#!/usr/bin/env python3
"""Drive heat_tpu_torch's main path once on one CUDA card and check it.

Run from the root of the repository, on a machine with a card:

    python3 chip_smoke.py

Phases, each printing JSON lines:
  1. the card's name and power limit, and the build of every kernel from
     heat_tpu_torch/csrc (one nvcc per source, all at once);
  2. every kernel against its plain PyTorch version on the card, at the
     paths' shapes and at ragged shapes (cdist also in each
     HEAT_TPU_CDIST_PREC strategy), with the stated tolerances, the
     kernel's, the plain version's and (where one PyTorch call computes the
     same function) the library call's times, and the bound; the flash
     kernels' times are device times (the calls replayed from a CUDA graph);
     the Hopper (wgmma) variants of K3, K4, K5, K6, K7a, K7b and K8, and
     K3's streamed f32 FMA kernel, are also
     held against the kernels they replace (mma.sync or f32 FMAs) and timed
     in turns with them (old, new, new, old), with their registers, spills
     and shared memory
     from the build, and their tile choices timed against the shape rules;
     the flash backward (K7a, K7b and K8) also through autograd, and
     two-pass against fused over sequence lengths;
  3. the random kernel (threefry2x32, the JAX package's stream) against
     its plain version in every epilogue on ragged shapes and split slices
     (bit-identical), the JAX package's golden values (randn's first and
     last four, randint's first 16), and its device time at bench.py's
     moments shape beside its plain version, torch.randn (another stream,
     for scale) and its bound from the function's operations (beside the
     instructions the compiler emitted, from the SASS); then the array path
     at bench.py's sizes through the user entry points, its inputs drawn by
     ht.random from seed 0:
     array(split=0) -> x*2+1 -> mean/var/std(axis=0) -> cdist -> KMeans.fit
     (bench.py's fit: randn data, init='random', random_state=1, 50
     iterations, tol=0; its first centers the JAX package's rows), with the
     kernels' launch counts read around it (the seeding's draws included);
     each stage is checked against a float64 reference, the fit both step
     by step along its own trajectory and end to end;
  4. the array path again under the profiler, for the device's busy share
     (device time over wall time of that one run) and the check that its
     fit gives bit-identical centers and labels to the first;
  5. the W8A8 path at bench.py's matmul_int8 width: 30 chained int8_matmul
     launches at 8192^3 that re-quantise the running product, checked bit
     for bit against the same chain through the plain GEMM, and one
     QuantDense(4096) call on 8192 tokens x 1024 against an f32 product;
  6. the linear-algebra path at bench.py's sizes: the matmul, matmul_f32,
     matmul_bf16 and matmul_1b chains through ht.matmul (TF32 on for the
     first, off for the second; the bf16 chain also through torch.matmul
     under torch's reduced-precision flag), each checked against float64
     and timed (wall and CUDA events, TFLOP/s and the share of the type's
     data-sheet rate), one f32 product profiled (one GEMM, no copy or
     cast); qr of a 1,000,000 x 256 and a 4096^2 f32 array and svd of the
     tall one, checked in float64; bench.py's elementwise row with clip;
     none of the csrc/ kernels may launch on this path; then bench.py's
     reduction row and this slice's statistics (argmax/argmin, average,
     cov, histogram, bincount, skew, kurtosis, nanmean/nanvar with NaNs,
     cumsum, chunk_moments at one K2 launch) at its moments shape, each
     against float64 with its wall time; then indexing and the
     manipulations at the same shape (sort both ways bit for bit against
     torch.sort, percentile and median against float64, unique with its
     inverse, topk, x[::3], x[idx] for 1,000,000 rows, a row mask, a full
     mask, x[x > 3] = 0, reshape, concatenate, flip, roll), only the random
     kernel launching;
  7. the serving path: bench.py's lm_step TransformerLM at full width
     (vocab 32768, d_model 1024, 16 heads, 12 layers, bf16, flash
     attention) answers three requests of 8 x 1024 tokens, checked against
     the same weights with the local core and in float32, and for
     causality; then one request under the profiler;
  6b. exact-type products (bool, int8, int32, int64, uint8, uint32 at
     1024^2) and the wide unsigned types (uint16, uint32, uint64: +, > 2, a
     mask, max, argmax, cumsum, //, %, sort, float64) against numpy; cg on a
     4096^2 s.p.d. system (its residual and time); bench.py's lasso row
     (2,000,000 x 64, 200 epochs at tol 0: fit times, device time and busy
     share under the profiler, launches of one graph-replayed epoch, that
     epoch against the eager one, coef_ against float64, the bytes bound)
     and spectral row (8192 x 32, k = 8, m = 64: the cdist kernel's rbf
     epilogue and the Lloyd kernel launched by the fit and held against
     their plain versions at its shapes, labels against the blob ids, the
     stages' times, the Lanczos basis);
  7b. the sparse arrays and what uses them: bench.py's sparse row uncut
     (16384^2 at 1%: csr_from_dense, spmv against float64, spmm, the
     transpose twice and staged, times beside torch.mv and the bytes
     bound); the eNeighbour Spectral on the spectral row's data (L sparse,
     K3 at the block shape and K4 launched and held against their plain
     versions, each stage's time, labels against the blob ids and the dense
     graph's, the Lanczos basis); connected components of that adjacency
     against scipy; KMedians, KMedoids, GaussianNB and KNN on 1,000,000 x
     64 in 8 blobs, each checked in float64;
  7c. out-of-core streaming: bench.py's moments array (8,000,000 x 64 f32,
     ht.random seed 0) written as four .npy shards and streamed by
     ChunkStream under HEAT_TPU_HBM_BUDGET=1G (8 chunks of at most
     1,048,576 rows); StreamingMoments (K2 once a chunk) against float64,
     its rows/s, load and fit time a chunk, K2's time a chunk, pageable and
     pinned host-to-device copies and its peak device memory against the
     files' bytes; MiniBatchKMeans(64, inner_iter=3) on K4 against the plain
     Lloyd pass on the card chunk by chunk; both resumed after chunk 4 bit
     for bit; KMeans(checkpoint_every=6) and a killed-then-resumed fit
     against the uninterrupted fit, bit for bit; save_csv/load_csv of
     1,000,000 x 16 through the native parser against np.loadtxt;
 8. the training path: the same model trains as bench.py's lm_step does
     (remat, bf16, the flash core with its two-pass backward, AdamW), one
     warm-up step and 8 steps on one batch, the loss falling and the
     kernels' launches counted per step; one step's gradients against the
     local core in bf16 and f32, the fused backward and remat off; peak
     memory with and without remat; one step under the profiler;
  9. data parallelism: the same model through nn.DataParallel on a world of
     one, DataParallelOptimizer(AdamW) with the CosineAnnealingLR schedule:
     3 blocking steps against the training path's plain step on the same
     batches, 3 double-buffered steps (the first applies zero gradients),
     the double-buffered second update against the blocking first (SGD),
     K6/K7a/K7b launches per step against the layer count, one step under
     the profiler;
 10. sequence parallelism at (1, 8192, 16, 64) bf16 causal on a world of
     one: ring_attention and ulysses_attention(use_pallas=True), forward and
     backward, against flash_attention and the kernels' plain versions,
     Ulysses launching K6, K7a and K7b; times and the ring's peak memory;
 11. DASO: examples/nn/daso_training.py's classifier through warmup,
     cycling and cooldown, the schedule state and accuracy per epoch;
 12. serving (bench.py:309-339 at its full size): KMeans(16) fitted on
     randn(200_000, 64) (K4 and the threefry kernel launch), served by
     Server(max_batch=64) through the program registry (a CUDA graph a
     bucket, captured at the warm-up): 1024 requests of 16 x 64 at once,
     three times, with no build after the warm-up, each answer equal to its
     solo dispatch bit for bit and to float64 labels apart from near ties;
     requests/s, latency, batches, occupancy, a batch's device time by CUDA
     events against its wall, the busy share under the profiler; every
     endpoint kind in exact and fast mode at modest sizes (batched against
     solo, against float64, save/restore, an injected fault retried, a
     shed); two replica processes on this card behind a Router (256
     requests bit for bit, both serving, nothing built after warm-up, no
     kernel compiled) and a rolling update onto a published version 2
     under traffic with no failed request.
 11b. scale-out training (after DASO): the serving model trains 3 steps
     each under nn.DataParallel (the reference), nn.FSDP over
     TransformerLM.stages() at prefetch 0 and 1, optim.ZeroOptimizer, and
     nn.Pipeline over the 12 blocks with 8 microbatches, gpipe and 1f1b
     (against DataParallel and the sequential application over the same
     blocks, embedding and head frozen): each step's wall, device time
     (CUDA events), flash launches and peak memory, the parameter and
     optimizer bytes a card, every run's updates against its reference's,
     prefetch 0 and 1 and 1f1b and gpipe bit for bit; DASO killed after a
     checkpoint and resumed, and cg on 4096^2 in windows of 16 iterations
     killed and resumed, each bit for bit its uninterrupted run; on four
     or more cards (after the collective audit) the same LM under FSDP and
     ZeroOptimizer on four NCCL ranks, the pipeline at S = 4 and at S = 2 x
     local 2 (HEAT_TPU_TOPOLOGY=2x2 HEAT_TPU_HIERARCHICAL=1), a flat and a
     tiered all-reduce of 4,194,304 f32 under every wire, each audited
     against the cost model and held against a world of one, else a line
     saying why it did not run;
 14. the autotuner and the program registry (after the data path): cdist
     at bench.py:209's 16,384 x 128 tuned over HEAT_TPU_CDIST_PREC under a
     1e-3 budget (the K3 variant of each candidate from the profiler, the
     pick no slower than the default, the record stored, a fresh process
     with HEAT_TPU_AUTOTUNE=1 adopting it with zero trials and launching
     the picked variant), the LM at full width under nn.FSDP tuned over
     HEAT_TPU_FSDP_PREFETCH (every depth's loss and parameters bit for bit,
     K6/K7a/K7b launches a trial), resplit of 1,000,000 x 256 over
     HEAT_TPU_RELAYOUT_PLAN (on four cards too, in the collective audit);
     a fault injected at relayout raising from resplit, one at cg_chunk
     stopping a checkpointed cg on 4096^2 and the resume bit for bit, the
     registry's sites with their hits and misses and a second pass that
     builds nothing, Lasso's epoch through streaming.lasso beside the
     private graph's figures; every line names the card and its power limit;
 13. data and observability: the array path (3) again under
     telemetry.enable(sink), a span a stage: the Chrome trace exported and
     checked, report.summarize's phases live and replayed from the sink,
     memory.watermark()'s peak against torch.cuda.max_memory_allocated, the
     results bit for bit those of an unrecorded run, and the path's wall
     with telemetry on and off in turns (the cost of recording); bench.py's
     kmeans_1b row (2^24 x 64 f32, k = 64, 10 passes: the fit's wall, K4's
     time a pass against a one-read bound, the centers against a float64
     Lloyd from the same start); after serving, the data path: the bundled
     iris through KMeans(3) (K4) and GaussianNB against the CPU, the Parter
     matrix's singular values at pi, the LM at full width under
     nn.DataParallel fed by DataLoader over a (512, 1024) token Dataset (two
     epochs of four steps, ishuffle off and on: the second epoch's order the
     threefry permutation, launches a step, each step's wall), and a
     4,000,000 x 64 f32 file streamed by PartialDataLoaderIter in batches of
     65,536 (PartialH5Dataset where h5py is installed, else PartialDataset
     over a .npy memory map: rows/s, the loader thread's reading, the
     consumer's waiting and the card's time, column sums against numpy in
     float64); on four or more cards the collective audit (ring cdist, qr,
     resplit on four NCCL ranks, each DriftReport), else a line saying why
     it did not run.
Each path's launch counts are set to 0 just before it and read just after.
The line before the last lists the kernels; the last line is
{"ok": true, "device": {...}}. Any failure exits non-zero before it. Without
a card, or without the package beside this script, it exits non-zero and
prints no result.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

# H100 SXM data-sheet peaks (dense, at the full 700 W power limit): HBM
# bandwidth, the f32 rate outside the tensor cores, and the tensor cores'
# bf16, int8 and TF32 rates
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12
TF32_FLOPS_PER_S = 495e12
ARRAY_PATH = ("moments", "cdist", "lloyd", "random")
# the wgmma K7a's (query rows a block, keys a tile) instantiations, by head dim
DQ_TILES = [(64, (64, 64)), (64, (64, 128)), (64, (128, 64)), (64, (128, 128)),
            (128, (128, 64))]

# golden values from the JAX package (tests/test_torch_random.py pins them):
# seed(0); randn(8_000_000, 64, split=0)'s first and last four values, the
# 64 rows of KMeans(64, init='random', random_state=1) over 2,000,000 rows,
# and seed(0); randint(0, 8, (8192, 1))'s first 16
GOLDEN_RANDN_SHAPE = (8_000_000, 64)
GOLDEN_RANDN_FIRST4 = [1.004014253616333, -0.9063372015953064, -0.7481722235679626,
                       -1.1713669300079346]
GOLDEN_RANDN_LAST4 = [1.3848791122436523, 0.11706317216157913, -0.40688031911849976,
                      1.7099376916885376]
GOLDEN_KMEANS_ROWS_OF = (2_000_000, 64)
GOLDEN_KMEANS_ROWS = [
    63401, 372458, 715379, 624832, 584277, 1580600, 773191, 1480569, 1816410, 1711003,
    1248872, 1498924, 1086903, 1808292, 405756, 1521495, 928483, 39798, 1841261, 635976,
    1048063, 1631096, 1201706, 438454, 1136256, 1798459, 267488, 1612066, 411328, 232216,
    1440796, 1475886, 1955296, 1437595, 1917081, 853868, 1326493, 166623, 217579, 1534357,
    766412, 144957, 136500, 993163, 872953, 379193, 1048879, 461236, 987743, 719783, 1544887,
    1777258, 942199, 1137366, 1600132, 1856413, 1623776, 1495837, 1732343, 928225, 1777631,
    1506766, 1740124, 1897027]
GOLDEN_RANDINT_FIRST16 = [7, 1, 7, 1, 2, 0, 1, 5, 5, 4, 5, 1, 7, 3, 5, 5]

FAILURES = []


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(name, ok, **fields):
    emit({"check": name, "ok": bool(ok), **fields})
    if not ok:
        FAILURES.append(name)


def materialize(obj):
    """Read the tensor of every DNDarray in ``obj`` (nested tuples and lists
    too) and return ``obj``: a deferred (fused) result then runs inside the
    timer that wraps the call, as an eager one does."""
    if hasattr(type(obj), "_fused_node"):
        obj.larray
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            materialize(v)
    return obj


def profiled_kernels(run, calls, tries=3, want=None):
    """The CUDA events of ``key_averages()`` over one profiler window that
    runs ``run()`` (``calls`` calls of one function), spin kernel excluded.
    The profiler can drop a kernel's record, at a window's first launch or
    inside it; since every call launches the same kernels, a window where a
    kernel's count is not a multiple of ``calls``, nothing was recorded, or
    no kernel's name holds ``want`` (when given), is profiled again, up to
    ``tries`` windows (the last is returned as it is)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)  # the window's first launch: a spin kernel
            torch.cuda.synchronize()
            run()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA and "spin" not in ev.key]
        launched = [ev for ev in evs if not ev.key.startswith(("Memset", "Memcpy"))]
        if launched and all(ev.count % calls == 0 for ev in launched) and (
                want is None or any(want in ev.key for ev in launched)):
            break
    return evs


def bound(bytes_moved, ops, rate=F32_FLOPS_PER_S):
    """The least time in ms: bytes over the memory rate or operations over
    the rate of their type, whichever is larger, and which one it is."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# bench.py's linear-algebra rows: (name, n, torch type name, chained
# products, TF32 flag for the row, the data-sheet rate of the product's type)
MATMUL_ROWS = [("matmul", 4096, "float32", 100, True, TF32_FLOPS_PER_S),
               ("matmul_f32", 4096, "float32", 25, False, F32_FLOPS_PER_S),
               ("matmul_bf16", 8192, "bfloat16", 30, None, BF16_FLOPS_PER_S),
               ("matmul_1b", 32768, "bfloat16", 5, None, BF16_FLOPS_PER_S)]
# qr and svd of a tall 1.02 GB f32 array, qr of a square one; bench.py's
# elementwise row (rows, columns, reps)
QR_TALL, QR_SQUARE = (1_000_000, 256), 4096
ELEMENTWISE = (8_000_000, 64, 10)


def matmul_step_tolerance(dtype_name, tf32, k):
    """The relative error of one product of positive operands against
    float64: TF32 rounds each operand to 10 mantissa bits (2^-10 relative at
    worst, two operands) and adds in f32 (K 2^-24 at worst for K positive
    terms); plain f32 only adds; bf16 operands are exact in float64 and the
    f32 sum is rounded once to bf16 (8 significant bits: 2^-8). Along a
    chain of positive matrices the relative errors add up at worst."""
    if dtype_name == "bfloat16":
        return 2.0 ** -8 + k * 2.0 ** -24
    return (2 * 2.0 ** -10 if tf32 else 0.0) + k * 2.0 ** -24


def linalg_path(ht, dev, gen):
    """The linear-algebra path through the user entry points at bench.py's
    sizes: the four matmul chains, qr and svd, the elementwise row. Returns
    the kernels' launch counts over the path."""
    import numpy as np
    import torch

    flags = torch.backends.cuda.matmul
    ht.reset_launch_counts()

    def timed_chain(step, y, reps):
        """Wall time ending in a synchronize, and device time by CUDA events
        around the same run, in ms."""
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        start.record()
        for _ in range(reps):
            y = materialize(step(y))
        end.record()
        torch.cuda.synchronize()
        return y, (time.perf_counter() - t) * 1e3, start.elapsed_time(end)

    for name, n, dtype_name, reps, tf32, rate in MATMUL_ROWS:
        dtype = getattr(torch, dtype_name)
        caller_tf32 = flags.allow_tf32
        if tf32 is not None:
            flags.allow_tf32 = tf32
        try:
            # as in bench.py: A = rand/n (spectral radius below 1), Y = rand, split 0
            a_t = (torch.rand((n, n), generator=gen, device=dev) / n).to(dtype)
            y_t = torch.rand((n, n), generator=gen, device=dev).to(dtype)
            a = ht.array(a_t, split=0, copy=False)
            y0 = ht.array(y_t, split=0, copy=False)
            first = ht.matmul(a, y0)  # warm-up, and the product checked for matmul_1b
            y, wall_ms, device_ms = timed_chain(lambda y: ht.matmul(a, y), y0, reps)
            flops = reps * 2.0 * n ** 3
            row = {"phase": f"linalg {name}", "n": n, "dtype": dtype_name, "chained": reps,
                   "allow_tf32": flags.allow_tf32 if dtype_name == "float32" else None,
                   "wall_ms": wall_ms, "device_ms": device_ms,
                   "tflop_s_wall": flops / (wall_ms * 1e-3) / 1e12,
                   "tflop_s_device": flops / (device_ms * 1e-3) / 1e12,
                   "share_of_rate_device": flops / (device_ms * 1e-3) / rate,
                   "rate_tflop_s": rate / 1e12}
            if dtype_name == "bfloat16":
                # the chain with the port's cleared reduced-precision flag
                # against torch.matmul under torch's own (by default set:
                # split-K may add in bf16), in turns: port, torch, torch, port
                row["torch_reduced_precision_flag"] = flags.allow_bf16_reduced_precision_reduction
                def port(t):
                    return ht.matmul(a, t)

                def lib(t):
                    return torch.matmul(a_t, t)

                turns = [timed_chain(port, y0, reps)[2], timed_chain(lib, y_t, reps)[2],
                         timed_chain(lib, y_t, reps)[2], timed_chain(port, y0, reps)[2]]
                port_ms, lib_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
                row.update({"turns_device_ms": {"port_cleared_flag": [turns[0], turns[3]],
                                                "torch_default_flag": [turns[1], turns[2]]},
                            "port_cleared_flag_tflop_s_device": flops / (port_ms * 1e-3) / 1e12,
                            "torch_default_flag_tflop_s_device": flops / (lib_ms * 1e-3) / 1e12})
            if dtype_name == "float32":
                # one product under the profiler: one GEMM, no copy or cast
                kernels = [ev.key for ev in profiled_kernels(lambda: ht.matmul(a, y0).larray, 1)]
                # cuBLAS may clear a workspace first (a device memset, no kernel)
                launched = [k for k in kernels if not k.startswith("Memset")]
                copies = [k for k in launched if any(w in k.lower() for w in
                                                     ("copy", "cast", "elementwise", "memcpy"))]
                row["profiled_product_kernels"] = [k[:120] for k in kernels]
                check(f"linalg {name}: one product is one GEMM kernel, no copy or cast",
                      len(launched) == 1 and not copies
                      and any(w in launched[0].lower() for w in ("gemm", "nvjet")),
                      kernels=kernels)
            emit(row)
            k_tol = matmul_step_tolerance(dtype_name, tf32, n)
            if n <= 8192:
                ref = y_t.double()
                a64 = a_t.double()
                for _ in range(reps):
                    ref = a64 @ ref
                err = ((y.larray.double() - ref).abs() / ref).max().item()
                tol = reps * k_tol
                label = f"linalg {name}: the {reps}-product chain vs float64"
            else:
                rows_ = torch.randint(0, n, (256,), generator=gen, device=dev)
                ref = a_t[rows_].double() @ y_t.double()
                err = ((first.larray[rows_].double() - ref).abs() / ref).max().item()
                tol = k_tol
                label = f"linalg {name}: first product vs float64 (256 sampled rows)"
            del ref
            ok = (y.shape == (n, n) and y.split == 0 and y.dtype.torch_type() == dtype
                  and bool(torch.isfinite(y.larray).all()) and err <= tol)
            check(label, ok, max_rel_err=err, tolerance=tol,
                  tolerance_rule="chained products x per-product bound: operand rounding "
                                 "(TF32 2 x 2^-10) + f32 sum K 2^-24 + bf16 output rounding 2^-8")
        finally:
            flags.allow_tf32 = caller_tf32
        del a_t, y_t, a, y0, y, first
        torch.cuda.empty_cache()

    # qr and svd at bench.py-like sizes; on one card the general path
    # (cuSOLVER). Bounds c n 2^-24 with c = 10 for a backward-stable
    # factorization of an m x n matrix in f32.
    def f64_norm(t):
        return torch.linalg.matrix_norm(t, "fro").item()

    m_t, n_t = QR_TALL
    x_tall = torch.randn((m_t, n_t), generator=gen, device=dev)
    for label, x_t in (("tall", x_tall),
                       ("square", torch.randn((QR_SQUARE, QR_SQUARE), generator=gen, device=dev))):
        x = ht.array(x_t, split=0, copy=False)
        ht.linalg.qr(x)  # warm-up
        torch.cuda.synchronize()
        t = time.perf_counter()
        q, r = ht.linalg.qr(x)
        torch.cuda.synchronize()
        qr_ms = (time.perf_counter() - t) * 1e3
        q64, r64, x64 = q.larray.double(), r.larray.double(), x_t.double()
        n_cols = x_t.shape[1]
        bound = 10 * n_cols * 2.0 ** -24
        recon = f64_norm(q64 @ r64 - x64) / f64_norm(x64)
        orth = f64_norm(q64.T @ q64 - torch.eye(n_cols, dtype=torch.float64, device=dev))
        emit({"phase": f"linalg qr {label}", "shape": list(x_t.shape), "split": 0, "ms": qr_ms,
              "q_split": q.split, "r_split": r.split, "rel_reconstruction_err": recon,
              "orthogonality_err": orth, "bound": bound})
        check(f"linalg qr {label}: |QR - A|/|A| and |Q^T Q - I| within 10 n 2^-24",
              recon <= bound and orth <= bound and q.shape == tuple(x_t.shape)
              and r.shape == (n_cols, n_cols), rel_reconstruction_err=recon,
              orthogonality_err=orth, bound=bound)
        del q, r, q64, r64, x64, x
    x = ht.array(x_tall, split=0, copy=False)
    ht.linalg.svd(x)  # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    u, s_, v = ht.linalg.svd(x)
    torch.cuda.synchronize()
    svd_ms = (time.perf_counter() - t) * 1e3
    u64, x64 = u.larray.double(), x_tall.double()
    bound = 10 * n_t * 2.0 ** -24
    recon = f64_norm((u64 * s_.larray.double()) @ v.larray.double().T - x64) / f64_norm(x64)
    orth = f64_norm(u64.T @ u64 - torch.eye(n_t, dtype=torch.float64, device=dev))
    # torch's default cuSOLVER routine on the same input, for the port's choice of gesvd
    torch.linalg.svd(x_tall, full_matrices=False)
    torch.cuda.synchronize()
    t = time.perf_counter()
    u_d, s_d, vt_d = torch.linalg.svd(x_tall, full_matrices=False)
    torch.cuda.synchronize()
    default_ms = (time.perf_counter() - t) * 1e3
    ud64 = u_d.double()
    default_orth = f64_norm(ud64.T @ ud64 - torch.eye(n_t, dtype=torch.float64, device=dev))
    del u_d, s_d, vt_d, ud64
    emit({"phase": "linalg svd tall", "shape": [m_t, n_t], "split": 0, "ms": svd_ms,
          "rel_reconstruction_err": recon, "orthogonality_err": orth, "bound": bound,
          "torch_default_routine_ms": default_ms,
          "torch_default_routine_orthogonality_err": default_orth})
    check("linalg svd tall: |U S V^T - A|/|A| and |U^T U - I| within 10 n 2^-24",
          recon <= bound and orth <= bound and bool((s_.larray[:-1] >= s_.larray[1:]).all()),
          rel_reconstruction_err=recon, orthogonality_err=orth, bound=bound)
    del u, s_, v, u64, x64, x, x_tall

    # bench.py's elementwise row, now that clip exists
    rows_e, cols_e, reps_e = ELEMENTWISE
    xe_t = torch.randn((rows_e, cols_e), generator=gen, device=dev)
    xe = ht.array(xe_t, split=0, copy=False)
    mean_, std_ = ht.array(np.float32(0.1), device=dev), ht.array(np.float32(1.3), device=dev)

    def one_pass(_):
        z = (xe - mean_) / (std_ + 1e-6)
        z = z * 0.125 + 0.5
        return ht.clip(z, 0.0, 1.0) * 255.0

    one_pass(None)
    out, wall_ms, device_ms = timed_chain(one_pass, None, reps_e)
    denom = float(torch.tensor(1.3, dtype=torch.float32) + 1e-6)
    ref = ((xe_t.double() - float(np.float32(0.1))) / denom * 0.125 + 0.5).clamp(0, 1) * 255
    err = (out.larray.double() - ref).abs().max().item()
    # seven f32 roundings of values within [-4, 4] before the clip, each
    # within 2^-24 of its value: 255 x 8 x 2^-24 after the scale
    tol = 255 * 8 * 2.0 ** -24
    # six passes over the array a rep (-, /, *, +, clip, *), each reading and
    # writing 4 B an element; the 0-d operands are not counted
    bytes_e = reps_e * 6 * 2 * 4 * rows_e * cols_e
    emit({"phase": "linalg elementwise", "shape": [rows_e, cols_e], "reps": reps_e,
          "wall_ms": wall_ms, "device_ms": device_ms,
          "tb_s_device": bytes_e / (device_ms * 1e-3) / 1e12,
          "share_of_hbm_rate": bytes_e / (device_ms * 1e-3) / HBM_BYTES_PER_S})
    check("linalg elementwise vs float64", out.dtype is ht.float32 and out.split == 0
          and err <= tol, max_abs_err=err, tolerance=tol)
    del xe, xe_t, out, ref
    torch.cuda.empty_cache()
    return dict(ht.launch_counts())


# the random kernel's bound from the function it computes, not from the
# instructions the compiler emitted: per element, operations that only the
# ALU pipe runs (64 lanes an SM a clock), integer adds that the ALU or the
# FMA pipe (IMAD.IADD) runs, and FP32 operations of the FMA pipes; every
# operation takes an issue slot (4 warps an SM a clock, 128 lanes). The
# least clocks an element an SM is then max(alu / 64, all / 128).
#   hash: 41 ALU (20 rotations, 20 xors, the final x0 ^ x1) and 32 adds
#         (20 in the rounds, 2 + 10 key injections; the key words' sums
#         with the round number are the same for every element)
#   normal_f32 adds the uniform's shift, or and max and erf_inv's branch
#         test on the ALU (4), and 27 FP32 operations: the uniform's
#         subtract, multiply and add (3), x * -x, log1p as one MUFU.LG2
#         beside 4, w - 2.5, the nine-term Horner (16), p * x, sqrt(2) * (1
#         each); this run's data takes the w < 5 branch and never u = +-1
INT_ALU_LANES, ISSUE_LANES = 64, 128
FUNCTION_OPS = {"bits32": {"alu": 41, "all": 41 + 32},
                "normal_f32": {"alu": 41 + 4, "all": 41 + 32 + 4 + 27 + 1}}
ALU_OPS = ("IADD3", "LOP3", "SHF", "ISETP", "SEL", "PRMT", "LEA", "IABS", "IMNMX", "FLO",
           "POPC", "BMSK", "MOV", "SHL", "SHR", "VIADD")


def sass_per_element(lib_path, epilogue):
    """Instructions a thread issues for one element in the grid-stride loop
    of the random kernel's ``epilogue`` instantiation, read from its SASS
    (``cuobjdump -sass``): from the counter's setup before the first
    rotation to the loop's back branch. Returns (all, ALU-pipe integer)."""
    import re

    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    body = next(f for f in sass.split("Function : ")[1:]
                if f"threefry_drawILi{epilogue}E" in f.splitlines()[0])
    ops = [(int(a, 16), op) for a, op in re.findall(
        r"/\*([0-9a-f]{4})\*/\s+(?:@!?U?P[T\d]\s+)?([A-Z][A-Z0-9_.]*)", body)]
    first = next(i for i, (_, op) in enumerate(ops) if op.startswith("SHF.L.W"))
    store = next(i for i in range(first, len(ops)) if ops[i][1].startswith("STG"))
    back = next(i for i in range(store, len(ops)) if ops[i][1] == "BRA")
    hot = [op for _, op in ops[first - 2:back + 1] if op not in ("NOP", "BSSY", "BSYNC")]
    alu = [op for op in hot if op.split(".")[0] in ALU_OPS]
    return len(hot), len(alu)


def random_phase(ht, dev, time_ms, paths):
    """The threefry kernel against its plain version on the card (every
    epilogue; ragged sizes; slices of a split axis, a rank's chunk
    included: bit-identical), the golden values of the JAX package, and
    its device time at bench.py's moments shape with the bound from the
    function's operations. Returns the kernels line's fields and the
    phase's launches."""
    import torch
    from heat_tpu_torch.core import _threefry as tf, cuda_random

    key = tf.fold_in(tf.prng_key(0), 0)
    rows, cols = GOLDEN_RANDN_SHAPE
    worst = {epi: 0 for epi in tf.EPILOGUES}
    cases = [((1000, 7), None, 0, None), ((10, 3), 0, 7, 3), ((4, 37, 11), 1, 5, 9),
             ((3, 5, 2), 2, 1, 1), ((123457,), 0, 1000, 5000),
             ((rows, cols), 0, 2_666_667, 2_666_667)]  # rank 1's chunk of 3
    ht.reset_launch_counts()
    for shape, split, start, length in cases:
        sl = tf.Slice(shape, split, start, length)
        for epi in tf.EPILOGUES:
            lo, hi = (-2.5, 7.25) if epi == "uniform_f32" else (0.0, 1.0)
            got = cuda_random.draw(key, sl, epi, lo, hi, device=dev)
            want = tf.draw_plain(key, sl, epi, lo, hi, device=dev)
            if got.is_floating_point():
                got, want = got.view(torch.int32), want.view(torch.int32)
            worst[epi] = max(worst[epi], int((got.long() - want.long()).abs().max()))
            del got, want
    compare_launches = ht.launch_counts()["random"]
    check("random kernel vs its plain version: every epilogue, ragged and split slices, "
          "bit-identical", not any(worst.values()) and compare_launches == 4 * len(cases),
          worst_ulp_or_bits=worst, launches=compare_launches, tolerance="bit-identical")

    # the golden values: the JAX package's draws at those indices
    ht.random.seed(0)
    x = ht.random.randn(rows, cols, split=0)
    flat = x.larray.reshape(-1)
    ends = torch.cat([flat[:4], flat[-4:]]).cpu()
    gold = torch.tensor(GOLDEN_RANDN_FIRST4 + GOLDEN_RANDN_LAST4, dtype=torch.float32)
    randn_ulp = int((ends.view(torch.int32).long() - gold.view(torch.int32).long()).abs().max())
    ht.random.seed(0)
    ints = ht.random.randint(0, 8, (8192, 1)).larray.reshape(-1)[:16].cpu().tolist()
    check("random golden values: randn within 4 ulp of the JAX package's, randint equal",
          randn_ulp <= 4 and ints == GOLDEN_RANDINT_FIRST16 and x.larray.is_cuda,
          randn_max_ulp=randn_ulp, randint_first16=ints)

    # device time at the moments shape; the plain version's; torch.randn's
    n = rows * cols
    sl = tf.Slice.whole((rows, cols))
    fields = {"shape": [rows, cols]}
    for epi in tf.EPILOGUES:
        fields[f"{epi}_ms"] = time_ms(lambda: cuda_random.draw(key, sl, epi, device=dev), 5)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    plain = tf.draw_plain(key, sl, "normal_f32", device=dev)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    kern = cuda_random.draw(key, sl, "normal_f32", device=dev)
    max_abs_err = (kern - plain).abs().max().item()
    del plain, kern, x, flat
    fields["torch_randn_ms"] = time_ms(lambda: torch.randn((rows, cols), device=dev), 5)
    props = torch.cuda.get_device_properties(dev)
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"], capture_output=True,
                               text=True, check=True).stdout.split()[0])
    clocks = props.multi_processor_count * mhz * 1e6
    per_elem = {}
    for epi, code in (("bits32", 0), ("normal_f32", 3)):
        ops = FUNCTION_OPS[epi]
        total, alu = sass_per_element(paths["random"], code)
        t_ops_epi = max(ops["alu"] / INT_ALU_LANES, ops["all"] / ISSUE_LANES) * n / clocks * 1e3
        per_elem[epi] = {"function_alu_ops": ops["alu"], "function_ops": ops["all"],
                         "operations_bound_ms": t_ops_epi,
                         "bound_ms": max(t_ops_epi, n * 4 / HBM_BYTES_PER_S * 1e3),
                         "emitted_instructions": total, "emitted_alu_integer": alu,
                         "emitted_alu_bound_ms": alu * n / (INT_ALU_LANES * clocks) * 1e3,
                         "emitted_issue_bound_ms": total * n / (ISSUE_LANES * clocks) * 1e3}
    t_bytes = n * 4 / HBM_BYTES_PER_S * 1e3
    t_ops = per_elem["normal_f32"]["operations_bound_ms"]
    fields.update({"per_element": per_elem, "sm_count": props.multi_processor_count,
                   "max_sm_mhz": mhz, "bytes_bound_ms": t_bytes})
    emit({"phase": "random kernel", **fields})
    return {"variant": "normal_f32", "kernel_ms": fields["normal_f32_ms"], "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "max_abs_err": max_abs_err, "old_ms": None,
            "torch_randn_ms": fields["torch_randn_ms"]}


FUSION_DENSE = 4096  # nn.functional.dense at 4096^2: x (4096, 4096) @ w (4096, 4096) + b, relu
RELAYOUT_SHAPE = (1_000_000, 256)  # the relayout phases' f32 array


def fusion_phase(ht, dev, smi, time_ms):
    """Deferred fusion at bench.py's moments size (8,000,000 x 64 f32 from
    ht.random, seed 0) and dense at 4096^2, with HEAT_TPU_FUSION=1 and then
    =0: mean and var of x*2+1 (axis 0), exp(a) - b*2, dense(x, w, bias=b,
    activation="relu"). Checks the same bits in both settings, one K2
    launch for each mean and each var of a pending chain, no build after
    warm-up, fused device time (CUDA events around five calls, in turns:
    eager, fused, fused, eager) within 1.05x of eager and no more copy
    kernels fused than eager; prints both times, the kernels' own time
    under the profiler, the launches and the peak memory.
    Returns the K2 launches of the fused run."""
    import torch

    from heat_tpu_torch import _knobs, telemetry
    from heat_tpu_torch.core import fusion

    rows, cols = GOLDEN_RANDN_SHAPE
    ht.random.seed(0)
    x = ht.random.randn(rows, cols, split=0)
    b = ht.random.randn(rows, cols, split=0)
    xd = ht.random.randn(FUSION_DENSE, FUSION_DENSE)
    w = ht.random.randn(FUSION_DENSE, FUSION_DENSE) * (1.0 / FUSION_DENSE ** 0.5)
    bias = ht.random.randn(FUSION_DENSE)
    for t in (x, b, xd, w, bias):
        t.larray
    cases = {
        "moments": lambda: (lambda z: (ht.mean(z, axis=0), ht.var(z, axis=0)))(x * 2.0 + 1.0),
        "chain": lambda: ht.exp(x) - b * 2,
        "dense": lambda: ht.nn.functional.dense(xd, w, bias=bias, activation="relu"),
    }
    report = {"nvidia_smi": smi, "shape": [rows, cols], "dense": [FUSION_DENSE] * 3}
    bits, times = {}, {}

    def setting(on):
        return _knobs.overlay({"HEAT_TPU_FUSION": "1" if on else "0"})

    for on in (True, False):
        tag = "fused" if on else "eager"
        with setting(on):
            for fn in cases.values():
                materialize(fn())  # warm-up: every program of the phase built
            torch.cuda.synchronize()
            fusion.reset_stats()
            ht.reset_launch_counts()
            with telemetry.CompileWatcher() as cw:
                out = {name: materialize(fn()) for name, fn in cases.items()}
                z = x * 2.0 + 1.0  # one more pending chain: var first
                out["var_first"] = materialize(ht.var(z, axis=0))
                torch.cuda.synchronize()
            launches = dict(ht.launch_counts())
            st = fusion.stats()
            bits[tag] = {"mean": out["moments"][0].larray, "var": out["moments"][1].larray,
                         "var_first": out["var_first"].larray, "chain": out["chain"].larray,
                         "dense": out["dense"].larray}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            for fn in cases.values():
                materialize(fn())
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(dev) - base
            kernels, kernel_ms = [], {}
            for name, fn in cases.items():
                evs = profiled_kernels(lambda: [materialize(fn()) for _ in range(3)], 3)
                kernel_ms[name] = sum(ev.self_device_time_total for ev in evs) / 3e3
                kernels += [(ev.key, ev.count) for ev in evs]
            copies = sum(c for k, c in kernels if any(m in k.lower() for m in
                                                      ("copy", "memcpy")))
            report[tag] = {"k2_launches": launches["moments"], "builds": cw.backend_compiles,
                           "fusion_stats": st, "peak_bytes_above_inputs": peak,
                           "copy_kernels": copies, "kernel_ms": kernel_ms,
                           "profiled_kernels": sorted({k[:100] for k, _ in kernels})}
    for turn in ("eager", "fused", "fused", "eager"):
        with setting(turn == "fused"):
            for name, fn in cases.items():
                times.setdefault(turn, {}).setdefault(name, []).append(time_ms(fn, 5))
    for tag in ("fused", "eager"):
        # device time by CUDA events around five calls, in turns (a host
        # sync inside a call, such as maximum's pageable scalar copy, lets
        # the host's work show as idle time between the events)
        report[tag]["ms"] = {name: sum(v) / len(v) for name, v in times[tag].items()}
    fused_ms, eager_ms = (sum(report[t]["ms"].values()) for t in ("fused", "eager"))
    report["fused_over_eager"] = fused_ms / eager_ms
    # and the kernels' own time under the profiler, a call
    report["kernel_fused_over_eager"] = (sum(report["fused"]["kernel_ms"].values())
                                         / sum(report["eager"]["kernel_ms"].values()))
    same = {k: bool(torch.equal(bits["fused"][k], bits["eager"][k])) for k in bits["fused"]}
    report["bits_equal"] = same
    emit({"phase": "fusion", **report})
    check("fusion: fused results equal HEAT_TPU_FUSION=0 bit for bit", all(same.values()),
          bits_equal=same)
    fz = report["fused"]["fusion_stats"]
    check("fusion: one K2 launch for each mean and each var of a pending chain, the chains "
          "grafted into it", report["fused"]["k2_launches"] == 3
          and report["eager"]["k2_launches"] == 3 and fz["reductions_absorbed"] == 2
          and fz["epilogues_grafted"] == 1, fused=report["fused"]["k2_launches"],
          eager=report["eager"]["k2_launches"], stats=fz)
    check("fusion: no build after warm-up", report["fused"]["builds"] == 0
          and report["eager"]["builds"] == 0,
          builds=[report["fused"]["builds"], report["eager"]["builds"]])
    check("fusion: fused device time within 1.05x of eager (events and kernels), no more "
          "copy kernels", fused_ms <= 1.05 * eager_ms
          and report["kernel_fused_over_eager"] <= 1.05
          and report["fused"]["copy_kernels"] <= report["eager"]["copy_kernels"],
          fused_ms=fused_ms, eager_ms=eager_ms, kernels=report["kernel_fused_over_eager"],
          copies=[report["fused"]["copy_kernels"], report["eager"]["copy_kernels"]])
    del x, b, xd, w, bias, bits
    torch.cuda.empty_cache()
    return report["fused"]["k2_launches"]


def relayout_phase(ht, dev, smi, time_ms):
    """One card: resplit of a 1,000,000 x 256 f32 array under each
    HEAT_TPU_RELAYOUT_PLAN value, the same bits (one rank moves nothing: the
    planner's fast path), and the plans the planner gives four ranks under a
    budget that the monolithic relayout does not fit."""
    import torch

    from heat_tpu_torch import _knobs
    from heat_tpu_torch.core import relayout_planner

    ht.random.seed(0)
    x = ht.random.randn(*RELAYOUT_SHAPE, split=0)
    out, ms = {}, {}
    for plan in ("auto", "monolithic", "alltoall", "chunked"):
        with _knobs.overlay({"HEAT_TPU_RELAYOUT_PLAN": plan}):
            out[plan] = x.resplit(1).larray
            ms[plan] = time_ms(lambda: x.resplit(1), 3)
    same = all(torch.equal(out["auto"], t) for t in out.values())
    need = relayout_planner.monolithic_need(RELAYOUT_SHAPE, 4, 0, 1, 4)
    plans = {}
    for budget in (None, 2 * need, need - 1, need // 4):
        p = relayout_planner.plan(RELAYOUT_SHAPE, 4, 0, 1, 4, budget=budget, live=0)
        plans[str(budget)] = {k: v for k, v in p.summary().items() if k != "gshape"}
    emit({"phase": "relayout one card", "shape": list(RELAYOUT_SHAPE), "ms": ms,
          "bits_equal": same, "four_rank_plans": plans, "monolithic_need_four_ranks": need,
          "nvidia_smi": smi})
    check("relayout: every HEAT_TPU_RELAYOUT_PLAN value gives the same bits", same)
    del x, out
    torch.cuda.empty_cache()


def statistics_path(ht, dev):
    """bench.py's reduction row and the statistics of this slice at its
    moments shape, through the user entry points, each against float64 on
    the same data with its wall time. Returns the launch counts over the
    path and the K2 launches of chunk_moments."""
    import numpy as np
    import torch

    rows, cols = GOLDEN_RANDN_SHAPE
    ht.reset_launch_counts()
    ht.random.seed(1)
    x = ht.random.randn(rows, cols, split=0)
    xt = x.larray
    x64 = xt.double()

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = materialize(fn())
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    # bench.py's reduction row: 10 reps of (x - m) / (s + 1e-6) * 0.125,
    # summed over axis 0
    m, sd = ht.array(np.float32(0.1), device=dev), ht.array(np.float32(1.3), device=dev)
    out, red_ms = timed(lambda: [ht.sum((x - m) / (sd + 1e-6) * 0.125, axis=0)
                                 for _ in range(10)][-1])
    ref = ((x64 - 0.1) / (1.3 + 1e-6) * 0.125).sum(0)
    scale = (x64.abs() / 1.3 * 0.125).sum(0)
    red_err = ((out.larray.double() - ref).abs() / scale).max().item()
    bytes_rep = 7 * rows * cols * 4  # three elementwise passes read and write, the sum reads
    emit({"phase": "reduction row", "shape": [rows, cols], "reps": 10, "wall_ms": red_ms,
          "gb_per_s": 10 * bytes_rep / (red_ms * 1e-3) / 1e9, "err_over_sum_abs": red_err})
    check("reduction row vs float64", out.shape == (cols,) and red_err <= 1e-5,
          err_over_sum_abs=red_err, tolerance=1e-5)

    results = {}

    def hold(name, got, err, tol, ms, **extra):
        results[name] = {"wall_ms": ms, "err": err, "tolerance": tol, **extra}
        check(f"statistics {name} vs float64", err <= tol, err=err, tolerance=tol)

    g, ms = timed(lambda: (ht.argmax(x, axis=0), ht.argmin(x, axis=0)))
    exact = bool(torch.equal(g[0].larray, x64.argmax(0)) and torch.equal(g[1].larray,
                                                                          x64.argmin(0)))
    hold("argmax/argmin(axis=0)", g, 0.0 if exact else 1.0, 0.0, ms)
    w = ht.random.rand(rows, split=0)
    g, ms = timed(lambda: ht.average(x, axis=0, weights=w))
    w64 = w.larray.double()
    ref = (x64 * w64[:, None]).sum(0) / w64.sum()
    hold("average(axis=0, weights)", g, ((g.larray.double() - ref).abs()
                                         / ((x64.abs() * w64[:, None]).sum(0) / w64.sum())
                                         ).max().item(), 1e-5, ms)
    g, ms = timed(lambda: ht.cov(x, rowvar=False))
    ref = torch.cov(x64.T)
    hold("cov(rowvar=False)", g, ((g.larray.double() - ref).abs().max()
                                  / ref.abs().max()).item(), 1e-4, ms)
    g, ms = timed(lambda: ht.histogram(x, bins=64))
    edges = g[1].larray
    idx = torch.bucketize(x64.reshape(-1), edges, right=True)  # numpy's bins, the last closed
    idx = torch.where(x64.reshape(-1) == edges[-1], 64, idx)
    ref = torch.bincount(idx, minlength=66)[1:65].double()
    del idx
    hold("histogram(bins=64)", g, float((g[0].larray.double() - ref).abs().max()), 0.0, ms,
         dtype=str(g[0].larray.dtype))
    labels = ht.random.randint(0, cols, (rows,), dtype=ht.int64, split=0)
    g, ms = timed(lambda: ht.bincount(labels))
    hold("bincount", g, float((g.larray - torch.bincount(labels.larray)).abs().max()), 0.0, ms)
    mu64 = x64.mean(0)
    dev64 = x64 - mu64
    m2, m3, m4 = (dev64 ** 2).mean(0), (dev64 ** 3).mean(0), (dev64 ** 4).mean(0)
    del dev64
    g, ms = timed(lambda: ht.skew(x, axis=0, unbiased=False))
    hold("skew(axis=0)", g, (g.larray.double() - m3 / m2 ** 1.5).abs().max().item(), 1e-4, ms)
    g, ms = timed(lambda: ht.kurtosis(x, axis=0))
    hold("kurtosis(axis=0)", g, (g.larray.double() - (m4 / m2 ** 2 - 3)).abs().max().item(),
         1e-4, ms)
    holes = xt.clone()
    holes[::1000, ::7] = float("nan")
    xn = ht.array(holes, split=0)
    h64 = holes.double()
    g, ms = timed(lambda: ht.nanmean(xn, axis=0))
    ref = h64.nanmean(0)
    hold("nanmean(axis=0), NaNs planted", g, ((g.larray.double() - ref).abs()
                                              / h64.abs().nanmean(0)).max().item(), 1e-5, ms)
    g, ms = timed(lambda: ht.nanvar(xn, axis=0))
    ref = ((h64 - ref) ** 2).nanmean(0)
    hold("nanvar(axis=0), NaNs planted", g, ((g.larray.double() - ref).abs() / ref).max().item(),
         1e-4, ms)
    del holes, xn, h64
    g, ms = timed(lambda: ht.cumsum(x, axis=0))
    ref = x64.cumsum(0)
    err = ((g.larray.double() - ref).abs() / x64.abs().cumsum(0).clamp(min=1.0)).max().item()
    del ref
    hold("cumsum(axis=0)", g, err, 1e-5, ms)
    del g
    before = ht.launch_counts()["moments"]
    (n_c, mu_c, m2_c), ms = timed(lambda: ht.chunk_moments(x))
    k2 = ht.launch_counts()["moments"] - before
    err = max(((mu_c.double() - mu64).abs() / (mu64.abs() + x64.std(0))).max().item(),
              ((m2_c.double() - m2 * rows).abs() / (m2 * rows)).max().item())
    hold("chunk_moments", (n_c, mu_c, m2_c), err, 1e-4, ms, k2_launches=k2)
    check("chunk_moments: one K2 launch", k2 == 1 and n_c == rows, launches=k2)
    launches = dict(ht.launch_counts())
    emit({"phase": "statistics path", "shape": [rows, cols], "results": results,
          "launches": launches})
    del x, xt, x64, w, labels
    return launches


def manipulations_path(ht, dev, smi):
    """Indexing and the manipulations at bench.py's moments shape through
    the user entry points, each checked on the card (bit for bit against
    torch's own operations where the result is exact, against float64 on
    the host for the percentiles) with its wall time. No kernel of csrc/
    lies on this path but the random draw of its inputs. Returns the launch
    counts over the path."""
    import numpy as np
    import torch

    rows, cols = GOLDEN_RANDN_SHAPE
    ht.reset_launch_counts()
    ht.random.seed(0)
    x = ht.random.randn(rows, cols, split=0)
    ints = ht.random.randint(0, 2 ** 20, (rows,), split=0)
    xt = x.larray
    results = {}

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = materialize(fn())
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    def hold(name, ok, ms, **extra):
        results[name] = {"wall_ms": ms, "ok": bool(ok), **extra}
        check(f"manipulations {name}", ok, wall_ms=ms, **extra)

    for descending in (False, True):
        (v, i), ms = timed(lambda: ht.sort(x, axis=0, descending=descending))
        rv, ri = torch.sort(xt, dim=0, stable=True, descending=descending)
        back = torch.equal(torch.gather(xt, 0, i.larray), v.larray)
        hold(f"sort(axis=0, descending={descending})", torch.equal(v.larray, rv)
             and torch.equal(i.larray, ri) and back and v.split == 0, ms,
             bitwise_vs_torch_sort=True)
        del v, i, rv, ri
    q = [5, 25, 50, 75, 95]
    p, ms = timed(lambda: ht.percentile(x, q, axis=0))
    med, ms_med = timed(lambda: ht.median(x, axis=0))
    picked = [0, 17, 40, 63]
    host = xt[:, picked].double().cpu().numpy()
    want = np.percentile(host, q, axis=0)
    err = float(np.abs(p.larray[:, picked].cpu().numpy() - want).max())
    err_med = float(np.abs(med.larray[picked].cpu().numpy() - np.median(host, axis=0)).max())
    hold("percentile([5, 25, 50, 75, 95], axis=0)", p.shape == (5, cols) and err <= 1e-12, ms,
         columns_checked=picked, max_abs_err_vs_float64=err, tolerance=1e-12)
    hold("median(axis=0)", med.shape == (cols,) and err_med <= 1e-12, ms_med,
         max_abs_err_vs_float64=err_med, tolerance=1e-12)
    del p, med, host
    (u, inv), ms = timed(lambda: ht.unique(ints, return_inverse=True))
    ru, rinv = torch.unique(ints.larray, sorted=True, return_inverse=True)
    hold("unique(ints, return_inverse=True)", torch.equal(u.larray, ru)
         and torch.equal(inv.larray, rinv), ms, n_unique=int(ru.numel()))
    del u, inv, ru, rinv
    (tv, ti), ms = timed(lambda: ht.topk(x, 64, dim=0))
    rv, ri = torch.sort(xt, dim=0, stable=True, descending=True)
    hold("topk(x, 64, dim=0)", torch.equal(tv.larray, rv[:64]) and torch.equal(ti.larray, ri[:64]),
         ms)
    del tv, ti, rv, ri
    g, ms = timed(lambda: x[::3])
    hold("x[::3]", torch.equal(g.larray, xt[::3]) and g.shape == ((rows + 2) // 3, cols), ms)
    idx = ht.random.randint(0, rows, (rows // 8,))
    g, ms = timed(lambda: x[idx])
    hold(f"x[idx], {rows // 8:,} random rows", torch.equal(g.larray, xt[idx.larray]), ms)
    g, ms = timed(lambda: x[x[:, 0] > 0])
    hold("x[x[:, 0] > 0]", torch.equal(g.larray, xt[xt[:, 0] > 0]), ms, rows=g.shape[0])
    g, ms = timed(lambda: x[x > 2])
    hold("x[x > 2]", torch.equal(g.larray, xt[xt > 2]), ms, selected=g.shape[0])
    g, ms = timed(lambda: ht.reshape(x, (rows // 2, 2 * cols)))
    hold(f"reshape(x, ({rows // 2:_}, {2 * cols}))",
         torch.equal(g.larray, xt.reshape(rows // 2, 2 * cols)), ms)
    g, ms = timed(lambda: ht.concatenate([x[:rows // 2], x[rows // 2:]], axis=0))
    hold("concatenate of two halves", torch.equal(g.larray, xt) and g.split == 0, ms)
    g, ms = timed(lambda: ht.flip(x, 0))
    hold("flip(x, 0)", torch.equal(g.larray, xt.flip(0)), ms)
    g, ms = timed(lambda: ht.roll(x, 1000, 0))
    hold("roll(x, 1000, 0)", torch.equal(g.larray, torch.roll(xt, 1000, 0)), ms)
    del g
    want = torch.where(xt > 3, 0.0, xt)
    _, ms = timed(lambda: x.__setitem__(x > 3, 0))
    hold("x[x > 3] = 0", torch.equal(x.larray, want) and not bool((x.larray > 3).any()), ms)
    del want
    launches = dict(ht.launch_counts())
    emit({"phase": "manipulations path", "shape": [rows, cols], "card": smi, "results": results,
          "launches": launches})
    del x, xt, ints, idx
    return launches


EXACT_TYPES = ("bool", "int8", "int32", "int64", "uint8", "uint32")
EXACT_N = 1024
WIDE_TYPES = ("uint16", "uint32", "uint64")
# bench.py's lasso row (:341-356) and spectral row (:439-459), and the
# solver phase's s.p.d. system
LASSO = (2_000_000, 64, 200, 0.01)
# one lasso epoch of the private CUDA graph the epoch was before the registry
# took it (device ms, kernels; H100 SXM, PR 11), and the penalties of the
# regularisation path that reuses the registry's program
LASSO_PRIVATE_GRAPH = {"epoch_ms": 3.21, "kernels": 970}
LASSO_PATH_LAMS = (0.1, 0.03, 0.001)
SPECTRAL = (8192, 32, 8, 64, 0.05)
CG_N = 4096


def exact_phase(ht, dev, time_ms):
    """matmul and dot of bool and the integer types at 1024^2 on the card,
    exactly as numpy's (bool: True where some pair is; the integers wrap
    modulo 2^w), with the card's time of the product."""
    import numpy as np
    import torch

    rng = np.random.default_rng(11)
    results = {}
    for name in EXACT_TYPES:
        if name == "bool":
            a, b = (rng.integers(0, 2, (EXACT_N, EXACT_N)).astype(bool) for _ in range(2))
        else:
            info = np.iinfo(name)
            a, b = (rng.integers(info.min, info.max, (EXACT_N, EXACT_N), dtype=name,
                                 endpoint=True) for _ in range(2))
        x, y = ht.array(a), ht.array(b)
        got = (x @ y).numpy()
        got_dot = ht.dot(x[0], y[:, 0]).numpy()
        with np.errstate(over="ignore"):
            want = (a.astype(np.int64) @ b.astype(np.int64)) > 0 if name == "bool" else a @ b
            want_dot = np.dot(a[0].astype(np.int64), b[:, 0].astype(np.int64)) > 0 \
                if name == "bool" else np.dot(a[0], b[:, 0])
        ms = time_ms(lambda: x @ y, 5)
        ok = got.dtype == want.dtype and np.array_equal(got, want) and \
            np.array_equal(got_dot, want_dot)
        results[name] = {"ok": bool(ok), "matmul_ms": ms}
        check(f"exact products {name} {EXACT_N}^2 equal numpy", ok, matmul_ms=ms)
        del x, y
    emit({"phase": "exact products", "n": EXACT_N, "results": results})


def unsigned_phase(ht, dev):
    """uint16, uint32 and uint64 on the card: +, > 2, a mask, max, argmax,
    cumsum, floor division, remainder, sort and the float64 conversion of
    values across the whole range (past 2^31 and 2^63), exactly as numpy's
    (cumsum in the type, wrapping as the JAX package's does)."""
    import numpy as np

    rng = np.random.default_rng(12)
    results = {}
    for name in WIDE_TYPES:
        info = np.iinfo(name)
        a, b = (rng.integers(0, info.max, (1024, 1024), dtype=name, endpoint=True)
                for _ in range(2))
        a[0, 0], a[1, 1] = info.max, 2 ** (info.bits - 1) + 5
        x, y = ht.array(a), ht.array(b)
        with np.errstate(over="ignore", divide="ignore"):
            cases = {
                "x + y": ((x + y).numpy(), a + b),
                "x > 2": ((x > 2).numpy(), a > 2),
                "x[x > 2]": (x[x > 2].numpy(), a[a > 2]),
                "max": (ht.max(x).numpy(), a.max()),
                "argmax": (ht.argmax(x).numpy(), a.argmax()),
                "min(axis=0)": (ht.min(x, axis=0).numpy(), a.min(axis=0)),
                "cumsum(axis=0)": (ht.cumsum(x, 0).numpy(), np.cumsum(a, 0, dtype=a.dtype)),
                "x // (y | 1)": ((x // (y | 1)).numpy(), a // (b | 1)),
                "x % (y | 1)": ((x % (y | 1)).numpy(), a % (b | 1)),
                "sort(axis=0)": (ht.sort(x, axis=0)[0].numpy(), np.sort(a, axis=0)),
                "astype(float64)": (x.astype(ht.float64).numpy(), a.astype(np.float64)),
            }
        for case, (got, want) in cases.items():
            ok = np.asarray(got).dtype == np.asarray(want).dtype and np.array_equal(got, want)
            results[f"{name} {case}"] = bool(ok)
            check(f"unsigned {name} {case} equals numpy", ok)
        del x, y
    emit({"phase": "unsigned", "shape": [1024, 1024], "results": results})


def _lasso_f64(x, y, lam, sweeps):
    """The coordinate descent of the JAX package's _cd_sweep in float64, in
    plain torch on the card: the reference for the lasso path."""
    import torch

    n = x.shape[0]
    xt = torch.cat([torch.ones((n, 1), dtype=torch.float64, device=x.device),
                    x.double()], dim=1).t().contiguous()
    yd = y.double()
    z = (xt * xt).sum(dim=1) / n
    theta = torch.zeros(xt.shape[0], dtype=torch.float64, device=x.device)
    for _ in range(sweeps):
        y_est = theta @ xt
        for j in range(xt.shape[0]):
            rho = torch.dot(xt[j], yd - y_est + theta[j] * xt[j]) / n
            if j > 0:
                rho = torch.sign(rho) * torch.clamp(rho.abs() - lam, min=0.0)
            new = rho / torch.clamp(z[j], min=1e-30)
            y_est = y_est + (new - theta[j]) * xt[j]
            theta[j] = new
    return theta


def lasso_path(ht, dev, smi):
    """bench.py's lasso row through the user entry points: x = randn(2,000,000,
    64, split=0), y = x @ randn(64, 1) from ht.random, Lasso(lam=0.01,
    max_iter=200, tol=0): one warm-up fit and three timed, the device time
    and busy share of one fit under the profiler, the launches and the
    device time of one epoch through its registry program (site
    streaming.lasso, the graph the fit captured: a hit) against the eager
    epoch on the same state and beside the private graph's figures before
    the registry took the epoch (LASSO_PRIVATE_GRAPH), a regularisation path
    of three more penalties that shares the one program and parameter set
    in constant memory, and coef_/intercept_ against the same descent in
    float64.
    No kernel of csrc/ lies on this path but the random draw of its inputs.
    Returns the launch counts over the path."""
    import gc

    import torch
    from torch.profiler import ProfilerActivity, profile

    from heat_tpu_torch.core import program_cache
    from heat_tpu_torch.regression.lasso import _curvature, _design, _epoch, _epoch_program

    rows, cols, sweeps, lam = LASSO
    ht.reset_launch_counts()
    ht.random.seed(0)
    x = ht.random.randn(rows, cols, dtype=ht.float32, split=0)
    y = ht.matmul(x, ht.random.randn(cols, 1, dtype=ht.float32))

    def fit():
        torch.cuda.synchronize()
        t = time.perf_counter()
        est = ht.regression.Lasso(lam=lam, max_iter=sweeps, tol=0.0).fit(x, y)
        torch.cuda.synchronize()
        return est, (time.perf_counter() - t) * 1e3

    est, warm_ms = fit()
    walls = [fit()[1] for _ in range(3)]
    launches = dict(ht.launch_counts())
    check("lasso ran max_iter epochs at tol=0", est.n_iter == sweeps, n_iter=est.n_iter)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, prof_wall = fit()
    device_ms = sum(ev.self_device_time_total for ev in prof.key_averages()
                    if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e3

    # one epoch through its registry program (site streaming.lasso: a CUDA
    # graph captured at the fit's first epoch) against the same epoch eagerly
    xt, yb, _ = _design(x, y, torch.float32)
    z = _curvature(xt, rows, None)
    start = est.theta.larray.clone()
    lam_t = torch.tensor(lam, device=dev)
    n_t = torch.tensor(float(rows), device=dev)
    eager, _ = _epoch(start.clone(), lam_t, n_t, xt, yb, z, comm=None)
    before = program_cache.site_stats("streaming.lasso")
    prog = _epoch_program(xt, None)
    graphed, _ = prog(start.clone(), lam_t, n_t, xt, yb, z)
    torch.cuda.synchronize()
    after = program_cache.site_stats("streaming.lasso")
    check("lasso's epoch is the registry program the fit captured (a hit, no build)",
          after["hits"] == before["hits"] + 1 and after["misses"] == before["misses"],
          before=before, after=after)
    replay_err = float((graphed - eager).abs().max())
    check("lasso registry epoch equals the eager epoch", replay_err == 0.0,
          max_abs_diff=replay_err)
    with profile(activities=[ProfilerActivity.CUDA]) as prof_epoch:
        prog(start, lam_t, n_t, xt, yb, z)
        torch.cuda.synchronize()
    kernels_per_epoch = sum(ev.count for ev in prof_epoch.key_averages()
                            if ev.device_type == torch.autograd.DeviceType.CUDA)
    epoch_start, epoch_end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    epoch_start.record()
    for _ in range(10):
        prog(start, lam_t, n_t, xt, yb, z)
    epoch_end.record()
    epoch_end.synchronize()
    epoch_ms = epoch_start.elapsed_time(epoch_end) / 10
    del eager, graphed, prog, xt, yb, z

    # a regularisation path: more penalties on the same design hit the one
    # program, whose one parameter set holds the one static copy of x
    gc.collect()
    torch.cuda.synchronize()
    path_allocated = [torch.cuda.memory_allocated(dev)]
    before = program_cache.site_stats("streaming.lasso")
    for path_lam in LASSO_PATH_LAMS:
        ht.regression.Lasso(lam=path_lam, max_iter=2, tol=0.0).fit(x, y)
        gc.collect()
        torch.cuda.synchronize()
        path_allocated.append(torch.cuda.memory_allocated(dev))
    after = program_cache.site_stats("streaming.lasso")
    param_sets = [k for k in program_cache._SHARED.keys() if k[0] == "streaming.lasso"]
    check("lasso: a path over three penalties hits the one program and parameter set in "
          "constant memory",
          after["misses"] == before["misses"]
          and after["hits"] == before["hits"] + len(LASSO_PATH_LAMS)
          and len(param_sets) == 1 and len(set(path_allocated)) == 1,
          allocated=path_allocated, param_sets=len(param_sets), before=before, after=after)

    theta64 = _lasso_f64(x.larray, y.larray[:, 0], lam, sweeps)
    got = est.theta.larray.double()
    err = float((got - theta64).abs().max())
    tol = 2e-3 * max(1.0, float(theta64.abs().max()))
    check("lasso coef_ and intercept_ within 2e-3 of the float64 descent", err <= tol,
          max_abs_err=err, tolerance=tol)
    # bytes: the function must read x_j, y and y_est and write y_est for each
    # coordinate, and read X^T and write y_est once an epoch; the code as
    # written reads 9 and writes 4 vectors a coordinate (y - y_est, t_j x_j,
    # their sum, the dot, the addcmul)
    vec = rows * 4
    must = sweeps * ((cols + 1) * 4 * vec + (cols + 1) * vec + vec)
    code = sweeps * ((cols + 1) * 13 * vec + (cols + 1) * vec + vec)
    bound_ms = must / HBM_BYTES_PER_S * 1e3
    emit({"phase": "lasso path", "card": smi, "shape": [rows, cols], "sweeps": sweeps,
          "lam": lam, "warmup_fit_ms": warm_ms, "fit_wall_ms": walls,
          "profiled_fit_wall_ms": prof_wall, "profiled_fit_device_ms": device_ms,
          "device_busy_share": device_ms / prof_wall, "registry_epoch_ms": epoch_ms,
          "registry_launches_per_epoch": kernels_per_epoch,
          "registry_vs_eager_max_abs_diff": replay_err,
          "private_graph_epoch_ms": LASSO_PRIVATE_GRAPH["epoch_ms"],
          "private_graph_launches_per_epoch": LASSO_PRIVATE_GRAPH["kernels"],
          "path_lams": list(LASSO_PATH_LAMS), "path_allocated_bytes": path_allocated,
          "coef_max_abs_err_vs_float64": err, "tolerance": tol,
          "bytes_bound_gb": must / 1e9, "bytes_bound_ms": bound_ms,
          "bytes_as_written_gb": code / 1e9, "bytes_as_written_ms": code / HBM_BYTES_PER_S * 1e3,
          "launches": launches})
    del x, y, est
    return launches


def _adjusted_rand(a, b):
    """The adjusted Rand index of two labelings."""
    import numpy as np

    a, b = np.asarray(a), np.asarray(b)
    table = np.zeros((a.max() + 1, b.max() + 1), dtype=np.int64)
    np.add.at(table, (a, b), 1)
    comb = lambda v: (v * (v - 1) / 2.0).sum()
    pairs, rows, cols = comb(table), comb(table.sum(1)), comb(table.sum(0))
    expected = rows * cols / comb(np.array([a.size]))
    return float((pairs - expected) / (0.5 * (rows + cols) - expected))


def spectral_path(ht, dev, smi, time_ms):
    """bench.py's spectral row through the user entry points: 8192 x 32
    randn points shifted by randint(0, 8) * 8, Spectral(n_clusters=8,
    gamma=0.05, n_lanczos=64). The launches of the one fit (rbf on the
    cdist kernel's rbf epilogue, KMeans on the Lloyd kernel), the labels
    against the generating blob ids (adjusted Rand index), each stage's
    wall time, the Lanczos basis (V^T V = I, V^T L V = T), and the two
    kernels against their plain versions at these shapes with their times.
    Returns (launch counts over the fit, the kernels' rows)."""
    import numpy as np
    import torch

    from heat_tpu_torch.cluster.cuda_lloyd import lloyd_update, lloyd_update_plain
    from heat_tpu_torch.spatial.cuda_cdist import euclid, euclid_plain, last_variant

    n, d, k, m, gamma = SPECTRAL
    ht.random.seed(0)
    base = ht.random.randn(n, d, dtype=ht.float32, split=0)
    ids = ht.random.randint(0, k, (n, 1))
    x = base + ids.astype(ht.float32) * 8.0
    truth = ids.numpy()[:, 0]

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = materialize(fn())
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    ht.random.seed(1)
    ht.reset_launch_counts()
    sp, fit_ms = timed(lambda: ht.cluster.Spectral(n_clusters=k, gamma=gamma,
                                                   n_lanczos=m).fit(x))
    launches = dict(ht.launch_counts())
    cdist_variant = last_variant()
    check("spectral fit launched the cdist and Lloyd kernels",
          launches["cdist"] > 0 and launches["lloyd"] > 0, launches=launches,
          cdist_variant=cdist_variant)
    ari = _adjusted_rand(sp.labels_.numpy(), truth)
    # the JAX package's labels on this input reach 0.8349 (measured on the CPU):
    # the norm_sym embedding leaves each blob along a ray of its degrees, so
    # KMeans splits one blob and merges two
    check("spectral labels recover the blob ids: adjusted Rand index >= 0.80", ari >= 0.80,
          adjusted_rand_index=ari)

    sigma = float(np.sqrt(1.0 / (2.0 * gamma)))
    stages = {}
    _, stages["rbf"] = timed(lambda: ht.spatial.rbf(x, sigma=sigma, quadratic_expansion=True))
    L, laplacian_ms = timed(lambda: sp._laplacian.construct(x))
    stages["laplacian (rbf included)"] = laplacian_ms
    (V, T), stages["lanczos"] = timed(lambda: ht.linalg.lanczos(L, m))
    t_host = T.numpy().astype(np.float64)
    (eigval, eigvec), stages["eigh of T (host)"] = timed(lambda: np.linalg.eigh(t_host))
    emb = sp._embedding
    ht.random.seed(1)
    _, stages["kmeans"] = timed(lambda: ht.cluster.KMeans(n_clusters=k, init="probability_based")
                                .fit(emb))
    v64 = V.larray.double()
    orth = float((v64.t() @ v64 - torch.eye(m, dtype=torch.float64, device=v64.device))
                 .abs().max())
    krylov = float((v64.t() @ (L.larray.double() @ v64) - torch.as_tensor(t_host, device=v64.device))
                   .abs().max())
    check("lanczos basis orthonormal: max|V^T V - I| <= 1e-4", orth <= 1e-4, value=orth)
    check("lanczos relation: max|V^T L V - T| <= 1e-3", krylov <= 1e-3, value=krylov)

    # the two kernels at the shapes this path gives them, against their plain versions
    xt = x.larray.contiguous()
    gamma_rbf = 1.0 / (2.0 * sigma * sigma)
    k3, k3_plain = euclid(xt, xt, gamma_rbf, epilogue="rbf"), euclid_plain(
        xt, xt, gamma_rbf, epilogue="rbf", precision=None)
    k3_err = float((k3 - k3_plain).abs().max())
    # on d2 within 2e-5 (|x|^2 + |y|^2) + 1e-6, times gamma for rbf (as the cdist checks)
    norms = (xt * xt).sum(1)
    k3_worst = float(((k3 - k3_plain).abs() / (gamma_rbf * (
        2e-5 * (norms[:, None] + norms[None, :]) + 1e-6))).max())
    centers = emb.larray[:k].clone()
    sums, counts = lloyd_update(emb.larray, centers)
    p_sums, p_counts = lloyd_update_plain(emb.larray, centers)
    k4_err = float((sums - p_sums).abs().max())
    check("spectral shape: cdist rbf kernel within gamma (2e-5 (|x|^2 + |y|^2) + 1e-6) of its "
          "plain version", k3_worst <= 1.0, max_abs_err=k3_err, worst_over_tolerance=k3_worst)
    check("spectral shape: Lloyd kernel counts exact, sums within 1e-4 of sum|x|",
          torch.equal(counts, p_counts) and k4_err <= 1e-4 * float(emb.larray.abs().sum()),
          max_abs_err=k4_err)
    k3_ms = time_ms(lambda: euclid(xt, xt, gamma_rbf, epilogue="rbf"), 20)
    k3_plain_ms = time_ms(lambda: euclid_plain(xt, xt, gamma_rbf, epilogue="rbf",
                                               precision=None), 5)
    k4_ms = time_ms(lambda: lloyd_update(emb.larray, centers), 50)
    k4_plain_ms = time_ms(lambda: lloyd_update_plain(emb.larray, centers), 50)
    # bounds: K3 writes the n x n f32 result (3 TF32 products of 2 n^2 d
    # operations each); K4 reads the (n, k) embedding (2 n k^2 f32 operations)
    k3_bound = bound(n * d * 4 + n * n * 4, 3 * 2 * n * n * d, TF32_FLOPS_PER_S)
    k4_bound = bound(n * k * 4, 3 * 2 * n * k * k, TF32_FLOPS_PER_S)
    rows = {
        "cdist": {"shape": f"spectral rbf ({n}, {n}, {d}) f32", "launches": launches["cdist"],
                  "variant": cdist_variant, "max_abs_err": k3_err, "ms": k3_ms,
                  "plain_ms": k3_plain_ms, "bound_ms": k3_bound[0], "bound_by": k3_bound[1],
                  "library_ms": None},
        "lloyd": {"shape": f"spectral KMeans pass ({n}, {k}), k = {k}",
                  "launches": launches["lloyd"], "max_abs_err": k4_err, "ms": k4_ms,
                  "plain_ms": k4_plain_ms, "bound_ms": k4_bound[0], "bound_by": k4_bound[1],
                  "library_ms": None},
    }
    emit({"phase": "spectral path", "card": smi, "shape": [n, d], "k": k, "m": m,
          "gamma": gamma, "fit_wall_ms": fit_ms, "stage_wall_ms": stages,
          "adjusted_rand_index": ari, "VtV_minus_I": orth, "VtLV_minus_T": krylov,
          "launches": launches, "kernels": rows})
    del x, base, L, V, T, xt, k3, k3_plain, sp, norms
    return launches, rows


def solver_phase(ht, dev, smi):
    """cg on a 4096^2 s.p.d. f32 system (M M^T / n + I from a seeded
    generator on the card, A split along its rows), with its relative
    residual and wall time."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(5)
    m = torch.randn((CG_N, CG_N), generator=gen, device=dev)
    a = m @ m.T / CG_N + torch.eye(CG_N, device=dev)
    b = torch.randn((CG_N,), generator=gen, device=dev)
    A, B = ht.array(a, split=0), ht.array(b)
    x0 = ht.zeros(CG_N)
    ht.linalg.cg(A, B, x0)
    torch.cuda.synchronize()
    t = time.perf_counter()
    x = ht.linalg.cg(A, B, x0)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    a64, b64 = a.double(), b.double()
    res = float(torch.linalg.vector_norm(a64 @ x.larray.double() - b64) /
                torch.linalg.vector_norm(b64))
    check("cg relative residual <= 1e-5", res <= 1e-5, relative_residual=res)
    emit({"phase": "solver", "card": smi, "n": CG_N, "cg_wall_ms": wall,
          "relative_residual": res})


# bench.py:461-482's sparse row (n, spmv repetitions, density); the sparse
# spectral path's threshold (an eNeighbour graph on SPECTRAL's data); the
# estimators' data (rows, columns, blobs, iterations) and KNN's training and
# query rows and k
SPARSE = (16384, 5, 0.01)
SPARSE_THRESHOLD = 0.01
ESTIMATORS = (1_000_000, 64, 8, 10)
KNN = (65_536, 16_384, 5)


def _timed(fn):
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = materialize(fn())
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def _sum_tolerance(abs_terms, terms):
    """Per entry: the float32 error bound of a sum of ``terms`` products
    (each rounded once, then added in any order), 2^-23 (terms + 1) times
    the sum of the magnitudes."""
    return (terms.double() + 1.0) * 2.0 ** -23 * abs_terms + 1e-30


def sparse_path(ht, dev, smi, time_ms):
    """bench.py's sparse row uncut: the 16384^2 operand at 1% density drawn
    as bench.py draws it (np.random.default_rng(11)), csr_from_dense, x from
    the same generator, 5 x spmv(A, x, out_split=None); against a float64
    product of the masked dense operand on the card, an spmm of 8 columns,
    transpose().transpose() == A and a staged transpose bit for bit, whether
    two identical spmv agree bit for bit; times: csr_from_dense wall, spmv
    wall and device (profiler), torch.mv of the dense operand, the CSR
    product alone, and the bytes bound. Returns the kernels' launches."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    ns, reps, density = SPARSE
    rng = np.random.default_rng(11)
    dense_h = rng.standard_normal((ns, ns)).astype(np.float32)
    dense_h[rng.random((ns, ns)) > density] = 0.0
    xh = rng.standard_normal(ns).astype(np.float32)
    x8_h = rng.standard_normal((ns, 8)).astype(np.float32)

    ht.reset_launch_counts()
    A, build_ms = _timed(lambda: ht.sparse.csr_from_dense(dense_h))
    x = ht.array(xh)
    _, first_ms = _timed(lambda: ht.sparse.spmv(A, x, out_split=None))  # builds the CSR tensor
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        y = ht.sparse.spmv(A, x, out_split=None)
    torch.cuda.synchronize()
    spmv_wall = (time.perf_counter() - t) * 1e3 / reps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            ht.sparse.spmv(A, x, out_split=None)
        torch.cuda.synchronize()
    spmv_device = sum(ev.self_device_time_total for ev in prof.key_averages()
                      if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / reps
    spmv_device = spmv_device or None  # the profiler saw no device activity: not measured
    spmv_events = time_ms(lambda: ht.sparse.spmv(A, x, out_split=None), 20)
    y2 = ht.sparse.spmv(A, x, out_split=None)
    repeat_bitwise = bool(torch.equal(y.larray, y2.larray))
    launches = dict(ht.launch_counts())

    dense = torch.from_numpy(dense_h).to(dev)
    xd = x.larray
    mv_ms = time_ms(lambda: torch.mv(dense, xd), 20)
    csr = A._csr(torch.float32)
    csr_ms = time_ms(lambda: csr @ xd, 20)
    mask = dense != 0
    row_nnz = mask.sum(1)
    ref = dense.double() @ xd.double()
    err = (y.larray.double() - ref).abs()
    tol = _sum_tolerance(dense.abs().double() @ xd.abs().double(), row_nnz)
    check("sparse spmv within 2^-23 (row nnz + 1) sum|a x| of float64", bool((err <= tol).all()),
          max_abs_err=float(err.max()), worst_over_tolerance=float((err / tol).max()))
    X8 = ht.array(x8_h)
    Y8 = ht.sparse.spmm(A, X8, out_split=None)
    ref8 = dense.double() @ X8.larray.double()
    err8 = (Y8.larray.double() - ref8).abs()
    tol8 = _sum_tolerance(dense.abs().double() @ X8.larray.abs().double(), row_nnz[:, None])
    check("sparse spmm (8 columns) within the same bound", bool((err8 <= tol8).all()),
          max_abs_err=float(err8.max()))
    del ref, ref8, err8, tol8, mask

    def same(a, b):
        c = a.lnnz
        return (a.shape == b.shape and a.counts.tolist() == b.counts.tolist()
                and a.capacity == b.capacity and torch.equal(a.indptr, b.indptr)
                and torch.equal(a.indices[:c], b.indices[:c])
                and torch.equal(a.values[:c], b.values[:c]))

    T, t_first_ms = _timed(lambda: A.transpose())
    T, t_ms = _timed(lambda: A.transpose())
    TT = T.transpose()
    slab = max(1, A.capacity // 4)
    T4, t4_ms = _timed(lambda: ht.sparse.transpose(A, slab=slab))
    check("transpose().transpose() equals A bit for bit", same(TT, A))
    check("transpose(slab=cap // 4) equals transpose() bit for bit", same(T4, T), slab=slab)
    check("sparse path launched no kernel of csrc/", not any(launches.values()), launches=launches)
    nnz = A.nnz
    # spmv's bytes: each stored element's column id and value, the row
    # pointers, x and y; 2 nnz float32 operations
    sp_bound = bound(nnz * 8 + (ns + 1) * 4 + 2 * ns * 4, 2 * nnz)
    emit({"phase": "sparse path", "card": smi, "n": ns, "density": density, "nnz": nnz,
          "capacity": A.capacity, "csr_from_dense_wall_ms": build_ms, "first_spmv_wall_ms": first_ms,
          "spmv_wall_ms": spmv_wall, "spmv_device_ms_profiler": spmv_device,
          "spmv_cuda_events_ms": spmv_events, "csr_product_alone_ms": csr_ms,
          "dense_torch_mv_ms": mv_ms, "spmv_bound_ms": sp_bound[0], "bound_by": sp_bound[1],
          "first_transpose_wall_ms": t_first_ms, "transpose_wall_ms": t_ms,
          "staged_transpose_wall_ms": t4_ms, "slab": slab,
          "spmv_repeat_bit_identical": repeat_bitwise, "launches": launches})
    del dense, dense_h, A, T, TT, T4, csr
    return launches


def sparse_spectral_path(ht, dev, smi, time_ms):
    """bench.py's spectral data (8192 x 32 randn plus randint(0, 8) * 8)
    through Spectral(n_clusters=8, gamma=0.05, metric='rbf',
    laplacian='eNeighbour', threshold=0.01, boundary='lower', n_lanczos=64):
    L a SparseDNDarray (density printed), K3 and K4 launched and held
    against their plain versions at these shapes, each stage's wall time,
    the labels against the blob ids and against the same Spectral with
    sparse=False, V^T V = I and V^T L V = T (L V by spmm). Returns (the
    launches, the kernels' rows, the eNeighbour adjacency)."""
    import numpy as np
    import torch

    from heat_tpu_torch.cluster.cuda_lloyd import lloyd_update, lloyd_update_plain
    from heat_tpu_torch.sparse.ops import _pack_rows
    from heat_tpu_torch.spatial.cuda_cdist import euclid, euclid_plain, last_variant

    n, d, k, m, gamma = SPECTRAL
    ht.random.seed(0)
    base = ht.random.randn(n, d, dtype=ht.float32, split=0)
    ids = ht.random.randint(0, k, (n, 1))
    x = base + ids.astype(ht.float32) * 8.0
    truth = ids.numpy()[:, 0]
    kw = dict(n_clusters=k, gamma=gamma, metric="rbf", laplacian="eNeighbour",
              threshold=SPARSE_THRESHOLD, boundary="lower", n_lanczos=m)

    ht.random.seed(1)
    ht.reset_launch_counts()
    sp, fit_ms = _timed(lambda: ht.cluster.Spectral(**kw).fit(x))
    launches = dict(ht.launch_counts())
    cdist_variant = last_variant()
    ht.random.seed(1)
    _, warm_fit_ms = _timed(lambda: ht.cluster.Spectral(**kw).fit(x))
    check("sparse spectral fit launched the cdist, Lloyd and random kernels",
          launches["cdist"] > 0 and launches["lloyd"] > 0 and launches["random"] > 0,
          launches=launches, cdist_variant=cdist_variant)
    ari = _adjusted_rand(sp.labels_.numpy(), truth)
    # the JAX package's labels on this input (CPU, its sparse and its dense
    # eNeighbour paths alike): 0.8354
    check("sparse spectral labels recover the blob ids: adjusted Rand index >= 0.80",
          ari >= 0.80, adjusted_rand_index=ari)

    lap = sp._laplacian
    stages = {}
    (rows, cols, vals, dt), stages["blocked rbf, threshold, compaction"] = _timed(
        lambda: lap._sparse_adjacency(x))
    A, stages["pack rows (csr)"] = _timed(lambda: _pack_rows(rows, cols, vals, (n, n), x.comm,
                                                             x.device, dt))
    del rows, cols, vals
    ones = ht.ones(n, dtype=dt)
    L, stages["degree spmv and value rewrite"] = _timed(
        lambda: lap._sparse_laplacian_values(A, ht.sparse.spmv(A, ones, out_split=None), dt))
    L_fit, stages["construct (all of the above)"] = _timed(lambda: lap.construct(x))
    check("eNeighbour L is a SparseDNDarray (sparse=None, under the density gate)",
          isinstance(L_fit, ht.sparse.SparseDNDarray), density=A.density, nnz=A.nnz)
    (V, T), stages["lanczos"] = _timed(lambda: ht.linalg.lanczos(L, m))
    t_host = T.numpy().astype(np.float64)
    _, stages["eigh of T (host)"] = _timed(lambda: np.linalg.eigh(t_host))
    emb = sp._embedding
    ht.random.seed(1)
    _, stages["kmeans"] = _timed(lambda: ht.cluster.KMeans(n_clusters=k,
                                                           init="probability_based").fit(emb))
    v64 = V.larray.double()
    orth = float((v64.t() @ v64 - torch.eye(m, dtype=torch.float64, device=v64.device))
                 .abs().max())
    LV = ht.sparse.spmm(L, V).larray.double()
    krylov = float((v64.t() @ LV - torch.as_tensor(t_host, device=v64.device)).abs().max())
    check("sparse lanczos basis orthonormal: max|V^T V - I| <= 1e-4", orth <= 1e-4, value=orth)
    check("sparse lanczos relation (L V by spmm): max|V^T L V - T| <= 1e-3", krylov <= 1e-3,
          value=krylov)
    ht.random.seed(1)
    dense_sp, dense_ms = _timed(lambda: ht.cluster.Spectral(**kw, sparse=False).fit(x))
    ari_dense = _adjusted_rand(sp.labels_.numpy(), dense_sp.labels_.numpy())
    # the JAX package's sparse and dense labels on this input agree exactly (1.0)
    check("sparse spectral labels against sparse=False: adjusted Rand index >= 0.99",
          ari_dense >= 0.99, adjusted_rand_index=ari_dense)

    # K3 at the eNeighbour block shape and K4 at the embedding's, against their plain versions
    bs = min(n, (1 << 28) // (n * 4))
    xt = x.larray.contiguous()
    xb = xt[:bs].contiguous()
    gamma_rbf = gamma
    k3 = euclid(xb, xt, gamma_rbf, epilogue="rbf")
    k3_plain = euclid_plain(xb, xt, gamma_rbf, epilogue="rbf", precision=None)
    k3_err = float((k3 - k3_plain).abs().max())
    norms = (xt * xt).sum(1)
    k3_worst = float(((k3 - k3_plain).abs() / (gamma_rbf * (
        2e-5 * (norms[:bs, None] + norms[None, :]) + 1e-6))).max())
    centers = emb.larray[:k].clone()
    sums, counts = lloyd_update(emb.larray, centers)
    p_sums, p_counts = lloyd_update_plain(emb.larray, centers)
    k4_err = float((sums - p_sums).abs().max())
    check("sparse spectral block shape: cdist rbf kernel within gamma (2e-5 (|x|^2 + |y|^2) + "
          "1e-6) of its plain version", k3_worst <= 1.0, max_abs_err=k3_err,
          worst_over_tolerance=k3_worst)
    check("sparse spectral embedding: Lloyd kernel counts exact, sums within 1e-4 of sum|x|",
          torch.equal(counts, p_counts) and k4_err <= 1e-4 * float(emb.larray.abs().sum()),
          max_abs_err=k4_err)
    k3_ms = time_ms(lambda: euclid(xb, xt, gamma_rbf, epilogue="rbf"), 20)
    k3_plain_ms = time_ms(lambda: euclid_plain(xb, xt, gamma_rbf, epilogue="rbf",
                                               precision=None), 5)
    k4_ms = time_ms(lambda: lloyd_update(emb.larray, centers), 50)
    k4_plain_ms = time_ms(lambda: lloyd_update_plain(emb.larray, centers), 50)
    k3_bound = bound(n * d * 4 + bs * d * 4 + bs * n * 4, 3 * 2 * bs * n * d, TF32_FLOPS_PER_S)
    k4_bound = bound(n * k * 4, 3 * 2 * n * k * k, TF32_FLOPS_PER_S)
    rows_out = {
        "cdist": {"shape": f"eNeighbour block rbf ({bs}, {n}, {d}) f32",
                  "launches": launches["cdist"], "variant": cdist_variant, "max_abs_err": k3_err,
                  "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_bound[0],
                  "bound_by": k3_bound[1], "library_ms": None},
        "lloyd": {"shape": f"sparse spectral KMeans pass ({n}, {k}), k = {k}",
                  "launches": launches["lloyd"], "max_abs_err": k4_err, "ms": k4_ms,
                  "plain_ms": k4_plain_ms, "bound_ms": k4_bound[0], "bound_by": k4_bound[1],
                  "library_ms": None},
    }
    emit({"phase": "sparse spectral path", "card": smi, "shape": [n, d], "k": k, "m": m,
          "gamma": gamma, "threshold": SPARSE_THRESHOLD, "density": A.density, "nnz": A.nnz,
          "capacity": A.capacity, "first_fit_wall_ms": fit_ms, "warm_fit_wall_ms": warm_fit_ms,
          "stage_wall_ms": stages,
          "dense_eNeighbour_fit_wall_ms": dense_ms, "adjusted_rand_index": ari,
          "adjusted_rand_index_vs_dense": ari_dense, "VtV_minus_I": orth,
          "VtLV_minus_T": krylov, "launches": launches, "kernels": rows_out})
    del x, base, L, L_fit, V, T, xt, xb, k3, k3_plain, sp, dense_sp, LV, v64, norms
    return launches, rows_out, A


def components_phase(ht, A, smi):
    """connected_components of the sparse spectral path's eNeighbour
    adjacency with assume_symmetric=False (so the transpose runs), against
    scipy's weak components of the same coo(): the same partition, each
    label its component's least index; the rounds and the wall time.
    Returns the kernels' launches."""
    import numpy as np
    import scipy.sparse
    import scipy.sparse.csgraph

    calls = []
    real = ht.sparse.spmv

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    ht.reset_launch_counts()
    ht.sparse.spmv = counted  # counts the rounds: two products a round
    try:
        labels, ms = _timed(lambda: ht.graph.connected_components(A))
    finally:
        ht.sparse.spmv = real
    launches = dict(ht.launch_counts())
    got = labels.numpy()
    r, c, _ = A.coo()
    n = A.shape[0]
    graph = scipy.sparse.coo_matrix((np.ones(r.shape[0]), (r, c)), shape=(n, n)).tocsr()
    n_comp, want = scipy.sparse.csgraph.connected_components(graph, connection="weak")
    pairs = set(zip(got.tolist(), want.tolist()))
    same = len(pairs) == len(set(got.tolist())) == n_comp
    least = all(lab == np.flatnonzero(got == lab).min() for lab in np.unique(got))
    check("components: scipy's partition, each label its component's least index",
          same and least, components=n_comp)
    check("components launched no kernel of csrc/", not any(launches.values()), launches=launches)
    emit({"phase": "components", "card": smi, "n": n, "nnz": A.nnz, "components": n_comp,
          "rounds": len(calls) // 2, "wall_ms": ms, "launches": launches})
    return launches


def estimators_path(ht, dev, smi):
    """KMedians and KMedoids (8 clusters, 10 iterations), GaussianNB and
    KNeighborsClassifier(5) on 1,000,000 x 64 f32 in 8 blobs (randn plus
    randint(0, 8) * 8, ht.random seed 0), each checked in float64: the
    centers against numpy's median of each cluster's members (KMedoids: the
    data point L1-nearest to it), the labels as the L1 argmin, GaussianNB's
    theta_/var_ against numpy, KNN against a float64 brute force with ties
    by index. Returns the kernels' launches."""
    import numpy as np
    import torch

    rows, cols, k, iters = ESTIMATORS
    ht.random.seed(0)
    base = ht.random.randn(rows, cols, dtype=ht.float32, split=0)
    ids = ht.random.randint(0, k, (rows, 1))
    x = base + ids.astype(ht.float32) * 8.0
    y = ids[:, 0]
    del base
    x64 = x.larray.double()
    x_host = x.larray.cpu().numpy().astype(np.float64)
    scale = float(x64.abs().max())
    results = {}

    def l1_argmin(centers64):
        """(labels, distance of the nearest and second nearest) in float64."""
        out, gap = [], []
        for s in range(0, rows, 65536):
            dist = (x64[s:s + 65536, None, :] - centers64[None]).abs().sum(-1)
            two = torch.topk(dist, 2, dim=1, largest=False)
            out.append(two.indices[:, 0])
            gap.append((two.values[:, 1] - two.values[:, 0]) / two.values[:, 1])
        return torch.cat(out), torch.cat(gap)

    ht.reset_launch_counts()
    for name in ("KMedians", "KMedoids"):
        fit = lambda n_iter: getattr(ht.cluster, name)(n_clusters=k, max_iter=n_iter).fit(x)
        est, ms = _timed(lambda: fit(iters))
        _, warm_ms = _timed(lambda: fit(iters))
        centers = est.cluster_centers_.larray.double()
        labels = est.labels_.larray
        lab_h = labels.cpu().numpy()
        # the last update's members: the assignment to the previous iteration's
        # centers (the same fit stopped one iteration earlier)
        before = fit(est.n_iter_ - 1)
        prev = before.predict(x).numpy()
        medians = np.stack([np.median(x_host[prev == c], axis=0) if (prev == c).any()
                            else before.cluster_centers_.numpy()[c] for c in range(k)])
        if name == "KMedians":
            center_err = float(np.abs(centers.cpu().numpy() - medians).max())
            ok_centers = center_err <= 2.0 ** -22 * scale
        else:
            med = torch.as_tensor(medians, device=dev)
            best = torch.stack([(x64 - med[c]).abs().sum(1).min() for c in range(k)])
            own = (centers - med).abs().sum(1)
            center_err = float(((own - best) / best.clamp(min=1e-30)).max())
            is_row = all(bool((x.larray == est.cluster_centers_.larray[c]).all(1).any())
                         for c in range(k))
            ok_centers = is_row and center_err <= 1e-5
        want, gap = l1_argmin(centers)
        wrong = labels != want
        check(f"{name}: centers the float64 median of the last update's members"
              f"{' snapped to the L1-nearest row' if name == 'KMedoids' else ''}",
              ok_centers, n_iter=est.n_iter_, center_err=center_err)
        check(f"{name}: labels the float64 L1 argmin (a mismatch only at a relative gap <= 1e-5)",
              bool((gap[wrong] <= 1e-5).all()), mismatches=int(wrong.sum()))
        results[name] = {"fit_wall_ms": ms, "warm_fit_wall_ms": warm_ms, "n_iter": est.n_iter_,
                         "inertia": est.inertia_, "center_err": center_err,
                         "label_mismatches": int(wrong.sum()),
                         "adjusted_rand_index": _adjusted_rand(lab_h, y.numpy())}
        del est, centers, labels, want, gap

    nb, nb_ms = _timed(lambda: ht.naive_bayes.GaussianNB().fit(x, y))
    pred, nb_pred_ms = _timed(lambda: nb.predict(x))
    y_h = y.numpy()
    theta = np.stack([x_host[y_h == c].mean(0) for c in range(k)])
    var = np.stack([x_host[y_h == c].var(0) for c in range(k)]) + nb.epsilon_
    theta_err = float(np.abs(nb.theta_.numpy() - theta).max() / np.abs(theta).max())
    var_err = float(np.abs(nb.var_.numpy() - var).max() / np.abs(var).max())
    check("GaussianNB theta_ and var_ within 1e-9 of numpy float64", max(theta_err, var_err)
          <= 1e-9, theta_rel_err=theta_err, var_rel_err=var_err)
    accuracy = float((pred.numpy() == y_h).mean())
    results["GaussianNB"] = {"fit_wall_ms": nb_ms, "predict_wall_ms": nb_pred_ms,
                             "theta_rel_err": theta_err, "var_rel_err": var_err,
                             "accuracy": accuracy}

    n_train, n_query, kn = KNN
    xt, yt = x[:n_train], y[:n_train]
    xq = x[n_train:n_train + n_query]
    knn = ht.classification.KNeighborsClassifier(kn)
    _, knn_fit_ms = _timed(lambda: knn.fit(xt, yt))
    pred, knn_ms = _timed(lambda: knn.predict(xq))
    t64, q64 = xt.larray.double(), xq.larray.double()
    y_t = yt.larray
    want, near_tie = [], []
    for s in range(0, n_query, 2048):
        q = q64[s:s + 2048]
        d2 = (q * q).sum(1, keepdim=True) + (t64 * t64).sum(1)[None] - 2.0 * q @ t64.T
        d_sorted, order = torch.sort(d2, dim=1, stable=True)
        votes = torch.nn.functional.one_hot(y_t[order[:, :kn]].long(), k).sum(1)
        want.append(torch.argmax(votes, dim=1))
        near_tie.append((d_sorted[:, kn] - d_sorted[:, kn - 1]) <= 1e-5 * d_sorted[:, kn])
    want, near_tie = torch.cat(want), torch.cat(near_tie)
    wrong = pred.larray != want
    check("KNN equals the float64 brute force with ties by index (a mismatch only at a "
          "k-th/k+1-th distance tie within 1e-5)", bool(near_tie[wrong].all()),
          mismatches=int(wrong.sum()))
    results["KNeighborsClassifier"] = {"train": n_train, "queries": n_query, "k": kn,
                                       "fit_wall_ms": knn_fit_ms, "predict_wall_ms": knn_ms,
                                       "mismatches": int(wrong.sum()),
                                       "accuracy": float((pred.numpy() == y_h[
                                           n_train:n_train + n_query]).mean())}
    launches = dict(ht.launch_counts())
    check("estimators launched only the random kernel (the seeding draws)",
          launches["random"] > 0 and not any(v for name, v in launches.items() if name != "random"),
          launches=launches)
    emit({"phase": "estimators", "card": smi, "shape": [rows, cols], "blobs": k,
          "max_iter": iters, "results": results, "launches": launches})
    del x, x64, x_host, y
    return launches


# bench.py's lm_step model trained under DataParallel (world of one): steps of
# each mode, the lr schedule over all of them
DP_STEPS = 3
# the sequence-parallel attention at a real context: (B, T, H, D) bf16, causal
SEQ_PARALLEL = (1, 8192, 16, 64)
# examples/nn/daso_training.py: classes, features, hidden width, epochs,
# batches an epoch, batch rows, eval rows
DASO_EXAMPLE = (10, 64, 64, 8, 16, 128, 1024)


def _lm_loss(vocab):
    import torch.nn.functional as F

    def lm_loss(model, tokens):
        logits = model(tokens)
        return F.cross_entropy(logits[:, :-1].float().reshape(-1, vocab),
                               tokens[:, 1:].reshape(-1))

    return lm_loss


def _update_error(got, ref, init):
    """Relative RMS of the difference of two runs' parameter updates (from
    the same initial state), over all tensors and the worst tensor, and
    whether the parameters are bit-identical."""
    num = den = 0.0
    worst, worst_name = 0.0, None
    for name, r in ref.items():
        du = (got[name].double() - r.double())
        ru = (r.double() - init[name].double())
        d2, r2 = du.pow(2).sum().item(), ru.pow(2).sum().item()
        rel = (d2 / r2) ** 0.5 if r2 else d2 ** 0.5
        if rel > worst:
            worst, worst_name = rel, name
        num, den = num + d2, den + r2
    bitwise = all(bool((got[name] == r).all()) for name, r in ref.items())
    return (num / den) ** 0.5 if den else num ** 0.5, worst, worst_name, bitwise


def data_parallel_path(ht, dev, cfg, steps=DP_STEPS, batch=(8, 1024)):
    """bench.py's lm_step model (``cfg``: full width, bf16, remat, flash with
    the two-pass backward) trained through ``nn.DataParallel`` on a world of
    one with ``optim.DataParallelOptimizer(torch.optim.AdamW)`` at optax.adamw's
    defaults and the ``lr_scheduler.CosineAnnealingLR`` schedule (through
    ``LambdaLR``): ``steps`` blocking steps, held against the training path's
    plain step (forward, backward, AdamW, the same schedule) on the same
    batches; ``steps`` double-buffered steps from the same weights (the first
    applies zero gradients: AdamW decays the weights and nothing else), and
    the double-buffered second update against the blocking first one, both
    with SGD (the JAX package's test). Launches of K6, K7a and K7b per step
    against the layer count; one blocking step under the profiler. Returns the
    kernels' launches of the DataParallel steps."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    vocab, layers = cfg["vocab_size"], cfg["num_layers"]
    train_cfg = dict(cfg, attn_impl="flash", dtype=torch.bfloat16, remat=True,
                     flash_bwd_impl="two_pass")
    per_step = {"flash_fwd": 2 * layers, "flash_bwd_dq": layers, "flash_bwd_dkv": layers,
                "flash_bwd_fused": 0}
    lm_loss = _lm_loss(vocab)
    rng = np.random.default_rng(2)
    batches = [torch.from_numpy(rng.integers(0, vocab, batch)).to(dev) for _ in range(steps + 1)]
    lr, wd = 1e-3, 1e-4
    schedule = ht.optim.lr_scheduler.CosineAnnealingLR(lr, T_max=4 * steps)

    def fresh(init=None, sgd=False):
        model = ht.nn.TransformerLM(**train_cfg,
                                    generator=torch.Generator(device=dev).manual_seed(0))
        if init is not None:
            model.load_state_dict(init)
        if sgd:
            return model, torch.optim.SGD(model.parameters(), lr=lr), None
        opt = torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=wd)
        return model, opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda k: schedule(k) / lr)

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = fn()
        torch.cuda.synchronize()
        return loss, (time.perf_counter() - t) * 1e3

    def run_dp(model, opt, sched, blocking, n, launches=None, walls=None, after=None):
        """``n`` steps in one DataParallel run (the double-buffered steps
        carry their pending gradients from one to the next); ``after(i)``
        runs after step ``i``, outside its timing."""
        dpo = ht.optim.DataParallelOptimizer(opt, blocking=blocking)
        dp = ht.nn.DataParallel(model, optimizer=dpo, blocking_parameter_updates=blocking)
        step = dp.make_train_step(lm_loss)
        state, pending, losses = dpo.init(model), dp.init_pending(model), []
        for i in range(n):
            ht.reset_launch_counts()

            def one():
                nonlocal pending
                if blocking:
                    _, _, loss = step(model, state, *dp.shard_batch(batches[i]))
                else:
                    _, _, pending, loss = step(model, state, pending, *dp.shard_batch(batches[i]))
                if sched is not None:
                    sched.step()
                return loss.item()

            loss, ms = timed(one)
            losses.append(loss)
            if launches is not None:
                launches.append({name: ht.launch_counts()[name] for name in per_step})
            if walls is not None:
                walls.append(ms)
            if after is not None:
                after(i)
        return losses, step, dp, state

    def params_of(model):
        return {name: p.detach().clone() for name, p in model.named_parameters()}

    report = {}
    model, opt, sched = fresh()
    init = {name: t.detach().clone() for name, t in model.state_dict().items()}
    init_params = params_of(model)
    blocking_launches, blocking_walls = [], []
    losses, step, dp, state = run_dp(model, opt, sched, True, steps, blocking_launches,
                                     blocking_walls)
    dp_params = params_of(model)
    # one more blocking step under the profiler (device activity only)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, prof_wall = timed(lambda: step(model, state, *dp.shard_batch(batches[steps]))[2].item())
    device_ms = sum(ev.self_device_time_total for ev in prof.key_averages()
                    if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    del model, opt, sched, dp, step, state

    plain, popt, psched = fresh(init)
    plain_losses, plain_walls = [], []
    for i in range(steps):
        def one():
            popt.zero_grad(set_to_none=True)
            loss = lm_loss(plain, batches[i])
            loss.backward()
            popt.step()
            psched.step()
            return loss.item()

        loss, ms = timed(one)
        plain_losses.append(loss)
        plain_walls.append(ms)
    rel, worst, worst_name, bitwise = _update_error(dp_params, params_of(plain), init_params)
    del plain, popt, psched, dp_params
    emit({"phase": "data-parallel path", "world": 1, "steps": steps,
          "blocking": {"losses": losses, "step_wall_ms": blocking_walls,
                       "launches_per_step": blocking_launches},
          "plain": {"losses": plain_losses, "step_wall_ms": plain_walls},
          "profiled_step": {"wall_ms": prof_wall, "device_ms": device_ms,
                            "device_busy_share": device_ms / prof_wall}})
    check("data-parallel: blocking losses finite", all(np.isfinite(losses)), losses=losses)
    # tolerance: the DataParallel step and the plain step run the same kernels
    # on the same bf16 activations (a world of one averages nothing), so the
    # updates may differ only where a gradient is summed in another order;
    # 1e-2 of the update's RMS over all tensors, 5e-2 per tensor
    check("data-parallel: blocking steps equal the plain training step",
          rel <= 1e-2 and worst <= 5e-2, update_rel_rms=rel, worst_tensor=worst_name,
          worst_tensor_rel_rms=worst, bit_identical=bitwise,
          tolerance={"global": 1e-2, "per_tensor": 5e-2})
    check("data-parallel: blocking launches per step match the layer count",
          all(c == per_step for c in blocking_launches), launches=blocking_launches,
          want=per_step)
    check("data-parallel: profiled step saw device time", device_ms > 0, device_ms=device_ms)

    model, opt, sched = fresh(init)
    db_launches, db_walls = [], []
    # the first step applies zeros: AdamW decays every weight by lr*wd, and m, v
    # stay zero (the optax step with zero gradients)
    decay = 1.0 - schedule(0) * wd
    first_err = None

    def after_first(i):
        nonlocal first_err
        if i == 0:
            first_err = max(((p.detach() - init_params[name] * decay).abs().max().item()
                             for name, p in model.named_parameters()))

    db_losses, *_ = run_dp(model, opt, sched, False, steps, db_launches, db_walls, after_first)
    del model, opt, sched
    emit({"phase": "data-parallel path, double-buffered", "steps": steps, "losses": db_losses,
          "step_wall_ms": db_walls, "launches_per_step": db_launches,
          "first_step_max_abs_err_vs_decay_only": first_err})
    check("data-parallel: double-buffered losses finite", all(np.isfinite(db_losses)),
          losses=db_losses)
    check("data-parallel: the first double-buffered step applies zero gradients",
          first_err <= 1e-6, max_abs_err=first_err, tolerance=1e-6)
    check("data-parallel: double-buffered launches per step match the layer count",
          all(c == per_step for c in db_launches), launches=db_launches, want=per_step)

    # the JAX package's test_second_step_matches_blocking_first_update, with SGD
    one_step, opt1, _ = fresh(init, sgd=True)
    run_dp(one_step, opt1, None, True, 1)
    two_steps, opt2, _ = fresh(init, sgd=True)
    run_dp(two_steps, opt2, None, False, 2)
    rel2, worst2, worst_name2, bitwise2 = _update_error(params_of(two_steps), params_of(one_step),
                                                        init_params)
    del one_step, two_steps, opt1, opt2
    check("data-parallel: double-buffered second update equals the blocking first",
          rel2 <= 1e-3 and worst2 <= 1e-2, update_rel_rms=rel2, worst_tensor=worst_name2,
          worst_tensor_rel_rms=worst2, bit_identical=bitwise2,
          tolerance={"global": 1e-3, "per_tensor": 1e-2})
    total = {name: sum(c[name] for c in blocking_launches + db_launches) for name in per_step}
    return total


def _grad_error(got, ref):
    """Relative RMS and the largest error over the reference's largest
    magnitude, of one tensor (an output or a gradient)."""
    g, r = got.double(), ref.double()
    rms = ((g - r).pow(2).sum() / r.pow(2).sum()).sqrt().item()
    return rms, ((g - r).abs().max() / r.abs().max()).item()


def sequence_parallel_phase(ht, dev, time_ms, shape=SEQ_PARALLEL):
    """ring_attention and ulysses_attention(use_pallas=True) on a world of
    one at ``shape`` (bf16, causal), forward and backward through autograd
    (the loss sum(O * dO)), held against flash_attention and the flash
    kernels' plain versions on the same inputs; Ulysses must launch K6 and
    the two-pass backward (K7a, K7b), the ring none (the JAX package's ring
    runs its plain block). Times of the forward and of forward + backward
    (CUDA events), the ring's peak memory. Returns Ulysses' launches."""
    import torch

    from heat_tpu_torch.parallel.cuda_attention import (flash_attention_bwd_plain,
                                                        flash_attention_plain)

    b, t, h, d = shape
    g = torch.Generator(device=dev).manual_seed(13)
    q, k, v, do = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(4))
    comm = ht.get_comm()
    fns = {
        "ulysses": lambda *a: ht.parallel.ulysses_attention(*a, comm=comm, causal=True,
                                                            use_pallas=True),
        "ring": lambda *a: ht.parallel.ring_attention(*a, comm=comm, causal=True),
        "flash": lambda *a: ht.parallel.flash_attention(*a, causal=True),
    }

    def run(fn):
        qs, ks, vs = (x.clone().requires_grad_(True) for x in (q, k, v))
        o = fn(qs, ks, vs)
        o.backward(do)
        return o.detach(), qs.grad, ks.grad, vs.grad

    results, launches, peaks = {}, {}, {}
    for name, fn in fns.items():
        ht.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        results[name] = run(fn)
        torch.cuda.synchronize()
        launches[name] = {key: ht.launch_counts()[key] for key in
                          ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_fused")}
        peaks[name] = torch.cuda.max_memory_allocated() / 2 ** 30
    o_p, lse_p = flash_attention_plain(q, k, v, causal=True, return_lse=True)
    plain = (o_p,) + tuple(flash_attention_bwd_plain(q, k, v, o_p, lse_p, do, causal=True,
                                                     scale=1.0 / d ** 0.5))
    del lse_p
    times = {}
    for name, fn in fns.items():
        with torch.no_grad():
            fwd = time_ms(lambda: fn(q, k, v), 3, warmup=1)
        times[name] = {"forward_ms": fwd, "forward_backward_ms": time_ms(lambda: run(fn), 3,
                                                                         warmup=1)}
    vmax = v.float().abs().max().item()

    def held(got, ref):
        """O's largest error, and O's and the gradients' relative RMS and
        largest error over the largest magnitude, of ``got`` against ``ref``."""
        e = {"o_max_abs_err": (got[0].float() - ref[0].float()).abs().max().item()}
        for gname, a, r in zip(("o", "dq", "dk", "dv"), got, ref):
            e[f"{gname}_rel_rms"], e[f"{gname}_max_over_max"] = _grad_error(a, r)
        return e

    errors = {name: held(results[name], plain) for name in ("ulysses", "ring", "flash")}
    ring_vs_flash = held(results["ring"], results["flash"])
    same = all(torch.equal(a, c) for a, c in zip(results["ulysses"], results["flash"]))
    emit({"phase": "sequence-parallel attention", "world": 1, "shape": list(shape),
          "dtype": "bfloat16", "causal": True, "launches": launches, "times": times,
          "peak_memory_gib": peaks, "errors_vs_plain": errors, "ring_vs_flash": ring_vs_flash,
          "ulysses_bit_identical_to_flash": same})
    # tolerances (tests/test_torch_cuda.py's for bf16), for O by O's own
    # scale as for the gradients (at this length a late row's |O| is far
    # below max|v|): the kernels relative RMS 2e-3 and largest error 2^-6 of
    # the largest; the ring rounds P to bf16 against each block's own maximum
    # and its backward is autograd's, which rounds dP and the gradients at
    # other points than the kernels: relative RMS 1e-2, largest error 2^-5;
    # and O within 2^-7 max|v|
    for name, against, e, (rms_tol, max_tol) in (
            ("ulysses", "the plain flash version", errors["ulysses"], (2e-3, 2.0 ** -6)),
            ("flash", "the plain flash version", errors["flash"], (2e-3, 2.0 ** -6)),
            ("ring", "the plain flash version", errors["ring"], (1e-2, 2.0 ** -5)),
            ("ring", "flash_attention", ring_vs_flash, (1e-2, 2.0 ** -5))):
        ok = e["o_max_abs_err"] <= 2.0 ** -7 * vmax and all(
            e[f"{gn}_rel_rms"] <= rms_tol and e[f"{gn}_max_over_max"] <= max_tol
            for gn in ("o", "dq", "dk", "dv"))
        check(f"sequence-parallel: {name} against {against}", ok, **e,
              tolerance={"rel_rms": rms_tol, "max_over_max": max_tol, "o_abs": "2^-7 max|v|",
                         "o_abs_value": 2.0 ** -7 * vmax})
    check("sequence-parallel: ulysses (world of one) equals flash_attention bit for bit", same)
    want = {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1, "flash_bwd_fused": 0}
    check("sequence-parallel: ulysses launched K6, K7a and K7b once each",
          launches["ulysses"] == want, launches=launches["ulysses"])
    check("sequence-parallel: the ring launched no kernel (its block is plain, as in the JAX "
          "package)", not any(launches["ring"].values()), launches=launches["ring"])
    return launches["ulysses"]


def daso_phase(ht, dev, sizes=DASO_EXAMPLE):
    """examples/nn/daso_training.py's classifier at its sizes, on one card:
    DASO(Adam 2e-3) through warmup (2 epochs), cycling and cooldown (2),
    max_global_skips 4; the schedule state and the eval accuracy at each
    epoch's end. The accuracy must reach the example's 0.95."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    n_classes, d_in, d_hidden, epochs, per_epoch, bs, n_eval = sizes
    protos = np.random.default_rng(42).standard_normal((n_classes, d_in)).astype(np.float32)

    def make_data(n, seed):
        rng = np.random.default_rng(seed)
        labels = rng.integers(0, n_classes, n)
        feats = protos[labels] + 0.4 * rng.standard_normal((n, d_in)).astype(np.float32)
        return torch.from_numpy(feats).to(dev), torch.from_numpy(labels).to(dev)

    class Classifier(torch.nn.Module):
        def __init__(self):
            super().__init__()
            rng = np.random.default_rng(0)
            w1 = rng.standard_normal((d_in, d_hidden)).astype(np.float32) * 0.1
            w2 = rng.standard_normal((d_hidden, n_classes)).astype(np.float32) * 0.1
            self.w1 = torch.nn.Parameter(torch.from_numpy(w1).to(dev))
            self.b1 = torch.nn.Parameter(torch.zeros(d_hidden, device=dev))
            self.w2 = torch.nn.Parameter(torch.from_numpy(w2).to(dev))
            self.b2 = torch.nn.Parameter(torch.zeros(n_classes, device=dev))

        def forward(self, x):
            return torch.relu(x @ self.w1 + self.b1) @ self.w2 + self.b2

    def loss_fn(model, xb, yb):
        return F.cross_entropy(model(xb), yb)

    x, y = make_data(per_epoch * bs, 0)
    x_eval, y_eval = make_data(n_eval, 1)
    model = Classifier()
    daso = ht.optim.DASO(torch.optim.Adam(model.parameters(), lr=2e-3), total_epochs=epochs,
                         warmup_epochs=2, cooldown_epochs=2, max_global_skips=4)
    daso.set_loss(loss_fn)
    daso.last_batch = per_epoch - 1
    params = daso.stack_params(model)
    opt_state = daso.init(params)
    rows, acc = [], 0.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for epoch in range(epochs):
        total = 0.0
        for i in range(per_epoch):
            lo = i * bs
            params, opt_state, loss = daso.step(params, opt_state, (x[lo:lo + bs], y[lo:lo + bs]))
            total += float(loss)
        daso.epoch_loss_logic(total / per_epoch)
        synced = daso.unstack_params(params)
        with torch.no_grad():
            h = torch.relu(x_eval @ synced["w1"] + synced["b1"])
            acc = ((h @ synced["w2"] + synced["b2"]).argmax(-1) == y_eval).float().mean().item()
        rows.append({"epoch": daso.epoch, "loss": total / per_epoch, "eval_accuracy": acc,
                     "global_skip": daso.global_skip, "local_skip": daso.local_skip,
                     "batches_to_wait": daso.batches_to_wait})
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    emit({"phase": "DASO", "world": 1, "n_nodes": daso.n_nodes, "n_local": daso.n_local,
          "epochs": rows, "wall_ms": wall, "steps": epochs * per_epoch})
    skips = [r["global_skip"] for r in rows]
    check("DASO: warmup, cycling and cooldown ran (global skip 0, then 4, then 0)",
          skips[:1] == [0] and 4 in skips and skips[-2:] == [0, 0], global_skips=skips)
    check("DASO: eval accuracy reaches the example's 0.95", acc >= 0.95, accuracy=acc)


# the scale-out training path: steps a run, microbatches of the pipeline;
# DASO's resume (epochs, the epoch after which the first run is killed) and
# cg's window (iterations)
SCALE_OUT_STEPS = 3
SCALE_OUT_MICROBATCHES = 8
DASO_RESUME = (6, 3)
CG_WINDOW = 16


def _step_rows(ht, dev, one, n):
    """``n`` calls of ``one()`` (a training step returning its loss), each
    with its wall (host clock to a synchronize), the span of the stream
    between CUDA events recorded around it, its flash launches, the device
    memory resident before it and its peak above that; then one more call
    under the profiler: its wall, the device's busy time (the CUDA
    kernels' self time) and the busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = dev.type == "cuda"
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_fused")
    rows = []
    for _ in range(n):
        ht.reset_launch_counts()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        t = time.perf_counter()
        loss = float(one())
        if cuda:
            end.record()
            torch.cuda.synchronize()
        row = {"loss": loss, "wall_ms": (time.perf_counter() - t) * 1e3,
               "launches": {k: ht.launch_counts()[k] for k in names}}
        if cuda:
            row["stream_span_ms"] = start.elapsed_time(end)
            row["resident_gib"] = resident / 2 ** 30
            row["step_peak_gib"] = (torch.cuda.max_memory_allocated() - resident) / 2 ** 30
        rows.append(row)
    if cuda:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            loss = float(one())
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        busy = sum(ev.self_device_time_total for ev in prof.key_averages()
                   if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        rows.append({"profiled": True, "loss": loss, "wall_ms": wall, "device_ms": busy,
                     "busy_share": busy / wall, "launches": {k: 0 for k in names}})
    return rows


def _opt_bytes(opt):
    import torch

    return sum(v.numel() * v.element_size() for st in opt.state.values() for v in st.values()
               if torch.is_tensor(v))


def scale_out_path(ht, dev, cfg, steps=SCALE_OUT_STEPS, batch=(8, 1024),
                   microbatches=SCALE_OUT_MICROBATCHES):
    """The scale-out training path on one card: bench.py's lm_step model
    (``cfg``: full width, bf16, flash with the two-pass backward) and AdamW
    at optax.adamw's defaults, ``steps`` steps each on one batch:

    * the reference, ``nn.DataParallel`` (remat on);
    * ``nn.FSDP`` over ``TransformerLM.stages()`` (embedding, the blocks,
      head), ``HEAT_TPU_FSDP=1``, prefetch 0 and 1;
    * ``optim.ZeroOptimizer`` over the same AdamW;
    * ``nn.Pipeline`` with the blocks as its layers, ``microbatches``
      microbatches, gpipe and 1f1b, against ``nn.DataParallel`` over the
      same blocks (the embedding and the head frozen: the pipeline's loss).

    Each step's wall, device time, flash launches and peak memory; the
    parameter and optimizer bytes a card; every run's updates against its
    reference's. Then DASO killed after a checkpoint and resumed, and cg on
    4096^2 run in windows, killed and resumed, each against its
    uninterrupted run bit for bit. Returns the flash launches of the runs."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    vocab = cfg["vocab_size"]
    train_cfg = dict(cfg, attn_impl="flash", dtype=torch.bfloat16, flash_bwd_impl="two_pass")
    lm_loss = _lm_loss(vocab)

    def ce(logits, tokens):
        return F.cross_entropy(logits[:, :-1].float().reshape(-1, vocab),
                               tokens[:, 1:].reshape(-1))

    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, vocab, batch)).to(dev)

    def adamw(params):
        return torch.optim.AdamW(params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=1e-4)

    def fresh(remat):
        return ht.nn.TransformerLM(**train_cfg, remat=remat,
                                   generator=torch.Generator(device=dev).manual_seed(0))

    def lm_params(model):
        return {n: p.detach().clone() for n, p in model.named_parameters()}

    def stage_params(logical):
        """FSDP's logical stages under the LM's names."""
        out = {}
        for k, stage in enumerate(logical):
            prefix = f"blocks.{k - 1}." if 0 < k < len(logical) - 1 else ""
            out.update({prefix + n: torch.as_tensor(v).to(dev) for n, v in stage.items()})
        return out

    report, runs, total = {}, {}, {}

    def record(name, rows, params=None, params_bytes=None, opt_bytes=None):
        runs[name] = {"steps": rows, "param_bytes_per_card": params_bytes,
                      "optimizer_bytes_per_card": opt_bytes}
        for row in rows:
            for k, v in row["launches"].items():
                total[k] = total.get(k, 0) + v
        if params is not None:
            report[name] = params

    # the reference: DataParallel, remat on
    model = fresh(True)
    init = lm_params(model)
    opt = adamw(model.parameters())
    dp = ht.nn.DataParallel(model, optimizer=opt, blocking_parameter_updates=True)
    step = dp.make_train_step(lm_loss)
    rows = _step_rows(ht, dev, lambda: step(model, opt, *dp.shard_batch(tokens))[2], steps)
    record("data_parallel", rows, lm_params(model),
           sum(p.numel() * p.element_size() for p in model.parameters()), _opt_bytes(opt))
    del model, opt, dp, step

    # FSDP over the LM's stages, prefetch 0 and 1
    saved = os.environ.get("HEAT_TPU_FSDP")
    os.environ["HEAT_TPU_FSDP"] = "1"
    try:
        for prefetch in (0, 1):
            model = fresh(False)
            fsdp = ht.nn.FSDP(model.stages(), optimizer=adamw, prefetch=prefetch)
            params = fsdp.shard_params(fsdp.init())
            state = fsdp.init_opt_state(params)
            fstep = fsdp.make_train_step(ce)
            (xb,) = fsdp.shard_batch(tokens)
            box = [params, state]

            def one():
                box[0], box[1], loss = fstep(box[0], box[1], xb, xb)
                return loss

            rows = _step_rows(ht, dev, one, steps)
            record(f"fsdp_prefetch{prefetch}", rows,
                   stage_params(fsdp.unshard_params(box[0])),
                   fsdp.param_bytes_per_device(box[0]), _opt_bytes(box[1]))
            del model, fsdp, params, state, box
    finally:
        if saved is None:
            os.environ.pop("HEAT_TPU_FSDP", None)
        else:
            os.environ["HEAT_TPU_FSDP"] = saved

    # ZeRO over the same AdamW
    model = fresh(True)
    zero = ht.optim.ZeroOptimizer(adamw)
    state = zero.init(model)
    zstep = zero.make_train_step(lm_loss)
    rows = _step_rows(ht, dev, lambda: zstep(model, state, *zero.shard_batch(tokens))[2], steps)
    record("zero", rows, lm_params(model),
           sum(p.numel() * p.element_size() for p in model.parameters()),
           zero.state_bytes_per_device())
    del model, zero, state, zstep

    # the pipeline over the blocks, against DataParallel over the same blocks
    base = fresh(False)
    embed, head = base.stages()[0], base.stages()[-1]
    for p in list(embed.parameters()) + list(head.parameters()):
        p.requires_grad_(False)
    with torch.no_grad():
        x = embed(tokens)

    def pipe_loss(h, t):
        return ce(head(h), t)

    layers = [{n: p.detach().clone() for n, p in block.named_parameters()}
              for block in base.blocks]

    class Blocks(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.blocks = torch.nn.ModuleList(
                ht.nn.TransformerBlock(cfg["num_heads"], cfg["mlp_ratio"], "flash",
                                       dtype=torch.bfloat16, flash_bwd_impl="two_pass",
                                       d_model=cfg["d_model"], device=dev)
                for _ in layers)
            for block, layer in zip(self.blocks, layers):
                block.load_state_dict(layer)

        def forward(self, h):
            for block in self.blocks:
                h = block(h)
            return h

    def block_params(blocks):
        return {f"{j}.{n}": p.detach().clone() for j, b in enumerate(blocks.blocks)
                for n, p in b.named_parameters()}

    blocks = Blocks()
    bopt = adamw(blocks.parameters())
    bdp = ht.nn.DataParallel(blocks, optimizer=bopt, blocking_parameter_updates=True)
    bstep = bdp.make_train_step(lambda m, h, t: pipe_loss(m(h), t))
    rows = _step_rows(ht, dev, lambda: bstep(blocks, bopt, x, tokens)[2], steps)
    record("blocks_data_parallel", rows, block_params(blocks))
    # the sequential application of the stages (the CPU tests' reference):
    # the same microbatches, loss / M each, gradients summed in their order
    blocks = Blocks()
    bopt = adamw(blocks.parameters())

    def sequential():
        bopt.zero_grad(set_to_none=True)
        total = torch.zeros((), device=dev)
        for m in range(microbatches):
            rows_m = slice(m * batch[0] // microbatches, (m + 1) * batch[0] // microbatches)
            loss = pipe_loss(blocks(x[rows_m]), tokens[rows_m]) / microbatches
            loss.backward()
            total = total + loss.detach()
        bopt.step()
        return total

    rows = _step_rows(ht, dev, sequential, steps)
    record("blocks_sequential", rows, block_params(blocks))
    del blocks, bopt, bdp, bstep
    table = {}
    for schedule in ("gpipe", "1f1b"):
        template = ht.nn.TransformerBlock(cfg["num_heads"], cfg["mlp_ratio"], "flash",
                                          dtype=torch.bfloat16, flash_bwd_impl="two_pass",
                                          d_model=cfg["d_model"], device=dev)
        pipe = ht.nn.Pipeline(template, len(layers), optimizer=adamw, loss_fn=pipe_loss,
                              n_microbatches=microbatches, schedule=schedule, prefetch=0)
        params = pipe.shard_params(layers)
        state = pipe.init_opt_state(params)
        pstep = pipe.make_train_step()
        box = [params, state]

        def one():
            box[0], box[1], loss = pstep(box[0], box[1], x, tokens)
            return loss

        rows = _step_rows(ht, dev, one, steps)
        t = pipe._table(True)
        table[schedule] = {"ticks": t.n_ticks, "bubble_cells": t.bubble_cells(),
                           "steady_bubble_ticks": t.steady_bubble_ticks(),
                           "stash_depth": t.stash_depth()}
        record(f"pipeline_{schedule}", rows,
               {f"{j}.{n}": torch.as_tensor(v).to(dev)
                for j, layer in enumerate(pipe.unshard_params(box[0])) for n, v in layer.items()},
               pipe.param_bytes_per_device(), _opt_bytes(box[1]))
        del template, pipe, params, state, box
    del base, embed, head, x

    def held(name, ref, start):
        rel, worst, worst_name, bitwise = _update_error(report[name], report[ref], start)
        return {"update_rel_rms": rel, "worst_tensor_rel_rms": worst, "worst_tensor": worst_name,
                "bit_identical": bitwise}

    block_init = {f"{j}.{n}": v.to(dev) for j, layer in enumerate(layers) for n, v in layer.items()}
    against = {name: held(name, "data_parallel", init)
               for name in ("fsdp_prefetch0", "fsdp_prefetch1", "zero")}
    against.update({name: held(name, "blocks_data_parallel", block_init)
                    for name in ("pipeline_gpipe", "pipeline_1f1b")})
    against.update({f"{name} vs sequential": held(name, "blocks_sequential", block_init)
                    for name in ("pipeline_gpipe", "pipeline_1f1b")})
    against["blocks_sequential"] = held("blocks_sequential", "blocks_data_parallel", block_init)
    same_prefetch = all(torch.equal(report["fsdp_prefetch0"][n], report["fsdp_prefetch1"][n])
                        for n in report["fsdp_prefetch0"])
    same_schedule = all(torch.equal(report["pipeline_gpipe"][n], report["pipeline_1f1b"][n])
                        for n in report["pipeline_gpipe"])
    emit({"phase": "scale-out training path", "world": 1, "steps": steps,
          "batch": list(batch), "microbatches": microbatches, "runs": runs,
          "against_reference": against, "pipeline_tables": table,
          "fsdp_prefetch_bit_identical": same_prefetch,
          "pipeline_1f1b_bit_identical_to_gpipe": same_schedule})
    for name, run in runs.items():
        check(f"scale-out: {name} losses finite",
              all(np.isfinite(r["loss"]) for r in run["steps"]))
        if dev.type == "cuda":
            check(f"scale-out: {name}'s profiled step saw device time",
                  run["steps"][-1]["device_ms"] > 0, device_ms=run["steps"][-1]["device_ms"])
    # tolerances: FSDP, ZeRO and the pipeline against the sequential
    # application as the data-parallel path's (the same kernels on the same
    # bf16 activations): 1e-2 of the update's RMS, 5e-2 per tensor. A batch
    # in microbatches rounds each microbatch's bf16 weight gradient on its
    # own (8 roundings of 2^-8 where one batch rounds once) and Adam's first
    # steps divide each gradient by its own size, so the pipeline and the
    # sequential reference stand 1e-1 (global) and 2e-1 (per tensor) from
    # one batch's DataParallel step
    for name, e in against.items():
        loose = name in ("pipeline_gpipe", "pipeline_1f1b", "blocks_sequential")
        tol = (1e-1, 2e-1) if loose else (1e-2, 5e-2)
        check(f"scale-out: {name} updates equal its reference's",
              e["update_rel_rms"] <= tol[0] and e["worst_tensor_rel_rms"] <= tol[1], **e,
              tolerance={"global": tol[0], "per_tensor": tol[1]})
    check("scale-out: FSDP prefetch 0 and 1 bit for bit", same_prefetch)
    check("scale-out: pipeline 1f1b bit for bit gpipe", same_schedule)
    per_step = {"flash_fwd": 2 * cfg["num_layers"], "flash_bwd_dq": cfg["num_layers"],
                "flash_bwd_dkv": cfg["num_layers"], "flash_bwd_fused": 0}
    for name in ("fsdp_prefetch0", "fsdp_prefetch1", "zero"):
        check(f"scale-out: {name} launches K6/K7a/K7b a step as the layer count",
              all(r["launches"] == per_step for r in runs[name]["steps"]
                  if not r.get("profiled")),
              launches=[r["launches"] for r in runs[name]["steps"]], want=per_step)
    for name in ("pipeline_gpipe", "pipeline_1f1b"):
        check(f"scale-out: {name} launched K6, K7a and K7b every step",
              all(r["launches"][k] > 0 for r in runs[name]["steps"] if not r.get("profiled")
                  for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")))
    if dev.type == "cuda":
        peak = {s: max(r["step_peak_gib"] for r in runs[f"pipeline_{s}"]["steps"]
                       if "step_peak_gib" in r) for s in ("gpipe", "1f1b")}
        check("scale-out: 1f1b's step peak at or below gpipe's (a stash of one microbatch "
              "against eight)", peak["1f1b"] <= peak["gpipe"], step_peak_gib=peak)
    check("scale-out: 1f1b's steady window has fewer bubble ticks than gpipe's",
          table["1f1b"]["steady_bubble_ticks"] <= table["gpipe"]["steady_bubble_ticks"]
          and table["1f1b"]["stash_depth"] < table["gpipe"]["stash_depth"], tables=table)
    daso_resume_phase(ht, dev)
    cg_resume_phase(ht, dev)
    return total


def daso_resume_phase(ht, dev, sizes=DASO_EXAMPLE, resume=DASO_RESUME):
    """DASO on examples/nn/daso_training.py's classifier (one card), killed
    after epoch ``resume[1]``'s checkpoint and resumed by a fresh DASO: the
    replica after ``resume[0]`` epochs equal to the uninterrupted run's bit
    for bit."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    n_classes, d_in, d_hidden, _, per_epoch, bs, _ = sizes
    epochs, kill = resume
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((per_epoch * bs, d_in)).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(0, n_classes, per_epoch * bs)).to(dev)

    def fresh(**kw):
        g = torch.Generator(device=dev).manual_seed(0)
        model = torch.nn.Sequential(torch.nn.Linear(d_in, d_hidden), torch.nn.ReLU(),
                                    torch.nn.Linear(d_hidden, n_classes)).to(dev)
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(torch.randn(p.shape, generator=g, device=dev) * 0.1)
        daso = ht.optim.DASO(torch.optim.Adam(model.parameters(), lr=2e-3), total_epochs=epochs,
                             warmup_epochs=1, cooldown_epochs=1, max_global_skips=4, **kw)
        daso.set_loss(lambda m, a, b: F.cross_entropy(m(a), b))
        daso.last_batch = per_epoch - 1
        return model, daso

    def run(model, daso, state, first, last):
        for _ in range(first, last):
            total = 0.0
            for i in range(per_epoch):
                lo = i * bs
                model, state, loss = daso.step(model, state, (x[lo:lo + bs], y[lo:lo + bs]))
                total += float(loss)
            daso.epoch_loss_logic(total / per_epoch)
        return model

    tmp = tempfile.mkdtemp(prefix="chip_smoke_daso_")
    try:
        model, daso = fresh()
        whole = run(model, daso, daso.init(model), 0, epochs)
        model, daso = fresh(checkpoint_every=per_epoch, checkpoint_path=os.path.join(tmp, "ck"))
        run(model, daso, daso.init(model), 0, kill)
        model, daso = fresh()
        state = daso.init(model)
        model, state = daso.load_checkpoint(os.path.join(tmp, "ck"), model, state)
        resumed = run(model, daso, state, kill, epochs)
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    same = all(torch.equal(a, b) for a, b in zip(whole.parameters(), resumed.parameters()))
    emit({"phase": "DASO resume", "epochs": epochs, "killed_after_epoch": kill,
          "bit_identical": same})
    check("DASO: killed after a checkpoint and resumed, bit for bit the uninterrupted run", same)


def cg_resume_phase(ht, dev, window=CG_WINDOW):
    """cg on the solver phase's 4096^2 system run in windows of ``window``
    iterations, killed after its second checkpoint and resumed: the solution
    equal to the uninterrupted solve's bit for bit; the windows' time."""
    import torch
    from heat_tpu_torch.core.linalg import solver

    gen = torch.Generator(device=dev).manual_seed(5)
    m = torch.randn((CG_N, CG_N), generator=gen, device=dev)
    a = m @ m.T / CG_N + torch.eye(CG_N, device=dev)
    b = torch.randn((CG_N,), generator=gen, device=dev)
    A, B, x0 = ht.array(a, split=0), ht.array(b), ht.zeros(CG_N)
    whole = ht.linalg.cg(A, B, x0).larray
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cg_")
    path = os.path.join(tmp, "ck")
    real, saves = solver._save_carry, [0]

    def save(*args, **kwargs):
        real(*args, **kwargs)
        saves[0] += 1
        if saves[0] == 2:
            raise KeyboardInterrupt("killed after the second window")

    try:
        solver._save_carry = save
        try:
            ht.linalg.cg(A, B, x0, checkpoint_every=window, checkpoint_path=path)
        except KeyboardInterrupt:
            pass
        finally:
            solver._save_carry = real
        t = time.perf_counter()
        resumed = ht.linalg.cg(A, B, x0, checkpoint_every=window, checkpoint_path=path,
                               resume=True).larray
        resume_ms = (time.perf_counter() - t) * 1e3
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    same = bool(torch.equal(whole, resumed))
    emit({"phase": "cg resume", "n": CG_N, "window": window, "bit_identical": same,
          "resumed_solve_wall_ms": resume_ms})
    check("cg: killed after two windows and resumed, bit for bit the uninterrupted solve", same)


# the autotune and registry phase: bench.py:209's cdist (rows, features), the
# error budget of its tune, the trials a candidate, the resplit's shape, and
# the cg system's order and window
TUNE_CDIST = (16384, 128)
TUNE_CDIST_BUDGET = 1e-3
# a process set to the exact variant (cdist_fma_stream's f32 FMAs, ~2.1 ms at
# this shape on an H100 SXM) tuned under a budget that admits the faster
# variants (their errors against it 0.003-0.046 here): a value other than
# the process's setting wins by a margin wider than the walls' spread
TUNE_CDIST_FROM = "highest"
TUNE_CDIST_LOOSE = 0.1
TUNE_TRIALS = 3
TUNE_RESPLIT = (1_000_000, 256)
REGISTRY_CG = (4096, 16)
# the K3 variant each HEAT_TPU_CDIST_PREC value launches (kernel, variant)
CDIST_VARIANTS = {"bf16x3": ("cdist_tc", "3xtf32_wgmma"), "high": ("cdist_tc", "3xtf32_wgmma"),
                  "default": ("cdist_tc", "tf32_wgmma"),
                  "highest": ("cdist_fma_stream", "f32_fma_stream")}

# a fresh process pointed at the tuning database: it adopts the pick with no
# trial, and its cdist launches the picked variant (the variant of a call
# before the tune is what the process runs untuned: the warm start at a
# registry miss adopts no lossy record without an ambient budget)
_WARM_START_CHILD = r"""
import json, sys
import torch
import heat_tpu_torch as ht
from heat_tpu_torch import _knobs, autotune, telemetry
from heat_tpu_torch.spatial.cuda_cdist import last_variant
from torch.profiler import ProfilerActivity, profile
rows, cols, budget, trials = (int(sys.argv[1]), int(sys.argv[2]), float(sys.argv[3]),
                              int(sys.argv[4]))
telemetry.enable()
ht.random.seed(0)
x = ht.random.rand(rows, cols, dtype=ht.float32, split=0)
ht.spatial.cdist(x, x, quadratic_expansion=True).larray
before = last_variant()
res = autotune.tune("cdist", lambda: ht.spatial.cdist(x, x, quadratic_expansion=True).larray,
                    signature=("cdist", (rows, cols), "float32"), search=["HEAT_TPU_CDIST_PREC"],
                    error_budget=budget, trials_per_config=trials)
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    ht.spatial.cdist(x, x, quadratic_expansion=True).larray
    torch.cuda.synchronize()
names = sorted({ev.key for ev in prof.key_averages() if "cdist" in ev.key})
print("WARM " + json.dumps({
    "from_db": res.from_db, "trials_run": res.trials_run, "config": res.config,
    "adopted": autotune.adopted(), "knob": _knobs.raw("HEAT_TPU_CDIST_PREC"),
    "trials_counter": int(telemetry.get_registry().counters.get("autotune.trials", 0)),
    "variant": last_variant(), "before_variant": before, "kernels": names}), flush=True)
"""


def _warm_start_child(tune_db, rows, cols, budget, **knob_env):
    """Run _WARM_START_CHILD in a fresh process with HEAT_TPU_AUTOTUNE=1, the
    tuning database ``tune_db`` and the knobs ``knob_env``: what it reports,
    or its output."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, HEAT_TPU_AUTOTUNE="1", HEAT_TPU_TUNE_DB=tune_db,
               PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""), **knob_env)
    env.pop("HEAT_TPU_AUTOTUNE_BUDGET", None)
    child = subprocess.run(
        [sys.executable, "-c", _WARM_START_CHILD, str(rows), str(cols), str(budget),
         str(TUNE_TRIALS)], cwd=here, env=env, capture_output=True, text=True, timeout=300)
    lines = [ln for ln in child.stdout.splitlines() if ln.startswith("WARM ")]
    if child.returncode != 0 or not lines:
        return {"returncode": child.returncode, "stdout": child.stdout[-2000:],
                "stderr": child.stderr[-2000:]}
    return json.loads(lines[-1][5:])


def _warm_adopted(warm, config, site):
    """Whether the warm-started process took ``config`` from the database
    with no trial, installed it in the knob overlay, and launched its
    cdist variant."""
    value = config["HEAT_TPU_CDIST_PREC"]
    kernel, variant = CDIST_VARIANTS[value]
    return (warm.get("from_db") is True and warm.get("trials_run") == 0
            and warm.get("trials_counter") == 0 and warm.get("config") == config
            and warm.get("knob") == value and warm.get("adopted", {}).get(site) == config
            and warm.get("variant") == variant
            and any(kernel in k for k in warm.get("kernels", [])))


def autotune_registry_phase(ht, dev, smi, cfg):
    """The autotuner and the program registry on the card (the card's name and
    power limit on every line):

    (a) bench.py:209's cdist (16,384 x 128 f32) tuned over
        HEAT_TPU_CDIST_PREC under an error budget of 1e-3, 3 trials a
        candidate: each candidate's trials launched the K3 variant it names
        (the wrapper's record during the trials, and the profiler on one call
        a candidate: cdist_tc for bf16x3 and high, its single TF32 pass for
        default, cdist_fma_stream for highest), the pick no slower than the
        default, a lossy pick within the budget, the record stored; then a
        fresh process with HEAT_TPU_AUTOTUNE=1 and the same HEAT_TPU_TUNE_DB
        adopts the pick with no trial (into the knob overlay) and its cdist
        launches the picked variant; the same from a process set to
        highest (cdist_fma_stream) under a budget of 0.1, which admits the
        faster variants: a value other than the process's setting wins, and
        a fresh process with that setting launches the picked variant, not
        the cdist_fma_stream it runs untuned;
    (b) bench.py's lm_step LM at full width under nn.FSDP
        (HEAT_TPU_FSDP=1), one AdamW step from the same start a call, tuned
        over HEAT_TPU_FSDP_PREFETCH with fsdp_cost_fn: the knob is neutral,
        so every candidate's loss and parameters digest the same; K6, K7a
        and K7b launches in each trial;
    (c) resplit of 1,000,000 x 256 f32 tuned over HEAT_TPU_RELAYOUT_PLAN with
        relayout_cost_fn on this card (the four-card tune runs in
        collective_audit_phase);
    (d) the registry: an injected fault at relayout raises from resplit; one
        at the second cg_chunk window stops a checkpointed cg on 4096^2, and
        the resumed solve equals the uninterrupted one bit for bit; every
        site the run reached with its hits and misses, and a second pass over
        a set of sites builds nothing (Lasso's epoch through streaming.lasso
        is measured in lasso_path)."""
    import shutil

    import numpy as np
    import torch
    import torch.nn.functional as F

    from heat_tpu_torch import _knobs, autotune, resilience, telemetry
    from heat_tpu_torch.autotune import cost, db, space, trials
    from heat_tpu_torch.core import program_cache
    from heat_tpu_torch.spatial.cuda_cdist import last_variant

    def check(name, ok, **fields):  # every line of the phase names the card
        globals()["check"](name, ok, card=smi, **fields)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    tune_db = os.path.join(tmp, "db")
    autotune.reset()
    try:
        # (a) cdist over HEAT_TPU_CDIST_PREC
        rows, cols = TUNE_CDIST
        ht.random.seed(0)
        x = ht.random.rand(rows, cols, dtype=ht.float32, split=0)
        seen = {}

        def cdist_work():
            out = ht.spatial.cdist(x, x, quadratic_expansion=True).larray
            seen.setdefault(_knobs.default_raw("HEAT_TPU_CDIST_PREC"), set()).add(last_variant())
            return out

        ht.reset_launch_counts()
        was_on = telemetry.enabled()
        reg = telemetry.enable()  # the tuner's events: each trial's seconds, each rejection
        first_event = len(reg.events)
        try:
            res = autotune.tune("cdist", cdist_work, signature=("cdist", TUNE_CDIST, "float32"),
                                search=["HEAT_TPU_CDIST_PREC"], error_budget=TUNE_CDIST_BUDGET,
                                trials_per_config=TUNE_TRIALS, db_dir=tune_db, adopt=False)
            events = [ev for ev in list(reg.events)[first_event:] if ev.get("kind") == "autotune"]
        finally:
            if not was_on:
                telemetry.disable()
        launches = {"cdist": ht.launch_counts()["cdist"]}
        lattice = space.candidates(["HEAT_TPU_CDIST_PREC"], error_budget=TUNE_CDIST_BUDGET)
        candidates = {}
        for i, cfg_ in enumerate(lattice):
            samples = [ev["seconds"] for ev in events
                       if ev.get("event") == "trial" and ev.get("config_index") == i]
            rejected = [ev for ev in events if ev.get("config_index") == i
                        and str(ev.get("event", "")).startswith("reject")]
            candidates[cfg_["HEAT_TPU_CDIST_PREC"]] = {
                "median_s": trials.robust_median(samples) if samples else None,
                "rejected": rejected[0]["event"] if rejected else None,
                "max_rel_err": rejected[0].get("max_rel_err") if rejected else None}
        rec = res.record
        profiled = {}
        for value in CDIST_VARIANTS:
            with _knobs.overlay({"HEAT_TPU_CDIST_PREC": value}):
                evs = profiled_kernels(cdist_work, 1, tries=5, want="cdist")
            profiled[value] = {"kernels": sorted({ev.key for ev in evs if "cdist" in ev.key}),
                               "variant": last_variant()}
        launched_as_named = all(
            seen.get(v, {want_variant}) == {want_variant}
            and any(want_kernel in k for k in profiled[v]["kernels"])
            and not any(other in k for k in profiled[v]["kernels"]
                        for other in ("cdist_tc", "cdist_fma_stream", "cdist_kernel")
                        if other != want_kernel)
            and profiled[v]["variant"] == want_variant
            for v, (want_kernel, want_variant) in CDIST_VARIANTS.items())
        stored = db.TuneDB(tune_db).lookup(res.key)
        emit({"phase": "autotune cdist", "card": smi, "shape": list(TUNE_CDIST),
              "budget": TUNE_CDIST_BUDGET, "pick": res.config, "validation": rec["validation"],
              "max_rel_err": rec["max_rel_err"], "baseline_median_s": rec["baseline_wall"],
              "pick_median_s": rec["tuned_wall"], "trials": res.trials_run,
              "configs_measured": rec["configs_measured"], "candidates": candidates,
              "trial_variants": {k: sorted(v) for k, v in seen.items()},
              "profiled": profiled})
        check("autotune cdist: every candidate launched the K3 variant it names",
              launched_as_named, trial_variants={k: sorted(v) for k, v in seen.items()},
              profiled=profiled)
        check("autotune cdist: the pick's median no worse than the default's",
              rec["tuned_wall"] <= rec["baseline_wall"])
        check("autotune cdist: a lossy pick within the budget",
              rec["validation"] == "digest" or rec["max_rel_err"] <= TUNE_CDIST_BUDGET,
              max_rel_err=rec["max_rel_err"])
        check("autotune cdist: the record is stored", stored is not None
              and stored["config"] == res.config)
        warm = _warm_start_child(tune_db, rows, cols, TUNE_CDIST_BUDGET)
        emit({"phase": "autotune warm start", "card": smi, "budget": TUNE_CDIST_BUDGET, **warm})
        check("autotune warm start: a fresh process adopts the pick with zero trials and its "
              "cdist launches the picked variant",
              _warm_adopted(warm, res.config, "cdist"), warm=warm)

        # the same tune from a process set to the exact variant, under a
        # budget that admits the faster ones: a value other than the
        # process's setting wins, and a fresh process with that setting runs
        # the picked variant, not the one it runs untuned
        loose_db = os.path.join(tmp, "db_loose")
        with _knobs.overlay({"HEAT_TPU_CDIST_PREC": TUNE_CDIST_FROM}):
            lres = autotune.tune("cdist", cdist_work,
                                 signature=("cdist", TUNE_CDIST, "float32"),
                                 search=["HEAT_TPU_CDIST_PREC"], error_budget=TUNE_CDIST_LOOSE,
                                 trials_per_config=TUNE_TRIALS, db_dir=loose_db, adopt=False)
        lwarm = _warm_start_child(loose_db, rows, cols, TUNE_CDIST_LOOSE,
                                  HEAT_TPU_CDIST_PREC=TUNE_CDIST_FROM)
        lpick = lres.config["HEAT_TPU_CDIST_PREC"]
        emit({"phase": "autotune cdist, loose budget", "card": smi, "budget": TUNE_CDIST_LOOSE,
              "from": TUNE_CDIST_FROM, "pick": lres.config,
              "default_config": lres.record["default_config"],
              "validation": lres.record["validation"],
              "max_rel_err": lres.record["max_rel_err"],
              "baseline_median_s": lres.record["baseline_wall"],
              "pick_median_s": lres.record["tuned_wall"], "trials": lres.trials_run,
              "configs_measured": lres.record["configs_measured"], "warm": lwarm})
        check("autotune cdist, loose budget: a value other than the process's setting wins "
              "within the budget, no slower than the setting",
              lres.record["default_config"] == {"HEAT_TPU_CDIST_PREC": TUNE_CDIST_FROM}
              and lpick != TUNE_CDIST_FROM and lres.record["max_rel_err"] <= TUNE_CDIST_LOOSE
              and lres.record["tuned_wall"] <= lres.record["baseline_wall"],
              pick=lres.config, max_rel_err=lres.record["max_rel_err"])
        check("autotune warm start, loose budget: the fresh process adopts the pick with zero "
              "trials and launches its variant, not the one it runs untuned",
              _warm_adopted(lwarm, lres.config, "cdist")
              and lwarm.get("before_variant") == CDIST_VARIANTS[TUNE_CDIST_FROM][1]
              and lwarm.get("before_variant") != lwarm.get("variant"), warm=lwarm)
        del x

        # (b) the LM under FSDP over HEAT_TPU_FSDP_PREFETCH
        vocab = cfg["vocab_size"]
        model = ht.nn.TransformerLM(**dict(cfg, attn_impl="flash", dtype=torch.bfloat16,
                                           flash_bwd_impl="two_pass"), remat=False,
                                    generator=torch.Generator(device=dev).manual_seed(0))
        stages = model.stages()
        tokens = torch.from_numpy(np.random.default_rng(3).integers(0, vocab, (8, 1024))).to(dev)

        def ce(logits, t):
            return F.cross_entropy(logits[:, :-1].float().reshape(-1, vocab),
                                   t[:, 1:].reshape(-1))

        def adamw(params):
            return torch.optim.AdamW(params, lr=1e-3, weight_decay=1e-4)

        names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
        fsdp_launches = {}
        saved = os.environ.get("HEAT_TPU_FSDP")
        os.environ["HEAT_TPU_FSDP"] = "1"
        try:
            init = ht.nn.FSDP(stages, optimizer=adamw).init()

            def fsdp_work():
                # one step from the same start a call; prefetch read at construction
                fsdp = ht.nn.FSDP(stages, optimizer=adamw)
                params = fsdp.shard_params(init)
                state = fsdp.init_opt_state(params)
                (xb,) = fsdp.shard_batch(tokens)
                ht.reset_launch_counts()
                params, state, loss = fsdp.make_train_step(ce)(params, state, xb, xb)
                torch.cuda.synchronize()
                counts = ht.launch_counts()
                fsdp_launches.setdefault(str(fsdp.prefetch), []).append(
                    {k: counts[k] for k in names})
                return loss, [dict(p) for p in params]

            numels = [p.numel() for stage in stages for p in stage.parameters()]
            fres = autotune.tune("fsdp_train_step", fsdp_work,
                                 signature=("fsdp", cfg["d_model"], cfg["num_layers"], (8, 1024)),
                                 search=["HEAT_TPU_FSDP_PREFETCH"],
                                 cost_fn=cost.fsdp_cost_fn(numels, 4, 1),
                                 trials_per_config=TUNE_TRIALS, db_dir=tune_db, adopt=False)
            digests = {}
            for value in ("0", "1", "2"):
                with _knobs.overlay({"HEAT_TPU_FSDP_PREFETCH": value}):
                    digests[value] = trials.digest(fsdp_work())
        finally:
            if saved is None:
                os.environ.pop("HEAT_TPU_FSDP", None)
            else:
                os.environ["HEAT_TPU_FSDP"] = saved
        emit({"phase": "autotune fsdp prefetch", "card": smi, "pick": fres.config,
              "validation": fres.record["validation"], "trials": fres.trials_run,
              "baseline_median_s": fres.record["baseline_wall"],
              "pick_median_s": fres.record["tuned_wall"],
              "launches_per_trial": fsdp_launches, "digests": digests})
        check("autotune fsdp: every prefetch depth's loss and parameters digest the same",
              len(set(digests.values())) == 1 and fres.record["configs_measured"] >= 2,
              digests=digests, configs_measured=fres.record["configs_measured"])
        check("autotune fsdp: every trial launched K6, K7a and K7b",
              all(row[k] > 0 for rows_ in fsdp_launches.values() for row in rows_
                  for k in names), launches=fsdp_launches)
        for k in names:
            launches[k] = sum(row[k] for rows_ in fsdp_launches.values() for row in rows_)
        del model, stages, init

        # (c) resplit over HEAT_TPU_RELAYOUT_PLAN on one card
        r_rows, r_cols = TUNE_RESPLIT
        xr = ht.array(torch.randn(TUNE_RESPLIT, generator=torch.Generator(device=dev)
                                  .manual_seed(7), device=dev), split=0)
        rres = autotune.tune("resplit", lambda: ht.resplit(xr, 1).larray,
                             signature=("resplit", TUNE_RESPLIT, 0, 1),
                             search=["HEAT_TPU_RELAYOUT_PLAN"],
                             cost_fn=cost.relayout_cost_fn(TUNE_RESPLIT, 4, 0, 1, 1),
                             trials_per_config=TUNE_TRIALS, db_dir=tune_db, adopt=False)
        emit({"phase": "autotune resplit one card", "card": smi, "shape": list(TUNE_RESPLIT),
              "pick": rres.config, "validation": rres.record["validation"],
              "configs_measured": rres.record["configs_measured"],
              "baseline_median_s": rres.record["baseline_wall"],
              "pick_median_s": rres.record["tuned_wall"]})
        check("autotune resplit: every plan gives the same bits, the pick no slower",
              rres.record["validation"] == "digest"
              and rres.record["configs_measured"] == 4
              and rres.record["tuned_wall"] <= rres.record["baseline_wall"],
              record=rres.record)
        del xr
    finally:
        autotune.reset()
        shutil.rmtree(tmp, ignore_errors=True)

    # (d) the registry on the card
    a = ht.array(torch.randn((4096, 256), device=dev), split=0)
    a.resplit(1)
    resilience.refresh()
    rule = resilience.inject(site="relayout", kind="resource", calls=(1,))
    try:
        a.resplit(1)
        raised = False
    except resilience.HeatTpuRuntimeError as e:
        raised = e.site == "relayout"
    finally:
        resilience.clear_faults()
        resilience.refresh()
    check("registry: a fault injected at relayout raises from resplit",
          raised and rule.fired == 1, fired=rule.fired)
    n, window = REGISTRY_CG
    gen = torch.Generator(device=dev).manual_seed(5)
    m = torch.randn((n, n), generator=gen, device=dev)
    A = ht.array(m @ m.T / n + torch.eye(n, device=dev), split=0)
    B = ht.array(torch.randn((n,), generator=gen, device=dev))
    x0 = ht.zeros(n)
    whole = ht.linalg.cg(A, B, x0).larray
    ck = tempfile.mkdtemp(prefix="chip_smoke_cg_fault_")
    path = os.path.join(ck, "cg")
    try:
        resilience.inject(site="cg_chunk", kind="resource", calls=(2,))
        try:
            ht.linalg.cg(A, B, x0, checkpoint_every=window, checkpoint_path=path)
            stopped = False
        except resilience.HeatTpuRuntimeError as e:
            stopped = e.site == "cg_chunk"
        finally:
            resilience.clear_faults()
            resilience.refresh()
        _, extra = resilience.load_checkpoint(path, with_extra=True)
        resumed = ht.linalg.cg(A, B, x0, checkpoint_every=window, checkpoint_path=path,
                               resume=True).larray
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    same = bool(torch.equal(whole, resumed))
    check("registry: a fault at the second cg_chunk window stops cg after its first "
          "checkpoint, and the resumed solve equals the uninterrupted one bit for bit",
          stopped and extra.get("it") == window and same, it=extra.get("it"), same=same)
    del A, B, x0, whole, resumed, m

    # a second pass over sites the main paths reach: hits only, no build
    xs = ht.array(torch.randn((100_000, 64), device=dev), split=0)
    ys = ht.array(torch.randn((100_000,), device=dev), split=0)

    def again():
        xs.resplit(1)
        ht.core.statistics.chunk_moments(xs)
        ht.regression.Lasso(lam=0.01, max_iter=2, tol=0.0).fit(xs, ys)
        ht.linalg.cg(A2, B2, ht.zeros(64))
        xs[torch.arange(0, 100_000, 7, device=dev)]

    gen = torch.Generator(device=dev).manual_seed(6)
    mm = torch.randn((64, 64), generator=gen, device=dev)
    A2 = ht.array(mm @ mm.T + 64 * torch.eye(64, device=dev), split=0)
    B2 = ht.array(torch.randn((64,), generator=gen, device=dev))
    again()
    before = program_cache.stats()
    with telemetry.CompileWatcher() as cw:
        again()
        torch.cuda.synchronize()
    after = program_cache.stats()
    reached = {k: v for k, v in after["sites"].items() if v["hits"] + v["misses"] > 0}
    emit({"phase": "registry sites", "card": smi, "sites": reached,
          "second_pass_builds": cw.backend_compiles,
          "second_pass_misses": after["misses"] - before["misses"],
          "second_pass_hits": after["hits"] - before["hits"]})
    check("registry: the sites the main paths reach moved, and a second pass builds nothing",
          len(reached) >= 20 and all(s in reached for s in (
              "relayout", "cg", "cg_chunk", "streaming.lasso", "streaming.moments",
              "streaming.minibatch_kmeans", "dp_train_step", "fsdp_train_step",
              "zero_train_step", "pipeline.step", "sharded_take"))
          and cw.backend_compiles == 0 and after["misses"] == before["misses"]
          and after["hits"] > before["hits"], reached=sorted(reached),
          builds=cw.backend_compiles)
    del xs, ys, A2, B2
    return launches


# the streaming path: bench.py:246's moments array as four .npy shards,
# streamed under HEAT_TPU_HBM_BUDGET=1G (rows, columns, shards), the
# MiniBatchKMeans on it (clusters, Lloyd window a chunk), the KMeans
# checkpoint fit (rows, iterations, window) and the CSV round trip (rows,
# columns)
STREAM = (8_000_000, 64, 4)
STREAM_BUDGET = "1G"
STREAM_KMEANS = (64, 3)
STREAM_CHECKPOINT_FIT = (1_000_000, 20, 6)
STREAM_CSV = (1_000_000, 16)


def _stream_carry(est):
    """An estimator's carry as host arrays, to compare bit for bit."""
    if hasattr(est, "_m2"):
        return [est._mean.copy(), est._m2.copy(), est.n_seen]
    return [est._centers_np.copy(), est._counts_np.copy(), est._shift]


def _carries_equal(a, b):
    import numpy as np

    return all(np.array_equal(x, y) if isinstance(x, np.ndarray) else x == y
               for x, y in zip(a, b))


def streaming_path(ht, dev, smi, time_ms):
    """The out-of-core path through the user entry points: bench.py:246's
    moments array (8,000,000 x 64 f32, ht.random seed 0) written as four
    .npy shards of 2,000,000 rows, streamed by ChunkStream under
    HEAT_TPU_HBM_BUDGET=1G (temp_budget 256 MiB: chunks of 1,048,576 rows,
    the chunking restarting at each file, 8 chunks); StreamingMoments over
    the stream (K2 once a chunk) against float64 numpy of the whole array,
    its peak device memory against the file set's bytes; MiniBatchKMeans(64,
    inner_iter=3, random_state=0) over the stream (K4 in each window) against
    the same estimator on the plain Lloyd pass on the card, from the same
    carry at every chunk; both resumed from a checkpoint after chunk 4 and
    continued through ChunkStream(skip_rows=...), bit for bit; a
    KMeans(checkpoint_every=6) fit of the first 1,000,000 rows against the
    uninterrupted fit and against a fit killed after 12 iterations and
    resumed, bit for bit; save_csv/load_csv of 1,000,000 x 16 f32 through the
    native parser against np.loadtxt, and save_npy/load_npy of a split
    array. Each stream's launches are counted around it. Returns them."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from heat_tpu_torch import native
    from heat_tpu_torch.cluster.cuda_lloyd import lloyd_update_plain
    from heat_tpu_torch.core.cuda_moments import column_moments

    rows, d, shards = STREAM
    per_file = rows // shards
    tmp = tempfile.mkdtemp(prefix="heat_stream_")
    old_budget = os.environ.get("HEAT_TPU_HBM_BUDGET")
    os.environ["HEAT_TPU_HBM_BUDGET"] = STREAM_BUDGET
    try:
        # the data: drawn on the card, written shard by shard; float64 sums
        # on the host for the reference
        torch.cuda.synchronize()
        t = time.perf_counter()
        ht.random.seed(0)
        x = ht.random.randn(rows, d, dtype=ht.float32, split=0)
        paths, host = [], []
        for s in range(shards):
            part = x.larray[s * per_file:(s + 1) * per_file].cpu().numpy()
            path = os.path.join(tmp, f"shard{s}.npy")
            np.save(path, part)
            paths.append(path)
            host.append(part)
        del x, part
        write_s = time.perf_counter() - t
        sum64 = sum(p.sum(0, dtype=np.float64) for p in host)
        mean64 = sum64 / rows
        var64 = sum(((p - mean64) ** 2).sum(0) for p in host) / rows
        torch.cuda.empty_cache()

        stream = ht.streaming.ChunkStream(paths)
        budget = ht.resilience.memory_guard.budget_bytes()
        temp = ht.resilience.memory_guard.temp_budget()
        chunk_rows = [min(stream.chunk_rows, per_file - lo)
                      for _ in paths for lo in range(0, per_file, stream.chunk_rows)]
        emit({"phase": "streaming data", "shape": [rows, d], "shards": shards,
              "write_s": write_s, "budget_bytes": budget, "temp_budget_bytes": temp,
              "chunk_rows": stream.chunk_rows, "chunks": len(stream),
              "load_all_bytes": stream.load_all_bytes()})
        check("stream: 1,048,576-row chunks, 8 chunks, restarting at each file",
              temp == 256 << 20 and stream.chunk_rows == 1_048_576 and len(stream) == 8
              and len(chunk_rows) == 8, chunk_rows=chunk_rows)

        def run_stream(est, stream, save_after=None, path=None):
            """Feed the stream to ``est``: (load seconds, fit seconds, carries
            after each chunk); saves ``est`` after chunk ``save_after`` (its
            seconds in ``save_s``)."""
            load_s, fit_s, carries = [], [], []
            it = iter(stream)
            while True:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                try:
                    chunk = next(it)
                except StopIteration:
                    break
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                est.partial_fit(chunk)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                load_s.append(t1 - t0)
                fit_s.append(t2 - t1)
                carries.append(_stream_carry(est))
                if save_after == len(carries):
                    t3 = time.perf_counter()
                    est.save(path)
                    save_s.append(time.perf_counter() - t3)
                del chunk
            return load_s, fit_s, carries

        save_s = []

        # ------------------------------------------- StreamingMoments, main path
        ckpt_m = os.path.join(tmp, "moments_ckpt")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        ht.reset_launch_counts()
        t = time.perf_counter()
        moments = ht.streaming.StreamingMoments()
        load_s, fit_s, m_carries = run_stream(moments, ht.streaming.ChunkStream(paths), 4, ckpt_m)
        wall_s = time.perf_counter() - t
        moments_launches = ht.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        spread = np.abs(mean64) + np.sqrt(var64)
        err_mean = float((np.abs(moments.mean - mean64) / spread).max())
        err_var = float((np.abs(moments.var() - var64) / var64).max())
        # K2 alone on one chunk of the stream, by CUDA events
        first = ht.load_npy(paths[0], split=0, chunks=(0, stream.chunk_rows))
        k2_ms = time_ms(lambda: column_moments(first.larray), 20)
        k2_bound = first.larray.numel() * 4 / HBM_BYTES_PER_S * 1e3
        # where a chunk's load goes: the read out of the memory map (the
        # files are in the page cache: they were just written) and the
        # host-to-device copy, pageable and pinned
        mm = np.load(paths[0], mmap_mode="r")
        t0 = time.perf_counter()
        block = np.array(mm[stream.chunk_rows:2 * stream.chunk_rows])
        read_ms = (time.perf_counter() - t0) * 1e3
        src = torch.from_numpy(block)
        h2d_ms = time_ms(lambda: src.to(dev), 5)
        t0 = time.perf_counter()
        pinned = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        pin_alloc_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        pinned.copy_(src)
        pin_copy_ms = (time.perf_counter() - t0) * 1e3
        h2d_pinned_ms = time_ms(lambda: pinned.to(dev, non_blocking=True), 5)
        del first, mm, block, src, pinned
        moments_fields = {
            "rows": rows, "chunks": len(fit_s), "wall_s": wall_s, "rows_per_s": rows / wall_s,
            "chunk_wall_ms": [1e3 * (a + b) for a, b in zip(load_s, fit_s)],
            "chunk_load_ms": [1e3 * a for a in load_s], "chunk_fit_ms": [1e3 * b for b in fit_s],
            "host_share": sum(load_s) / wall_s, "checkpoint_save_s": save_s[0],
            "other_s": wall_s - sum(load_s) - sum(fit_s) - save_s[0], "k2_ms_a_chunk": k2_ms,
            "k2_bound_ms_a_chunk": k2_bound, "chunk_read_ms": read_ms,
            "chunk_h2d_pageable_ms": h2d_ms, "chunk_h2d_pinned_ms": h2d_pinned_ms,
            "pin_alloc_ms": pin_alloc_ms, "pin_copy_ms": pin_copy_ms,
            "peak_allocated_bytes": peak, "allocated_before_bytes": base_mem,
            "load_all_bytes": stream.load_all_bytes(), "launches": moments_launches,
            "mean_err_over_spread": err_mean, "var_rel_err": err_var,
            "tolerance": {"mean_over_spread": 1e-5, "var_rel": 1e-4}, "nvidia_smi": smi}
        emit({"phase": "streaming moments", **moments_fields})
        check("StreamingMoments vs float64 numpy of the whole array",
              err_mean <= 1e-5 and err_var <= 1e-4, mean_err_over_spread=err_mean,
              var_rel_err=err_var)
        check("StreamingMoments launched K2 once a chunk (8)", moments_launches["moments"] == 8,
              launches=moments_launches)
        check("StreamingMoments peak device memory below the file set's bytes",
              peak < stream.load_all_bytes(), peak=peak, load_all=stream.load_all_bytes())

        # ----------------------------------------- MiniBatchKMeans, main path
        k, inner = STREAM_KMEANS
        ckpt_k = os.path.join(tmp, "minibatch_ckpt")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ht.reset_launch_counts()
        t = time.perf_counter()
        mbk = ht.streaming.MiniBatchKMeans(n_clusters=k, inner_iter=inner, random_state=0)
        k_load, k_fit, k_carries = run_stream(mbk, ht.streaming.ChunkStream(paths), 4, ckpt_k)
        k_wall = time.perf_counter() - t
        mbk_launches = ht.launch_counts()
        k_peak = torch.cuda.max_memory_allocated()

        # the same estimator on the plain Lloyd pass, on the card: from the
        # kernel estimator's carry before each chunk (one chunk's window and
        # blend), and along its own trajectory from the same first centers
        ref = ht.streaming.MiniBatchKMeans(n_clusters=k, inner_iter=inner, random_state=0)
        ref._update = lloyd_update_plain
        traj = ht.streaming.MiniBatchKMeans(n_clusters=k, inner_iter=inner, random_state=0)
        traj._update = lloyd_update_plain
        per_chunk = []
        for i, chunk in enumerate(ht.streaming.ChunkStream(paths)):
            if i:
                ref._centers_np, ref._counts_np, ref._shift = (
                    k_carries[i - 1][0].copy(), k_carries[i - 1][1].copy(), k_carries[i - 1][2])
            ref.partial_fit(chunk)
            traj.partial_fit(chunk)
            c_k, cnt_k = k_carries[i][0], k_carries[i][1]
            scale = float(np.abs(ref._centers_np).max())
            per_chunk.append({
                "center_max_abs_err": float(np.abs(c_k - ref._centers_np).max()),
                "center_rel_rms": float(np.linalg.norm(c_k - ref._centers_np)
                                        / np.linalg.norm(ref._centers_np)),
                "counts_max_abs_diff": float(np.abs(cnt_k - ref._counts_np).max()),
                "counts_sum": float(cnt_k.sum()), "center_scale": scale})
            del chunk
        worst = max(max(p["center_max_abs_err"] / (1e-2 * p["center_scale"]),
                        p["center_rel_rms"] / 1e-3) for p in per_chunk)
        rows_ok = all(p["counts_sum"] == sum(chunk_rows[:i + 1])
                      for i, p in enumerate(per_chunk))
        traj_err = float(np.abs(mbk._centers_np - traj._centers_np).max())
        emit({"phase": "streaming minibatch kmeans", "n_clusters": k, "inner_iter": inner,
              "wall_s": k_wall, "rows_per_s": rows / k_wall, "checkpoint_save_s": save_s[1],
              "chunk_fit_ms": [1e3 * b for b in k_fit], "chunk_load_ms": [1e3 * a for a in k_load],
              "peak_allocated_bytes": k_peak, "launches": mbk_launches,
              "inertia_last_chunk": mbk.inertia_, "plain_inertia_last_chunk": ref.inertia_,
              "per_chunk_vs_plain_from_the_same_carry": per_chunk,
              "trajectory_vs_plain_center_max_abs_err": traj_err,
              "trajectory_plain_inertia_last_chunk": traj.inertia_,
              "tolerance": "from the same carry, centers relative RMS <= 1e-3 and largest "
                           "error <= 1e-2 max|c| against the plain pass's; counts add up to "
                           "the rows seen", "nvidia_smi": smi})
        check("MiniBatchKMeans vs its plain version on the card, chunk by chunk",
              worst <= 1.0 and rows_ok, worst_err_over_tol=worst)
        check("MiniBatchKMeans launched K4 within its window's bound (8 x 3) and seeded on "
              "the random kernel",
              0 < mbk_launches["lloyd"] <= 8 * inner and mbk_launches["random"] > 0,
              launches=mbk_launches)

        # ------------------------------------------------ resume bit for bit
        skip = sum(chunk_rows[:4])
        resumed_m = ht.streaming.StreamingMoments.restore(ckpt_m)
        resumed_k = ht.streaming.MiniBatchKMeans.restore(ckpt_k)
        for chunk in ht.streaming.ChunkStream(paths, skip_rows=skip):
            resumed_m.partial_fit(chunk)
            resumed_k.partial_fit(chunk)
            del chunk
        same_m = _carries_equal(_stream_carry(resumed_m), m_carries[-1])
        same_k = _carries_equal(_stream_carry(resumed_k), k_carries[-1])
        check("StreamingMoments resumed after chunk 4: bit for bit", same_m, skip_rows=skip,
              chunks_after_resume=resumed_m.chunks_seen)
        check("MiniBatchKMeans resumed after chunk 4: bit for bit", same_k, skip_rows=skip,
              chunks_after_resume=resumed_k.chunks_seen)

        # --------------------------------------- KMeans(checkpoint_every=...)
        n_fit, iters, every = STREAM_CHECKPOINT_FIT
        xf = ht.load_npy(paths[0], split=0, chunks=(0, n_fit))
        kw = dict(n_clusters=k, init="random", max_iter=iters, tol=0.0, random_state=0)
        plain_fit, plain_ms = _timed(lambda: ht.cluster.KMeans(**kw).fit(xf))
        ck_path = os.path.join(tmp, "kmeans_ckpt")
        ck_fit, ck_ms = _timed(lambda: ht.cluster.KMeans(
            **kw, checkpoint_every=every, checkpoint_path=ck_path).fit(xf))
        shutil.rmtree(ck_path)
        ht.cluster.KMeans(**dict(kw, max_iter=2 * every), checkpoint_every=every,
                          checkpoint_path=ck_path).fit(xf)
        resumed_fit = ht.cluster.KMeans(**kw, checkpoint_every=every, checkpoint_path=ck_path,
                                        resume=True).fit(xf)

        def same_fit(a, b):
            return (a.n_iter_ == b.n_iter_ and a.inertia_ == b.inertia_
                    and torch.equal(a.cluster_centers_.larray, b.cluster_centers_.larray)
                    and torch.equal(a.labels_.larray, b.labels_.larray))

        check("KMeans(checkpoint_every=6) equals the uninterrupted fit bit for bit",
              same_fit(plain_fit, ck_fit), n_iter=ck_fit.n_iter_, fit_ms=plain_ms,
              checkpointed_fit_ms=ck_ms)
        check("KMeans killed after 12 iterations and resumed equals the uninterrupted fit",
              same_fit(plain_fit, resumed_fit), n_iter=resumed_fit.n_iter_)
        del xf, plain_fit, ck_fit, resumed_fit

        # --------------------------------------------------- CSV and npy I/O
        csv_rows, csv_cols = STREAM_CSV
        ht.random.seed(1)
        xc = ht.random.rand(csv_rows, csv_cols, dtype=ht.float32, split=0)
        csv_path = os.path.join(tmp, "x.csv")
        before = native.native_calls()
        _, save_ms = _timed(lambda: ht.save_csv(xc, csv_path))
        loaded, load_ms = _timed(lambda: ht.load_csv(csv_path, split=0))
        calls = {key: native.native_calls()[key] - before[key] for key in before}
        t0 = time.perf_counter()
        want = np.loadtxt(csv_path, delimiter=",", dtype=np.float64)
        loadtxt_ms = (time.perf_counter() - t0) * 1e3
        got = loaded.numpy()
        csv_ok = (np.array_equal(got, want.astype(np.float32))
                  and np.array_equal(got, xc.numpy()))
        emit({"phase": "streaming csv", "shape": [csv_rows, csv_cols],
              "file_bytes": os.path.getsize(csv_path), "save_csv_ms": save_ms,
              "load_csv_ms": load_ms, "np_loadtxt_ms": loadtxt_ms,
              "native_library": str(native.library_path()),
              "native_available": native.native_available(), "native_calls": calls})
        check("CSV: save_csv/load_csv through the native parser equal np.loadtxt",
              csv_ok and calls["parse"] >= 1 and calls["write"] >= 1, native_calls=calls)
        npy_path = os.path.join(tmp, "x.npy")
        ht.save_npy(xc, npy_path)
        back = ht.load_npy(npy_path, split=0)
        check("npy: save_npy/load_npy of a split array", back.split == 0
              and torch.equal(back.larray, xc.larray))
        del xc, loaded, back, got, want
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if old_budget is None:
            os.environ.pop("HEAT_TPU_HBM_BUDGET", None)
        else:
            os.environ["HEAT_TPU_HBM_BUDGET"] = old_budget
    return {"moments": moments_launches, "minibatch": mbk_launches,
            "k2_ms_a_chunk": k2_ms, "k2_bound_ms_a_chunk": k2_bound}


# bench.py:317-333's serving row at its full size: (data rows, features,
# centers, requests, rows a request), served with max_batch=64
SERVING = (200_000, 64, 16, 1024, 16)
# every endpoint kind at modest sizes: training and reference rows,
# features, classes, reference rows of cdist/rbf, dense (d_in, d_out),
# sparse (features, out, density), requests a kind, the ladder top
SERVING_KINDS = {"train": 20_000, "features": 64, "classes": 10, "reference": 4096,
                 "dense": (1024, 256), "sparse": (1024, 64, 0.02), "requests": 32,
                 "max_batch": 16}
UNIT_ROUNDOFF = 2.0 ** -24  # f32
# KNN at bench.py's serving training size (200,000 x 64, 51 MB)
SERVING_KNN_FULL = {"train": 200_000, "features": 64, "classes": 16, "k": 5, "requests": 16,
                    "max_batch": 64}


def _program_bytes(server, name, ep):
    """After the warm-up: each bucket's graph pool bytes as
    memory_guard.program_bytes reads them (the largest of a sparse bucket's
    nnz lattice), the bytes of the parameter set, and how many parameter
    sets the endpoint's programs hold (one: the buckets share it)."""
    import numpy as np
    import torch

    from heat_tpu_torch.resilience import memory_guard

    pools, sets, params = {}, set(), 0
    for b in server.ladder:
        for cap in (ep.nnz_ladder(b) if ep.is_sparse else (None,)):
            prog = server._program(name, ep, b, cap)
            if ep.is_sparse:
                args = (torch.zeros(b + 1, dtype=torch.int32), torch.zeros(cap, dtype=torch.int32),
                        torch.from_numpy(np.zeros(cap, ep.dtype)))
            else:
                args = (torch.from_numpy(np.zeros((b, ep.features), ep.dtype)),)
            args += tuple(ep.params)
            pools[b] = max(pools.get(b, 0), memory_guard.program_bytes(prog, args))
            sets.add(id(prog.__wrapped__.shared))
            params = prog.__wrapped__.param_bytes()
    want = sum(p.numel() * p.element_size() for p in ep.params)
    check(f"serving kinds: {name}'s buckets share one parameter set of its parameters' bytes",
          len(sets) == 1 and params == want, param_sets=len(sets), param_bytes=params,
          want=want)
    return {"pool_bytes": pools, "param_bytes": params, "param_sets": len(sets)}


def _serving_knn_full(ht, dev):
    """knn_classify over SERVING_KNN_FULL's training set (separated blobs,
    16 classes 8 apart), Server(max_batch=64) warmed: each bucket's pool
    bytes, the largest below one copy of its untiled (bucket, N, F)
    broadcast; one parameter set for the seven buckets; requests batched
    against solo bit for bit; labels against float64 (the squared
    distances by the float64 expansion); no build after warm-up; one
    64-row batch's device time by CUDA events against its wall."""
    import numpy as np
    import torch

    from heat_tpu_torch import serve, telemetry

    cfg = SERVING_KNN_FULL
    n, f, ncls = cfg["train"], cfg["features"], cfg["classes"]
    rng = np.random.default_rng(3)
    protos = (rng.standard_normal((ncls, f)) * 8).astype(np.float32)
    ids = rng.integers(0, ncls, n)
    xt = (protos[ids] + rng.standard_normal((n, f))).astype(np.float32)
    knn = ht.classification.KNeighborsClassifier(cfg["k"]).fit(
        ht.array(xt, split=0), ht.array(ids.astype(np.int64), split=0))
    ep = serve.knn_classify(knn)
    server = serve.Server(max_batch=cfg["max_batch"], max_wait_ms=20.0)
    server.register("knn_full", ep)
    warm = server.warmup()
    sizes = _program_bytes(server, "knn_full", ep)
    top = max(server.ladder)
    untiled = top * n * f * 4
    check("serving kinds: knn over 200,000 x 64, the largest bucket's pool below one copy of "
          "its untiled broadcast", 0 < sizes["pool_bytes"][top] < untiled,
          pool_bytes=sizes["pool_bytes"][top], untiled_broadcast_bytes=untiled)
    qs = [(protos[rng.integers(0, ncls, r)] + rng.standard_normal((r, f))).astype(np.float32)
          for r in rng.integers(1, 10, cfg["requests"])]
    qs.append((protos[rng.integers(0, ncls, top)] + rng.standard_normal((top, f)))
              .astype(np.float32))
    with telemetry.CompileWatcher() as cw:
        solo = [server.predict("knn_full", q) for q in qs]
        batched = [fut.result(120) for fut in [server.submit("knn_full", q) for q in qs]]
    bitwise = all(a.tobytes() == b.tobytes() for a, b in zip(solo, batched))
    x64 = ep.params[0].double()
    x2 = (x64 * x64).sum(1)
    wrong = 0
    for q, got in zip(qs, batched):
        q64 = torch.from_numpy(q).to(dev).double()
        d2 = (q64 * q64).sum(1, keepdim=True) + x2[None] - 2.0 * (q64 @ x64.T)
        idx = torch.sort(d2, dim=1, stable=True).indices[:, :ep.config["k"]]
        votes = (ep.params[1][idx][:, :, None] == ep.params[2][None, None]).sum(1)
        want = ep.params[2][votes.argmax(1)]
        wrong += int((torch.from_numpy(np.asarray(got)).to(dev) != want).sum())
    check("serving kinds: knn over 200,000 x 64 batched equals solo bit for bit", bitwise)
    check("serving kinds: knn over 200,000 x 64 labels equal float64's, no build after warm-up",
          wrong == 0 and cw.backend_compiles == 0, label_mismatches=wrong,
          builds=cw.backend_compiles)
    prog = server._program("knn_full", ep, top)
    batch = torch.from_numpy(qs[-1])
    prog(batch, *ep.params)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    reps = 10
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        out = prog(batch, *ep.params)
    end.record()
    out.cpu()
    wall = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    server.close()
    return {"sizes": cfg, "warmup": warm, **sizes, "untiled_broadcast_bytes": untiled,
            "bitwise_batched_vs_solo": bitwise, "label_mismatches": wrong,
            "batch64_device_ms": start.elapsed_time(end) / reps, "batch64_wall_ms": wall}


def _serving_kinds(ht, dev, smi):
    """Every endpoint kind on the card at SERVING_KINDS' sizes, in exact and
    in fast mode: each request batched (coalesced into a padded bucket)
    against solo; against the plain PyTorch form in float64 (labels equal on
    separated blobs; floats within the f32 bound of their form: 16 u times
    the sum of the magnitudes of the terms for the exact halving trees, n u
    for the fast GEMM forms, on the squared distances 32 u (|x|^2 + |y|^2)
    for the fast expansion); each endpoint's pool bytes a bucket and its one
    parameter set (_program_bytes); then save -> restore bit for bit (and no
    build), an injected transient fault retried with the same bits, a shed
    under HEAT_TPU_SERVE_QUEUE_MAX=4, and KNN at bench.py's serving training
    size (_serving_knn_full). Returns the phase's report."""
    import numpy as np
    import torch

    from heat_tpu_torch import resilience, serve, telemetry
    from heat_tpu_torch.serve import ServerOverloadedError

    cfg = SERVING_KINDS
    n, f, ncls, nref = cfg["train"], cfg["features"], cfg["classes"], cfg["reference"]
    (d_in, d_out), (s_in, s_out, density) = cfg["dense"], cfg["sparse"]
    rng = np.random.default_rng(1)
    protos = (rng.standard_normal((ncls, f)) * 8).astype(np.float32)
    ids = rng.integers(0, ncls, n)
    xt = (protos[ids] + rng.standard_normal((n, f))).astype(np.float32)
    beta = rng.standard_normal(f).astype(np.float32)
    x_dev = ht.array(xt, split=0)
    y_dev = ht.array(ids.astype(np.int64), split=0)
    knn = ht.classification.KNeighborsClassifier(5).fit(x_dev, y_dev)
    gnb = ht.naive_bayes.GaussianNB().fit(x_dev, y_dev)
    lasso = ht.regression.Lasso(lam=0.01, max_iter=20).fit(
        x_dev, ht.array(xt @ beta + 0.5, split=0))
    w_dense = (rng.standard_normal((d_in, d_out)) / 32).astype(np.float32)
    b_dense = rng.standard_normal(d_out).astype(np.float32)
    w_sparse = rng.standard_normal((s_in, s_out)).astype(np.float32)
    b_sparse = rng.standard_normal(s_out).astype(np.float32)
    ref_rows = xt[:nref]
    gamma = 1.0 / (2.0 * 8.0 * 8.0)

    def endpoints():
        return {
            "kmeans": serve.Endpoint("kmeans_predict", [protos], features=f, dtype=np.float32),
            "knn": serve.knn_classify(knn),
            "gnb": serve.gaussian_nb_predict(gnb),
            "lasso": serve.lasso_predict(lasso),
            "cdist": serve.cdist_query(ref_rows),
            "rbf": serve.rbf_query(ref_rows, sigma=8.0),
            "dense": serve.dense_forward(w_dense, b_dense, activation="relu"),
            "sparse": serve.sparse_query(w_sparse, b_sparse, activation="relu"),
        }

    def payload(name):
        r = int(rng.integers(1, 10))
        if name == "dense":
            return rng.standard_normal((r, d_in)).astype(np.float32)
        if name == "sparse":
            q = rng.standard_normal((r, s_in)).astype(np.float32)
            q[rng.random(q.shape) >= density] = 0
            return q
        q = protos[rng.integers(0, ncls, r)] + rng.standard_normal((r, f))
        return q.astype(np.float64 if name == "gnb" else np.float32)

    payloads = {name: [payload(name) for _ in range(cfg["requests"])] for name in endpoints()}

    def reference(name, ep, q, exact):
        """(the float64 answer, its tolerance or None for labels)."""
        q64 = torch.from_numpy(q).to(dev).double()
        p64 = [p.double() for p in ep.params]
        u = UNIT_ROUNDOFF
        if name in ("kmeans", "knn", "cdist", "rbf"):
            ref = p64[0]
            d2 = ((q64[:, None, :] - ref[None]) ** 2).sum(-1)
            scale = (q64 ** 2).sum(1, keepdim=True) + (ref ** 2).sum(1)[None]
            if name == "kmeans":
                return d2.argmin(1), None
            if name == "knn":
                idx = torch.sort(d2, dim=1, stable=True).indices[:, :ep.config["k"]]
                votes = (ep.params[1][idx][:, :, None] == ep.params[2][None, None]).sum(1)
                return ep.params[2][votes.argmax(1)], None
            if name == "cdist":
                if exact:
                    return d2.sqrt(), 16 * u * d2.sqrt() + 1e-7
                return d2, 32 * u * scale  # held on the squared distances
            tol = (16 * u * (gamma * d2 + 1) if exact else gamma * 32 * u * scale + 16 * u)
            return torch.exp(-gamma * d2), tol * torch.exp(-gamma * d2) + 1e-30
        if name == "gnb":
            theta, var, prior, classes = p64[0], p64[1], p64[2], ep.params[3]
            jll = (prior.log()[None] - 0.5 * torch.log(2 * np.pi * var).sum(1)[None]
                   - 0.5 * ((q64[:, None] - theta[None]) ** 2 / var[None]).sum(2))
            return classes[jll.argmax(1)], None
        w = p64[0] if name != "lasso" else p64[0][:, None]
        b = p64[1] if len(p64) > 1 else None
        y = q64 @ w + (b if b is not None else 0)
        mag = q64.abs() @ w.abs() + (b.abs() if b is not None else 0)
        terms = q64.shape[1]
        tol = (16 if exact else terms) * u * mag + 1e-30
        if name == "lasso":
            return y[:, 0], tol[:, 0]
        return torch.clamp(y, min=0), tol

    def serve_all(exact):
        eps = endpoints()
        server = serve.Server(max_batch=cfg["max_batch"], max_wait_ms=20.0)
        for name, ep in eps.items():
            server.register(name, ep)
        warm = server.warmup()
        rows = {}
        sizes = {name: _program_bytes(server, name, ep) for name, ep in eps.items()}
        with telemetry.CompileWatcher() as cw:
            for name, ep in eps.items():
                qs = payloads[name]
                solo = [server.predict(name, q) for q in qs]
                batched = [fut.result(120) for fut in [server.submit(name, q) for q in qs]]
                bitwise = all(s.tobytes() == b.tobytes() for s, b in zip(solo, batched))
                worst, wrong = 0.0, 0
                for q, got in zip(qs, batched):
                    want, tol = reference(name, ep, q, exact)
                    got_t = torch.from_numpy(np.asarray(got)).to(dev)
                    if tol is None:
                        wrong += int((got_t.reshape(want.shape) != want).sum())
                        continue
                    if name == "cdist" and not exact:
                        got_t = got_t.double() ** 2
                    err = (got_t.double().reshape(want.shape) - want).abs()
                    worst = max(worst, float((err / tol).max()))
                rows[name] = {"bitwise_batched_vs_solo": bitwise, "label_mismatches": wrong,
                              "worst_error_over_tolerance": worst,
                              "batches": server.stats()["endpoints"][name]["batches"],
                              **sizes[name]}
                label = "exact" if exact else "fast"
                if exact:
                    check(f"serving kinds ({label}): {name} batched equals solo bit for bit",
                          bitwise)
                check(f"serving kinds ({label}): {name} against float64 within its f32 "
                      "tolerance", wrong == 0 and worst <= 1.0, **rows[name])
        check(f"serving kinds ({'exact' if exact else 'fast'}): no build after warm-up",
              cw.backend_compiles == 0, builds=cw.backend_compiles)
        return server, eps, warm, rows

    report = {}
    server, eps, warm, report["exact"] = serve_all(True)
    report["warmup"] = warm
    # save -> restore on the card, bit for bit, without a build
    with tempfile.TemporaryDirectory(prefix="chip_smoke_kinds_") as tmp:
        path = os.path.join(tmp, "ckpt")
        server.save(path)
        restored = serve.Server.restore(path, max_batch=cfg["max_batch"], device="cuda")
        with telemetry.CompileWatcher() as cw:
            rewarm = restored.warmup()
            same = all(restored.predict(name, q).tobytes() == server.predict(name, q).tobytes()
                       for name in eps for q in payloads[name][:4])
        restored.close()
    check("serving kinds: save -> restore answers bit for bit and builds nothing",
          same and cw.backend_compiles == 0, rewarm=rewarm)
    # an injected transient fault: the batch is retried, same bits, no build
    os.environ["HEAT_TPU_RETRIES"] = "2"
    os.environ["HEAT_TPU_RETRY_BASE"] = "0.001"
    resilience.refresh()
    retried = {}
    try:
        for name in eps:
            q = payloads[name][0]
            clean = server.predict(name, q)
            rule = resilience.inject(f"serve.{name}", kind="reset", calls=[1])
            with telemetry.CompileWatcher() as cw:
                again = server.predict(name, q)
            retried[name] = bool(rule.fired == 1 and again.tobytes() == clean.tobytes()
                                 and cw.backend_compiles == 0)
            resilience.clear_faults()
    finally:
        resilience.clear_faults()
        del os.environ["HEAT_TPU_RETRIES"], os.environ["HEAT_TPU_RETRY_BASE"]
        resilience.refresh()
    check("serving kinds: an injected transient fault is retried with the same bits",
          all(retried.values()), retried=retried)
    # a shed: queue bound 4, the first batch held 50 ms by an injected latency
    os.environ["HEAT_TPU_SERVE_QUEUE_MAX"] = "4"
    try:
        shedder = serve.Server(max_batch=cfg["max_batch"])
        shedder.register("shed", eps["kmeans"])
        shedder.warmup()
        resilience.inject("serve.shed", kind="latency", delay=0.05, calls=[1])
        q = payloads["kmeans"][0][:1]
        want = server.predict("kmeans", q)
        futs, sheds = [], 0
        for _ in range(64):
            try:
                futs.append(shedder.submit("shed", q))
            except ServerOverloadedError as e:
                sheds += e.reason == "queue_full"
        answered = all(fut.result(60).tobytes() == want.tobytes() for fut in futs)
        shedder.close()
    finally:
        resilience.clear_faults()
        del os.environ["HEAT_TPU_SERVE_QUEUE_MAX"]
    check("serving kinds: HEAT_TPU_SERVE_QUEUE_MAX=4 sheds 503 and answers the admitted",
          sheds > 0 and answered, sheds=sheds, admitted=len(futs))
    server.close()
    # fast mode: the GEMM forms, TF32 off inside, the caller's flag kept
    os.environ["HEAT_TPU_SERVE_EXACT"] = "0"
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        fast_server, _, _, report["fast"] = serve_all(False)
        fast_server.close()
        flag_kept = torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        del os.environ["HEAT_TPU_SERVE_EXACT"]
    check("serving kinds (fast): the caller's TF32 flag is kept", flag_kept)
    report["knn_full"] = _serving_knn_full(ht, dev)
    report.update(retried=retried, sheds=sheds, sizes=cfg)
    emit({"phase": "serving kinds", **report, "nvidia_smi": smi})
    return report


def serving_path(ht, dev, smi):
    """The serving path (bench.py:309-339 at its full size): KMeans(16,
    max_iter=10, random_state=0) fitted on ht.random.randn(200_000, 64)
    (seed 0; K4 and the threefry kernel launch in the fit), mounted on
    Server(max_batch=64) and warmed (a CUDA graph a bucket); 1024 requests
    of 16 x 64 f32 (default_rng(0)) submitted at once, three times, under a
    CompileWatcher that must see no build; every answer against its solo
    dispatch bit for bit and against float64 nearest-centre labels apart
    from near ties (the two best squared distances within 16 u of their
    sum, u = 2^-24); requests/s, latency percentiles, batches, occupancy,
    device time of one 64-row batch by CUDA events against its wall time,
    and the busy share of one burst under torch.profiler. Then every
    endpoint kind (_serving_kinds), and two replica processes on this card
    from the server's checkpoint behind a Router: 256 requests bit for bit,
    both replicas serving, no build after warm-up in either, no kernel
    compiled by either; then rolling_update onto the checkpoint of a
    publish of the fit with random_state=1 (version 2) under traffic: no
    request fails, the drains exit 0, the versions advance. Returns the
    fit's launches and the report."""
    import shutil
    import threading

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from heat_tpu_torch import serve, streaming, telemetry
    from heat_tpu_torch.serve.net import ReplicaPool, Router

    rows, d, k, n_req, req_rows = SERVING
    ht.random.seed(0)
    data = ht.random.randn(rows, d, dtype=ht.float32, split=0)
    torch.cuda.synchronize()
    ht.reset_launch_counts()
    t0 = time.perf_counter()
    km = ht.cluster.KMeans(n_clusters=k, max_iter=10, random_state=0).fit(data)
    torch.cuda.synchronize()
    fit_ms = (time.perf_counter() - t0) * 1e3
    fit_launches = {name: ht.launch_counts()[name] for name in ("lloyd", "random")}
    check("serving: the KMeans fit launched K4 and the threefry kernel",
          fit_launches["lloyd"] > 0 and fit_launches["random"] > 0, launches=fit_launches)

    server = serve.Server(max_batch=64)
    ep = serve.kmeans_predict(km)
    server.register("kmeans", ep)
    with telemetry.CompileWatcher() as cw:
        warm = server.warmup()
    check("serving: warm-up captured one CUDA graph a bucket",
          warm["backend_compiles"] == len(server.ladder) == cw.backend_compiles, warmup=warm)
    rng = np.random.default_rng(0)
    payloads = [rng.standard_normal((req_rows, d)).astype(np.float32) for _ in range(n_req)]

    def burst():
        t = time.perf_counter()
        futs = [server.submit("kmeans", p) for p in payloads]
        res = [fut.result(120) for fut in futs]
        return res, time.perf_counter() - t

    runs = []
    with telemetry.CompileWatcher() as steady:
        for _ in range(3):
            before = server.stats()["endpoints"]["kmeans"]["batches"]
            answers, wall = burst()
            batches = server.stats()["endpoints"]["kmeans"]["batches"] - before
            runs.append({"wall_s": wall, "requests_per_s": n_req / wall, "batches": batches,
                         "wall_ms_per_batch": wall * 1e3 / batches})
        solo = [server.predict("kmeans", p) for p in payloads]
    st = server.stats()["endpoints"]["kmeans"]
    check("serving: no build after warm-up (CompileWatcher over 3 bursts and the solo pass)",
          steady.backend_compiles == 0, builds=steady.backend_compiles)
    check("serving: every batched answer equals its solo dispatch bit for bit",
          all(a.tobytes() == s.tobytes() for a, s in zip(answers, solo)))
    q64 = torch.from_numpy(np.concatenate(payloads)).to(dev).double()
    c64 = ep.params[0].double()
    d2 = ((q64[:, None, :] - c64[None]) ** 2).sum(-1)
    two = torch.topk(d2, 2, dim=1, largest=False)
    near = (two.values[:, 1] - two.values[:, 0]) <= 16 * UNIT_ROUNDOFF * two.values.sum(1)
    got = torch.from_numpy(np.concatenate(answers)).to(dev)
    wrong = got != two.indices[:, 0]
    check("serving: labels equal the float64 nearest centres apart from near ties",
          not bool((wrong & ~near).any()), near_ties=int(near.sum()),
          near_ties_differing=int((wrong & near).sum()), rows=int(got.numel()))

    # one 64-row batch through the bucket's program: device time by CUDA
    # events (the host-to-device copy, the replay, the clone) against the
    # wall time of the call and the copy back
    prog = server._program("kmeans", ep, 64)
    xb = torch.from_numpy(np.concatenate(payloads[:4]))
    for _ in range(5):
        prog(xb, *ep.params).cpu()
    torch.cuda.synchronize()
    pairs, walls = [], []
    for _ in range(200):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        e0.record()
        out = prog(xb, *ep.params)
        e1.record()
        out.cpu()
        walls.append(time.perf_counter() - t)
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    device_ms = float(np.mean([a.elapsed_time(b) for a, b in pairs]))
    wall_ms = float(np.mean(walls)) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, prof_wall = burst()
    on_device = sum(ev.self_device_time_total for ev in prof.key_averages()
                    if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    report = {"fit_ms": fit_ms, "fit_launches": fit_launches, "warmup": warm, "runs": runs,
              "latency": st["latency"], "mean_batch_rows": st.get("mean_batch_rows"),
              "occupancy": st.get("occupancy"), "batch_device_ms": device_ms,
              "batch_wall_ms": wall_ms,
              "profiled_burst": {"wall_ms": prof_wall * 1e3, "device_ms": on_device,
                                 "device_busy_share": on_device / (prof_wall * 1e3)},
              "near_ties": int(near.sum())}
    emit({"phase": "serving path", **report, "nvidia_smi": smi})

    report["kinds"] = _serving_kinds(ht, dev, smi)

    # two replica processes on this card
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    pool, router = None, None
    try:
        v1, v2 = os.path.join(tmp, "v1"), os.path.join(tmp, "v2")
        server.save(v1)
        pool = ReplicaPool(v1, 2, device="cuda", ready_timeout=300.0,
                           env={"HEAT_TPU_SERVE_MAX_BATCH": "64"},
                           log_dir=os.path.join(tmp, "logs"))
        t = time.perf_counter()
        pool.start()  # a replica that fails to start raises here
        start_s = time.perf_counter() - t
        replicas = [{"index": h.index, "ready_s": h.ready_s, "start_s": h.ready["start_s"],
                     "restore_s": h.ready["restore_s"],
                     "warmup_s": h.ready["warmup"]["seconds"],
                     "kernel_builds": h.ready["kernel_builds"]} for h in pool.replicas]
        check("serving replicas: neither replica compiled a kernel (the build directory is "
              "shared)", all(r["kernel_builds"] == 0 for r in replicas), replicas=replicas)
        router = Router(pool, retries=2, poll_ms=25.0, workers=8, request_timeout=60.0)
        t = time.perf_counter()
        routed = [fut.result(120) for fut in [router.submit("kmeans", p) for p in payloads[:256]]]
        routed_s = time.perf_counter() - t
        check("serving replicas: 256 routed answers equal the in-process server bit for bit",
              all(np.asarray(a).tobytes() == b.tobytes() for a, b in zip(routed, answers)))
        nets = [pool.stats(h.index)["net"] for h in pool.replicas]
        check("serving replicas: both replicas served requests",
              all(n["http_requests"] > 0 for n in nets), http=[n["http_requests"] for n in nets])
        check("serving replicas: no build after warm-up in either replica",
              all(n["steady_backend_compiles"] == 0 for n in nets),
              steady=[n["steady_backend_compiles"] for n in nets])
        km1 = ht.cluster.KMeans(n_clusters=k, max_iter=10, random_state=1).fit(data)
        published = server.publish("kmeans", serve.kmeans_predict(km1))
        check("serving: a same-shape publish builds nothing",
              published["backend_compiles"] == 0 and published["version"] == 2,
              publish=published)
        want_v2 = [server.predict("kmeans", p) for p in payloads[:8]]
        server.save(v2)
        seen, errors, stop = [], [], threading.Event()

        def traffic(i):
            while not stop.is_set():
                p = payloads[i % 8]
                try:
                    seen.append((i % 8, np.asarray(router.predict("kmeans", p, timeout=60))))
                except Exception as e:  # noqa: BLE001 - counted and checked below
                    errors.append(repr(e))
                i += 1

        threads = [threading.Thread(target=traffic, args=(j,), daemon=True) for j in range(4)]
        for th in threads:
            th.start()
        rolled = streaming.rolling_update(pool, router, v2, drain_timeout=60.0)
        stop.set()
        for th in threads:
            th.join(120.0)
        valid = all(a.tobytes() in (answers[i].tobytes(), want_v2[i].tobytes())
                    for i, a in seen)
        check("serving replicas: no request failed during the roll, each answered by one "
              "version or the other bit for bit",
              not errors and valid and not any(th.is_alive() for th in threads),
              errors=errors[:3], requests=len(seen))
        check("serving replicas: the roll's drains exit 0 and the versions advance to 2",
              [s["drain_rc"] for s in rolled["steps"]] == [0, 0]
              and len(rolled["versions"]) == 2
              and all(v == {"kmeans": 2} for v in rolled["versions"].values()),
              roll=rolled)
        after = [np.asarray(router.predict("kmeans", p, timeout=60)) for p in payloads[:8]]
        nets = [pool.stats(h.index)["net"] for h in pool.replicas
                if h.state == "up" and h.alive()]
        check("serving replicas: after the roll, answers equal version 2 bit for bit and the "
              "new replicas built nothing after warm-up",
              all(a.tobytes() == b.tobytes() for a, b in zip(after, want_v2))
              and all(n["steady_backend_compiles"] == 0 and n["kernel_builds"] == 0
                      for n in nets))
        replacements = [{"index": h.index, "ready_s": h.ready_s, "start_s": h.ready["start_s"],
                         "warmup_s": h.ready["warmup"]["seconds"]}
                        for h in pool.replicas if h.index >= 2]
        report["replicas"] = {"start_s": start_s, "replicas": replicas,
                              "routed_256_s": routed_s, "roll_s": rolled["seconds"],
                              "roll_steps": rolled["steps"], "roll_requests": len(seen),
                              "replacements": replacements}
        emit({"phase": "serving replicas", **report["replicas"], "nvidia_smi": smi})
        report["autoscale"] = autoscale_phase(pool, router, payloads[:8], want_v2, smi)
    finally:
        if router is not None:
            router.close()
        if pool is not None:
            pool.close()
        server.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return report


class _DelayProxy:
    """A front that answers like the replica behind it, each POST
    ``delay_s`` late: the straggler a hedge routes around."""

    def __init__(self, url: str, delay_s: float):
        import http.client
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from urllib.parse import urlparse

        target = urlparse(url)

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.0"

            def log_message(self, *args):
                pass

            def _forward(self, method, body=None):
                conn = http.client.HTTPConnection(target.hostname, target.port, timeout=60)
                try:
                    conn.request(method, self.path, body=body,
                                 headers={"Content-Type": "application/json"})
                    resp = conn.getresponse()
                    data = resp.read()
                finally:
                    conn.close()
                self.send_response(resp.status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                self._forward("GET")

            def do_POST(self):
                body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                time.sleep(delay_s)
                self._forward("POST", body)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def autoscale_phase(pool, router, payloads, want, smi):
    """The autoscaler and the router's priority classes and hedges over the
    serving path's replicas on this card: a burst scales up one replica and
    idle ticks drain it; a replica killed with SIGKILL is replaced; a bulk
    flood past a bounded queue sheds no latency-class request; a hedge
    against a delayed front wins. Every answer equals the server's bit for
    bit."""
    import numpy as np

    from heat_tpu_torch.serve import ServerOverloadedError
    from heat_tpu_torch.serve.net import AutoscaleController, Router

    def same(got, idx):
        return all(np.asarray(g).tobytes() == want[i % len(want)].tobytes()
                   for g, i in zip(got, idx))

    live = [h for h in pool.replicas if h.state == "up" and h.alive()]
    base = len(live)
    t_phase = time.perf_counter()
    ctrl = AutoscaleController(pool, router, min_replicas=base, max_replicas=base + 1,
                               backlog_high=4.0, backlog_ticks=1, idle_low=0.5, idle_ticks=2,
                               up_cooldown_s=0.0, down_cooldown_s=0.0)
    n_burst = 2048
    futs = [router.submit("kmeans", payloads[i % len(want)]) for i in range(n_burst)]
    t = time.perf_counter()
    up = ctrl.tick()
    up_s = time.perf_counter() - t
    burst = [f.result(180) for f in futs]
    idle = []
    for _ in range(4):
        idle.append(ctrl.tick())
        if idle[-1]["action"] == "scale_down":
            break
    t_drain = time.perf_counter()
    after_down = [h.index for h in pool.replicas if h.state == "up" and h.alive()]
    check("autoscale: a burst scales up one replica, idle ticks drain it, every answer bit "
          "for bit", up["action"] == "scale_up" and idle[-1]["action"] == "scale_down"
          and len(after_down) == base and same(burst, range(n_burst)),
          actions=[up["action"]] + [r["action"] for r in idle],
          per_replica_backlog=up["per_replica_backlog"])
    victim = next(h for h in pool.replicas if h.state == "up" and h.alive())
    victim.proc.kill()
    victim.proc.wait(10)
    t = time.perf_counter()
    rep = ctrl.tick()
    replace_s = time.perf_counter() - t
    answers = [router.predict("kmeans", payloads[i], timeout=60) for i in range(len(want))]
    check("autoscale: a killed replica is replaced and the fleet answers bit for bit",
          [r["old"] for r in rep.get("replaced", [])] == [victim.index]
          and same(answers, range(len(want))), row=rep)

    # priority classes: a bulk flood past a bounded queue
    prio = Router(pool, priorities={"latency": 8.0, "bulk": 1.0}, priority_queue_max=8,
                  workers=2, poll_ms=25.0, request_timeout=60.0)
    try:
        bulk = [prio.submit("kmeans", payloads[i % len(want)], priority="bulk")
                for i in range(400)]
        # fewer latency requests than the bound: a queue full of latency work
        # would shed a latency request by the same rule
        lat = [prio.submit("kmeans", payloads[i % len(want)], priority="latency")
               for i in range(6)]
        lat_got = [f.result(120) for f in lat]
        shed, ok = 0, 0
        for f in bulk:
            try:
                f.result(120)
                ok += 1
            except ServerOverloadedError:
                shed += 1
        classes = prio.stats()["priority"]["classes"]
    finally:
        prio.close()
    check("autoscale: a bulk flood sheds no latency-class request",
          classes["latency"]["shed"] == 0 and same(lat_got, range(6)) and shed > 0 and ok > 0,
          classes=classes, bulk_shed=shed, bulk_ok=ok)

    # hedged retries: the first target delays every answer by 0.5 s
    real = next(h for h in pool.replicas if h.state == "up" and h.alive())
    proxy = _DelayProxy(real.url, 0.5)
    hedge = Router([proxy.url, real.url], hedge=True, hedge_delay_ms=50.0,
                   hedge_max_fraction=1.0, workers=1, poll_ms=1000.0, request_timeout=60.0)
    try:
        t = time.perf_counter()
        got = hedge.predict("kmeans", payloads[0], timeout=60)
        hedge_s = time.perf_counter() - t
        counts = hedge.stats()["router"]
    finally:
        hedge.close()
        proxy.stop()
    check("autoscale: a hedge against a delayed replica wins, bit for bit",
          counts["hedges"] == 1 and counts["hedge_wins"] == 1 and hedge_s < 0.45
          and same([got], [0]), counts={k: counts[k] for k in ("hedges", "hedge_wins")},
          seconds=hedge_s)
    report = {"burst_requests": n_burst, "scale_up_s": up_s, "replace_s": replace_s,
              "drained_after_s": t_drain - t_phase, "phase_s": time.perf_counter() - t_phase,
              "replica_seconds": ctrl.replica_seconds, "counts": ctrl.counts,
              "history": [{k: r[k] for k in ("tick", "action", "per_replica_backlog",
                                             "hot_ticks", "idle_ticks")} for r in ctrl.history],
              "priority": {"bulk_shed": shed, "bulk_ok": ok, "classes": classes},
              "hedge_s": hedge_s, "nvidia_smi": smi}
    emit({"phase": "autoscale", **report})
    return report


# ------------------------------------------------------------------ data and observability

OBS_TURNS = 3  # telemetry on and off, in turns, this many times each
KMEANS_1B = (1 << 24, 64, 64, 10)  # bench.py:423-437: rows, features, k, iterations
TOKENS = (512, 1024)  # the token dataset of the data path (rows of tokens)
DATA_STEPS = (2, 4)  # epochs, steps an epoch
STREAM_ROWS = (4_000_000, 64, 65_536, 500_000)  # rows, columns, batch, window


def observability_path(ht, dev, xm_t, xc_t, xk_t):
    """The array path at bench.py's sizes under ``telemetry.enable(sink)``:
    a span a stage (the cdist kernel's own ``pallas_cdist`` span inside
    its stage), the registry's events exported as a Chrome trace and checked
    (every slice with ``ph``, ``ts``, ``dur``, ``pid`` and ``tid``,
    timestamps not decreasing), ``report.summarize``'s phases, and
    ``memory.watermark()``'s peak against ``torch.cuda.max_memory_allocated``.
    Then the same path's wall with telemetry on and off in turns, as the
    cost of recording; the results with it on equal those with it off, bit
    for bit. Returns the kernels' launches of one recorded run."""
    import torch
    from heat_tpu_torch import telemetry
    from heat_tpu_torch.telemetry import memory, report as treport

    def run():
        with telemetry.span("moments", gshape=list(xm_t.shape)) as sp:
            y = ht.array(xm_t, split=0) * 2 + 1
            mom = (ht.mean(y, axis=0), ht.var(y, axis=0), ht.std(y, axis=0))
            sp.output([m.larray for m in mom])
        with telemetry.span("cdist", gshape=[xc_t.shape[0], xc_t.shape[0]]) as sp:
            xc = ht.array(xc_t, split=0)
            dist = sp.output(ht.spatial.cdist(xc, xc, quadratic_expansion=True))
        with telemetry.span("kmeans", gshape=list(xk_t.shape), k=64) as sp:
            km = ht.cluster.KMeans(n_clusters=64, init="random", max_iter=50, tol=0.0,
                                   random_state=1).fit(ht.array(xk_t, split=0))
            sp.output(km.cluster_centers_)
        torch.cuda.synchronize()
        return mom, dist, km

    tmp = tempfile.mkdtemp(prefix="heat_tpu_torch_obs_")
    sink = os.path.join(tmp, "events.jsonl")
    reg = telemetry.get_registry()
    reg.clear()
    run()  # warm, not recorded
    torch.cuda.reset_peak_memory_stats(dev)
    ht.reset_launch_counts()
    telemetry.enable(sink)
    t = time.perf_counter()
    mom_on, dist_on, km_on = run()
    first_wall = (time.perf_counter() - t) * 1e3
    launches = dict(ht.launch_counts())
    t = time.perf_counter()
    snap = memory.watermark("array path")
    watermark_ms = (time.perf_counter() - t) * 1e3
    peak_alloc = torch.cuda.max_memory_allocated(dev)
    telemetry.disable()
    trace_path = telemetry.export_trace(os.path.join(tmp, "trace.json"))
    summary = treport.summarize()
    replay = treport.summarize(treport.load_events(sink), dict(reg.watermarks))
    with open(trace_path) as f:
        doc = json.load(f)
    rows = [e for e in doc["traceEvents"] if e["ph"] != "M"]
    complete = all({"ph", "ts", "pid", "tid"} <= set(e) and (e["ph"] != "X" or "dur" in e)
                   for e in doc["traceEvents"])
    ts = [e["ts"] for e in rows]
    spans = {e["name"] for e in rows if e["ph"] == "X"}
    mom_off, dist_off, km_off = run()
    same = (all(torch.equal(a.larray, b.larray) for a, b in zip(mom_on, mom_off))
            and torch.equal(dist_on.larray, dist_off.larray)
            and torch.equal(km_on.cluster_centers_.larray, km_off.cluster_centers_.larray))
    del mom_on, dist_on, km_on, mom_off, dist_off, km_off
    walls = {"on": [], "off": []}
    for _ in range(OBS_TURNS):
        for mode in ("on", "off"):
            if mode == "on":
                reg.clear()
                telemetry.enable()
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = run()
            walls[mode].append((time.perf_counter() - t) * 1e3)
            telemetry.disable()
            del out
    reg.clear()
    on, off = sorted(walls["on"])[OBS_TURNS // 2], sorted(walls["off"])[OBS_TURNS // 2]
    stats = snap.get("device_stats", {}).get("cuda:0", {})
    emit({"phase": "observability path", "first_recorded_wall_ms": first_wall,
          "launches": launches, "phases": summary["phases"], "events": summary["events"],
          "trace_slices": len(rows), "span_names": sorted(spans),
          "watermark": {"live_bytes_total": snap["total"], "arrays": snap["arrays"],
                        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
                        "torch_max_memory_allocated": peak_alloc, "probe_ms": watermark_ms},
          "wall_ms": walls, "median_wall_ms": {"on": on, "off": off},
          "recording_overhead": (on - off) / off})
    check("observability: the trace is well formed",
          complete and ts == sorted(ts) and ts and ts[0] >= 0
          and {"moments", "cdist", "kmeans", "pallas_cdist"} <= spans,
          slices=len(rows), spans=sorted(spans))
    check("observability: the summary has the path's phases, live and replayed",
          set(summary["phases"]) == {"moments", "cdist", "kmeans"}
          and summary["phases"] == replay["phases"], phases=summary["phases"])
    check("observability: the watermark's peak is the allocator's",
          stats.get("peak_bytes_in_use") == peak_alloc and snap["total"] > 0,
          peak_bytes_in_use=stats.get("peak_bytes_in_use"), max_memory_allocated=peak_alloc)
    check("observability: recorded results equal unrecorded, bit for bit", same)
    check("observability: the recorded path launched K2, K3, K4 and threefry",
          all(launches[k] > 0 for k in ARRAY_PATH), launches=launches)
    return {k: launches[k] for k in ARRAY_PATH}


def kmeans_1b_row(ht, dev, time_ms):
    """bench.py's kmeans_1b row (bench.py:423-437), never run on the card
    before: 2^24 x 64 f32 (4.3 GB) from ht.random, KMeans(64, init="random",
    max_iter=10, tol=0, random_state=1). The fit's wall, K4's time a pass
    against its bound (one read of the data), the launches; the centers
    after the fit against a float64 Lloyd on the card from the same initial
    centers over the same data."""
    import torch
    from heat_tpu_torch.cluster.cuda_lloyd import lloyd_update, lloyd_update_plain

    n, d, k, iters = KMEANS_1B
    ht.random.seed(0)
    x = ht.random.randn(n, d, split=0)
    torch.cuda.synchronize()
    est = ht.cluster.KMeans(n_clusters=k, init="random", max_iter=iters, tol=0.0, random_state=1)
    c0 = est._initialize_cluster_centers(x).clone()
    ht.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    km = ht.cluster.KMeans(n_clusters=k, init="random", max_iter=iters, tol=0.0,
                           random_state=1).fit(x)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    launches = {name: ht.launch_counts()[name] for name in ("lloyd", "random")}
    xt = x.larray
    pass_ms = time_ms(lambda: lloyd_update(xt, c0), 5)
    s_k, n_k = lloyd_update(xt, c0)
    s_p, n_p = lloyd_update_plain(xt, c0)
    max_abs = (s_k - s_p).abs().max().item()
    bound_ms, bound_by = bound(n * d * 4 + 2 * k * d * 4 + k * 4, 3 * 2 * n * k * d,
                               TF32_FLOPS_PER_S)
    # the float64 Lloyd from the same centers, in row blocks of 2^22
    c = c0.double()
    for _ in range(iters):
        sums = torch.zeros((k, d), dtype=torch.float64, device=dev)
        counts = torch.zeros(k, dtype=torch.float64, device=dev)
        for lo in range(0, n, 1 << 22):
            xb = xt[lo:lo + (1 << 22)].double()
            lab = ((c * c).sum(1)[None, :] - 2.0 * (xb @ c.T)).argmin(1)
            sums.index_add_(0, lab, xb)
            counts += torch.bincount(lab, minlength=k).double()
            del xb, lab
        c = torch.where(counts[:, None] > 0, sums / counts.clamp_min(1)[:, None], c)
    got = km.cluster_centers_.larray.double()
    err = (got - c).abs().max().item()
    scale = c.abs().max().item()
    emit({"phase": "kmeans_1b", "shape": [n, d], "k": k, "iterations": km.n_iter_,
          "fit_wall_s": fit_s, "launches": launches, "k4_pass_ms": pass_ms,
          "k4_pass_bound_ms": bound_ms, "k4_pass_bound_by": bound_by,
          "k4_share_of_bound": bound_ms / pass_ms, "k4_vs_plain_max_abs_err": max_abs,
          "k4_vs_plain_count_diff": int((n_k - n_p).abs().sum().item()),
          "centers_max_abs_err_vs_float64": err, "centers_max_abs": scale})
    # near-tie rows (two centers within the f32 error of a score) may take
    # either label in f32 and float64 and move a center by |x| / count
    # (~1e-5 at 262,144 rows a center); 1e-3 of the centers' scale covers a
    # hundred such moves a center over the ten passes
    check("kmeans_1b: centers vs a float64 Lloyd from the same start",
          km.n_iter_ == iters and err <= 1e-3 * scale,
          max_abs_err=err, centers_scale=scale, tolerance="1e-3 of max |center|")
    check("kmeans_1b: K4 launched once a pass", launches["lloyd"] == iters, launches=launches)
    del x, xt, km, est, c0, s_k, n_k, s_p, n_p
    return {"launches": launches, "kernel_ms": pass_ms, "bound_ms": bound_ms, "fit_s": fit_s}


def data_path(ht, dev, cfg):
    """The data modules on the card: the bundled iris through KMeans(3) (K4)
    and GaussianNB, each equal to the same calls on the CPU; the Parter
    matrix's singular values at pi; bench.py's LM at full width trained
    through nn.DataParallel on batches of a token Dataset from DataLoader
    (two epochs of four steps, ishuffle off and on: the second epoch's order
    the threefry permutation, K6/K7a/K7b launches a step against the layer
    count, each step's wall); a 4,000,000 x 64 f32 file streamed by
    PartialDataset batches of 65,536 rows (rows/s, the loader thread's
    reading and waiting against the card's time, column sums against numpy
    in float64). Returns the kernels' launches of the path."""
    import numpy as np
    import torch
    from heat_tpu_torch.core import _threefry

    total = {}

    def add(counts):
        for name, v in counts.items():
            total[name] = total.get(name, 0) + v

    # ------------------------------------------------------------ iris
    ht.reset_launch_counts()
    X, y = ht.datasets.load_iris()
    Xc, yc = ht.datasets.load_iris(device="cpu")
    init = X.numpy()[[0, 50, 100]]
    km = ht.cluster.KMeans(n_clusters=3, init=ht.array(init), max_iter=50).fit(X)
    kmc = ht.cluster.KMeans(n_clusters=3, init=ht.array(init, device="cpu"), max_iter=50).fit(Xc)
    Xtr, Xte, ytr, yte = ht.datasets.load_iris_split()
    acc = float((ht.naive_bayes.GaussianNB().fit(Xtr, ytr).predict(Xte).numpy()
                 == yte.numpy()).mean())
    Ctr, Cte, ctr, cte = ht.datasets.load_iris_split(device="cpu")
    acc_cpu = float((ht.naive_bayes.GaussianNB().fit(Ctr, ctr).predict(Cte).numpy()
                     == cte.numpy()).mean())
    iris_launches = dict(ht.launch_counts())
    add(iris_launches)
    same_labels = np.array_equal(km.labels_.numpy(), kmc.labels_.numpy())
    c_err = float(np.abs(km.cluster_centers_.numpy() - kmc.cluster_centers_.numpy()).max())
    emit({"phase": "data path: iris", "card": X.larray.is_cuda, "kmeans_n_iter": km.n_iter_,
          "centers_max_abs_err_vs_cpu": c_err, "gaussian_nb_accuracy": acc,
          "gaussian_nb_accuracy_cpu": acc_cpu, "launches": iris_launches})
    check("data path: iris KMeans on the card equals the CPU's", X.larray.is_cuda and same_labels
          and c_err <= 1e-5 and iris_launches["lloyd"] > 0, centers_max_abs_err=c_err,
          tolerance=1e-5)
    check("data path: iris GaussianNB accuracy equals the CPU's", acc == acc_cpu and acc > 0.9,
          accuracy=acc, cpu=acc_cpu)

    # ---------------------------------------------------------- Parter
    t = time.perf_counter()
    P = ht.utils.data.matrixgallery.parter(4096)
    s = ht.linalg.svd(P, compute_uv=False)
    sv = s.larray.double()
    torch.cuda.synchronize()
    svd_s = time.perf_counter() - t
    sv64 = torch.linalg.svdvals(P.larray.double())
    near = int(((sv - np.pi).abs() < 1e-2).sum())
    rel = ((sv.sort(descending=True).values - sv64) / sv64).abs().max().item()
    emit({"phase": "data path: parter", "n": 4096, "svd_s": svd_s, "near_pi": near,
          "largest": sv.max().item(), "rel_err_vs_float64": rel})
    check("data path: Parter's singular values cluster at pi", near >= 4000 and rel <= 1e-4,
          near_pi=near, rel_err=rel, tolerance={"near": "|s - pi| < 1e-2 for >= 4000 of 4096",
                                                "rel": 1e-4})
    del P, s, sv, sv64

    # ------------------------------------------------ the LM through DataLoader
    vocab, layers = cfg["vocab_size"], cfg["num_layers"]
    tokens = np.random.default_rng(3).integers(0, vocab, TOKENS).astype(np.int64)
    perm = _threefry.permutation(_threefry.split(_threefry.prng_key(0))[1], TOKENS[0]).numpy()
    per_step = {"flash_fwd": 2 * layers, "flash_bwd_dq": layers, "flash_bwd_dkv": layers}
    lm_loss = _lm_loss(vocab)
    epochs, steps = DATA_STEPS
    runs = {}
    for ishuffle in (False, True):
        model = ht.nn.TransformerLM(**dict(cfg, attn_impl="flash", dtype=torch.bfloat16,
                                           remat=True, flash_bwd_impl="two_pass"),
                                    generator=torch.Generator(device=dev).manual_seed(0))
        opt = torch.optim.AdamW(model.parameters(), lr=1e-4)
        dp = ht.nn.DataParallel(model, optimizer=opt, blocking_parameter_updates=True)
        step = dp.make_train_step(lm_loss)
        data = ht.utils.data.Dataset(ht.array(tokens, split=0), ishuffle=ishuffle)
        loader = ht.utils.data.DataLoader(data, batch_size=8, shuffle=True)
        walls, losses, counts, order = [], [], [], []
        for epoch in range(epochs):
            for i, (xb,) in enumerate(loader):
                if i == steps:
                    break
                (tb,) = dp.shard_batch(xb)
                order.append(tb[:, :4].cpu().numpy())
                ht.reset_launch_counts()
                torch.cuda.synchronize()
                t = time.perf_counter()
                _, _, loss = step(model, opt, tb)
                losses.append(loss.item())
                walls.append((time.perf_counter() - t) * 1e3)
                c = {name: ht.launch_counts()[name] for name in per_step}
                counts.append(c)
                add(c)
        rows = np.concatenate(order)
        want = np.concatenate([tokens[:8 * steps, :4], tokens[perm[:8 * steps], :4]])
        runs["ishuffle" if ishuffle else "blocking"] = {
            "step_wall_ms": walls, "losses": losses, "launches_per_step": counts,
            "order_is_threefry": bool(np.array_equal(rows, want))}
        del model, opt, dp, step, data, loader
    emit({"phase": "data path: LM through DataLoader", "tokens": list(TOKENS), "batch": 8,
          "epochs": epochs, "steps_an_epoch": steps, "runs": runs})
    for name, r in runs.items():
        check(f"data path: LM {name}: the second epoch's order is the threefry permutation",
              r["order_is_threefry"])
        check(f"data path: LM {name}: launches a step match the layer count",
              all(c == per_step for c in r["launches_per_step"]) and
              all(np.isfinite(r["losses"])), launches=r["launches_per_step"], want=per_step)

    # ------------------------------------------------------ the stream
    rows_n, cols, bs, win = STREAM_ROWS
    tmp = tempfile.mkdtemp(prefix="heat_tpu_torch_stream_")
    rng = np.random.default_rng(4)
    try:
        import h5py  # noqa: F401
        have_h5 = True
    except ImportError:
        have_h5 = False
    t = time.perf_counter()
    if have_h5:
        import h5py

        path = os.path.join(tmp, "data.h5")
        with h5py.File(path, "w") as f:
            dset = f.create_dataset("data", (rows_n, cols), dtype="f4")
            for lo in range(0, rows_n, 1_000_000):
                dset[lo:lo + 1_000_000] = rng.standard_normal((1_000_000, cols), np.float32)
        ds = ht.utils.data.PartialH5Dataset(path, initial_load=win, load_length=win)
    else:
        path = os.path.join(tmp, "data.npy")
        mm = np.lib.format.open_memmap(path, mode="w+", dtype=np.float32, shape=(rows_n, cols))
        for lo in range(0, rows_n, 1_000_000):
            mm[lo:lo + 1_000_000] = rng.standard_normal((1_000_000, cols), np.float32)
        mm.flush()
        del mm
        ds = ht.utils.data.PartialDataset({"data": np.load(path, mmap_mode="r")},
                                          initial_load=win, load_length=win)
    write_s = time.perf_counter() - t
    sums = torch.zeros(cols, dtype=torch.float64, device=dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    card_ms, n_batches = 0.0, 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    for (b,) in ht.utils.data.PartialDataLoaderIter(ds, bs, shuffle=False):
        start.record()
        sums += b.larray.double().sum(0)
        end.record()
        end.synchronize()
        card_ms += start.elapsed_time(end)
        n_batches += 1
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t
    covered = n_batches * bs
    src = np.load(path, mmap_mode="r") if not have_h5 else None
    if have_h5:
        import h5py

        with h5py.File(path, "r") as f:
            want = sum(f["data"][lo:min(lo + 1_000_000, covered)].astype(np.float64).sum(0)
                       for lo in range(0, covered, 1_000_000))
    else:
        want = sum(np.asarray(src[lo:min(lo + 1_000_000, covered)], np.float64).sum(0)
                   for lo in range(0, covered, 1_000_000))
    got = sums.cpu().numpy()
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    if have_h5:
        ds.close()
    del src
    stats = dict(ds.stats)
    emit({"phase": "data path: partial dataset", "format": "hdf5" if have_h5 else "npy memmap",
          "note": None if have_h5 else "h5py is not installed here: PartialDataset over a "
                                       ".npy memory map (PartialH5Dataset opens the file with "
                                       "h5py and streams the same way)",
          "rows": rows_n, "columns": cols, "batch": bs, "window": win, "write_s": write_s,
          "batches": n_batches, "wall_s": wall_s, "rows_per_s": covered / wall_s,
          "loader_read_s": stats["read_seconds"], "consumer_wait_s": stats["wait_seconds"],
          "card_ms": card_ms, "colsum_rel_err_vs_numpy_f64": rel})
    check("data path: stream column sums vs numpy in float64",
          n_batches == rows_n // bs and rel <= 1e-5, rel_err=rel, tolerance=1e-5)
    import shutil

    shutil.rmtree(tmp, ignore_errors=True)
    return total


# resplit of one array under the three plans on the ranks of a world: the
# same bits, each chunk stage's audited bytes against its plan, the peak
# temporaries under the budget that forces the chunked plan (rehearse on
# the CPU: exec this with ht, then relayout_plans(ht, t) on four gloo ranks)
_RELAYOUT_RANKS = r"""
def relayout_plans(ht, t):
    import hashlib
    import torch
    from heat_tpu_torch import _knobs
    from heat_tpu_torch.core import relayout_planner as rp
    from heat_tpu_torch.resilience import memory_guard
    from heat_tpu_torch.telemetry import collectives as costs, hlo

    x = ht.array(t, split=0)
    cuda = x.larray.is_cuda
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    comm = x.comm
    res = {"rank": comm.rank, "world": comm.size, "shape": list(t.shape)}
    digests = {}
    for plan in ("monolithic", "alltoall", "chunked"):
        env = {"HEAT_TPU_RELAYOUT_PLAN": plan}
        if plan == "chunked":
            # a budget that the monolithic relayout does not fit: live bytes
            # plus 600 MiB against its analytic need of 768 MiB a rank
            sync()
            live = memory_guard.live_bytes()
            need = rp.monolithic_need(t.shape, 4, 0, 1, comm.size)
            env = {"HEAT_TPU_RELAYOUT_PLAN": "auto",
                   "HEAT_TPU_HBM_BUDGET": str(live + min(need - 1, 600 * 2 ** 20))}
        with _knobs.overlay(env):
            p = rp.maybe_plan(t.shape, 4, 0, 1, comm) or rp.plan(t.shape, 4, 0, 1, comm)
            x.resplit(1)  # warm-up
            sync()
            if cuda:
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            y = x.resplit(1)
            sync()
            ms = (time.perf_counter() - t0) * 1e3
            peak = (torch.cuda.max_memory_allocated() - base) if cuda else -1
            hlo.clear()
            x.resplit(1, audit=True)
            sync()
            recs = hlo.recent()
            budget = memory_guard.budget_bytes()
        # the stages of the plan the resplit ran (its own reading of live
        # bytes): each record's block, its cost, its audited bytes, no drift
        stages = [[r.fields["lo"], r.fields["hi"],
                   int(costs.relayout_chunk_cost(t.shape, 4, 0, 1, r.fields["hi"] - r.fields["lo"],
                                                 comm.size).bytes),
                   int(r.audit.total_wire()), bool(r.report.ok)]
                  for r in recs if r.site == "relayout_stage"] if p.kind == "chunked" else []
        if p.kind == "chunked":  # each stage's temporaries against the model's
            res["stage_memory"] = rp.plan_memory(p, x.larray, comm)
        digests[plan] = hashlib.sha256(y.larray.cpu().numpy().tobytes()).hexdigest()
        res[plan] = {"kind": p.kind, "ms": ms, "peak_bytes_above_live": peak,
                     "budget": budget, "live_before": base if cuda else None,
                     "model_temp_bytes": p.temp_bytes, "predicted_wire_bytes": p.predicted_bytes,
                     "audited_wire_bytes": sum(int(r.audit.total_wire()) for r in recs),
                     "stages": stages}
        del y
    res["digests"] = digests
    res["bench_field"] = rp.bench_field((4096, 64), comm=comm)
    return res


def relayout_tune(ht, t, trials=3):
    # the autotuner over HEAT_TPU_RELAYOUT_PLAN with relayout_cost_fn: every
    # rank measures the same pruned lattice in the same order (each trial a
    # collective), the ranks agree on one pick and each adopts it (no
    # database: nothing stored)
    from heat_tpu_torch import _knobs, autotune
    from heat_tpu_torch.autotune import cost

    x = ht.array(t, split=0)
    comm = x.comm
    fn = cost.relayout_cost_fn(t.shape, 4, 0, 1, comm.size)
    res = autotune.tune("resplit", lambda: ht.resplit(x, 1).larray,
                        signature=("resplit", tuple(t.shape), 0, 1),
                        search=["HEAT_TPU_RELAYOUT_PLAN"], cost_fn=fn, trials_per_config=trials,
                        persist=False)
    adopted = _knobs.raw("HEAT_TPU_RELAYOUT_PLAN")
    autotune.reset()
    rec = res.record
    return {"rank": comm.rank, "pick": res.config, "adopted": adopted,
            "validation": rec["validation"],
            "configs_measured": rec["configs_measured"], "baseline_median_s": rec["baseline_wall"],
            "pick_median_s": rec["tuned_wall"],
            "predicted_wire_bytes": {p: fn({"HEAT_TPU_RELAYOUT_PLAN": p})
                                     for p in ("auto", "monolithic", "chunked", "alltoall")}}
"""


_AUDIT_WORKER = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.cuda.set_device(rank)
dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world)
import heat_tpu_torch as ht
from heat_tpu_torch.telemetry import hlo
ht.use_device("gpu")
exec(_RELAYOUT_RANKS)
rng = np.random.default_rng(0)
x = rng.standard_normal((16384, 128)).astype(np.float32)
t = rng.standard_normal((1_000_000, 256)).astype(np.float32)
out = {}
for name, call in (
        ("ring_cdist", lambda: ht.spatial.cdist(ht.array(x, split=0), ht.array(x, split=0),
                                                ring=True, audit=True)),
        ("tsqr", lambda: ht.linalg.qr(ht.array(t, split=0), audit=True)),
        ("cholqr_gram_ring", lambda: ht.linalg.qr(ht.array(t[:65536], split=1), audit=True)),
        ("resplit", lambda: ht.resplit(ht.array(t, split=0), 1, audit=True))):
    hlo.clear()
    call()
    torch.cuda.synchronize()
    out[name] = [r.report.summary() for r in hlo.recent()]
print("AUDIT " + json.dumps({"rank": rank, "reports": out}), flush=True)
print("RELAYOUT " + json.dumps(relayout_plans(ht, t)), flush=True)
print("TUNE " + json.dumps(relayout_tune(ht, t)), flush=True)
dist.barrier()
dist.destroy_process_group()
"""


def collective_audit_phase():
    """On four or more cards: the ring cdist, qr (TSQR and CholeskyQR2) and
    resplit with ``audit=True`` on four NCCL ranks (one process a card),
    each DriftReport printed. With fewer cards the phase says so."""
    import socket
    import torch

    world = torch.cuda.device_count()
    if world < 4:
        emit({"phase": "collective audit", "run": False,
              "why": f"needs four cards, this machine has {world}"})
        return
    world = 4
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
    code = f"_RELAYOUT_RANKS = {_RELAYOUT_RANKS!r}\nimport time\n" + _AUDIT_WORKER
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(world),
                               str(port)], cwd=here, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    reports, relayouts, tunes, ok = [], [], [], True
    for p in procs:
        try:
            log = p.communicate(timeout=600)[0]
        finally:
            p.kill()
        ok = ok and p.returncode == 0
        lines = [ln for ln in log.splitlines() if ln.startswith("AUDIT ")]
        if lines:
            reports.append(json.loads(lines[-1][6:]))
        else:
            emit({"phase": "collective audit", "rank_log_tail": log[-2000:]})
        relayouts += [json.loads(ln[9:]) for ln in log.splitlines() if ln.startswith("RELAYOUT ")]
        tunes += [json.loads(ln[5:]) for ln in log.splitlines() if ln.startswith("TUNE ")]
    for r in reports:
        emit({"phase": "collective audit", "world": world, **r})
    drift = [(r["rank"], site, rep["drifts"]) for r in reports for site, reps in r["reports"].items()
             for rep in reps if not rep["ok"]]
    check("collective audit: four NCCL ranks, no drift", ok and len(reports) == world
          and not drift, drift=drift)
    check_relayout_ranks(relayouts, world)
    check_relayout_tune(tunes, world)


def check_relayout_tune(tunes, world):
    """The four ranks' tunes over HEAT_TPU_RELAYOUT_PLAN (``relayout_tune``):
    every plan measured and validated bit for bit, the plans priced apart by
    the cost model, and one pick, adopted by every rank, with the same
    agreed medians (the slowest rank's), no slower than the default."""
    for r in tunes:
        emit({"phase": "autotune resplit four cards", **r})
    ok = len(tunes) == world and all(
        r["validation"] == "digest" and r["configs_measured"] == 4
        and r["pick_median_s"] <= r["baseline_median_s"]
        and r["adopted"] == r["pick"]["HEAT_TPU_RELAYOUT_PLAN"]
        and len(set(r["predicted_wire_bytes"].values())) > 1 for r in tunes)
    one = len({json.dumps([r["pick"], r["baseline_median_s"], r["pick_median_s"]])
               for r in tunes}) == 1
    check("autotune resplit: four ranks measured every plan, same bits, and adopted one pick "
          "no slower than the default", ok and one, ranks=len(tunes),
          picks=[r["adopted"] for r in tunes])


def check_relayout_ranks(relayouts, world):
    """The four ranks' relayout results (``_RELAYOUT_RANKS``): the same bits
    under every plan, ``auto`` chose chunked under its budget, each stage's
    audited bytes equal to its plan, the peak temporaries under the budget
    and each stage's within the model's (-1 on the CPU: not measured), and
    ``bench_field``'s audited bytes equal to its predicted ones."""
    for r in relayouts:
        emit({"phase": "relayout four cards", **r})
    ok = len(relayouts) == world
    for r in relayouts:
        c = r.get("chunked", {})
        ok = ok and len(set(r["digests"].values())) == 1 and c.get("kind") == "chunked" \
            and c["stages"] and all(s[2] == s[3] and s[4] for s in c["stages"]) \
            and (c["peak_bytes_above_live"] < 0
                 or c["live_before"] + c["peak_bytes_above_live"] <= c["budget"]) \
            and r["stage_memory"]["peak_temp_bytes"] <= r["stage_memory"]["model_temp_bytes"] \
            and r["bench_field"]["audited_wire_bytes"] == r["bench_field"]["predicted_wire_bytes"]
    check("relayout: four ranks give the same bits under monolithic, alltoall and chunked; "
          "the chunked stages' audited bytes equal the plan's, peaks under the budget and "
          "the model", ok,
          ranks=len(relayouts))


_SCALE_OUT_WORKER = r"""
import json, os, sys, time
import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
rank, world, port, backend, size = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
                                    sys.argv[5])
if backend == "nccl":
    torch.cuda.set_device(rank)
from datetime import timedelta
# a collective that waits longer than this fails the rank instead of hanging it
dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                        world_size=world, timeout=timedelta(seconds=300))
import heat_tpu_torch as ht
from heat_tpu_torch.core import collective_prec as cp
from heat_tpu_torch.core.communication import TorchCommunication
from heat_tpu_torch.telemetry import collectives as costs, hlo
cuda = backend == "nccl"
dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
ht.use_device("gpu" if cuda else "cpu")
if size == "full":
    cfg = dict(vocab_size=32768, d_model=1024, num_heads=16, num_layers=12, max_len=1024,
               mlp_ratio=4.0)
    batch, reduce_n = (8, 1024), 4_194_304
else:
    cfg = dict(vocab_size=64, d_model=32, num_heads=4, num_layers=4, max_len=16, mlp_ratio=4.0)
    batch, reduce_n = (8, 16), 4096
STEPS, M = 3, 8
vocab = cfg["vocab_size"]
train_cfg = dict(cfg, attn_impl="flash", dtype=torch.bfloat16, flash_bwd_impl="two_pass",
                 device=dev)
# a world of one on every rank, for the references
solo = TorchCommunication([dist.new_group([r]) for r in range(world)][rank])
comm = ht.get_comm()
tokens = torch.from_numpy(np.random.default_rng(3).integers(0, vocab, batch)).to(dev)


def sync():
    if cuda:
        torch.cuda.synchronize()


def ce(logits, t):
    return F.cross_entropy(logits[:, :-1].float().reshape(-1, vocab), t[:, 1:].reshape(-1))


def adamw(params):
    return torch.optim.AdamW(params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def fresh(remat=False):
    return ht.nn.TransformerLM(**train_cfg, remat=remat,
                               generator=torch.Generator(device=dev).manual_seed(0))


def steps(one):
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    out = []
    for _ in range(STEPS):
        sync()
        t = time.perf_counter()
        loss = float(one())
        sync()
        out.append({"loss": loss, "wall_ms": (time.perf_counter() - t) * 1e3})
    if cuda:  # the run's peak device memory, in the last row
        out[-1]["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


def opt_bytes(opt):
    return sum(v.numel() * v.element_size() for st in opt.state.values() for v in st.values()
               if torch.is_tensor(v))


def audit(site, fn, predicted):
    _, rec = hlo.audit_call(site, fn, predicted=predicted)
    return rec.report.summary()


def lm_params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def stage_params(logical):  # FSDP's logical stages under the LM's names
    out = {}
    for k, stage in enumerate(logical):
        prefix = f"blocks.{k - 1}." if 0 < k < len(logical) - 1 else ""
        out.update({prefix + n: torch.as_tensor(v).to(dev) for n, v in stage.items()})
    return out


def against_one(got):
    # the parameters after the steps against the world of one's, as the
    # one-card phase holds its runs
    from chip_smoke import _update_error

    rel, worst, worst_name, bitwise = _update_error(got, one_params, init)
    return {"update_rel_rms": rel, "worst_tensor_rel_rms": worst, "worst_tensor": worst_name,
            "bit_identical": bitwise}


res = {}
# the world-of-one DataParallel reference, and its bytes
model = fresh(True)
init = lm_params(model)
opt = adamw(model.parameters())
dp = ht.nn.DataParallel(model, comm=solo, optimizer=opt, blocking_parameter_updates=True)
step = dp.make_train_step(lambda m, t: ce(m(t), t))
res["one"] = steps(lambda: step(model, opt, tokens)[2])
one_params = lm_params(model)
res["replicated_bytes"] = [sum(p.numel() * 4 for p in model.parameters()), opt_bytes(opt)]
del model, opt, dp, step

# FSDP over the stages, p = 4
os.environ["HEAT_TPU_FSDP"] = "1"
model = fresh()
fsdp = ht.nn.FSDP(model.stages(), optimizer=adamw, prefetch=1)
params = fsdp.shard_params(fsdp.init())
state = fsdp.init_opt_state(params)
fstep = fsdp.make_train_step(ce)
(xb,) = fsdp.shard_batch(tokens)
gathers = costs.CollectiveCost("all-gather", sum(
    costs.fsdp_gather_cost(lf.chunk, 4, 1, world).bytes for lf in fsdp._plan.leaves
    if lf.sharded))
with torch.no_grad():
    res["fsdp_forward_audit"] = audit("fsdp.forward", lambda: fsdp(params, tokens), gathers)
box = [params, state]


def fsdp_one():
    box[0], box[1], loss = fstep(box[0], box[1], xb, xb)
    return loss


res["fsdp"] = steps(fsdp_one)
res["fsdp_bytes"] = [fsdp.param_bytes_per_device(box[0]), opt_bytes(box[1])]
res["fsdp_vs_one"] = against_one(stage_params(fsdp.unshard_params(box[0])))
os.environ["HEAT_TPU_FSDP"] = "0"
del model, fsdp, params, state, box

# ZeRO, p = 4
model = fresh(True)
zero = ht.optim.ZeroOptimizer(adamw)
zstate = zero.init(model)
zstep = zero.make_train_step(lambda m, t: ce(m(t), t))
(zb,) = zero.shard_batch(tokens)
res["zero"] = steps(lambda: zstep(model, zstate, zb)[2])
res["zero_vs_one"] = against_one(lm_params(model))  # before the audited fourth step
chunks = [s.numel() for s in zero.shards]
predicted = costs.CollectiveCost("all-reduce+reduce-scatter+all-gather", 2 * 4 * (world - 1) + sum(
    costs.reduce_scatter_cost(world * c, 4, world).bytes + world * c * 4 * (world - 1)
    for c in chunks))
res["zero_step_audit"] = audit("zero.step", lambda: zstep(model, zstate, zb), predicted)
res["zero_bytes"] = [sum(p.numel() * 4 for p in model.parameters()), zero.state_bytes_per_device()]
del model, zero, zstate, zstep

# the pipeline over the blocks: S = 4, then S = 2 x local 2 (tiered)
base = fresh()
embed, head = base.stages()[0], base.stages()[-1]
for p in list(embed.parameters()) + list(head.parameters()):
    p.requires_grad_(False)
with torch.no_grad():
    x = embed(tokens)
layers = [{n: p.detach().clone() for n, p in b.named_parameters()} for b in base.blocks]


def pipe_loss(h, t):
    return ce(head(h), t)


def pipeline(schedule, pcomm, n_stages, name, audit_step=False):
    def make():
        template = ht.nn.TransformerBlock(cfg["num_heads"], cfg["mlp_ratio"], "flash",
                                          dtype=torch.bfloat16, flash_bwd_impl="two_pass",
                                          d_model=cfg["d_model"], device=dev)
        pipe = ht.nn.Pipeline(template, len(layers), comm=pcomm, optimizer=adamw,
                              loss_fn=pipe_loss, n_stages=n_stages, n_microbatches=M,
                              schedule=schedule, prefetch=1)
        params = pipe.shard_params(layers)
        return pipe, [params, pipe.init_opt_state(params)], pipe.make_train_step()

    pipe, box, pstep = make()

    def one():
        box[0], box[1], loss = pstep(box[0], box[1], x, tokens)
        return loss

    res[name] = steps(one)
    table = pipe._table(True)
    res[name + "_table"] = {"ticks": table.n_ticks, "steady_bubble_ticks":
                            table.steady_bubble_ticks(), "stash_depth": table.stash_depth()}
    res[name + "_bytes"] = pipe.param_bytes_per_device()
    logical = pipe.unshard_params(box[0])
    if audit_step:  # one more step of a fresh pipeline, recorded
        _, fresh_box, fresh_step = make()
        mb = x[: batch[0] // M]
        predicted = costs.CollectiveCost(
            "ppermute-ring+all-reduce",
            2 * (table.n_ticks - 1) * costs.pipeline_hop_cost(
                1, mb.numel(), mb.element_size(), world, stride=1).bytes + 2 * 4 * (world - 1))
        res[name + "_audit"] = audit("pipeline.step",
                                     lambda: fresh_step(fresh_box[0], fresh_box[1], x, tokens),
                                     predicted)
    return [v for layer in logical for v in layer.values()]


want = pipeline("gpipe", solo, 1, "pipe_one")
got = {s: pipeline(s, comm, 4, f"pipe4_{s}", audit_step=(s == "gpipe")) for s in
       ("gpipe", "1f1b")}
os.environ["HEAT_TPU_TOPOLOGY"], os.environ["HEAT_TPU_HIERARCHICAL"] = "2x2", "1"
got["tiered"] = pipeline("gpipe", comm, None, "pipe22")
res["pipe_bit_identical"] = {k: all(np.array_equal(a, b) for a, b in zip(v, want))
                             for k, v in got.items()}
res["pipe_1f1b_is_gpipe"] = all(np.array_equal(a, b) for a, b in zip(got["1f1b"], got["gpipe"]))
res["pipe_max_abs_vs_one"] = {k: max(float(np.abs(a - b).max()) for a, b in zip(v, want))
                              for k, v in got.items()}
os.environ["HEAT_TPU_HIERARCHICAL"] = "0"
del base, embed, head, x

# a flat and a tiered all-reduce of reduce_n f32 under every wire
payload = torch.randn(reduce_n, generator=torch.Generator(device=dev).manual_seed(rank),
                      device=dev)
exact = comm.allreduce(payload.clone())
amax = float(comm.allreduce(payload.abs().max().reshape(1).clone(), op="max")[0])
res["allreduce"] = {}
for tiered in (False, True):
    os.environ["HEAT_TPU_HIERARCHICAL"] = "1" if tiered else "0"
    for wire in ("off", "bf16", "int8", "blockwise"):
        predicted = (costs.hierarchical_allreduce_cost(reduce_n, 4, 2, 2, wire) if tiered
                     else costs.allreduce_cost(reduce_n, 4, world, wire))
        report = audit("allreduce", lambda: comm.allreduce(payload.clone(), precision=wire),
                       predicted)
        out = comm.allreduce(payload.clone(), precision=wire)
        for _ in range(2):
            comm.allreduce(payload.clone(), precision=wire)
        sync()
        t = time.perf_counter()
        for _ in range(10):
            comm.allreduce(payload.clone(), precision=wire)
        sync()
        res["allreduce"][("tiered " if tiered else "flat ") + wire] = {
            "ms": (time.perf_counter() - t) * 1e2, "audit": report,
            "max_abs_err": float((out - exact).abs().max()),
            # the wire's bound at p + 1 hops, plus 4 ulp of the largest sum
            # for the order the tiers add in
            "bound": cp.quant_error_bound(amax * world, wire, world + 1)
            + 4 * 2.0 ** -23 * amax * world}
os.environ["HEAT_TPU_HIERARCHICAL"] = "0"
print("SCALE " + json.dumps({"rank": rank, **res}), flush=True)
dist.barrier()
dist.destroy_process_group()
"""


# the four ranks' FSDP and ZeRO updates against the world of one's: the
# relative RMS over all tensors and the worst tensor's. Four H100s measured
# 0.0158 and 0.0225 (700 W); a rank that trains on its own quarter of the
# batch stands near 1 from it
SCALE_FOUR_UPDATE_TOL = (2.5e-2, 4e-2)


def scale_out_four_phase(backend="nccl", size="full", timeout=900):
    """On four or more cards: the scale-out path on four NCCL ranks (one
    process a card) with ``_SCALE_OUT_WORKER``: the LM under FSDP (p = 4)
    and ZeroOptimizer, the pipeline over its blocks at S = 4 (gpipe and
    1f1b) and at S = 2 x local 2 (``HEAT_TPU_TOPOLOGY=2x2
    HEAT_TPU_HIERARCHICAL=1``), each held against a world of one on the
    same rank; a flat and a tiered all-reduce of 4,194,304 f32 under every
    wire; each one's issued collectives audited against the cost model.
    With fewer cards the phase says so. ``backend="gloo", size="tiny"``
    rehearses it on the CPU."""
    import socket
    import torch

    world = 4
    if backend == "nccl" and torch.cuda.device_count() < world:
        emit({"phase": "scale-out on four cards", "run": False,
              "why": f"needs four cards, this machine has {torch.cuda.device_count()}"})
        return None
    here = os.path.dirname(os.path.abspath(__file__))
    if backend == "nccl":  # the flash kernels once, before the ranks load them
        sys.path.insert(0, here)
        from heat_tpu_torch import _build

        _build.build(["flash_fwd", "flash_bwd"])
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""),
               HEAT_TPU_FSDP="0", HEAT_TPU_HIERARCHICAL="0")
    env.pop("HEAT_TPU_TOPOLOGY", None)
    logs = [tempfile.TemporaryFile(mode="w+") for _ in range(world)]
    procs = [subprocess.Popen([sys.executable, "-c", _SCALE_OUT_WORKER, str(r), str(world),
                               str(port), backend, size], cwd=here, env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    # the first rank to fail ends the others (they would wait in a collective)
    deadline = time.time() + timeout
    while any(p.poll() is None for p in procs) and time.time() < deadline:
        if any(p.poll() not in (None, 0) for p in procs):
            break
        time.sleep(1.0)
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    ranks, ok = [], all(p.returncode == 0 for p in procs)
    for r, log in enumerate(logs):
        log.seek(0)
        text = log.read()
        log.close()
        lines = [ln for ln in text.splitlines() if ln.startswith("SCALE ")]
        if lines:
            ranks.append(json.loads(lines[-1][6:]))
        else:
            emit({"phase": "scale-out on four cards", "rank": r,
                  "returncode": procs[r].returncode, "rank_log_tail": text[-3000:]})
    check("scale-out four cards: every rank finished", ok and len(ranks) == world)
    if len(ranks) != world:
        return None
    emit({"phase": "scale-out on four cards", "world": world, "backend": backend,
          "ranks": ranks})
    audits = {"fsdp forward": [r["fsdp_forward_audit"] for r in ranks],
              "zero step": [r["zero_step_audit"] for r in ranks],
              "pipeline step (S = 4)": [r["pipe4_gpipe_audit"] for r in ranks],
              **{f"allreduce {k}": [r["allreduce"][k]["audit"] for r in ranks]
                 for k in ranks[0]["allreduce"]}}
    check("scale-out four cards: audited bytes equal the cost model's",
          all(a["ok"] and a["emitted_bytes"] == a["predicted_bytes"]
              for reports in audits.values() for a in reports),
          audits={k: [(a["emitted_bytes"], a["predicted_bytes"]) for a in v]
                  for k, v in audits.items()})
    r0 = ranks[0]
    check("scale-out four cards: FSDP and ZeRO bytes a card below the replicated run's",
          all(r["fsdp_bytes"][0] < r["replicated_bytes"][0]
              and r["fsdp_bytes"][1] < r["replicated_bytes"][1]
              and r["zero_bytes"][1] < r["replicated_bytes"][1] for r in ranks),
          fsdp=r0["fsdp_bytes"], zero=r0["zero_bytes"], replicated=r0["replicated_bytes"])
    # tolerance: the loss after three steps within 1e-2 of the world of one's
    # (bf16 activations; the four ranks' gradients are summed in another
    # order than one card's batch)
    one = r0["one"][-1]["loss"]
    losses = {name: [r[name][-1]["loss"] for r in ranks]
              for name in ("fsdp", "zero", "pipe4_gpipe", "pipe4_1f1b", "pipe22")}
    pipe_one = r0["pipe_one"][-1]["loss"]
    check("scale-out four cards: the losses after three steps equal the world of one's",
          all(abs(v - one) <= 1e-2 * abs(one) for v in losses["fsdp"] + losses["zero"])
          and all(abs(v - pipe_one) <= 1e-2 * abs(pipe_one) for name in
                  ("pipe4_gpipe", "pipe4_1f1b", "pipe22") for v in losses[name]),
          world_of_one=one, pipeline_world_of_one=pipe_one, losses=losses, tolerance=1e-2)
    if backend == "nccl":  # the gathered weights dropped, only inputs stashed
        peak = {name: r0[name][-1]["peak_gib"] for name in
                ("one", "fsdp", "zero", "pipe_one", "pipe4_gpipe", "pipe4_1f1b", "pipe22")}
        check("scale-out four cards: FSDP's, ZeRO's and the pipeline's peak memory below "
              "their world of one's", peak["fsdp"] < peak["one"] and peak["zero"] < peak["one"]
              and max(peak["pipe4_gpipe"], peak["pipe4_1f1b"], peak["pipe22"])
              < peak["pipe_one"], peak_gib=peak)
    # tolerance: FSDP's and ZeRO's parameters after three steps hold the
    # world of one's updates to SCALE_FOUR_UPDATE_TOL of their RMS (global,
    # per tensor): the four ranks round their bf16 gradients of a quarter
    # batch each before they are summed
    vs_one = {name: [r[name + "_vs_one"] for r in ranks] for name in ("fsdp", "zero")}
    check("scale-out four cards: FSDP's and ZeRO's updates equal the world of one's",
          all(e["update_rel_rms"] <= SCALE_FOUR_UPDATE_TOL[0]
              and e["worst_tensor_rel_rms"] <= SCALE_FOUR_UPDATE_TOL[1]
              for v in vs_one.values() for e in v),
          against_world_of_one={k: v[0] for k, v in vs_one.items()},
          tolerance=SCALE_FOUR_UPDATE_TOL)
    check("scale-out four cards: the pipeline at S = 4 and 2 x 2 bit for bit the world of one",
          all(all(r["pipe_bit_identical"].values()) for r in ranks),
          max_abs_vs_one=r0["pipe_max_abs_vs_one"])
    check("scale-out four cards: 1f1b bit for bit gpipe, fewer steady bubble ticks",
          all(r["pipe_1f1b_is_gpipe"] for r in ranks)
          and r0["pipe4_1f1b_table"]["steady_bubble_ticks"]
          < r0["pipe4_gpipe_table"]["steady_bubble_ticks"],
          tables={k: r0[k + "_table"] for k in ("pipe4_gpipe", "pipe4_1f1b")})
    check("scale-out four cards: compressed all-reduces within their bound",
          all(v["max_abs_err"] <= v["bound"] for r in ranks
              for v in r["allreduce"].values()),
          errors={k: (v["max_abs_err"], v["bound"]) for k, v in r0["allreduce"].items()})
    return ranks


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import heat_tpu_torch as ht
    from heat_tpu_torch import _build
    from heat_tpu_torch.cluster.cuda_lloyd import lloyd_fit, lloyd_update, lloyd_update_plain
    from heat_tpu_torch.core.cuda_moments import column_moments, column_moments_plain
    from heat_tpu_torch.core.linalg import int8_matmul, quantize_int8
    from heat_tpu_torch.core.linalg.cuda_quant import _wgmma_tile_width, int8_gemm, int8_gemm_plain
    from heat_tpu_torch.parallel.cuda_attention import (
        _attention_variant, _flash_forward, _fwd_tiles, _strides, flash_attention_plain)
    from heat_tpu_torch.spatial.cuda_cdist import euclid, euclid_plain, last_variant

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0)})

    t0 = time.perf_counter()
    paths = _build.build()
    build_s = time.perf_counter() - t0
    ptxas = {}
    for name, path in paths.items():
        log = path.with_suffix(".so.log")
        lines = log.read_text().splitlines() if log.exists() else []
        ptxas[name] = [ln.split("ptxas info    : ")[-1].strip() for ln in lines
                       if "Used" in ln or "spill" in ln]
    # the Hopper variants by name: registers and spills from the nvcc log, the
    # dynamic shared memory a block asks for from the library itself
    import ctypes
    hopper = {}
    for name, marks in (("flash_fwd", ("flash_",)), ("flash_bwd", ("flash_",)),
                        ("int8_gemm", ("int8_gemm_wgmma", "transpose_s8")),
                        ("lloyd", ("lloyd_tc",)),
                        ("cdist", ("cdist_tc", "cdist_prepare", "cdist_fma_stream"))):
        log = paths[name].with_suffix(".so.log")
        lines = log.read_text().splitlines() if log.exists() else []
        for i, ln in enumerate(lines):
            if "Compiling entry function" in ln and any(
                    ("wgmma" in ln or mark != "flash_") and mark in ln for mark in marks):
                entry = ln.split("'")[1]
                mark = next(mark for mark in marks if mark in entry)
                entry = entry[entry.index(mark):]
                entry = entry.split("EEEv")[0] if "EEEv" in entry else mark
                hopper[entry] = " ".join(x.split("ptxas info    : ")[-1].strip()
                                         for x in lines[i + 1:i + 4] if "Used" in x or "spill" in x)
            if "Potential Performance Loss" in ln or "setmaxnreg ignored" in ln:
                hopper.setdefault("ptxas_performance_notes", []).append(ln[:320])
    fwd_lib, bwd_lib = ctypes.CDLL(str(paths["flash_fwd"])), ctypes.CDLL(str(paths["flash_bwd"]))
    q_lib, lloyd_lib = ctypes.CDLL(str(paths["int8_gemm"])), ctypes.CDLL(str(paths["lloyd"]))
    cdist_lib = ctypes.CDLL(str(paths["cdist"]))
    smem = {f"flash_fwd_wgmma d={d} bm={bm} bn={bn}": fwd_lib.heat_flash_fwd_wgmma_smem(d, bm, bn)
            for d in (64, 128) for bm in (64, 128) for bn in (64, 128)}
    smem.update({f"flash_bwd_fused_wgmma d={d}": bwd_lib.heat_flash_bwd_fused_wgmma_smem(d)
                 for d in (64, 128)})
    smem.update({f"flash_bwd_dkv_wgmma d={d} stages={st}":
                 bwd_lib.heat_flash_bwd_dkv_wgmma_smem(d, st) for d in (64, 128) for st in (2, 4)})
    smem.update({f"flash_bwd_dq_wgmma d={d} bm={bm} bn={bn}":
                 bwd_lib.heat_flash_bwd_dq_wgmma_smem(d, bm, bn) for d, (bm, bn) in DQ_TILES})
    smem.update({f"int8_gemm_wgmma bn={bn}": q_lib.heat_int8_gemm_wgmma_smem(bn)
                 for bn in (128, 256)})
    for d, k in ((64, 64), (512, 1024), (64, 1), (36, 100)):
        plan = [ctypes.c_int(0) for _ in range(3)]
        smem[f"lloyd_tc d={d} k={k}"] = {
            "bytes": lloyd_lib.heat_lloyd_tc_plan(d, k, *(ctypes.byref(v) for v in plan)),
            **dict(zip(("blocks_per_sm", "x_slots", "accumulator_copies"),
                       (v.value for v in plan)))}
    smem["cdist_tc"] = cdist_lib.heat_cdist_tc_smem()
    spilled = [k for k, v in hopper.items() if k != "ptxas_performance_notes"
               and "0 bytes spill stores, 0 bytes spill loads" not in v]
    emit({"phase": "build", "seconds": build_s, "ptxas": ptxas, "hopper_variants": hopper,
          "hopper_dynamic_smem_bytes": smem})
    check("no Hopper variant spills", len(hopper) > 0 and not spilled, spilled=spilled)

    def time_ms(fn, reps, warmup=2):
        for _ in range(warmup):
            materialize(fn())
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            materialize(fn())
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def device_ms(fn, reps, warmup=2):
        """Device time of one call: `reps` calls captured into a CUDA graph
        and replayed three times between two events. The flash wrappers take
        60-90 microseconds of host time a call, more than some of their
        kernels run, so back-to-back calls from Python would time the host."""
        for _ in range(warmup):
            materialize(fn())
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                materialize(fn())
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            graph.replay()
        end.record()
        end.synchronize()
        del graph
        return start.elapsed_time(end) / (3 * reps)

    def time_turns(old, new, reps):
        """old, new, new, old in turns on this card: the mean device time of each."""
        t = [device_ms(fn, reps) for fn in (old, new, new, old)]
        return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    report = {}

    # ---------------------------------------------------------------- K2
    def moments_case(label, m, d, lim, timed):
        x = torch.randn((m, d), generator=gen, device=dev) * 3.0 + 1.5
        mu_k, m2_k = column_moments(x, lim)
        mu_p, m2_p = column_moments_plain(x, lim)
        torch.cuda.synchronize()
        # tolerance: mean within 1e-5 of the column's spread (the mean is near
        # 0 against a spread of 3), M2 within 1e-4 relative (the kernel sums in
        # another order than torch)
        spread = mu_p.abs() + torch.sqrt(m2_p / max(lim, 1))
        err_mu = ((mu_k - mu_p).abs() / spread).max().item()
        err_m2 = ((m2_k - m2_p).abs() / m2_p.abs()).max().item()
        max_abs = max((mu_k - mu_p).abs().max().item(), (m2_k - m2_p).abs().max().item())
        fields = {"shape": [m, d], "lim": lim, "mean_err_over_spread": err_mu,
                  "m2_rel_err": err_m2, "max_abs_err": max_abs,
                  "tolerance": {"mean_over_spread": 1e-5, "m2_rel": 1e-4}}
        xl = x[:lim]
        reps = 20 if timed else 5
        fields["kernel_ms"] = time_ms(lambda: column_moments(x, lim), reps)
        fields["plain_ms"] = time_ms(lambda: column_moments_plain(x, lim), reps)
        fields["library_ms"] = time_ms(lambda: torch.var_mean(xl, 0, correction=0), reps)
        fields["bound_ms"], fields["bound_by"] = bound(lim * d * 4 + 2 * d * 4, 3 * lim * d)
        if timed:
            report["moments"] = fields
        check(f"moments {label}", err_mu <= 1e-5 and err_m2 <= 1e-4, **fields)
        del x

    moments_case("main", 8_000_000, 64, 8_000_000, True)
    moments_case("ragged", 1_000_003, 100, 1_000_003, False)
    moments_case("ragged lim", 1_000_003, 100, 999_990, False)

    # ---------------------------------------------------------------- K3
    # Each case against the plain version of its own tier
    # (HEAT_TPU_CDIST_PREC: bf16x3/high -> the 3xTF32 kernel, default -> one
    # TF32 pass, highest -> the f32 FMA kernel; the plain TF32 forms emulate
    # the tensor cores). Tolerance on the squared distance: 2e-5 of
    # |x|^2 + |y|^2 (+ 1e-6), the error scale of an f32 GEMM-form expansion
    # over k <= 512 terms; for rbf the same, times gamma
    # (|d exp(-g d2)| <= g |d d2|). The one TF32 pass is also held to exact
    # f32 at 2e-3 of |x|^2 + |y|^2: each operand's TF32 truncation (<= 2^-10
    # relative) gives <= 2^-9 a product, and 2 |x.y| <= |x|^2 + |y|^2. For
    # x = y the diagonal: out[i, i] <= sqrt(2e-5 * 2 |x_i|^2 + 1e-6) (for one
    # TF32 pass 2e-3, its tier's scale). Every case runs twice and must be
    # bit-identical.
    def d2_worst(out_k, out_p, scale, gamma, epilogue, rel):
        if epilogue == "rbf":
            return ((out_k - out_p).abs() / (gamma * (rel * scale + 1e-6))).max().item()
        return ((out_k * out_k - out_p * out_p).abs() / (rel * scale + 1e-6)).max().item()

    def cdist_case(label, m, n, k, epilogue, expect, precision="bf16x3", same=False,
                   timed=False, turns=False, chunk=None):
        """chunk: the benchmark's block, x the first m of y's n standard
        Gaussian rows; the plain version is held against the kernel `chunk`
        rows at a time (whole, its temporaries pass the card's memory), the
        kernel also bit for bit against cdist_kernel, and neither the plain
        version nor the library call is timed."""
        if chunk:
            y = torch.randn((n, k), generator=gen, device=dev)
            x = y[:m]
        else:
            x = torch.rand((m, k), generator=gen, device=dev)
            y = x if same else torch.rand((n, k), generator=gen, device=dev)
        gamma = 0.5 / k if epilogue == "rbf" else 0.0
        out_k = euclid(x, y, gamma, epilogue, precision)
        variant = last_variant()
        repeat = bool(torch.equal(out_k, euclid(x, y, gamma, epilogue, precision)))
        x2 = (x * x).sum(1)
        y2 = (y * y).sum(1)
        worst, max_abs = 0.0, 0.0
        for r0 in range(0, m, chunk or m):
            r1 = min(m, r0 + (chunk or m))
            out_p = euclid_plain(x[r0:r1], y, gamma, epilogue, precision)
            scale = x2[r0:r1, None] + y2[None, :]
            worst = max(worst, d2_worst(out_k[r0:r1], out_p, scale, gamma, epilogue, 2e-5))
            max_abs = max(max_abs, (out_k[r0:r1] - out_p).abs().max().item())
            del out_p, scale
        fields = {"shape": [m, n, k], "epilogue": epilogue, "precision": precision,
                  "variant": variant, "expected_variant": expect,
                  "max_abs_err": max_abs,
                  "worst_err_over_tol": worst, "repeat_bitwise": repeat,
                  "tolerance": "|d2_k - d2_p| <= 2e-5 (|x|^2 + |y|^2) + 1e-6, "
                               "against the plain version of the same tier"}
        ok = worst <= 1.0 and repeat and variant == expect
        if chunk:
            fields["plain_rows_a_chunk"] = chunk
            fields["bitwise_vs_cdist_kernel"] = bool(
                torch.equal(out_k, euclid(x, y, gamma, epilogue, _old_kernel=True)))
            ok = ok and fields["bitwise_vs_cdist_kernel"]
        if precision == "DEFAULT":
            out_e = euclid_plain(x, y, gamma, epilogue, "HIGHEST")
            scale = x2[:, None] + y2[None, :]
            fields["worst_err_over_tol_vs_exact_f32"] = d2_worst(out_k, out_e, scale, gamma,
                                                                 epilogue, 2e-3)
            fields["tolerance_vs_exact_f32"] = "|d2_k - d2_f32| <= 2e-3 (|x|^2 + |y|^2) + 1e-6"
            ok = ok and fields["worst_err_over_tol_vs_exact_f32"] <= 1.0
            del out_e, scale
        if same and epilogue == "dist":  # the tier's own scale: 2e-3 for one TF32 pass
            rel = 2e-3 if precision == "DEFAULT" else 2e-5
            diag = (out_k.diagonal() / torch.sqrt(rel * 2 * x2 + 1e-6)).max().item()
            fields["diagonal_over_bound"] = diag
            fields["diagonal_bound"] = f"out[i, i] <= sqrt({rel} * 2 |x_i|^2 + 1e-6)"
            ok = ok and diag <= 1.0
        del out_k
        reps = 10 if timed else 5
        run = lambda: euclid(x, y, gamma, epilogue, precision)  # noqa: E731
        if turns:  # cdist_kernel, the older f32 FMA kernel, in turns with this one
            fields["old_ms"], fields["kernel_ms"] = time_turns(
                lambda: euclid(x, y, gamma, epilogue, _old_kernel=True), run, reps)
        else:
            fields["old_ms"], fields["kernel_ms"] = None, device_ms(run, reps)
        fields["plain_ms"] = (None if chunk else
                              time_ms(lambda: euclid_plain(x, y, gamma, epilogue, precision), 5))
        # torch.cdist with TF32 off (set above for the whole run)
        fields["library_ms"] = (time_ms(lambda: torch.cdist(x, y), 5)
                                if epilogue == "dist" and not chunk else None)
        nbytes = (m * k + n * k + m * n) * 4
        fields["bound_ms_f32_fma"], fields["bound_by_f32_fma"] = bound(nbytes, 2 * m * n * k)
        products = {"3xtf32_wgmma": 3, "tf32_wgmma": 1}.get(variant)
        fields["bound_ms"], fields["bound_by"] = (
            bound(nbytes, products * 2 * m * n * k, TF32_FLOPS_PER_S) if products
            else (fields["bound_ms_f32_fma"], fields["bound_by_f32_fma"]))
        if timed:
            report["cdist"] = fields
        check(f"cdist {label}", ok, **fields)
        del x, y

    cdist_case("main", 16384, 16384, 128, "dist", "3xtf32_wgmma", same=True, timed=True,
               turns=True)
    cdist_case("main, HEAT_TPU_CDIST_PREC=default", 16384, 16384, 128, "dist", "tf32_wgmma",
               precision="DEFAULT", same=True)
    cdist_case("main, HEAT_TPU_CDIST_PREC=highest", 16384, 16384, 128, "dist", "f32_fma_stream",
               precision="HIGHEST", same=True, turns=True)
    cdist_case("ragged (n % 4 != 0: guarded stores)", 16000, 15999, 124, "dist", "3xtf32_wgmma")
    cdist_case("ragged rbf", 16000, 15999, 124, "rbf", "3xtf32_wgmma")
    cdist_case("k = 512", 2049, 4100, 512, "dist", "3xtf32_wgmma")
    cdist_case("k = 4", 4097, 1000, 4, "rbf", "3xtf32_wgmma")
    cdist_case("ragged k = 127 (the streamed f32 FMA kernel by its gate, four panels)", 16000,
               15999, 127, "dist", "f32_fma_stream")
    cdist_case("ragged k = 127 rbf", 16000, 15999, 127, "rbf", "f32_fma_stream")
    cdist_case("SUSY's block, 40,000 x 160,000 x 18 (the streamed f32 FMA kernel by its gate)",
               40000, 160000, 18, "dist", "f32_fma_stream", turns=True, chunk=4000)
    cdist_case("ragged k = 17 rbf (streamed, guarded stores)", 16000, 15999, 17, "rbf",
               "f32_fma_stream")

    # ---------------------------------------------------------------- K4
    def blobs(n, d, k, spread=8.0):
        protos = torch.randn((k, d), generator=gen, device=dev) * spread
        lab = torch.randint(0, k, (n,), generator=gen, device=dev)
        x = protos[lab] + torch.randn((n, d), generator=gen, device=dev)
        return x, protos

    def lloyd_case(label, n, d, k, timed):
        x, protos = blobs(n, d, k)
        c = protos + 0.1 * torch.randn((k, d), generator=gen, device=dev)
        s_k, n_k = lloyd_update(x, c)
        s_p, n_p = lloyd_update_plain(x, c)
        s_k2, n_k2 = lloyd_update(x, c)
        s_o, n_o = lloyd_update(x, c, _old_kernel=True)
        torch.cuda.synchronize()
        abs_sums = torch.zeros_like(c).index_add_(
            0, torch.argmin(torch.cdist(x, c), 1), x.abs())
        # tolerance: counts exact (well separated blobs have no near-ties),
        # sums within 1e-4 of the sum of |x| (another summation order); the
        # old (f32 FMA) kernel is held to the same
        worst = ((s_k - s_p).abs() / (1e-4 * abs_sums + 1e-5)).max().item()
        worst_old = ((s_o - s_p).abs() / (1e-4 * abs_sums + 1e-5)).max().item()
        counts_equal = bool(torch.equal(n_k, n_p) and torch.equal(n_o, n_p))
        repeat_equal = bool(torch.equal(s_k, s_k2) and torch.equal(n_k, n_k2))
        tc = d % 4 == 0  # the tensor-core kernel's gate at these shapes
        fields = {"shape": [n, d, k], "variant": "lloyd_tc" if tc else "lloyd_partial",
                  "counts_equal": counts_equal, "repeat_bitwise": repeat_equal,
                  "max_abs_err": (s_k - s_p).abs().max().item(), "worst_err_over_tol": worst,
                  "old_worst_err_over_tol": worst_old,
                  "tolerance": "counts exact; |sums_k - sums_p| <= 1e-4 sum|x| + 1e-5"}
        reps = 10 if timed else 5
        if tc:
            fields["old_ms"], fields["kernel_ms"] = time_turns(
                lambda: lloyd_update(x, c, _old_kernel=True), lambda: lloyd_update(x, c), reps)
        else:
            fields["old_ms"], fields["kernel_ms"] = None, device_ms(lambda: lloyd_update(x, c),
                                                                     reps)
        fields["plain_ms"] = time_ms(lambda: lloyd_update_plain(x, c), reps)
        fields["library_ms"] = None
        # the f32 FMA kernel's operations: the scores' product (2nkd), one
        # argmin compare per score (nk) and one add per row and feature into
        # its center (nd); the tensor-core kernel does the product three
        # times in TF32 (lo.hi, hi.lo, hi.hi)
        nbytes = n * d * 4 + 2 * k * d * 4 + k * 4
        fma_ms, fma_by = bound(nbytes, 2 * n * k * d + n * k + n * d)
        fields["bound_ms_f32_fma"], fields["bound_by_f32_fma"] = fma_ms, fma_by
        fields["bound_ms"], fields["bound_by"] = (
            bound(nbytes, 3 * 2 * n * k * d, TF32_FLOPS_PER_S) if tc else (fma_ms, fma_by))
        if timed:
            report["lloyd"] = fields
        check(f"lloyd {label}", worst <= 1.0 and worst_old <= 1.0 and counts_equal
              and repeat_equal, **fields)

    lloyd_case("main", 2_000_000, 64, 64, True)
    lloyd_case("ragged (d % 4 != 0: the f32 FMA kernel)", 100_003, 33, 1000, False)
    lloyd_case("gate corner", 20_011, 512, 1024, False)
    lloyd_case("k = 1", 5_000, 64, 1, False)
    lloyd_case("d no multiple of 32", 70_001, 36, 100, False)

    # ---------------------------------------------------------------- K6
    # Tolerances: in f32, O within 2e-5 max|v| (exact f32 products summed in
    # other orders); in bf16, O within 2^-7 max|v| (each side rounds O to
    # bf16, one ulp of |O| <= max|v| being 2^-8 max|v|, and a probability
    # near a bf16 rounding boundary may round the other way); the LSE within
    # 1e-5 (1 + |lse|) in both (its products are exact in f32). The output
    # without the LSE must equal the output with it, bit for bit.
    import torch.nn.functional as F

    def live_pairs(b, t_q, t_k, h, causal, kv_valid):
        """The (row, key) pairs this run's masks leave live, and the key rows
        that any row sees."""
        kv_end = min(kv_valid, t_k)
        rows = torch.arange(t_q, dtype=torch.float64)
        live = (torch.clamp(rows + 1, max=kv_end) if causal
                else torch.full_like(rows, kv_end)).sum().item()
        return b * h * live, (min(kv_end, t_q) if causal else kv_end)

    def flash_case(label, b, t_q, t_k, h, d, dtype, causal, kv_valid, reps, transposed=False):
        q = torch.randn((b, t_q, h, d), generator=gen, device=dev).to(dtype)
        k = torch.randn((b, t_k, h, d), generator=gen, device=dev).to(dtype)
        v = torch.randn((b, t_k, h, d), generator=gen, device=dev).to(dtype)
        if transposed:  # (B, H, T, D) memory behind the (B, T, H, D) view
            q, k, v = (x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v))
        scale = 1.0 / d ** 0.5
        variant = _attention_variant(dtype, d, _strides(q, k, v), True)
        o_k, lse_k = _flash_forward(q, k, v, scale, causal, kv_valid, return_lse=True)
        o_k2 = _flash_forward(q, k, v, scale, causal, kv_valid)
        o_p, lse_p = flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                           kv_valid=kv_valid, return_lse=True)
        torch.cuda.synchronize()
        vmax = v.float().abs().max().item()
        tol = (2e-5 if dtype == torch.float32 else 2.0 ** -7) * vmax
        err = (o_k.float() - o_p.float()).abs().max().item()
        lse_err = ((lse_k - lse_p).abs() / (1e-5 * (1 + lse_p.abs()))).max().item()
        same = bool(torch.equal(o_k, o_k2))
        pairs, kv_rows = live_pairs(b, t_q, t_k, h, causal, kv_valid)
        esize = q.element_size()
        nbytes = (2 * b * t_q * h * d + 2 * b * kv_rows * h * d) * esize
        fields = {"shape": [b, t_q, t_k, h, d], "dtype": str(dtype).split(".")[-1],
                  "causal": causal, "kv_valid": kv_valid, "transposed": transposed,
                  "variant": variant, "max_abs_err": err,
                  "err_over_tol": err / tol, "lse_err_over_tol": lse_err,
                  "no_lse_output_bitwise": same,
                  "tolerance": {"o_abs": tol, "lse": "1e-5 (1 + |lse|)"}}
        ok = err <= tol and lse_err <= 1.0 and same

        def run(**kw):
            return lambda: _flash_forward(q, k, v, scale, causal, kv_valid, **kw)

        if variant == "bf16_wgmma":
            # the mma.sync kernel at the same shape: held to the same tolerance,
            # and timed in turns with the new one
            fields["tiles"] = list(_fwd_tiles(t_q, d))
            o_old, lse_old = _flash_forward(q, k, v, scale, causal, kv_valid, return_lse=True,
                                            _old_kernel=True)
            fields["old_max_abs_err"] = (o_old.float() - o_p.float()).abs().max().item()
            fields["new_vs_old_max_abs"] = (o_k.float() - o_old.float()).abs().max().item()
            ok = ok and fields["old_max_abs_err"] <= tol
            del o_old, lse_old
            fields["old_ms"], fields["kernel_ms"] = time_turns(run(_old_kernel=True), run(), reps)
        else:
            fields["old_ms"], fields["kernel_ms"] = None, device_ms(run(), reps)
        del o_p, lse_p, o_k2
        fields["kernel_lse_ms"] = device_ms(run(return_lse=True), reps)
        fields["plain_ms"] = time_ms(lambda: flash_attention_plain(
            q, k, v, causal=causal, scale=scale, kv_valid=kv_valid), 2, warmup=1)
        fields["library_ms"] = None
        if kv_valid >= t_k:
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            fields["library_ms"] = device_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, scale=scale), reps)
        ops = 4 * pairs * d
        fields["bound_ms"], fields["bound_by"] = bound(
            nbytes, ops, BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S)
        fields["operations"], fields["exponentials"], fields["bytes"] = ops, pairs, nbytes
        check(f"flash_fwd {label}", ok, **fields)
        return fields

    report["flash_fwd"] = flash_case("LM shape", 8, 1024, 1024, 16, 64, torch.bfloat16, True,
                                     1024, 20)
    flash_bench = flash_case("bench shape", 4, 4096, 4096, 8, 128, torch.bfloat16, False, 4096, 10)
    flash_case("bench shape, causal", 4, 4096, 4096, 8, 128, torch.bfloat16, True, 4096, 10)
    for d in (24, 64, 128):  # 24: off the Hopper gate, the mma.sync and f32 kernels
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (False, True):
                flash_case("ragged", 2, 1000, 1337, 3, d, dtype, causal, 900, 3)
    flash_case("ragged, transposed, kv_valid = T_k", 2, 1000, 1337, 3, 64, torch.bfloat16, False,
               1337, 3, transposed=True)
    flash_case("one short tile", 3, 40, 70, 2, 128, torch.bfloat16, True, 70, 3)
    # the Hopper forward's tile choices (query rows a block x keys a tile) at
    # the two path shapes: what _fwd_tiles' rule rests on
    tile_ms = {}
    for label, (b, t, h, d), causal in (("LM shape", (8, 1024, 16, 64), True),
                                        ("bench shape", (4, 4096, 8, 128), False)):
        q, k, v = (torch.randn((b, t, h, d), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        tile_ms[label] = {
            f"{bm}x{bn}": device_ms(lambda: _flash_forward(q, k, v, d ** -0.5, causal, t,
                                                           _tiles=(bm, bn)), 10)
            for bm in (64, 128) for bn in (64, 128)}
        tile_ms[label]["rule"] = "x".join(map(str, _fwd_tiles(t, d)))
    emit({"phase": "flash_fwd tile choices, device ms", **tile_ms})
    check("flash_fwd: the tile rule picks the fastest or within 10% of it",
          all(ms[ms["rule"]] <= 1.10 * min(x for x in ms.values() if isinstance(x, float))
              for ms in tile_ms.values()), tile_ms=tile_ms)
    del q, k, v
    # the wrapper's host time per call (enqueue only, no synchronize inside the
    # loop) at a shape whose kernel is shorter than its launch: the Hopper
    # variant encodes three tensor maps a call
    q, k, v = (torch.randn((1, 64, 1, 64), generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    host_us = {}
    for label, kw in (("old", {"_old_kernel": True}), ("new", {}), ("new again", {}),
                      ("old again", {"_old_kernel": True})):
        for _ in range(20):
            _flash_forward(q, k, v, 0.125, True, 64, **kw)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(500):
            _flash_forward(q, k, v, 0.125, True, 64, **kw)
        host_us[label] = (time.perf_counter() - t) / 500 * 1e6
        torch.cuda.synchronize()
    emit({"phase": "flash_fwd wrapper host time per call, microseconds", **host_us})
    del q, k, v
    # a non-positive scale is outside the Hopper forward: it takes the mma.sync kernel
    q, k, v = (torch.randn((2, 200, 2, 64), generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    o_neg = _flash_forward(q, k, v, -0.125, True, 200)
    o_neg_p = flash_attention_plain(q, k, v, causal=True, scale=-0.125, kv_valid=200)
    err = (o_neg.float() - o_neg_p.float()).abs().max().item()
    check("flash_fwd negative scale (mma.sync kernel)",
          err <= 2.0 ** -7 * v.float().abs().max().item(), max_abs_err=err)
    del q, k, v, o_neg, o_neg_p

    # --------------------------------------------------------- K7a, K7b, K8
    # The backward kernels against the plain backward on the same inputs
    # (O and LSE from K6). Tolerances, against each gradient's largest
    # magnitude in the plain version: in f32 within 2e-5 (exact f32 products
    # summed in other orders; K8 adds dQ by f32 atomics). In bf16 both round
    # the same p and dS to bf16 before their products, but p comes from
    # ex2.approx against exp and the scores sum in other orders, so a value
    # near a bf16 rounding boundary may round the other way (one bf16 ulp is
    # 2^-8 relative) and each output rounds to bf16 (2^-9): relative RMS
    # within 2e-3 and the largest error within 2^-6. A fully masked input
    # (kv_valid = 0) gives gradients of exactly 0. Two runs of K7a and K7b,
    # and K8's dK and dV, agree bit for bit; K8's dQ is a sum of f32 atomics
    # whose order changes from run to run, so it is held to the tolerance.
    # The D that the Hopper K7a writes for K7b is held against the plain
    # prologue's within 1e-6 of sum |dO O| over the row (f32 sums of the
    # same exact products in another order).
    # The library time is SDPA's backward: its forward and backward less its
    # forward (no kv_valid mask there, so only where kv_valid >= T_k).
    from heat_tpu_torch.parallel.cuda_attention import (
        _bwd_dkv_stages, _bwd_dq_tiles, _bwd_operands, _dq_workspace, _flash_bwd,
        _flash_bwd_fused, _launch_bwd, _launch_dkv_wgmma, _launch_dq_wgmma, _launch_fused_wgmma,
        _row_terms, flash_attention, flash_attention_bwd_plain)

    def grad_errors(got, want, dtype):
        """Per gradient: the largest error, over the peak, relative RMS, and
        whether it is within the tolerance."""
        out = {}
        for name, x, w in zip(("dq", "dk", "dv"), got, want):
            x, w = x.float(), w.float()
            peak = w.abs().max().item()
            err = (x - w).abs().max().item()
            if peak == 0.0:
                out[name] = {"max_abs_err": err, "ok": err == 0.0}
                continue
            rel = ((x - w).norm() / w.norm()).item()
            ok = (err <= 2e-5 * peak if dtype == torch.float32
                  else rel <= 2e-3 and err <= 2.0 ** -6 * peak)
            out[name] = {"max_abs_err": err, "max_over_peak": err / peak, "rel_rms": rel, "ok": ok}
        return out

    def sdpa_bwd_ms(q, k, v, do, causal, scale, reps):
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        dot = do.transpose(1, 2)

        def fwd_bwd():
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, scale=scale).backward(dot)

        def fwd():
            with torch.no_grad():
                F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, scale=scale)

        return device_ms(fwd_bwd, reps) - device_ms(fwd, reps)

    def flash_bwd_case(label, b, t_q, t_k, h, d, dtype, causal, kv_valid, reps, timed=False,
                       transposed=False):
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                       for shape in ((b, t_q, h, d), (b, t_k, h, d), (b, t_k, h, d),
                                     (b, t_q, h, d)))
        if transposed:  # (B, H, T, D) memory behind the (B, T, H, D) view
            q, k, v, do = (x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v, do))
        scale = 1.0 / d ** 0.5
        variant = _attention_variant(dtype, d, _strides(q, k, v, do), True)
        o, lse = _flash_forward(q, k, v, scale, causal, kv_valid, return_lse=True)
        args = (q, k, v, o, lse, do, scale, causal, kv_valid)
        want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal, scale=scale,
                                         kv_valid=kv_valid)
        two, two2 = _flash_bwd(*args), _flash_bwd(*args)
        fused, fused2 = _flash_bwd_fused(*args), _flash_bwd_fused(*args)
        torch.cuda.synchronize()
        err_two, err_fused = grad_errors(two, want, dtype), grad_errors(fused, want, dtype)
        repeat_two = all(torch.equal(x, y) for x, y in zip(two, two2))
        repeat_fused_kv = all(torch.equal(x, y) for x, y in zip(fused[1:], fused2[1:]))
        fields = {"shape": [b, t_q, t_k, h, d], "dtype": str(dtype).split(".")[-1],
                  "causal": causal, "kv_valid": kv_valid, "transposed": transposed,
                  "variant": variant, "two_pass": err_two, "fused": err_fused,
                  "two_pass_repeat_bitwise": repeat_two,
                  "fused_dk_dv_repeat_bitwise": repeat_fused_kv,
                  "fused_dq_repeat_bitwise": torch.equal(fused[0], fused2[0]),
                  "tolerance": {"f32": "max err <= 2e-5 peak",
                                "bf16": "rel RMS <= 2e-3 and max err <= 2^-6 peak",
                                "fully masked": "exactly 0",
                                "D": "|D_k - D_p| <= 1e-6 sum|dO O|"}}
        ok = (all(e["ok"] for e in (*err_two.values(), *err_fused.values()))
              and repeat_two and repeat_fused_kv)
        if variant == "bf16_wgmma":
            # the mma.sync kernels at the same shape: against the plain
            # backward and against the new ones, the same tolerance
            old_two = _flash_bwd(*args, _old_kernel=True)
            old = _flash_bwd_fused(*args, _old_kernel=True)
            fields["two_pass_old_kernel"] = grad_errors(old_two, want, dtype)
            fields["two_pass_new_vs_old"] = grad_errors(two, old_two, dtype)
            fields["fused_old_kernel"] = grad_errors(old, want, dtype)
            # the D that K7a writes for K7b, against the plain prologue
            qq, kk, vv, dd_o, lse_c, dd_p = _bwd_operands(q, k, v, o, lse, do)
            dd_k = torch.full_like(dd_p, float("nan"))
            _launch_dq_wgmma(qq, kk, vv, dd_o, o, lse_c, dd_k, torch.empty_like(qq), scale, causal,
                             kv_valid, _bwd_dq_tiles(t_q, d))
            size = (do.float() * o.float()).abs().sum(-1).transpose(1, 2)
            fields["k7a_d_err_over_tol"] = ((dd_k - dd_p).abs() / (1e-6 * size + 1e-30)).max().item()
            ok = ok and fields["k7a_d_err_over_tol"] <= 1.0 and all(
                e["ok"] for name in ("two_pass_old_kernel", "two_pass_new_vs_old",
                                     "fused_old_kernel") for e in fields[name].values())
            del old, old_two, dd_k, size
        del want, two2, fused2
        kernels = None
        if timed:
            qq, kk, vv, dd_o, lse_c, dd = _bwd_operands(q, k, v, o, lse, do)
            dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
            dq32 = torch.zeros(q.shape, dtype=torch.float32, device=dev)
            dd_buf = torch.empty_like(dd)

            def launch(name, outs):
                return lambda: _launch_bwd(name, qq, kk, vv, dd_o, lse_c, dd, *outs, scale,
                                           causal, kv_valid)

            plain_ms = time_ms(lambda: flash_attention_bwd_plain(
                q, k, v, o, lse, do, causal=causal, scale=scale, kv_valid=kv_valid), 2, warmup=1)
            library_ms = sdpa_bwd_ms(q, k, v, do, causal, scale, reps) if kv_valid >= t_k else None
            # the whole two-pass wrapper, old (plain D prologue, mma.sync
            # kernels) against new (D inside the wgmma K7a), and the prologue
            # alone
            fields["two_pass_old_ms"], fields["two_pass_ms"] = time_turns(
                lambda: _flash_bwd(*args, _old_kernel=True), lambda: _flash_bwd(*args), reps)
            fields["plain_prologue_ms"] = device_ms(lambda: _row_terms(o, do), reps)
            fields["fused_old_ms"], fields["fused_ms"] = time_turns(
                lambda: _flash_bwd_fused(*args, _old_kernel=True),
                lambda: _flash_bwd_fused(*args), reps)
            fields["plain_ms"], fields["library_ms"] = plain_ms, library_ms
            pairs, kv_rows = live_pairs(b, t_q, t_k, h, causal, kv_valid)
            es = q.element_size()
            reads = (2 * b * t_q * h * d + 2 * b * kv_rows * h * d) * es + 2 * b * h * t_q * 4
            kv_out = 2 * b * t_k * h * d * es
            rate = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S
            wgmma = variant == "bf16_wgmma"
            # the wgmma K7a also reads O and computes D (2 D operations a row)
            # in place of reading it
            dq_bytes = reads + b * t_q * h * d * es * (2 if wgmma else 1)
            dq_ops_extra = 2 * b * t_q * h * d if wgmma else 0
            new = {
                "flash_bwd_dq": lambda: _launch_dq_wgmma(
                    qq, kk, vv, dd_o, o, lse_c, dd_buf, dq, scale, causal, kv_valid,
                    _bwd_dq_tiles(t_q, d)),
                "flash_bwd_dkv": lambda: _launch_dkv_wgmma(
                    qq, kk, vv, dd_o, lse_c, dd, dk, dv, scale, causal, kv_valid,
                    _bwd_dkv_stages(d)),
            }
            kernels = {}
            for name, outs, per_pair, nbytes, extra, err in (
                    ("flash_bwd_dq", (dq, None, None), 6, dq_bytes, dq_ops_extra,
                     err_two["dq"]["max_abs_err"]),
                    ("flash_bwd_dkv", (None, dk, dv), 8, reads + kv_out, 0,
                     max(err_two["dk"]["max_abs_err"], err_two["dv"]["max_abs_err"])),
                    ("flash_bwd_fused", (dq32, dk, dv), 10, reads + kv_out + 4 * b * t_q * h * d,
                     0, max(e["max_abs_err"] for e in err_fused.values()))):
                ops = per_pair * d * pairs + extra
                bound_ms, bound_by = bound(nbytes, ops, rate)
                old_ms, which = None, variant if wgmma else None
                if wgmma and name == "flash_bwd_fused":
                    # kernel alone, on a workspace that is not re-zeroed: the
                    # sums it holds change no time
                    ws = _dq_workspace(b, h, t_q, d, dev)
                    old_ms, kernel_ms = time_turns(
                        launch(name, outs),
                        lambda: _launch_fused_wgmma(qq, kk, vv, dd_o, lse_c, dd, ws, dk, dv,
                                                    scale, causal, kv_valid), reps)
                    del ws
                elif wgmma:
                    old_ms, kernel_ms = time_turns(launch(name, outs), new[name], reps)
                else:
                    kernel_ms = device_ms(launch(name, outs), reps)
                kernels[name] = {"kernel_ms": kernel_ms, "old_ms": old_ms, "variant": which,
                                 "plain_ms": plain_ms, "library_ms": library_ms,
                                 "bound_ms": bound_ms, "bound_by": bound_by, "operations": ops,
                                 "exponentials": pairs, "bytes": nbytes, "max_abs_err": err}
            fields["kernels"] = kernels
            fields["two_pass_kernels_ms"] = (kernels["flash_bwd_dq"]["kernel_ms"]
                                             + kernels["flash_bwd_dkv"]["kernel_ms"])
        check(f"flash_bwd {label}", ok, **fields)
        return kernels

    report.update(flash_bwd_case("LM shape", 8, 1024, 1024, 16, 64, torch.bfloat16, True, 1024,
                                 20, timed=True))
    attention_bwd = flash_bwd_case("attention_bwd shape", 4, 4096, 4096, 8, 128, torch.bfloat16,
                                   True, 4096, 10, timed=True)
    emit({"phase": "flash_bwd attention_bwd shape", "kernels": attention_bwd})
    emit({"phase": "flash_bwd attention_bwd shape, non-causal", "kernels": flash_bwd_case(
        "attention_bwd shape, non-causal", 4, 4096, 4096, 8, 128, torch.bfloat16, False, 4096, 5,
        timed=True)})
    for d in (24, 64, 128):  # 24: off the Hopper gate, the mma.sync and f32 kernels
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (False, True):
                flash_bwd_case("ragged", 2, 1000, 1337, 3, d, dtype, causal, 900, 3)
    flash_bwd_case("ragged, transposed, kv_valid = T_k", 2, 1000, 1337, 3, 64, torch.bfloat16,
                   False, 1337, 3, transposed=True)
    flash_bwd_case("fully masked", 2, 100, 100, 2, 64, torch.bfloat16, False, 0, 3)
    flash_bwd_case("fully masked, D = 128, causal", 2, 100, 100, 2, 128, torch.bfloat16, True, 0,
                   3)
    flash_bwd_case("ragged, transposed, D = 128, causal", 2, 1000, 1337, 3, 128, torch.bfloat16,
                   True, 1337, 3, transposed=True)
    # the Hopper two-pass's choices at the two timed shapes, each kernel
    # alone: K7a's (query rows a block, keys a tile) and K7b's ring slots,
    # what _bwd_dq_tiles and _bwd_dkv_stages rest on
    choice_ms = {}
    for label, (b, t, h, d) in (("LM shape", (8, 1024, 16, 64)),
                                ("attention_bwd shape", (4, 4096, 8, 128))):
        q, k, v, g = (torch.randn((b, t, h, d), generator=gen, device=dev).to(torch.bfloat16)
                      for _ in range(4))
        o, lse = _flash_forward(q, k, v, d ** -0.5, True, t, return_lse=True)
        qq, kk, vv, dd_o, lse_c, dd = _bwd_operands(q, k, v, o, lse, g)
        dq, dk, dv, dd_buf = (torch.empty_like(x) for x in (q, k, v, dd))
        reps = 20 if t == 1024 else 10
        dq_ms = {f"{bm}x{bn}": device_ms(lambda: _launch_dq_wgmma(
            qq, kk, vv, dd_o, o, lse_c, dd_buf, dq, d ** -0.5, True, t, (bm, bn)), reps)
            for dd_, (bm, bn) in DQ_TILES if dd_ == d}
        dq_ms["rule"] = "x".join(map(str, _bwd_dq_tiles(t, d)))
        dkv_ms = {str(st): device_ms(lambda: _launch_dkv_wgmma(
            qq, kk, vv, dd_o, lse_c, dd, dk, dv, d ** -0.5, True, t, st), reps) for st in (2, 4)}
        dkv_ms["rule"] = str(_bwd_dkv_stages(d))
        choice_ms[label] = {"flash_bwd_dq tiles": dq_ms, "flash_bwd_dkv stages": dkv_ms}
    emit({"phase": "flash_bwd two-pass choices, device ms, bf16 causal", **choice_ms})
    check("flash_bwd two-pass: the rules pick the fastest choice or within 10% of it",
          all(ms[ms["rule"]] <= 1.10 * min(x for x in ms.values() if isinstance(x, float))
              for by in choice_ms.values() for ms in by.values()), choice_ms=choice_ms)
    del q, k, v, g, o, lse, qq, kk, vv, dd_o, lse_c, dd, dq, dk, dv, dd_buf

    # the composed autograd path, flash_attention(...).backward(g): two-pass
    # bit-identical to the direct call (the same K6 forward feeds the same
    # kernels), fused within the tolerance, both against the plain backward
    q, k, v, g = (torch.randn((8, 1024, 16, 64), generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(4))
    o, lse = _flash_forward(q, k, v, 0.125, True, 1024, return_lse=True)
    want = flash_attention_bwd_plain(q, k, v, o, lse, g, causal=True, scale=0.125)
    direct = _flash_bwd(q, k, v, o, lse, g, 0.125, True, 1024)
    for impl in ("two_pass", "fused"):
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        flash_attention(*leaves, causal=True, bwd_impl=impl).backward(g)
        got = [x.grad for x in leaves]
        errs = grad_errors(got, want, torch.bfloat16)
        same = all(torch.equal(x, y) for x, y in zip(got, direct))
        check(f"flash_attention autograd {impl} (LM shape) vs plain backward",
              all(e["ok"] for e in errs.values()) and (same or impl == "fused"),
              errors=errs, bitwise_equal_to_direct_two_pass=same)
    del q, k, v, g, o, lse, want, direct, leaves, got

    # "auto": two-pass against fused over T at the LM's widths, for the
    # port's shape rule (no timing at run time)
    auto_ms = {}
    for b, t, h, d in ((8, 256, 16, 64), (8, 512, 16, 64), (8, 1024, 16, 64), (8, 2048, 16, 64),
                       (2, 4096, 16, 64), (4, 4096, 8, 128)):
        q, k, v, g = (torch.randn((b, t, h, d), generator=gen, device=dev).to(torch.bfloat16)
                      for _ in range(4))
        o, lse = _flash_forward(q, k, v, d ** -0.5, True, t, return_lse=True)
        args = (q, k, v, o, lse, g, d ** -0.5, True, t)
        fused_old_ms, fused_ms = time_turns(lambda: _flash_bwd_fused(*args, _old_kernel=True),
                                            lambda: _flash_bwd_fused(*args), 10)
        two_old_ms, two_ms = time_turns(lambda: _flash_bwd(*args, _old_kernel=True),
                                        lambda: _flash_bwd(*args), 10)
        auto_ms[f"{b}x{t}x{h}x{d}"] = {"two_pass_ms": two_ms, "two_pass_old_kernel_ms": two_old_ms,
                                       "two_pass_host_bound_ms": time_ms(
                                           lambda: _flash_bwd(*args), 10),
                                       "fused_host_bound_ms": time_ms(
                                           lambda: _flash_bwd_fused(*args), 10),
                                       "fused_ms": fused_ms, "fused_old_kernel_ms": fused_old_ms}
    emit({"phase": "flash_bwd two-pass vs fused, bf16 causal", "ms": auto_ms})
    del q, k, v, g, o, lse, args

    # ---------------------------------------------------------------- K5
    # bit-identical: the int32 accumulation is exact and the epilogue
    # rounds in the plain version's order
    def int8_case(label, m, n, k, out_dtype, reps):
        qa, sa = quantize_int8(torch.randn((m, k), generator=gen, device=dev), axis=1)
        qb, sb = quantize_int8(torch.randn((k, n), generator=gen, device=dev), axis=0)
        got = int8_gemm(qa, sa, qb, sb, out_dtype)
        want = int8_gemm_plain(qa, sa, qb, sb, out_dtype)
        old = int8_gemm(qa, sa, qb, sb, out_dtype, _old_kernel=True)
        torch.cuda.synchronize()
        equal = bool(torch.equal(got, want) and torch.equal(old, want))
        wgmma = k % 16 == 0  # the wgmma kernel's gate at these shapes
        fields = {"shape": [m, n, k], "out_dtype": str(out_dtype).split(".")[-1],
                  "variant": "int8_gemm_wgmma" if wgmma else "int8_gemm_kernel",
                  "bit_identical": equal,
                  "max_abs_err": (got.float() - want.float()).abs().max().item(),
                  "tolerance": "bit-identical, the mma.sync kernel too"}
        del got, want, old
        if wgmma:
            fields["old_ms"], fields["kernel_ms"] = time_turns(
                lambda: int8_gemm(qa, sa, qb, sb, out_dtype, _old_kernel=True),
                lambda: int8_gemm(qa, sa, qb, sb, out_dtype), reps)
            # both tile widths, bit-identical, timed for the width rule
            other = 384 - _wgmma_tile_width(k)
            fields["tile_width_rule"] = _wgmma_tile_width(k)
            fields[f"bn={other}_bit_identical"] = bool(torch.equal(
                int8_gemm(qa, sa, qb, sb, out_dtype, _bn=other),
                int8_gemm_plain(qa, sa, qb, sb, out_dtype)))
            fields[f"bn={other}_ms"] = device_ms(
                lambda: int8_gemm(qa, sa, qb, sb, out_dtype, _bn=other), reps)
            equal = equal and fields[f"bn={other}_bit_identical"]
            qbt = torch.empty((n, k), dtype=torch.int8, device=dev)
            fields["qb_transpose_copy_ms"] = device_ms(lambda: qbt.copy_(qb.t()), reps)
            del qbt
        else:
            fields["old_ms"], fields["kernel_ms"] = None, device_ms(
                lambda: int8_gemm(qa, sa, qb, sb, out_dtype), reps)
        fields["plain_ms"] = time_ms(lambda: int8_gemm_plain(qa, sa, qb, sb, out_dtype), 2,
                                     warmup=1)
        fields["library_ms"] = None
        if m > 16 and k % 8 == 0 and n % 8 == 0:
            scale = sa * sb
            fields["library_ms"] = time_ms(
                lambda: (torch._int_mm(qa, qb).float() * scale).to(out_dtype), reps)
        out_bytes = m * n * (4 if out_dtype == torch.float32 else 2)
        fields["bound_ms"], fields["bound_by"] = bound(m * k + k * n + 4 * (m + n) + out_bytes,
                                                       2 * m * n * k, INT8_OPS_PER_S)
        check(f"int8_gemm {label}", equal, **fields)
        return fields

    report["int8_gemm"] = int8_case("8192^3", 8192, 8192, 8192, torch.float32, 10)
    int8_case("8192^3", 8192, 8192, 8192, torch.bfloat16, 5)
    int8_quant_dense = int8_case("QuantDense shape", 8192, 4096, 1024, torch.float32, 10)
    for out_dtype in (torch.float32, torch.bfloat16):
        int8_case("ragged (K % 16 != 0: the mma.sync kernel)", 1000, 1000, 999, out_dtype, 5)
        int8_case("ragged M, N; K % 128 != 0", 1000, 777, 1040, out_dtype, 5)

    # ------------------------------------------------------ random kernel
    report["random"] = random_phase(ht, dev, time_ms, paths)

    # ---------------------------------------------------------- main path
    # the inputs drawn as bench.py draws them, through ht.random (the
    # threefry kernel), from seed 0
    ht.random.seed(0)
    ht.reset_launch_counts()
    xm_t = ht.random.randn(8_000_000, 64, split=0).larray
    xc_t = ht.random.rand(16384, 128, split=0).larray
    xk_t = ht.random.randn(2_000_000, 64, split=0).larray
    torch.cuda.synchronize()
    draw_launches = ht.launch_counts()["random"]
    check("main path inputs drawn by the random kernel", draw_launches == 3 and xm_t.is_cuda,
          launches=draw_launches)

    def run_main_path():
        stages = {}
        t = time.perf_counter()
        x = ht.array(xm_t, split=0)
        y = x * 2 + 1
        moments = ht.mean(y, axis=0), ht.var(y, axis=0), ht.std(y, axis=0)
        torch.cuda.synchronize()
        stages["moments_s"] = time.perf_counter() - t
        t = time.perf_counter()
        xc = ht.array(xc_t, split=0)
        dist = ht.spatial.cdist(xc, xc, quadratic_expansion=True)
        torch.cuda.synchronize()
        stages["cdist_s"] = time.perf_counter() - t
        t = time.perf_counter()
        xk = ht.array(xk_t, split=0)
        km = ht.cluster.KMeans(n_clusters=64, init="random", max_iter=50, tol=0.0,
                               random_state=1).fit(xk)
        torch.cuda.synchronize()
        stages["kmeans_s"] = time.perf_counter() - t
        return stages, moments, dist, km

    ht.reset_launch_counts()
    stages, (mu, va, sd), dist, km = run_main_path()
    launches = {name: ht.launch_counts()[name] for name in ARRAY_PATH}
    cdist_variant = last_variant()
    emit({"phase": "main path", "stages": stages, "launches": launches,
          "kmeans_n_iter": km.n_iter_, "cdist_variant": cdist_variant})
    check("main path launched every kernel", all(v > 0 for v in launches.values()),
          launches=launches)
    check("main path cdist ran the 3xTF32 kernel", cdist_variant == "3xtf32_wgmma",
          variant=cdist_variant)

    # references in float64
    y64 = xm_t.double() * 2 + 1
    mu64 = y64.mean(0)
    va64 = y64.var(0, correction=0)
    del y64
    spread = mu64.abs() + va64.sqrt()
    err_mu = ((mu.larray.double() - mu64).abs() / spread).max().item()
    err_va = ((va.larray.double() - va64).abs() / va64).max().item()
    err_sd = ((sd.larray.double() - va64.sqrt()).abs() / va64.sqrt()).max().item()
    shapes_ok = mu.shape == (64,) and va.shape == (64,) and sd.shape == (64,)
    finite = bool(torch.isfinite(mu.larray).all() and torch.isfinite(va.larray).all())
    check("main path moments vs float64", shapes_ok and finite and err_mu <= 1e-5
          and err_va <= 1e-4 and err_sd <= 1e-4, mean_err_over_spread=err_mu,
          var_rel_err=err_va, std_rel_err=err_sd,
          tolerance={"mean_over_spread": 1e-5, "var_rel": 1e-4, "std_rel": 1e-4})

    rows = torch.randint(0, 16384, (512,), generator=gen, device=dev)
    xc64 = xc_t.double()
    ref = torch.cdist(xc64[rows], xc64, compute_mode="donot_use_mm_for_euclid_dist")
    got = dist.larray[rows].double()
    scale = (xc64[rows] ** 2).sum(1)[:, None] + (xc64 ** 2).sum(1)[None, :]
    err_d2 = ((got ** 2 - ref ** 2).abs() - (2e-5 * scale + 1e-6)).max().item()
    check("main path cdist vs float64 (512 sampled rows)",
          dist.shape == (16384, 16384) and bool(torch.isfinite(dist.larray).all()) and err_d2 <= 0,
          max_abs_err=(got - ref).abs().max().item(),
          tolerance="|d2 - d2_ref| <= 2e-5 (|x|^2 + |y|^2) + 1e-6")
    del ref, got, scale, dist

    # KMeans, step by step: the fit's own trajectory replayed through
    # lloyd_fit with every pass held against a float64 pass from the same
    # centers. A row whose two best float64 scores lie within the f32 error
    # bound of a score, 2 d u (2 |x| max|c| + max|c|^2), may take either
    # label, so its |x| and its count are allowed to either center; the rest
    # of the sums within 1e-4 of the sum of |x| (another summation order).
    n_rows, d_k, k_k = xk_t.shape[0], xk_t.shape[1], 64
    # init='random', random_state=1: the JAX package's 64 rows
    c0 = xk_t[torch.tensor(GOLDEN_KMEANS_ROWS, device=dev)].clone()
    c_first = ht.cluster.KMeans(n_clusters=k_k, init="random", random_state=1)
    c_first = c_first._initialize_cluster_centers(ht.array(xk_t, split=0))
    check("main path kmeans starts from the JAX package's rows", bool(torch.equal(c_first, c0)),
          rows_of=list(GOLDEN_KMEANS_ROWS_OF))
    del c_first
    xk64 = xk_t.double()
    xnorm = xk64.norm(dim=1)
    steps = {"worst_sum_err_over_tol": 0.0, "worst_count_err_over_tol": 0.0,
             "most_ambiguous_rows": 0, "every_row_counted_once": True}

    def checked_update(x, c):
        s_k, n_k = lloyd_update(x, c)
        c64 = c.double()
        scores = (c64 * c64).sum(1)[None, :] - 2.0 * (xk64 @ c64.T)
        top = torch.topk(scores, 2, dim=1, largest=False)
        del scores
        lab, lab2 = top.indices[:, 0], top.indices[:, 1]
        cmax = c64.norm(dim=1).max()
        eps = 2 * d_k * 2.0 ** -24 * (2 * xnorm * cmax + cmax * cmax)
        amb = (top.values[:, 1] - top.values[:, 0]) <= eps
        zeros = torch.zeros((k_k, d_k), dtype=torch.float64, device=dev)
        sums = zeros.clone().index_add_(0, lab, xk64)
        cnt = torch.bincount(lab, minlength=k_k).double()
        abs_sums = zeros.clone().index_add_(0, lab, xk64.abs())
        xa = xk64[amb].abs()
        amb_abs = zeros.clone().index_add_(0, lab[amb], xa).index_add_(0, lab2[amb], xa)
        amb_cnt = (torch.bincount(lab[amb], minlength=k_k)
                   + torch.bincount(lab2[amb], minlength=k_k)).double()
        sum_err = ((s_k.double() - sums).abs() / (1e-4 * abs_sums + amb_abs + 1e-5)).max().item()
        cnt_err = ((n_k.double() - cnt).abs() / (amb_cnt + 0.5)).max().item()
        steps["worst_sum_err_over_tol"] = max(steps["worst_sum_err_over_tol"], sum_err)
        steps["worst_count_err_over_tol"] = max(steps["worst_count_err_over_tol"], cnt_err)
        steps["most_ambiguous_rows"] = max(steps["most_ambiguous_rows"], int(amb.sum()))
        steps["every_row_counted_once"] &= int(n_k.sum().item()) == n_rows
        return s_k, n_k

    c_replay, it_replay = lloyd_fit(xk_t, c0, 50, 0.0, None, update=checked_update)
    same_path = bool(torch.equal(c_replay, km.cluster_centers_.larray)) and it_replay == km.n_iter_
    check("main path kmeans, each pass vs float64 along the fit's trajectory",
          same_path and km.n_iter_ == 50 and steps["worst_sum_err_over_tol"] <= 1.0
          and steps["worst_count_err_over_tol"] < 1.0 and steps["every_row_counted_once"],
          replay_bit_identical_to_fit=same_path, n_iter=km.n_iter_, **steps,
          tolerance="counts add up to the rows, each within its ambiguous rows; "
                    "|sums - sums64| <= 1e-4 sum|x| + |x| of the ambiguous rows + 1e-5")

    # KMeans, end to end: a float64 fit from the same initial centers. On
    # randn data, with no cluster structure, two fits whose passes differ in
    # near-tie labels drift apart over 50 passes, so labels and centers are
    # reported beside the same drift of the plain f32 fit (lloyd_fit with
    # the plain pass); the gate is n_iter and the inertia, within 1e-4
    # relative (each pass moves it only by the near-tie rows' score gaps)
    c = c0.double()
    for _ in range(50):
        lab = torch.argmin((c * c).sum(1)[None, :] - 2.0 * (xk64 @ c.T), 1)
        sums = torch.zeros_like(c).index_add_(0, lab, xk64)
        cnt = torch.bincount(lab, minlength=k_k).double()[:, None]
        c = torch.where(cnt > 0, sums / cnt.clamp(min=1), c)
    d2 = ((xk64 * xk64).sum(1)[:, None] + (c * c).sum(1)[None, :] - 2.0 * (xk64 @ c.T)).clamp(min=0)
    lab = torch.argmin(d2, 1)
    inertia64 = float(d2.min(1).values.sum())
    del d2
    c_plain, _ = lloyd_fit(xk_t, c0, 50, 0.0, None, update=lloyd_update_plain)
    lab_plain = torch.argmin(torch.cdist(xk_t, c_plain), 1)
    drift = {
        "label_agreement": (km.labels_.larray == lab).double().mean().item(),
        "center_max_abs_err": (km.cluster_centers_.larray.double() - c).abs().max().item(),
        "plain_f32_label_agreement": (lab_plain == lab).double().mean().item(),
        "plain_f32_center_max_abs_err": (c_plain.double() - c).abs().max().item(),
    }
    err_i = abs(km.inertia_ - inertia64) / inertia64
    check("main path kmeans end to end vs a float64 fit", km.n_iter_ == 50 and err_i <= 1e-4,
          n_iter=km.n_iter_, inertia_rel_err=err_i, **drift,
          tolerance={"n_iter": 50, "inertia_rel": 1e-4})
    del xk64, xnorm, mu, va, sd, c_plain, lab_plain

    # the KMeans stage's host time: the 'random' draw (threefry sort keys
    # and two stable sorts of the rows on the card), the wrapper's host
    # time per pass (no sync), and a warm Lloyd iteration with its shift
    # read, against the pass alone
    xk = ht.array(xk_t, split=0)
    est = ht.cluster.KMeans(n_clusters=64, init="random", random_state=1)
    torch.cuda.synchronize()
    t = time.perf_counter()
    c_init = est._initialize_cluster_centers(xk)
    torch.cuda.synchronize()
    init_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    for _ in range(20):
        lloyd_update(xk_t, c_init)
    wrapper_host_ms = (time.perf_counter() - t) * 1e3 / 20
    torch.cuda.synchronize()
    t = time.perf_counter()
    lloyd_fit(xk_t, c_init, 20, 0.0)
    iteration_ms = (time.perf_counter() - t) * 1e3 / 20
    emit({"phase": "kmeans host breakdown", "init_draw_ms": init_ms,
          "wrapper_host_ms_per_pass": wrapper_host_ms, "iteration_wall_ms": iteration_ms,
          "pass_device_ms": time_ms(lambda: lloyd_update(xk_t, c_init), 10)})
    del xk, est, c_init

    # the main path again under the profiler (device activity only, to keep
    # its host overhead small): device time by kernel and wall time of the
    # same run give the device's busy share; its fit must repeat the first
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        warm_stages, _, _, km2 = run_main_path()
        wall_ms = (time.perf_counter() - t) * 1e3
    on_device = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            on_device[ev.key[:90]] = ev.self_device_time_total / 1e3
    device_ms = sum(on_device.values())
    top = dict(sorted(on_device.items(), key=lambda kv: -kv[1])[:12])
    emit({"phase": "main path profile", "warm_stages": warm_stages, "wall_ms": wall_ms,
          "device_ms": device_ms, "device_busy_share": device_ms / wall_ms,
          "top_device_ms": top})
    check("main path profile saw device time", device_ms > 0, device_ms=device_ms)
    same = bool(torch.equal(km.cluster_centers_.larray, km2.cluster_centers_.larray)
                and torch.equal(km.labels_.larray, km2.labels_.larray))
    check("kmeans fit twice: bit-identical centers and labels", same, n_iter=km2.n_iter_)
    del km, km2
    # ----------------------------------------- the array path under telemetry
    obs_launches = observability_path(ht, dev, xm_t, xc_t, xk_t)
    del xm_t, xc_t, xk_t
    # ------------------------------------------------- bench.py's kmeans_1b row
    kmeans_1b = kmeans_1b_row(ht, dev, time_ms)


    # ----------------------------------------------------------- W8A8 path
    # bench.py's matmul_int8 chain through the port's functions: a's scale
    # normalised by sqrt(n), 30 launches that re-quantise the running
    # product; then one QuantDense(4096) call on the LM's activations
    n_q, reps_q = 8192, 30
    qa, sa = quantize_int8(torch.randn((n_q, n_q), generator=gen, device=dev), axis=1)
    sa = sa / torch.sqrt(torch.tensor(float(n_q), device=dev))
    qb, sb = quantize_int8(torch.randn((n_q, n_q), generator=gen, device=dev), axis=0)
    xd = torch.randn((8, 1024, 1024), generator=gen, device=dev)
    qdense = ht.nn.QuantDense(4096, in_features=1024, device=dev,
                              generator=torch.Generator(device=dev).manual_seed(2))

    def chain(mm):
        qc, sc, scales = qb, sb, []
        for _ in range(reps_q):
            qc, sc = quantize_int8(mm(qa, sa, qc, sc), axis=0)
            scales.append(sc)
        return qc, sc, torch.stack(scales)

    torch.cuda.synchronize()
    ht.reset_launch_counts()
    t = time.perf_counter()
    q_end, s_end, chain_scales = chain(lambda a, s_a, b, s_b: int8_matmul(
        a, s_a, b, s_b, out_dtype=torch.float32))
    torch.cuda.synchronize()
    chain_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    yd = qdense(xd)
    torch.cuda.synchronize()
    dense_ms = (time.perf_counter() - t) * 1e3
    w8a8_launches = {"int8_gemm": ht.launch_counts()["int8_gemm"]}
    emit({"phase": "W8A8 path", "chain_wall_ms": chain_ms, "chain_launches": reps_q,
          "chain_top_s": 2.0 * n_q ** 3 * reps_q / (chain_ms * 1e-3) / 1e12,
          "quant_dense_wall_ms": dense_ms, "launches": w8a8_launches})
    check("W8A8 path launched the int8 kernel 31 times", w8a8_launches["int8_gemm"] == reps_q + 1,
          launches=w8a8_launches)
    q_plain, s_plain, _ = chain(int8_gemm_plain)
    finite = bool(torch.isfinite(chain_scales).all() and (chain_scales > 0).all())
    check("W8A8 chain: scales finite and bit-identical to the plain chain",
          finite and bool(torch.equal(q_end, q_plain) and torch.equal(s_end, s_plain)),
          scale_min=chain_scales.min().item(), scale_max=chain_scales.max().item())
    # QuantDense against the f32 product of the same weights: each operand
    # rounds to 1/127 of its row's (column's) absmax, a uniform error of
    # ~0.9% of a Gaussian value's spread each, so ~1.3% relative RMS; gate 3%
    ref = (xd.reshape(-1, 1024) @ qdense.weight.T).reshape(8, 1024, 4096)
    rel = ((yd - ref).norm() / ref.norm()).item()
    check("QuantDense vs f32 dense", yd.shape == (8, 1024, 4096) and rel <= 3e-2,
          rel_rms_err=rel, max_abs_err=(yd - ref).abs().max().item(),
          tolerance={"rel_rms": 3e-2})
    del qa, sa, qb, sb, q_end, s_end, q_plain, s_plain, chain_scales, xd, yd, ref, qdense

    # ------------------------------------------------ linear-algebra path
    # bench.py's matmul rows, qr and svd, and the elementwise row through the
    # user entry points; no kernel of csrc/ lies on this path
    linalg_launches = linalg_path(ht, dev, gen)
    emit({"phase": "linalg path launches", "launches": linalg_launches})
    check("linalg path launched no kernel of csrc/", not any(linalg_launches.values()),
          launches=linalg_launches)

    # ------------------------------------------------------ statistics path
    # bench.py's reduction row and the statistics at its moments shape,
    # inputs from ht.random
    stats_launches = statistics_path(ht, dev)
    check("statistics path drew with the random kernel and reduced with K2",
          stats_launches["random"] > 0 and stats_launches["moments"] > 0,
          launches=stats_launches)

    # ---------------------------------------------- fusion and the relayouts
    # mean and var of a pending chain grafted into K2, a chain, dense; fused
    # against HEAT_TPU_FUSION=0; then resplit under every plan
    fusion_k2 = fusion_phase(ht, dev, smi, time_ms)
    relayout_phase(ht, dev, smi, time_ms)

    # --------------------------------------------------- manipulations path
    # sort, percentile, unique, topk, getitem/setitem and the layout
    # operations at the moments shape; only the random kernel launches
    manip_launches = manipulations_path(ht, dev, smi)
    check("manipulations path launched only the random kernel",
          manip_launches["random"] > 0 and not any(
              n for name, n in manip_launches.items() if name != "random"),
          launches=manip_launches)

    # ------------------------- exact products, unsigned types, the solvers
    exact_phase(ht, dev, time_ms)
    unsigned_phase(ht, dev)
    solver_phase(ht, dev, smi)

    # ------------------------------------------------ lasso and spectral paths
    lasso_launches = lasso_path(ht, dev, smi)
    check("lasso path launched only the random kernel",
          lasso_launches["random"] > 0 and not any(
              n for name, n in lasso_launches.items() if name != "random"),
          launches=lasso_launches)
    spectral_launches, spectral_rows = spectral_path(ht, dev, smi, time_ms)

    # ------------------------- sparse arrays, the sparse graph, the estimators
    sparse_path(ht, dev, smi, time_ms)
    _, sparse_spectral_rows, adjacency = sparse_spectral_path(ht, dev, smi, time_ms)
    components_phase(ht, adjacency, smi)
    del adjacency
    estimators_path(ht, dev, smi)

    # --------------------------------------------------- out-of-core streaming
    stream_report = streaming_path(ht, dev, smi, time_ms)

    # ------------------------------------------------------------ LM path
    # bench.py's lm_step model at full width, served: three requests of
    # 8 x 1024 tokens drawn from a numpy seed, random weights from a seeded
    # generator; bf16 compute, f32 parameters, flash attention
    import numpy as np

    cfg = dict(vocab_size=32768, d_model=1024, num_heads=16, num_layers=12, max_len=1024,
               mlp_ratio=4.0, device=dev)
    lm = ht.nn.TransformerLM(**cfg, attn_impl="flash", dtype=torch.bfloat16,
                             generator=torch.Generator(device=dev).manual_seed(0))
    matmul_params = sum(p.numel() for name, p in lm.named_parameters()
                        if p.ndim == 2 and name not in ("embed", "pos"))
    rng = np.random.default_rng(0)
    requests = [torch.from_numpy(rng.integers(0, 32768, (8, 1024))).to(dev) for _ in range(3)]
    tokens_per_request = requests[0].numel()

    def serve(tokens):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with torch.inference_mode():
            logits = lm(tokens)
        torch.cuda.synchronize()
        return logits, (time.perf_counter() - t) * 1e3

    warm_ms = serve(requests[0])[1]  # the first call sets up cuBLAS and the allocator
    ht.reset_launch_counts()
    answers, walls = [], []
    for tokens in requests:
        logits, ms = serve(tokens)
        walls.append(ms)
        answers.append(logits)
    lm_launches = {"flash_fwd": ht.launch_counts()["flash_fwd"]}
    for i, logits in enumerate(answers):
        check(f"LM answer {i} finite, (8, 1024, 32768) bf16",
              logits.shape == (8, 1024, 32768) and logits.dtype == torch.bfloat16
              and bool(torch.isfinite(logits).all()))
    del answers[1:], logits
    emit({"phase": "LM path", "requests": len(requests), "first_call_ms": warm_ms,
          "request_wall_ms": walls, "tokens_per_s": [tokens_per_request / (w * 1e-3) for w in walls],
          "matmul_params": matmul_params,
          "matmul_tflop_s": [2.0 * matmul_params * tokens_per_request / (w * 1e-3) / 1e12
                             for w in walls],
          "launches": lm_launches})
    check("LM path launched flash_fwd 12 times a request", lm_launches["flash_fwd"] == 36,
          launches=lm_launches)

    # the same weights with the local core in bf16, and in float32 with the
    # local core (TF32 off): relative RMS error of the logits within 2e-2
    # (bf16 vs bf16: the same roundings but another attention summation
    # order, amplified over 12 layers) and 5e-2 (bf16 vs f32: every
    # activation rounded to bf16, ~2^-9 each, over 12 layers)
    flash_logits = answers[0].float()
    state = lm.state_dict()
    for name, dtype, tol in (("local bf16", torch.bfloat16, 2e-2),
                             ("local f32", torch.float32, 5e-2)):
        other = ht.nn.TransformerLM(**cfg, attn_impl="local", dtype=dtype)
        other.load_state_dict(state)
        with torch.inference_mode():
            ref = other(requests[0]).float()
        rel = ((flash_logits - ref).norm() / ref.norm()).item()
        top1 = (flash_logits.argmax(-1) == ref.argmax(-1)).double().mean().item()
        check(f"LM flash bf16 vs {name}", rel <= tol, rel_rms_err=rel,
              max_abs_err=(flash_logits - ref).abs().max().item(),
              ref_max_abs=ref.abs().max().item(), top1_agreement=top1,
              tolerance={"rel_rms": tol})
        del other, ref
    # causality: a new last token leaves every earlier position bit-identical
    changed = requests[0].clone()
    changed[:, -1] = (changed[:, -1] + 1) % 32768
    with torch.inference_mode():
        logits2 = lm(changed)
    check("LM causal: earlier positions bit-identical after the last token changes",
          bool(torch.equal(answers[0][:, :-1], logits2[:, :-1])),
          max_abs_diff=(answers[0][:, :-1].float() - logits2[:, :-1].float()).abs().max().item())
    del answers, flash_logits, logits2, state

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        logits, prof_wall = serve(requests[1])
    on_device = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            on_device[ev.key[:90]] = ev.self_device_time_total / 1e3
    device_ms = sum(on_device.values())
    emit({"phase": "LM request profile", "wall_ms": prof_wall, "device_ms": device_ms,
          "device_busy_share": device_ms / prof_wall,
          "top_device_ms": dict(sorted(on_device.items(), key=lambda kv: -kv[1])[:12])})
    check("LM profile saw device time", device_ms > 0, device_ms=device_ms)
    del logits, lm

    # ------------------------------------------------------- training path
    # bench.py's lm_step (bench.py:533-593) at full width, as user code:
    # TransformerLM forward, the mean cross-entropy of the next token,
    # backward, and AdamW with optax.adamw's defaults (lr 1e-3, betas 0.9 and
    # 0.999, eps 1e-8, weight decay 1e-4 on every parameter); remat=True,
    # bf16 compute, f32 parameters, flash attention with the two-pass
    # backward. One warm-up step, then 8 steps on one batch of 8 x 1024
    # tokens from a numpy seed, each step ending in a synchronize.
    vocab = cfg["vocab_size"]
    train_cfg = dict(cfg, attn_impl="flash", dtype=torch.bfloat16, remat=True,
                     flash_bwd_impl="two_pass")
    per_step = {"flash_fwd": 24, "flash_bwd_dq": 12, "flash_bwd_dkv": 12, "flash_bwd_fused": 0}
    backward_kernels = ("flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_fused")

    def lm_loss(model, tokens):
        logits = model(tokens)
        return F.cross_entropy(logits[:, :-1].float().reshape(-1, vocab),
                               tokens[:, 1:].reshape(-1))

    allocated_before = torch.cuda.memory_allocated()
    lm = ht.nn.TransformerLM(**train_cfg, generator=torch.Generator(device=dev).manual_seed(0))
    init_state = {name: t.detach().clone() for name, t in lm.state_dict().items()}
    batch = torch.from_numpy(np.random.default_rng(1).integers(0, vocab, (8, 1024))).to(dev)
    tokens_per_step = batch.numel()
    opt = torch.optim.AdamW(lm.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)

    def train_step():
        torch.cuda.synchronize()
        t = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = lm_loss(lm, batch)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        return loss.item(), (time.perf_counter() - t) * 1e3

    warm_loss, warm_ms = train_step()  # cuBLAS, the allocator and AdamW's state
    losses, step_ms, step_launches = [], [], []
    torch.cuda.reset_peak_memory_stats()
    train_launches = dict.fromkeys(per_step, 0)
    for _ in range(8):
        ht.reset_launch_counts()
        loss, ms = train_step()
        counts = {name: ht.launch_counts()[name] for name in per_step}
        losses.append(loss)
        step_ms.append(ms)
        step_launches.append(counts)
        for name in per_step:
            train_launches[name] += counts[name]
    peak_remat = torch.cuda.max_memory_allocated()
    lm.remat = False
    torch.cuda.reset_peak_memory_stats()
    no_remat_loss, no_remat_ms = train_step()
    peak_no_remat = torch.cuda.max_memory_allocated()
    lm.remat = True
    emit({"phase": "training path", "steps": len(losses), "warm_up": {"loss": warm_loss,
          "wall_ms": warm_ms}, "losses": losses, "step_wall_ms": step_ms,
          "tokens_per_s": [tokens_per_step / (ms * 1e-3) for ms in step_ms],
          "model_tflop_s": [6.0 * matmul_params * tokens_per_step / (ms * 1e-3) / 1e12
                            for ms in step_ms],
          "launches_per_step": step_launches[0], "launches": train_launches,
          "max_memory_allocated_gib": {"remat": peak_remat / 2 ** 30,
                                       "no_remat": peak_no_remat / 2 ** 30,
                                       "allocated_before_the_model": allocated_before / 2 ** 30,
                                       "initial_weights_kept_for_the_checks":
                                           sum(t.numel() * t.element_size()
                                               for t in init_state.values()) / 2 ** 30},
          "no_remat_step": {"loss": no_remat_loss, "wall_ms": no_remat_ms}})
    check("training: every loss finite, the 8th below the first",
          all(np.isfinite(losses)) and losses[-1] < losses[0], losses=losses)
    check("training: launches per step flash_fwd 24, dq 12, dkv 12, fused 0",
          all(c == per_step for c in step_launches), launches_per_step=step_launches)

    # one step's gradients from the same weights and tokens, held against
    # the local core (bf16 and f32), fused against two-pass, and remat off
    # against on. Relative RMS per tensor and over all of them, and the
    # cosine similarity over all of them. Gates: flash against local in
    # bf16, 5e-2 global and 1e-1 per tensor (both round every activation to
    # bf16 at the same points, but the attention cores sum and round p and
    # dS their own ways, and the error compounds over 12 layers forward and
    # back: the logits alone differ by ~1.5%); against f32, the same gates
    # (every activation of the bf16 run is rounded, ~2^-9 each); fused
    # against two-pass, 3e-2 and 5e-2: only dQ's summation order differs,
    # which flips a bf16 rounding of dQ here and there, but each layer
    # below re-rounds every activation gradient to bf16, so the difference
    # compounds over 12 layers as the cores' does (~1% seen); two fused runs
    # differ the same way (K8's atomics), and are held to the same gates;
    # remat off against on, 1e-3 for both (the recompute repeats the
    # forward's arithmetic; it is reported whether bit-identical).
    def grads_of(**over):
        model = ht.nn.TransformerLM(**dict(train_cfg, **over))
        model.load_state_dict(init_state)
        loss = lm_loss(model, batch)
        loss.backward()
        grads = {name: p.grad for name, p in model.named_parameters()}
        return loss.item(), grads

    def compare(label, got, ref, gate_global, gate_tensor):
        num = den = dot = norm_got = 0.0
        worst, worst_name = 0.0, None
        for name, r in ref.items():
            a, r = got[name].double(), r.double()
            d2, r2 = (a - r).pow(2).sum().item(), r.pow(2).sum().item()
            rel = (d2 / r2) ** 0.5 if r2 else d2 ** 0.5
            if rel > worst:
                worst, worst_name = rel, name
            num, den = num + d2, den + r2
            dot, norm_got = dot + (a * r).sum().item(), norm_got + a.pow(2).sum().item()
        rel_global = (num / den) ** 0.5
        bitwise = all(torch.equal(got[name], ref[name]) for name in ref)
        check(f"training gradients: {label}", rel_global <= gate_global and worst <= gate_tensor,
              rel_rms_global=rel_global, worst_tensor=worst_name, worst_tensor_rel_rms=worst,
              cosine=dot / (norm_got * den) ** 0.5, bit_identical=bitwise,
              tolerance={"global": gate_global, "per_tensor": gate_tensor})

    ht.reset_launch_counts()
    ref_loss, ref_grads = grads_of()
    check("training gradients: the reference step launched the two-pass kernels",
          {name: ht.launch_counts()[name] for name in per_step} == per_step,
          launches={name: ht.launch_counts()[name] for name in per_step})
    for label, over, gates in (("flash bf16 vs local bf16", {"attn_impl": "local"}, (5e-2, 1e-1)),
                               ("flash bf16 vs local f32",
                                {"attn_impl": "local", "dtype": torch.float32}, (5e-2, 1e-1)),
                               ("remat off vs on", {"remat": False}, (1e-3, 1e-3))):
        other_loss, other = grads_of(**over)
        emit({"phase": f"training gradients {label}", "loss": ref_loss, "other_loss": other_loss})
        compare(label, ref_grads, other, *gates)
        del other
    ht.reset_launch_counts()
    _, fused_grads = grads_of(flash_bwd_impl="fused")
    fused_launches = {name: ht.launch_counts()[name] for name in per_step}
    check("training: fused step launched flash_bwd_fused 12 times, dq and dkv 0",
          fused_launches == {"flash_fwd": 24, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                             "flash_bwd_fused": 12}, launches=fused_launches)
    compare("fused vs two-pass", fused_grads, ref_grads, 3e-2, 5e-2)
    train_launches["flash_bwd_fused"] = fused_launches["flash_bwd_fused"]
    del ref_grads
    compare("fused vs a second fused run", grads_of(flash_bwd_impl="fused")[1], fused_grads,
            3e-2, 5e-2)
    del fused_grads

    # one training step under the profiler (device activity only)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, prof_wall = train_step()
    on_device = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            on_device[ev.key[:90]] = ev.self_device_time_total / 1e3
    device_ms = sum(on_device.values())
    emit({"phase": "training step profile", "wall_ms": prof_wall, "device_ms": device_ms,
          "device_busy_share": device_ms / prof_wall,
          "top_device_ms": dict(sorted(on_device.items(), key=lambda kv: -kv[1])[:16])})
    check("training profile saw device time", device_ms > 0, device_ms=device_ms)
    del lm, opt, init_state

    # ---------------------------------- data and sequence parallelism, DASO
    dp_launches = data_parallel_path(ht, dev, cfg)
    sp_launches = sequence_parallel_phase(ht, dev, time_ms)
    daso_phase(ht, dev)
    scale_launches = scale_out_path(ht, dev, cfg)
    serving = serving_path(ht, dev, smi)
    # ------------------------------------------------- data and observability
    data_launches = data_path(ht, dev, cfg)
    tune_launches = autotune_registry_phase(ht, dev, smi, cfg)
    collective_audit_phase()
    scale_out_four_phase()
    parallel_kernels = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    check("DataParallel, Ulysses and the scale-out path launched K6, K7a and K7b",
          all(dp_launches[name] > 0 and sp_launches[name] > 0 and scale_launches[name] > 0
              for name in parallel_kernels),
          data_parallel=dp_launches, ulysses=sp_launches, scale_out=scale_launches)

    sources = {
        "moments": ("heat_tpu_torch/csrc/moments.cu", "heat_tpu/core/pallas_moments.py:64"),
        "cdist": ("heat_tpu_torch/csrc/cdist.cu", "heat_tpu/spatial/pallas_cdist.py:80"),
        "lloyd": ("heat_tpu_torch/csrc/lloyd.cu", "heat_tpu/cluster/pallas_lloyd.py:55"),
        "flash_fwd": ("heat_tpu_torch/csrc/flash_fwd.cu",
                      "heat_tpu/parallel/pallas_attention.py:46"),
        "int8_gemm": ("heat_tpu_torch/csrc/int8_gemm.cu", "heat_tpu/core/linalg/quant.py:49"),
        "flash_bwd_dq": ("heat_tpu_torch/csrc/flash_bwd.cu",
                         "heat_tpu/parallel/pallas_attention.py:323"),
        "flash_bwd_dkv": ("heat_tpu_torch/csrc/flash_bwd.cu",
                          "heat_tpu/parallel/pallas_attention.py:364"),
        "flash_bwd_fused": ("heat_tpu_torch/csrc/flash_bwd.cu",
                            "heat_tpu/parallel/pallas_attention.py:436"),
        # no Pallas kernel: XLA's threefry2x32, reached from the draws there
        "random": ("heat_tpu_torch/csrc/random.cu", "heat_tpu/core/random.py:59"),
    }
    launches = {**launches, **w8a8_launches, **lm_launches,
                **{name: train_launches[name] for name in backward_kernels}}
    check("training path launched every backward kernel",
          all(launches[name] > 0 for name in backward_kernels), launches=launches)
    # the redesigned kernels also at bench.py's attention shapes and at
    # QuantDense's shape
    also = {"flash_fwd": ("bench shape (4, 4096, 8, 128) bf16 non-causal", flash_bench),
            **{name: ("attention_bwd shape (4, 4096, 8, 128) bf16 causal", attention_bwd[name])
               for name in backward_kernels},
            "int8_gemm": ("QuantDense (8192, 4096, 1024) f32 out", int8_quant_dense)}
    shapes = {"int8_gemm": "W8A8 chain (8192, 8192, 8192) f32 out",
              "lloyd": "KMeans pass (2,000,000, 64), k = 64",
              "cdist": "main path (16384, 16384, 128) f32, x = y, dist",
              "random": "randn (8,000,000, 64) f32: the normal_f32 epilogue"}
    timing_keys = ("variant", "kernel_ms", "old_ms", "plain_ms", "library_ms", "bound_ms",
                   "bound_by", "max_abs_err")
    kernels = []
    for name, (src, tpu) in sources.items():
        r = report[name]
        row = {
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        }
        if name in also or name in shapes:
            row.update({"variant": r["variant"], "old_ms": r["old_ms"],
                        "shape": shapes.get(name, "LM shape (8, 1024, 16, 64) bf16 causal")})
        if name in ("lloyd", "cdist"):
            row["bound_ms_f32_fma"] = r["bound_ms_f32_fma"]
        if name == "random":
            row["torch_randn_ms_other_stream"] = r["torch_randn_ms"]
        if name in also:
            label, other = also[name]
            row["also"] = {"shape": label, **{key: other[key] for key in timing_keys}}
        if name in parallel_kernels:  # the launches of the parallel paths
            row["data_parallel_path_launches"] = dp_launches[name]
            row["ulysses_launches"] = sp_launches[name]
            row["scale_out_path_launches"] = scale_launches[name]
        if name == "moments":  # the streaming path: one launch a chunk
            row["streaming_path_launches"] = stream_report["moments"]["moments"]
            row["fusion_path_launches"] = fusion_k2  # mean/var of pending chains
            row["streaming_chunk"] = {"shape": "(1,048,576, 64) f32",
                                      "ms": stream_report["k2_ms_a_chunk"],
                                      "bound_ms": stream_report["k2_bound_ms_a_chunk"]}
        if name == "lloyd":  # the streaming path: MiniBatchKMeans's windows
            row["streaming_path_launches"] = stream_report["minibatch"]["lloyd"]
        if name in ("lloyd", "random"):  # the serving path's fit
            row["serving_path_launches"] = serving["fit_launches"][name]
        if name in ARRAY_PATH:  # the array path recorded by telemetry
            row["observability_path_launches"] = obs_launches[name]
        if name in data_launches:
            row["data_path_launches"] = data_launches[name]
        if name in tune_launches:  # the tuner's trials: cdist in (a), the LM under FSDP in (b)
            row["autotune_phase_launches"] = tune_launches[name]
        if name in ("lloyd", "random"):  # bench.py's kmeans_1b row
            row["kmeans_1b_launches"] = kmeans_1b["launches"][name]
        if name == "lloyd":
            row["kmeans_1b"] = {"shape": "(16,777,216, 64), k = 64", "ms": kmeans_1b["kernel_ms"],
                                "bound_ms": kmeans_1b["bound_ms"],
                                "fit_wall_s": kmeans_1b["fit_s"]}
        if name in spectral_rows:  # K3 and K4 at the spectral path's shapes, its launches
            row["spectral_path"] = spectral_rows[name]
            row["sparse_spectral_path"] = sparse_spectral_rows[name]
        kernels.append(row)
    if FAILURES:
        print(f"chip_smoke: failed checks: {FAILURES}", file=sys.stderr)
        return 1
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
