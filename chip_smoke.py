#!/usr/bin/env python3
"""Drive heat_tpu_torch's main path once on one CUDA card and check it.

Run from the root of the repository, on a machine with a card:

    python3 chip_smoke.py

Phases, each printing JSON lines:
  1. the card's name and power limit, and the build of every kernel from
     heat_tpu_torch/csrc (one nvcc per source, all at once);
  2. every kernel against its plain PyTorch version on the card, at the
     paths' shapes and at ragged shapes, with the stated tolerances, the
     kernel's, the plain version's and (where one PyTorch call computes the
     same function) the library call's times, and the bound; the flash
     kernels' times are device times (the calls replayed from a CUDA graph);
     the Hopper (wgmma) variants of K6, K7a, K7b and K8 are also held
     against the mma.sync kernels they replace and timed in turns with them
     (old, new, new, old), with their registers, spills and shared memory
     from the build, and their tile choices timed against the shape rules;
     the flash backward (K7a, K7b and K8) also through autograd, and
     two-pass against fused over sequence lengths;
  3. the array path at bench.py's sizes through the user entry points:
     array(split=0) -> x*2+1 -> mean/var/std(axis=0) -> cdist -> KMeans.fit
     (bench.py's fit: randn data, init='random', random_state=1, 50
     iterations, tol=0), with the kernels' launch counts read around it;
     each stage is checked against a float64 reference, the fit both step
     by step along its own trajectory and end to end;
  4. the array path again under the profiler, for the device's busy share
     (device time over wall time of that one run) and the check that its
     fit gives bit-identical centers and labels to the first;
  5. the W8A8 path at bench.py's matmul_int8 width: 30 chained int8_matmul
     launches at 8192^3 that re-quantise the running product, checked bit
     for bit against the same chain through the plain GEMM, and one
     QuantDense(4096) call on 8192 tokens x 1024 against an f32 product;
  6. the serving path: bench.py's lm_step TransformerLM at full width
     (vocab 32768, d_model 1024, 16 heads, 12 layers, bf16, flash
     attention) answers three requests of 8 x 1024 tokens, checked against
     the same weights with the local core and in float32, and for
     causality; then one request under the profiler;
  7. the training path: the same model trains as bench.py's lm_step does
     (remat, bf16, the flash core with its two-pass backward, AdamW), one
     warm-up step and 8 steps on one batch, the loss falling and the
     kernels' launches counted per step; one step's gradients against the
     local core in bf16 and f32, the fused backward and remat off; peak
     memory with and without remat; one step under the profiler.
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
import time

# H100 SXM data-sheet peaks (dense, at the full 700 W power limit): HBM
# bandwidth, the f32 rate outside the tensor cores, and the tensor cores'
# bf16 and int8 rates
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12
ARRAY_PATH = ("moments", "cdist", "lloyd")
# the wgmma K7a's (query rows a block, keys a tile) instantiations, by head dim
DQ_TILES = [(64, (64, 64)), (64, (64, 128)), (64, (128, 64)), (64, (128, 128)),
            (128, (128, 64))]

FAILURES = []


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(name, ok, **fields):
    emit({"check": name, "ok": bool(ok), **fields})
    if not ok:
        FAILURES.append(name)


def bound(bytes_moved, ops, rate=F32_FLOPS_PER_S):
    """The least time in ms: bytes over the memory rate or operations over
    the rate of their type, whichever is larger, and which one it is."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    from heat_tpu_torch.core.linalg.cuda_quant import int8_gemm, int8_gemm_plain
    from heat_tpu_torch.parallel.cuda_attention import (
        _attention_variant, _flash_forward, _fwd_tiles, _strides, flash_attention_plain)
    from heat_tpu_torch.spatial.cuda_cdist import euclid, euclid_plain

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
    for name in ("flash_fwd", "flash_bwd"):
        log = paths[name].with_suffix(".so.log")
        lines = log.read_text().splitlines() if log.exists() else []
        for i, ln in enumerate(lines):
            if "Compiling entry function" in ln and "wgmma" in ln:
                entry = ln.split("'")[1]
                entry = entry[entry.index("flash_"):].split("EEEv")[0]
                hopper[entry] = " ".join(x.split("ptxas info    : ")[-1].strip()
                                         for x in lines[i + 1:i + 4] if "Used" in x or "spill" in x)
            if "Potential Performance Loss" in ln:
                hopper.setdefault("ptxas_performance_notes", []).append(ln[:200])
    fwd_lib, bwd_lib = ctypes.CDLL(str(paths["flash_fwd"])), ctypes.CDLL(str(paths["flash_bwd"]))
    smem = {f"flash_fwd_wgmma d={d} bm={bm} bn={bn}": fwd_lib.heat_flash_fwd_wgmma_smem(d, bm, bn)
            for d in (64, 128) for bm in (64, 128) for bn in (64, 128)}
    smem.update({f"flash_bwd_fused_wgmma d={d}": bwd_lib.heat_flash_bwd_fused_wgmma_smem(d)
                 for d in (64, 128)})
    smem.update({f"flash_bwd_dkv_wgmma d={d} stages={st}":
                 bwd_lib.heat_flash_bwd_dkv_wgmma_smem(d, st) for d in (64, 128) for st in (2, 4)})
    smem.update({f"flash_bwd_dq_wgmma d={d} bm={bm} bn={bn}":
                 bwd_lib.heat_flash_bwd_dq_wgmma_smem(d, bm, bn) for d, (bm, bn) in DQ_TILES})
    spilled = [k for k, v in hopper.items() if k != "ptxas_performance_notes"
               and "0 bytes spill stores, 0 bytes spill loads" not in v]
    emit({"phase": "build", "seconds": build_s, "ptxas": ptxas, "hopper_variants": hopper,
          "hopper_dynamic_smem_bytes": smem})
    check("no Hopper variant spills", len(hopper) > 0 and not spilled, spilled=spilled)

    def time_ms(fn, reps, warmup=2):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def device_ms(fn, reps, warmup=2):
        """Device time of one call: `reps` calls captured into a CUDA graph
        and replayed three times between two events. The flash wrappers take
        60-90 microseconds of host time a call, more than some of their
        kernels run, so back-to-back calls from Python would time the host."""
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
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
    def cdist_case(label, m, n, k, epilogue, timed, same=False):
        x = torch.rand((m, k), generator=gen, device=dev)
        y = x if same else torch.rand((n, k), generator=gen, device=dev)
        gamma = 0.5 / k if epilogue == "rbf" else 0.0
        out_k = euclid(x, y, gamma, epilogue)
        out_p = euclid_plain(x, y, gamma, epilogue)
        torch.cuda.synchronize()
        # tolerance on the squared distance: 2e-5 of |x|^2 + |y|^2, the error
        # scale of an f32 GEMM-form expansion over k <= 512 terms; for rbf the
        # same, times gamma (|d exp(-g d2)| <= g |d d2|)
        scale = (x * x).sum(1)[:, None] + (y * y).sum(1)[None, :]
        if epilogue == "rbf":
            worst = ((out_k - out_p).abs() / (gamma * (2e-5 * scale + 1e-6))).max().item()
        else:
            worst = ((out_k * out_k - out_p * out_p).abs() / (2e-5 * scale + 1e-6)).max().item()
        max_abs = (out_k - out_p).abs().max().item()
        fields = {"shape": [m, n, k], "epilogue": epilogue, "max_abs_err": max_abs,
                  "worst_err_over_tol": worst,
                  "tolerance": "|d2_k - d2_p| <= 2e-5 (|x|^2 + |y|^2) + 1e-6"}
        del scale, out_p
        reps = 10 if timed else 5
        fields["kernel_ms"] = time_ms(lambda: euclid(x, y, gamma, epilogue), reps)
        fields["plain_ms"] = time_ms(lambda: euclid_plain(x, y, gamma, epilogue), 5)
        fields["library_ms"] = time_ms(lambda: torch.cdist(x, y), 5) if epilogue == "dist" else None
        fields["bound_ms"], fields["bound_by"] = bound((m * k + n * k + m * n) * 4, 2 * m * n * k)
        if timed:
            report["cdist"] = fields
        check(f"cdist {label}", worst <= 1.0, **fields)

    cdist_case("main", 16384, 16384, 128, "dist", True, same=True)
    cdist_case("ragged", 16000, 15999, 127, "dist", False)
    cdist_case("ragged rbf", 16000, 15999, 127, "rbf", False)

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
        torch.cuda.synchronize()
        abs_sums = torch.zeros_like(c).index_add_(
            0, torch.argmin(torch.cdist(x, c), 1), x.abs())
        # tolerance: counts exact (well separated blobs have no near-ties),
        # sums within 1e-4 of the sum of |x| (another summation order)
        worst = ((s_k - s_p).abs() / (1e-4 * abs_sums + 1e-5)).max().item()
        counts_equal = bool(torch.equal(n_k, n_p))
        repeat_equal = bool(torch.equal(s_k, s_k2) and torch.equal(n_k, n_k2))
        fields = {"shape": [n, d, k], "counts_equal": counts_equal, "repeat_bitwise": repeat_equal,
                  "max_abs_err": (s_k - s_p).abs().max().item(), "worst_err_over_tol": worst,
                  "tolerance": "counts exact; |sums_k - sums_p| <= 1e-4 sum|x| + 1e-5"}
        reps = 10 if timed else 5
        fields["kernel_ms"] = time_ms(lambda: lloyd_update(x, c), reps)
        fields["plain_ms"] = time_ms(lambda: lloyd_update_plain(x, c), reps)
        fields["library_ms"] = None
        # operations: the scores' product (2nkd), one argmin compare per
        # score (nk) and one add per row and feature into its center (nd)
        fields["bound_ms"], fields["bound_by"] = bound(n * d * 4 + 2 * k * d * 4 + k * 4,
                                                       2 * n * k * d + n * k + n * d)
        if timed:
            report["lloyd"] = fields
        check(f"lloyd {label}", worst <= 1.0 and counts_equal and repeat_equal, **fields)

    lloyd_case("main", 2_000_000, 64, 64, True)
    lloyd_case("ragged", 100_003, 33, 1000, False)
    lloyd_case("gate corner", 20_011, 512, 1024, False)

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
        torch.cuda.synchronize()
        equal = bool(torch.equal(got, want))
        fields = {"shape": [m, n, k], "out_dtype": str(out_dtype).split(".")[-1],
                  "bit_identical": equal,
                  "max_abs_err": (got.float() - want.float()).abs().max().item(),
                  "tolerance": "bit-identical"}
        del got, want
        fields["kernel_ms"] = time_ms(lambda: int8_gemm(qa, sa, qb, sb, out_dtype), reps)
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

    report["int8_gemm"] = int8_case("8192^3", 8192, 8192, 8192, torch.float32, 20)
    int8_case("8192^3", 8192, 8192, 8192, torch.bfloat16, 10)
    int8_case("QuantDense shape", 8192, 4096, 1024, torch.float32, 10)
    for out_dtype in (torch.float32, torch.bfloat16):
        int8_case("ragged", 1000, 1000, 999, out_dtype, 5)

    # ---------------------------------------------------------- main path
    xm_t = torch.randn((8_000_000, 64), generator=gen, device=dev)
    xc_t = torch.rand((16384, 128), generator=gen, device=dev)
    xk_t = torch.randn((2_000_000, 64), generator=gen, device=dev)
    torch.cuda.synchronize()

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
    emit({"phase": "main path", "stages": stages, "launches": launches,
          "kmeans_n_iter": km.n_iter_})
    check("main path launched every kernel", all(v > 0 for v in launches.values()),
          launches=launches)

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
    pick = torch.Generator()
    pick.manual_seed(1)  # init='random', random_state=1: k distinct rows
    c0 = xk_t[torch.randperm(n_rows, generator=pick)[:k_k].to(dev)].clone()
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

    # the KMeans stage's host time: the 'random' draw (a randperm of the
    # rows on the host), the wrapper's host time per pass (no sync), and a
    # warm Lloyd iteration with its shift read, against the pass alone
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
    del km, km2, xm_t, xc_t, xk_t


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
    }
    launches = {**launches, **w8a8_launches, **lm_launches,
                **{name: train_launches[name] for name in backward_kernels}}
    check("training path launched every backward kernel",
          all(launches[name] > 0 for name in backward_kernels), launches=launches)
    # the redesigned kernels also at bench.py's attention shapes
    also = {"flash_fwd": ("bench shape (4, 4096, 8, 128) bf16 non-causal", flash_bench),
            **{name: ("attention_bwd shape (4, 4096, 8, 128) bf16 causal", attention_bwd[name])
               for name in backward_kernels}}
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
        if name in also:
            label, other = also[name]
            row.update({"variant": r["variant"], "old_ms": r["old_ms"],
                        "shape": "LM shape (8, 1024, 16, 64) bf16 causal",
                        "also": {"shape": label, **{key: other[key] for key in timing_keys}}})
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
