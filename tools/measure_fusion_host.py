#!/usr/bin/env python3
"""Host-bound paths of the port timed with deferred fusion off and on, and
on a parent tree, in turns on one card: what the fusion hooks cost on the
paths where the host, not the card, sets the time.

Three variants, each in a fresh process: ``parent`` (the tree PARENT with
its own defaults), ``eager`` (the tree TREE with ``HEAT_TPU_FUSION=0``)
and ``fused`` (TREE with ``HEAT_TPU_FUSION=1``), in the order parent,
eager, fused, fused, eager, parent for each round. Each process warms every
path once and then times it, with the card synchronized before and after
each call, and prints one JSON line: the median wall of each path in ms
with its quartiles, and the fusion counters' ``deferred`` and ``flushes``
a call (absent in a tree without fusion). The paths, at chip_smoke.py's sizes:

- ``lanczos``: ``linalg.lanczos(L, 64)`` of the spectral row's Laplacian
  (8192 x 32 points, gamma 0.05), 5 calls;
- ``spectral``: ``cluster.Spectral(8, gamma=0.05, n_lanczos=64).fit``, 3;
- ``cg``: ``linalg.cg`` on a 4096^2 s.p.d. f32 system, 5;
- ``kmeans``: ``cluster.KMeans(8, init="random", max_iter=10, tol=0)`` over
  1,000,000 x 64 f32, 3;
- ``lasso``: ``regression.Lasso(lam=0.01, max_iter=50, tol=0)`` over
  2,000,000 x 64 (the lasso row, 50 of its 200 epochs), 3;
- ``dp_step``: one blocking ``nn.DataParallel`` step of bench.py's
  lm_step model at full width (12 layers, d 1024, bf16, flash, remat) on
  8 x 1024 tokens with AdamW, 5;
- ``train_step``: the same model's plain step (forward, backward, AdamW), 5;
- ``small_chain``: ``sum(exp(x) - x * 2.0 + 1.0, axis=0)`` of a 4096 x 64
  f32 array, 200 calls (host-bound by its size);
- ``small_dense``: ``nn.functional.dense`` 256 x 256 with bias and relu,
  200 calls.

Then one summary line: each variant's median of each path over its
processes, and the card's name and power limit.

    python3 tools/measure_fusion_host.py PARENT TREE [--rounds 1]

Run from the repository root on a machine with a CUDA card; PARENT is a
directory holding another commit's ``heat_tpu_torch`` (``git archive``
unpacked under ``build/``).
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

CHILD = r"""
import json, statistics, sys, time
import numpy as np
import torch
import heat_tpu_torch as ht

try:
    from heat_tpu_torch.core import fusion
except ImportError:
    fusion = None

dev = "cuda"
ht.use_device("gpu")


def sync_read(out):
    # a deferred result computes at its first read
    for o in out if isinstance(out, tuple) else (out,):
        if isinstance(o, ht.DNDarray):
            o.larray
    torch.cuda.synchronize()


def timed(fn, n):
    fn_out = fn()
    sync_read(fn_out)  # warm-up
    before = fusion.stats() if fusion is not None else None
    walls = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        sync_read(fn())
        walls.append((time.perf_counter() - t) * 1e3)
    q1, _, q3 = statistics.quantiles(walls, n=4)
    row = {"ms": statistics.median(walls), "q1": q1, "q3": q3}
    if fusion is not None:
        after = fusion.stats()
        row["deferred"] = (after["deferred"] - before["deferred"]) / n
        row["flushes"] = (after["flushes"] - before["flushes"]) / n
    return row


rows = {}
ht.random.seed(0)
base = ht.random.randn(8192, 32, dtype=ht.float32, split=0)
ids = ht.random.randint(0, 8, (8192, 1))
pts = base + ids.astype(ht.float32) * 8.0
sp = ht.cluster.Spectral(n_clusters=8, gamma=0.05, n_lanczos=64)
L = sp._laplacian.construct(pts)
rows["lanczos"] = timed(lambda: ht.linalg.lanczos(L, 64), 5)
rows["spectral"] = timed(lambda: ht.cluster.Spectral(n_clusters=8, gamma=0.05,
                                                     n_lanczos=64).fit(pts).labels_, 3)

gen = torch.Generator(device=dev).manual_seed(5)
m = torch.randn((4096, 4096), generator=gen, device=dev)
A = ht.array(m @ m.T / 4096 + torch.eye(4096, device=dev), split=0)
B = ht.array(torch.randn((4096,), generator=gen, device=dev))
x0 = ht.zeros(4096)
rows["cg"] = timed(lambda: ht.linalg.cg(A, B, x0), 5)
del m, A, B

ht.random.seed(0)
xk = ht.random.randn(1_000_000, 64, dtype=ht.float32, split=0)
rows["kmeans"] = timed(lambda: ht.cluster.KMeans(n_clusters=8, init="random", max_iter=10,
                                                 tol=0.0, random_state=0).fit(xk).cluster_centers_,
                       3)
del xk

ht.random.seed(0)
xl = ht.random.randn(2_000_000, 64, dtype=ht.float32, split=0)
yl = ht.matmul(xl, ht.random.randn(64, 1, dtype=ht.float32))
rows["lasso"] = timed(lambda: ht.regression.Lasso(lam=0.01, max_iter=50, tol=0.0)
                      .fit(xl, yl).coef_, 3)
del xl, yl

cfg = dict(vocab_size=32768, d_model=1024, num_heads=16, num_layers=12, max_len=1024,
           mlp_ratio=4.0, device=dev, attn_impl="flash", dtype=torch.bfloat16, remat=True,
           flash_bwd_impl="two_pass")
tokens = torch.from_numpy(np.random.default_rng(2).integers(0, 32768, (8, 1024))).to(dev)


def lm_loss(model, t):
    logits = model(t)
    return torch.nn.functional.cross_entropy(logits[:, :-1].float().reshape(-1, 32768),
                                             t[:, 1:].reshape(-1))


model = ht.nn.TransformerLM(**cfg, generator=torch.Generator(device=dev).manual_seed(0))
opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
dpo = ht.optim.DataParallelOptimizer(opt, blocking=True)
dp = ht.nn.DataParallel(model, optimizer=dpo, blocking_parameter_updates=True)
step = dp.make_train_step(lm_loss)
state = dpo.init(model)
rows["dp_step"] = timed(lambda: step(model, state, *dp.shard_batch(tokens))[2].item(), 5)


def plain_step():
    opt.zero_grad(set_to_none=True)
    loss = lm_loss(model, tokens)
    loss.backward()
    opt.step()
    return loss.item()


rows["train_step"] = timed(plain_step, 5)
del model, opt, dpo, dp, state

xs = ht.array(torch.randn((4096, 64), generator=gen, device=dev), split=0)
rows["small_chain"] = timed(lambda: ht.sum(ht.exp(xs) - xs * 2.0 + 1.0, axis=0), 200)
xd = ht.array(torch.randn((256, 256), generator=gen, device=dev))
wd = ht.array(torch.randn((256, 256), generator=gen, device=dev))
bd = ht.array(torch.randn((256,), generator=gen, device=dev))
rows["small_dense"] = timed(lambda: ht.nn.functional.dense(xd, wd, bias=bd, activation="relu"),
                            200)
print(json.dumps({"variant": sys.argv[1], "package": ht.__file__, "paths": rows}), flush=True)
"""


def run(variant: str, tree: str, fusion) -> dict:
    # from inside the tree: `python -c` puts its working directory first
    # on sys.path, ahead of PYTHONPATH
    root = os.path.abspath(tree)
    env = dict(os.environ, PYTHONPATH=root)
    env.pop("HEAT_TPU_FUSION", None)
    if fusion is not None:
        env["HEAT_TPU_FUSION"] = fusion
    out = subprocess.run([sys.executable, "-c", CHILD, variant], env=env, cwd=root,
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        sys.stderr.write(out.stderr[-4000:])
        raise SystemExit(f"{variant}: exit {out.returncode}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parent")
    ap.add_argument("tree")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    variants = {"parent": (args.parent, None), "eager": (args.tree, "0"),
                "fused": (args.tree, "1")}
    rows = []
    for _ in range(args.rounds):
        for name in ("parent", "eager", "fused", "fused", "eager", "parent"):
            rows.append(run(name, *variants[name]))
            print(json.dumps(rows[-1]), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    summary = {"nvidia_smi": smi}
    for name in variants:
        mine = [r["paths"] for r in rows if r["variant"] == name]
        summary[name] = {p: statistics.median(r[p]["ms"] for r in mine) for p in mine[0]}
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
