#!/usr/bin/env python3
"""Host-bound paths of the port timed on a parent tree and on this tree, in
turns on one card: what routing the program sites through the registry
(``core/program_cache.cached_program``) costs where the host, not the card,
sets the time.

Two variants, each in a fresh process: ``parent`` (the tree PARENT) and
``change`` (the tree TREE), in the order parent, change, change, parent
for each round. Each process warms every path once and then times it, with
the card synchronized before and after each call, and prints one JSON
line: the median wall of each path in ms with its quartiles. The paths:

- ``registry_call_us``: one hit of ``cached_program`` with an inline
  program around an identity function on a 0-d card tensor, less the
  direct call, in microseconds (20,000 calls; on either tree);
- ``take``: ``x[idx]`` of a 4096 x 64 f32 array split along its rows by
  512 indices (site ``sharded_take``), 500 calls;
- ``resplit``: ``resplit(x, 1)`` of the same array (site ``relayout``),
  500 calls;
- ``take_registry_us`` and ``resplit_registry_us`` (this tree only): the
  take's median wall less that of the same take with its program's body
  called without the registry, and the resplit's registry call (lookup
  and program) less its body called alone, calls alternating in one
  process, in microseconds (2,000 pairs): the registry's cost at the site,
  free of the spread between processes;
- ``cg``: ``linalg.cg`` on a 4096^2 s.p.d. f32 system (sites ``cg``,
  ``cg_init``), 5 calls;
- ``lasso``: chip_smoke.py's lasso row, ``regression.Lasso(lam=0.01,
  max_iter=200, tol=0)`` over 2,000,000 x 64 (site ``streaming.lasso``),
  3 fits;
- ``lasso_path``: fits at the penalties 0.1, 0.03 and 0.01, 20 epochs
  each, on the same design: one call is the three fits, 3 calls;
- ``dp_step``: one blocking ``nn.DataParallel`` step of bench.py's lm_step
  model at full width (12 layers, d 1024, bf16, flash, remat) on 8 x 1024
  tokens with AdamW (sites ``dp_train_step``, ``dp_optimizer_step``), 5;
- ``daso_epoch``: 16 steps of ``optim.DASO`` over the classifier of
  examples/nn/daso_training.py at its sizes (sites ``daso_step``,
  ``daso_send``, ``daso_merge``), 5 calls.

Then one summary line: each variant's median of each path over its
processes, and the card's name and power limit.

    python3 tools/measure_registry_host.py PARENT TREE [--rounds 1]

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
import torch.nn.functional as F
import heat_tpu_torch as ht
from heat_tpu_torch.core import program_cache

dev = "cuda"
ht.use_device("gpu")


def sync_read(out):
    for o in out if isinstance(out, tuple) else (out,):
        if isinstance(o, ht.DNDarray):
            o.larray
    torch.cuda.synchronize()


def timed(fn, n):
    sync_read(fn())  # warm-up
    walls = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        sync_read(fn())
        walls.append((time.perf_counter() - t) * 1e3)
    q1, _, q3 = statistics.quantiles(walls, n=4)
    return {"ms": statistics.median(walls), "q1": q1, "q3": q3}


rows = {}


def ident(t):
    return t


z = torch.zeros((), device=dev)
program_cache.cached_program("measure.noop", (), lambda: ident, inline=True)(z)
calls = 20000
best = []
for _ in range(5):
    t = time.perf_counter()
    for _ in range(calls):
        program_cache.cached_program("measure.noop", (), lambda: ident, inline=True)(z)
    via = time.perf_counter() - t
    t = time.perf_counter()
    for _ in range(calls):
        ident(z)
    direct = time.perf_counter() - t
    best.append((via - direct) / calls * 1e6)
rows["registry_call_us"] = {"us": statistics.median(best), "min": min(best), "max": max(best)}

gen = torch.Generator(device=dev).manual_seed(5)
xs = ht.array(torch.randn((4096, 64), generator=gen, device=dev), split=0)
idx = torch.randint(0, 4096, (512,), generator=gen, device=dev)
rows["take"] = timed(lambda: xs[idx], 500)
rows["resplit"] = timed(lambda: xs.resplit(1), 500)


def paired(via, direct, n=2000):
    # alternate the two calls so that both see the same host
    sync_read(via())
    sync_read(direct())
    a, b = [], []
    for _ in range(n):
        for fn, out in ((via, a), (direct, b)):
            torch.cuda.synchronize()
            t = time.perf_counter()
            sync_read(fn())
            out.append((time.perf_counter() - t) * 1e6)
    return {"us": statistics.median(a) - statistics.median(b),
            "registry_us": statistics.median(a), "direct_us": statistics.median(b)}


try:
    from heat_tpu_torch.core.dndarray import DNDarray, _relayout_program
    from heat_tpu_torch.core.indexing import _advanced_take, _check_bounds, _take_program
except ImportError:  # a tree before the registry took these sites
    _take_program = None
if _take_program is not None:
    def take_direct():
        i = _check_bounds(idx, 4096, 0)
        gshape = (i.shape[0], 64)
        data = _take_program(xs.larray, i, 0, xs.split, 4096, gshape, xs.comm)
        return DNDarray(data, gshape, xs.dtype, xs.split, xs.device, xs.comm, True)

    rows["take_registry_us"] = paired(lambda: _advanced_take(xs, 0, idx), take_direct)
    rows["resplit_registry_us"] = paired(
        lambda: program_cache.cached_program(
            "relayout", (xs.shape, xs.dtype, xs.split, 1), lambda: _relayout_program,
            comm=xs.comm, inline=True)(xs, 1),
        lambda: _relayout_program(xs, 1))

m = torch.randn((4096, 4096), generator=gen, device=dev)
A = ht.array(m @ m.T / 4096 + torch.eye(4096, device=dev), split=0)
B = ht.array(torch.randn((4096,), generator=gen, device=dev))
x0 = ht.zeros(4096)
rows["cg"] = timed(lambda: ht.linalg.cg(A, B, x0), 5)
del m, A, B

ht.random.seed(0)
xl = ht.random.randn(2_000_000, 64, dtype=ht.float32, split=0)
yl = ht.matmul(xl, ht.random.randn(64, 1, dtype=ht.float32))
rows["lasso"] = timed(lambda: ht.regression.Lasso(lam=0.01, max_iter=200, tol=0.0)
                      .fit(xl, yl).coef_, 3)
rows["lasso_path"] = timed(lambda: tuple(
    ht.regression.Lasso(lam=lam, max_iter=20, tol=0.0).fit(xl, yl).coef_
    for lam in (0.1, 0.03, 0.01)), 3)
del xl, yl

cfg = dict(vocab_size=32768, d_model=1024, num_heads=16, num_layers=12, max_len=1024,
           mlp_ratio=4.0, device=dev, attn_impl="flash", dtype=torch.bfloat16, remat=True,
           flash_bwd_impl="two_pass")
tokens = torch.from_numpy(np.random.default_rng(2).integers(0, 32768, (8, 1024))).to(dev)


def lm_loss(model, t):
    logits = model(t)
    return F.cross_entropy(logits[:, :-1].float().reshape(-1, 32768), t[:, 1:].reshape(-1))


model = ht.nn.TransformerLM(**cfg, generator=torch.Generator(device=dev).manual_seed(0))
opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
dpo = ht.optim.DataParallelOptimizer(opt, blocking=True)
dp = ht.nn.DataParallel(model, optimizer=dpo, blocking_parameter_updates=True)
step = dp.make_train_step(lm_loss)
state = dpo.init(model)
rows["dp_step"] = timed(lambda: step(model, state, *dp.shard_batch(tokens))[2].item(), 5)
del model, opt, dpo, dp, state

n_classes, d_in, d_hidden, per_epoch, bs = 10, 64, 64, 16, 128
rng = np.random.default_rng(42)
protos = rng.standard_normal((n_classes, d_in)).astype(np.float32)
labels = rng.integers(0, n_classes, per_epoch * bs)
feats = protos[labels] + 0.4 * rng.standard_normal((per_epoch * bs, d_in)).astype(np.float32)
xd, yd = torch.from_numpy(feats).to(dev), torch.from_numpy(labels).to(dev)


class Classifier(torch.nn.Module):
    def __init__(self):
        super().__init__()
        r = np.random.default_rng(0)
        self.w1 = torch.nn.Parameter(torch.from_numpy(
            r.standard_normal((d_in, d_hidden)).astype(np.float32) * 0.1).to(dev))
        self.b1 = torch.nn.Parameter(torch.zeros(d_hidden, device=dev))
        self.w2 = torch.nn.Parameter(torch.from_numpy(
            r.standard_normal((d_hidden, n_classes)).astype(np.float32) * 0.1).to(dev))
        self.b2 = torch.nn.Parameter(torch.zeros(n_classes, device=dev))

    def forward(self, x):
        return torch.relu(x @ self.w1 + self.b1) @ self.w2 + self.b2


clf = Classifier()
daso = ht.optim.DASO(torch.optim.Adam(clf.parameters(), lr=2e-3), total_epochs=1000,
                     warmup_epochs=2, cooldown_epochs=2, max_global_skips=4)
daso.set_loss(lambda model, xb, yb: F.cross_entropy(model(xb), yb))
daso.last_batch = per_epoch - 1
carry = {"params": daso.stack_params(clf)}
carry["state"] = daso.init(carry["params"])


def daso_epoch():
    loss = None
    for i in range(per_epoch):
        lo = i * bs
        carry["params"], carry["state"], loss = daso.step(
            carry["params"], carry["state"], (xd[lo:lo + bs], yd[lo:lo + bs]))
    return float(loss)


rows["daso_epoch"] = timed(daso_epoch, 5)
print(json.dumps({"variant": sys.argv[1], "package": ht.__file__, "paths": rows}), flush=True)
"""


def run(variant: str, tree: str) -> dict:
    # from inside the tree: `python -c` puts its working directory first
    # on sys.path, ahead of PYTHONPATH
    root = os.path.abspath(tree)
    env = dict(os.environ, PYTHONPATH=root)
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
    trees = {"parent": args.parent, "change": args.tree}
    rows = []
    for _ in range(args.rounds):
        for name in ("parent", "change", "change", "parent"):
            rows.append(run(name, trees[name]))
            print(json.dumps(rows[-1]), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    summary = {"nvidia_smi": smi}
    for name in trees:
        mine = [r["paths"] for r in rows if r["variant"] == name]
        summary[name] = {p: statistics.median(r[p].get("ms", r[p].get("us")) for r in mine)
                         for p in mine[0]}
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
