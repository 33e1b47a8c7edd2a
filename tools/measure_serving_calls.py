#!/usr/bin/env python3
"""Two trees of the port served in turns on the card: the in-process
serving burst and one program call, to compare a change of the serving
path with its parent on one card.

Each tree is a directory holding a ``heat_tpu_torch`` package (a checkout,
or a ``git archive`` of another commit unpacked under ``build/``). For
each round the trees run in the order a, b, b, a, each in a fresh process:
``Server(max_batch=64)`` with one ``kmeans_predict`` endpoint (16 centres
of 64 from ``default_rng(0)``, the exact form), warmed, then nine bursts
of 1024 requests of 16 x 64 submitted at once (the first two are not
kept: the first warms the host, the second carries the collector's
work of the first); then 800 calls of the 64-row program, each with one of
eight distinct host batches, as the server gives it a fresh tensor a batch.
Prints one JSON line a process (the package it imported, requests/s of
each kept burst, the median call in microseconds), then one summary line with the medians of each tree
and the card's name and power limit.

    python3 tools/measure_serving_calls.py TREE_A TREE_B [--rounds 4]

Run from the repository root on a machine with a CUDA card.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

CHILD = r"""
import json, sys, time
import numpy as np
import torch
import heat_tpu_torch
from heat_tpu_torch import serve

rng = np.random.default_rng(0)
centers = rng.standard_normal((16, 64)).astype(np.float32)
server = serve.Server(max_batch=64)
server.register("kmeans", serve.Endpoint("kmeans_predict", [centers], features=64,
                                         dtype=np.float32))
server.warmup()
payloads = [rng.standard_normal((16, 64)).astype(np.float32) for _ in range(1024)]
rates = []
for rep in range(9):
    t0 = time.perf_counter()
    futs = [server.submit("kmeans", p) for p in payloads]
    for f in futs:
        f.result(60)
    if rep >= 2:
        rates.append(1024 / (time.perf_counter() - t0))
ep = server.endpoints()["kmeans"]
prog = server._program("kmeans", ep, 64)
batches = [torch.from_numpy(np.concatenate(payloads[4 * i:4 * i + 4])) for i in range(8)]
for i in range(50):
    prog(batches[i % 8], *ep.params).cpu()
ts = []
for i in range(800):
    t0 = time.perf_counter()
    prog(batches[i % 8], *ep.params).cpu()
    ts.append(time.perf_counter() - t0)
server.close()
print(json.dumps({"tree": sys.argv[1], "package": heat_tpu_torch.__file__,
                  "requests_per_s": rates, "call_us_median": float(np.median(ts)) * 1e6}),
      flush=True)
"""


def run(tree: str) -> dict:
    # from inside the tree: `python -c` puts its working directory first
    # on sys.path, ahead of PYTHONPATH
    root = os.path.abspath(tree)
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", CHILD, tree], env=env, cwd=root, check=True,
                         capture_output=True, text=True, timeout=300)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("tree_a")
    ap.add_argument("tree_b")
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()
    rows = []
    for _ in range(args.rounds):
        for tree in (args.tree_a, args.tree_b, args.tree_b, args.tree_a):
            rows.append(run(tree))
            print(json.dumps(rows[-1]), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    summary = {"nvidia_smi": smi}
    for tree in (args.tree_a, args.tree_b):
        mine = [r for r in rows if r["tree"] == tree]
        per_process = [statistics.median(r["requests_per_s"]) for r in mine]
        summary[tree] = {
            "requests_per_s_median": statistics.median(
                [x for r in mine for x in r["requests_per_s"]]),
            "per_process_medians": per_process,
            "call_us_median": statistics.median([r["call_us_median"] for r in mine]),
        }
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
