#!/usr/bin/env python3
"""The KMeans stage's seeding on the card: the threefry draw against the
host draw it replaced, timed in turns in one process.

``KMeans(init='random')`` picks its first rows as the JAX package does
(``choice(PRNGKey(random_state), n, (k,), replace=False)``: threefry sort
keys and two stable sorts of the row indices on the card). Before, the port
drew them with a host ``torch.randperm`` from a ``torch.Generator`` seeded
with ``random_state``; that draw is replayed here for comparison only.

On the array path's KMeans input (``chip_smoke.py``'s third draw from seed
0: ``randn(2_000_000, 64)``, k = 64, ``random_state=1``) it times, after a
warm-up, the draw alone and the whole stage (draw and a 50-pass fit, tol
0) in the order new, old, old, new, and prints one JSON line with the wall
times in milliseconds, the card's name and its power limit.

    python3 tools/measure_kmeans_seeding.py

Run from the repository root on a machine with a CUDA card.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import heat_tpu_torch as ht  # noqa: E402

N_ROWS, D, K, SEED = 2_000_000, 64, 64, 1


def host_draw(x):
    """The rows the port drew before: a host randperm's first k."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(SEED)
    idx = torch.randperm(N_ROWS, generator=gen)[:K].to(x.larray.device)
    return ht.array(x.larray[idx].clone())


def wall_ms(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    ht.random.set_state(("Threefry", 0, 2, 0, 0.0))  # chip_smoke.py's KMeans input
    x = ht.random.randn(N_ROWS, D, split=0)
    est = ht.cluster.KMeans(n_clusters=K, init="random", random_state=SEED)
    draws = {"threefry": lambda: est._initialize_cluster_centers(x),
             "host_randperm": lambda: host_draw(x)}

    def stage(which):
        init = "random" if which == "threefry" else host_draw(x)
        ht.cluster.KMeans(n_clusters=K, init=init, max_iter=50, tol=0.0,
                          random_state=SEED).fit(x)

    for which in draws:  # warm-up: builds, caches, the first fit
        wall_ms(draws[which])
        wall_ms(lambda: stage(which))
    draw_ms = {which: [] for which in draws}
    stage_ms = {which: [] for which in draws}
    for which in ("threefry", "host_randperm", "host_randperm", "threefry"):
        draw_ms[which].append(wall_ms(draws[which]))
        stage_ms[which].append(wall_ms(lambda: stage(which)))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"draw_ms": draw_ms, "stage_ms": stage_ms,
                      "card": card.strip().splitlines()[0]}))


if __name__ == "__main__":
    main()
