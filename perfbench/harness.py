"""Run one cell once and reduce it to the result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``: a configuration
(``configs/<config>.json``) under a traffic mix (``traffic/<traffic>.json``)
on 1 or 4 cards, with the limits of its comparison in
``workloads/<name>.json``. Its metrics are the entries of ``end_to_end``
(``--trace 0``) or ``per_layer`` (``--trace 1``) that list it, or list no
cells; each is read by the reader of its quantity under ``metrics/``
(``reader_path``). The traffic names its op, the class ``Op`` of
``ops/<op>.py`` (``generator.make_op``). Nothing here names a cell, an op
or a metric.

A run: make the inputs from the seed, warm up with one op, then a window of
``--seconds``, then judge the last op's result with the plain reference.
``closed`` traffic waits for each op (``torch.cuda.synchronize()``) and
times it; ``back_to_back`` traffic dispatches ops with no host wait between
them, and the ranks agree to stop, with one small all-reduce, only at a
check every N ops (N fixed at warm-up to about ``stop_check_s``).
"""

from __future__ import annotations

import importlib.util
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "heat_tpu")
CARD_QUERY = "index,name,pci.bus_id,clocks.sm,power.draw,power.limit,temperature.gpu"


class CellError(ValueError):
    """A cell, configuration, traffic or limit that the files do not define."""


def _json(path: Path) -> Dict[str, Any]:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        raise CellError(f"{path.relative_to(ROOT)} is missing") from None


def load_cell(name: str, bench_path: Optional[Path] = None) -> Dict[str, Any]:
    """Everything a run of cell ``name`` reads from the files: its entry,
    configuration, traffic, limits and metric entries."""
    bench = _json(bench_path or ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise CellError(f"no workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    if cell["config"] not in configs:
        raise CellError(f"workload {name!r} names the unknown configuration {cell['config']!r}")

    def mine(entries):
        return [m for m in entries if name in m.get("workloads", [name])]

    return {
        "name": name,
        "chips": int(cell["chips"]),
        "config": _json(ROOT / configs[cell["config"]]["file"]),
        "traffic": _json(PKG / "traffic" / f"{cell['traffic']}.json"),
        "limits": _json(PKG / "workloads" / f"{name}.json")["limits"],
        "end_to_end": mine(bench["end_to_end"]),
        "per_layer": mine(bench["per_layer"]),
    }


def reader_path(metric: str) -> Path:
    """The reader of ``metric``: the first of ``metrics/<metric>.py``, the
    name before its first dot (``op_ms.x4`` is read as ``op_ms``: the
    qualifier names the cell, not the quantity), and that name without its
    leading words (``cdist_roofline`` is read as ``roofline``: the word
    names the kernel) that exists."""
    base = metric.split(".")[0]
    words = base.split("_")
    for name in [metric] + ["_".join(words[i:]) for i in range(len(words))]:
        path = PKG / "metrics" / f"{name}.py"
        if name and path.exists():
            return path
    raise CellError(f"metric {metric!r} has no reader under {(PKG / 'metrics').relative_to(ROOT)}")


def reader(metric: str):
    """The ``read`` function of the reader of ``metric``."""
    path = reader_path(metric)
    spec = importlib.util.spec_from_file_location("perfbench_metric_" + path.stem.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Modules whose top-level name is JAX's or the JAX package's (the
    whole name before the first dot, so ``heat_tpu_torch`` is not one)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def cards() -> List[Dict[str, str]]:
    """Every card's name, SM clock, power draw and limit and temperature
    from ``nvidia-smi``; [] where it cannot be asked."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={CARD_QUERY}",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    keys = CARD_QUERY.split(",")
    return [dict(zip(keys, (v.strip() for v in line.split(",")))) for line in out.splitlines()
            if line.strip()]


def join(rank: int, world: int, port: int, device: str, threads: int) -> None:
    """Make this process rank ``rank`` of ``world``: its share of the host's
    cores, its card, and the process group over localhost:``port``."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    torch.set_num_threads(threads)
    cores = sorted(os.sched_getaffinity(0))
    share = max(1, len(cores) // world)
    mine = cores[rank * share:(rank + 1) * share]
    if mine:
        os.sched_setaffinity(0, mine)
    backend = "gloo"
    if device == "cuda":
        torch.cuda.set_device(rank)
        backend = "nccl"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=180))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(argv: List[str], world: int, timeout_s: float) -> Optional[List[str]]:
    """Run ``argv + ["--rank", r]`` for every rank and wait for all of them
    (a rank that fails, or the time limit, ends the others). Returns rank
    0's standard output lines, or None where a rank failed."""
    procs: List[subprocess.Popen] = []
    lines: List[str] = []
    drain = None
    try:
        for r in range(world):
            procs.append(subprocess.Popen(argv + ["--rank", str(r)], cwd=ROOT,
                                          stdout=subprocess.PIPE if r == 0 else sys.stderr,
                                          text=True))
        drain = threading.Thread(target=lambda: lines.extend(procs[0].stdout), daemon=True)
        drain.start()
        deadline = time.time() + timeout_s
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.time() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        if drain is not None:
            drain.join(timeout=10)
    codes = [p.returncode for p in procs]
    if any(codes):
        print(f"perfbench: rank exit codes {codes}", file=sys.stderr)
        return None
    return lines


def _finite(v: float) -> Optional[float]:
    return v if v == v and v not in (float("inf"), float("-inf")) else None


def run_rank(cell: Dict[str, Any], seed: int, seconds: float, trace: bool, rank: int = 0,
             world: int = 1, device: str = "cuda", t_start: Optional[float] = None,
             control: bool = False) -> Optional[Dict[str, Any]]:
    """One rank's run of ``cell`` (the process group, where ``world`` > 1,
    is already up). Returns rank 0's result dict, with ``checks`` last, and
    None on the other ranks. With ``control`` the reference in TF32 stands
    in for the program (``generator.Op``): the same window and judge, which
    have to find it not correct; the benchmark's own runs never do this."""
    import gc

    import torch
    import torch.distributed as dist

    import heat_tpu_torch as ht
    from heat_tpu_torch.core import program_cache
    from perfbench import generator
    from perfbench import trace as tracing
    from perfbench.roofline import counts

    t_start = time.time() if t_start is None else t_start
    on_card = device == "cuda"
    dev = torch.device("cuda", torch.cuda.current_device()) if on_card else torch.device("cpu")
    if not on_card:
        ht.use_device("cpu")
    ht.use_comm(None)
    comm = ht.get_comm()
    if comm.size != world:
        raise RuntimeError(f"the communicator has {comm.size} ranks, the cell {world}")
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    def barrier():
        if world > 1:
            t = torch.ones(1, device=dev)
            dist.all_reduce(t)
        sync()

    marks = [("enter", time.time())]
    op = generator.make_op(ht, cell["config"], cell["traffic"], seed, dev, comm, control)
    sync()
    marks.append(("inputs", time.time()))
    result = op()  # warm-up: builds, loads, the allocator's blocks
    sync()
    marks.append(("warm-up", time.time()))
    check_every = 0
    if op.loop == "back_to_back":
        result = None
        s = time.perf_counter()
        result = op()
        sync()
        per_op = time.perf_counter() - s
        n = torch.tensor([max(1, round(op.stop_check_s / max(per_op, 1e-6)))], device=dev)
        if world > 1:
            dist.all_reduce(n, op=dist.ReduceOp.MAX)
        check_every = int(n.item())
        marks.append(("timed op", time.time()))
    elif op.loop != "closed":
        raise CellError(f"unknown loop {op.loop!r}: 'closed' or 'back_to_back'")
    result = None
    before = cards() if rank == 0 and on_card else []
    marks.append(("cards", time.time()))
    prof = None
    if trace:
        # the profiler starts before the barrier, so that no rank's window
        # holds another rank's profiler start-up
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        prof = profile(activities=acts)
        prof.__enter__()
    marks.append(("profiler", time.time()))
    barrier()
    setup_s = time.time() - t_start
    marks.append(("barrier", time.time()))
    print(f"perfbench set-up, rank {rank}: " + ", ".join(
        f"{k} {t - t_start:.3f} s" for k, t in marks), file=sys.stderr, flush=True)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    misses0 = program_cache.stats()["misses"]
    if prof is not None:
        mark = record_function(tracing.WINDOW)
        mark.__enter__()
    walls: List[float] = []
    events: List[Any] = []
    spans: List[Any] = []  # closed loop: (start, end) events of each op
    collected = [[0, 0.0] for _ in range(3)]  # collections and seconds a generation
    began = [0.0]

    def on_gc(phase, info):
        if phase == "start":
            began[0] = time.perf_counter()
        else:
            collected[info["generation"]][0] += 1
            collected[info["generation"]][1] += time.perf_counter() - began[0]

    gc.callbacks.append(on_gc)
    ops = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    if op.loop == "closed":
        while True:
            if on_card:
                spans.append((torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True)))
            s = time.perf_counter()
            result = None  # one result at a time
            if on_card:
                spans[-1][0].record()
            result = op()
            if on_card:
                spans[-1][1].record()
            sync()
            e = time.perf_counter()
            walls.append(e - s)
            ops += 1
            if e >= deadline:
                break
    else:
        record = trace and on_card and rank == 0
        if record:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        while True:
            result = None
            result = op()
            ops += 1
            if record:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
            if ops % check_every == 0:
                stop = torch.tensor([1.0 if time.perf_counter() >= deadline else 0.0],
                                    device=dev)
                if world > 1:
                    dist.all_reduce(stop, op=dist.ReduceOp.MAX)
                if stop.item() > 0:
                    break
        sync()
    barrier()
    window_s = time.perf_counter() - t0
    gc.callbacks.remove(on_gc)
    if prof is not None:
        mark.__exit__(None, None, None)
        prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    misses = program_cache.stats()["misses"] - misses0
    after = cards() if rank == 0 and on_card else []
    event_op_s = [a.elapsed_time(b) / 1000.0 for a, b in zip(events, events[1:])]
    # where a window's time went, for a run that reads far off: the card's
    # time of each op (closed loop: from its first launch to its end) and
    # the host's garbage collections
    on_device = [a.elapsed_time(b) for a, b in spans]
    half = len(on_device) // 2
    print(f"perfbench window, rank {rank}: {ops} ops in {window_s:.3f} s"
          + (f"; card ms an op {sum(on_device) / len(on_device):.4f} (first half "
             f"{sum(on_device[:half]) / max(half, 1):.4f}, second "
             f"{sum(on_device[half:]) / max(len(on_device) - half, 1):.4f})" if on_device else "")
          + "; gc " + ", ".join(f"gen{g} {n} in {t:.4f} s" for g, (n, t) in enumerate(collected)),
          file=sys.stderr, flush=True)

    checks = op.judge(result)
    result = None
    mine = {
        "rank": rank,
        "peak": int(peak),
        "registry_misses": int(misses),
        "work": op.work(),
        "trace": tracing.summarize(tracing.export(prof)) if prof is not None else None,
        "forbidden": forbidden_modules(),
        "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
    }
    if world > 1:
        gathered = [None] * world
        dist.all_gather_object(gathered, mine)
    else:
        gathered = [mine]
    if rank != 0:
        return None

    rec = {
        "world": world,
        "ops": ops,
        "window_s": window_s,
        "op_walls": walls,
        "event_op_s": event_op_s,
        "setup_s": setup_s,
        "peak_bytes": max(g["peak"] for g in gathered),
        "ranks": gathered,
        "peaks": counts.peaks(mine["kind"]) if on_card else None,
    }
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell[kind]:
        v = reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    limits = cell["limits"]
    missing = sorted(set(checks) - set(limits))
    if missing:
        raise CellError(f"no limit for {missing} in workloads/{cell['name']}.json")
    correct = all(v <= limits[k] for k, v in checks.items())  # nan fails
    out = {
        "correct": correct,
        "attempted": ops,
        "failed": 0 if correct else 1,
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu", "kind": mine["kind"],
                   "count": world, "memory_peak_bytes": rec["peak_bytes"]},
    }
    ts = [g["trace"] for g in gathered if g["trace"]]
    if ts:
        out["device"]["busy_s"] = sum(t["busy_s"] for t in ts) / len(ts)
        out["device"]["window_s"] = sum(t["window_s"] for t in ts) / len(ts)
        out["breakdown"] = {"device_ops": ts[0]["device_ops"], "idle_gaps": ts[0]["idle_gaps"]}
    out["forbidden"] = sorted({m for g in gathered for m in g["forbidden"]})
    out["cards"] = {"start": before, "end": after}
    out["checks"] = {k: {"value": _finite(v), "limit": limits[k]} for k, v in checks.items()}
    return out


def emit(out: Dict[str, Any]) -> int:
    """Print a rank-0 result: the cards' readings on an earlier line, each
    compared number beside its limit as the last lines on standard error,
    and the result line last on standard output. Returns the exit code: not
    0, and no result, where a forbidden module was loaded."""
    found = sorted(set(out.pop("forbidden")) | set(forbidden_modules()))
    cardlines = out.pop("cards")
    if found:
        print(f"perfbench: the run loaded {found}: neither JAX nor the JAX package may run",
              file=sys.stderr)
        return 3
    print("perfbench cards " + json.dumps(cardlines), flush=True)
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
