"""A traced window, reduced to what the per-layer metrics read.

``torch.profiler`` records the window (CPU ops and the card's activity);
its Chrome trace is read back and cut to the ``perfbench_window``
annotation. Device time is every kernel, copy and fill on the card; the
busy time is the union of their intervals. An idle gap is a stretch of the
window in which nothing ran on the card, named by what the host was doing:
the innermost host op that launched the activity ending the gap, ``python``
where no op was running, or ``wait`` where that activity had been launched
before the gap began (launch latency, or a wait for another stream or
rank).
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from collections import defaultdict
from typing import Any, Dict, List

WINDOW = "perfbench_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def clean(name: str) -> str:
    """A name as the result line carries it: 64 letters, digits and ``_.:-``."""
    return re.sub(r"[^A-Za-z0-9_.:-]", "_", name)[:64]


def is_nccl(name: str) -> bool:
    return name.lower().startswith("nccl")


def export(prof) -> Dict[str, Any]:
    """The profiler's Chrome trace as a dict, through a file under TMPDIR
    that is removed again."""
    fd, path = tempfile.mkstemp(prefix="perfbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.unlink(path)


def summarize(trace: Dict[str, Any]) -> Dict[str, Any]:
    """Device time by name, NCCL time, kernel launches, busy and window
    seconds, and the idle gaps by what the host was doing, all within the
    window annotation."""
    events = [e for e in trace.get("traceEvents", []) if isinstance(e, dict) and e.get("ph") == "X"]
    marks = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
    if not marks:
        raise ValueError(f"the trace has no {WINDOW!r} annotation")
    w0 = float(marks[0]["ts"])
    w1 = w0 + float(marks[0]["dur"])
    device = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s, d = float(e["ts"]), float(e.get("dur", 0.0))
        if s + d <= w0 or s >= w1:
            continue
        device.append((max(s, w0), min(s + d, w1), e))
    device.sort(key=lambda t: t[0])

    by_name: Dict[str, float] = defaultdict(float)
    nccl_s = compute_s = 0.0
    kernels = 0
    for s, t, e in device:
        sec = (t - s) * 1e-6
        name = e.get("name", "?")
        by_name[clean(name)] += sec
        if is_nccl(name):
            nccl_s += sec
        else:
            compute_s += sec
        if e.get("cat") == "kernel":
            kernels += 1

    # the union of the device's intervals, and the gaps between them
    busy = 0.0
    gaps = []
    cursor = w0
    for s, t, e in device:
        if s > cursor:
            gaps.append((cursor, s, e))
        if t > cursor:
            busy += t - max(s, cursor)
            cursor = t
    if cursor < w1:
        gaps.append((cursor, w1, None))

    launches = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = e
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e.get("tid"),
                   e.get("name", "?")) for e in events
                  if e.get("cat") == "cpu_op" and w0 <= float(e["ts"]) <= w1)
    starts = [h[0] for h in host]

    def host_op(ts: float, tid) -> str:
        # the innermost (latest-starting) host op on the launching thread
        # that is running at ts
        i = bisect.bisect_right(starts, ts)
        for j in range(i - 1, max(-1, i - 400), -1):
            s, t, htid, name = host[j]
            if htid == tid and s <= ts <= t:
                return name
        return "python"

    idle: Dict[str, float] = defaultdict(float)
    for g0, g1, nxt in gaps:
        if nxt is None:
            label = "window_end"
        else:
            corr = (nxt.get("args") or {}).get("correlation")
            launch = launches.get(corr)
            if launch is None:
                what = "unknown"
            elif float(launch["ts"]) < g0:
                what = "wait"
            else:
                what = host_op(float(launch["ts"]), launch.get("tid"))
            label = f"{what} before {nxt.get('name', '?')}"
        idle[clean(label)] += (g1 - g0) * 1e-6

    window_s = (w1 - w0) * 1e-6
    return {
        "window_s": window_s,
        "busy_s": busy * 1e-6,
        "compute_s": compute_s,
        "nccl_s": nccl_s,
        "kernels": kernels,
        "device_ops": top(by_name),
        "idle_gaps": top(idle),
    }


def top(d: Dict[str, float], n: int = 10) -> List[List[Any]]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
