"""The program's own spans in a traced window.

Under ``torch.profiler`` every ``heat_tpu_torch.telemetry`` span is a profiler
range named ``htt.<span name>``, on the clock of the card's activities. This
reads them from the same Chrome trace that ``trace.py`` reads, cut to the same
``perfbench_window`` annotation, and gives for each span name:

* ``count``: the ranges that start in the window;
* ``host_s``: their host seconds, and ``self_s``: those less the part that
  the ``htt.*`` ranges directly inside them cover;
* ``device_s``: the device seconds of the activities launched (matched by
  correlation) while a range of this name was the innermost ``htt.*`` range
  on the launching thread;
* ``idle_s``: the seconds of the window's idle gaps on the card (as
  ``trace.py`` finds them) put down to this name: a gap, where it overlaps
  the ranges of the thread that launched the activity ending it, goes to the
  innermost range open at each moment;
* ``device_all_s`` and ``idle_all_s``: the same for a range together with
  every range inside it.

A program without such spans gives ``{}``.

Run as a script, it runs one traced cell, or one rank of it, through
``run.py`` in this process and writes the window's span summary to a file:

    python3 perfbench/spans.py <out.json> --workload <name> --seed <n> --seconds <s> --trace 1

A cell on several cards needs each rank started this way by hand, with
``--world <cards> --port <free port> --rank <r>`` and an output file a rank.
"""

from __future__ import annotations

import bisect
import json
import sys
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, List, Optional

if __name__ == "__main__":  # run as a script: the checkout's root on the path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench.trace import DEVICE_CATS, WINDOW, clean  # noqa: E402

PREFIX = "htt."
FIELDS = ("count", "host_s", "self_s", "device_s", "device_all_s", "idle_s", "idle_all_s")


class _Node:
    """One range: its interval (us), name, the range around it, and the
    time its direct children cover (``inner_us``)."""

    __slots__ = ("start", "end", "name", "parent", "inner_us")

    def __init__(self, start: float, end: float, name: str, parent: Optional["_Node"]):
        self.start, self.end, self.name, self.parent = start, end, name, parent
        self.inner_us = 0.0

    def names(self) -> set:
        """Its name and those of the ranges around it."""
        out, r = set(), self
        while r is not None:
            out.add(r.name)
            r = r.parent
        return out


def _nest(spans: List[tuple]):
    """One thread's ranges, nested as entered: the ranges, and the
    (start, end, innermost range) segments in time order (time outside
    every range has none)."""
    spans.sort(key=lambda r: (r[0], -r[1]))
    ranges: List[_Node] = []
    segs: List[tuple] = []
    stack: List[_Node] = []
    cursor = 0.0

    def close_until(t: float) -> None:
        nonlocal cursor
        while stack and stack[-1].end <= t:
            top = stack.pop()
            if top.end > cursor:
                segs.append((cursor, top.end, top))
            cursor = top.end

    for s, t, name in spans:
        close_until(s)
        parent = stack[-1] if stack else None
        if parent is not None:
            t = min(t, parent.end)
            if s > cursor:
                segs.append((cursor, s, parent))
            parent.inner_us += t - s
        r = _Node(s, t, name, parent)
        ranges.append(r)
        stack.append(r)
        cursor = s
    close_until(float("inf"))
    return ranges, segs


def summarize(trace: Dict[str, Any]) -> Dict[str, Dict[str, float]]:
    """Each span name's numbers (module docstring), in seconds, within the
    window annotation."""
    events = [e for e in trace.get("traceEvents", []) if isinstance(e, dict) and e.get("ph") == "X"]
    marks = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
    if not marks:
        raise ValueError(f"the trace has no {WINDOW!r} annotation")
    w0 = float(marks[0]["ts"])
    w1 = w0 + float(marks[0]["dur"])

    by_thread: Dict[Any, List[tuple]] = defaultdict(list)
    for e in events:
        name = e.get("name", "")
        if e.get("cat") in ("cpu_op", "user_annotation") and name.startswith(PREFIX):
            s = float(e["ts"])
            if w0 <= s <= w1:
                by_thread[e.get("tid")].append(
                    (s, min(s + float(e.get("dur", 0.0)), w1), clean(name[len(PREFIX):])))
    if not by_thread:
        return {}
    out: Dict[str, Dict[str, float]] = defaultdict(lambda: dict.fromkeys(FIELDS, 0.0))
    segs, starts = {}, {}
    for tid, spans in by_thread.items():
        ranges, segs[tid] = _nest(spans)
        starts[tid] = [g[0] for g in segs[tid]]
        for r in ranges:
            row = out[r.name]
            row["count"] += 1
            row["host_s"] += (r.end - r.start) * 1e-6
            row["self_s"] += (r.end - r.start - r.inner_us) * 1e-6

    def put(r: _Node, us: float, what: str) -> None:
        out[r.name][what + "_s"] += us * 1e-6
        for name in r.names():
            out[name][what + "_all_s"] += us * 1e-6

    def at(tid, ts: float) -> Optional[_Node]:
        # the innermost range on thread tid open at ts
        ss = segs.get(tid)
        if not ss:
            return None
        i = bisect.bisect_right(starts[tid], ts) - 1
        return ss[i][2] if i >= 0 and ts < ss[i][1] else None

    launches = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = e
    device = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s, d = float(e["ts"]), float(e.get("dur", 0.0))
        if s + d <= w0 or s >= w1:
            continue
        device.append((max(s, w0), min(s + d, w1), launches.get((e.get("args") or {}).get(
            "correlation"))))
    device.sort(key=lambda t: t[0])

    cursor = w0
    for s, t, launch in device:
        if launch is not None:
            r = at(launch.get("tid"), float(launch["ts"]))
            if r is not None:
                put(r, t - s, "device")
            if s > cursor:
                _idle(segs.get(launch.get("tid")) or [], starts.get(launch.get("tid")) or [],
                      cursor, s, put)
        cursor = max(cursor, t)
    return {k: dict(v) for k, v in sorted(out.items())}


def _idle(segs: List[tuple], starts: List[float], g0: float, g1: float, put) -> None:
    """Put the gap [g0, g1) down to the innermost range of each moment."""
    i = max(0, bisect.bisect_right(starts, g0) - 1)
    while i < len(segs) and segs[i][0] < g1:
        s, t, r = segs[i]
        over = min(t, g1) - max(s, g0)
        if over > 0:
            put(r, over, "idle")
        i += 1


def main(argv: List[str]) -> int:
    """Run ``run.py`` with ``argv[1:]`` here, summarizing the traced
    window's spans into the file ``argv[0]`` as the run exports its trace."""
    from perfbench import run
    from perfbench import trace as tracing

    out = Path(argv[0])
    export = tracing.export

    def export_and_summarize(prof):
        trace = export(prof)
        out.write_text(json.dumps(summarize(trace), indent=1))
        return trace

    tracing.export = export_and_summarize
    code = run.main(argv[1:])
    if code == 0 and not out.exists():
        print("perfbench/spans.py: no traced window in this process (--trace 1; a cell on "
              "several cards needs --world, --port and --rank)", file=sys.stderr)
        return 2
    return code


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
