"""The readings that a cell's limits are set from (not run by the benchmark).

    python3 perfbench/calibrate.py --workload <name> --seed <first> --seconds <s> \\
        --seeds 12 --controls 3

For each of ``--seeds`` seeds from ``--seed`` on, one run of the cell with a
window of ``--seconds`` (its set-up, window and comparison, as the benchmark
runs them), and its compared numbers; then, on the first ``--controls`` of
those seeds, a run with the control in the program's place (the reference
computed in TF32, at the cell's own size, through the same window and judge:
``correct`` has to come out false). All in one process (one per card), so
the kernels are built and loaded once. One JSON line a reading, then a
summary: each number's largest program reading and smallest control
reading.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import harness, run  # noqa: E402

EXTRA = (("--seeds", {"type": int, "default": 12}), ("--controls", {"type": int, "default": 3}))


def readings(args, cell, rank: int, world: int) -> None:
    seeds = [args.seed + i for i in range(args.seeds)]
    program, control = {}, {}
    runs = [(s, False) for s in seeds] + [(s, True) for s in seeds[:args.controls]]
    for s, is_control in runs:
        out = harness.run_rank(cell, s, args.seconds, False, rank, world, args.device,
                               control=is_control)
        if out is not None:
            checks = {k: v["value"] for k, v in out["checks"].items()}
            for k, v in checks.items():
                (control if is_control else program).setdefault(k, []).append(v)
            print(json.dumps({"seed": s, "control" if is_control else "program": checks,
                              "correct": out["correct"], "ops": out["attempted"],
                              "metrics": out["metrics"]}), flush=True)
    if rank == 0:
        # a reading that is no number (None, nan) is a failure: the largest
        # for the program, and it sets no smallest for the control
        worst = lambda v: float("inf") if v is None or v != v else v  # noqa: E731
        print(json.dumps({"summary": {k: {
            "program_max": max(map(worst, program[k])),
            "control_min": min((worst(v) for v in control.get(k, []) if worst(v) < float("inf")),
                               default=None)} for k in program}}), flush=True)


def main(argv=None) -> int:
    args = run.parse(argv, EXTRA)
    if args.rank is not None:
        harness.join(args.rank, args.world, args.port, args.device, run.THREADS)
        import torch.distributed as dist

        try:
            readings(args, run.cell_of(args), args.rank, args.world)
        finally:
            dist.destroy_process_group()
        return 0
    cell = run.check_cards(args)
    if cell is None:
        return 2
    if cell["chips"] == 1:
        readings(args, cell, 0, 1)
        return 0
    world = cell["chips"]
    argv_ranks = run.rank_argv(args, __file__, world, harness.free_port()) + [
        "--seeds", str(args.seeds), "--controls", str(args.controls)]
    lines = harness.launch(argv_ranks, world, 3000.0)
    if lines is None:
        return 1
    sys.stdout.write("".join(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
