"""Run one cell of the benchmark once, from the root of a checkout:

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

It prints the cards' readings, then one JSON result line last on standard
output (``harness.emit``). It exits with another code than 0, and prints no
result, where ``torch.cuda`` sees no card or fewer than the cell asks for, or
where JAX or the JAX package was loaded. A cell on several cards starts one
rank process per card itself; they meet over a free TCP port on localhost.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
THREADS = 2  # host threads a rank: four ranks stay within one host's cores
RANK_TIMEOUT_S = 340.0


def _environment() -> None:
    """Fixed cache directories inside the checkout, few host threads, and no
    JAX through a library that would load it by itself."""
    cache = ROOT / "build" / "perfbench"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(cache / "cuda"))
    os.environ.setdefault("OMP_NUM_THREADS", str(THREADS))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


_environment()
sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402


def parse(argv, extra=()):
    """The benchmark's arguments, and the hidden ones of a rank process."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    for name, kw in extra:
        p.add_argument(name, **kw)
    # a rank process of a cell on several cards, started by this script;
    # --device and --sizes only there, for tests on the CPU at small sizes.
    # --control 1 puts the reference in TF32 in the program's place, to see
    # the comparison find it not correct: never in a benchmark run
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--t-start", type=float, default=None, help=argparse.SUPPRESS)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"), help=argparse.SUPPRESS)
    p.add_argument("--sizes", default="{}", help=argparse.SUPPRESS)
    p.add_argument("--control", type=int, choices=(0, 1), default=0, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def cell_of(args):
    cell = harness.load_cell(args.workload)
    cell["config"].update(json.loads(args.sizes))
    return cell


def rank_argv(args, script: str, world: int, port: int):
    """The command line of every rank process of this run (without --rank)."""
    return [sys.executable, script, "--workload", args.workload, "--seed", str(args.seed),
            "--seconds", str(args.seconds), "--trace", str(args.trace), "--world", str(world),
            "--port", str(port), "--t-start", repr(T_START), "--device", args.device,
            "--sizes", args.sizes, "--control", str(args.control)]


def check_cards(args, cell=None):
    """The cell, or None after saying why no result can come."""
    cell = cell or cell_of(args)
    import torch

    if not torch.cuda.is_available():
        print("perfbench: torch.cuda.is_available() is false: no card, no result",
              file=sys.stderr)
        return None
    if torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: {cell['name']} needs {cell['chips']} cards, torch.cuda sees "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return None
    return cell


def main(argv=None) -> int:
    args = parse(argv)
    if args.rank is not None:
        if args.device == "cuda" and check_cards(args) is None:
            return 2
        imported = time.time()
        harness.join(args.rank, args.world, args.port, args.device, THREADS)
        t0 = T_START if args.t_start is None else args.t_start
        print(f"perfbench process, rank {args.rank}: started {T_START - t0:.3f} s, "
              f"torch {imported - t0:.3f} s, joined {time.time() - t0:.3f} s",
              file=sys.stderr, flush=True)
        import torch.distributed as dist

        try:
            out = harness.run_rank(cell_of(args), args.seed, args.seconds, bool(args.trace),
                                   args.rank, args.world, args.device, args.t_start,
                                   bool(args.control))
        finally:
            dist.destroy_process_group()
        if out is not None:
            print(json.dumps(out), flush=True)
        return 0
    if args.device != "cuda" or args.sizes != "{}":
        print("perfbench: --device and --sizes are for rank processes", file=sys.stderr)
        return 2
    cell = cell_of(args)
    if cell["chips"] > 1:
        # the ranks look for their cards themselves: this process does not
        # import torch, and holds no card
        world = cell["chips"]
        lines = harness.launch(rank_argv(args, __file__, world, harness.free_port()), world,
                               RANK_TIMEOUT_S)
        if not lines:
            print("perfbench: the ranks gave no result", file=sys.stderr)
            return 1
        return harness.emit(json.loads(lines[-1]))
    if check_cards(args, cell) is None:
        return 2
    import torch

    torch.set_num_threads(THREADS)
    out = harness.run_rank(cell, args.seed, args.seconds, bool(args.trace), t_start=T_START,
                           control=bool(args.control))
    return harness.emit(out)


if __name__ == "__main__":
    sys.exit(main())
