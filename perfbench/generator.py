"""The one generator of the benchmark's work.

A configuration file gives the table (rows, features, how the data is
drawn) and the algorithm's parameters; a traffic file names the op
(``op``), how it is called (``loop``, the operands' split, the op's own
keys) and ``options``, the keywords handed on to the program's entry point
as they stand. The op is the class ``Op`` of ``ops/<op>.py``, found by that
name as a metric's reader is: a mix that only changes parameters or
options is a new data file and no code, and a new kind of work is a new
file beside the others.

From the configuration, the traffic and the seed an op makes the inputs on
the device, calls the program (``heat_tpu_torch``, handed in as ``ht``) and
judges what it produced with the plain reference; the same inputs go to
both sides. Made as the control (``control=True``), the op puts the
reference computed in TF32 in the program's place, in the form of the
program's outputs, so that the same window and the same judge decide that
it is not correct.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

OPS = Path(__file__).resolve().parent / "ops"


def seeded(seed: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def make_table(cfg: Dict[str, Any], seed: int, device: torch.device) -> torch.Tensor:
    """The configuration's (rows, features) float32 table, drawn on
    ``device`` from ``seed`` in a few large calls: the same seed gives the
    same table on every rank."""
    g = seeded(seed, device)
    rows, feats = int(cfg["rows"]), int(cfg["features"])
    data = cfg["data"]
    if data["kind"] == "gaussian":
        return torch.randn((rows, feats), generator=g, device=device)
    if data["kind"] == "gaussian_mixture":
        k = int(data["components"])
        means = torch.randn((k, feats), generator=g, device=device) * float(data["spread"])
        comp = torch.randint(0, k, (rows,), generator=g, device=device)
        x = torch.randn((rows, feats), generator=g, device=device)
        x += means[comp]
        return x
    raise ValueError(f"unknown data kind {data['kind']!r}")


def device_name(device: torch.device) -> str:
    """``device`` as heat_tpu_torch names it."""
    return "cpu" if device.type == "cpu" else f"gpu:{device.index or 0}"


def local_rows(t: torch.Tensor, split: Optional[int], comm) -> torch.Tensor:
    """This rank's rows of the whole ``t`` when it is split along its rows
    as the program splits it; all of ``t`` otherwise."""
    if split is None or comm.size == 1:
        return t
    offset, lshape, _ = comm.chunk(tuple(t.shape), 0)
    return t[offset:offset + lshape[0]]


def reducer(comm) -> Optional[Callable[[torch.Tensor, str], torch.Tensor]]:
    """``reduce(t, "sum" | "max")`` over the ranks, or None with one rank."""
    if comm.size == 1:
        return None

    def reduce(t: torch.Tensor, op: str) -> torch.Tensor:
        t = t.clone()
        dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX)
        return t

    return reduce


def worst(value: float, comm, device: torch.device) -> float:
    """The largest of every rank's ``value`` (nan where any rank's is)."""
    if comm.size == 1:
        return value
    t = torch.nan_to_num(torch.tensor([value], dtype=torch.float64, device=device),
                         nan=float("inf"))
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    v = float(t)
    return float("nan") if v == float("inf") else v


class Op:
    """One cell's op. Calling it runs the program once (the control's
    stand-in, where ``control``) and returns what it produced; ``judge``
    reduces that to the numbers compared with the cell's limits, and
    ``work`` gives this rank's operations and bytes of one op for the
    roofline. ``loop`` (``closed`` or ``back_to_back``) and
    ``stop_check_s`` come from the traffic."""

    def __init__(self, ht, cfg: Dict[str, Any], traffic: Dict[str, Any], seed: int,
                 device: torch.device, comm, control: bool = False):
        self.ht, self.cfg, self.traffic, self.seed = ht, cfg, traffic, seed
        self.device, self.comm, self.control = device, comm, control
        self.loop = traffic["loop"]
        self.stop_check_s = float(traffic.get("stop_check_s", 0.5))
        self.options = dict(traffic.get("options", {}))

    def __call__(self) -> Any:
        return self.stand_in() if self.control else self.program()

    def program(self) -> Any:
        raise NotImplementedError

    def stand_in(self) -> Any:
        """The reference in TF32, in the form ``program`` returns."""
        raise NotImplementedError

    def judge(self, result: Any) -> Dict[str, float]:
        raise NotImplementedError

    def work(self) -> Dict[str, float]:
        raise NotImplementedError


def op_class(name: str):
    """The class ``Op`` of ``ops/<name>.py``."""
    path = OPS / f"{name}.py"
    if not path.exists():
        known = sorted(p.stem for p in OPS.glob("*.py") if not p.stem.startswith("_"))
        raise ValueError(f"unknown op {name!r}: no ops/{name}.py; there are {known}")
    spec = importlib.util.spec_from_file_location("perfbench_op_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.Op


def make_op(ht, cfg: Dict[str, Any], traffic: Dict[str, Any], seed: int,
            device: torch.device, comm, control: bool = False) -> Op:
    """The op of a configuration under a traffic mix, its inputs made from
    ``seed`` on ``device``; the control's where ``control``."""
    return op_class(str(traffic.get("op")))(ht, cfg, traffic, seed, device, comm, control)
