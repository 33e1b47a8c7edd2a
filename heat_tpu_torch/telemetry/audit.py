"""``python -m heat_tpu_torch.telemetry.audit <expr>``: audit an expression.

Counterpart of ``heat_tpu/telemetry/audit.py``. Evaluates a Python
expression with ``htt`` (heat_tpu_torch), ``torch`` and ``np`` in scope,
with telemetry recording and the collective audit on for every
instrumented site (``resplit``, ``qr``, the ring distances, the sparse
products and transpose); prints one JSON report of every audit the
expression recorded (the collectives issued, their wire bytes, the drift
verdict against the analytic cost model). Exit status 1 when any drift was
flagged, or when no audit was recorded at all (a world of one rank issues
no collective, so it verifies nothing).

``--device`` picks the device (``gpu``, the default, or ``cpu``) instead of
the JAX package's ``--mesh``. Collectives need several ranks: start one
process a rank under ``torchrun`` and pass ``--distributed`` (the process
group starts from torchrun's environment, NCCL on the card, gloo on the
CPU); each rank prints its own report. Examples::

    torchrun --nproc-per-node 4 -m heat_tpu_torch.telemetry.audit --distributed \\
        "htt.resplit(htt.random.randn(256, 64, split=0), 1)"
    torchrun --nproc-per-node 4 -m heat_tpu_torch.telemetry.audit --distributed \\
        --device cpu --trace /tmp/trace.json \\
        "htt.linalg.qr(htt.random.randn(512, 32, split=0))"

``--trace`` also exports the telemetry event stream as a Chrome trace,
loadable in ``chrome://tracing`` or https://ui.perfetto.dev.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m heat_tpu_torch.telemetry.audit",
        description="Run an expression and audit the collectives of its instrumented ops "
                    "(resplit, qr, ring cdist, sparse), issued against predicted.")
    p.add_argument("expr", help="Python expression evaluated with `htt` (heat_tpu_torch), "
                                "`torch` and `np` in scope, e.g. "
                                "\"htt.resplit(htt.random.randn(256, 64, split=0), 1)\"")
    p.add_argument("--device", choices=("gpu", "cpu"), default="gpu",
                   help="the device the expression runs on (default: gpu)")
    p.add_argument("--distributed", action="store_true",
                   help="start the process group from torchrun's environment (env://)")
    p.add_argument("--trace", type=str, default=None,
                   help="also export the telemetry event stream as Chrome-trace JSON")
    p.add_argument("--tolerance", type=float, default=None,
                   help="relative byte-drift tolerance (default: HEAT_TPU_HLO_TOLERANCE, 0.1)")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    import heat_tpu_torch as htt
    from heat_tpu_torch import telemetry
    from heat_tpu_torch.telemetry import hlo

    if args.tolerance is not None:
        hlo.DEFAULT_TOLERANCE = args.tolerance
    if args.distributed:
        comm = htt.init_distributed(backend="gloo" if args.device == "cpu" else "nccl")
        if args.device == "gpu":  # one card a rank, before the first collective
            torch.cuda.set_device(comm.rank % torch.cuda.device_count())
    htt.use_device(args.device)
    if not telemetry.enabled():
        telemetry.enable()
    hlo.enable_audit()
    hlo.clear()

    result = eval(args.expr, {"htt": htt, "torch": torch, "np": np})
    for v in result if isinstance(result, tuple) else (result,):
        t = getattr(v, "larray", v)
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)

    records = hlo.recent()
    drift = sum(len(r.report.drifts) for r in records if r.report is not None)
    comm = htt.get_comm()
    out = {
        "expr": args.expr,
        "rank": comm.rank,
        "world": comm.size,
        "device": args.device,
        "audits": [r.summary() for r in records],
        "n_audits": len(records),
        "drift": drift,
        "ok": drift == 0 and len(records) > 0,
    }
    if not records:
        out["error"] = ("no instrumented op was audited: collectives need several ranks "
                        "(torchrun ... --distributed) and an expression that runs resplit, "
                        "qr, a ring distance or a sparse product on split arrays")
    if args.trace:
        telemetry.export_trace(args.trace)
        out["trace"] = args.trace
    print(json.dumps(out, indent=2, default=str))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
