"""heatlint for the port (counterpart of ``heat_tpu/analysis``): the
repo-native static analyzer, its six rules stated for ``heat_tpu_torch``.

The port keeps its invariants at chokepoints, as the JAX package does:
``program_cache.cached_program`` as the one capture site, the
communicator's movers feeding the collective audit, the exact sites that
no lossy wire reaches, the knob registry. heatlint turns each into a rule:

==== =========================================================
HL001 no CUDA graph capture or ``torch.compile`` outside the
      program registry
HL002 no ``torch.distributed`` collective outside the
      communicator
HL003 the exact sites pass no lossy ``precision=``
HL004 no host sync inside a registry program's body
HL005 every ``HEAT_TPU_*`` env read goes through ``_knobs``
HL006 no closed-over numeric literals in ``cached_program`` bodies
==== =========================================================

CLI::

    python -m heat_tpu_torch.analysis                  # scan heat_tpu_torch/
    python -m heat_tpu_torch.analysis heat_tpu_torch/ --select HL001 --format json
    python -m heat_tpu_torch.analysis --write-baseline # re-grandfather
    python -m heat_tpu_torch.analysis --list-rules
    python -m heat_tpu_torch.analysis --knob-table     # the knob catalog

Suppress one site with ``# heatlint: disable=HL004 -- reason``; the
baseline (``heat_tpu_torch/analysis/heatlint-baseline.json``) is the
port's own and absent while the tree scans clean.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

from .engine import (  # noqa: F401
    BASELINE_NAME,
    Finding,
    Report,
    analyze,
    apply_baseline,
    load_baseline,
    load_baseline_entries,
    scan_source,
    write_baseline,
)
from .rules import RULES, Rule, rule_by_id  # noqa: F401

__all__ = [
    "BASELINE_NAME",
    "Finding",
    "Report",
    "RULES",
    "Rule",
    "analyze",
    "apply_baseline",
    "load_baseline",
    "load_baseline_entries",
    "rule_by_id",
    "run",
    "scan_source",
    "write_baseline",
    "bench_field",
    "DEFAULT_PATHS",
]

# the tree the gate scans: the port; tests/ is excluded (test code holds the
# flagged patterns as fixtures)
DEFAULT_PATHS = ("heat_tpu_torch",)


def repo_root() -> str:
    """The repository checkout containing this package."""
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(
    paths: Optional[Sequence[str]] = None,
    root: Optional[str] = None,
    baseline: Optional[str] = None,
    select: Optional[Sequence[str]] = None,
) -> Report:
    """One-call API: analyze ``paths`` under ``root`` and apply the
    port's baseline (default ``<root>/heat_tpu_torch/analysis/
    heatlint-baseline.json`` when it exists; pass ``baseline=""`` to
    skip). Gate on ``report.findings``: those are the NEW violations."""
    root = root or repo_root()
    if paths is None:
        # only the *defaults* are existence-filtered; an explicit path that does not exist raises
        # FileNotFoundError rather than silently scanning nothing
        paths = [p for p in DEFAULT_PATHS
                 if os.path.exists(os.path.join(root, p))]
    else:
        paths = list(paths)
    report = analyze(paths, root, select=select)
    if baseline is None:
        candidate = os.path.join(root, BASELINE_NAME)
        baseline = candidate if os.path.exists(candidate) else ""
    if baseline:
        report = apply_baseline(report, load_baseline(baseline))
    return report


def bench_field() -> dict:
    """The summary row a benchmark records: finding counts per bucket so
    the debt curve (baseline shrinking, suppressions steady, new always
    zero) is visible run over run."""
    try:
        report = run()
        return {
            **report.counts(),
            "rules": len(RULES),
            "gate": "clean" if not report.findings else "FAILING",
        }
    except Exception as e:  # noqa: BLE001 - a summary must never die on lint
        return {"error": repr(e)}
