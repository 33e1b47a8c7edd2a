"""Candidate-lattice construction (counterpart of
``heat_tpu/autotune/space.py``): the search space comes from the knob
registry's ``tunable=`` metadata, not from the tuner.

A *config* is a ``{knob name: raw env string}`` dict — exactly what the
knob overlay installs — covering only the knobs a tune searches. The
default config (every searched knob at its CURRENT effective value:
overlay/env if set, declared default otherwise) is always candidate 0,
which is what lets the winner-selection rule guarantee "never worse than
default": the default is measured under the same protocol as every
challenger.

Lossy knobs (constraint class ``lossy``) are only enumerated when the
caller states a positive error budget; without one they stay pinned at
their current value, so an exact-only tune can never even *construct* a
config that moves a lossy knob.
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterable, List, Optional

from .. import _knobs as knobs

__all__ = [
    "default_config",
    "candidates",
    "lossy_knobs",
    "exact_variant",
    "is_lossy_shift",
]

# Lattice bound before analytic pruning: the cartesian product over
# tunable values is capped here so a wide knob list cannot explode the
# offline stage (the measured stage is bounded separately by prune_to).
MAX_CONFIGS = 64


def _tunable(name: str) -> knobs.Knob:
    k = knobs.REGISTRY.get(name)
    if k is None:
        raise KeyError(f"{name!r} is not a registered HEAT_TPU knob")
    if k.tunable is None:
        raise ValueError(
            f"{name!r} carries no tunable= metadata — declare its search "
            "space in heat_tpu_torch/_knobs.py before tuning it"
        )
    return k


def default_config(names: Iterable[str]) -> Dict[str, str]:
    """The searched knobs at their current effective raw values."""
    return {n: knobs.default_raw(n) for n in names}


def lossy_knobs(names: Iterable[str]) -> List[str]:
    return [n for n in names if _tunable(n).tunable.kind == "lossy"]


def exact_variant(config: Dict[str, str]) -> Dict[str, str]:
    """``config`` with every lossy knob moved to its declared
    exact-semantics value — the reference the error budget is measured
    against."""
    out = dict(config)
    for n in config:
        t = _tunable(n).tunable
        if t.kind == "lossy":
            out[n] = t.exact_value
    return out


def is_lossy_shift(config: Dict[str, str], base: Dict[str, str]) -> bool:
    """Whether ``config`` differs from ``base`` on any lossy knob — the
    validator's digest-vs-allclose fork: exact/neutral shifts must stay
    bit-identical to the default run, lossy shifts are judged against
    the exact reference under the budget."""
    return any(
        config.get(n) != base.get(n) for n in lossy_knobs(config)
    )


def candidates(
    names: Iterable[str],
    *,
    error_budget: Optional[float] = None,
    max_configs: int = MAX_CONFIGS,
) -> List[Dict[str, str]]:
    """The candidate lattice over ``names``: default config first, then
    the cartesian product of each knob's declared values (plus the
    current value, if the environment holds one the registry does not
    enumerate), deterministic order, capped at ``max_configs``."""
    names = list(names)
    if not names:
        raise ValueError("tune over an empty knob list")
    base = default_config(names)
    search_lossy = error_budget is not None and error_budget > 0
    axes: List[List[str]] = []
    for n in names:
        t = _tunable(n).tunable
        if t.kind == "lossy" and not search_lossy:
            axes.append([base[n]])
            continue
        vals = list(t.values)
        if base[n] not in vals:
            vals.insert(0, base[n])
        axes.append(vals)
    out: List[Dict[str, str]] = [base]
    seen = {tuple(sorted(base.items()))}
    for combo in itertools.product(*axes):
        cfg = dict(zip(names, combo))
        sig = tuple(sorted(cfg.items()))
        if sig in seen:
            continue
        seen.add(sig)
        out.append(cfg)
        if len(out) >= max_configs:
            break
    return out
