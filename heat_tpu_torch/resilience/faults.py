"""Deterministic, seeded fault injection at the dispatch sites.

Counterpart of ``heat_tpu/resilience/faults.py``, with the same spec
grammar, rule semantics and draw, so that one ``HEAT_TPU_FAULTS`` spec
fires at the same call indices in both packages. The rule table is
consulted by the guarded dispatch (:mod:`.guard`) of every program of the
registry (:mod:`heat_tpu_torch.core.program_cache`) while the resilience
package is armed: it raises synthetic transient errors, adds latency, or
has the guard poison the call's output with NaNs.

Spec grammar (``HEAT_TPU_FAULTS`` or :func:`inject`): ``rule(;rule)*``,
each rule ``site_pattern(:key=value)*``:

* ``site_pattern``: an :mod:`fnmatch` glob over the site name
  (``serve.<endpoint>`` for the serving programs);
* ``kind=resource|reset|latency|nan`` (default ``resource``): an
  out-of-memory-class error, a connection-reset-class error, a
  ``delay``-second sleep, or NaN corruption of the output;
* ``calls=1,3``: fire at these 1-based call indices, counted per
  (rule, site) pair;
* ``p=0.25``: fire with this probability a call; the draw is a pure
  function of ``(seed, site, call index)`` (CRC32, not python's salted
  ``hash``), so a seed replays the same schedule in every process;
* ``seed=7`` (default 0), ``delay=0.05`` (seconds, default 0.01),
  ``times=2`` (stop after this many injections of the rule).

With no rules installed the dispatch never enters this module.
"""

from __future__ import annotations

import fnmatch
import threading
import time
import zlib
from typing import Dict, List, Optional

from .. import _knobs as knobs

__all__ = [
    "FaultRule",
    "InjectedConnectionReset",
    "InjectedFault",
    "InjectedResourceExhausted",
    "active",
    "check",
    "clear",
    "inject",
    "parse_spec",
    "stats",
]


class InjectedFault(RuntimeError):
    """Base of every synthetic error raised here; carries the ``site`` and
    the call ``index``. Always transient to :func:`.guard.classify`."""

    transient = True

    def __init__(self, message: str, site: str = "?", index: int = 0):
        super().__init__(message)
        self.site = site
        self.index = index


class InjectedResourceExhausted(InjectedFault):
    """A synthetic out-of-memory-class fault."""


class InjectedConnectionReset(InjectedFault):
    """A synthetic connection-reset-class fault."""


_KINDS = ("resource", "reset", "latency", "nan")


class FaultRule:
    """One parsed rule, with its per-site call counters and its count of
    injections (both under the module lock)."""

    __slots__ = ("pattern", "kind", "calls", "p", "seed", "delay", "times",
                 "counts", "fired")

    def __init__(self, pattern: str, kind: str = "resource", calls: Optional[tuple] = None,
                 p: Optional[float] = None, seed: int = 0, delay: float = 0.01,
                 times: Optional[int] = None):
        if kind not in _KINDS:
            raise ValueError(f"fault kind must be one of {_KINDS}, got {kind!r}")
        if calls is None and p is None:
            p = 1.0  # a rule with neither trigger fires on every call
        self.pattern = pattern
        self.kind = kind
        self.calls = tuple(int(c) for c in calls) if calls else None
        self.p = float(p) if p is not None else None
        self.seed = int(seed)
        self.delay = float(delay)
        self.times = int(times) if times is not None else None
        self.counts: Dict[str, int] = {}
        self.fired = 0

    def matches(self, site: str) -> bool:
        return fnmatch.fnmatchcase(site, self.pattern)

    def should_fire(self, site: str) -> Optional[int]:
        """Advance this rule's call counter at ``site``; the 1-based call
        index when it fires, else None. The caller holds the module lock."""
        index = self.counts.get(site, 0) + 1
        self.counts[site] = index
        if self.times is not None and self.fired >= self.times:
            return None
        if self.calls is not None and index in self.calls:
            return index
        if self.p is not None and _draw(self.seed, site, index) < self.p:
            return index
        return None

    def describe(self) -> dict:
        return {"pattern": self.pattern, "kind": self.kind, "calls": self.calls, "p": self.p,
                "seed": self.seed, "delay": self.delay, "times": self.times,
                "fired": self.fired}


def _draw(seed: int, site: str, index: int) -> float:
    """A uniform in [0, 1), a pure function of its inputs (the JAX
    package's draw, bit for bit)."""
    return zlib.crc32(f"{seed}:{site}:{index}".encode()) / 2**32


_LOCK = threading.Lock()
_RULES: List[FaultRule] = []
_ACTIVE = False  # mirrors bool(_RULES): the dispatch's one flag
_INJECTED: Dict[str, int] = {}


def active() -> bool:
    """Whether any rule is installed."""
    return _ACTIVE


def parse_spec(spec: str) -> List[FaultRule]:
    """Parse a ``HEAT_TPU_FAULTS`` spec into rules; a malformed spec raises
    ValueError (a chaos run that parsed to nothing would test nothing)."""
    rules = []
    for chunk in spec.split(";"):
        chunk = chunk.strip()
        if not chunk:
            continue
        parts = chunk.split(":")
        pattern = parts[0].strip()
        if not pattern or "=" in pattern:
            raise ValueError(f"fault rule {chunk!r} must start with a site pattern "
                             "(e.g. 'serve.*:kind=resource:calls=1')")
        kw: dict = {}
        for part in parts[1:]:
            if "=" not in part:
                raise ValueError(f"malformed fault option {part!r} in {chunk!r}")
            k, v = (s.strip() for s in part.split("=", 1))
            if k == "kind":
                kw["kind"] = v
            elif k == "calls":
                kw["calls"] = tuple(int(c) for c in v.split(",") if c)
            elif k == "p":
                kw["p"] = float(v)
            elif k == "seed":
                kw["seed"] = int(v)
            elif k == "delay":
                kw["delay"] = float(v)
            elif k == "times":
                kw["times"] = int(v)
            else:
                raise ValueError(f"unknown fault option {k!r} in {chunk!r}")
        rules.append(FaultRule(pattern, **kw))
    return rules


def inject(site: str = "*", kind: str = "resource", calls: Optional[tuple] = None,
           p: Optional[float] = None, seed: int = 0, delay: float = 0.01,
           times: Optional[int] = None) -> FaultRule:
    """Install one rule (the API twin of the spec) and arm the resilience
    package. Returns the rule; its ``fired`` count is live."""
    global _ACTIVE
    rule = FaultRule(site, kind=kind, calls=calls, p=p, seed=seed, delay=delay, times=times)
    with _LOCK:
        _RULES.append(rule)
        _ACTIVE = True
    from . import refresh

    refresh()
    return rule


def install_spec(spec: str) -> List[FaultRule]:
    """Parse and install every rule of ``spec`` (the import-time activation)."""
    global _ACTIVE
    rules = parse_spec(spec)
    with _LOCK:
        _RULES.extend(rules)
        _ACTIVE = bool(_RULES)
    return rules


def clear() -> None:
    """Remove every rule and zero the injection counts."""
    global _ACTIVE
    with _LOCK:
        _RULES.clear()
        _INJECTED.clear()
        _ACTIVE = False
    from . import refresh

    refresh()


def check(site: str) -> Optional[str]:
    """Consult the rules for one dispatch at ``site``: raise the synthetic
    error of a ``resource``/``reset`` rule, sleep for ``latency`` rules,
    and return ``"nan"`` when the guard should poison the output."""
    directive = None
    sleep_s = 0.0
    fire: Optional[tuple] = None  # (rule, index) of the first raising rule
    with _LOCK:
        for rule in _RULES:
            if not rule.matches(site):
                continue
            index = rule.should_fire(site)
            if index is None:
                continue
            rule.fired += 1
            _INJECTED[site] = _INJECTED.get(site, 0) + 1
            if rule.kind == "latency":
                sleep_s += rule.delay
            elif rule.kind == "nan":
                directive = "nan"
            elif fire is None:
                fire = (rule, index)
    _record(site, fire, sleep_s, directive)
    if sleep_s:
        time.sleep(sleep_s)
    if fire is not None:
        rule, index = fire
        if rule.kind == "resource":
            raise InjectedResourceExhausted(
                f"out of memory: synthetic allocator failure injected at site {site!r} "
                f"(call {index}, rule {rule.pattern!r})", site=site, index=index)
        raise InjectedConnectionReset(
            f"connection reset by peer: synthetic transport fault injected at site "
            f"{site!r} (call {index}, rule {rule.pattern!r})", site=site, index=index)
    return directive


def _record(site: str, fire, sleep_s: float, directive) -> None:
    if fire is None and not sleep_s and directive is None:
        return
    from .. import telemetry

    if not telemetry.enabled():
        return
    reg = telemetry.get_registry()
    reg.add("resilience.faults_injected", 1)
    kind = fire[0].kind if fire is not None else ("nan" if directive == "nan" else "latency")
    reg.emit("resilience", site, event="inject", fault_kind=kind)


def stats() -> dict:
    """The installed rules and the injections per site."""
    with _LOCK:
        return {"rules": [r.describe() for r in _RULES], "injected": dict(_INJECTED)}


def env_spec() -> str:
    """The ``HEAT_TPU_FAULTS`` spec, read now ('' when unset)."""
    return (knobs.raw("HEAT_TPU_FAULTS", "") or "").strip()
