"""The public face of ``heat_tpu_torch``'s knob registry against
``heat_tpu``'s on the CPU.

- Every knob both packages register has the same type, default, choices
  and ``Tunable`` (values, kind, exact value): the autotuner's search
  space is the same in both.
- The overlay: an installed value wins over the environment for ``raw``,
  ``get`` and ``default_raw``; ``overlay`` restores the previous entries,
  their absence too, and checks every name before installing any;
  ``set_override``/``clear_overrides``/``overrides`` as in the JAX package.
- ``default_raw``, ``names``, ``tunables`` and ``markdown_table``'s type,
  default and tunable columns agree with the JAX package's for the shared
  knobs; ``heat_tpu_torch.core.knobs`` re-exports the registry.
"""

import pytest

from heat_tpu import _knobs as jax_knobs

from heat_tpu_torch import _knobs
from heat_tpu_torch.core import knobs as public

SHARED = sorted(n for n in _knobs.REGISTRY if n in jax_knobs.REGISTRY)


@pytest.fixture(autouse=True)
def clean_overlay():
    _knobs.clear_overrides()
    jax_knobs.clear_overrides()
    yield
    _knobs.clear_overrides()
    jax_knobs.clear_overrides()


def test_every_port_knob_is_a_jax_knob():
    assert SHARED == sorted(_knobs.REGISTRY)
    assert len(SHARED) >= 60


@pytest.mark.parametrize("name", SHARED)
def test_shared_knob_type_default_choices_and_tunable(name):
    mine, theirs = _knobs.REGISTRY[name], jax_knobs.REGISTRY[name]
    assert (mine.type, mine.default, mine.choices) == \
        (theirs.type, theirs.default, theirs.choices)
    assert theirs.scope == "runtime"  # every shared knob is one the JAX package reads itself
    assert _tun(mine.tunable) == _tun(theirs.tunable)


def _tun(t):
    return None if t is None else (t.values, t.kind, t.exact_value)


def test_tunables_are_the_jax_tunables_of_the_shared_knobs():
    want = {n for n, k in jax_knobs.tunables().items() if n in _knobs.REGISTRY}
    assert set(_knobs.tunables()) == want
    assert {"HEAT_TPU_FUSION", "HEAT_TPU_FUSION_DEPTH", "HEAT_TPU_RELAYOUT_PLAN"} <= want
    for n in want:
        assert _knobs.tunables()[n].tunable.kind in ("exact", "lossy", "neutral")


@pytest.mark.parametrize("name,env,over", [
    ("HEAT_TPU_FUSION", "1", "0"),
    ("HEAT_TPU_FUSION_DEPTH", "8", "32"),
    ("HEAT_TPU_RELAYOUT_PLAN", "chunked", "alltoall"),
    ("HEAT_TPU_HEDGE_MAX_FRACTION", "0.5", "0.25"),
    ("HEAT_TPU_SERVE_PRIORITY_WEIGHTS", "a=1", "latency=8,bulk=1"),
])
def test_overlay_wins_over_the_environment(name, env, over, monkeypatch):
    monkeypatch.setenv(name, env)
    assert _knobs.raw(name) == env and _knobs.get(name) == jax_knobs.get(name)
    with _knobs.overlay({name: over}), jax_knobs.overlay({name: over}):
        assert _knobs.raw(name) == over == jax_knobs.raw(name)
        assert _knobs.get(name) == jax_knobs.get(name)
        assert _knobs.default_raw(name) == jax_knobs.default_raw(name) == over
        assert _knobs.overrides() == {name: over}
    assert _knobs.raw(name) == env and _knobs.overrides() == {}
    monkeypatch.delenv(name)
    assert _knobs.default_raw(name) == jax_knobs.default_raw(name)


def test_overlay_restores_previous_entries_and_checks_names_first():
    _knobs.set_override("HEAT_TPU_FUSION", "0")
    with _knobs.overlay({"HEAT_TPU_FUSION": "1", "HEAT_TPU_FUSION_DEPTH": "4"}):
        assert _knobs.get("HEAT_TPU_FUSION") is True
        assert _knobs.get("HEAT_TPU_FUSION_DEPTH") == 4
    assert _knobs.overrides() == {"HEAT_TPU_FUSION": "0"}
    with pytest.raises(KeyError):
        with _knobs.overlay({"HEAT_TPU_FUSION_DEPTH": "2", "HEAT_TPU_NOT_A_KNOB": "1"}):
            pass
    assert _knobs.overrides() == {"HEAT_TPU_FUSION": "0"}  # nothing leaked
    with pytest.raises(KeyError):
        _knobs.set_override("HEAT_TPU_NOT_A_KNOB", "1")
    _knobs.set_override("HEAT_TPU_FUSION", None)
    assert _knobs.overrides() == {}
    _knobs.set_override("HEAT_TPU_FUSION", "0")
    _knobs.set_override("HEAT_TPU_RELAYOUT_PLAN", "chunked")
    _knobs.clear_overrides(["HEAT_TPU_FUSION"])
    assert _knobs.overrides() == {"HEAT_TPU_RELAYOUT_PLAN": "chunked"}


@pytest.mark.parametrize("name", SHARED)
def test_default_raw_matches_without_environment(name, monkeypatch):
    monkeypatch.delenv(name, raising=False)
    assert _knobs.default_raw(name) == jax_knobs.default_raw(name)


def test_markdown_table_columns_match_the_jax_table():
    def rows(table):
        out = {}
        for line in table.splitlines():
            if line.startswith("| `HEAT_TPU_"):
                cells = [c.strip() for c in line.strip("|").split(" | ")]
                out[cells[0]] = cells[1:4]
        return out

    mine, theirs = rows(_knobs.markdown_table()), rows(jax_knobs.markdown_table())
    assert set(mine) == {f"`{n}`" for n in SHARED}
    for name, cols in mine.items():
        assert cols == theirs[name], name


def test_public_face_reexports_the_registry():
    assert public.REGISTRY is _knobs.REGISTRY
    assert public.get is _knobs.get and public.overlay is _knobs.overlay
    assert set(public.__all__) == set(_knobs.__all__)
    assert public.names() == frozenset(_knobs.REGISTRY)
