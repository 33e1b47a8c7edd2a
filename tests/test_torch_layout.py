"""The port's chunk rule against the JAX package's, bit for bit.

For every mesh size the JAX package can build on the 8-device CPU mesh,
``chunk``, ``lshape_map`` and ``counts_displs`` of heat_tpu_torch (as
functions of an explicit world size) must equal heat_tpu's
``MeshCommunication`` answers. The import rule of the port is checked
here too."""

import ast
from pathlib import Path

import jax
import numpy as np
import pytest

import heat_tpu as ht_tpu
from heat_tpu.core.communication import MeshCommunication

import heat_tpu_torch as htt
from heat_tpu_torch.core import communication as tcomm

SIZES = list(range(1, len(jax.devices()) + 1))
LENGTHS = [0, 1, 7, 10, 13, 64]


def _mesh(p):
    return MeshCommunication(devices=jax.devices()[:p])


@pytest.mark.parametrize("p", SIZES)
@pytest.mark.parametrize("n", LENGTHS)
def test_chunk_lshape_map_counts_displs_match(p, n):
    ref = _mesh(p)
    assert tcomm.chunk_size(n, p) == ref.chunk_size(n)
    assert tcomm.padded_size(n, p) == ref.padded_size(n)
    for gshape, split in (((n, 3), 0), ((3, n), 1), ((n, 3), None)):
        np.testing.assert_array_equal(
            tcomm.lshape_map(gshape, split, p), ref.lshape_map(gshape, split)
        )
        for r in range(p):
            assert tcomm.chunk(gshape, split, r, p) == ref.chunk(gshape, split, r)
    assert tcomm.counts_displs(n, p) == ref.counts_displs(n)


_REPO = Path(__file__).resolve().parent.parent
_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "heat_tpu")


def _port_sources():
    return sorted((_REPO / "heat_tpu_torch").rglob("*.py")) + [_REPO / "chip_smoke.py"]


def _imported_roots(path):
    """The top-level package of every import in ``path``, with its line."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


def test_port_imports_no_jax_flax_or_heat_tpu():
    """The port and chip_smoke.py run where there is no jax: no module of
    heat_tpu_torch and no line of chip_smoke.py imports jax, flax or the JAX
    package (heat_tpu_torch itself is fine)."""
    sources = _port_sources()
    assert len(sources) > 30
    found = [f"{p.relative_to(_REPO)}:{line} imports {root}"
             for p in sources for root, line in _imported_roots(p) if root in _FORBIDDEN]
    assert not found, found


def test_import_rule_catches_a_forbidden_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import os\nfrom heat_tpu.core import linalg\nimport heat_tpu_torch\n"
                   "def f():\n    import jax.numpy as jnp\n")
    roots = {root for root, _ in _imported_roots(bad)}
    assert roots & set(_FORBIDDEN) == {"heat_tpu", "jax"}


@pytest.fixture
def on_cpu():
    htt.use_device("cpu")
    yield
    htt.use_device(None)


def test_world_of_one_without_process_group(on_cpu):
    comm = htt.get_comm()
    assert (comm.size, comm.rank) == (1, 0)
    t = htt.array(np.arange(6.0).reshape(2, 3)).larray
    assert comm.allreduce(t.clone()).equal(t)
    assert comm.allgather(t, 0, 2).equal(t)


@pytest.mark.parametrize("n", LENGTHS)
def test_dndarray_layout_matches_at_mesh_size_one(on_cpu, n):
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    ref = ht_tpu.array(x, split=0, comm=_mesh(1))
    got = htt.array(x, split=0)
    np.testing.assert_array_equal(got.lshape_map, ref.lshape_map)
    assert got.lshape == ref.lshape
    assert got.counts_displs() == ref.counts_displs()
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
