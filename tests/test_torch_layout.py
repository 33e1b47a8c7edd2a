"""The port's chunk rule against the JAX package's, bit for bit.

For every mesh size the JAX package can build on the 8-device CPU mesh,
``chunk``, ``lshape_map`` and ``counts_displs`` of heat_tpu_torch (as
functions of an explicit world size) must equal heat_tpu's
``MeshCommunication`` answers."""

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
