"""heat_tpu_torch's compressed collectives (core/collective_prec.py) against heat_tpu's.

The pure rules against the JAX package's bit for bit: ``local_roundtrip``
(the quantize-dequantize of every wire, ``round`` half to even and the same
bf16 scale), ``quant_error_bound``, ``blockwise_segments``, ``resolve``/
``effective``/``compressible`` and the knobs. One spawned world of four
gloo ranks runs every compressed collective of the communicator and holds:

* the movers (``all_gather``, ``ppermute``) bit for bit the exact move of
  ``local_roundtrip`` (the JAX package's parity oracle);
* the sums (``allreduce``, ``reduce_scatter_flat``, ``all_to_all``) within
  ``quant_error_bound`` at ``p + 1`` hops of the exact results;
* each collective's audited wire bytes equal to the cost model's
  (``allreduce_cost``, ``reduce_scatter_cost``; no drift);
* ``resplit(precision=)`` bit for bit the JAX package's on four devices
  (the same scales, the same int8 payload), its audit without drift;
* the sparse ``spmv`` over the bf16 wire within ``quant_error_bound`` of
  bf16 at ``p + 1`` hops of the JAX package's exact product, and each
  rank's result equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import heat_tpu as ht_tpu
from heat_tpu.core import collective_prec as jcp
from heat_tpu.core.communication import MeshCommunication

from heat_tpu_torch.core import collective_prec as cp

from .torch_spmd import spawn

MODES = ("bf16", "int8", "blockwise")


def _payload(shape, seed):
    """A payload with a zero run, an outlier and a scale of its own."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * [1e-3, 1.0, 1e3][seed % 3]).astype(np.float32)
    flat = x.reshape(-1)
    flat[: flat.size // 3] = 0.0
    if flat.size > 10:
        flat[-3] = 50.0 * np.abs(flat).max()
    return x


@pytest.mark.parametrize("shape", [(1000,), (7, 33), (3, 128), (5,)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
def test_local_roundtrip_bit_for_bit(mode, dtype, shape):
    x = _payload(shape, len(shape) + shape[0])
    for block in (128, 7):
        want = jcp.local_roundtrip(jnp.asarray(x).astype(dtype), mode, block)
        got = cp.local_roundtrip(torch.from_numpy(x).to(getattr(torch, dtype)), mode, block)
        assert str(got.dtype).endswith(dtype)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))


def test_roundtrip_passes_exact_payloads_through():
    for t in (torch.arange(10, dtype=torch.int32), torch.ones(4, dtype=torch.bool)):
        for mode in ("off",) + MODES:
            assert cp.local_roundtrip(t, mode) is t
    x = torch.randn(9)
    assert cp.local_roundtrip(x, "off") is x


@pytest.mark.parametrize("mode", ("off",) + MODES)
@pytest.mark.parametrize("hops", [1, 5])
def test_quant_error_bound_matches(mode, hops):
    x = _payload((64,), 1)
    assert cp.quant_error_bound(torch.from_numpy(x), mode, hops) == \
        jcp.quant_error_bound(jnp.asarray(x), mode, hops)
    assert cp.quant_error_bound(3.5, mode, hops) == jcp.quant_error_bound(3.5, mode, hops)
    assert cp.quant_error_bound(torch.arange(4), mode) == 0.0
    assert cp.quant_error_bound(float("inf"), mode) == float("inf")


def test_rules_match(monkeypatch):
    for extent in (1, 64, 127, 128, 256, 300, 384):
        for block in (1, 64, 128):
            assert cp.blockwise_segments(extent, block) == jcp.blockwise_segments(extent, block)
    for shape, split in (((4, 8), 0), ((4, 8), 1), ((8,), 0), ((2, 3, 4), None), ((4, 0), 0)):
        assert cp.blockwise_axis_ok(shape, split) == jcp.blockwise_axis_ok(shape, split)
    for name in ("off", "BF16", " int8 ", "blockwise", None):
        assert cp.resolve(name) == jcp.resolve(name)
        for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
                         (torch.int32, jnp.int32), (torch.bool, jnp.bool_)):
            assert cp.effective(tdt, name) == jcp.effective(jdt, name)
            assert cp.compressible(tdt) == jcp.compressible(jdt)
    with pytest.raises(ValueError, match="precision must be one of"):
        cp.resolve("fp8")
    with pytest.raises(ValueError, match="precision must be one of"):
        jcp.resolve("fp8")
    for raw, block in (("int8", "64"), ("garbage", "-3"), ("blockwise", "x")):
        monkeypatch.setenv("HEAT_TPU_COLLECTIVE_PREC", raw)
        monkeypatch.setenv("HEAT_TPU_COLLECTIVE_PREC_BLOCK", block)
        assert (cp.mode(), cp.block_size()) == (jcp.mode(), jcp.block_size())


def test_allreduce_wire_dtype_is_the_payloads_own():
    """A summing all-reduce moves its own type on NCCL and gloo alike: the
    JAX package's table on a TPU; its CPU backend widens bf16 and f16 to f32
    (a documented difference of the CPU legalization, not of the wire)."""
    for tdt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float16, jnp.float16),
                     (torch.float32, jnp.float32), (torch.int32, jnp.int32)):
        assert cp.allreduce_wire_dtype(tdt) == jcp.allreduce_wire_dtype(jdt, "tpu")
    assert jcp.allreduce_wire_dtype(jnp.bfloat16, "cpu") == "f32"


# -- a world of four ----------------------------------------------------------------------

_RESPLITS = [((16, 256), 0, 1), ((16, 256), 0, None), ((16, 256), 1, 0), ((16, 7), 0, 1)]

_SCRIPT = """
from heat_tpu_torch.core import collective_prec as cp
from heat_tpu_torch.telemetry import collectives as costs, hlo

MODES = ("bf16", "int8", "blockwise")
RESPLITS = %r


def run(ht, rank, world):
    comm = ht.get_comm()
    rng = np.random.default_rng(rank)
    x = torch.from_numpy(rng.standard_normal(1000).astype(np.float32))
    t = torch.from_numpy(rng.standard_normal((8, 6)).astype(np.float32))
    res = {"x": x, "t": t, "a2a": comm.all_to_all(t, 0, 1, 8, 6 * world)}
    for m in MODES:
        def audited(name, fn, predicted):
            out, rec = hlo.audit_call(name, fn, predicted=predicted)
            res[f"{name}_{m}_ok"] = np.array(rec.report.ok)
            res[f"{name}_{m}_bytes"] = np.array([rec.report.emitted_bytes,
                                                 rec.report.predicted_bytes])
            return out

        res[f"psum_{m}"] = audited("psum", lambda: comm.allreduce(x.clone(), precision=m),
                                   costs.allreduce_cost(1000, 4, world, m))
        res[f"rs_{m}"] = audited("rs", lambda: comm.reduce_scatter_flat(x, precision=m),
                                 costs.reduce_scatter_cost(1000, 4, world, m))
        res[f"ag_{m}"] = comm.allgather(x[:250].clone(), 0, 1000, precision=m)
        res[f"pp_{m}"] = comm.ring_permute(x.clone(), 1, precision=m)
        res[f"a2a_{m}"] = comm.all_to_all(t, 0, 1, 8, 6 * world, precision=m)
        res[f"tiled_a2a_{m}"] = cp.all_to_all(t, comm, 0, 1, m)
        res[f"rt_{m}"] = cp.local_roundtrip(x, m)
        res[f"rt250_{m}"] = cp.local_roundtrip(x[:250], m)
        data = np.random.default_rng(7).standard_normal((16, 256)).astype(np.float32)
        for i, (shape, src, dst) in enumerate(RESPLITS):
            a = ht.array(data[:shape[0], :shape[1]].copy(), split=src)
            b = ht.resplit(a, dst, audit=True, precision=m)
            rec = hlo.last_audit("resplit")
            res[f"resplit{i}_{m}"] = b.numpy()
            res[f"resplit{i}_{m}_ok"] = np.array(rec.report.ok)
    dense = np.random.default_rng(11).standard_normal((16, 16)).astype(np.float32)
    dense *= np.random.default_rng(12).random((16, 16)) < 0.3
    A = ht.sparse.csr_from_dense(ht.array(dense, split=0))
    v = ht.array(np.random.default_rng(13).standard_normal(16).astype(np.float32), split=0)
    res["spmv_bf16"] = ht.sparse.spmv(A, v, out_split=None, precision="bf16").numpy()
    return res
""" % (_RESPLITS,)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return spawn(tmp_path_factory.mktemp("cprec"), 4, _SCRIPT)


@pytest.mark.parametrize("mode", MODES)
def test_world_of_four_movers_are_the_exact_move_of_the_roundtrip(four, mode):
    want_ag = np.concatenate([r[f"rt250_{mode}"] for r in four])
    for rank, r in enumerate(four):
        np.testing.assert_array_equal(r[f"ag_{mode}"], want_ag)
        np.testing.assert_array_equal(r[f"pp_{mode}"], four[(rank - 1) % 4][f"rt_{mode}"])


@pytest.mark.parametrize("mode", MODES)
def test_world_of_four_sums_within_the_bound(four, mode):
    xs = np.stack([r["x"] for r in four])
    total = xs.astype(np.float64).sum(0)
    bound = cp.quant_error_bound(float(np.abs(xs).max()) * 4, mode, 5) + 1e-5
    for rank, r in enumerate(four):
        assert np.abs(r[f"psum_{mode}"] - total).max() <= bound
        np.testing.assert_array_equal(r[f"psum_{mode}"], four[0][f"psum_{mode}"])
        # blockwise pads each rank's chunk to whole blocks: 250 -> 256
        c = 256 if mode == "blockwise" else 250
        padded = np.concatenate([total, np.zeros(4 * c - 1000)])
        assert r[f"rs_{mode}"].shape == (c,)
        assert np.abs(r[f"rs_{mode}"] - padded[rank * c:(rank + 1) * c]).max() <= bound
        exact = r["a2a"]
        assert np.abs(r[f"a2a_{mode}"] - exact).max() <= cp.quant_error_bound(
            float(np.abs(np.stack([q["t"] for q in four])).max()), mode, 1) + 1e-7


@pytest.mark.parametrize("mode", MODES)
def test_world_of_four_tiled_all_to_all_matches_the_reference(four, mode):
    """``all_to_all``'s per-slab quantization moves the same int8 and scales
    as the JAX package's: the dequantized slabs bit for bit."""
    from jax.sharding import PartitionSpec as P

    comm = MeshCommunication(devices=jax.devices()[:4])
    ax = comm.axis_name
    run = jax.shard_map(lambda v: jcp.all_to_all(v[0], ax, 4, 0, 1, mode)[None], mesh=comm.mesh,
                        in_specs=P(ax), out_specs=P(ax), check_vma=False)
    want = np.asarray(run(jnp.asarray(np.stack([r["t"] for r in four]))))
    for rank, r in enumerate(four):
        np.testing.assert_array_equal(r[f"tiled_a2a_{mode}"], want[rank])


@pytest.mark.parametrize("mode", MODES)
def test_world_of_four_audits_match_the_cost_model(four, mode):
    for r in four:
        for name in ("psum", "rs"):
            emitted, predicted = r[f"{name}_{mode}_bytes"]
            assert bool(r[f"{name}_{mode}_ok"]) and emitted == predicted, (name, emitted,
                                                                           predicted)


@pytest.mark.parametrize("case", range(len(_RESPLITS)))
@pytest.mark.parametrize("mode", MODES)
def test_world_of_four_resplit_matches_the_reference(four, mode, case):
    shape, src, dst = _RESPLITS[case]
    data = np.random.default_rng(7).standard_normal((16, 256)).astype(np.float32)
    x = data[:shape[0], :shape[1]].copy()
    comm = MeshCommunication(devices=jax.devices()[:4])
    want = ht_tpu.resplit(ht_tpu.array(x, split=src, comm=comm), dst, precision=mode).numpy()
    for r in four:
        np.testing.assert_array_equal(r[f"resplit{case}_{mode}"], want)
        assert bool(r[f"resplit{case}_{mode}_ok"])


def test_world_of_four_sparse_bf16_spmv(four):
    dense = np.random.default_rng(11).standard_normal((16, 16)).astype(np.float32)
    dense *= np.random.default_rng(12).random((16, 16)) < 0.3
    v = np.random.default_rng(13).standard_normal(16).astype(np.float32)
    comm = MeshCommunication(devices=jax.devices()[:4])
    A = ht_tpu.sparse.csr_from_dense(ht_tpu.array(dense, split=0, comm=comm))
    exact = ht_tpu.sparse.spmv(A, ht_tpu.array(v, split=0, comm=comm), out_split=None).numpy()
    bound = cp.quant_error_bound(float(np.abs(dense).sum(1).max() * np.abs(v).max()), "bf16", 5)
    for r in four:
        assert np.abs(r["spmv_bf16"] - exact).max() <= bound
        np.testing.assert_array_equal(r["spmv_bf16"], four[0]["spmv_bf16"])
