"""heat_tpu_torch's 2-level topology and tiered collectives (core/topology.py) against heat_tpu's.

The rules bit for bit against the JAX package's: ``parse`` (the ``2x4``
grammar, its warnings), ``detect`` (one host: the emulated two-node split),
the groups, ``resolve``/``active``/``cross_mode``/``fsdp_wire``/
``cache_token`` under the knobs. One spawned world of four gloo ranks
(``HEAT_TPU_TOPOLOGY=2x2``, ``HEAT_TPU_HIERARCHICAL=1``) runs the tiered
lowerings of the communicator against the JAX package's ``hier_*`` in
``shard_map`` on four devices:

* the all-gather and the all-to-all (pure movement) bit for bit, and bit
  for bit the flat ones of the same world;
* the sum and the reduce-scatter within 4 ulp of the largest partial sum
  (the tiers add in another order than the flat ring); integer-valued sums
  exactly;
* the compressed cross tier within ``quant_error_bound`` at ``node + 1``
  hops of the exact sum;
* every tiered collective's audited wire bytes equal to the cost model's
  ``hierarchical_*_cost`` (no drift);
* ``node_mean_cross_sum`` (DASO's send) against the JAX package's, and
  DASO's node count from the declared topology;
* the exact sites (the moments' and the statistics' sums, ``numpy()``'s
  gather, ``resplit``) under ``HEAT_TPU_HIERARCHICAL_PREC=int8`` or
  ``HEAT_TPU_COLLECTIVE_PREC=bf16`` bit for bit the same sites without
  the knob: only the surfaces that resolve a lossy knob read it.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from heat_tpu.core import topology as jtopo
from heat_tpu.core.communication import MeshCommunication

from heat_tpu_torch.core import collective_prec as cp
from heat_tpu_torch.core import topology as topo

from .torch_spmd import spawn

RAWS = ["2x4", "2×4", " 2X4 ", "4x2", "1x8", "8x1", "3x3", "x", "axb", "0x8", "-1x-8", "",
        "2x2x2", "4x1"]


def _fields(t):
    return None if t is None else (t.node, t.local, t.source, t.size, t.nontrivial,
                                   t.node_groups(), t.cross_groups(), t.describe())


@pytest.mark.parametrize("raw", RAWS)
@pytest.mark.parametrize("p", [8, 4])
def test_parse_matches(raw, p):
    with warnings.catch_warnings(record=True) as got_w:
        warnings.simplefilter("always")
        got = topo.parse(raw, p)
    with warnings.catch_warnings(record=True) as want_w:
        warnings.simplefilter("always")
        want = jtopo.parse(raw, p)
    assert _fields(got) == _fields(want)
    assert len(got_w) == len(want_w)


@pytest.mark.parametrize("p", range(1, 10))
def test_detect_on_one_host_matches(p):
    assert _fields(topo.detect(p, hosts=1)) == _fields(jtopo.detect(p))
    assert _fields(topo.detect(p, hosts=2)) == (
        _fields(topo.Topology(2, p // 2, "detected")) if p % 2 == 0
        else _fields(topo.detect(p, hosts=1)))


@pytest.mark.parametrize("env", [
    {}, {"HEAT_TPU_HIERARCHICAL": "1"}, {"HEAT_TPU_HIERARCHICAL": "1", "HEAT_TPU_TOPOLOGY": "4x2"},
    {"HEAT_TPU_HIERARCHICAL": "1", "HEAT_TPU_TOPOLOGY": "1x8"},
    {"HEAT_TPU_HIERARCHICAL": "1", "HEAT_TPU_HIERARCHICAL_PREC": "int8"},
    {"HEAT_TPU_HIERARCHICAL": "1", "HEAT_TPU_COLLECTIVE_PREC": "bf16"},
    {"HEAT_TPU_FSDP_PREC": "blockwise"},
    {"HEAT_TPU_HIERARCHICAL": "1", "HEAT_TPU_HIERARCHICAL_PREC": "bogus",
     "HEAT_TPU_COLLECTIVE_PREC": "int8"}])
def test_knob_rules_match(monkeypatch, env):
    for name in ("HEAT_TPU_HIERARCHICAL", "HEAT_TPU_TOPOLOGY", "HEAT_TPU_HIERARCHICAL_PREC",
                 "HEAT_TPU_COLLECTIVE_PREC", "HEAT_TPU_FSDP_PREC"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert topo.hierarchical_requested() == jtopo.hierarchical_requested()
    for p in (4, 8):
        assert _fields(topo.resolve(p)) == _fields(jtopo.resolve(p))
        assert _fields(topo.active(p)) == _fields(jtopo.active(p))
        assert topo.cache_token(p) == jtopo.cache_token(p)
        for tdt, jdt in ((torch.float32, jnp.float32), (torch.int32, jnp.int32)):
            for prec in (None, "off", "bf16", "int8"):
                assert topo.cross_mode(tdt, prec) == jtopo.cross_mode(jdt, prec)
                assert topo.fsdp_wire(tdt, p, prec) == jtopo.fsdp_wire(jdt, p, prec)


# -- the world of four, 2 x 2 ----------------------------------------------------------------

_SCRIPT = """
import os
from heat_tpu_torch.core import topology
from heat_tpu_torch.telemetry import collectives as costs, hlo


def run(ht, rank, world):
    comm = ht.get_comm()
    rng = np.random.default_rng(rank)
    x = torch.from_numpy(rng.standard_normal(1000).astype(np.float32))
    xi = torch.from_numpy(rng.integers(-50, 50, 1000).astype(np.float32))
    t = torch.from_numpy(rng.standard_normal((8, 6)).astype(np.float32))
    res = {"x": x, "xi": xi, "t": t}

    def audited(name, fn, predicted):
        out, rec = hlo.audit_call(name, fn, predicted=predicted)
        res[name + "_audit"] = np.array([rec.report.ok, rec.report.emitted_bytes,
                                         rec.report.predicted_bytes])
        return out

    res["psum"] = audited("psum", lambda: comm.allreduce(x.clone()),
                          costs.hierarchical_allreduce_cost(1000, 4, 2, 2))
    res["psumi"] = comm.allreduce(xi.clone())
    res["ag"] = audited("ag", lambda: comm.allgather(x[:250].clone(), 0, 1000),
                        costs.hierarchical_allgather_cost(250, 4, 2, 2))
    res["rs"] = audited("rs", lambda: comm.reduce_scatter_flat(x),
                        costs.hierarchical_reduce_scatter_cost(1000, 4, 2, 2))
    res["a2a"] = audited("a2a", lambda: comm.all_to_all(t, 0, 1, 8, 24),
                         costs.hierarchical_a2a_cost(8 * 24, 4, 2, 2))
    res["hier_a2a"] = topology.hier_all_to_all(t, comm, topology.Topology(2, 2), 0, 1)
    for m in ("bf16", "int8", "blockwise"):
        res["psum_" + m] = audited("psum_" + m, lambda: comm.allreduce(x.clone(), precision=m),
                                   costs.hierarchical_allreduce_cost(1000, 4, 2, 2, m))
        res["ag_" + m] = comm.allgather(x[:250].clone(), 0, 1000, precision=m)
        # a payload of p whole blocks a rank (as ZeRO pads it): the chunks align
        res["rs_" + m] = comm.reduce_scatter_flat(torch.nn.functional.pad(x, (0, 24)),
                                                  precision=m)
    node, local = comm.node_local(2)
    for wire in ("off", "bf16", "int8"):
        res["daso_send_" + wire] = topology.node_mean_cross_sum(
            x, local_comm=local, node_comm=node, wire=wire).float()
    data = np.random.default_rng(7).standard_normal((10, 6)).astype(np.float32)

    def exact_sites(moves):
        a = ht.array(data, split=0)
        out = {"mean": ht.mean(a, axis=0).numpy(), "var": ht.var(a, axis=0).numpy(),
               "sum": ht.sum(a, axis=0).numpy(), "gathered": a.numpy()}
        if moves:  # resplit reads HEAT_TPU_COLLECTIVE_PREC itself, as the JAX package's
            out["resplit1"] = ht.resplit(a, 1).larray.numpy()
            out["replicated"] = ht.resplit(a, None).larray.numpy()
        return out

    for label, env in (("exact", {}), ("hier_int8", {"HEAT_TPU_HIERARCHICAL_PREC": "int8"}),
                       ("coll_bf16", {"HEAT_TPU_COLLECTIVE_PREC": "bf16"})):
        os.environ.update(env)
        for k, v in exact_sites(label != "coll_bf16").items():
            res["sites_" + label + "_" + k] = v
        for k in env:
            del os.environ[k]
    os.environ["HEAT_TPU_HIERARCHICAL"] = "0"
    for k, v in exact_sites(True).items():
        res["sites_flat_" + k] = v
    res["flat_ag"] = comm.allgather(x[:250].clone(), 0, 1000)
    res["flat_a2a"] = comm.all_to_all(t, 0, 1, 8, 24)
    res["flat_psumi"] = comm.allreduce(xi.clone())
    daso = ht.optim.DASO(torch.optim.SGD([torch.nn.Parameter(torch.ones(2))], lr=0.1),
                         total_epochs=2)
    res["daso_nodes"] = np.array([daso.n_nodes, daso.n_local])
    return res
"""


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return spawn(tmp_path_factory.mktemp("topo"), 4, _SCRIPT,
                 env={"HEAT_TPU_TOPOLOGY": "2x2", "HEAT_TPU_HIERARCHICAL": "1"})


def _jax_tiered(fn, per_rank):
    """``fn(v)`` on each of four devices (rank ``r``'s input
    ``per_rank[r]``) under ``shard_map``; the stacked results."""
    comm = MeshCommunication(devices=jax.devices()[:4])
    ax = comm.axis_name
    run = jax.shard_map(lambda v: fn(v[0], ax)[None], mesh=comm.mesh, in_specs=P(ax),
                        out_specs=P(ax), check_vma=False)
    return np.asarray(run(jnp.asarray(np.stack(per_rank))))


def test_world_of_four_movers_match_the_reference_and_the_flat_ones(four):
    t22 = jtopo.Topology(2, 2)
    want_ag = _jax_tiered(lambda v, ax: jtopo.hier_all_gather(v, ax, t22),
                          [r["x"][:250] for r in four])
    want_a2a = _jax_tiered(lambda v, ax: jtopo.hier_all_to_all(v, ax, t22, 0, 1),
                           [r["t"] for r in four])
    for rank, r in enumerate(four):
        np.testing.assert_array_equal(r["ag"], want_ag[rank])
        np.testing.assert_array_equal(r["ag"], r["flat_ag"])
        np.testing.assert_array_equal(r["hier_a2a"], want_a2a[rank])
        np.testing.assert_array_equal(r["a2a"], want_a2a[rank])
        np.testing.assert_array_equal(r["a2a"], r["flat_a2a"])


def test_world_of_four_sums_match_the_reference(four):
    t22 = jtopo.Topology(2, 2)
    xs = np.stack([r["x"] for r in four])
    want_psum = _jax_tiered(lambda v, ax: jtopo.hier_psum(v, ax, t22), list(xs))
    want_rs = _jax_tiered(lambda v, ax: jtopo.hier_reduce_scatter(v, ax, t22), list(xs))
    ulp4 = 4 * np.finfo(np.float32).eps * float(np.abs(xs).sum(0).max())
    for rank, r in enumerate(four):
        np.testing.assert_allclose(r["psum"], want_psum[rank], rtol=0, atol=ulp4)
        np.testing.assert_allclose(r["rs"], want_rs[rank], rtol=0, atol=ulp4)
        np.testing.assert_array_equal(r["psumi"], r["flat_psumi"])
        np.testing.assert_array_equal(r["psumi"], np.stack([q["xi"] for q in four]).sum(0))


@pytest.mark.parametrize("mode", ["bf16", "int8", "blockwise"])
def test_world_of_four_compressed_cross_tier_within_the_bound(four, mode):
    xs = np.stack([r["x"] for r in four]).astype(np.float64)
    total = xs.sum(0)
    # the cross tier quantizes in-node partial sums (at most twice a payload)
    bound = cp.quant_error_bound(2 * float(np.abs(xs).max()) * 2, mode, 3) + 1e-5
    for rank, r in enumerate(four):
        assert np.abs(r["psum_" + mode] - total).max() <= bound
        padded = np.concatenate([total, np.zeros(24)])
        assert r["rs_" + mode].shape == (256,)
        assert np.abs(r["rs_" + mode] - padded[rank * 256:(rank + 1) * 256]).max() <= bound
        roundtrip = np.concatenate([cp.local_roundtrip(torch.from_numpy(q["x"][:250]),
                                                       mode).numpy() for q in four])
        np.testing.assert_array_equal(r["ag_" + mode], roundtrip)


def test_world_of_four_tiered_audits_match_the_cost_model(four):
    for r in four:
        for name in ("psum", "ag", "rs", "a2a", "psum_bf16", "psum_int8", "psum_blockwise"):
            ok, emitted, predicted = r[name + "_audit"]
            assert ok and emitted == predicted, (name, emitted, predicted)


@pytest.mark.parametrize("wire", ["off", "bf16", "int8"])
def test_world_of_four_daso_send_matches_the_reference(four, wire):
    comm = MeshCommunication(devices=jax.devices()[:4])
    mesh = jax.sharding.Mesh(np.asarray(comm.devices).reshape(2, 2), ("node", "local"))
    xs = np.stack([r["x"] for r in four])
    send = jax.shard_map(
        lambda v: jtopo.node_mean_cross_sum(v[0], local_axis="local", node_axis="node",
                                            n_node=2, wire=wire)[None].astype(jnp.float32),
        mesh=mesh, in_specs=P(("node", "local")), out_specs=P(("node", "local")),
        check_vma=False)
    want = np.asarray(send(jnp.asarray(xs)))
    bound = cp.quant_error_bound(2 * float(np.abs(xs).max()), "int8", 3) if wire == "int8" \
        else 2.0 ** -7 * float(np.abs(want).max())
    for rank, r in enumerate(four):
        assert np.abs(r["daso_send_" + wire] - want[rank]).max() <= bound
        assert tuple(r["daso_nodes"]) == (2, 2)


@pytest.mark.parametrize("label", ["hier_int8", "coll_bf16"])
def test_world_of_four_exact_sites_ignore_the_lossy_knobs(four, label):
    data = np.random.default_rng(7).standard_normal((10, 6)).astype(np.float32)
    for rank, r in enumerate(four):
        sites = [k[len("sites_exact_"):] for k in r if k.startswith("sites_exact_")]
        assert len(sites) == 6
        for k in sites:
            if k in ("resplit1", "replicated") and label == "coll_bf16":
                continue
            np.testing.assert_array_equal(r[f"sites_{label}_{k}"], r["sites_exact_" + k],
                                          err_msg=k)
        # the moves bit for bit the data and the flat world's
        np.testing.assert_array_equal(r["sites_exact_gathered"], data)
        np.testing.assert_array_equal(r["sites_exact_replicated"], data)
        np.testing.assert_array_equal(r["sites_exact_resplit1"], data[:, 2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(r["sites_exact_resplit1"], r["sites_flat_resplit1"])
        # the sums within 4 ulp of float64 (the tiers add in another order)
        d64 = data.astype(np.float64)
        for k, want in (("mean", d64.mean(0)), ("sum", d64.sum(0)),
                        ("var", d64.var(0))):
            ulp4 = 4 * np.finfo(np.float32).eps * float(np.abs(d64).sum(0).max())
            np.testing.assert_allclose(r["sites_exact_" + k], want, rtol=0, atol=ulp4,
                                       err_msg=k)
