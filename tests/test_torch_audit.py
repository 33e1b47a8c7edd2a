"""The collective audit (``telemetry.hlo``) against heat_tpu's.

The JAX package parses the collectives XLA compiled; the port records the
ones it issues. Held here:

* ``compare``'s verdicts and the wire-byte rule equal the JAX package's on
  the same collectives (exact);
* ``audit_call`` on a world of one records nothing, re-raises the call's
  error, nests, and obeys ``HEAT_TPU_HLO_AUDIT``;
* on a gloo world of four ranks (one spawned world, a module fixture):
  ``resplit`` (between split axes, to and from replicated), the ring
  ``cdist``/``manhattan`` (``p - 1`` hops with the overlap, ``p`` without),
  ``qr`` (TSQR and both Gram rings of CholeskyQR2) and the sparse products
  audit with no drift against the analytic cost, and issue the wire bytes
  that the JAX package's audit of the same program on a four-device mesh
  predicts, with the kinds of collective it emitted (exact); the sparse
  transpose reports its drift (the port moves the stored elements, the
  cost model counts worst-case slabs);
* ``python -m heat_tpu_torch.telemetry.audit`` exits 1 on a world of one
  (nothing audited) and 0 on each of four gloo ranks under ``--distributed``.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest

import heat_tpu as ht_tpu
from heat_tpu.core.communication import MeshCommunication
from heat_tpu.telemetry import collectives as jc
from heat_tpu.telemetry import hlo as jhlo

import heat_tpu_torch as htt
from heat_tpu_torch import telemetry
from heat_tpu_torch.telemetry import audit as taudit
from heat_tpu_torch.telemetry import collectives as tc
from heat_tpu_torch.telemetry import hlo

REPO = Path(__file__).resolve().parent.parent
WORLD = 4


@pytest.fixture(autouse=True)
def on_cpu():
    htt.use_device("cpu")
    yield
    htt.use_device(None)


# ------------------------------------------------------------ compare, exact

OPS = ["all-gather", "all-to-all", "reduce-scatter", "all-reduce", "collective-permute"]


@pytest.mark.parametrize("op", OPS)
def test_wire_bytes_rule_matches_reference(op):
    for in_b, out_b, g, n, pairs in [(64, 256, 4, 4, 4), (100, 100, 1, 1, 0), (8, 64, 8, 8, 8),
                                     (33, 99, 3, 6, 2)]:
        assert hlo._wire_bytes(op, in_b, out_b, g, n, pairs) == \
            jhlo._wire_bytes(op, in_b, out_b, g, n, pairs)


def _both(op, name, in_b, out_b, g):
    kw = dict(op=op, name=name, dtype="f32", shapes=((4,),), in_bytes=in_b, out_bytes=out_b,
              group_size=g, n_participants=g, groups=(),
              wire_bytes=jhlo._wire_bytes(op, in_b, out_b, g, g, g))
    return hlo.EmittedCollective(**kw), jhlo.EmittedCollective(**kw)


CASES = [
    ([("all-to-all", 256, 256, 4)], ("all-to-all", 768)),
    ([("all-to-all", 256, 256, 4)], ("all-to-all", 1000)),           # byte drift
    ([("all-gather", 64, 256, 4)], ("all-to-all", 768)),             # missing + unexpected
    ([("collective-permute", 64, 64, 4)] * 3, ("ppermute-ring", 768)),
    ([("collective-permute", 64, 64, 4)] * 3 + [("all-gather", 32, 128, 4)],
     ("ppermute-ring+all-gather", 1152)),
    ([], ("none", 0)),
    ([("all-reduce", 40, 40, 4)], ("local-slice", 0)),               # unexpected
    ([("all-reduce", 40, 40, 4)], ("mystery", 10)),                  # unknown kind
    ([("all-reduce", 40, 40, 4)], ("all-reduce", 239)),              # within 10%
]


@pytest.mark.parametrize("tolerance", [None, 0.01, 0.5])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_compare_verdicts_match_reference(case, tolerance):
    issued, (kind, b) = CASES[case]
    pairs = [_both(op, f"c{i}", i_b, o_b, g) for i, (op, i_b, o_b, g) in enumerate(issued)]
    got = hlo.compare(hlo.CollectiveAudit([p[0] for p in pairs], 4), tc.CollectiveCost(kind, b),
                      tolerance=0.1 if tolerance is None else tolerance, steps=1)
    want = jhlo.compare(jhlo.CollectiveAudit([p[1] for p in pairs], 4),
                        jc.CollectiveCost(kind, b), tolerance=0.1 if tolerance is None else
                        tolerance, steps=1)
    g, w = got.summary(), want.summary()
    for d in g["drifts"] + w["drifts"]:  # the wording names each package's source of truth
        d.pop("detail")
    assert g == w


def test_compare_does_not_scale_the_issued_permutes():
    """The port records every hop, so a ring of three hops is three
    permutes: no scaling by the predicted steps (the JAX package scales the
    one permute its loop body holds)."""
    audit = hlo.CollectiveAudit([_both("collective-permute", "p", 64, 64, 4)[0]] * 3, 4)
    rep = hlo.compare(audit, tc.ring_cdist_cost(64, 1, 4, 4, hops=3))
    assert rep.ok and rep.emitted_bytes == 3 * 64 * 4


def test_tolerance_follows_the_knob(monkeypatch):
    audit = hlo.CollectiveAudit([_both("all-reduce", "r", 100, 100, 2)[0]], 2)
    cost = tc.CollectiveCost("all-reduce", 230)  # 200 issued: 13% off
    assert not hlo.compare(audit, cost).ok
    monkeypatch.setenv("HEAT_TPU_HLO_TOLERANCE", "0.2")
    assert hlo.compare(audit, cost).ok
    monkeypatch.setattr(hlo, "DEFAULT_TOLERANCE", 0.01)
    assert not hlo.compare(audit, cost).ok


# ------------------------------------------------------ audit_call, world of one


def test_audit_call_on_a_world_of_one_records_no_collective():
    hlo.clear()
    x = htt.array(np.ones((6, 4), np.float32), split=0)
    out, rec = hlo.audit_call("probe", lambda: htt.resplit(x, 1),
                              predicted=tc.relayout_cost((6, 4), 4, 0, 1, 1))
    assert out.split == 1 and rec.audit.collectives == [] and rec.report.ok
    assert hlo.last_audit("probe") is rec and hlo.recent() == [rec]
    assert hlo.last_audit("other") is None


def test_audit_call_records_what_the_communication_layer_reports():
    def fake_collectives():
        telemetry.trace_event("all_gather", op="all-gather", in_bytes=16, out_bytes=64,
                              group_size=4)
        telemetry.trace_event("allgather_object", group_size=4)  # counted, not audited
        _, inner = hlo.audit_call("inner", lambda: telemetry.trace_event(
            "ppermute", op="collective-permute", in_bytes=16, out_bytes=16, group_size=4,
            pairs=[(0, 1), (1, 2), (2, 3), (3, 0), (1, 1)]))
        return inner

    inner, outer = hlo.audit_call("outer", fake_collectives)
    assert [c.op for c in outer.audit.collectives] == ["all-gather", "collective-permute"]
    assert [c.op for c in inner.audit.collectives] == ["collective-permute"]
    assert inner.audit.collectives[0].wire_bytes == 16 * 4  # the self pair moves nothing
    # the gather: 64 bytes out, 3 of 4 parts received, on each of 4 ranks
    assert outer.audit.wire_by_op() == {"all-gather": 192, "collective-permute": 64}
    assert outer.report is None and outer.audit.n_devices == 4


def test_audit_call_reraises_and_closes_the_recording():
    with pytest.raises(ZeroDivisionError):
        hlo.audit_call("boom", lambda: 1 / 0)
    assert hlo._RECORDING == 0 and hlo._stack() == []


def test_the_global_audit_flag():
    assert not hlo.audit_enabled()
    hlo.enable_audit()
    try:
        assert hlo.audit_enabled() and telemetry.op_cost(tc.tsqr_cost, 8, 2, 4, 2)[2]
    finally:
        hlo.disable_audit()
    code = ("import heat_tpu_torch.telemetry.hlo as h; print(h.audit_enabled())")
    env = dict(os.environ, HEAT_TPU_HLO_AUDIT="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.stdout.strip() == "True", out.stderr


def test_audit_event_while_recording():
    reg = telemetry.get_registry()
    reg.clear()
    telemetry.enable()
    try:
        hlo.audit_call("evt", lambda: telemetry.trace_event(
            "all_to_all", op="all-to-all", in_bytes=64, out_bytes=64, group_size=4),
            predicted=tc.CollectiveCost("all-to-all", 192), fields={"mesh": 4})
        (ev,) = [e for e in reg.events if e["kind"] == "hlo_audit"]
        assert (ev["ok"], ev["drift"], ev["emitted_bytes"], ev["mesh"]) == (True, 0, 192, 4)
        assert telemetry.report.summarize()["hlo_collectives"]["sites"]["evt"]["audits"] == 1
    finally:
        telemetry.disable()
        reg.clear()


def test_cli_on_a_world_of_one_exits_1(capsys):
    # an instrumented op on one rank moves nothing, so nothing is audited
    rc = taudit.main(["--device", "cpu", "htt.resplit(htt.ones((8, 4), split=0), 1)"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 1 and out["n_audits"] == 0 and out["world"] == 1 and "error" in out
    telemetry.disable()
    hlo.disable_audit()
    rc = taudit.main(["--device", "cpu", "htt.ones(3) + 1"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 1 and out["n_audits"] == 0 and "error" in out
    telemetry.disable()
    hlo.disable_audit()


# ------------------------------------------------------------ four gloo ranks

_DATA = textwrap.dedent("""
    def _AUDITED(ht):
        rng = np.random.default_rng(11)
        x = rng.standard_normal((64, 16)).astype(np.float32)
        x1 = rng.standard_normal((96, 12)).astype(np.float32)
        s = (rng.random((64, 64)) < 0.1).astype(np.float32)
        v = np.ones(64, np.float32)
        X = rng.standard_normal((64, 5)).astype(np.float32)
        return {
            "resplit_0_1": lambda: ht.resplit(ht.array(x, split=0), 1, audit=True),
            "resplit_0_none": lambda: ht.array(x, split=0).resplit(None, audit=True),
            "resplit_1_0": lambda: ht.resplit(ht.array(x1, split=1), 0, audit=True),
            "resplit_none_0": lambda: ht.resplit(ht.array(x), 0, audit=True),
            "ring_cdist": lambda: ht.spatial.cdist(ht.array(x, split=0), ht.array(x, split=0),
                                                   ring=True, audit=True),
            "ring_manhattan": lambda: ht.spatial.manhattan(ht.array(x, split=0), ring=True,
                                                           audit=True),
            "tsqr": lambda: ht.linalg.qr(ht.array(x, split=0), audit=True),
            "cholqr_gram_ring": lambda: ht.linalg.qr(ht.array(x1, split=1), audit=True),
            "sparse.spmv": lambda: ht.sparse.spmv(ht.sparse.csr_from_dense(ht.array(s, split=0)),
                                                  ht.array(v, split=0), out_split=None,
                                                  audit=True),
            "sparse.spmm": lambda: ht.sparse.spmm(ht.sparse.csr_from_dense(ht.array(s, split=0)),
                                                  ht.array(X, split=0), out_split=None,
                                                  audit=True),
            "sparse.transpose_a2a": lambda: ht.sparse.transpose(
                ht.sparse.csr_from_dense(ht.array(s, split=0)), audit=True),
        }
""")

_WORKER = _DATA + textwrap.dedent("""
    import json
    import os
    import sys
    import numpy as np
    import torch.distributed as dist
    rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    import heat_tpu_torch as ht
    from heat_tpu_torch.telemetry import hlo
    ht.use_device("cpu")
    res = {}
    for serial in (False, True):
        if serial:  # the serial ring schedule: p hops
            os.environ["HEAT_TPU_RING_OVERLAP"] = "0"
        for name, call in _AUDITED(ht).items():
            if serial and "ring" not in name:
                continue
            hlo.clear()
            call()
            recs = [r.summary() for r in hlo.recent()]
            res[name + ("_serial" if serial else "")] = recs
    with open(f"{out}/rank{rank}.json", "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(argvs, env):
    procs = [subprocess.Popen(argv, cwd=REPO, env=e, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for argv, e in zip(argvs, env)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=300)[0])
        finally:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return logs


@pytest.fixture(scope="module")
def gloo_ranks(tmp_path_factory):
    """One spawned world of four gloo ranks; each rank's audit records."""
    out = tmp_path_factory.mktemp("audit_gloo")
    port = _free_port()
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    _spawn([[sys.executable, "-c", _WORKER, str(r), str(WORLD), str(port), str(out)]
            for r in range(WORLD)], [env] * WORLD)
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(WORLD)]


SITES = ["resplit_0_1", "resplit_0_none", "resplit_1_0", "resplit_none_0", "ring_cdist",
         "ring_manhattan", "tsqr", "cholqr_gram_ring", "sparse.spmv", "sparse.spmm",
         "ring_cdist_serial", "ring_manhattan_serial"]


@pytest.mark.parametrize("site", SITES)
def test_gloo_audit_has_no_drift(gloo_ranks, site):
    for rank in gloo_ranks:
        recs = rank[site]
        assert recs, site
        for rec in recs:
            rep = rec["report"]
            assert rep["ok"], (site, rep)
            assert rep["emitted_bytes"] == rep["predicted_bytes"], (site, rep)


@pytest.mark.parametrize("serial", [False, True])
@pytest.mark.parametrize("site", ["ring_cdist", "ring_manhattan"])
def test_gloo_ring_hops(gloo_ranks, site, serial):
    """``p - 1`` hops with the overlap, ``p`` serially, and the cost
    model's ``ring_cdist_cost`` with those hops (the JAX package's)."""
    hops = WORLD if serial else WORLD - 1
    want = jc.ring_cdist_cost(64, 16, 4, WORLD, hops=hops)
    for rank in gloo_ranks:
        (rec,) = rank[site + ("_serial" if serial else "")]
        assert rec["audit"]["ops"] == {"collective-permute": hops}
        assert rec["report"]["predicted_bytes"] == want.bytes
        assert rec["site"] == "ring_cdist"


def test_gloo_qr_audits_both_gram_passes(gloo_ranks):
    for rank in gloo_ranks:
        recs = rank["cholqr_gram_ring"]
        assert [r["site"] for r in recs] == ["cholqr_gram_ring"] * 2
        for r in recs:
            assert r["audit"]["ops"] == {"collective-permute": WORLD - 1, "all-gather": 1}
        assert rank["tsqr"][0]["audit"]["ops"] == {"all-gather": 1}


def test_gloo_transpose_reports_its_drift(gloo_ranks):
    for rank in gloo_ranks:
        (rec,) = rank["sparse.transpose_a2a"]
        reasons = {d["reason"] for d in rec["report"]["drifts"]}
        # fewer bytes than the worst-case slabs, and the counts' gather
        assert reasons == {"byte-drift", "unexpected-collective"}
        assert rec["report"]["emitted_bytes"] < rec["report"]["predicted_bytes"]


def _jax_audit(site, call):
    jhlo.clear()
    jhlo.enable_audit()
    try:
        call()
    finally:
        jhlo.disable_audit()
    return [r for r in jhlo.recent() if r.site == site]


@pytest.mark.parametrize("site", ["resplit_0_1", "resplit_1_0", "ring_cdist", "tsqr",
                                  "cholqr_gram_ring"])
def test_gloo_audit_matches_the_reference_audit(gloo_ranks, site):
    """The JAX package's audit of the same program on a four-device mesh:
    the port issues the bytes that its prediction (its cost model on its
    padded buffers) gives, and the kinds of collective it emitted. Its
    emitted bytes are no reference here: under this jax version its HLO
    parser reads zero operand bytes for the all-to-all and the permutes
    (it flags its own byte drift), so the prediction is held instead."""
    comm = MeshCommunication(devices=jax.devices()[:WORLD])
    ns = {"np": np}
    exec(_DATA, ns)
    calls = ns["_AUDITED"](_JaxNamespace(comm))
    jax_site = {"resplit_0_1": "resplit", "resplit_1_0": "resplit"}.get(site, site)
    recs = _jax_audit(jax_site, calls[site])
    mine = gloo_ranks[0][site]
    assert recs and len(recs) == len(mine), site
    for got, ref in zip(mine, recs):
        assert got["report"]["emitted_bytes"] == ref.report.predicted_bytes
        assert set(got["audit"]["ops"]) == set(ref.audit.counts())


class _JaxNamespace:
    """``heat_tpu`` with ``array`` on a mesh of the world's size."""

    def __init__(self, comm):
        self._comm = comm

    def array(self, x, split=None):
        return ht_tpu.array(x, split=split, comm=self._comm)

    def __getattr__(self, name):
        return getattr(ht_tpu, name)


def test_cli_on_four_gloo_ranks(tmp_path):
    port = _free_port()
    expr = "htt.resplit(htt.array(np.arange(256, dtype=np.float32).reshape(16, 16), split=0), 1)"
    envs = [dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(r),
                 WORLD_SIZE=str(WORLD)) for r in range(WORLD)]
    trace = [str(tmp_path / f"trace{r}.json") for r in range(WORLD)]
    logs = _spawn([[sys.executable, "-m", "heat_tpu_torch.telemetry.audit", "--distributed",
                    "--device", "cpu", "--trace", trace[r], expr] for r in range(WORLD)], envs)
    for r, log in enumerate(logs):
        out = json.loads(log[log.index("{"):])
        assert (out["rank"], out["world"], out["ok"], out["drift"]) == (r, WORLD, True, 0)
        assert out["audits"][0]["audit"]["ops"] == {"all-to-all": 1}
        assert json.loads(open(trace[r]).read())["traceEvents"]
