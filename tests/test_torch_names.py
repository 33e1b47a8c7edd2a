"""The core names of heat_tpu that heat_tpu_torch lacked: the type
functions and type names at the package root, the estimator mixins and
predicates, the factories ``eye``/``linspace``/``logspace``/``meshgrid``,
the validation helpers and ``spatial.manhattan``.

One numpy input goes through both packages (heat_tpu on its 8-device CPU
mesh, heat_tpu_torch as a world of one rank on the CPU). Types and
predicates must give the reference's answers; arrays its type, split,
lshape map over 8 ranks and values (``eye``, ``meshgrid`` exactly,
``linspace`` exactly, ``logspace`` and ``manhattan`` within 1e-6
relative: ``pow`` and the sums round in the last place).
"""

import numpy as np
import pytest

import heat_tpu as ht_tpu

import heat_tpu_torch as htt
from heat_tpu_torch.core import communication as tcomm


@pytest.fixture(autouse=True)
def on_cpu():
    htt.use_device("cpu")
    yield
    htt.use_device(None)


ROOT_NAMES = [
    "datatype", "number", "integer", "signedinteger", "unsignedinteger", "floating",
    "flexible", "bool", "bool_", "byte", "short", "int", "long", "ubyte",
    "half", "float", "float_", "double", "cfloat", "csingle", "cdouble", "iinfo", "finfo",
    "heat_type_of", "heat_type_is_exact", "heat_type_is_inexact",
    "heat_type_is_complexfloating", "issubdtype", "result_type", "can_cast", "iscomplex",
    "isreal", "BaseEstimator", "ClassificationMixin", "ClusteringMixin", "RegressionMixin",
    "TransformMixin", "is_classifier", "is_estimator", "is_regressor", "is_transformer", "eye",
    "linspace", "logspace", "meshgrid", "sanitize_in", "sanitize_infinity", "sanitize_in_tensor",
    "sanitize_lshape", "sanitize_out", "sanitize_sequence", "scalar_to_1d", "sanitize_slice",
    "sanitize_axis", "sanitize_shape", "broadcast_shape",
    # the root names of the data and observability slice
    "Communication", "CommunicationError", "init_distributed", "perf_stats", "reset_perf_stats",
    "binary_op", "local_op", "reduce_op", "cum_op", "program_cache", "basics", "quant", "solver",
    "utils", "datasets", "load_checkpoint", "save_checkpoint", "supports_checkpoint",
]

# the names of heat_tpu's root that the port lacks, and why
LACKED_BY_DESIGN = {
    "MeshCommunication": "the JAX device-mesh communicator; the port's is TorchCommunication "
                         "over torch.distributed, one process a rank",
}
LACKED_FOR_NOW = {
    # at either root only once something has imported it: heatlint is a tool
    "analysis": "heat_tpu_torch.analysis, imported on demand as heat_tpu.analysis",
}


def test_the_reference_root_minus_the_lacked_names_is_in_the_port():
    missing = {n for n in dir(ht_tpu) if not n.startswith("_")} - set(dir(htt))
    assert missing - set(LACKED_BY_DESIGN) - set(LACKED_FOR_NOW) == set()
    assert set(LACKED_BY_DESIGN) <= missing


@pytest.mark.parametrize("module,name", [
    ("random", "Type"), ("io", "save_netcdf_local"), ("io", "supports_checkpoint"),
    ("io", "save_checkpoint"), ("io", "load_checkpoint"), ("io", "CommunicationError"),
    ("resilience.guard", "HeatTpuRuntimeError"), ("telemetry", "op_cost"),
    ("telemetry", "SLO"), ("telemetry", "export_trace"), ("telemetry", "summarize_cluster"),
    ("utils.data", "DataLoader"), ("utils.data", "PartialH5Dataset"),
    ("datasets", "load_iris")])
def test_submodule_name_exists_as_in_the_reference(module, name):
    import functools

    for pkg in (ht_tpu, htt):
        assert hasattr(functools.reduce(getattr, module.split("."), pkg), name), (pkg, module)


def test_op_wrappers_take_torch_callables():
    import torch

    x = htt.array(np.arange(6, dtype=np.float32).reshape(3, 2), split=0)
    assert torch.equal(htt.local_op(torch.exp, x).larray, torch.exp(x.larray))
    assert np.array_equal(htt.binary_op(torch.add, x, x).numpy(), 2 * x.numpy())


def test_io_checkpoint_names_map_onto_resilience(tmp_path):
    x = htt.array(np.arange(12, dtype=np.float32).reshape(4, 3), split=0)
    assert htt.supports_checkpoint()
    htt.save_checkpoint({"x": x, "step": 3}, str(tmp_path / "ck"))
    back = htt.load_checkpoint(str(tmp_path / "ck"), like={"x": x, "step": 0})
    assert np.array_equal(back["x"].numpy(), x.numpy()) and back["step"] == 3


def test_init_distributed_refuses_a_second_start(monkeypatch):
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    with pytest.raises(htt.CommunicationError, match="already"):
        htt.init_distributed("127.0.0.1:1", 1, 0)
    assert issubclass(htt.CommunicationError, RuntimeError)
    assert isinstance(htt.get_comm(), htt.Communication)


@pytest.mark.parametrize("name", ROOT_NAMES)
def test_root_name_exists_as_in_the_reference(name):
    assert hasattr(ht_tpu, name)
    assert hasattr(htt, name), name


@pytest.mark.parametrize("name", ["bool", "bool_", "byte", "short", "int", "long", "ubyte",
                                  "half", "float", "float_", "double", "cfloat", "csingle",
                                  "cdouble"])
def test_type_aliases_name_the_reference_types(name):
    assert getattr(htt, name).__name__ == getattr(ht_tpu, name).__name__


TYPES = ["bool", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64",
         "float16", "bfloat16", "float32", "float64", "complex64", "complex128"]
ABSTRACT = ["datatype", "number", "integer", "signedinteger", "unsignedinteger", "floating",
            "complexfloating", "flexible"]


@pytest.mark.parametrize("name", TYPES)
def test_type_predicates(name):
    t, r = getattr(htt, name), getattr(ht_tpu, name)
    for fn in ("heat_type_is_exact", "heat_type_is_inexact", "heat_type_is_complexfloating"):
        assert getattr(htt, fn)(t) == getattr(ht_tpu, fn)(r), fn
    for abstract in ABSTRACT:
        assert htt.issubdtype(t, getattr(htt.core.types, abstract)) == \
            ht_tpu.issubdtype(r, getattr(ht_tpu.core.types, abstract)), abstract
    for other in TYPES:
        for casting in ("intuitive", "safe", "same_kind", "unsafe", "no"):
            assert htt.can_cast(t, getattr(htt, other), casting) == \
                ht_tpu.can_cast(r, getattr(ht_tpu, other), casting), (other, casting)


@pytest.mark.parametrize("name", ["float16", "bfloat16", "float32", "float64", "complex64"])
def test_finfo(name):
    got, want = htt.finfo(getattr(htt, name)), ht_tpu.finfo(getattr(ht_tpu, name))
    assert (got.bits, got.eps, got.max, got.min, got.tiny) == \
        (want.bits, want.eps, want.max, want.min, want.tiny)


def test_iinfo_and_finfo_refuse_the_other_kind():
    for ht in (htt, ht_tpu):
        with pytest.raises(TypeError):
            ht.iinfo(ht.float32)
        with pytest.raises(TypeError):
            ht.iinfo(ht.bool)
        with pytest.raises(TypeError):
            ht.finfo(ht.int32)


OBJECTS = [True, 3, 2.5, 1j, np.float64(1), np.int8(3), [1, 2], [1.5, 2.0],
           np.zeros(2, np.uint16)]


@pytest.mark.parametrize("obj", OBJECTS, ids=[repr(o) for o in OBJECTS])
def test_heat_type_of(obj):
    assert htt.heat_type_of(obj).__name__ == ht_tpu.heat_type_of(obj).__name__


RESULT_ARGS = [
    ("int32", 2.5), ("uint8", "int8"), ("float16", 3), ("bool", 2), ("int64", "float32"),
    ("uint64", "int64"), (1, 2.0), ("uint32", "int16"), ("complex64", "float64"),
]


@pytest.mark.parametrize("args", RESULT_ARGS, ids=[str(a) for a in RESULT_ARGS])
def test_result_type(args):
    def conv(ht, a):
        return getattr(ht, a) if isinstance(a, str) else a

    got = htt.result_type(*(conv(htt, a) for a in args))
    want = ht_tpu.result_type(*(conv(ht_tpu, a) for a in args))
    assert got.__name__ == want.__name__


@pytest.mark.parametrize("split", [None, 0])
def test_iscomplex_isreal(split):
    x = np.array([1 + 0j, 2 + 1j, 0j, 3 - 2j], np.complex64)
    for name in ("iscomplex", "isreal"):
        _check(getattr(htt, name)(htt.array(x, split=split)),
               getattr(ht_tpu, name)(ht_tpu.array(x, split=split)))
        _check(getattr(htt, name)(htt.array(x.real.copy(), split=split)),
               getattr(ht_tpu, name)(ht_tpu.array(x.real.copy(), split=split)))


def test_estimator_mixins_and_predicates():
    class Reg(htt.BaseEstimator, htt.RegressionMixin):
        pass

    class Clf(htt.BaseEstimator, htt.ClassificationMixin):
        pass

    class Tr(htt.BaseEstimator, htt.TransformMixin):
        pass

    for est, flags in ((Reg(), (False, True, True, False)), (Clf(), (True, True, False, False)),
                       (Tr(), (False, True, False, True)), (object(), (False, False, False, False))):
        assert (htt.is_classifier(est), htt.is_estimator(est), htt.is_regressor(est),
                htt.is_transformer(est)) == flags
    with pytest.raises(NotImplementedError):
        Reg().fit(None, None)
    with pytest.raises(NotImplementedError):
        Tr().fit_transform(None)
    assert htt.is_regressor(htt.regression.Lasso())
    assert htt.is_estimator(htt.cluster.Spectral(n_clusters=2))


def test_sanitation_helpers():
    x = htt.array(np.arange(12, dtype=np.int32).reshape(4, 3), split=0)
    for ht, a in ((htt, x), (ht_tpu, ht_tpu.array(np.arange(12, dtype=np.int32).reshape(4, 3),
                                                  split=0))):
        assert ht.sanitize_infinity(a) == np.iinfo(np.int32).max
        assert ht.sanitize_infinity(ht.array(np.ones(2, np.float32))) == float("inf")
        assert ht.sanitize_sequence((1, 2)) == [1, 2]
        assert ht.sanitize_sequence(ht.array([1, 2])) == [1, 2]
        with pytest.raises(ValueError):
            ht.sanitize_sequence(a)
        with pytest.raises(TypeError):
            ht.sanitize_sequence("ab")
        one = ht.scalar_to_1d(ht.array(5))
        assert one.shape == (1,) and one.split is None and int(one.numpy()[0]) == 5
        with pytest.raises(ValueError):
            ht.scalar_to_1d(a)
        with pytest.raises(ValueError):
            ht.sanitize_lshape(a, np.zeros((2, 2)))
    htt.sanitize_lshape(x, np.zeros((1, 3)))
    htt.sanitize_in_tensor(x.larray)
    with pytest.raises(TypeError):
        htt.sanitize_in_tensor(x)
    for sl, n in ((slice(None), 5), (slice(-3, None, 2), 7), (slice(1, 100, -1), 6)):
        assert htt.sanitize_slice(sl, n) == ht_tpu.sanitize_slice(sl, n)
    with pytest.raises(TypeError):
        htt.sanitize_slice(3, 4)


def _check(got, ref, rtol=0.0):
    assert got.dtype.__name__ == ref.dtype.__name__
    assert got.shape == tuple(ref.shape) and got.split == ref.split
    if got.split is not None:
        np.testing.assert_array_equal(tcomm.lshape_map(got.shape, got.split, 8), ref.lshape_map)
    g, r = got.numpy(), np.asarray(ref.numpy())
    if rtol:
        np.testing.assert_allclose(g, r, rtol=rtol)
    else:
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("shape,dtype", [(5, "float32"), ((11, 4), "int32"), ((3, 9), "bool"),
                                         ((9,), "float64")])
def test_eye(shape, dtype, split):
    _check(htt.eye(shape, dtype=getattr(htt, dtype), split=split),
           ht_tpu.eye(shape, dtype=getattr(ht_tpu, dtype), split=split))


LINSPACE = [(0.0, 1.0, 11, True, None), (-3.5, 7.25, 37, False, None), (2, 9, 1, True, None),
            (1.0, 0.1, 50, True, None), (0.0, 10.0, 13, True, "int32"),
            (0.0, 1.0, 9, True, "float64")]


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("start,stop,num,endpoint,dtype", LINSPACE)
def test_linspace_and_logspace(start, stop, num, endpoint, dtype, split):
    kw = {} if dtype is None else {"dtype": getattr(htt, dtype)}
    kw_ref = {} if dtype is None else {"dtype": getattr(ht_tpu, dtype)}
    got, step = htt.linspace(start, stop, num, endpoint, retstep=True, split=split, **kw)
    want, ref_step = ht_tpu.linspace(start, stop, num, endpoint, retstep=True, split=split,
                                     **kw_ref)
    _check(got, want)
    assert step == ref_step
    if dtype is None:
        _check(htt.logspace(start, stop, num, endpoint, base=2.0, split=split),
               ht_tpu.logspace(start, stop, num, endpoint, base=2.0, split=split), rtol=1e-6)
    with pytest.raises(ValueError):
        htt.linspace(0.0, 1.0, 0)


@pytest.mark.parametrize("indexing", ["xy", "ij"])
@pytest.mark.parametrize("splits", [(None, None), (0, None), (None, 0), (None, None, 0)])
def test_meshgrid(splits, indexing):
    vecs = [np.arange(5, dtype=np.float32), np.arange(7, dtype=np.int64) * 2,
            np.linspace(0, 1, 3)][:len(splits)]
    got = htt.meshgrid(*[htt.array(v, split=s) for v, s in zip(vecs, splits)], indexing=indexing)
    want = ht_tpu.meshgrid(*[ht_tpu.array(v, split=s) for v, s in zip(vecs, splits)],
                           indexing=indexing)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _check(g, w)
    with pytest.raises(ValueError):
        htt.meshgrid(htt.array(vecs[0], split=0), htt.array(vecs[1], split=0))


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("dtype", ["float32", "float64", "int32"])
def test_manhattan(dtype, split):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((13, 6)) * 4).astype(dtype)
    y = (rng.standard_normal((9, 6)) * 4).astype(dtype)
    _check(htt.spatial.manhattan(htt.array(x, split=split)),
           ht_tpu.spatial.manhattan(ht_tpu.array(x, split=split)), rtol=1e-6)
    _check(htt.spatial.manhattan(htt.array(x, split=split), htt.array(y)),
           ht_tpu.spatial.manhattan(ht_tpu.array(x, split=split), ht_tpu.array(y)), rtol=1e-6)
    # ring=True on one rank: the gate sends it to the ordinary path, as there
    _check(htt.spatial.manhattan(htt.array(x, split=split), ring=True),
           ht_tpu.spatial.manhattan(ht_tpu.array(x, split=split), ring=True), rtol=1e-6)
