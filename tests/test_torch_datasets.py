"""``heat_tpu_torch.datasets`` against ``heat_tpu.datasets``, and the
sources of the modules of this slice.

The port keeps its own copy of the seven CSVs: byte for byte the JAX
package's. ``load_iris``, ``load_iris_split`` and ``load_diabetes`` must
give the JAX package's arrays exactly (the same files through two CSV
parsers to float32), with their types and splits. ``regenerate`` writes
only to the directory it is given (scikit-learn is imported when called;
the test skips without it). No module of the port imports ``jax`` or
``heat_tpu`` (a grep of the ``import`` lines).
"""

import filecmp
import re
from pathlib import Path

import numpy as np
import pytest

import heat_tpu as ht_tpu
import heat_tpu.datasets as jdatasets

import heat_tpu_torch as htt
from heat_tpu_torch import datasets

REPO = Path(__file__).resolve().parent.parent
CSVS = sorted(p.name for p in (REPO / "heat_tpu" / "datasets").glob("*.csv"))


@pytest.fixture(autouse=True)
def on_cpu():
    htt.use_device("cpu")
    yield
    htt.use_device(None)


def test_the_port_carries_every_csv():
    assert len(CSVS) == 7
    assert sorted(p.name for p in (REPO / "heat_tpu_torch" / "datasets").glob("*.csv")) == CSVS


@pytest.mark.parametrize("name", CSVS)
def test_csv_copy_is_byte_for_byte(name):
    ours = Path(datasets.path(name))
    assert ours.parent == REPO / "heat_tpu_torch" / "datasets"
    assert filecmp.cmp(ours, REPO / "heat_tpu" / "datasets" / name, shallow=False)


def test_path_of_a_missing_file_names_the_choices():
    with pytest.raises(FileNotFoundError, match="iris.csv"):
        datasets.path("nope.csv")


def _same(got, want):
    assert got.shape == tuple(want.shape) and got.split == want.split
    assert got.dtype.__name__ == want.dtype.__name__
    assert np.array_equal(got.numpy(), np.asarray(want.numpy()))


@pytest.mark.parametrize("split", [None, 0])
def test_load_iris_matches_reference(split):
    for got, want in zip(datasets.load_iris(split=split), jdatasets.load_iris(split=split)):
        _same(got, want)


@pytest.mark.parametrize("split", [None, 0])
def test_load_iris_split_matches_reference(split):
    got, want = datasets.load_iris_split(split=split), jdatasets.load_iris_split(split=split)
    assert [g.shape for g in got] == [(105, 4), (45, 4), (105,), (45,)]
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("split", [None, 0])
def test_load_diabetes_matches_reference(split):
    for got, want in zip(datasets.load_diabetes(split=split), jdatasets.load_diabetes(split=split)):
        _same(got, want)


def test_iris_fits_as_in_the_reference():
    """The bundled iris through the port's KMeans and GaussianNB on the
    CPU: the labels the JAX package's estimators give."""
    X, _ = datasets.load_iris()
    Xj, _ = jdatasets.load_iris()
    init = X.numpy()[[0, 50, 100]]
    got = htt.cluster.KMeans(n_clusters=3, init=htt.array(init), max_iter=50).fit(X)
    want = ht_tpu.cluster.KMeans(n_clusters=3, init=ht_tpu.array(init), max_iter=50).fit(Xj)
    assert np.array_equal(got.labels_.numpy().ravel(), np.asarray(want.labels_.numpy()).ravel())
    Xtr, Xte, ytr, yte = datasets.load_iris_split()
    acc = (htt.naive_bayes.GaussianNB().fit(Xtr, ytr).predict(Xte).numpy() == yte.numpy()).mean()
    Jtr, Jte, jtr, jte = jdatasets.load_iris_split()
    jacc = (np.asarray(ht_tpu.naive_bayes.GaussianNB().fit(Jtr, jtr).predict(Jte).numpy())
            == np.asarray(jte.numpy())).mean()
    assert acc == jacc and acc > 0.9


def test_regenerate_writes_only_where_it_is_told(tmp_path):
    pytest.importorskip("sklearn")
    before = {p.name: p.stat().st_mtime_ns
              for p in (REPO / "heat_tpu_torch" / "datasets").glob("*.csv")}
    datasets.regenerate(str(tmp_path / "out"))
    written = sorted(p.name for p in (tmp_path / "out").iterdir())
    assert written == CSVS
    for name in CSVS:
        a = np.loadtxt(tmp_path / "out" / name, delimiter=";")
        b = np.loadtxt(datasets.path(name), delimiter=";")
        np.testing.assert_array_equal(a, b)
    after = {p.name: p.stat().st_mtime_ns
             for p in (REPO / "heat_tpu_torch" / "datasets").glob("*.csv")}
    assert after == before
    with pytest.raises(ValueError):
        datasets.regenerate(str(REPO / "heat_tpu_torch" / "datasets"))
    with pytest.raises(TypeError):
        datasets.regenerate()


NEW_MODULES = ["utils", "datasets", "telemetry"]
_IMPORTS = re.compile(r"^\s*(import|from)\s+(jax\b|heat_tpu\b(?!_torch))", re.M)


@pytest.mark.parametrize("package", NEW_MODULES)
def test_the_new_modules_import_neither_jax_nor_heat_tpu(package):
    files = sorted((REPO / "heat_tpu_torch" / package).rglob("*.py"))
    assert files
    offenders = [str(p) for p in files if _IMPORTS.search(p.read_text())]
    assert offenders == []
