"""The comparison that decides ``correct``, shown to fail: the control (the
reference computed in TF32 in the program's place, through the same window
and judge) and each fault a cell can have, planted in the program underneath
a whole run, on the CPU at a tiny size. The limits are the cells' own
(``workloads/<name>.json``)."""

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402

TINY = {
    "kmeans.higgs": ({"rows": 40000}, {}),
    "cdist_block.susy-160k": ({"rows": 3000}, {"query_rows": 800}),
    "cdist.susy-160k.x4": ({"rows": 3000}, {}),
}
SEED = 2 ** 31 + 21


def tiny_cell(name):
    cell = harness.load_cell(name)
    cfg, traffic = TINY[name]
    cell["config"].update(cfg)
    cell["traffic"].update(traffic)
    return cell


def over(numbers, limits):
    """The numbers that fail their limits (nan fails)."""
    return [k for k, v in numbers.items() if not v <= limits[k]]


@pytest.mark.parametrize("name", ["kmeans.higgs", "cdist_block.susy-160k"])
def test_control_fails_and_program_passes(name):
    # the four-card cell's control runs on four ranks: test_x4_faults
    cell = tiny_cell(name)
    control = harness.run_rank(cell, SEED, 0.2, False, device="cpu", control=True)
    assert not control["correct"] and control["failed"] == 1, control["checks"]
    out = harness.run_rank(cell, SEED, 0.2, False, device="cpu")
    assert out["correct"], out["checks"]


def _kmeans_mod():
    import heat_tpu_torch.cluster.kmeans as mod

    return mod


def _state_unchanged(monkeypatch):
    mod = _kmeans_mod()
    monkeypatch.setattr(mod, "lloyd_fit", lambda x, c0, max_iter, tol, comm, update:
                        (c0.clone(), max_iter))


def _half_batch(monkeypatch):
    mod = _kmeans_mod()
    orig = mod.lloyd_update
    monkeypatch.setattr(mod, "lloyd_update",
                        lambda x, c, lim=None: orig(x[:x.shape[0] // 2], c))


def _label_altered(monkeypatch):
    mod = _kmeans_mod()
    orig = mod.KMeans.fit

    def fit(self, x):
        out = orig(self, x)
        lab = out.labels_.larray
        lab[0] = (lab[0] + 1) % self.n_clusters
        return out

    monkeypatch.setattr(mod.KMeans, "fit", fit)


def _center_altered(monkeypatch):
    mod = _kmeans_mod()
    orig = mod.KMeans.fit

    def fit(self, x):
        out = orig(self, x)
        out.cluster_centers_.larray[0, 0] += 1e-3
        return out

    monkeypatch.setattr(mod.KMeans, "fit", fit)


def _cdist_mod():
    import heat_tpu_torch.spatial.cuda_cdist as mod

    return mod


def _half_rows(monkeypatch):
    mod = _cdist_mod()
    orig = mod.euclid

    def euclid(x, y, *a, **k):
        out = torch.zeros((x.shape[0], y.shape[0]), dtype=x.dtype)
        half = x.shape[0] // 2
        out[:half] = orig(x[:half], y, *a, **k)
        return out

    monkeypatch.setattr(mod, "euclid", euclid)


def _distance_altered(monkeypatch):
    mod = _cdist_mod()
    orig = mod.euclid

    def euclid(x, y, *a, **k):
        out = orig(x, y, *a, **k)
        out[3, 5] += 0.01
        return out

    monkeypatch.setattr(mod, "euclid", euclid)


FAULTS = [
    ("kmeans.higgs", _state_unchanged, "last_gap"),
    ("kmeans.higgs", _half_batch, "last_gap"),
    ("kmeans.higgs", _label_altered, "label_gap"),
    ("kmeans.higgs", _center_altered, "last_gap"),
    ("cdist_block.susy-160k", _half_rows, "dist_gap"),
    ("cdist_block.susy-160k", _distance_altered, "dist_gap"),
]


@pytest.mark.parametrize("name,fault,fails", FAULTS,
                         ids=[f"{n}-{f.__name__.strip('_')}" for n, f, _ in FAULTS])
def test_one_card_faults(monkeypatch, name, fault, fails):
    fault(monkeypatch)
    out = harness.run_rank(tiny_cell(name), SEED, 0.2, False, device="cpu")
    assert not out["correct"] and out["failed"] == 1
    checks = {k: v["value"] for k, v in out["checks"].items()}
    assert fails in over({k: float("nan") if v is None else v for k, v in checks.items()},
                         tiny_cell(name)["limits"]), checks


# planted in every rank process before the run: the all-gather of y left
# out (each rank's own rows stand in for the others'), or one distance
# altered on rank 2 alone
X4_FAULTS = {
    "exchange": """
from heat_tpu_torch.core import communication as c
def allgather(self, local, dim, n, precision=None):
    return torch.cat([local] * self.size, dim=dim).narrow(dim, 0, n)
c.TorchCommunication.allgather = allgather
""",
    "altered": """
import heat_tpu_torch.spatial.cuda_cdist as m
orig = m.euclid
def euclid(x, y, *a, **k):
    out = orig(x, y, *a, **k)
    if sys.argv[sys.argv.index("--rank") + 1] == "2":
        out[7, 11] += 0.01
    return out
m.euclid = euclid
""",
}


@pytest.mark.parametrize("fault", [None, "exchange", "altered", "control"])
def test_x4_faults(fault):
    boot = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n"
            "import torch\nimport heat_tpu_torch\n" + (X4_FAULTS.get(fault) or "") +
            "\nfrom perfbench import run\nsys.exit(run.main(sys.argv[1:]))\n")
    argv = [sys.executable, "-c", boot, "--workload", "cdist.susy-160k.x4", "--seed",
            str(SEED), "--seconds", "0.3", "--trace", "0", "--world", "4", "--port",
            str(harness.free_port()), "--device", "cpu",
            "--sizes", json.dumps(TINY["cdist.susy-160k.x4"][0]),
            "--control", "1" if fault == "control" else "0"]
    lines = harness.launch(argv, 4, 240)
    assert lines, "a rank failed"
    out = json.loads(lines[-1])
    assert out["correct"] is (fault is None), out["checks"]
