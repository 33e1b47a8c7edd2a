"""The benchmark's files: BENCHMARK.json against the contract's shape, and
every configuration, traffic, limit and metric file found by its name."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "perfbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "projection", "head", "expansion",
               "experts_per_token", "features")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def _entries():
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[kind]:
            yield kind, e


@pytest.mark.parametrize("kind,entry", list(_entries()), ids=lambda v: v if isinstance(v, str)
                         else v.get("name"))
def test_names_and_units(kind, entry):
    assert NAME.match(entry["name"])
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"}}
    assert set(entry) <= allowed[kind]
    assert set(entry) >= allowed[kind] - {"workloads"}
    texts = [entry[k] for k in ("why", "layer") if k in entry]
    if kind == "configs":
        texts.append(entry["source"])
    for text in texts:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    if kind in ("end_to_end", "per_layer"):
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
        assert entry["source"] in (("host_clock", "device_trace") if kind == "end_to_end" else
                                   ("device_trace", "program_span", "program_counter",
                                    "host_clock"))
    if kind == "end_to_end":
        assert 0.01 <= entry["bound"] <= 0.25
    if kind == "workloads":
        assert entry["chips"] in (1, 4)
        assert NAME.match(entry["config"]) and NAME.match(entry["traffic"])


def test_names_unique_and_four_card_share():
    for kind in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(pairs) // 4)


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_file(config):
    path = ROOT / config["file"]
    assert path.parent.parent == PKG and path.exists()
    cfg = json.loads(path.read_text())
    assert cfg["name"] == config["name"]
    assert cfg["reduced"] == config["reduced"] and len(config["reduced"]) <= 16
    for key in config["reduced"]:
        assert NAME.match(key) and key in cfg
        assert not key.endswith(("_dim", "_rank")) and not any(w in key for w in WIDTH_WORDS)
    assert any(c["config"] == config["name"] for c in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_load_by_name(cell):
    from perfbench import generator, harness

    loaded = harness.load_cell(cell["name"])
    assert issubclass(generator.op_class(loaded["traffic"]["op"]), generator.Op)
    assert isinstance(loaded["traffic"].get("options", {}), dict)
    e2e = [m["name"] for m in loaded["end_to_end"]]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert loaded["per_layer"]
    for m in loaded["end_to_end"] + loaded["per_layer"]:
        assert callable(harness.reader(m["name"]))
    for m in loaded["per_layer"]:
        # the end-to-end metric it moves is reported in every cell it lists
        assert m["moves"] in e2e
    assert all(v >= 0 for v in loaded["limits"].values())


def test_every_metric_has_a_reader_and_the_moves_are_end_to_end():
    from perfbench import harness

    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert harness.reader_path(m["name"]).parent == PKG / "metrics"
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"]:  # a kernel's share of its roofline
            assert m["name"].split(".")[0].endswith("_roofline") and m["unit"] == "%"
    assert {m["name"] for m in BENCH["end_to_end"]} == {
        "op_ms", "op_p95_ms", "op_ms.block", "op_p95_ms.block", "op_ms.x4", "peak_mem_gib",
        "setup_s"}
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers <= {"entry points", "op dispatch", "program registry", "communication",
                      "kernels", "device"}


def test_unknown_cell_is_refused():
    from perfbench import harness

    with pytest.raises(harness.CellError):
        harness.load_cell("no-such-cell")
