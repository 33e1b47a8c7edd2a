"""The benchmark on a card: one short run of each one-card cell through the
command line, correct and with every metric it should report, and one with
the control in the program's place, not correct. Skipped
without a card; on the chip: ``python -m pytest perfbench/tests -m cuda``."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("control", [0, 1])
@pytest.mark.parametrize("name,metrics", [
    ("kmeans.higgs", {"op_ms", "op_p95_ms", "peak_mem_gib", "setup_s"}),
    ("cdist_block.susy-160k", {"op_ms.block", "op_p95_ms.block", "peak_mem_gib", "setup_s"}),
])
def test_cell_on_the_card(card, name, metrics, control):
    # with --control 1 the reference in TF32 stands in for the program, at
    # the cell's own size: the comparison has to find it not correct
    done = subprocess.run([sys.executable, "perfbench/run.py", "--workload", name, "--seed",
                           "2147483999", "--seconds", "2", "--trace", "0", "--control",
                           str(control)], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    out = json.loads(done.stdout.strip().splitlines()[-1])
    assert out["correct"] is (control == 0) and set(out["metrics"]) == metrics
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
