"""heatlint for the port (``heat_tpu_torch.analysis``) on the CPU.

- Each of the six rules has positive and negative fixture sources, in the
  port's own form of its invariant.
- Suppressions (inline with a reason, a standalone comment governing the
  next code line, the wrong rule id, a deleted directive), the baseline
  (grandfather, new findings unmasked, a narrowed rewrite keeping what it
  did not scan, line drift) and the CLI (its JSON, ``--select``,
  ``--list-rules``, ``--knob-table``, its exit codes).
- HL005 and HL006 give the JAX package's findings on framework-neutral
  fixtures (``heat_tpu.analysis``'s rules of the same ids).
- The port's tree scans clean with no baseline, the counterpart of
  ``tests/test_no_stray_jit.py``: HL001 and HL002 hold outright (no
  suppression), every committed suppression carries a reason and is
  load-bearing, and every allowlist names a real file.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import textwrap

import pytest

from heat_tpu import analysis as jax_analysis

from heat_tpu_torch import _knobs
from heat_tpu_torch import analysis
from heat_tpu_torch.analysis import __main__ as cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def scan(src: str, rule_id: str, relpath: str = "heat_tpu_torch/fixture.py"):
    return analysis.scan_source(relpath, textwrap.dedent(src), [analysis.rule_by_id(rule_id)])


def fired(src: str, rule_id: str, relpath: str = "heat_tpu_torch/fixture.py"):
    return [f.line for f in scan(src, rule_id, relpath)[0]]


# -- HL001: graph capture and compilation only in the registry --------------------------------

_HL001_POSITIVE = {
    "cuda_graph": "import torch\ng = torch.cuda.CUDAGraph()\nwith torch.cuda.graph(g):\n    f()\n",
    "alias": "import torch.cuda as tc\ng = tc.CUDAGraph()\n",
    "from_import": "from torch.cuda import graph, make_graphed_callables\nf = make_graphed_callables(m, x)\n",
    "compile": "import torch\nfast = torch.compile(model)\n",
    "compile_decorator": "import torch\n@torch.compile\ndef f(x):\n    return x\n",
    "pool": "import torch\np = torch.cuda.graph_pool_handle()\n",
}


@pytest.mark.parametrize("name", sorted(_HL001_POSITIVE))
def test_hl001_positive(name):
    assert fired(_HL001_POSITIVE[name], "HL001")


@pytest.mark.parametrize("src", [
    "import torch\ns = torch.cuda.Stream()\ntorch.cuda.synchronize()\n",
    "import re\np = re.compile('x')\n",
    "from heat_tpu_torch.core import program_cache\n"
    "f = program_cache.cached_program('s', (), lambda: g)\n",
])
def test_hl001_negative(src):
    assert fired(src, "HL001") == []


def test_hl001_allows_the_registry_itself():
    src = _HL001_POSITIVE["cuda_graph"]
    assert fired(src, "HL001", "heat_tpu_torch/core/program_cache.py") == []


# -- HL002: collectives only in the communicator -----------------------------------------------

_HL002_POSITIVE = {
    "alias": "import torch.distributed as dist\ndist.all_gather(parts, buf)\n",
    "full_name": "import torch\ntorch.distributed.all_reduce(t)\n",
    "from_import": "from torch.distributed import all_to_all_single as a2a\na2a(o, i)\n",
    "from_torch": "from torch import distributed\ndistributed.broadcast(t, 0)\n",
    "reference": "import torch.distributed as dist\nop = dist.isend\n",
    "p2p": "import torch.distributed as dist\ndist.batch_isend_irecv([dist.P2POp(dist.isend, t, 1)])\n",
}


@pytest.mark.parametrize("name", sorted(_HL002_POSITIVE))
def test_hl002_positive(name):
    assert fired(_HL002_POSITIVE[name], "HL002")


@pytest.mark.parametrize("src", [
    "comm.allgather(t, 0, n)\ncomm.gather_stack(t, name='all_gather')\n",
    "import torch.distributed as dist\nr = dist.get_rank()\nok = dist.is_initialized()\n",
    "from heat_tpu_torch.core import communication\nx = communication.get_comm().sum(t)\n",
])
def test_hl002_negative(src):
    assert fired(src, "HL002") == []


def test_hl002_allows_the_communicator():
    assert fired(_HL002_POSITIVE["alias"], "HL002", "heat_tpu_torch/core/communication.py") == []


# -- HL003: the exact sites stay exact ---------------------------------------------------------

_STATS = "heat_tpu_torch/core/statistics.py"


@pytest.mark.parametrize("src", [
    "def mean(x):\n    return x.comm.allreduce(s, precision=wire)\n",
    "def var(x):\n    return x.comm.allgather(s, 0, n, precision='bf16')\n",
    "def chunk_moments(x):\n    def inner():\n        return comm.sum(t, precision=p)\n    return inner()\n",
    "from . import collective_prec\ndef _column_moments(x):\n"
    "    w = collective_prec.resolve(None)\n",
    "from . import collective_prec\ndef std(x):\n    return collective_prec.psum(t, comm, 'int8')\n",
])
def test_hl003_positive(src):
    assert fired(src, "HL003", _STATS)


@pytest.mark.parametrize("src,relpath", [
    ("def mean(x):\n    return x.comm.allreduce(s, precision='off')\n", _STATS),
    ("def var(x):\n    return x.comm.allreduce(s, precision=None)\n", _STATS),
    ("def mean(x):\n    return x.comm.allreduce(s)\n", _STATS),
    # a lossy surface by design: the gradient mean of the training steps
    ("def _mean_over(comm, g, wire):\n    return comm.allreduce(g, precision=wire)\n",
     "heat_tpu_torch/nn/data_parallel.py"),
    # outside the exact functions of an exact module
    ("def percentile(x):\n    return x.comm.allgather(s, 0, n, precision=p)\n", _STATS),
])
def test_hl003_negative(src, relpath):
    assert fired(src, "HL003", relpath) == []


def test_hl003_covers_the_gathers_of_numpy_and_resplit():
    src = "class DNDarray:\n    def _global(self):\n        return c.allgather(t, 0, n, precision=w)\n"
    assert fired(src, "HL003", "heat_tpu_torch/core/dndarray.py")


# -- HL004: host syncs inside registry programs ------------------------------------------------

_HL004_POSITIVE = {
    "item": "def body(x):\n    return x.sum().item()\n"
            "f = program_cache.cached_program('s', (), lambda: body, inline=True)\n",
    "float_arg": "def body(x, rs):\n    return x if float(rs) > 0 else -x\n"
                 "f = program_cache.cached_program('s', (), lambda: body)\n",
    "lambda": "f = program_cache.cached_program('s', (), lambda: (lambda x: x.cpu()))\n",
    "synchronize": "import torch\ndef body(x):\n    torch.cuda.synchronize()\n    return x\n"
                   "f = program_cache.cached_program('s', (), lambda: body)\n",
    "method": "class A:\n    def _run(self, x):\n        return x.tolist()\n"
              "    def go(self, x):\n"
              "        return program_cache.cached_program('s', (), lambda: A._run)(self, x)\n",
    "builder_inner": "def _build(n):\n    def run(x):\n        return x.numpy()\n    return run\n"
                     "f = program_cache.cached_program('s', (), lambda: _build(3))\n",
    "partial": "import functools\ndef body(x, n):\n    return x.item()\n"
               "f = program_cache.cached_program('s', (), lambda: functools.partial(body, n=2))\n",
}


@pytest.mark.parametrize("name", sorted(_HL004_POSITIVE))
def test_hl004_positive(name):
    assert fired(_HL004_POSITIVE[name], "HL004")


@pytest.mark.parametrize("src", [
    # host reads outside the program
    "def body(x):\n    return x.sum()\n"
    "f = program_cache.cached_program('s', (), lambda: body)\nv = f(t).item()\n",
    # float() of a python value that is not an argument
    "def body(x):\n    return x * float(3)\n"
    "f = program_cache.cached_program('s', (), lambda: body)\n",
    # a module-level numpy read is not in the program
    "import numpy as np\nK = np.zeros(3).tolist()\ndef body(x):\n    return x + 1\n"
    "f = program_cache.cached_program('s', (), lambda: body)\n",
    # a builder's own statements run once, at the build
    "def _build(n):\n    k = int(n)\n    def run(x):\n        return x * k\n    return run\n"
    "f = program_cache.cached_program('s', (), lambda: _build(3))\n",
])
def test_hl004_negative(src):
    assert fired(src, "HL004") == []


# -- HL005 and HL006: the same findings as the JAX package's rules -----------------------------

_NEUTRAL = {
    "environ_get": "import os\nv = os.environ.get('HEAT_TPU_FUSION')\n",
    "getenv": "import os\nv = os.getenv('HEAT_TPU_RELAYOUT_PLAN', 'auto')\n",
    "subscript": "import os\nv = os.environ['HEAT_TPU_TELEMETRY']\n",
    "unregistered": "from x import knobs\nv = knobs.get('HEAT_TPU_NOT_A_KNOB_AT_ALL')\n",
    "registered": "from x import knobs\nv = knobs.get('HEAT_TPU_FUSION')\n",
    "write": "import os\nos.environ['HEAT_TPU_FUSION'] = '0'\n",
    "other_var": "import os\nv = os.environ.get('HOME')\n",
    "literal_closed": "def f(x):\n    scale = 2.0\n"
                      "    return program_cache.cached_program('s', (), lambda: (lambda v: v * scale))\n",
    "literal_named": "def f(x):\n    k = 3\n    def body(v):\n        return v + k\n"
                     "    return program_cache.cached_program('s', (), lambda: body)\n",
    "literal_arg": "def f(x):\n    k = 3\n    def body(v, k):\n        return v + k\n"
                   "    return program_cache.cached_program('s', (), lambda: body)(x, k)\n",
    "rebound": "def f(x):\n    k = 3\n    def body(v):\n        k = 4\n        return v + k\n"
               "    return program_cache.cached_program('s', (), lambda: body)\n",
    "module_const": "K = 3\ndef f(x):\n    K = 3\n"
                    "    return program_cache.cached_program('s', (), lambda: (lambda v: v + K))\n",
    "negative_literal": "def f(x):\n    lo = -1.5\n"
                        "    return program_cache.cached_program('s', (), lambda: (lambda v: v - lo))\n",
}


@pytest.mark.parametrize("rule_id", ["HL005", "HL006"])
@pytest.mark.parametrize("name", sorted(_NEUTRAL))
def test_neutral_fixture_findings_equal_the_jax_packages(rule_id, name):
    src = _NEUTRAL[name]
    mine = [(f.line, f.col) for f in analysis.scan_source(
        "fixture.py", src, [analysis.rule_by_id(rule_id)])[0]]
    theirs = [(f.line, f.col) for f in jax_analysis.scan_source(
        "fixture.py", src, [jax_analysis.rule_by_id(rule_id)])[0]]
    assert mine == theirs


@pytest.mark.parametrize("name,rule_id,want", [
    ("environ_get", "HL005", 1), ("subscript", "HL005", 1), ("unregistered", "HL005", 1),
    ("registered", "HL005", 0), ("write", "HL005", 0), ("literal_closed", "HL006", 1),
    ("literal_named", "HL006", 1), ("literal_arg", "HL006", 0), ("rebound", "HL006", 0),
])
def test_neutral_fixture_counts(name, rule_id, want):
    assert len(fired(_NEUTRAL[name], rule_id)) == want


def test_hl005_allows_the_registry_module():
    src = "import os\nv = os.environ.get('HEAT_TPU_FUSION')\n"
    assert fired(src, "HL005", "heat_tpu_torch/_knobs.py") == []


# -- suppressions ---------------------------------------------------------------------------------

_SUPPRESSED = "import torch.distributed as dist\ndist.all_gather(p, b)  # heatlint: disable=HL002 -- fixture reason\n"


def test_inline_suppression_with_reason():
    findings, suppressed = scan(_SUPPRESSED, "HL002")
    assert findings == [] and len(suppressed) == 1
    assert suppressed[0][0].rule == "HL002" and suppressed[0][1] == "fixture reason"


@pytest.mark.parametrize("gap", ["# the reason wraps\n# onto a second line\n", "\n"])
def test_standalone_comment_covers_next_code_line(gap):
    src = ("import torch.distributed as dist\n# heatlint: disable=HL002 -- fixture reason\n"
           + gap + "dist.all_gather(p, b)\n")
    findings, suppressed = scan(src, "HL002")
    assert findings == [] and len(suppressed) == 1


def test_wrong_rule_id_does_not_suppress():
    src = _SUPPRESSED.replace("HL002", "HL001")
    findings, suppressed = scan(src, "HL002")
    assert len(findings) == 1 and suppressed == []


def test_deleting_the_directive_resurfaces_the_finding():
    findings, suppressed = scan(_SUPPRESSED.split("  #")[0] + "\n", "HL002")
    assert len(findings) == 1 and suppressed == []


# -- the baseline ------------------------------------------------------------------------------------


def _legacy_tree(tmp_path):
    (tmp_path / "legacy.py").write_text("import torch.distributed as dist\ndist.barrier()\n")
    return tmp_path


def test_grandfather_then_clean(tmp_path):
    root = _legacy_tree(tmp_path)
    report = analysis.analyze(["legacy.py"], str(root))
    assert len(report.findings) == 1
    analysis.write_baseline(report, str(root / "bl.json"))
    again = analysis.apply_baseline(analysis.analyze(["legacy.py"], str(root)),
                                    analysis.load_baseline(str(root / "bl.json")))
    assert again.findings == [] and len(again.baselined) == 1


def test_new_finding_not_masked_by_baseline(tmp_path):
    root = _legacy_tree(tmp_path)
    analysis.write_baseline(analysis.analyze(["legacy.py"], str(root)), str(root / "bl.json"))
    (root / "legacy.py").write_text(
        "import torch.distributed as dist\ndist.barrier()\ndist.all_reduce(t)\n")
    report = analysis.apply_baseline(analysis.analyze(["legacy.py"], str(root)),
                                     analysis.load_baseline(str(root / "bl.json")))
    assert [f.code for f in report.findings] == ["dist.all_reduce(t)"]


def test_line_drift_does_not_resurrect(tmp_path):
    root = _legacy_tree(tmp_path)
    analysis.write_baseline(analysis.analyze(["legacy.py"], str(root)), str(root / "bl.json"))
    (root / "legacy.py").write_text("import torch.distributed as dist\n\n\n# moved\ndist.barrier()\n")
    report = analysis.apply_baseline(analysis.analyze(["legacy.py"], str(root)),
                                     analysis.load_baseline(str(root / "bl.json")))
    assert report.findings == [] and len(report.baselined) == 1


def test_subset_rewrite_preserves_out_of_scope_entries(tmp_path, capsys):
    root = _legacy_tree(tmp_path)
    (root / "other.py").write_text("import torch\ng = torch.cuda.CUDAGraph()\n")
    bl = str(root / "bl.json")
    assert cli.main(["legacy.py", "other.py", "--root", str(root), "--baseline", bl,
                     "--write-baseline"]) == 0
    assert cli.main(["legacy.py", "--root", str(root), "--baseline", bl, "--select", "HL002",
                     "--write-baseline"]) == 0
    capsys.readouterr()
    rules = sorted(e["rule"] for e in analysis.load_baseline_entries(bl))
    assert rules == ["HL001", "HL002"]


# -- the CLI -----------------------------------------------------------------------------------------


def test_cli_json_on_a_new_finding(tmp_path, capsys):
    root = _legacy_tree(tmp_path)
    rc = cli.main(["legacy.py", "--root", str(root), "--format", "json"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 1 and out["new"] == 1 and out["per_rule"] == {"HL002": 1}
    assert out["findings"][0]["path"] == "legacy.py" and out["findings"][0]["line"] == 2


def test_cli_select_and_list_rules(tmp_path, capsys):
    root = _legacy_tree(tmp_path)
    assert cli.main(["legacy.py", "--root", str(root), "--select", "HL001"]) == 0
    assert cli.main(["--list-rules"]) == 0
    listed = re.findall(r"^(HL\d{3})", capsys.readouterr().out, re.M)
    assert listed == ["HL001", "HL002", "HL003", "HL004", "HL005", "HL006"]
    assert cli.main(["legacy.py", "--root", str(root), "--select", "HL999"]) == 2


def test_cli_knob_table(capsys):
    assert cli.main(["--knob-table"]) == 0
    assert capsys.readouterr().out == _knobs.markdown_table()


def test_cli_module_exits_zero_on_the_port_tree():
    r = subprocess.run([sys.executable, "-m", "heat_tpu_torch.analysis", "--format", "json"],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    out = json.loads(r.stdout)
    assert out["new"] == 0 and out["baselined"] == [] and out["files"] > 100


# -- the port's tree scans clean -------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_report():
    return analysis.run(root=REPO)


def test_the_port_tree_scans_clean(port_report):
    assert port_report.files_scanned > 100
    assert port_report.findings == [], "\n".join(f.render() for f in port_report.findings)
    assert not os.path.exists(os.path.join(REPO, analysis.BASELINE_NAME))


@pytest.mark.parametrize("rule_id", ["HL001", "HL002"])
def test_graphs_and_collectives_hold_outright(port_report, rule_id):
    assert [f.render() for f, _ in port_report.suppressed if f.rule == rule_id] == []


def test_every_suppression_has_a_reason_and_is_load_bearing(port_report):
    assert port_report.suppressed
    for path in sorted({f.path for f, _ in port_report.suppressed}):
        src = open(os.path.join(REPO, path)).read()
        kept = [(f, r) for f, r in port_report.suppressed if f.path == path]
        assert all(r for _, r in kept), path
        stripped = re.sub(r"#\s*heatlint:\s*disable[^\n]*", "# (directive removed)", src)
        findings, _ = analysis.scan_source(path, stripped, analysis.RULES)
        assert len(findings) == len(kept), path


@pytest.mark.parametrize("rule_id", ["HL001", "HL002", "HL003", "HL004", "HL005", "HL006"])
def test_allowlists_and_exact_sites_name_real_files(rule_id):
    rule = analysis.rule_by_id(rule_id)
    for rel in rule.allowed:
        assert os.path.exists(os.path.join(REPO, rel)), rel
    if rule_id == "HL003":
        from heat_tpu_torch.analysis.rules import EXACT_SITES

        for rel, names in EXACT_SITES.items():
            src = open(os.path.join(REPO, rel)).read()
            for name in names:
                assert re.search(rf"def {name}\(", src), (rel, name)


def test_the_public_names_are_the_jax_packages():
    assert set(jax_analysis.__all__) <= set(analysis.__all__)
    assert [r.id for r in analysis.RULES] == [r.id for r in jax_analysis.RULES]
