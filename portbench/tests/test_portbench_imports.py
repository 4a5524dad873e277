"""What the benchmark runs loads neither JAX nor the JAX package (top-level
module names compared whole: ``vpp_tpu_torch`` passes), and the plain
reference imports nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
# every cell with a traffic file: the manifest's, and those kept for a
# later benchmark
CELLS = sorted(p.stem for p in
               (ROOT / "portbench" / "traffic").glob("*.json"))

PROBE = """
import sys, json
sys.path.insert(0, {root!r})
from portbench import harness
from portbench.tests import tiny
res, _ = tiny.run({cell!r}, trace={trace})
for m in harness.manifest()["per_layer"]:
    harness.load_module(harness.reader_path(m["name"]), "probe_" + m["name"])
print(json.dumps({{"banned": harness.banned_modules(),
                   "port": "vpp_tpu_torch" in sys.modules,
                   "correct": res["correct"]}}))
"""


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_a_run_loads_no_jax(cell, trace):
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=str(ROOT), cell=cell,
                                            trace=trace)],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["banned"] == [] and got["port"]


def test_banned_names_are_compared_whole(monkeypatch):
    from portbench import harness
    monkeypatch.setitem(sys.modules, "vpp_tpu_torch_probe", sys)
    monkeypatch.setitem(sys.modules, "jaxline_probe", sys)
    assert harness.banned_modules() == [] or all(
        m.split(".")[0] in harness.BANNED for m in harness.banned_modules())
    monkeypatch.setitem(sys.modules, "vpp_tpu.probe", sys)
    assert "vpp_tpu.probe" in harness.banned_modules()


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    (ROOT / "portbench" / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"vpp_tpu_torch", "vpp_tpu", "jax", "jaxlib", "flax"}


def test_harness_files_import_no_jax():
    for path in (ROOT / "portbench").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"vpp_tpu", "jax", "jaxlib", "flax"}, path
