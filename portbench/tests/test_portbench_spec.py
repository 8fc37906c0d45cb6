"""The benchmark's files: BENCHMARK.json against its contract's shape,
every file it names present, every workload and reader loadable, and
the reference free of JAX, the JAX package and the port."""
import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_paths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entry_keys():
    names = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        for key in ("name", "config", "traffic"):
            assert NAME.match(w[key])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for cell in m["workloads"]:
            moved = [e for e in SPEC["end_to_end"] if e["name"] == m["moves"]]
            assert cell in moved[0].get("workloads", CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load(cell):
    c = harness.Cell(cell)
    assert (BENCH / "drivers" / f"{c.workload['driver']}.py").is_file()
    assert "setup_s" in {m["name"] for m in c.end_to_end}
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m in c.end_to_end:
        assert callable(harness.load_module(
            BENCH / "end_to_end" / f"{m['name']}.py").read)
    for m in c.per_layer:
        assert callable(harness.load_module(
            BENCH / "layer_metrics" / f"{m['name']}.py").read)
    assert set(c.workload["limits"]) and all(
        v >= 0 for v in c.workload["limits"].values())


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_reference_imports_no_port_and_no_jax():
    for path in (BENCH / "reference").glob("*.py"):
        assert not set(_imports(path)) & {"jax", "jaxlib", "flax", "repro",
                                          "repro_torch"}, path
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.reference.fedcgd, portbench.reference.rwkv6, "
            "portbench.reference.compare, portbench.reference.resnet18gn; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'repro', 'repro_torch'}))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_forbidden_modules_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", object())
    assert harness.forbidden_modules() == [] or \
        set(harness.forbidden_modules()) <= set(harness.FORBIDDEN)
    before = set(harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert set(harness.forbidden_modules()) == before | {"jax"}
