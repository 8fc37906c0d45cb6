"""Each cell run end to end on the CPU at a tiny size (``--device cpu
--tiny``), in a process of its own: a last line of the contract's shape,
correct, and no JAX or JAX package loaded (the run refuses to print one
otherwise).  Without a card, and in a directory with only the
benchmark's files, a run fails and prints no result."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
RUN = [sys.executable, "portbench/run.py"]


def _run(args, cwd=ROOT):
    return subprocess.run(RUN + args, cwd=cwd, capture_output=True,
                          text=True, timeout=600)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_prints_a_contract_line(cell, trace):
    p = _run(["--workload", cell, "--seed", str(2 ** 31 + 12345),
              "--seconds", "1", "--trace", str(trace), "--device", "cpu",
              "--tiny"])
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["attempted"] >= 1
    entry = {m["name"]: m for m in SPEC["end_to_end"] + SPEC["per_layer"]}
    for name, m in line["metrics"].items():
        assert m["unit"] == entry[name]["unit"]
    if trace == 0:
        want = {m["name"] for m in SPEC["end_to_end"]
                if cell in m.get("workloads", CELLS)}
        assert set(line["metrics"]) == want
    else:
        assert set(line["device"]) >= {"busy_s", "window_s"}
    tail = p.stderr.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") for t in tail)


def test_without_a_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _run(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_benchmark_files_alone_do_not_run(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
              "--device", "cpu", "--tiny"], cwd=tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
