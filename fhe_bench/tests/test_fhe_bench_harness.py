"""The harness on the CPU: its files load and keep to the contract's
characters, a cell and a metric added as files run with no code edited,
each kind agrees with its reference at logN 9 through the pass and judge
code the timed path uses, and the measuring command refuses to run
without a card."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from conftest import BENCH, ROOT, make_root
from fhe_bench import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
METRIC_KEYS = {"name", "unit", "better", "source", "bound", "layer",
               "moves", "workloads"}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_json_keeps_to_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["fhe_bench"]
    assert SPEC["command"][1] == "fhe_bench/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51
    configs = {c["name"]: c for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["why"]) and _line(c["source"])
        assert c["file"].startswith("fhe_bench/configs/")
        assert all(NAME.match(k) for k in c["reduced"])
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == \
            c["reduced"]
    cells = {}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] == 1 and _line(w["why"])
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
        cells[w["name"]] = w
    assert {w["config"] for w in cells.values()} == set(configs)
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    for m in SPEC["end_to_end"]:
        assert set(m) <= METRIC_KEYS - {"layer", "moves"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= set(cells)
    for m in SPEC["per_layer"]:
        assert set(m) <= METRIC_KEYS - {"bound"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        moved = e2e[m["moves"]].get("workloads", list(cells))
        assert set(m["workloads"]) <= set(moved)
    for cell in cells:
        reported = [n for n in e2e if cell in e2e[n].get("workloads",
                                                         [cell])]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(cell in m["workloads"] for m in SPEC["per_layer"])
    assert len(json.dumps(SPEC)) <= 64 * 1024


@pytest.mark.parametrize("folder", ["configs", "traffic", "metrics"])
def test_every_file_loads_and_is_named_within_the_contract(folder):
    files = sorted((BENCH / folder).iterdir())
    assert files
    for f in files:
        if f.name == "__pycache__":
            continue
        assert NAME.match(f.stem), f
        if f.suffix == ".json":
            data = json.loads(f.read_text())
            if folder == "configs":
                assert data["name"] == f.stem
                assert all(NAME.match(k) for k in data["reduced"])
                assert set(data["limits"]) >= {"max_abs_err", "limbs_off",
                                               "limb_mismatch",
                                               "pass_mismatch"}
                assert set(data["limits"]) <= {"max_abs_err", "rms_err",
                                               "limbs_off", "limb_mismatch",
                                               "pass_mismatch"}
                assert data["control_dtype"] in ("bfloat16", "float16")
                assert data["security_bits"] > 0
        else:
            assert f.suffix == ".py"
            assert callable(core.Bench().reader(f.stem))
            assert f.read_text().startswith('"""' + f.stem.split(".")[0])


def test_every_metric_of_the_benchmark_has_a_reader():
    bench = core.Bench()
    for m in SPEC["per_layer"]:
        assert callable(bench.reader(m["name"]))


def test_an_added_cell_and_metric_run_with_no_code_edited(tmp_path):
    root = make_root(tmp_path)
    (root / "fhe_bench" / "metrics" / "passes_timed.py").write_text(
        '"""passes_timed: the mean pass time of the traced window."""\n\n\n'
        "def read(rec):\n    return rec['pass_s']\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({
        "name": "passes_timed", "unit": "s", "better": "lower",
        "source": "host_clock", "layer": "pass", "moves":
        "head_inputs_per_s", "workloads": ["tiny-head-pass"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = core.Bench(root)
    assert "tiny-head-pass" in [w["name"] for w in bench.spec["workloads"]]
    traced = core.run("tiny-head-pass", 5, 0.2, True, device="cpu",
                      root=root)
    assert traced["correct"] and traced["metrics"]["passes_timed"]["value"] > 0
    assert set(traced["metrics"]) >= {"passes_timed", "keyswitches.head",
                                      "head_cpmm_s"}
    plain = core.run("tiny-head-pass", 5, 0.2, False, device="cpu",
                     root=root)
    assert set(plain["metrics"]) == {"head_inputs_per_s", "setup_s"}
    assert list(plain)[-1] == "checks"


@pytest.mark.parametrize("cell", ["tiny-head-pass", "tiny-boot-b2"])
def test_kind_agrees_with_its_reference_at_logN_9(tiny_root, cell):
    r = core.run(cell, 2147483659, 0.2, False, device="cpu", root=tiny_root)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    c = r["checks"]
    assert c["limb_mismatch"]["value"] == 0 and c["limbs_off"]["value"] == 0
    assert 0 < c["max_abs_err"]["value"] < c["max_abs_err"]["limit"]


def test_the_measuring_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    r = subprocess.run([sys.executable, "fhe_bench/run.py", "--workload",
                        "head-n16-pass", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
    with pytest.raises(RuntimeError, match="CUDA"):
        core.run("head-n16-pass", 1, 1.0, False, device="cuda")


def test_the_command_fails_with_only_the_benchmark_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "fhe_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "fhe_bench/run.py", "--workload",
                        "head-n16-pass", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "moai_tpu_torch" in r.stderr


def test_tiny_cell_on_the_card(cuda_card, tiny_root):
    r = core.run("tiny-head-pass", 3, 0.5, True, device=cuda_card,
                 root=tiny_root)
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert r["device"]["busy_s"] > 0
