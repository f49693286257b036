"""Fixtures of the benchmark's own tests (CPU; what needs a card skips)."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
ROOT = BENCH.parent
DATA = HERE / "data"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# test-only cells at logN 9, with their configurations and traffic
TINY = {"tiny-head-pass": ("tiny-head", "tiny-head-b32"),
        "tiny-boot-b2": ("tiny-boot", "tiny-boot-b2")}


def make_root(tmp: Path) -> Path:
    """A copy of the benchmark's folder and BENCHMARK.json under ``tmp``,
    with the tiny cells added as a later change would add cells: files and
    entries, no code."""
    shutil.copytree(BENCH, tmp / "fhe_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cell, (config, traffic) in TINY.items():
        shutil.copy(DATA / f"{config}.json",
                    tmp / "fhe_bench" / "configs" / f"{config}.json")
        shutil.copy(DATA / f"{traffic}.json",
                    tmp / "fhe_bench" / "traffic" / f"{traffic}.json")
        spec["configs"].append({
            "name": config, "source": "https://eprint.iacr.org/2025/991",
            "file": f"fhe_bench/configs/{config}.json", "reduced": [],
            "why": "test only"})
        spec["workloads"].append({"name": cell, "config": config,
                                  "traffic": traffic, "chips": 1,
                                  "why": "test only"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            kind = config.split("-")[1]
            if "workloads" in m and any(
                    w.startswith(kind) for w in m["workloads"]):
                m["workloads"].append(cell)
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return tmp


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)


@pytest.fixture
def cuda_card():
    """The card, or a skip: the decision is made here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
