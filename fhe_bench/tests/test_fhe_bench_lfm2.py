"""The kind ``lfm2_conv`` on the CPU, through the pass and judge code the
timed path uses, at logN 9 (``data/tiny-lfm2.json``: hidden size 16, the
channels [4, 8) held, 32 sequences of 8 tokens): it agrees with its
reference, its spans and counters reach their metrics, its float16 control
and a broken pass come out not correct, and it fails at once on a program
without ``entry.build_lfm2_conv``.  The cell's configuration holds the
port's chain and the catalog's numbers."""

from __future__ import annotations

import json
import math
import shutil

import pytest
import torch

from conftest import BENCH, DATA, make_root
from fhe_bench import core
from fhe_bench.kinds.head import check_chain
from fhe_bench.work import cost
from test_fhe_bench_control import (_altered, _fails_on_precision_alone,
                                    _half, _unchanged)

CELL, CONFIG, TRAFFIC = "tiny-lfm2-pass", "tiny-lfm2", "tiny-lfm2-b32"
FULL = "lfm2-8b-a1b-conv-n16"
SPANS = ("lfm2_inproj_s", "lfm2_gate_s", "lfm2_shift_s", "lfm2_outproj_s")


@pytest.fixture
def lfm2_root(tmp_path):
    """The tiny roots of ``conftest.make_root`` with the tiny LFM2 cell
    added as files and entries, on every metric the real cell reports."""
    root = make_root(tmp_path)
    shutil.copy(DATA / f"{CONFIG}.json",
                root / "fhe_bench" / "configs" / f"{CONFIG}.json")
    shutil.copy(DATA / f"{TRAFFIC}.json",
                root / "fhe_bench" / "traffic" / f"{TRAFFIC}.json")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({
        "name": CONFIG, "source": "https://huggingface.co/LiquidAI",
        "file": f"fhe_bench/configs/{CONFIG}.json", "reduced": [],
        "why": "test only"})
    spec["workloads"].append({"name": CELL, "config": CONFIG,
                              "traffic": TRAFFIC, "chips": 1,
                              "why": "test only"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "lfm2-conv-n16-pass" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


def test_kind_agrees_with_its_reference_at_logN_9(lfm2_root):
    r = core.run(CELL, 2147483659, 0.2, False, device="cpu", root=lfm2_root)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    c = r["checks"]
    assert c["limb_mismatch"]["value"] == 0 and c["limbs_off"]["value"] == 0
    assert 0 < c["max_abs_err"]["value"] < c["max_abs_err"]["limit"]
    assert 0 < c["rms_err"]["value"] < c["rms_err"]["limit"]
    assert set(r["metrics"]) == {"head_inputs_per_s", "setup_s"}


def test_the_traced_run_reads_the_spans_and_the_key_switches(lfm2_root):
    r = core.run(CELL, 5, 0.2, True, device="cpu", root=lfm2_root)
    assert r["correct"], r["checks"]
    got = {k: v["value"] for k, v in r["metrics"].items()}
    assert all(got[k] > 0 for k in SPANS)
    # u = B*x and C*v relinearize once each; the shifts 1 and 2 switch
    # a key each through one hoisted call
    assert got["keyswitches.lfm2"] == 4
    # no profile on the CPU, and no frozen work at the tiny configuration
    assert not set(got) & {"mfu.lfm2", "idle_share.lfm2",
                           "ntt_roofline.lfm2"}


def test_the_control_is_not_correct_at_logN_9(lfm2_root):
    bench = core.Bench(lfm2_root)
    cfg = bench.config(CONFIG)
    for seed in (11, 2147483659):
        checks = core.control(bench.kind("lfm2_conv"), cfg,
                              bench.traffic(TRAFFIC), seed,
                              torch.device("cpu"))
        _fails_on_precision_alone(checks)


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
def test_a_broken_pass_is_not_correct(lfm2_root, monkeypatch, fault):
    real_kind = core.Bench.kind

    def broken_kind(self, name):
        kind = real_kind(self, name)
        setup = kind.setup

        class Broken:
            RATE, reference, judge = kind.RATE, kind.reference, kind.judge
            judge_spec, pack = kind.judge_spec, kind.pack

            @staticmethod
            def setup(*a, **k):
                prog = setup(*a, **k)
                prog._good = prog.run
                prog.run = fault(prog)
                return prog
        return Broken

    monkeypatch.setattr(core.Bench, "kind", broken_kind)
    r = core.run(CELL, 7, 0.2, False, device="cpu", root=lfm2_root)
    assert not r["correct"], (fault.__name__, r["checks"])


def test_fails_at_once_without_the_programs_builder(lfm2_root, monkeypatch):
    """A program that lacks ``build_lfm2_conv`` (the parent of the change
    that adds it) fails at set-up, before any key is made."""
    import moai_tpu_torch.entry as entry
    monkeypatch.delattr(entry, "build_lfm2_conv")
    with pytest.raises(ImportError, match="build_lfm2_conv"):
        core.run(CELL, 3, 0.2, False, device="cpu", root=lfm2_root)


def test_the_configuration_is_the_catalogs_and_the_ports_chain():
    from moai_tpu_torch.params import Context, head_config
    cfg = json.loads((BENCH / "configs" / f"{FULL}.json").read_text())
    assert (cfg["hidden_size"], cfg["conv_L_cache"], cfg["conv_bias"]) == \
        (2048, 3, False)
    assert cfg["reduced"] == ["num_hidden_layers", "layer_types",
                              "held_channels"]
    assert cfg["published"]["num_hidden_layers"] == 24
    assert cfg["published"]["layer_types"].count("conv") == 18
    assert cfg["held_channels"] == [0, 256] and \
        cfg["published"]["held_channels"] == [0, 2048]
    check_chain(Context(head_config(16, cfg["ckks"]["n_data_levels"]),
                        device="cpu"), cfg)
    w = json.loads((BENCH / "work" / f"{FULL}.json").read_text())
    least = cost.pass_least_s(w, w["batch"])
    assert w["config"] == FULL and w["ctx"]["L"] == len(cfg["q_primes"])
    assert 0 < least / w["batch"] < 0.1
    assert all(r["count"] > 0 and not math.isnan(cost.least_s(w["ctx"], r))
               for r in w["records"])
