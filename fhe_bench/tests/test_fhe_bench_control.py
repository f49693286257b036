"""``correct`` has to be able to come out false.

The control (the plain reference computed in the configuration's
``control_dtype``, the precision below the one it states, put in the
program's place as a ciphertext) is judged as a run judges the program's
output and comes out not correct, at each configuration's own size.  And
a run whose timed path is broken underneath comes out not correct, once
for each fault the cells can have: a pass that returns its state
unchanged, half of the batch left out, and an answer altered where it is
produced (no cell has an exchange between chips to leave out)."""

from __future__ import annotations

import pytest
import torch

from fhe_bench import core

CELLS = ["head-n16-pass", "boot-n16-b12", "boot-n16-b2", "boot-n16p-b12"]
EXACT = ("limbs_off", "limb_mismatch", "pass_mismatch")


def _control(root, cell, seed):
    bench = core.Bench(root)
    cfg = bench.config(bench.cell(cell)["config"])
    return core.control(bench.kind(cfg["kind"]), cfg,
                        bench.traffic(bench.cell(cell)["traffic"]), seed,
                        torch.device("cpu"))


def _fails_on_precision_alone(checks):
    assert all(checks[k][0] == 0 for k in EXACT), checks
    failed = [k for k, (v, lim) in checks.items() if v > lim]
    assert failed and set(failed).isdisjoint(EXACT), checks
    return failed


@pytest.mark.parametrize("cell", ["tiny-head-pass", "tiny-boot-b2"])
def test_the_control_is_not_correct_at_logN_9(tiny_root, cell):
    for seed in (11, 2147483659):
        _fails_on_precision_alone(_control(tiny_root, cell, seed))


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_at_the_cells_size(cell):
    failed = _fails_on_precision_alone(_control(core.ROOT, cell, 11))
    if cell.startswith("boot"):
        # the float16 rounding step at 0.8 is 2.7x the bootstrap's own
        # largest error: the root-mean-square error is what separates
        assert "rms_err" in failed


def _unchanged(prog):
    """The pass hands back its input."""
    def run():
        return prog._good().with_data(prog.x_data)
    return run


def _half(prog):
    """Half of the batch computed, the rest copied from it."""
    def run():
        out = prog._good()
        d = out.data.clone()
        h = d.shape[0] // 2
        d[h:2 * h] = d[:h]
        return out.with_data(d)
    return run


def _altered(prog):
    """One residue of the answer altered where it is produced."""
    def run():
        out = prog._good()
        d = out.data.clone()
        d[(0,) * (d.dim() - 2) + (d.shape[-2] - 1, 5)] += 1
        return out.with_data(d)
    return run


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
@pytest.mark.parametrize("cell", ["tiny-head-pass", "tiny-boot-b2"])
def test_a_broken_pass_is_not_correct(tiny_root, monkeypatch, cell, fault):
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
                prog._good, prog.run = prog.run, None
                prog.run = fault(prog)
                return prog
        return Broken

    monkeypatch.setattr(core.Bench, "kind", broken_kind)
    r = core.run(cell, 7, 0.2, False, device="cpu", root=tiny_root)
    assert not r["correct"], (fault.__name__, r["checks"])
    assert r["failed"] == r["attempted"]
