"""moai_tpu_torch.utils.debug's span recorder on the CPU: off it records
nothing and hands out one shared null context; on, spans nest with their
parents and passes, close on an exception, and sit on the clock of
torch.profiler's events after ``Trace.epoch_ns``.  The program's spans:
the attention head of tests/test_torch_head.py and the smallest bootstrap
of tests/test_torch_boot.py give their span trees, with the same output
as untraced and ``on_stage`` called as before; set-up's spans; and the
launch shape limb_ew records."""

import time

import pytest
import torch

from moai_tpu_torch import limb_cuda
from moai_tpu_torch.entry import build_bootstrap, build_head
from moai_tpu_torch.params import CKKSConfig
from moai_tpu_torch.utils import debug

torch.set_num_threads(1)
HEAD = dict(logN=9, n_data_levels=12, num_x=32, num_row=8, d_model=8,
            head_dim=8, exp_r=2, inv_iters=2, input_count=3)
BOOT = CKKSConfig(logN=9, q0_bits=(30.0, 30.0), data_pair_bits=26.0,
                  n_data_levels=13, n_boot_levels=0, dnum=7,
                  special_bits=29.5, hamming_weight=64)


def _tree(trace: debug.Trace) -> list[tuple[int, str]]:
    """(depth, name) of each span in the order they opened."""
    return [(trace.path(i).count("/"), s.name)
            for i, s in enumerate(trace.spans)]


def test_off_records_nothing_and_shares_one_null_span():
    assert debug._trace is None
    a, b = debug.span("a"), debug.span("b")
    assert a is b is debug.NULL_SPAN
    with a as got:
        assert got is None
    with debug.tracing() as trace:
        with debug.span("on"):
            pass
    with debug.span("after"):
        pass
    assert debug._trace is None
    assert [s.name for s in trace.spans] == ["on"]


def test_nesting_parents_and_passes():
    with debug.tracing() as trace:
        with debug.span("pass") as root:
            with debug.span("a"):
                with debug.span("a.1"):
                    time.sleep(0.001)
            with debug.span("b"):
                pass
        with debug.span("second"):
            with debug.span("c"):
                pass
    names = [s.name for s in trace.spans]
    assert names == ["pass", "a", "a.1", "b", "second", "c"]
    assert [s.parent for s in trace.spans] == [-1, 0, 1, 0, -1, 4]
    assert [s.pass_id for s in trace.spans] == [0, 0, 0, 0, 4, 4]
    assert trace.path(2) == "pass/a/a.1" and trace.path(5) == "second/c"
    assert root is trace.spans[0]
    for s in trace.spans:
        assert 0 <= s.start_ns <= s.end_ns and s.launches == 0
    outer, inner = trace.spans[1], trace.spans[2]
    assert outer.start_ns <= inner.start_ns and inner.end_ns <= outer.end_ns
    assert inner.host_s >= 0.001


def test_an_exception_closes_its_spans():
    with debug.tracing() as trace:
        with pytest.raises(ValueError):
            with debug.span("outer"):
                with debug.span("inner"):
                    raise ValueError("raised inside two spans")
        with debug.span("next"):
            pass
    assert all(s.end_ns >= s.start_ns for s in trace.spans)
    assert [(s.name, s.parent, s.pass_id) for s in trace.spans] == [
        ("outer", -1, 0), ("inner", 0, 0), ("next", -1, 2)]


def test_spans_sit_on_the_profilers_clock():
    """A span and a record_function region around the same work start and
    end within 1 ms of each other once the span is put on the epoch
    clock (the first record_function call is made before, outside)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    x = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm"):
            x @ x
        with debug.tracing() as trace:
            with debug.span("work"):
                with record_function("work"):
                    for _ in range(20):
                        x = torch.tanh(x @ x)
                    time.sleep(0.02)
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "work" and e.device_type() == DeviceType.CPU]
    assert len(ev) == 1
    s = trace.spans[0]
    start, end = trace.epoch_ns(s.start_ns), trace.epoch_ns(s.end_ns)
    assert abs(ev[0].start_ns() - start) < 1_000_000
    assert abs(ev[0].start_ns() + ev[0].duration_ns() - end) < 1_000_000
    assert end - start >= 20_000_000


def test_head_span_tree_and_output():
    """The first pass encodes the softmax's two plaintexts under
    ``softmax.pts``; a later pass makes them from the head's kept
    coefficients, with no ``encode`` below it, and the same output as
    untraced."""
    with debug.tracing() as setup:
        h = build_head(**HEAD, device="cpu")
    roots = [s.name for s in setup.spans if s.parent < 0]
    assert {"context", "keygen.galois", "keygen.public",
            "keygen.relin"} <= set(roots)
    with debug.tracing() as first:
        out = h.fn(h.x_data)
    plain = h.fn(h.x_data)
    with debug.tracing() as trace:
        traced = h.fn(h.x_data)
    assert torch.equal(plain.data, traced.data) \
        and plain.scale == traced.scale
    assert torch.equal(out.data, traced.data)
    for tr in (first, trace):
        top = [name for depth, name in _tree(tr) if depth <= 1]
        assert top == ["head", "cpmm", "cpmm", "cpmm", "ccmm_col_to_diag",
                       "softmax", "ccmm_diag_to_col"]
        assert {s.pass_id for s in tr.spans} == {0}
    first_paths = [first.path(i) for i in range(len(first.spans))]
    paths = [trace.path(i) for i in range(len(trace.spans))]
    assert "head/softmax/softmax.pts" in paths
    encodes = [p for p in first_paths
               if p.startswith("head/softmax/softmax.pts/encode")]
    assert len(encodes) == 2
    assert not [p for p in paths
                if p.startswith("head/softmax/softmax.pts/encode")]


def test_bootstrap_stage_spans_beside_on_stage():
    B = build_bootstrap(BOOT, 1, seed=101, device="cpu")
    stages = []
    B.bootstrapper.on_stage = stages.append
    plain = B.fn(B.x_data)
    assert stages == ["ModRaise", "CoeffToSlot 0", "EvalMod real",
                      "EvalMod imag", "SlotToCoeff 0"]
    stages.clear()
    with debug.tracing() as trace:
        traced = B.fn(B.x_data)
    assert torch.equal(plain.data, traced.data)
    assert stages == ["ModRaise", "CoeffToSlot 0", "EvalMod real",
                      "EvalMod imag", "SlotToCoeff 0"]
    assert [name for depth, name in _tree(trace) if depth <= 1] == [
        "refresh", "modraise", "coeff_to_slot.0", "evalmod.real",
        "evalmod.imag", "slot_to_coeff.0"]
    root = trace.spans[0]
    for s in trace.spans[1:]:
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns


def test_limb_ew_launch_shape_counts_a_broadcast_axis_once():
    a = torch.zeros(2, 3, 5, 8, dtype=torch.int32)
    b = torch.zeros(3, 5, 8, dtype=torch.int32)       # broadcast over 2
    q = torch.zeros(5, 1, dtype=torch.int32)          # one per limb
    for op, ops, want in (
            ("mul", (a, b, None, q), ("mul", 240, 240, 120, 0, 5)),
            ("add", (a[:, :, :2], 7, None, 11), ("add", 96, 96, 0, 0, 0)),
            ("neg", (b, None, None, q[:1]), ("neg", 120, 120, 0, 0, 1))):
        shape, sizes, st, _ = limb_cuda.ew_layout(ops)
        assert limb_cuda.ew_shape(op, ops, shape.numel(), sizes, st) == want
