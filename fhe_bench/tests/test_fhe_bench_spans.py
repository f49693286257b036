"""The span reader on synthetic intervals (self intervals, idle outside
every span, a gap that straddles two spans) and on a real trace of the
tiny head, and the NTT, limb_ew and diag_mac bounds against the port's
smoke-run column (PERF.md section 6, "4-byte bound ms")."""

from __future__ import annotations

import pytest

from conftest import BENCH
from fhe_bench import core, spans

N16 = 1 << 16
MS = 1_000_000


def _rows():
    """pass [0, 100) ms: a [10, 40) with a.x [20, 30), b [50, 90);
    a second pass [200, 260) with encode [210, 250)."""
    return [("pass", -1, 0, 100 * MS, 5), ("pass/a", 0, 10 * MS, 40 * MS, 3),
            ("pass/a/a.x", 1, 20 * MS, 30 * MS, 1),
            ("pass/b", 0, 50 * MS, 90 * MS, 2),
            ("pass", -1, 200 * MS, 260 * MS, 4),
            ("pass/encode", 4, 210 * MS, 250 * MS, 0)]


def test_self_segments_cut_children_out():
    segs = spans.self_segments(_rows())
    assert [(s // MS, e // MS, i) for s, e, i in segs] == [
        (0, 10, 0), (10, 20, 1), (20, 30, 2), (30, 40, 1), (40, 50, 0),
        (50, 90, 3), (90, 100, 0), (200, 210, 4), (210, 250, 5),
        (250, 260, 4)]


def test_idle_is_charged_to_self_intervals_and_outside():
    idle = [(15 * MS, 25 * MS, "g1"),      # straddles a's self and a.x
            (45 * MS, 55 * MS, "g2"),      # pass's self, then b
            (95 * MS, 205 * MS, "g3"),     # pass, outside, the next pass
            (220 * MS, 230 * MS, "g4")]    # inside encode
    got = spans.attribute(_rows(), idle)
    secs = {p: round(v[0] * 1e3, 6) for p, v in got.items()}
    assert secs == {"pass/a": 5.0, "pass/a/a.x": 5.0, "pass": 15.0,
                    "pass/b": 5.0, spans.OUTSIDE: 100.0,
                    "pass/encode": 10.0}
    assert got[spans.OUTSIDE][2] == "g3" and got["pass"][2] == "g3"
    assert round(got["pass"][1] * 1e3, 6) == 10.0    # g3's two pieces
    s = spans.summarise(_rows(), idle)
    assert s["idle_s"] == pytest.approx(0.140)
    assert s["below_root_share"] == pytest.approx(25 / 140)
    assert s["idle_gaps"][0] == [f"{spans.OUTSIDE} | g3", 0.1]
    assert s["spans"]["pass"] == pytest.approx([0.160, 0.015, 9])
    assert spans.host_in_s(_rows(), "encode") == pytest.approx(0.040)
    assert spans.idle_in_s(s["idle_by_span"], "encode") == \
        pytest.approx(0.010)


def test_idle_intervals_from_device_events():
    events = [(10, 20, "void ntt_cols<false>(int*)"), (15, 30, "limb_ew"),
              (40, 50, "Memcpy HtoD (Pageable -> Device)")]
    got = spans.idle_intervals(events, 0, 60)
    assert got == [(0, 10, "after (start) before ntt_cols"),
                   (30, 40, "after limb_ew before Memcpy HtoD"),
                   (50, 60, "after Memcpy HtoD before (end)")]


def test_a_real_trace_of_the_tiny_head():
    from moai_tpu_torch.entry import build_head
    from moai_tpu_torch.utils import debug
    h = build_head(logN=9, n_data_levels=12, num_x=32, num_row=8,
                   d_model=8, head_dim=8, exp_r=2, inv_iters=2,
                   input_count=3, device="cpu")
    with debug.tracing() as trace:
        h.fn(h.x_data)
    rows = spans.span_rows(trace)
    start, end = rows[0][2], rows[0][3]
    idle = [(start - MS, end + MS, "all")]    # as if the device never ran
    s = spans.summarise(rows, idle)
    assert s["idle_s"] == pytest.approx((end - start + 2 * MS) / 1e9)
    assert s["idle_by_span"][spans.OUTSIDE] == pytest.approx(0.002)
    host = s["spans"]
    assert host["head"][0] == pytest.approx((end - start) / 1e9)
    assert sum(v[1] for p, v in host.items() if p != spans.OUTSIDE) == \
        pytest.approx(host["head"][0])
    assert spans.host_in_s(rows, "encode") > 0


def _module(name):
    return core._load_module(BENCH / "metrics" / f"{name}.py", name)


@pytest.mark.parametrize("metric, shape, ms", [
    # the NTT, bootstrap, [8, 2, 87, 2^16]: rows 1392, 87 limbs
    ("ntt_roofline", (8 * 2 * 87, 87, 16), 0.21785),
    # mont_mul of [2, 2, 74, 2^16] with a per-limb q
    ("limb_ew_roofline", ("mul", 4 * 74 * N16, 4 * 74 * N16, 4 * 74 * N16,
                          0, 74), 0.06949),
    # diag_mac, 8 diagonals x [2, 2, 74, 2^16]
    ("diag_mac_roofline", (8, 4, 74, N16), 0.25479),
])
def test_bounds_reproduce_the_smoke_runs(metric, shape, ms):
    assert _module(metric).bound_s(shape) * 1e3 == pytest.approx(
        ms, rel=5e-3)


def test_rooflines_read_none_without_a_matched_profile():
    for name in ("ntt_roofline", "limb_ew_roofline", "diag_mac_roofline"):
        read = core.Bench().reader(name)
        assert read({"profile": None}) is None
        assert read({"profile": {"matched": False, "port": {},
                                 "shapes": {}, "launches": {},
                                 "passes": 2}}) is None


def test_a_roofline_over_profiled_launches():
    prof = {"matched": True, "passes": 2,
            "port": {"diag_mac": [0.002, 4], "limb_ew": [0.001, 2]},
            "shapes": {"diag_mac": {(8, 4, 74, N16): 4}},
            "launches": {"diag_mac": 4}}
    got = core.Bench().reader("diag_mac_roofline")({"profile": prof})
    assert got == pytest.approx(100 * 4 * 0.25479e-3 / 0.002, rel=5e-3)
    assert core.Bench().reader("limb_ew_roofline")({"profile": prof}) is None


def test_the_command_rehearses_on_the_cpu(tiny_root):
    """``measure`` at logN 9 on the CPU: the set-up's spans, the cost
    passes, and every idle second of the profiled passes (no device
    events: all idle) charged to a span path or outside."""
    import torch
    r = spans.measure(core.Bench(tiny_root), "tiny-head-pass", 2147483659,
                      1, 1, torch.device("cpu"))
    assert {"context", "keygen.galois"} <= set(r["setup_split_s"])
    assert r["galois_keys_s"] == r["setup_split_s"]["keygen.galois"]
    assert len(r["host_pass_runs_s"]["on"]) == 1
    assert r["idle_s"] == pytest.approx(r["window_s"], rel=1e-6)
    assert r["below_root_share"] > 0.99
    assert r["host_encode_s"] > 0 and r["ntt_roofline"] is None
    assert r["idle_gaps"][0][0].startswith("head/")
