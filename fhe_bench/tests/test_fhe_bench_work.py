"""The frozen cost arithmetic: the kernel bounds reproduce the port's
smoke run's bound column, and a primitive's least time is its hand
count."""

from __future__ import annotations

import json
import math

import pytest

from conftest import BENCH
from fhe_bench.work import cost

N16, N15 = 1 << 16, 1 << 15


@pytest.mark.parametrize("kernel, shape, ms", [
    # PERF.md section 6: ks_mac, bootstrap, checked y [2, 6, 87, 2^16]
    ("ks_mac", (1, 2, 6, 87, N16, 87, 74, False), 0.19062),
    # ks_mac, bootstrap, commonest y [2, 6, 85, 2^16]
    ("ks_mac", (1, 2, 6, 85, N16, 87, 74, False), 0.18624),
    # base_conv, bootstrap, checked [2, 74] -> [2, 6, 87] (integer bound)
    ("base_conv", (2, 74, 6, 13, 87, N16, True, False), 0.14586),
    # base_conv, head, checked [8, 34] -> [8, 3, 45] (integer bound)
    ("base_conv", (8, 34, 3, 12, 45, N15, True, False), 0.07284),
])
def test_kernel_bounds_reproduce_the_smoke_runs(kernel, shape, ms):
    assert cost.kernel_bound_s(kernel, shape) * 1e3 == pytest.approx(
        ms, abs=5e-6)


def test_the_int32_rate_is_the_cards():
    assert cost.INT32_SLOTS_PER_S == 64 * 132 * 1980e6


def test_a_relinearization_least_time_is_its_hand_count():
    # head chain (N 2^15, L 34, K 11, dnum 3, alpha 12) at n_q 20, B 64:
    # D = 2 digits over T = 31 targets
    ctx = {"N": N15, "L": 34, "K": 11, "alpha": 12,
           "digit_ranges": [[0, 12], [12, 24], [24, 34]]}
    B, n, N, K, D, T = 64, 20, N15, 11, 2, 31
    butterflies = N // 2 * 15 * 4                 # slots per limb's NTT
    intt_c = B * n * butterflies
    conv = B * N * T * (2 * (12 + 8) + 10 * 2) + 7 * B * n * N
    ntt_y = B * D * T * butterflies
    mac = 2 * B * T * N * (2 * D + 8 * 1)
    mod_down = (B * K * butterflies + (B * N * n * (2 * K + 10)
                                       + 7 * B * K * N)
                + B * n * butterflies + 10 * B * n * N)
    slots = intt_c + conv + ntt_y + mac + 2 * mod_down + 2 * B * n * N
    nbytes = 4 * (3 * B * n * N + D * 2 * T * N + 2 * B * n * N)
    want = max(nbytes / 3.35e12, slots / (64 * 132 * 1980e6))
    got = cost.least_s(ctx, {"op": "relinearize", "B": B, "n_q": n})
    assert got == pytest.approx(want, rel=1e-12)
    assert slots / (64 * 132 * 1980e6) > nbytes / 3.35e12  # slot-bound


@pytest.mark.parametrize("config", ["bert-base-head-n16",
                                    "bert-base-boot-n16",
                                    "bert-base-boot-n16-parity"])
def test_frozen_work_prices_below_a_tenth_of_a_second_per_item(config):
    work = json.loads((BENCH / "work" / f"{config}.json").read_text())
    assert work["config"] == config and work["records"]
    least = cost.pass_least_s(work, work["batch"])
    assert 0 < least / work["batch"] < 0.1
    assert all(r["count"] > 0 and not math.isnan(cost.least_s(work["ctx"],
                                                               r))
               for r in work["records"])
