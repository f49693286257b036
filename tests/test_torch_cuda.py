"""moai_tpu_torch on a CUDA card: the NTT kernels against their plain
versions, a small encrypted head against the float64 oracle, and a small
bootstrap against the same bootstrap on the CPU.

This file imports neither JAX nor moai_tpu, so it runs on a GPU host
without them (tests/conftest.py imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a card every test skips."""

import dataclasses

import numpy as np
import pytest
import torch

from moai_tpu_torch import ntt_cuda
from moai_tpu_torch.entry import build_bootstrap, build_head
from moai_tpu_torch.ntt import ntt, intt, ntt_plain, intt_plain
from moai_tpu_torch.params import CKKSConfig, Context, \
    test_config as _test_config


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("logN,sl", [
    (9, None), (10, None), (11, None), (11, (2, 5)), (11, (8, 12)),
    (12, None), (13, None), (14, None), (15, None), (16, None), (16, (3, 7))])
def test_kernels_match_plain(card, logN, sl):
    """Every N the kernels take, all limbs and slices of the test chain."""
    ctx = Context(dataclasses.replace(_test_config(), logN=logN), device=card)
    tb = ctx.dev["ntt"]
    lo, hi = sl or (0, ctx.L + ctx.K)
    x = torch.stack([torch.randint(0, q, (3, 2, ctx.cfg.N), device=card)
                     for q in ctx.all_primes[lo:hi]], dim=-2)
    n0 = dict(ntt_cuda.launches)
    fwd = ntt(x, tb, sl)                       # dispatches to the kernel
    assert ntt_cuda.launches["ntt_fwd"] == n0["ntt_fwd"] + 1
    assert torch.equal(fwd, ntt_plain(x, tb, sl))
    back = intt(fwd, tb, sl)
    assert ntt_cuda.launches["ntt_inv"] == n0["ntt_inv"] + 1
    assert torch.equal(back, intt_plain(fwd, tb, sl))
    assert torch.equal(back, x)


def test_small_head_on_card(card):
    h = build_head(logN=9, n_data_levels=12, num_x=32, num_row=8, d_model=8,
                   head_dim=8, exp_r=2, inv_iters=2, input_count=3,
                   device=card)
    got = h.decode(h.fn(h.x_data))
    # the CPU run of the same head (tests/test_torch_head.py) is 1.4716e-8
    # from the oracle, and the card's arithmetic is exact
    assert np.abs(got - h.oracle()).max() < 1.5e-8


def test_bootstrap_on_card_equals_cpu(card):
    """The whole bootstrap (logN 9, L 28) gives the CPU's residues on the
    card: ModRaise's float32 CRT estimate rounds as the plain path does,
    and every other step is exact."""
    cfg = CKKSConfig(logN=9, q0_bits=(30.0, 30.0), data_pair_bits=26.0,
                     n_data_levels=13, dnum=7, special_bits=29.5,
                     hamming_weight=64)
    on_card = build_bootstrap(cfg, 2, seed=101, device=card)
    on_cpu = build_bootstrap(cfg, 2, seed=101, device="cpu")
    got = on_card.fn(on_card.x_data)
    want = on_cpu.fn(on_cpu.x_data)
    assert got.scale == want.scale
    assert torch.equal(got.data.cpu(), want.data)
