"""moai_tpu_torch on a CUDA card: the NTT kernels against their plain
versions, a small encrypted head against the float64 oracle, a small
bootstrap against the same bootstrap on the CPU, serial loads onto the
card against loads onto the CPU, and a small two-layer model resumed from
its layer-0 checkpoint against the same on the CPU.

This file imports neither JAX nor moai_tpu, so it runs on a GPU host
without them (tests/conftest.py imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a card every test skips."""

import dataclasses

import numpy as np
import pytest
import torch

from moai_tpu_torch import ntt_cuda, serial
from moai_tpu_torch.encoder import Encoder
from moai_tpu_torch.encrypt import Encryptor
from moai_tpu_torch.entry import build_bootstrap, build_head, build_model
from moai_tpu_torch.keys import KeyGenerator
from moai_tpu_torch.models.bert import BertDims, DepthPlan
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


def test_serial_loads_onto_card_equal_cpu(card, tmp_path):
    """Each kind written once, loaded onto the card and onto the CPU."""
    ctx = Context(_test_config(), device="cpu")
    kg = KeyGenerator(ctx, seed=3, device="cpu")
    gks = kg.gen_galois_keys(steps=[1, 2], dtype=torch.int32)
    encryptor = Encryptor(ctx, Encoder(ctx), kg.gen_public_key(), kg,
                          device="cpu")
    ct = encryptor.encrypt_values(
        np.random.default_rng(3).uniform(-1, 1, (2, ctx.cfg.slots)))
    files = {k: str(tmp_path / f"{k}.bin") for k in ("ct", "gk", "sk",
                                                     "state")}
    serial.save_ciphertext(files["ct"], ct, ctx.cfg)
    serial.save_galois_keys(files["gk"], gks)
    serial.save_secret_key(files["sk"], kg.sk)
    serial.save_layer_state(files["state"], ct, 0, ctx.cfg)
    for dev in (card, "cpu"):
        got = serial.load_ciphertext(files["ct"], device=dev)
        assert got.data.device.type == torch.device(dev).type
        assert torch.equal(got.data.cpu(), ct.data)
        state, idx = serial.load_layer_state(files["state"], device=dev)
        assert idx == 0 and torch.equal(state.data.cpu(), ct.data)
        assert torch.equal(serial.load_secret_key(files["sk"], device=dev)
                           .s_ntt.cpu(), kg.sk.s_ntt)
        keys = serial.load_galois_keys(files["gk"], device=dev,
                                       dtype=torch.int32)
        for g, k in gks.keys.items():
            assert keys.keys[g].data.dtype == torch.int32
            assert torch.equal(keys.keys[g].data.cpu(), k.data)


class _Stop(Exception):
    """Ends a model run after its first checkpoint."""


def test_model_resume_on_card_equals_cpu(card, tmp_path):
    """Two tiny layers: layer 0 to a checkpoint, reloaded, then layer 1
    from it, on the card and on the CPU, give the same residues."""
    out = {}
    for dev in (card, "cpu"):
        m = build_model(9, 10, BertDims(32, 8, 8, 2, 4, 16),
                        DepthPlan(2, 2, 1, 0, 8), 2, 3, device=dev)
        path = str(tmp_path / f"{torch.device(dev).type}.zip")

        def save_and_stop(i, ct):
            m.save_state(path, ct, i)
            raise _Stop
        with pytest.raises(_Stop):
            m.fn(m.x_data, on_layer=save_and_stop)
        state, idx = m.load_state(path)
        assert state.data.device.type == torch.device(dev).type
        out[dev] = m.fn(state.data, start_layer=idx + 1)
    got, want = out[card], out["cpu"]
    assert got.scale == want.scale
    assert torch.equal(got.data.cpu(), want.data)
