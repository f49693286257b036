"""LFM2's gated short-convolution mixer on moai_tpu_torch (models/lfm2.py,
ops/shortconv.py, entry.build_lfm2_conv) against its plain reference
(models/lfm2_reference.py), at logN 9: 32 sequences of 8 tokens, hidden
size 16, kernel 3.

The reference is held to HF's ``Lfm2ShortConv`` written with nn modules,
and its channel shares to the uncut mixer.  The encrypted share is held to
the reference's share: the circuit is the mixer itself (no polynomial
approximation), so what remains is CKKS noise and the rounding of the
weights, the masks and the taps (the share of seed 7 below is 1.23e-8
from the reference, outputs up to 0.045), and TOL is that error with
room.  Imports no JAX."""

import numpy as np
import pytest
import torch
from torch import nn

from moai_tpu_torch.encoder import Encoder
from moai_tpu_torch.encrypt import Decryptor, Encryptor
from moai_tpu_torch.entry import build_lfm2_conv
from moai_tpu_torch.evaluator import Evaluator
from moai_tpu_torch.keys import KeyGenerator
from moai_tpu_torch.models import lfm2_reference as ref
from moai_tpu_torch.models.lfm2 import LEVELS, Lfm2ConvDims
from moai_tpu_torch.ops.packing import batch_input, unpack_batch
from moai_tpu_torch.ops.shortconv import (ConvPlaintexts, causal_conv,
                                          shift_steps, token_masks)
from moai_tpu_torch.params import Context, head_config
from moai_tpu_torch.utils import debug

torch.set_num_threads(1)
DIMS = Lfm2ConvDims(hidden_size=16, conv_L_cache=3, channels=(4, 8),
                    num_x=32, num_row=8)
TOL = 5e-8


class HFShortConv(nn.Module):
    """HF's Lfm2ShortConv.slow_forward, without the cache."""

    def __init__(self, H: int, L: int):
        super().__init__()
        self.in_proj = nn.Linear(H, 3 * H, bias=False)
        self.conv = nn.Conv1d(H, H, L, groups=H, padding=L - 1, bias=False)
        self.out_proj = nn.Linear(H, H, bias=False)

    def forward(self, x, attention_mask):
        seqlen = x.shape[1]
        x = x * attention_mask[:, :, None].to(x.dtype)
        B, C, x = self.in_proj(x).transpose(-1, -2).chunk(3, dim=-2)
        conv_out = self.conv(B * x)[..., :seqlen]
        return self.out_proj((C * conv_out).transpose(-1, -2))


def test_reference_is_hf_short_conv():
    """The weights are PyTorch's default initialisations after
    manual_seed, and the mixer is HF's forward pass, padding mask too."""
    H, L, seed = 16, 3, 2147483659
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        hf = HFShortConv(H, L)
    w = ref.weights(seed, H, L)
    assert torch.equal(w["in_proj"], hf.in_proj.weight)
    assert torch.equal(w["conv"], hf.conv.weight[:, 0])
    assert torch.equal(w["out_proj"], hf.out_proj.weight)
    lens, h = ref.inputs(seed, 4, 8, H, 4, 8)
    mask = torch.arange(8)[None, :] < torch.as_tensor(lens)[:, None]
    with torch.no_grad():
        want = hf.double()(torch.as_tensor(h), mask)
    got = ref.mixer(h, w, lens)
    assert torch.allclose(got, want, rtol=0, atol=1e-14)
    assert float(got[mask].abs().min()) > 0
    assert float(got[~mask].abs().max()) == 0


def test_eight_shares_sum_to_the_uncut_mixer():
    """Column-parallel in_proj, per-channel gates and conv, row-parallel
    out_proj: the 8 shares' partial y add up to the whole layer's."""
    H, seed = 64, 5
    w = ref.weights(seed, H, 3)
    lens, h = ref.inputs(seed, 3, 8, H, 4, 8)
    whole = ref.mixer(h, w, lens)
    parts = [ref.mixer(h, w, lens, channels=(8 * i, 8 * i + 8))
             for i in range(8)]
    assert torch.allclose(sum(parts), whole, rtol=0, atol=1e-15)
    assert all(float((p - whole).abs().max()) > 1e-3 for p in parts)


@pytest.mark.parametrize("seed,full", [(1, False), (13, True)])
def test_encrypted_share_matches_reference(seed, full):
    """Seed 1 draws lengths 6, 6, 7 of 8; seed 13 draws 8, 8, 8, so the
    shifts' wrapped tokens land on valid ones and only the mask removes
    them."""
    P = build_lfm2_conv(logN=9, dims=DIMS, input_count=3, seed=seed,
                        device="cpu")
    assert (P.lens == DIMS.num_row).all() == full
    assert (P.lens < DIMS.num_row).all() == (not full)
    out = P.fn(P.x_data)
    assert out.n_q == P.ctx.n_q0 and out.data.shape[0] == DIMS.hidden_size
    got, want = P.decode(out), P.oracle()
    assert got.shape == (3, 8, 16) and np.abs(want).max() > 0.01
    assert np.abs(got - want).max() < TOL


def test_shift_conv_against_a_shift_of_the_token_axis():
    """causal_conv alone on u packed as the mixer packs it: each tap times
    the token axis shifted by its lag, zero before token 0 and past each
    sequence's length (lengths 8, 5, 8: the full ones wrap)."""
    ctx = Context(head_config(9, 2), device="cpu")
    enc = Encoder(ctx)
    kg = KeyGenerator(ctx, seed=3, device="cpu")
    ev = Evaluator(ctx, relin_key=kg.gen_relin_key(), device="cpu",
                   galois_keys=kg.gen_galois_keys(steps=shift_steps(32, 3)))
    rng = np.random.default_rng(3)
    lens = np.array([8, 5, 8])
    u = rng.normal(0, 0.5, (3, 8, 4))
    taps = rng.uniform(-0.6, 0.6, (4, 3))
    x = batch_input(Encryptor(ctx, enc, kg.gen_public_key(), kg,
                              device="cpu"), u, 32, 8)
    pts = ConvPlaintexts(ev, enc, taps, token_masks(lens, 32, 8, 256, 3),
                         x.n_q)
    v = causal_conv(ev, x, pts, 32)
    assert v.n_q == x.n_q - 2 and abs(v.scale / x.scale - 1) < 1e-12
    got = unpack_batch(Decryptor(ctx, enc, kg.sk, device="cpu").decrypt(
        v).real, 32, 8, 3)
    want = ref.causal_conv(torch.as_tensor(u), torch.as_tensor(taps))
    want = want.numpy() * (np.arange(8)[None, :] < lens[:, None])[..., None]
    assert np.abs(got - want).max() < 1e-7


def test_spans_of_a_pass():
    P = build_lfm2_conv(logN=9, dims=DIMS, input_count=3, seed=7,
                        device="cpu")
    with debug.tracing() as tr:
        P.fn(P.x_data)
    paths = [tr.path(i) for i in range(len(tr.spans))]
    root = "lfm2_conv"
    assert paths[0] == root
    assert [p for p in paths if p.count("/") == 1] == [
        f"{root}/lfm2.in_proj", f"{root}/lfm2.gate", f"{root}/lfm2.shift",
        f"{root}/lfm2.gate", f"{root}/lfm2.out_proj"]
    assert f"{root}/lfm2.in_proj/cpmm" in paths
    assert all(s.end_ns >= s.start_ns for s in tr.spans)


def test_the_chain_holds_the_mixers_levels():
    """head_config(logN, LEVELS) is the least chain: one level fewer
    raises."""
    with pytest.raises(ValueError, match="chain too short"):
        build_lfm2_conv(logN=9, n_data_levels=LEVELS - 1, dims=DIMS,
                        input_count=3, device="cpu")
    assert Lfm2ConvDims() == Lfm2ConvDims(2048, 3, (0, 256), 256, 128)
    with pytest.raises(ValueError, match="held channels"):
        Lfm2ConvDims(channels=(0, 4096))
