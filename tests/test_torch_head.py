"""The encrypted attention head of moai_tpu_torch (entry.build_head), at the
multi-chip dry-run dims of __graft_entry__ (logN 9, L 26, 32 inputs of 8
tokens, d_model 8, head_dim 8, exp_r 2, inv_iters 2, 3 inputs, seed 11).

Tier-1 holds the decrypted output to the float64 oracle, which repeats the
circuit's approximations (the (1+x/2^r)^(2^r) exp, the masks, sum_scale
and the Goldschmidt product), so what remains is CKKS noise and encoding
round-off.  The JAX head at these dims and seed is 1.4716e-8 from the
oracle (max abs, outputs up to 0.086); the port is bit-identical to it
(the slow test), so the tolerance is that error, rounded up to 1.5e-8."""

import math

import numpy as np
import pytest
import torch

from moai_tpu_torch.entry import balanced_input_scale, build_head, head_oracle
from moai_tpu_torch.ops import nonlinear
from moai_tpu_torch.params import Context, head_config

torch.set_num_threads(1)
DIMS = dict(logN=9, n_data_levels=12, num_x=32, num_row=8, d_model=8,
            head_dim=8, exp_r=2, inv_iters=2, input_count=3)
TOL = 1.5e-8


@pytest.mark.parametrize("nominal", [True, False])
def test_head_matches_oracle(nominal):
    """nominal: the input at ctx.scale, as _build_head encodes it; else at
    entry.balanced_input_scale (1.4716e-8 from the oracle here too)."""
    h = build_head(**DIMS, device="cpu", nominal_input_scale=nominal)
    out = h.fn(h.x_data)
    assert out.n_q == h.ctx.n_q0 + 2 and out.data.shape[0] == 8
    got = h.decode(out)
    want = h.oracle()
    assert got.shape == (3, 8, 8) and np.isfinite(got).all()
    assert np.abs(got - want).max() < TOL
    # rows past an input's length are zero
    for j, n in enumerate(h.lens):
        assert np.abs(got[j, n:]).max(initial=0.0) < TOL


def test_softmax_plaintexts_encoded_once_per_head():
    """A head encodes its softmax's two plaintexts on its first pass and
    makes later passes' from the kept coefficients, with the same output;
    a head of other lengths (seed 12: lengths 7, 5, 8 where seed 11 draws
    4, 4, 7) encodes its own and meets the oracle."""
    calls = nonlinear.softmax_pts_calls
    nonlinear.reset_softmax_pts_calls()
    h = build_head(**DIMS, device="cpu")
    first = h.fn(h.x_data)
    assert calls == {"encoded": 2, "reused": 0}
    second = h.fn(h.x_data)
    assert calls == {"encoded": 2, "reused": 2}
    assert torch.equal(first.data, second.data) \
        and first.scale == second.scale
    other = build_head(**DIMS, seed=12, device="cpu")
    assert not np.array_equal(other.lens, h.lens)
    got = other.decode(other.fn(other.x_data))
    assert calls == {"encoded": 4, "reused": 2}
    assert np.abs(got - other.oracle()).max() < TOL


def test_oracle_is_softmax_attention_in_the_limit():
    """With many squarings and iterations the oracle's approximations
    converge to exact masked softmax attention (checks the oracle itself)."""
    rng = np.random.default_rng(0)
    xs = rng.normal(0, 0.5, (2, 6, 5))
    w = {k: rng.normal(0, 0.3, (5, 4)) for k in ("wq", "wk", "wv")}
    w.update({k: rng.normal(0, 0.1, 4) for k in ("bq", "bk", "bv")})
    lens = [6, 4]
    got = head_oracle(xs, w, lens, exp_r=20, inv_iters=40, num_row=6,
                      eps=0.0)
    for j, n in enumerate(lens):
        x = xs[j, :n]
        s = (x @ w["wq"] + w["bq"]) @ (x @ w["wk"] + w["bk"]).T
        p = np.exp(s - s.max(1, keepdims=True))
        want = p / p.sum(1, keepdims=True) @ (x @ w["wv"] + w["bv"])
        assert np.abs(got[j, :n] - want).max() < 1e-5
        assert not got[j, n:].any()


def _scale_flow(ctx, log_x: float, exp_r: int, inv_iters: int) -> list:
    """log2 of the scale after each step of the head, as the ops' scale
    bookkeeping computes it: a rescale divides by the top pair of its
    level; CPMM, the exp's 1/2^r and the mask land where they start."""
    def pair(n):
        return math.log2(ctx.q_primes[n - 1]) + math.log2(ctx.q_primes[n - 2])
    n = ctx.L - 2                          # Q, K after CPMM, on the input
    s = 2 * log_x - pair(n)                # QK^T
    n -= 4                                 # QK^T rescale, exp's constant
    out = [s]
    for _ in range(exp_r):
        s = 2 * s - pair(n)
        n -= 2
        out.append(s)
    n -= 2                                 # the mask
    y = r = s
    for _ in range(inv_iters):             # Goldschmidt: y^2, res * (1+y)
        y = 2 * y - pair(n)
        n -= 2
        r = r + y - pair(n)
        out += [y, r]
    sm = s + r - pair(n - 2)               # exp * inverse
    return out + [sm, sm + log_x - pair(4)]   # softmax * V


def test_balanced_input_scale_at_the_heads_chain():
    """At the head's own chain (logN 15, L 34, exp_r 5, inv_iters 4) the
    nominal input scale drifts past q0 (60 bits) by the output; the
    balanced one keeps every step within 0.05 bits of ctx.scale."""
    ctx = Context(head_config(), device="cpu")
    nominal = _scale_flow(ctx, math.log2(ctx.scale), 5, 4)
    assert nominal[-1] > 100
    lx = math.log2(balanced_input_scale(ctx, 5, 4))
    balanced = _scale_flow(ctx, lx, 5, 4)
    assert max(abs(v - math.log2(ctx.scale)) for v in balanced) < 0.05


@pytest.mark.slow
def test_head_bit_identical_to_jax():
    """The whole head against __graft_entry__._build_head (jitted)."""
    import jax
    import __graft_entry__ as ge
    fn, x_data, _ = ge._build_head(**DIMS)
    want = np.asarray(jax.jit(fn)(x_data)).astype(np.int64)
    h = build_head(**DIMS, device="cpu", nominal_input_scale=True)
    assert np.array_equal(np.asarray(x_data).astype(np.int64),
                          h.x_data.numpy())
    assert np.array_equal(h.fn(h.x_data).data.numpy(), want)
