"""moai_tpu_torch limb arithmetic, primes and DRBG against moai_tpu.

Every modular result is the canonical residue in [0, q), so the port's
int64 functions must equal the JAX package's uint32 ones bit for bit, on
random values and on the edges (0, q-1, and values >= q for to_mont)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from moai_tpu import mod_arith as jma
from moai_tpu import primes as jpr
from moai_tpu.csprng import ShakeRng as JShake
from moai_tpu_torch import mod_arith as ma
from moai_tpu_torch import primes as tprimes
from moai_tpu_torch.csprng import ShakeRng

torch.set_num_threads(1)

QS = (tprimes.ntt_primes_near(29.5, 1 << 12, 2)
      + tprimes.ntt_primes_near(26.0, 1 << 12, 2))
RNG = np.random.default_rng(3)
N = 512


def _limb_consts():
    c = [ma.mont_constants(q) for q in QS]
    col = lambda k, dt: np.array([x[k] for x in c], dt).reshape(-1, 1)
    return ({k: col(k, np.uint32) for k in ("q", "qneg_inv", "r2")},
            {k: torch.from_numpy(col(k, np.int64)) for k in ("q", "rinv",
                                                            "r2")})


def _residues(edges: bool) -> np.ndarray:
    x = np.stack([RNG.integers(0, q, N, dtype=np.uint64) for q in QS])
    if edges:
        for i, q in enumerate(QS):
            x[i, :4] = [0, 1, q - 1, q - 2]
    return x.astype(np.uint32)


def _eq(j, t):
    return np.array_equal(np.asarray(j).astype(np.int64), t.numpy())


def test_host_constants_match():
    for q in QS:
        a, b = jma.mont_constants(q), ma.mont_constants(q)
        assert {k: b[k] for k in a} == a
        assert b["rinv"] * b["r1"] % q == 1
        for x in (0, 1, q - 1, 12345):
            assert ma.host_to_mont(x, q) == jma.host_to_mont(x, q)
            assert ma.host_from_mont(x, q) == jma.host_from_mont(x, q)
            assert ma.host_shoup(x, q) == jma.host_shoup(x, q)


@pytest.mark.parametrize("edges", [False, True])
def test_add_sub_neg_mul(edges):
    (jc, tc) = _limb_consts()
    a, b = _residues(edges), _residues(edges)[:, ::-1].copy()
    ta, tb = (torch.from_numpy(v.astype(np.int64)) for v in (a, b))
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    q, jq = tc["q"], jnp.asarray(jc["q"])
    assert _eq(jma.add_mod(ja, jb, jq), ma.add_mod(ta, tb, q))
    assert _eq(jma.sub_mod(ja, jb, jq), ma.sub_mod(ta, tb, q))
    assert _eq(jma.neg_mod(ja, jq), ma.neg_mod(ta, q))
    assert _eq(jma.mont_mul(ja, jb, jq, jnp.asarray(jc["qneg_inv"])),
               ma.mont_mul(ta, tb, q, tc["rinv"]))
    assert _eq(jma.from_mont(ja, jq, jnp.asarray(jc["qneg_inv"])),
               ma.from_mont(ta, q, tc["rinv"]))


def test_shoup_mul():
    (jc, tc) = _limb_consts()
    x = _residues(True)
    w = _residues(True)[:, :1]                      # one multiplier per limb
    ws = np.array([[ma.host_shoup(int(w[i, 0]), q)] for i, q in
                   enumerate(QS)], np.uint32)
    got = ma.shoup_mul(torch.from_numpy(x.astype(np.int64)),
                       torch.from_numpy(w.astype(np.int64)),
                       torch.from_numpy(ws.astype(np.int64)), tc["q"])
    want = jma.shoup_mul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(ws),
                         jnp.asarray(jc["q"]))
    assert _eq(want, got)


def test_to_mont_any_uint32():
    (jc, tc) = _limb_consts()
    x = RNG.integers(0, 1 << 32, (len(QS), N), dtype=np.uint64)
    x[:, :3] = [0, (1 << 32) - 1, 1 << 31]
    x = x.astype(np.uint32)
    got = ma.to_mont(torch.from_numpy(x.astype(np.int64)), tc["q"],
                     tc["rinv"], tc["r2"])
    want = jma.to_mont(jnp.asarray(x), jnp.asarray(jc["q"]),
                       jnp.asarray(jc["qneg_inv"]), jnp.asarray(jc["r2"]))
    assert _eq(want, got)


@pytest.mark.parametrize("bits,two_n,count,direction",
                         [(26.0, 1 << 12, 6, "down"), (29.5, 1 << 16, 4, "up"),
                          (28.0, 1 << 10, 5, "both")])
def test_primes_match(bits, two_n, count, direction):
    got = tprimes.ntt_primes_near(bits, two_n, count, direction=direction)
    assert got == jpr.ntt_primes_near(bits, two_n, count, direction=direction)
    for p in got:
        assert tprimes.primitive_root_2n(p, two_n) == \
            jpr.primitive_root_2n(p, two_n)
        assert tprimes.is_prime(p)
        assert tprimes.inv_mod(3, p) == jpr.inv_mod(3, p)


@pytest.mark.parametrize("seed", [0, 11, -5])
def test_shake_streams_match(seed):
    a, b = ShakeRng(seed), JShake(seed)
    assert a.bytes(100) == b.bytes(100)
    assert np.array_equal(a.integers(0, 1 << 62, size=3000, dtype=np.uint64),
                          b.integers(0, 1 << 62, size=3000, dtype=np.uint64))
    assert np.array_equal(a.normal(0, 3.2, (7, 9)), b.normal(0, 3.2, (7, 9)))
    assert np.array_equal(a.choice(1000, size=64, replace=False),
                          b.choice(1000, size=64, replace=False))
    assert np.array_equal(a.choice(np.array([-1, 0, 1]), size=(3, 50)),
                          b.choice(np.array([-1, 0, 1]), size=(3, 50)))
    assert int(a.integers(1 << 62)) == int(b.integers(1 << 62))
