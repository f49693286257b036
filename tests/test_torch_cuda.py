"""moai_tpu_torch on a CUDA card: the NTT kernels and the limb-arithmetic
kernels against their plain versions (int32 residues, the port's at-rest
format; every wrapper refuses int64), a small encrypted head against the
float64 oracle, a small bootstrap against the same bootstrap on the CPU,
serial loads onto the card against loads onto the CPU, a small
two-layer model resumed from its layer-0 checkpoint against the same on
the CPU, and the sharded programs (parallel/sharding.py: the evaluator
step over limb shards, the column-sharded CCMM and refresh) against the
same programs unsharded on one card, over a virtual mesh on one card and
over a mesh of real cards where the host has more than one, and the
sharded attention head (entry.build_sharded_head) on a virtual (2, 2) mesh
against the unsharded head; a channel share of LFM2's conv mixer
(entry.build_lfm2_conv) against the same share on the CPU; the CPMM's
digit split and bucket fold (modmat_cuda) against their plain versions,
and mod_matmul on the card against the CPU's; a span
(utils/debug.py) holding its NTT kernels on the profiler's clock, and every
kernel's launch shapes counting its launches.

This file imports neither JAX nor moai_tpu, so it runs on a GPU host
without them (tests/conftest.py imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a card every test skips."""

import dataclasses

import numpy as np
import pytest
import torch

from moai_tpu_torch import limb_cuda, modmat, modmat_cuda, ntt_cuda, serial
from moai_tpu_torch import mod_arith as ma
from moai_tpu_torch.ciphertext import Ciphertext
from moai_tpu_torch.encoder import Encoder
from moai_tpu_torch.encrypt import Encryptor
from moai_tpu_torch.entry import (build_bootstrap, build_head,
                                  build_lfm2_conv, build_model,
                                  build_sharded_ccmm, build_sharded_head,
                                  build_sharded_step)
from moai_tpu_torch.keys import KeyGenerator
from moai_tpu_torch.models.bert import BertDims, DepthPlan
from moai_tpu_torch.models.lfm2 import Lfm2ConvDims
from moai_tpu_torch.ntt import ntt, intt, ntt_plain, intt_plain
from moai_tpu_torch.params import CKKSConfig, Context, head_config, \
    test_config as _test_config
from moai_tpu_torch.parallel.sharding import (ShardedBootstrapper, gather,
                                              make_mesh)
from moai_tpu_torch.primes import ntt_primes_near


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
    x = torch.stack([torch.randint(0, q, (3, 2, ctx.cfg.N), device=card,
                                   dtype=torch.int32)
                     for q in ctx.all_primes[lo:hi]], dim=-2)
    n0 = dict(ntt_cuda.launches)
    fwd = ntt(x, tb, sl)                       # dispatches to the kernel
    assert ntt_cuda.launches["ntt_fwd"] == n0["ntt_fwd"] + 1
    assert torch.equal(fwd, ntt_plain(x, tb, sl))
    back = intt(fwd, tb, sl)
    assert ntt_cuda.launches["ntt_inv"] == n0["ntt_inv"] + 1
    assert torch.equal(back, intt_plain(fwd, tb, sl))
    assert torch.equal(back, x)


def _residues(qs, lead, N, gen):
    """Canonical int32 residues [*lead, len(qs), N] on qs' device, with 0,
    1 and q - 1 in the first columns and q - 1 over the first row's
    rest."""
    x = torch.randint(0, 1 << 62, lead + (len(qs), N), device=qs.device,
                      generator=gen).remainder_(qs.reshape(-1, 1)).int()
    x[..., 0], x[..., 1] = 0, 1
    x[..., 2] = qs - 1
    x.reshape(-1, len(qs), N)[0, :, 3:] = qs.reshape(-1, 1) - 1
    return x


def _past_q(qs, lead, N, gen):
    """int32 values in [q, 2^31) per limb row (the kernels' domain beyond
    the canonical residues), with q, 2q - 1, 2^30 and 2^31 - 1 first."""
    lo = qs.reshape(-1, 1).long()
    x = (lo + torch.randint(0, 1 << 62, lead + (len(qs), N), device=qs.device,
                            generator=gen).remainder_((1 << 31) - lo)).int()
    x[..., 0] = qs
    x[..., 1] = 2 * qs - 1
    x[..., 2], x[..., 3] = 1 << 30, (1 << 31) - 1
    return x


@pytest.mark.parametrize("logN", range(9, 17))
def test_limb_kernels_match_plain(card, logN):
    """Every limb kernel torch.equal to its plain version on the card: the
    elementwise family on each broadcast pattern of its call sites (and on
    operands in [q, 2^31)), base_conv at the key-switch decomposition of
    every level, the mod-down and ModRaise's conversion, ks_mac with and
    without the hoisted permutation, and diag_mac, then the edge shapes of
    _limb_edge_shapes; each kernel launched."""
    ctx = Context(dataclasses.replace(_test_config(), logN=logN), device=card)
    dv, L, K, N = ctx.dev, ctx.L, ctx.K, ctx.cfg.N
    gen = torch.Generator(card).manual_seed(logN)

    def res(qs, lead):
        return _residues(qs, lead, N, gen)
    before = dict(limb_cuda.launches)
    q, rinv = dv["q"][:L].reshape(-1, 1), dv["rinv"][:L].reshape(-1, 1)
    a, b = res(dv["q"][:L], (2, 2)), res(dv["q"][:L], (2, 2))
    col = res(dv["q"][:L], (2, 1))[..., :1]    # [C, 1, L, 1]
    qe, re_ = int(dv["q"][L - 1]), int(dv["rinv"][L - 1])
    u = torch.randint(0, 1 << 30, (2, 1, N), device=card, generator=gen,
                      dtype=torch.int32)
    wide = _past_q(dv["q"][:L], (2, 2), N, gen)
    r2 = dv["r2"][:L].reshape(-1, 1)
    pairs = [
        (ma.add_mod(a, b, q), ma.add_mod_plain(a, b, q)),
        (ma.sub_mod(a, b, q), ma.sub_mod_plain(a, b, q)),
        (ma.neg_mod(a, q), ma.neg_mod_plain(a, q)),
        (ma.mont_mul(a, b, q, rinv), ma.mont_mul_plain(a, b, q, rinv)),
        (ma.mont_mul(a, b[0, :1], q, rinv),
         ma.mont_mul_plain(a, b[0, :1], q, rinv)),
        (ma.mont_mul(a, col, q, rinv), ma.mont_mul_plain(a, col, q, rinv)),
        (ma.to_mont(u, q, rinv, r2), ma.mont_mul_plain(u, r2, q, rinv)),
        (ma.from_mont(a, q, rinv), ma.from_mont_plain(a, q, rinv)),
        (ma.sub_mont_mul(a[..., :L - 1, :], b[..., 1:, :], col[..., 1:, :],
                         q[:L - 1], rinv[:L - 1]),
         ma.sub_mont_mul_plain(a[..., :L - 1, :], b[..., 1:, :],
                               col[..., 1:, :], q[:L - 1], rinv[:L - 1])),
        (ma.add_mod(a[..., -1:, :], qe >> 1, qe),
         ma.add_mod_plain(a[..., -1:, :], qe >> 1, qe)),
        (ma.from_mont(a[..., -1:, :], qe, re_),
         ma.from_mont_plain(a[..., -1:, :], qe, re_)),
        (ma.sub_mod(wide, a, q), ma.sub_mod_plain(wide, a, q)),
        (ma.mont_mul(wide, b, q, rinv), ma.mont_mul_plain(wide, b, q, rinv)),
        (ma.from_mont(wide, q, rinv), ma.from_mont_plain(wide, q, rinv)),
    ]
    for i, (got, want) in enumerate(pairs):
        assert torch.equal(got, want), i
    qall = dv["q"]
    for n_q in range(1, L + 1):
        D = sum(1 for lo, _ in ctx.digit_ranges if lo < n_q)
        qt = torch.cat([qall[:n_q], qall[L:]]).reshape(-1, 1)
        rt = torch.cat([dv["rinv"][:n_q], dv["rinv"][L:]]).reshape(-1, 1)
        hat = dv["ks_hat_mm"][n_q, :D]
        hat_t = torch.cat([hat[..., :n_q], hat[..., L:]], dim=-1)
        c = res(qall[:n_q], (2,))
        args = (c, dv["ks_q_pad"], dv["ks_rinv_pad"],
                dv["ks_hatinv_mont"][n_q, :D], hat_t, qt, rt)
        assert torch.equal(ma.base_conv(*args), ma.base_conv_plain(*args))
        y = res(qt.reshape(-1), (2, D))
        keys = [res(qall, (ctx.dnum, 2)) for _ in range(3)]
        perm = torch.stack([torch.randperm(N, device=card, generator=gen)
                            for _ in keys])
        for kw in ({"keys": keys[0]}, {"keys": keys, "perm": perm}):
            for got, want in zip(
                    ma.ks_mac(y, kw["keys"], L, qt, rt, kw.get("perm")),
                    ma.ks_mac_plain(y, kw["keys"], L, qt, rt,
                                    kw.get("perm"))):
                assert torch.equal(got, want), n_q
    cp = res(qall[L:], (2, 2))
    args = (cp, qall[L:], dv["rinv"][L:], dv["pdown_hatinv_mont"],
            dv["pdown_hat_modq_mm"][None, :, :L - 1], q[:L - 1], rinv[:L - 1])
    assert torch.equal(ma.base_conv(*args), ma.base_conv_plain(*args))
    lam = res(qall[:2], (2, 2))
    k = torch.randint(0, 3, (2, 2, N), device=card, generator=gen,
                      dtype=torch.int32)
    hat = res(qall[:L], (2,))[..., 0][None].contiguous()
    args = (lam, None, None, None, hat, q, rinv, k, dv["r1"][:L])
    assert torch.equal(ma.base_conv(*args), ma.base_conv_plain(*args))
    cts = [res(qall[:L], (2, 2)) for _ in range(9)]
    pts = res(qall[:L], (9,))
    assert torch.equal(ma.diag_mac(cts, pts, q, rinv),
                       ma.diag_mac_plain(cts, pts, q, rinv))
    _limb_edge_shapes(ctx, res)
    torch.cuda.synchronize()
    assert all(limb_cuda.launches[k] > before[k] for k in before)


def _galois_perms(N, steps, device):
    """NTT-domain permutations of the rotations by ``steps``
    (keys.KeyGenerator.galois_perm of 5^s mod 2N)."""
    k = torch.arange(N, device=device)
    return torch.stack([((pow(5, s, 2 * N) * (2 * k + 1)) % (2 * N) - 1) // 2
                        for s in steps])


def _limb_edge_shapes(ctx, res):
    """base_conv and ks_mac on odd B and B = 1, ks_mac over MAX_ROT
    rotations through real Galois permutations, and every compile-time
    bucket of both kernels (base_conv digits of 8, 16, 20 and 32 inputs,
    ks_mac of 3, 7 and 13 digits, T not a multiple of the tile of four) on
    primes just below 2^30, and base_conv's input conversion on operands
    in [q, 2^31) and ModRaise's term on negative k."""
    dv, L, N = ctx.dev, ctx.L, ctx.cfg.N
    card = dv["q"].device
    qall = dv["q"]
    D = ctx.dnum
    qt = torch.cat([qall[:L], qall[L:]]).reshape(-1, 1)
    rt = torch.cat([dv["rinv"][:L], dv["rinv"][L:]]).reshape(-1, 1)
    hat = dv["ks_hat_mm"][L, :D]

    def same(got, want, what):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            assert torch.equal(g, w), what
    for B in (1, 3):
        args = (res(qall[:L], (B,)), dv["ks_q_pad"], dv["ks_rinv_pad"],
                dv["ks_hatinv_mont"][L, :D], hat, qt, rt)
        same(ma.base_conv(*args), ma.base_conv_plain(*args), ("B", B))
        y = res(qt.reshape(-1), (B, D))
        key = res(qall, (ctx.dnum, 2))
        same(ma.ks_mac(y, key, L, qt, rt), ma.ks_mac_plain(y, key, L, qt, rt),
             ("B", B))
    R = limb_cuda.MAX_ROT
    perm = _galois_perms(N, range(1, R + 1), card)
    keys = [res(qall, (ctx.dnum, 2)) for _ in range(2)] * (R // 2)
    y = res(qt.reshape(-1), (2, D))
    same(ma.ks_mac(y, keys, L, qt, rt, perm),
         ma.ks_mac_plain(y, keys, L, qt, rt, perm), "MAX_ROT")
    del keys, perm, y

    big = ntt_primes_near(29.99, 2, 40)
    primes = torch.tensor(big, device=card, dtype=torch.int32)
    rinvs = torch.tensor([ma.mont_constants(p)["rinv"] for p in big],
                         device=card, dtype=torch.int32)
    for D, A, S, nt in ((1, 8, 8, 5), (1, 16, 16, 7), (2, 20, 33, 5),
                        (1, 32, 32, 6)):
        pad = torch.arange(D * A, device=card) % S
        tq = primes[S:S + nt]
        hatinv = torch.randint(0, 1 << 62, (D * A,), device=card).remainder_(
            primes[pad]).int()
        hat = torch.randint(0, 1 << 62, (D, A, nt), device=card).remainder_(
            tq).int()
        args = (res(primes[:S], (3,)), primes[pad], rinvs[pad], hatinv, hat,
                tq.reshape(-1, 1), rinvs[S:S + nt].reshape(-1, 1))
        same(ma.base_conv(*args), ma.base_conv_plain(*args), (D, A, S, nt))
    # the conversion on inputs in [q, 2^31) (the int32 lanes' range), and
    # ModRaise's term on negative k
    x = res(primes[:5], (3,))
    x[0, :, 5:9] = torch.tensor([big[0], (1 << 30) + 3, (1 << 31) - 2,
                                 (1 << 31) - 1], device=card)
    hatinv = torch.randint(0, 1 << 62, (5,), device=card).remainder_(
        primes[:5]).int()
    hat = torch.randint(0, 1 << 62, (1, 5, 3), device=card).remainder_(
        primes[5:8]).int()
    args = (x, primes[:5], rinvs[:5], hatinv, hat,
            primes[5:8].reshape(-1, 1), rinvs[5:8].reshape(-1, 1))
    same(ma.base_conv(*args), ma.base_conv_plain(*args), "past q")
    k = torch.randint(-3, 4, (3, N), device=card, dtype=torch.int32)
    kq = primes[5:8] - 1
    args = (res(primes[:5], (3,)), None, None, None, hat,
            primes[5:8].reshape(-1, 1),
            rinvs[5:8].reshape(-1, 1), k, kq)
    same(ma.base_conv(*args), ma.base_conv_plain(*args), "negative k")
    q_limbs, n_q, kp = 20, 3, 4
    KL = q_limbs + kp
    tq = torch.cat([primes[:n_q], primes[q_limbs:KL]]).reshape(-1, 1)
    trinv = torch.cat([rinvs[:n_q], rinvs[q_limbs:KL]]).reshape(-1, 1)
    perm = _galois_perms(N, (3, 7), card)
    for D in (3, 7, 13):
        y = res(tq.reshape(-1), (3, D))
        keys = [res(primes[:KL], (D, 2)) for _ in range(2)]
        same(ma.ks_mac(y, keys[0], q_limbs, tq, trinv),
             ma.ks_mac_plain(y, keys[0], q_limbs, tq, trinv), D)
        same(ma.ks_mac(y, keys, q_limbs, tq, trinv, perm),
             ma.ks_mac_plain(y, keys, q_limbs, tq, trinv, perm), D)
    # a limb shard's key rows read in place (parallel/sharding.py): Q rows
    # from row 5 of whole keys and the special share [2, 4)
    s0, plo, phi, n_q = 5, 2, 4, 6
    tq = torch.cat([primes[s0:s0 + n_q],
                    primes[q_limbs + plo:q_limbs + phi]]).reshape(-1, 1)
    trinv = torch.cat([rinvs[s0:s0 + n_q],
                       rinvs[q_limbs + plo:q_limbs + phi]]).reshape(-1, 1)
    y = res(tq.reshape(-1), (3, 7))
    keys = [res(primes[:KL], (7, 2))[..., s0:q_limbs + phi, :]
            for _ in range(2)]
    ql = q_limbs + plo - s0
    same(ma.ks_mac(y, keys[0], ql, tq, trinv),
         ma.ks_mac_plain(y, keys[0], ql, tq, trinv), "window")
    same(ma.ks_mac(y, keys, ql, tq, trinv, perm),
         ma.ks_mac_plain(y, keys, ql, tq, trinv, perm), "window")


@pytest.mark.parametrize("logN", range(9, 17))
def test_limb_ew_and_diag_mac_on_int32_lanes(card, logN):
    """limb_ew's every op on its vector and scalar paths: operands
    contiguous from a 16-byte boundary, one element off it, broadcast
    along N (per-limb and per-column constants), Python ints, a modulus
    varying along the innermost dim; canonical residues and values in [q,
    2^31); then diag_mac over 1 to 32 diagonals (each bucket of its term
    count), all torch.equal to the plain versions."""
    ctx = Context(dataclasses.replace(_test_config(), logN=logN), device=card)
    dv, L, N = ctx.dev, ctx.L, ctx.cfg.N
    gen = torch.Generator(card).manual_seed(100 + logN)
    qs = dv["q"][:L]
    q, rinv = qs.reshape(-1, 1), dv["rinv"][:L].reshape(-1, 1)
    canon = [_residues(qs, (2, 2), N, gen) for _ in range(3)]
    past = [_past_q(qs, (2, 2), N, gen) for _ in range(3)]
    col = _residues(qs, (2, 1), N, gen)[..., :1]
    qe = int(qs[-1])
    n0 = limb_cuda.launches["limb_ew"]
    calls = 0
    for a, b, c in (canon, past, (canon[0], past[1], canon[2])):
        cases = [(a, b, c, q), (a, col, col, q), (a, 7, 99, q),
                 (a[..., 1:], b[..., 1:], c[..., 1:], q),
                 (a[..., 1:N - 3], b[..., 3:N - 1], c[..., :N - 4], q),
                 (a.transpose(-1, -2), b.transpose(-1, -2),
                  c.transpose(-1, -2), qs),
                 (a[..., -1:, :], qe >> 1, b[..., -1:, :], qe)]
        for x, y, z, m in cases:
            r = rinv if isinstance(m, torch.Tensor) and m.dim() == 2 else (
                dv["rinv"][:L] if isinstance(m, torch.Tensor) else
                ma.mont_constants(m)["rinv"])
            for got, want in (
                    (ma.add_mod(x, y, m), ma.add_mod_plain(x, y, m)),
                    (ma.sub_mod(x, y, m), ma.sub_mod_plain(x, y, m)),
                    (ma.neg_mod(x, m), ma.neg_mod_plain(x, m)),
                    (ma.mont_mul(x, y, m, r), ma.mont_mul_plain(x, y, m, r)),
                    (ma.from_mont(x, m, r), ma.from_mont_plain(x, m, r)),
                    (ma.sub_mont_mul(x, y, z, m, r),
                     ma.sub_mont_mul_plain(x, y, z, m, r))):
                assert got.dtype == torch.int32
                assert torch.equal(got, want), (x.shape, x.stride())
                calls += 1
    assert limb_cuda.launches["limb_ew"] - n0 == calls
    for J in (1, 2, 3, 4, 5, 8, 9, 12, 16, 17, 24, 31, 32):
        cts = [_residues(qs, (2, 2), N, gen) for _ in range(J)]
        pts = _residues(qs, (J,), N, gen)
        got = ma.diag_mac(cts, pts, q, rinv)
        assert got.dtype == torch.int32
        assert torch.equal(got, ma.diag_mac_plain(cts, pts, q, rinv)), J


def test_wrappers_refuse_int64(card):
    """Each kernel wrapper raises TypeError on an int64 residue tensor (the
    data and the per-limb tables alike)."""
    ctx = Context(_test_config(), device=card)
    dv, L, N = ctx.dev, ctx.L, ctx.cfg.N
    gen = torch.Generator(card).manual_seed(5)
    q = dv["q"][:L].reshape(-1, 1)
    x = _residues(dv["q"][:L], (2,), N, gen)
    wide = x.long()
    tb = dv["ntt"]["cuda"]
    hat = dv["ks_hat_mm"][L, :1, :, :2]
    y = _residues(dv["q"][:L], (1, 1), N, gen)
    key = _residues(dv["q"], (ctx.dnum, 2), N, gen)
    calls = [
        lambda: limb_cuda.limb_ew("add", wide, x, None, q),
        lambda: limb_cuda.limb_ew("mul", x, x, None, q.long()),
        lambda: ntt_cuda.ntt_cuda(wide, tb, (0, L)),
        lambda: ntt_cuda.intt_cuda(wide, tb, (0, L)),
        lambda: limb_cuda.base_conv(wide, dv["ks_q_pad"], None, hat, q[:2]),
        lambda: limb_cuda.base_conv(x, dv["ks_q_pad"], None, hat.long(),
                                    q[:2]),
        lambda: limb_cuda.ks_mac(y.long(), key[:, :, :L], L, q),
        lambda: limb_cuda.ks_mac(y, key[:, :, :L].long(), L, q),
        lambda: limb_cuda.diag_mac([wide], x[:1], q),
        lambda: limb_cuda.diag_mac([x], wide[:1], q),
        lambda: modmat_cuda.digit_split(wide),
    ]
    part = torch.zeros((24, 2 * N), dtype=torch.int32, device=card)
    out = torch.zeros((2, 2, N), dtype=torch.int32, device=card)
    c = q[0]
    calls += [
        lambda: modmat_cuda.bucket_fold(part.long(), None, out, c, c),
        lambda: modmat_cuda.bucket_fold(part, out.long(), out, c, c),
        lambda: modmat_cuda.bucket_fold(part, None, out.long(), c, c),
        lambda: modmat_cuda.bucket_fold(part, None, out, c.long(), c),
        lambda: modmat_cuda.bucket_fold(part, None, out, c, c.long()),
    ]
    for i, call in enumerate(calls):
        with pytest.raises(TypeError):
            call()


def _modmat_primes(card, n):
    """n primes of the CPMM tests, cycling through the largest odd prime
    below 2^30 of the chains' kind, a 26-bit data prime and 12289."""
    qs = Context(head_config(11, 3), device="cpu").q_primes
    cycle = [qs[0], qs[3], 12289]
    return torch.tensor([cycle[i % 3] for i in range(n)], dtype=torch.int32,
                        device=card)


@pytest.mark.parametrize("J,P,N", [(37, 2, 64), (48, 1, 200), (64, 3, 8),
                                   (modmat.MAX_J, 2, 16)])
def test_modmat_kernels_match_plain(card, J, P, N):
    """digit_split and bucket_fold torch.equal to their plain versions:
    the split of each limb of a limb window of a larger x (rows of N apart
    from each other, not contiguous), J on and off the 64-wide tile, N off
    it, inputs up to 2^31 - 1; the fold of every bucket with part at
    +-2^29 and acc holding 0 and q - 1, with and without an accumulator,
    in place, and into an output limb's strides."""
    L = 3
    qs = _modmat_primes(card, L + 2)
    gen = torch.Generator(card).manual_seed(J + N)
    big = _residues(qs, (J, P), N, gen)                  # [J, P, L + 2, N]
    big[0, 0, :, :4] = torch.tensor([1 << 30, (1 << 31) - 1, 0x7F7F7F7F,
                                     0x7F807F80], dtype=torch.int32)
    x = big[:, :, 1:L + 1]
    n0 = dict(modmat_cuda.launches)
    for li in range(L):
        xl = x[:, :, li, :]
        assert not xl.is_contiguous()
        got = modmat_cuda.digit_split(xl)
        assert got.shape == (P * N, modmat.NDIG * modmat_cuda.padded_j(J))
        assert torch.equal(got, modmat.digit_split_plain(xl)), li
    fq = qs[1:L + 1]
    q, c = fq.cpu(), torch.from_numpy(modmat.host_bucket_consts(fq.tolist()))
    rinv = torch.tensor([ma.mont_constants(int(v))["rinv"] for v in q],
                        dtype=torch.int32)
    I, lim = 5, 1 << 29
    part = torch.randint(-lim, lim + 1, (24, P * N), device=card,
                         generator=gen, dtype=torch.int32)
    part[0, :2], part[1, :2] = lim, -lim
    out = torch.zeros((I, P, L + 2, N), dtype=torch.int32, device=card)
    for li in range(L):
        acc = _residues(fq[li:li + 1], (I, P), N, gen)[:, :, 0]
        for k in range(2 * modmat.NDIG - 1):
            args = (c[k, li], q[li])
            fresh = torch.empty((I, P, N), dtype=torch.int32)
            want = modmat.bucket_fold_plain(part.cpu(), acc.cpu(), fresh,
                                            *args, rinv[li]).clone()
            bare = modmat.bucket_fold_plain(part.cpu(), None, fresh, *args,
                                            rinv[li])
            dev = [t.to(card) for t in args]
            got = modmat_cuda.bucket_fold(part, acc, torch.empty_like(acc),
                                          *dev)
            assert torch.equal(got.cpu(), want), (li, k)
            inplace = acc.clone()
            modmat_cuda.bucket_fold(part, inplace, inplace, *dev)
            assert torch.equal(inplace.cpu(), want), (li, k)
            dst = out[:, :, li + 1, :]
            modmat_cuda.bucket_fold(part, None, dst, *dev)
            assert torch.equal(dst.cpu(), bare), (li, k)
    torch.cuda.synchronize()
    assert modmat_cuda.launches["digit_split"] - n0["digit_split"] == L
    assert modmat_cuda.launches["bucket_fold"] - n0["bucket_fold"] == 21 * L
    assert modmat_cuda.shapes["digit_split"][(J, P, N)] >= L
    assert modmat_cuda.shapes["bucket_fold"][(I, P, N, False)] >= 7 * L


def test_bucket_fold_refuses_unaligned_rows(card):
    """The fold moves four residues a thread: it raises on N not a
    multiple of 4 and on a row off a 16-byte boundary, and launches
    nothing."""
    q = torch.tensor([12289], dtype=torch.int32, device=card)
    part = torch.zeros((24, 2 * 6), dtype=torch.int32, device=card)
    n0 = modmat_cuda.launches["bucket_fold"]
    with pytest.raises(ValueError):
        modmat_cuda.bucket_fold(part, None, torch.zeros(
            (2, 2, 6), dtype=torch.int32, device=card), q, q)
    flat = torch.zeros(24 * 16 + 1, dtype=torch.int32, device=card)
    part, shifted = flat[:-1].view(24, 16), flat[1:].view(24, 16)
    out = torch.zeros((2, 2, 8), dtype=torch.int32, device=card)
    with pytest.raises(ValueError):                 # part off 16 bytes
        modmat_cuda.bucket_fold(shifted, None, out, q, q)
    with pytest.raises(ValueError):                 # acc off 16 bytes
        modmat_cuda.bucket_fold(part, shifted.reshape(-1)[:32].view(
            2, 2, 8), out, q, q)
    wide = torch.zeros(2 * 2 * 3 * 8 + 1, dtype=torch.int32, device=card)
    with pytest.raises(ValueError):                 # out's limb off 16 bytes
        modmat_cuda.bucket_fold(part, None, wide[1:].view(2, 2, 3, 8)[
            :, :, 0], q, q)
    assert modmat_cuda.launches["bucket_fold"] == n0


@pytest.mark.parametrize("J,I,fill", [
    (37, 5, None), (48, 32, None), (96, 40, "q-1"), (96, 40, "0"),
    (modmat.MAX_J, 24, "q-1")])
def test_mod_matmul_on_card_equals_cpu(card, J, I, fill):
    """mod_matmul on the card (digit_split, seven GEMMs over column
    windows, bucket_fold) torch.equal to the CPU path: J off and on 16, I
    below 24 (padding rows) and above, every input and weight residue q - 1
    or 0, J = MAX_J at q - 1 (the largest bucket sums); x a limb window of
    a larger tensor, the weights a rows/cols slice and a limb window of
    larger digits and tables, as CPMM.product and the shards pass them."""
    L, P, N = 3, 2, 64
    qs = _modmat_primes(card, L + 2)
    gen = torch.Generator(card).manual_seed(J + I)
    big = _residues(qs, (J, P), N, gen)
    rng = np.random.default_rng(J + I)
    w = rng.integers(0, 1 << 62, size=(L + 2, J + 3, I + 4)) \
        % qs.cpu().numpy().astype(np.int64)[:, None, None]
    if fill is not None:
        big[:] = qs.reshape(-1, 1) - 1 if fill == "q-1" else 0
        w[:] = qs.cpu().numpy()[:, None, None] - 1 if fill == "q-1" else 0
    x = big[:, :, 1:L + 1]
    wd = torch.from_numpy(modmat.host_weight_digits(w))[:, 1:L + 1, 1:J + 1,
                                                       2:I + 2]
    tables = (torch.from_numpy(modmat.host_bucket_consts(qs.tolist())),
              qs.cpu(), torch.tensor([ma.mont_constants(int(v))["rinv"]
                                      for v in qs], dtype=torch.int32))
    tables = [t[..., 1:L + 1] for t in tables]
    n0 = modmat_cuda.launches["digit_split"]
    got = modmat.mod_matmul(x, wd.to(card), *[t.to(card) for t in tables])
    want = modmat.mod_matmul(x.cpu(), wd, *tables)
    assert got.shape == (I, P, L, N)
    assert torch.equal(got.cpu(), want)
    assert modmat_cuda.launches["digit_split"] - n0 == L


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


def test_lfm2_conv_on_card_equals_cpu(card):
    """A channel share of LFM2's conv mixer (logN 9, hidden 16, channels
    [4, 8), full-length and shorter sequences) gives the CPU's residues on
    the card: the CPMMs, the key switches, the hoisted shifts and the
    mask-and-tap products are exact."""
    dims = Lfm2ConvDims(hidden_size=16, conv_L_cache=3, channels=(4, 8),
                        num_x=32, num_row=8)
    on_card = build_lfm2_conv(logN=9, dims=dims, input_count=3, seed=7,
                              device=card)
    on_cpu = build_lfm2_conv(logN=9, dims=dims, input_count=3, seed=7,
                             device="cpu")
    got = on_card.fn(on_card.x_data)
    want = on_cpu.fn(on_cpu.x_data)
    assert got.scale == want.scale
    assert torch.equal(got.data.cpu(), want.data)


BOOT9 = CKKSConfig(logN=9, q0_bits=(30.0, 30.0), data_pair_bits=26.0,
                   n_data_levels=13, dnum=7, special_bits=29.5,
                   hamming_weight=64)


def test_a_span_holds_its_kernels_on_the_profilers_clock(card):
    """A span around an ntt_fwd call and its synchronise holds both of
    the call's device kernels in a CUDA-only profile, once the span is
    put on the epoch clock (1 ms of host sleep inside each end of the
    span: the clocks agree to better than that)."""
    import time
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from moai_tpu_torch.utils import debug
    ctx = Context(dataclasses.replace(_test_config(), logN=16), device=card)
    x = torch.zeros((4, ctx.L + ctx.K, ctx.cfg.N), dtype=torch.int32,
                    device=card)
    ntt(x, ctx.dev["ntt"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with debug.tracing() as trace:
            with debug.span("ntt"):
                time.sleep(0.001)
                ntt(x, ctx.dev["ntt"])
                torch.cuda.synchronize()
                time.sleep(0.001)
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA and "ntt_" in e.name()]
    assert len(kernels) == 2
    s = trace.spans[0]
    lo, hi = trace.epoch_ns(s.start_ns), trace.epoch_ns(s.end_ns)
    for e in kernels:
        assert lo < e.start_ns() < e.start_ns() + e.duration_ns() < hi


def test_launch_shapes_sum_to_launches(card):
    """Every kernel's launch shapes count each of its launches once over a
    bootstrap of two ciphertexts, and each kernel launched."""
    B = build_bootstrap(BOOT9, 2, seed=101, device=card)
    ntt_cuda.reset_launches()
    limb_cuda.reset_launches()
    B.fn(B.x_data)
    torch.cuda.synchronize()
    for mod in (ntt_cuda, limb_cuda):
        assert set(mod.shapes) == set(mod.launches)
        for name, n in mod.launches.items():
            assert n > 0 and sum(mod.shapes[name].values()) == n, name


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


BOOT9 = CKKSConfig(logN=9, q0_bits=(30.0, 30.0), data_pair_bits=26.0,
                   n_data_levels=13, dnum=7, special_bits=29.5,
                   hamming_weight=64)
STEP9 = CKKSConfig(logN=9, q0_bits=(30.0, 30.0), data_pair_bits=26.0,
                   n_data_levels=7, n_boot_levels=0, dnum=2, hamming_weight=64)


def _sharded_programs_equal_unsharded(devices):
    """On meshes over ``devices`` (cards, possibly repeated): the evaluator
    step on (1, 2) over limb and, given 4 devices, on (2, 2) over col and
    limb (key rows copied to the cards without the keys alone); the CCMM
    over (2, 1) and (1, 2); ShardedBootstrapper.make_refresh over (2, 1)
    and (1, 2).  Each gathered onto the first card and held torch.equal to
    the same program unsharded there; every kernel the unsharded program
    launched also launched in the sharded one."""
    home = devices[0]
    for n in (2, 4)[:len(devices) // 2]:
        st = build_sharded_step(STEP9, 4, make_mesh(n, 2, devices[:n]),
                                device=home)
        want = st.plain(st.a, st.b)
        limb_cuda.reset_launches()
        ntt_cuda.reset_launches()
        got = gather(st.fn(st.shard(st.a), st.shard(st.b)), home)
        counts = {**limb_cuda.launches, **ntt_cuda.launches}
        assert all(v > 0 for k, v in counts.items() if k != "diag_mac")
        assert got.scale == want.scale and torch.equal(got.data, want.data)
        # key rows are copied only to the cards that do not hold the keys
        assert {k[1] for k in st.sev._key_rows} == set(devices[:n]) - {home}
    mesh = make_mesh(2, 1, devices[:2])
    cc = build_sharded_ccmm(STEP9, 64, 4, 4, mesh, col_chunk=1, device=home)
    got = gather(cc.fn(cc.shard(cc.x), cc.shard(cc.w)), home)
    want = cc.plain(cc.x, cc.w)
    assert got.scale == want.scale and torch.equal(got.data, want.data)
    cc = build_sharded_ccmm(STEP9, 64, 4, 4, make_mesh(2, 2, devices[:2]),
                            col_chunk=1, device=home)
    got = gather(cc.fn(cc.shard(cc.x), cc.shard(cc.w)), home)
    assert torch.equal(got.data, want.data)
    plain = build_bootstrap(BOOT9, 2, seed=101, device=home)
    want = plain.fn(plain.x_data)
    x = Ciphertext(plain.x_data, plain.ctx.scale, True)
    for n, la in ((2, 1), (2, 2)):
        refresh = ShardedBootstrapper(
            plain.bootstrapper, make_mesh(n, la, devices[:n])).make_refresh()
        limb_cuda.reset_launches()
        got = refresh(x, plain.n_out)
        assert limb_cuda.launches["diag_mac"] > 0
        assert got.scale == want.scale and torch.equal(got.data, want.data)


def test_sharded_programs_on_a_virtual_mesh(card):
    """Four mesh positions on one card, as the JAX tests' virtual CPU
    devices time-share one host."""
    _sharded_programs_equal_unsharded([torch.device("cuda", 0)] * 4)


def test_sharded_programs_on_real_cards(card):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"a mesh of real cards needs two; this host has {n}")
    _sharded_programs_equal_unsharded(
        [torch.device("cuda", i) for i in range(min(n, 4))])


def test_sharded_head_on_a_virtual_mesh(card):
    """dryrun_multichip's head at logN 9 on a (2, 2) mesh of cuda:0, the
    input at P("col", None, "limb", None): torch.equal to the unsharded
    head on the card, launching every kernel that the unsharded head
    launches."""
    S = build_sharded_head(9, 12, 32, 8, 8, 8, 2, 2, 3,
                           make_mesh(4, 2, [card] * 4), device=card)
    limb_cuda.reset_launches()
    ntt_cuda.reset_launches()
    want = S.plain(S.head.x_data)
    plain = {**limb_cuda.launches, **ntt_cuda.launches}
    limb_cuda.reset_launches()
    ntt_cuda.reset_launches()
    got = gather(S.fn(S.head.x_data), card)
    counts = {**limb_cuda.launches, **ntt_cuda.launches}
    assert all(counts[k] > 0 for k, v in plain.items() if v > 0)
    assert got.scale == want.scale and torch.equal(got.data, want.data)
