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
against the unsharded head.

This file imports neither JAX nor moai_tpu, so it runs on a GPU host
without them (tests/conftest.py imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a card every test skips."""

import dataclasses

import numpy as np
import pytest
import torch

from moai_tpu_torch import limb_cuda, ntt_cuda, serial
from moai_tpu_torch import mod_arith as ma
from moai_tpu_torch.encoder import Encoder
from moai_tpu_torch.encrypt import Encryptor
from moai_tpu_torch.entry import (build_bootstrap, build_head, build_model,
                                  build_sharded_ccmm, build_sharded_head,
                                  build_sharded_step)
from moai_tpu_torch.keys import KeyGenerator
from moai_tpu_torch.models.bert import BertDims, DepthPlan
from moai_tpu_torch.ntt import ntt, intt, ntt_plain, intt_plain
from moai_tpu_torch.params import CKKSConfig, Context, \
    test_config as _test_config
from moai_tpu_torch.parallel.sharding import gather, make_mesh
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
    ]
    for i, call in enumerate(calls):
        with pytest.raises(TypeError):
            call()


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


BOOT9 = CKKSConfig(logN=9, q0_bits=(30.0, 30.0), data_pair_bits=26.0,
                   n_data_levels=13, dnum=7, special_bits=29.5,
                   hamming_weight=64)
STEP9 = CKKSConfig(logN=9, q0_bits=(30.0, 30.0), data_pair_bits=26.0,
                   n_data_levels=7, n_boot_levels=0, dnum=2, hamming_weight=64)


def _sharded_programs_equal_unsharded(devices):
    """On meshes over ``devices`` (cards, possibly repeated): the evaluator
    step on (1, 2) over limb and, given 4 devices, on (2, 2) over col and
    limb (key rows copied to the cards without the keys alone); the CCMM
    over (2, 1) and (1, 2); make_refresh over (2, 1) and (1, 2).  Each
    gathered onto the first card and held torch.equal to the same program
    unsharded there; every kernel the unsharded program launched also
    launched in the sharded one."""
    home = devices[0]
    for n in (2, 4)[:len(devices) // 2]:
        st = build_sharded_step(STEP9, 4, make_mesh(n, 2, devices[:n]),
                                "limb", device=home)
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
                            mode="limb", col_chunk=1, device=home)
    got = gather(cc.fn(cc.shard(cc.x), cc.shard(cc.w)), home)
    assert torch.equal(got.data, want.data)
    plain = build_bootstrap(BOOT9, 2, seed=101, device=home)
    want = plain.fn(plain.x_data)
    for n, la in ((2, 1), (2, 2)):
        sharded = build_bootstrap(BOOT9, 2, seed=101, device=home,
                                  mesh=make_mesh(n, la, devices[:n]))
        limb_cuda.reset_launches()
        got = sharded.fn(sharded.x_data)
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
                           make_mesh(4, 2, [card] * 4), "limb", device=card)
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
