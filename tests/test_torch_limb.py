"""The limb-arithmetic kernels' algorithms (csrc/limb.cu) in numpy, against
their plain versions (moai_tpu_torch/mod_arith.py).

The kernels run only on a CUDA card (tests/test_torch_cuda.py holds them
torch.equal to the plain versions there).  Here each kernel's exact
algorithm is modelled in numpy, step for step: -q^-1 mod 2^32 by Newton
from q, REDC with R = 2^32, the fast paths and the remainder branch of the
elementwise ops, groups of four products per REDC in the MACs (asserting
that every group sum stays below q * 2^32, REDC's input range), the
canonical 32-bit sums.  The models must equal the plain versions on every
prime of flagship_config and head_config(15, 13), at their largest digit
count, digit size and special-prime count, on edge values (0, 1, q - 1,
inputs >= q where the call sites pass them) and on the operands past the
residues' range that only the remainder branch sees.  The launch layout of
the elementwise kernel (collapsed broadcast dims, strides, rows) is
replayed on each broadcast pattern of the call sites, and CPU tensors are
shown to take the plain versions.  No JAX."""

import numpy as np
import pytest
import torch

from moai_tpu_torch import limb_cuda
from moai_tpu_torch import mod_arith as ma
from moai_tpu_torch.params import Context, flagship_config, head_config

torch.set_num_threads(1)

U64, I64, U32 = np.uint64, np.int64, np.uint32
TWO32, TWO63 = 1 << 32, 1 << 63
N = 16


@pytest.fixture(scope="module", params=["flagship", "head15"])
def ctx(request):
    cfg = flagship_config() if request.param == "flagship" else \
        head_config(15, 13)
    return Context(cfg, device="cpu")


# ---------------------------------------------------------------------------
# numpy models of the device functions (uint64 lanes wrap as the card's)
# ---------------------------------------------------------------------------

def neg_qinv(q):
    q = np.asarray(q, U64).astype(U32)
    x = q.copy()
    with np.errstate(over="ignore"):
        for _ in range(4):
            x = x * (U32(2) - q * x)
        return (U32(0) - x).astype(U64)


def redc(T, q):
    """(T + m q) / 2^32, m = T * (-q^-1) mod 2^32: T < 2^63, q < 2^31."""
    T, q = np.asarray(T, U64), np.asarray(q, U64)
    assert (T < U64(TWO63)).all()
    m = ((T & U64(TWO32 - 1)) * neg_qinv(q)) & U64(TWO32 - 1)
    return (T + m * q) >> U64(32)


def floor_mod(x, q):
    return np.remainder(np.asarray(x, I64), np.asarray(q, I64))


def reduce(s, q):
    q = np.asarray(q, I64)
    s = np.where(s >= q, s - q, np.where(s < 0, s + q, s))
    return np.where((s >= 0) & (s < q), s, floor_mod(s, q))


def k_mont_mul(a, b, q):
    ua, ub = np.asarray(a, I64).view(U64), np.asarray(b, I64).view(U64)
    q = np.asarray(q, U64)
    T = ua * ub
    fast = ((ua | ub) < U64(TWO32)) & (T < U64(TWO63))
    t = redc(np.where(fast, T, U64(0)), q)
    t = np.where(t >= q, t - q, t)
    t = np.where(t < q, t, t % q)
    slow = redc(floor_mod(T.view(I64), q).astype(U64), q)
    slow = np.where(slow >= q, slow - q, slow)
    return np.where(fast, t, slow).astype(I64)


def k_from_mont(x, q):
    ux, q = np.asarray(x, I64).view(U64), np.asarray(q, U64)
    fast = ux < U64(TWO32)
    t = redc(np.where(fast, ux, U64(0)), q)
    t = np.where(t >= q, t - q, t)
    rinv = (q * neg_qinv(q) + U64(1)) >> U64(32)
    slow = floor_mod((ux * rinv).view(I64), q.astype(I64))
    return np.where(fast, t.astype(I64), slow)


def k_ew(op, a, b, c, q):
    a, b, c = (np.asarray(v, I64) for v in (a, b, c))
    wrap = lambda u: u.view(I64)
    ua, ub = a.view(U64), b.view(U64)
    if op == "add":
        return reduce(wrap(ua + ub), q)
    if op == "sub":
        return reduce(wrap(ua - ub), q)
    if op == "neg":
        return reduce(wrap(U64(0) - ua), q)
    if op == "mul":
        return k_mont_mul(a, b, q)
    if op == "from_mont":
        return k_from_mont(a, q)
    return k_mont_mul(reduce(wrap(ua - ub), q), c, q)      # sub_mul


def group_sum(lam, hat, q):
    """The MACs' canonical sum of REDC'd groups of four products."""
    q = np.asarray(q, U64)
    acc = np.zeros(np.broadcast_shapes(lam[0].shape, q.shape), U64)
    for i in range(0, len(lam), 4):
        T = sum(np.asarray(lam[j], U64) * np.asarray(hat[j], U64)
                for j in range(i, min(i + 4, len(lam))))
        assert (T < q * U64(TWO32)).all(), "a group sum passes REDC's range"
        r = redc(T, q)
        r = np.where(r >= q, r - q, r)
        acc = acc + r
        acc = np.where(acc >= q, acc - q, acc)
    return acc


def k_base_conv(x, src_q, hatinv, hat, tq, k=None, kq=None):
    x = np.asarray(x, I64)
    S = x.shape[-2]
    D, A, T = hat.shape
    out = np.zeros(x.shape[:-2] + (D, T, x.shape[-1]), I64)
    for d in range(D):
        lo, cnt = d * A, min(A, S - d * A)
        lam = []
        for i in range(cnt):
            v = x[..., lo + i, :]
            if hatinv is not None:
                qi = src_q[lo + i]
                v = k_from_mont(k_mont_mul(v, hatinv[lo + i], qi), qi)
            lam.append(v.astype(U32).astype(U64))
        for t in range(T):
            acc = group_sum(lam, [hat[d, j, t] for j in range(cnt)], tq[t])
            if k is not None:
                kt = k_mont_mul(k, kq[t], tq[t]).astype(U64)
                acc = np.where(acc >= kt, acc - kt, acc + U64(tq[t]) - kt)
            out[..., d, t, :] = acc.astype(I64)
    return out


def k_ks_mac(y, keys, q_limbs, tq, perm=None):
    y = np.asarray(y, I64)
    D, T, n = y.shape[-3:]
    keys = [keys] if perm is None else keys
    KL = keys[0].shape[-2]
    n_q = T - (KL - q_limbs)
    outs = [np.zeros((len(keys),) + y.shape[:-3] + (T, n), I64)
            for _ in range(2)]
    for r, key in enumerate(keys):
        src = np.arange(n) if perm is None else perm[r]
        for t in range(T):
            kl = t if t < n_q else t + q_limbs - n_q
            ys = [y[..., d, t, src].astype(U64) for d in range(D)]
            for p in range(2):
                outs[p][r, ..., t, :] = group_sum(
                    ys, [key[d, p, kl].astype(I64) for d in range(D)], tq[t])
    if perm is None:
        return outs[0][0], outs[1][0]
    return outs[0], outs[1]


def k_diag_mac(cts, pts, q):
    L = pts.shape[1]
    out = np.zeros(cts[0].shape, I64)
    for l in range(L):
        out[..., l, :] = group_sum([ct[..., l, :] for ct in cts],
                                   [pt[l] for pt in pts], q[l])
    return out


def residues(qs, lead, rng, edges=True):
    """Canonical residues [*lead, len(qs), N] with 0, 1, q-1, q-2 (and
    q-1 over a whole row) among them."""
    qs = np.asarray(qs, I64).reshape(-1, 1)
    x = rng.integers(0, qs, size=lead + (len(qs), N))
    if edges:
        x[..., :4] = np.concatenate([np.zeros_like(qs), np.ones_like(qs),
                                     qs - 1, qs - 2], axis=1)
        x.reshape(-1, len(qs), N)[0, :, 4:] = qs - 1
    return x


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def test_newton_inverse_and_redc_every_prime(ctx):
    """-q^-1 mod 2^32 from four Newton steps, and R^-1 mod q from it, for
    every prime of the chain; REDC within q of T / 2^32 at its range."""
    for q in ctx.all_primes:
        c = ma.mont_constants(q)
        assert int(neg_qinv(q)) == c["qneg_inv"]
        assert (q * int(neg_qinv(q)) + 1) >> 32 == c["rinv"]
        for T_ in (0, 1, q - 1, q * TWO32 - 1, (q - 1) ** 2 * 4, TWO63 - 1):
            t = int(redc(T_, q))
            assert t % q == T_ * c["rinv"] % q and t < T_ // TWO32 + q
    qmax = max(ctx.all_primes)
    assert qmax < 1 << 30 and 4 * (qmax - 1) ** 2 < qmax * TWO32


def test_elementwise_model_equals_plain():
    """Every op of limb_ew on canonical residues, the edges, to_mont's
    inputs >= q, negative differences, and operands past the residues'
    range (the remainder branch), on primes of both chains."""
    rng = np.random.default_rng(7)
    qs = sorted({*Context(head_config(15, 13), device="cpu").all_primes[::7],
                 (1 << 30) - 35, 12289})
    qs = [q for q in qs if q % 2]
    extra = [0, 1, TWO32 - 1, TWO32, TWO32 + 5, 1 << 40, TWO63 - 1, -1, -7,
             -(1 << 40), -TWO63, 3 << 61]
    for q in qs:
        c = ma.mont_constants(q)
        edge = np.array([0, 1, q - 1, q, q + 1, 2 * q - 1, (1 << 30) - 1]
                        + extra, I64)
        rnd = rng.integers(0, q, 64)
        big = rng.integers(-(1 << 62), 1 << 62, 64)
        a = np.concatenate([np.repeat(edge, len(edge)), rnd, big, rnd])
        b = np.concatenate([np.tile(edge, len(edge)), rng.integers(0, q, 64),
                            rng.integers(0, q, 64),
                            rng.integers(0, TWO32, 64)])
        cc = rng.integers(0, q, len(a))
        ta, tb, tc = T(a), T(b), T(cc)
        plain = {"add": ma.add_mod_plain(ta, tb, q),
                 "sub": ma.sub_mod_plain(ta, tb, q),
                 "neg": ma.neg_mod_plain(ta, q),
                 "mul": ma.mont_mul_plain(ta, tb, q, c["rinv"]),
                 "from_mont": ma.from_mont_plain(ta, q, c["rinv"]),
                 "sub_mul": ma.sub_mont_mul_plain(ta, tb, tc, q, c["rinv"])}
        for op, want in plain.items():
            got = k_ew(op, a, b, cc, q)
            assert np.array_equal(got, want.numpy()), (op, q)
        # to_mont at the rescale's inputs: u < q_ell for a smaller q_j
        u = np.concatenate([rng.integers(0, 1 << 30, 64),
                            [(1 << 30) - 1, TWO32 - 1]])
        want = ma.mont_mul_plain(T(u), c["r2"], q, c["rinv"]).numpy()
        assert np.array_equal(k_mont_mul(u, c["r2"], q), want)


def test_conversions_and_macs_equal_plain(ctx):
    """base_conv at the key-switch decomposition (every digit at the top
    level, a partial last digit), the mod-down (K limbs) and ModRaise (with
    k); ks_mac with int64 and int32 keys, with and without the hoisted
    rotations' permutation, over every active digit; diag_mac over a giant
    step of diagonals.  Group sums are checked against REDC's range."""
    rng = np.random.default_rng(11)
    dv, L, K = ctx.dev, ctx.L, ctx.K
    qall = np.array(ctx.all_primes, I64)
    for n_q in (L, L - ctx.alpha // 2 - 1):
        D = sum(1 for lo, _ in ctx.digit_ranges if lo < n_q)
        tq = np.concatenate([qall[:n_q], qall[L:]])
        trinv = torch.cat([dv["rinv"][:n_q], dv["rinv"][L:]])
        hat = dv["ks_hat_mm"][n_q, :D]
        hat_t = torch.cat([hat[..., :n_q], hat[..., L:]], dim=-1)
        x = residues(qall[:n_q], (2,), rng)
        want = ma.base_conv_plain(T(x), dv["ks_q_pad"], dv["ks_rinv_pad"],
                                  dv["ks_hatinv_mont"][n_q, :D], hat_t,
                                  T(tq), trinv)
        got = k_base_conv(x, dv["ks_q_pad"].numpy(),
                          dv["ks_hatinv_mont"][n_q, :D].reshape(-1).numpy(),
                          hat_t.numpy(), tq)
        assert np.array_equal(got, want.numpy()), ("decompose", n_q)

        y = residues(tq, (2, D), rng)
        for dtype in (torch.int64, torch.int32):
            keys = [T(residues(qall, (ctx.dnum, 2), rng)).to(dtype)
                    for _ in range(3)]
            w0, w1 = ma.ks_mac_plain(T(y), keys[0], L, T(tq), trinv)
            g0, g1 = k_ks_mac(y, keys[0].numpy(), L, tq)
            assert np.array_equal(g0, w0.numpy())
            assert np.array_equal(g1, w1.numpy())
            perm = np.stack([rng.permutation(N) for _ in keys])
            w0, w1 = ma.ks_mac_plain(T(y), keys, L, T(tq), trinv, T(perm))
            g0, g1 = k_ks_mac(y, [k.numpy() for k in keys], L, tq, perm)
            assert np.array_equal(g0, w0.numpy())
            assert np.array_equal(g1, w1.numpy())

    # the mod-down: K special limbs to the n_q limbs of Q
    n_q = L - 3
    cp = residues(qall[L:], (2, 2), rng)
    hat = dv["pdown_hat_modq_mm"][None, :, :n_q]
    want = ma.base_conv_plain(T(cp), dv["q"][L:], dv["rinv"][L:],
                              dv["pdown_hatinv_mont"], hat, dv["q"][:n_q],
                              dv["rinv"][:n_q])
    got = k_base_conv(cp, qall[L:], dv["pdown_hatinv_mont"].numpy(),
                      hat.numpy(), qall[:n_q])
    assert np.array_equal(got, want.numpy()), "mod-down"

    # ModRaise: lam over the n_q0 bottom limbs to all L, less k * q0
    n0 = ctx.n_q0
    lam = residues(qall[:n0], (2,), rng)
    k = rng.integers(0, n0 + 1, (2, N))
    k[0, :3] = [0, n0, -1]
    hat = torch.from_numpy(rng.integers(0, qall[:L], (1, n0, L)))
    kq = torch.from_numpy(rng.integers(0, qall[:L]))
    want = ma.base_conv_plain(T(lam), None, None, None, hat, dv["q"][:L],
                              dv["rinv"][:L], T(k), kq)
    got = k_base_conv(lam, None, None, hat.numpy(), qall[:L], k, kq.numpy())
    assert np.array_equal(got, want.numpy()), "ModRaise"

    # one giant step of diagonals over two ciphertexts' polynomials
    n_q = L - 5
    q = dv["q"][:n_q].reshape(-1, 1)
    cts = [residues(qall[:n_q], (2, 2), rng) for _ in range(9)]
    pts = residues(qall[:n_q], (9,), rng)
    want = ma.diag_mac_plain([T(c) for c in cts], T(pts), q,
                             dv["rinv"][:n_q].reshape(-1, 1))
    assert np.array_equal(k_diag_mac(cts, pts, qall[:n_q]), want.numpy())


def _replay_layout(op, ops):
    """limb_ew's launch as the kernel walks it (rows split over the outer
    collapsed dims, each row's inner elements at the inner strides), in
    numpy, from ew_layout's sizes and strides."""
    shape, sizes, st, rows = limb_cuda.ew_layout(ops)
    flat = []
    for t in ops:
        if isinstance(t, torch.Tensor):
            span = 1 + sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
            flat.append(t.as_strided((span,), (1,)).numpy())
        else:
            flat.append(None)
    inner = sizes[-1]
    out = np.empty(shape.numel(), I64)
    j = np.arange(inner)
    for row in range(rows):
        base, r = [0] * 4, row
        for d in range(len(sizes) - 2, -1, -1):
            i, r = r % sizes[d], r // sizes[d]
            base = [b + i * s[d] for b, s in zip(base, st)]
        vals = [np.full(inner, int(t or 0), I64) if f is None else
                f[b + j * s[-1]] for t, f, b, s in zip(ops, flat, base, st)]
        out[row * inner:(row + 1) * inner] = k_ew(op, *vals)
    return out.reshape(tuple(shape))


def test_elementwise_layout_replayed_on_call_site_patterns():
    """The broadcast patterns the call sites pass: per-limb [n, 1]
    constants, per-column [C, 1, n, 1] constants, a diagonal broadcast over
    the polynomials, a limb slice of a larger tensor (the mod-down's u_q),
    a Python-int modulus and operand (the rescale's last limb)."""
    rng = np.random.default_rng(5)
    ctx = Context(head_config(15, 13), device="cpu")
    dv = ctx.dev
    q5, r5 = dv["q"][:5].reshape(-1, 1), dv["rinv"][:5].reshape(-1, 1)
    qs = dv["q"][:5].numpy()

    def res(lead):
        return T(residues(qs, lead, rng, edges=False))
    u7 = T(residues(dv["q"][:7].numpy(), (3,), rng, edges=False))
    qe = int(dv["q"][7])
    cases = [
        ("mul", res((2, 3)), q5 * 0 + 7, None, q5),
        ("add", res((4, 2)), res((4, 1))[..., :1], None, q5),
        ("mul", res((4, 2)), torch.from_numpy(
            rng.integers(0, qs.reshape(-1, 1), (4, 1, 5, 1))), None, q5),
        ("mul", res((2, 2)), res(())[None], None, q5),
        ("sub_mul", u7[..., :5, :], res((3,)),
         dv["pdown_pinv_mont"][:5].reshape(-1, 1), q5),
        ("add", T(rng.integers(0, qe, (3, 1, N))), qe >> 1, None, qe),
        ("from_mont", u7[:, 6:7, :], None, None, qe),
        ("neg", res((3,)).transpose(-1, -2), None, None, q5.reshape(1, -1)),
    ]
    for op, a, b, c, q in cases:
        want = {"add": lambda: ma.add_mod_plain(a, b, q),
                "neg": lambda: ma.neg_mod_plain(a, q),
                "mul": lambda: ma.mont_mul_plain(a, b, q, r5),
                "from_mont": lambda: ma.from_mont_plain(
                    a, q, ma.mont_constants(q)["rinv"]),
                "sub_mul": lambda: ma.sub_mont_mul_plain(a, b, c, q, r5)}[op]()
        got = _replay_layout(op, (a, b, c, q))
        assert got.shape == tuple(want.shape), op
        assert np.array_equal(got, want.numpy()), op
    # eight dims that no two operands step through alike do not collapse
    wide = torch.zeros((2,) * 8, dtype=torch.int64)
    with pytest.raises(ValueError, match="dims"):
        limb_cuda.ew_layout((wide, wide.permute(*range(7, -1, -1)), None, 3))


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """On CPU tensors every dispatcher of mod_arith returns its plain
    version's result and no kernel wrapper is reached; each wrapper refuses
    a CPU tensor instead of computing it."""
    ctx = Context(head_config(15, 13), device="cpu")
    dv, L = ctx.dev, ctx.L
    rng = np.random.default_rng(2)
    q, rinv = dv["q"][:L].reshape(-1, 1), dv["rinv"][:L].reshape(-1, 1)
    x, z = (T(residues(dv["q"][:L].numpy(), (2,), rng)) for _ in range(2))
    before = dict(limb_cuda.launches)
    for name in ("limb_ew", "base_conv", "ks_mac", "diag_mac"):
        with pytest.raises(ValueError, match="CUDA"):
            {"limb_ew": lambda: limb_cuda.limb_ew("add", x, z, None, q),
             "base_conv": lambda: limb_cuda.base_conv(
                 x, dv["q"], None, dv["ks_hat_mm"][L, :1, :2], q),
             "ks_mac": lambda: limb_cuda.ks_mac(x[None], x[None, None], L, q),
             "diag_mac": lambda: limb_cuda.diag_mac([x], x[:1], q)}[name]()

        def refuse(*a, **k):
            raise AssertionError("a CPU tensor reached a kernel wrapper")
        monkeypatch.setattr(limb_cuda, name, refuse)
    assert torch.equal(ma.add_mod(x, z, q), ma.add_mod_plain(x, z, q))
    assert torch.equal(ma.sub_mod(x, z, q), ma.sub_mod_plain(x, z, q))
    assert torch.equal(ma.neg_mod(x, q), ma.neg_mod_plain(x, q))
    assert torch.equal(ma.mont_mul(x, z, q, rinv),
                       ma.mont_mul_plain(x, z, q, rinv))
    assert torch.equal(ma.to_mont(x, q, rinv, dv["r2"][:L].reshape(-1, 1)),
                       ma.mont_mul_plain(x, dv["r2"][:L].reshape(-1, 1), q,
                                         rinv))
    assert torch.equal(ma.from_mont(x, q, rinv),
                       ma.from_mont_plain(x, q, rinv))
    assert torch.equal(ma.sub_mont_mul(x, z, x, q, rinv),
                       ma.sub_mont_mul_plain(x, z, x, q, rinv))
    hat = dv["pdown_hat_modq_mm"][None, :, :L]
    cp = T(residues(dv["q"][L:].numpy(), (2,), rng))
    args = (cp, dv["q"][L:], dv["rinv"][L:], dv["pdown_hatinv_mont"], hat,
            q, rinv)
    assert torch.equal(ma.base_conv(*args), ma.base_conv_plain(*args))
    key = T(residues(dv["q"].numpy(), (ctx.dnum, 2), rng))
    y = T(residues(np.concatenate([dv["q"][:L].numpy(),
                                   dv["q"][L:].numpy()]), (2, ctx.dnum), rng))
    qt = torch.cat([dv["q"][:L], dv["q"][L:]]).reshape(-1, 1)
    rt = torch.cat([dv["rinv"][:L], dv["rinv"][L:]]).reshape(-1, 1)
    for a, b in zip(ma.ks_mac(y, key, L, qt, rt),
                    ma.ks_mac_plain(y, key, L, qt, rt)):
        assert torch.equal(a, b)
    cts = [x[None].expand(2, 2, L, N).contiguous() for _ in range(3)]
    pts = x[:1].expand(3, L, N).contiguous()
    assert torch.equal(ma.diag_mac(cts, pts, q, rinv),
                       ma.diag_mac_plain(cts, pts, q, rinv))
    assert limb_cuda.launches == before
