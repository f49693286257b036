"""The limb-arithmetic kernels' algorithms (csrc/limb.cu) in numpy, against
their plain versions (moai_tpu_torch/mod_arith.py).

The kernels run only on a CUDA card (tests/test_torch_cuda.py holds them
torch.equal to the plain versions there).  Here each kernel's exact
algorithm is modelled in numpy, step for step, on its int32 lanes (values
in [0, 2^31)): -q^-1 mod 2^32 by Newton from q, REDC with R = 2^32, the
elementwise ops' 32-bit arithmetic and the remainder branch past [0, 2q),
groups of four products per REDC in ks_mac and diag_mac (asserting that
every group sum stays below q * 2^32, REDC's input range), base_conv's
register tiles, lazy 64-bit sums of up to 16 products (asserted not to
wrap) and two-step REDC, each kernel's flat index maps and compile-time
buckets (diag_mac's coefficients per thread by term count), the canonical
32-bit sums.  The models must equal the plain versions on every prime of
flagship_config and head_config(15, 13), at their largest digit count,
digit size and special-prime count, on edge values (0, 1, q - 1, inputs
in [q, 2^31) where the domain takes them).  The launch layout of the
elementwise kernel (collapsed broadcast dims, strides, rows, the vector
and scalar paths, a modulus per row or per element) is replayed on each
broadcast pattern of the call sites, and CPU tensors are shown to take the
plain versions.  No JAX."""

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


TWO31 = 1 << 31


def lanes(x):
    """int32 lanes' values as uint64, asserting the kernels' domain."""
    x = np.asarray(x, I64)
    assert ((x >= 0) & (x < TWO31)).all(), "outside [0, 2^31)"
    return x.astype(U64)


def reduce(t, q):
    """limb.cu's reduce: t mod q for t < 2^32, one subtract below 2q, else
    the remainder."""
    t, q = np.asarray(t, U64), np.asarray(q, U64)
    assert (t < U64(TWO32)).all()
    t = np.where(t >= q, t - q, t)
    return np.where(t < q, t, t % q)


def k_sub(x, y, q):
    """limb.cu's sub_mod on uint32: d = x - y mod 2^32, plus q where
    negative, the floored remainder where still outside [0, q)."""
    x, y, q = lanes(x), lanes(y), np.asarray(q, U64)
    d = (x - y) & U64(TWO32 - 1)
    d = np.where(d >= U64(TWO31), (d + q) & U64(TWO32 - 1), d)
    slow = np.remainder(x.astype(I64) - y.astype(I64), q.astype(I64))
    return np.where(d < q, d, slow.astype(U64))


def k_mont_mul(a, b, q):
    """One 32x32 -> 64 product and one REDC (below 2^30 + q), then
    reduce."""
    q = np.asarray(q, U64)
    t = redc(lanes(a) * lanes(b), q)
    assert (t < U64(TWO31)).all()
    return reduce(t, q).astype(I64)


def k_from_mont(x, q):
    q = np.asarray(q, U64)
    t = redc(lanes(x), q)
    assert (t <= q).all()
    return reduce(t, q).astype(I64)


def k_ew(op, a, b, c, q):
    if op == "add":
        return reduce(lanes(a) + lanes(b), q).astype(I64)
    if op == "sub":
        return k_sub(a, b, q).astype(I64)
    if op == "neg":
        return k_sub(np.zeros_like(np.asarray(a)), a, q).astype(I64)
    if op == "mul":
        return k_mont_mul(a, b, q)
    if op == "from_mont":
        return k_from_mont(a, q)
    return k_mont_mul(k_sub(a, b, q), c, q)                # sub_mul


def group_sum(lam, hat, q):
    """ks_mac's and diag_mac's canonical sum of REDC'd groups of four
    products."""
    q = np.asarray(q, U64)
    acc = np.zeros(np.broadcast_shapes(lam[0].shape, q.shape), U64)
    for i in range(0, len(lam), 4):
        T = sum(np.asarray(lam[j], U64) * np.asarray(hat[j], U64)
                for j in range(i, min(i + 4, len(lam))))
        assert (T < q * U64(TWO32)).all(), "a group sum passes REDC's range"
        acc = add_canon(acc, redc_canon(T, q), q)
    return acc


def redc_canon(T, q):
    r = redc(T, q)
    return np.where(r >= q, r - q, r)


def add_canon(acc, t, q):
    s = acc + t
    return np.where(s >= q, s - q, s)


def redc2_canon(S, q):
    """base_conv's reduction: S * 2^-64 mod q for any S < 2^64, two REDC
    steps (the first on all 64 bits of S), at most q before the subtract."""
    S, q = np.asarray(S, U64), np.asarray(q, U64)
    lo = U64(TWO32 - 1)
    qn = neg_qinv(q)
    m1 = ((S & lo) * qn) & lo
    s1 = (S >> U64(32)) + ((m1 * q + (S & lo)) >> U64(32))
    assert (s1 <= U64(TWO32 - 1) + q).all()
    m2 = ((s1 & lo) * qn) & lo
    s2 = (s1 + m2 * q) >> U64(32)
    assert (s2 <= q).all()
    return np.where(s2 >= q, s2 - q, s2)


def lazy_add(S, p):
    """S + p in uint64, asserting that the sum does not wrap (p < 2^64)."""
    out = S + p
    assert (out >= S).all(), "a lazy 64-bit sum passes 2^64"
    return out


CONV_THREADS, CONV_TILE, LAZY = 128, 4, 16
MAC_THREADS = 256


def conv_bucket(A):
    """base_conv's compile-time bound on a digit's inputs (the launcher's
    dispatch)."""
    return 16 if A <= 16 else 32


def mac_bucket(D):
    return next(c for c in (2, 4, 8, 16) if D <= c)


def to_lam(v, q, hatinv):
    """base_conv's input conversion, from_mont(mont_mul(v, hatinv)): one
    REDC of v * (hatinv * 2^-32 mod q), below 2q for any v in [0, 2^31),
    made canonical; hatinv * 2^-32 mod q is one REDC of hatinv, made
    canonical, per block."""
    hp = k_from_mont(hatinv, q).astype(U64)
    T = lanes(v) * hp
    assert (T < U64(q) * U64(TWO32)).all()
    return redc_canon(T, U64(q)).astype(I64)


def k_mont_mul_k(k, w, q):
    """base_conv's ModRaise term: any int32 k (a negative one taken as
    k % q + q, C's truncated remainder) times w, one REDC."""
    k = np.asarray(k, I64)
    u = np.where(k >= 0, k, np.fmod(k, q) + q)
    return k_mont_mul(u, w, q)


def k_base_conv(x, src_q, hatinv, hat, tq, k=None, kq=None):
    """The base_conv kernel step for step on flat arrays: the block's
    tables (q padded with 1 to a multiple of the tile, -q^-1, 2^64 mod q,
    hat * 2^32 mod q per digit), each thread's coefficient pair
    n = 2 (blockIdx.x * 128 + threadIdx.x) with its lam in registers, the
    targets in tiles of four, lazy 64-bit sums of up to 16 products, two
    REDC steps per sum, the k term, and the flat output index; the inputs'
    conversion as to_lam."""
    x = np.asarray(x, I64)
    S, Nn = x.shape[-2:]
    D, A, T = hat.shape
    assert Nn % 2 == 0
    B = x.size // (S * Nn)
    xf = x.reshape(-1)
    kf = None if k is None else np.asarray(k, I64).reshape(-1)
    out = np.full(B * D * T * Nn, -1, I64)
    MAXC = conv_bucket(A)
    Tp = -(-T // CONV_TILE) * CONV_TILE
    s_q = np.ones(Tp, U64)
    s_q[:T] = np.asarray(tq, I64)[:T]
    with np.errstate(over="ignore"):
        r1 = (U32(0) - s_q.astype(U32)) % s_q.astype(U32)
    s_r2 = r1.astype(U64) * r1 % s_q
    s_kq = np.zeros(Tp, U64)
    if k is not None:
        s_kq[:T] = np.asarray(kq, I64).reshape(-1)[:T].astype(U32)
    n = 2 * np.arange(-(-Nn // (2 * CONV_THREADS)) * CONV_THREADS)
    n = n[n < Nn]                                  # the threads that work
    for bd in range(B * D):
        d, b = bd % D, bd // D
        lo, cnt = d * A, min(A, S - d * A)
        s_hat = np.zeros((cnt, Tp), U64)
        for ai in range(cnt):
            h = np.asarray(hat[d, ai], I64).astype(U32).astype(U64)
            s_hat[ai, :T] = redc_canon(h * s_r2[:T], s_q[:T])
        lam = []
        for i in range(cnt):
            v = np.stack([xf[(b * S + lo + i) * Nn + n + c] for c in (0, 1)])
            if hatinv is not None:
                v = to_lam(v, int(src_q[lo + i]), int(hatinv[lo + i]))
            lam.append(v.astype(U32).astype(U64))          # [2, pairs]
        kv = None if k is None else np.stack(
            [kf[b * Nn + n + c] for c in (0, 1)])
        for t0 in range(0, T, CONV_TILE):
            qs = s_q[t0:t0 + CONV_TILE]
            res = None
            for g0 in range(0, MAXC, LAZY):
                if g0 >= cnt:
                    continue
                Ssum = np.zeros((CONV_TILE, 2, len(n)), U64)
                for i in range(g0, min(g0 + LAZY, MAXC)):
                    if i < cnt:
                        h = s_hat[i, t0:t0 + CONV_TILE]
                        Ssum = lazy_add(Ssum, lam[i][None] * h[:, None, None])
                r = redc2_canon(Ssum, qs[:, None, None])
                res = r if g0 == 0 else add_canon(res, r, qs[:, None, None])
            for j in range(CONV_TILE):
                t = t0 + j
                if t >= T:
                    continue
                r = res[j]
                if k is not None:
                    q = int(qs[j])
                    kt = k_mont_mul_k(kv, int(s_kq[t]), q).astype(U64)
                    r = np.where(r >= kt, r - kt, r + U64(q) - kt)
                for c in (0, 1):
                    out[(bd * T + t) * Nn + n + c] = r[c].astype(I64)
    assert (out >= 0).all(), "an output was not written"
    return out.reshape(x.shape[:-2] + (D, T, Nn))


def k_ks_mac(y, keys, q_limbs, tq, perm=None, window=None):
    """The ks_mac kernel step for step on flat arrays: the grid's rows
    rt over (t, r), r fastest, each thread's coefficient n = blockIdx.x *
    256 + threadIdx.x, its key values and perm[r, n] loaded once, the loop
    over the B rows of y, groups of four digits per REDC, and the flat
    output index of [2, R, B, T, N].  With window (s, rows) each key is a
    whole contiguous key of which the launch reads rows [s, s + rows): the
    planes as far apart as the whole key's rows, the pointer at row s."""
    y = np.asarray(y, I64)
    D, T, Nn = y.shape[-3:]
    B = y.size // (D * T * Nn)
    keys = [keys] if perm is None else keys
    R, KL = len(keys), keys[0].shape[-2]
    row0, rows = (0, KL) if window is None else window
    n_q = T - (rows - q_limbs)
    split, kgap = n_q, q_limbs - n_q
    MAXD = mac_bucket(D)
    yf = y.reshape(-1)
    out = np.full(2 * R * B * T * Nn, -1, I64)
    plane, dstep = KL * Nn, T * Nn
    ystep, half = D * dstep, R * B * dstep
    n = np.arange(-(-Nn // MAC_THREADS) * MAC_THREADS)
    n = n[n < Nn]
    for rt in range(R * T):
        t, r = rt // R, rt % R
        q = int(tq[t])
        src = n if perm is None else np.asarray(perm).reshape(-1)[r * Nn + n]
        kl = t if t < split else t + kgap
        kf = np.asarray(keys[r]).reshape(-1)[row0 * Nn:]
        k0 = [kf[2 * d * plane + kl * Nn + n].astype(U32).astype(U64)
              for d in range(D)]
        k1 = [kf[(2 * d + 1) * plane + kl * Nn + n].astype(U32).astype(U64)
              for d in range(D)]
        for b in range(B):
            yv = [yf[b * ystep + d * dstep + t * Nn + src].astype(U32)
                  .astype(U64) for d in range(D)]
            acc = []
            for kk in (k0, k1):
                a = np.zeros(len(n), U64)
                for d0 in range(0, MAXD, 4):
                    if d0 < D:
                        Tg = sum(yv[d] * kk[d] for d in range(d0, min(
                            d0 + 4, MAXD)) if d < D)
                        assert (Tg < U64(q) * U64(TWO32)).all()
                        a = add_canon(a, redc_canon(Tg, U64(q)), U64(q))
                acc.append(a)
            o = (r * B * T + t) * Nn + n + b * dstep
            out[o] = acc[0].astype(I64)
            out[half + o] = acc[1].astype(I64)
    assert (out >= 0).all(), "an output was not written"
    out = out.reshape((2, R) + y.shape[:-3] + (T, Nn))
    if perm is None:
        return out[0, 0], out[1, 0]
    return out[0], out[1]


DIAG_THREADS = 128


def diag_lanes(terms):
    """diag_mac's coefficients per thread for a launch's term count (the
    launcher's compile-time buckets of 8, 16 and 32 terms)."""
    return 4 if terms <= 8 else 2 if terms <= 16 else 1


def k_diag_mac(cts, pts, q):
    """The diag_mac kernel on flat arrays: block rows over the limbs, each
    thread's V coefficients n = V (blockIdx.x * 128 + threadIdx.x) of
    every diagonal loaded once, the walk over the B rows, groups of four
    terms per REDC, and the flat output index."""
    J, L, Nn = pts.shape
    V = diag_lanes(J)
    assert Nn % 4 == 0
    B = cts[0].size // (L * Nn)
    ctf = [np.asarray(c, I64).reshape(-1) for c in cts]
    ptf = np.asarray(pts, I64).reshape(-1)
    out = np.full(B * L * Nn, -1, I64)
    rows = L * Nn
    blocks = -(-(Nn // V) // DIAG_THREADS)
    n = V * np.arange(blocks * DIAG_THREADS)
    n = n[n < Nn]                                  # the threads that work
    for l in range(L):
        for c in range(V):
            off = l * Nn + n + c
            pt = [ptf[j * rows + off] for j in range(J)]
            for b in range(B):
                o = b * rows + off
                out[o] = group_sum([ctf[j][o] for j in range(J)], pt,
                                   q[l]).astype(I64)
    assert (out >= 0).all(), "an output was not written"
    return out.reshape(cts[0].shape)


def residues(qs, lead, rng, edges=True, n=N):
    """Canonical residues [*lead, len(qs), n] with 0, 1, q-1, q-2 (and
    q-1 over a whole row) among them."""
    qs = np.asarray(qs, I64).reshape(-1, 1)
    x = rng.integers(0, qs, size=lead + (len(qs), n))
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
    inputs >= q, negative differences, and operands in [q, 2^31) (up to
    the int32 lanes' top, where sums and differences leave [0, 2q) and
    take the remainder branch), on primes of both chains."""
    rng = np.random.default_rng(7)
    qs = sorted({*Context(head_config(15, 13), device="cpu").all_primes[::7],
                 (1 << 30) - 35, 12289})
    qs = [q for q in qs if q % 2]
    extra = [0, 1, 1 << 30, (1 << 30) + 1, TWO31 - 2, TWO31 - 1]
    for q in qs:
        c = ma.mont_constants(q)
        edge = np.array([0, 1, q - 1, q, q + 1, 2 * q - 1, (1 << 30) - 1]
                        + extra, I64)
        rnd = rng.integers(0, q, 64)
        big = rng.integers(0, TWO31, 64)
        a = np.concatenate([np.repeat(edge, len(edge)), rnd, big, rnd])
        b = np.concatenate([np.tile(edge, len(edge)), rng.integers(0, q, 64),
                            rng.integers(0, q, 64),
                            rng.integers(0, TWO31, 64)])
        cc = rng.integers(0, q, len(a))
        ta, tb, tc = (T(v).int() for v in (a, b, cc))
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
                            [(1 << 30) - 1, TWO31 - 1]])
        want = ma.mont_mul_plain(T(u).int(), c["r2"], q, c["rinv"]).numpy()
        assert np.array_equal(k_mont_mul(u, c["r2"], q), want)


def galois_perms(n, steps):
    """NTT-domain permutations of the rotations by ``steps`` at ring
    dimension n (keys.KeyGenerator.galois_perm of 5^s mod 2n)."""
    k = np.arange(n, dtype=I64)
    return np.stack([((pow(5, s, 2 * n) * (2 * k + 1)) % (2 * n) - 1) // 2
                     for s in steps])


def test_conversions_and_macs_equal_plain(ctx):
    """base_conv at the key-switch decomposition (every digit at the top
    level, partial last digits at lower levels, the levels whose targets
    number 87, 45 and 38, ragged against the tile of four), the mod-down
    (K limbs) and ModRaise (with k); ks_mac with and without the hoisted
    rotations' real Galois permutations (R = 3),
    over every active digit, on B = 2 rows and at the top level also on
    B = 1 and B = 3; diag_mac over a giant step of diagonals.  Lazy sums
    are checked against 2^64 and group sums against REDC's range."""
    rng = np.random.default_rng(11)
    dv, L, K = ctx.dev, ctx.L, ctx.K
    qall = np.array(ctx.all_primes, I64)
    levels = {L, L - ctx.alpha // 2 - 1, ctx.alpha + 1, 1} | {
        t - K for t in (87, 45, 38) if 0 < t - K <= L}
    perm = galois_perms(N, (1, 2, 5))
    for n_q in sorted(levels, reverse=True):
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

        for B in ((2, 1, 3) if n_q == L else (2,)):
            y = residues(tq, (B, D), rng)
            keys = [T(residues(qall, (ctx.dnum, 2), rng)).int()
                    for _ in range(3)]
            w0, w1 = ma.ks_mac_plain(T(y).int(), keys[0], L, T(tq), trinv)
            g0, g1 = k_ks_mac(y, keys[0].numpy(), L, tq)
            assert np.array_equal(g0, w0.numpy()), (n_q, B)
            assert np.array_equal(g1, w1.numpy()), (n_q, B)
            w0, w1 = ma.ks_mac_plain(T(y).int(), keys, L, T(tq), trinv,
                                     T(perm))
            g0, g1 = k_ks_mac(y, [k.numpy() for k in keys], L, tq, perm)
            assert np.array_equal(g0, w0.numpy()), (n_q, B)
            assert np.array_equal(g1, w1.numpy()), (n_q, B)

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


def test_tile_maps_buckets_and_lazy_groups():
    """The launch maps past one block (N = 1024: four base_conv blocks of
    256 coefficients; N = 512: two ks_mac blocks; diag_mac's blocks of 128
    threads of 4, 2 or 1 coefficients), every compile-time bucket of the
    three kernels with its guards, and what the chains never reach:
    base_conv digits of 16 inputs (one full lazy group), 20 and 32 (two
    groups), odd B, T of 1 to 7 targets, inputs in [q, 2^31), negative k;
    ks_mac with 7 and 13 digits (groups of four past the first) and two
    rotations; diag_mac over 1 to 32 diagonals."""
    rng = np.random.default_rng(3)
    ctx = Context(head_config(15, 13), device="cpu")
    dv = ctx.dev
    qall = np.array(ctx.all_primes, I64)
    n = 1024
    for D, A, S, nt in ((1, 16, 16, 7), (2, 20, 33, 5), (1, 32, 32, 6),
                        (3, 3, 8, 1), (2, 5, 9, 3)):
        src, tq = qall[:S], qall[S:S + nt]
        x = residues(src, (3,), rng, n=n)
        pad = np.arange(D * A) % S                 # the plain pads past S
        q_pad, r_pad = T(qall[pad]), dv["rinv"][pad]
        hatinv = T(rng.integers(0, qall[pad]))
        hat = T(np.stack([rng.integers(0, tq, (A, nt)) for _ in range(D)]))
        want = ma.base_conv_plain(T(x), q_pad, r_pad, hatinv, hat, T(tq),
                                  dv["rinv"][S:S + nt])
        got = k_base_conv(x, qall[pad], hatinv.numpy(), hat.numpy(), tq)
        assert np.array_equal(got, want.numpy()), (D, A, S, nt)
    # the conversion on inputs in [q, 2^31), up to the int32 lanes' top
    x = residues(qall[:5], (3,), rng, n=n)
    x[0, :, 5:9] = [qall[0], (1 << 30) + 3, TWO31 - 2, TWO31 - 1]
    hatinv = rng.integers(0, qall[:5])
    hat = T(rng.integers(0, qall[5:8], (1, 5, 3)))
    want = ma.base_conv_plain(T(x).int(), T(qall[:5]), dv["rinv"][:5],
                              T(hatinv), hat, T(qall[5:8]), dv["rinv"][5:8])
    got = k_base_conv(x, qall[:5], hatinv, hat.numpy(), qall[5:8])
    assert np.array_equal(got, want.numpy()), "inputs past q"

    # ModRaise's form at N = 1024: two inputs, no hatinv, less k * kq
    lam = residues(qall[:2], (3,), rng, n=n)
    k = rng.integers(-1, 4, (3, n))
    tq = qall[:7]
    hat = T(rng.integers(0, tq, (1, 2, 7)))
    kq = T(rng.integers(0, tq))
    want = ma.base_conv_plain(T(lam), None, None, None, hat, T(tq),
                              dv["rinv"][:7], T(k), kq)
    got = k_base_conv(lam, None, None, hat.numpy(), tq, k, kq.numpy())
    assert np.array_equal(got, want.numpy()), "ModRaise"

    # ks_mac past one block, at 7 and 13 digits, one key and two rotations
    n, q_limbs, n_q, kp = 512, 20, 3, 4
    KL = q_limbs + kp
    tq = np.concatenate([qall[:n_q], qall[q_limbs:KL]])
    trinv = torch.cat([dv["rinv"][:n_q], dv["rinv"][q_limbs:KL]])
    perm = galois_perms(n, (3, 7))
    for D in (7, 13):
        assert mac_bucket(D) in (8, 16)
        y = residues(tq, (3, D), rng, n=n)
        keys = [T(residues(qall[:KL], (D, 2), rng, n=n)).int()
                for _ in perm]
        w = ma.ks_mac_plain(T(y), keys[0], q_limbs, T(tq), trinv)
        g = k_ks_mac(y, keys[0].numpy(), q_limbs, tq)
        assert all(np.array_equal(a, b.numpy()) for a, b in zip(g, w)), D
        w = ma.ks_mac_plain(T(y), keys, q_limbs, T(tq), trinv, T(perm))
        g = k_ks_mac(y, [k.numpy() for k in keys], q_limbs, tq, perm)
        assert all(np.array_equal(a, b.numpy()) for a, b in zip(g, w)), D

    # ks_mac on a window of a key's rows, as a limb shard reads its rows in
    # place: Q rows from s = 5 and the special share [2, 4) of kp = 4, so
    # the share starts at row q_limbs + 2 - s of the window
    s0, plo, phi, n_q = 5, 2, 4, 6
    tq = np.concatenate([qall[s0:s0 + n_q], qall[q_limbs + plo:q_limbs + phi]])
    trinv = torch.cat([dv["rinv"][s0:s0 + n_q],
                       dv["rinv"][q_limbs + plo:q_limbs + phi]])
    y = residues(tq, (3, 7), rng, n=n)
    keys = [T(residues(qall[:KL], (7, 2), rng, n=n)).int() for _ in perm]
    views = [k[..., s0:q_limbs + phi, :] for k in keys]
    assert limb_cuda._key_row_stride(views[0]) == KL
    window = (s0, q_limbs + phi - s0)
    w = ma.ks_mac_plain(T(y), views[0], q_limbs + plo - s0, T(tq), trinv)
    assert all(torch.equal(a, b) for a, b in zip(w, ma.ks_mac_plain(
        T(y), torch.cat([keys[0][..., s0:s0 + n_q, :],
                         keys[0][..., q_limbs + plo:q_limbs + phi, :]], -2),
        n_q, T(tq), trinv)))
    g = k_ks_mac(y, keys[0].numpy(), q_limbs + plo - s0, tq, window=window)
    assert all(np.array_equal(a, b.numpy()) for a, b in zip(g, w)), "window"
    w = ma.ks_mac_plain(T(y), views, q_limbs + plo - s0, T(tq), trinv,
                        T(perm))
    g = k_ks_mac(y, [k.numpy() for k in keys], q_limbs + plo - s0, tq, perm,
                 window)
    assert all(np.array_equal(a, b.numpy()) for a, b in zip(g, w)), "window"
    # a key cut along any other axis is no window of rows
    for bad in (keys[0][..., :n // 2], keys[0][::2], keys[0].transpose(2, 3)):
        with pytest.raises(ValueError, match="window of the rows"):
            limb_cuda._key_row_stride(bad)

    # diag_mac at every bucket of its term count, past one block
    n, L = 1024, 3
    q = T(qall[:L]).reshape(-1, 1)
    for J in (1, 4, 5, 8, 9, 16, 17, 32):
        cts = [residues(qall[:L], (2, 2), rng, n=n) for _ in range(J)]
        pts = residues(qall[:L], (J,), rng, n=n)
        want = ma.diag_mac_plain([T(c).int() for c in cts], T(pts).int(), q,
                                 dv["rinv"][:L].reshape(-1, 1))
        assert np.array_equal(k_diag_mac(cts, pts, qall[:L]),
                              want.numpy()), J


EW_THREADS, EW_VECS = 256, 2
EW_SPAN = EW_THREADS * EW_VECS * 4
EW_INPUTS = {"add": 2, "sub": 2, "neg": 1, "mul": 2, "from_mont": 1,
             "sub_mul": 3}


def _replay_layout(op, ops):
    """limb_ew's launch as the kernel walks it, in numpy, from ew_layout's
    sizes and strides: rows split over the outer collapsed dims; per row
    the constants (q, -q^-1, each operand constant along the row) read
    once; the vector path (16-byte loads of 4 residues, EW_VECS per thread)
    where the row is a multiple of 4 long, q is constant along it and
    every other input is contiguous along it from a 16-byte boundary,
    else the scalar path (q per element where it varies along the row);
    every element of every row written once.  Returns the result and the
    set of paths taken."""
    shape, sizes, st, rows = limb_cuda.ew_layout(ops)
    nin = EW_INPUTS[op]
    flat = []
    for t in ops:
        if isinstance(t, torch.Tensor):
            span = 1 + sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
            flat.append(t.as_strided((span,), (1,)).numpy())
        else:
            flat.append(None)
    inner = sizes[-1]
    out = np.full(shape.numel(), -1, I64)
    q_row = flat[3] is None or st[3][-1] == 0
    tid = np.arange(EW_THREADS)
    runs = np.arange(-(-inner // EW_SPAN)) * EW_SPAN
    vec_j = (runs[:, None, None] + 4 * (np.arange(EW_VECS)[None, :, None]
                                        * EW_THREADS + tid)).reshape(-1)
    vec_j = (vec_j[vec_j < inner][:, None] + np.arange(4)).reshape(-1)
    scal_j = (runs[:, None, None] + np.arange(4 * EW_VECS)[None, :, None]
              * EW_THREADS + tid).reshape(-1)
    scal_j = scal_j[scal_j < inner]
    paths = set()
    for row in range(rows):
        base, r = [0] * 4, row
        for d in range(len(sizes) - 2, -1, -1):
            i, r = r % sizes[d], r // sizes[d]
            base = [b + i * s[d] for b, s in zip(base, st)]
        along = [f is not None and s[-1] != 0 for f, s in zip(flat, st)]
        cst = [int(t or 0) if f is None else 0 if al else int(f[b])
               for t, f, b, al in zip(ops, flat, base, along)]
        vec = q_row and inner % 4 == 0 and all(
            st[k][-1] == 1 and (ops[k].data_ptr() + 4 * base[k]) % 16 == 0
            for k in range(nin) if along[k])
        paths.add("vector" if vec else "scalar")
        j = vec_j if vec else scal_j
        assert np.array_equal(np.sort(j), np.arange(inner))
        vals = [f[b + j * s[-1]] if al else np.full(len(j), c, I64)
                for f, b, s, al, c in zip(flat, base, st, along, cst)]
        o = row * inner + j
        assert (out[o] == -1).all(), "an element written twice"
        out[o] = k_ew(op, *vals)
    assert (out >= 0).all(), "an element not written"
    return out.reshape(tuple(shape)), paths


def test_elementwise_layout_replayed_on_call_site_patterns():
    """The broadcast patterns the call sites pass, each on the vector path:
    per-limb [n, 1] constants, per-column [C, 1, n, 1] constants, a
    diagonal broadcast over the polynomials, a limb slice of a larger
    tensor (the mod-down's u_q), a Python-int modulus and operand (the
    rescale's last limb); and on the scalar path an operand one element
    off a 16-byte boundary and a modulus that varies along the innermost
    dim."""
    rng = np.random.default_rng(5)
    ctx = Context(head_config(15, 13), device="cpu")
    dv = ctx.dev
    q5, r5 = dv["q"][:5].reshape(-1, 1), dv["rinv"][:5].reshape(-1, 1)
    qs = dv["q"][:5].numpy()

    def res(lead):
        return T(residues(qs, lead, rng, edges=False)).int()
    u7 = T(residues(dv["q"][:7].numpy(), (3,), rng, edges=False)).int()
    qe = int(dv["q"][7])
    cases = [
        ("mul", res((2, 3)), q5 * 0 + 7, None, q5),
        ("add", res((4, 2)), res((4, 1))[..., :1], None, q5),
        ("mul", res((4, 2)), torch.from_numpy(
            rng.integers(0, qs.reshape(-1, 1), (4, 1, 5, 1))).int(), None,
         q5),
        ("mul", res((2, 2)), res(())[None], None, q5),
        ("sub_mul", u7[..., :5, :], res((3,)),
         dv["pdown_pinv_mont"][:5].reshape(-1, 1), q5),
        ("add", T(rng.integers(0, qe, (3, 1, N))).int(), qe >> 1, None, qe),
        ("from_mont", u7[:, 6:7, :], None, None, qe),
        ("add", res((3,))[..., 1:], res((3,))[..., 1:], None, q5),
        ("neg", res((3,)).transpose(-1, -2), None, None, q5.reshape(1, -1)),
    ]
    scalar = cases[-2:]
    for op, a, b, c, q in cases:
        want = {"add": lambda: ma.add_mod_plain(a, b, q),
                "neg": lambda: ma.neg_mod_plain(a, q),
                "mul": lambda: ma.mont_mul_plain(a, b, q, r5),
                "from_mont": lambda: ma.from_mont_plain(
                    a, q, ma.mont_constants(q)["rinv"]),
                "sub_mul": lambda: ma.sub_mont_mul_plain(a, b, c, q, r5)}[op]()
        got, paths = _replay_layout(op, (a, b, c, q))
        assert got.shape == tuple(want.shape), op
        assert np.array_equal(got, want.numpy()), op
        scalar_case = any(a is s[1] for s in scalar)
        assert paths == {"scalar" if scalar_case else "vector"}, op
    # eight dims that no two operands step through alike do not collapse
    wide = torch.zeros((2,) * 8, dtype=torch.int32)
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
