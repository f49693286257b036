"""CKKS parameter sets, modulus-chain ladder, and precomputed context.

Port of ``moai_tpu/params.py``.  The host tables (numpy uint32) are built
exactly as in the JAX package; ``Context.dev`` holds them as int32 tensors
(every entry is a residue below 2^30, the port's at-rest format) on the
context's device, together with the NTT tables: those of the plain
transforms always, and on a CUDA device also the kernels' tables
(``dev["ntt"]["cuda"]``), which is where ``ntt.ntt`` finds them.

Chain layout (composite scale: a data level is a pair of ~26-bit primes):

    Q = [q0 primes] + [data pairs] * n_data_levels + [boot pairs] * n_boot
    P = [special primes] * k_sp          (hybrid key-switching modulus)
"""

from __future__ import annotations

import copy
import dataclasses
import math

import numpy as np
import torch

from .primes import ntt_primes_near, inv_mod
from .ntt import NttTables


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  CUDA is the default everywhere;
    asking for it on a machine without a card raises (no silent CPU run)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def check_device(ctx: "Context", device) -> torch.device:
    """Resolve ``device`` and require it to be the context's."""
    dev = resolve_device(device)
    if dev.type != ctx.device.type:
        raise ValueError(f"context lives on {ctx.device}, not {dev}")
    return ctx.device


def _moved(tree, device):
    """A dict/list tree of tensors with every tensor on ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _moved(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_moved(v, device) for v in tree]
    return tree


@dataclasses.dataclass(frozen=True)
class CKKSConfig:
    """User-facing parameter choice (all sizes in bits unless noted)."""
    logN: int = 14
    # base modulus q0: product of these prime sizes (bits)
    q0_bits: tuple = (30.0, 21.0)
    # data levels: pairs of primes; scale = product of each pair ~ 2**(2*b)
    data_pair_bits: float = 26.0
    n_data_levels: int = 6
    # bootstrapping levels (consumed by the bootstrap pipeline itself)
    boot_pair_bits: float = 29.0
    n_boot_levels: int = 0
    # hybrid key-switching: number of digits; special primes sized to cover
    # the largest digit product
    dnum: int = 3
    special_bits: float = 29.5
    # sparse ternary secret Hamming weight; 0 = uniform ternary
    hamming_weight: int = 192
    noise_std: float = 3.2

    @property
    def N(self) -> int:
        return 1 << self.logN

    @property
    def slots(self) -> int:
        return self.N // 2


def _pair_primes(two_n: int, bits: float, count_pairs: int, exclude
                 ) -> list[int]:
    """Pick 2*count_pairs primes around 2**bits, alternating below/above the
    target so each consecutive pair's product stays close to 2**(2*bits)."""
    lo = ntt_primes_near(bits, two_n, count_pairs, exclude=exclude,
                         direction="down")
    hi = ntt_primes_near(bits, two_n, count_pairs,
                         exclude=list(exclude) + lo, direction="up")
    out = []
    for a, b in zip(sorted(lo, reverse=True), sorted(hi)):
        out.extend([a, b])
    return out


class Context:
    """Precomputed CKKS context: ladder, tables, RNS/keyswitch constants,
    with its tensors on ``device``."""

    def __init__(self, cfg: CKKSConfig, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        N = cfg.N
        two_n = 2 * N

        used: list[int] = []
        q0 = []
        for b in cfg.q0_bits:
            q0 += ntt_primes_near(b, two_n, 1, exclude=used)
            used += q0[-1:]
        data = _pair_primes(two_n, cfg.data_pair_bits, cfg.n_data_levels, used)
        used += data
        boot = _pair_primes(two_n, cfg.boot_pair_bits, cfg.n_boot_levels,
                            used) if cfg.n_boot_levels else []
        used += boot

        self.q_primes: list[int] = q0 + data + boot    # Q, low->high chain
        self.n_q0 = len(q0)
        self.L = len(self.q_primes)

        # hybrid KS digit layout over the full Q basis
        dnum = max(1, min(cfg.dnum, self.L))
        alpha = math.ceil(self.L / dnum)
        self.dnum, self.alpha = dnum, alpha
        self.digit_ranges = [(d * alpha, min((d + 1) * alpha, self.L))
                             for d in range(dnum)]
        max_digit_bits = max(
            sum(math.log2(self.q_primes[i]) for i in range(a, b))
            for a, b in self.digit_ranges)
        k_sp = math.ceil(max_digit_bits / cfg.special_bits)
        self.p_primes = ntt_primes_near(cfg.special_bits, two_n, k_sp,
                                        exclude=used, direction="up")
        self.K = len(self.p_primes)

        self.all_primes = self.q_primes + self.p_primes
        self.sp_slice = (self.L, self.L + self.K)

        self.scale = float(np.prod([float(p) for p in
                                    data[:2]])) if data else float(q0[-1])
        self.q0_product = 1
        for p in q0:
            self.q0_product *= p

        # NTT + Montgomery tables over ALL primes (Q then P)
        self.ntt = NttTables(cfg.logN, self.all_primes)
        self._build_rns_tables()
        self.dev = self._device_tables()

    def to(self, device) -> "Context":
        """This context's replica on ``device``: the host tables shared, the
        device tables moved there and nothing recomputed (a replica on a
        card of a context without one builds the kernels' NTT tables); the
        context itself when it is there already."""
        dev = resolve_device(device)
        if dev == self.device:
            return self
        out = copy.copy(self)
        out.device = dev
        out.dev = _moved({k: v for k, v in self.dev.items() if k != "ntt"},
                         dev)
        out.dev["ntt"] = _moved({k: v for k, v in self.dev["ntt"].items()
                                 if k != "cuda"}, dev)
        if dev.type == "cuda":
            from .ntt_cuda import CudaNttTables
            cuda = self.dev["ntt"].get("cuda")
            out.dev["ntt"]["cuda"] = cuda.to(dev) if cuda is not None else \
                CudaNttTables(self.ntt, dev)
        return out

    def prime(self, i: int) -> int:
        return self.all_primes[i]

    def q_product(self, n_q: int) -> int:
        out = 1
        for p in self.q_primes[:n_q]:
            out *= p
        return out

    def estimate_security_bits(self, quantum: bool = False) -> float:
        """Primal-uSVP core-SVP estimate for this chain's N, full key
        modulus QP and secret distribution (``security.py``)."""
        from .security import context_security_bits
        return context_security_bits(self, quantum=quantum)

    # -- RNS precomputations (host; identical to the JAX package) ---------
    def _build_rns_tables(self):
        primes = self.all_primes
        L, K = self.L, self.K
        nall = L + K

        def mont(x, q):
            return (x % q) * (1 << 32) % q

        # rescale tables: dropping Q prime index ell (the current top prime)
        # new_limb_j = (limb_j - lift(limb_ell)) * qell^{-1} mod q_j
        self.resc_qlinv_mont = np.zeros((L, L), dtype=np.uint32)
        self.resc_half = np.zeros(L, dtype=np.uint32)
        self.resc_half_mod = np.zeros((L, L), dtype=np.uint32)
        for ell in range(1, L):
            qe = primes[ell]
            self.resc_half[ell] = qe >> 1
            for j in range(ell):
                qj = primes[j]
                self.resc_qlinv_mont[ell, j] = mont(inv_mod(qe % qj, qj), qj)
                self.resc_half_mod[ell, j] = mont((qe >> 1) % qj, qj)

        # mod-down-by-P tables (keyswitch tail): conv P -> q_j then *P^{-1}
        P = 1
        for p in self.p_primes:
            P *= p
        self.P_int = P
        self.pdown_hatinv_mont = np.zeros(K, dtype=np.uint32)
        self.pdown_hat_modq_mm = np.zeros((K, L), dtype=np.uint32)
        self.pdown_pinv_mont = np.zeros(L, dtype=np.uint32)
        self.pdown_half = np.array([p >> 1 for p in self.p_primes], np.uint32)
        self.pdown_half_modq = np.zeros(L, dtype=np.uint32)
        for i, p in enumerate(self.p_primes):
            hat = P // p
            self.pdown_hatinv_mont[i] = mont(inv_mod(hat % p, p), p)
            for j, qj in enumerate(self.q_primes):
                self.pdown_hat_modq_mm[i, j] = (hat % qj) * pow(2, 64, qj) % qj
        for j, qj in enumerate(self.q_primes):
            self.pdown_pinv_mont[j] = mont(inv_mod(P % qj, qj), qj)
            self.pdown_half_modq[j] = (P >> 1) % qj

        # hybrid-KS digit decomposition tables, per level (n_q active
        # primes): hatS_inv [L+1, dnum, alpha] (Montgomery constants) and
        # hatS_mod_t [L+1, dnum, alpha, nall] stored *R^2 so the MAC lands
        # directly in Montgomery form
        self.ks_hatinv_mont = np.zeros((L + 1, self.dnum, self.alpha),
                                       dtype=np.uint32)
        self.ks_hat_mm = np.zeros((L + 1, self.dnum, self.alpha, nall),
                                  dtype=np.uint32)
        # per-position prime constants padded to dnum*alpha (positions past
        # L reuse the last prime; their lambdas are identically zero)
        npos = self.dnum * self.alpha
        self.ks_q_pad = np.full(npos, primes[L - 1], dtype=np.uint32)
        self.ks_qneg_pad = np.zeros(npos, dtype=np.uint32)
        self.ks_rinv_pad = np.zeros(npos, dtype=np.uint32)
        for i in range(npos):
            q = primes[i] if i < L else primes[L - 1]
            self.ks_q_pad[i] = q
            self.ks_qneg_pad[i] = ((1 << 32) - pow(q, -1, 1 << 32)) % (1 << 32)
            self.ks_rinv_pad[i] = pow((1 << 32) % q, -1, q)
        for n_q in range(1, L + 1):
            for d, (a, b) in enumerate(self.digit_ranges):
                b_act = min(b, n_q)
                if a >= b_act:
                    continue
                S = 1
                for i in range(a, b_act):
                    S *= primes[i]
                for ii, i in enumerate(range(a, b_act)):
                    si = primes[i]
                    hat = S // si
                    self.ks_hatinv_mont[n_q, d, ii] = mont(
                        inv_mod(hat % si, si), si)
                    for t in range(nall):
                        qt = primes[t]
                        self.ks_hat_mm[n_q, d, ii, t] = \
                            (hat % qt) * pow(2, 64, qt) % qt

    # -- device tables -----------------------------------------------------
    def _device_tables(self) -> dict:
        def t(a):                      # residues below 2^30: int32, exact
            return torch.from_numpy(np.asarray(a).astype(np.int32)).to(
                self.device)
        ntt_dev = self.ntt.to(self.device)
        if self.device.type == "cuda":
            from .ntt_cuda import CudaNttTables
            ntt_dev["cuda"] = CudaNttTables(self.ntt, self.device)
        return {
            "ntt": ntt_dev,
            "q": t(self.ntt.q),
            "rinv": t(self.ntt.rinv),
            "r2": t(self.ntt.r2),
            "r1": t(self.ntt.r1),
            "resc_qlinv_mont": t(self.resc_qlinv_mont),
            "resc_half_mod": t(self.resc_half_mod),
            "pdown_hatinv_mont": t(self.pdown_hatinv_mont),
            "pdown_hat_modq_mm": t(self.pdown_hat_modq_mm),
            "pdown_pinv_mont": t(self.pdown_pinv_mont),
            "ks_hatinv_mont": t(self.ks_hatinv_mont),
            "ks_hat_mm": t(self.ks_hat_mm),
            "ks_q_pad": t(self.ks_q_pad),
            "ks_rinv_pad": t(self.ks_rinv_pad),
        }


# canonical configs ---------------------------------------------------------

def test_config() -> CKKSConfig:
    """Small, fast config for unit tests (CPU)."""
    return CKKSConfig(logN=11, q0_bits=(29.0, 21.0), data_pair_bits=26.0,
                      n_data_levels=3, n_boot_levels=0, dnum=2,
                      hamming_weight=64)


def bench_config_n15() -> CKKSConfig:
    """Mult + rescale + rotation at N=2^15; q0 = 60 bits > composite scale
    (2^52) + headroom 2^7, so messages |m| < ~64 survive at the bottom
    level."""
    return CKKSConfig(logN=15, q0_bits=(30.0, 30.0), data_pair_bits=26.0,
                      n_data_levels=8, n_boot_levels=0, dnum=3,
                      hamming_weight=192)


def head_config(logN: int = 15, n_data_levels: int = 16) -> CKKSConfig:
    """The encrypted attention head's chain (``entry.build_head``): at
    logN 15, 34 Q primes, 11 special primes, dnum 3."""
    return CKKSConfig(logN=logN, q0_bits=(30.0, 30.0), data_pair_bits=26.0,
                      n_data_levels=n_data_levels, n_boot_levels=0, dnum=3,
                      hamming_weight=64)


def _approx_security_bits(cfg: CKKSConfig) -> float:
    """Closed-form estimate from the CONFIG bit budget (no prime search):
    logQP ~ sum of configured sizes + special primes covering the largest
    hybrid digit.  Good to ~1 bit vs the built-context estimate."""
    from .security import security_bits
    logq = (sum(cfg.q0_bits) + 2 * cfg.data_pair_bits * cfg.n_data_levels
            + 2 * cfg.boot_pair_bits * cfg.n_boot_levels)
    n_primes = len(cfg.q0_bits) + 2 * (cfg.n_data_levels + cfg.n_boot_levels)
    alpha = math.ceil(n_primes / max(1, min(cfg.dnum, n_primes)))
    digit_bits = alpha * max(cfg.q0_bits[0], cfg.data_pair_bits,
                             cfg.boot_pair_bits)
    special = math.ceil(digit_bits / cfg.special_bits) * cfg.special_bits
    return security_bits(cfg.N, logq + special,
                         hamming_weight=cfg.hamming_weight or None)


def flagship_config() -> CKKSConfig:
    """The full chain at N=2^16: 20 data levels + 16 boot levels (3
    CoeffToSlot + 10 EvalMod + 3 SlotToCoeff composite levels), q0 = 60
    bits, dnum 6: the throughput-first chain, held to at least 55 bits of
    conservative core-SVP hardness (``security.py``)."""
    cfg = CKKSConfig(logN=16, q0_bits=(30.0, 30.0), data_pair_bits=26.0,
                     n_data_levels=20, boot_pair_bits=29.0, n_boot_levels=16,
                     dnum=6, hamming_weight=192)
    bits = _approx_security_bits(cfg)
    assert bits >= 55.0, \
        f"flagship chain regressed below its documented floor: {bits:.1f}"
    return cfg


def flagship_parity_config() -> CKKSConfig:
    """N=2^16 chain sized to the reference's bit budget (logp=46 data
    levels, logq=51 q0/boot levels): 23-bit data pairs, 25.5-bit boot
    pairs, 51-bit q0, dnum 13 so the special primes stay small.  ~74 bits
    of conservative core-SVP hardness (``security.py``)."""
    return CKKSConfig(logN=16, q0_bits=(26.0, 25.0), data_pair_bits=23.0,
                      n_data_levels=20, boot_pair_bits=25.5,
                      n_boot_levels=16, dnum=13, special_bits=29.5,
                      hamming_weight=192)
