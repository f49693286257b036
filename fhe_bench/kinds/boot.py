"""Kind ``boot``: the CKKS bootstrap through ``boot.bootstrap.make_refresh``.

Set-up composes what ``entry.build_bootstrap`` composes, from the port's
public pieces: ``Context``, ``Encoder``, ``KeyGenerator``, ``Encryptor``,
``Evaluator``, ``Bootstrapper``, ``make_refresh``.  One thing differs.
Right after ``KeyGenerator(ctx, seed)`` has drawn the client's secret from
the seed, its stream is replaced by ``KeyStream``, a seeded stream that is
cheap to draw (on the card).  It stands in for the client, which makes the
evaluation keys and ships them to the server: the keys the timed path
reads are the same kind of thing (uniform residues, rounded Gaussian
errors, 29.3 GB of int32 Galois keys at logN 16), but not cryptographic,
and the configuration file says so.  A pass refreshes a batch of
``batch`` ciphertexts, each holding its own U(-bound, bound) slot values,
from n_q0 + 2 limbs to the data chain above the bootstrap's levels.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from fhe_bench.kinds.head import check_chain
from fhe_bench.reference import boot as ref

RATE = "boot_cts_per_s"


class KeyStream:
    """The subset of the client's sampler that key generation and the
    Encryptor's seeding draw on.  The 64-bit words come from a seeded
    ``torch.Generator`` on the program's device, BLOCK words a draw, one
    copy to the host each (key generation masks them to 62 bits and
    reduces them mod q); Gaussian errors and integers from numpy's
    PCG64."""

    BLOCK = 1 << 23

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.np = np.random.Generator(np.random.PCG64([seed, 3]))
        self.buf, self.pos = np.empty(0, np.uint64), 0

    def _u64(self, count: int) -> np.ndarray:
        if self.pos + count > len(self.buf):
            words = torch.randint(0, 1 << 62, (max(count, self.BLOCK),),
                                  dtype=torch.int64, device=self.device,
                                  generator=self.gen)
            self.buf, self.pos = words.cpu().numpy().view(np.uint64), 0
        self.pos += count
        return self.buf[self.pos - count:self.pos]

    def normal(self, loc=0.0, scale=1.0, size=None):
        return self.np.normal(loc, scale, size)

    def integers(self, low, high=None, size=None):
        return self.np.integers(low, high, size=size)


class Program:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from moai_tpu_torch.boot.bootstrap import Bootstrapper, make_refresh
        from moai_tpu_torch.ciphertext import Ciphertext
        from moai_tpu_torch.encoder import Encoder
        from moai_tpu_torch.encrypt import Encryptor
        from moai_tpu_torch.evaluator import Evaluator
        from moai_tpu_torch.keys import KeyGenerator
        from moai_tpu_torch.params import CKKSConfig, Context
        ck = cfg["ckks"]
        self.cfg, self.seed = cfg, seed
        self.batch = self.items = traffic["batch"]
        params = {k: tuple(v) if isinstance(v, list) else v
                  for k, v in ck.items()
                  if k in CKKSConfig.__dataclass_fields__}
        t = [time.perf_counter()]
        ctx = Context(CKKSConfig(**params), device=device)
        check_chain(ctx, cfg)
        enc = Encoder(ctx)
        t.append(time.perf_counter())
        kg = KeyGenerator(ctx, seed=seed, device=device)
        kg.rng = KeyStream(seed, device)
        encryptor = Encryptor(ctx, enc, kg.gen_public_key(), kg,
                              device=device)
        ev = Evaluator(ctx, relin_key=kg.gen_relin_key(), device=device)
        t.append(time.perf_counter())
        bt = Bootstrapper(ev, enc, m_bound=ck["m_bound"],
                          lt_group=ck["lt_group"],
                          evalmod_degree=ck["evalmod_degree"])
        t.append(time.perf_counter())
        ev.galois_keys = kg.gen_galois_keys(steps=bt.galois_steps(),
                                            conjugate=True)
        t.append(time.perf_counter())
        self.n_out = ctx.L - 2 * bt.levels
        if self.n_out != cfg["out_limbs"]:
            raise ValueError(f"the bootstrap ends at {self.n_out} limbs, "
                             f"not the configuration's {cfg['out_limbs']}")
        refresh = make_refresh(bt, m_bound=ck["m_bound"])
        vals = ref.values(seed, self.batch, ctx.cfg.slots,
                          traffic["value_bound"])
        x = encryptor.encrypt_values(vals, n_q=ctx.n_q0 + 2).data
        scale = ctx.scale
        t.append(time.perf_counter())
        print("[fhe_bench] boot set-up s: context "
              f"{t[1] - t[0]:.2f}, public and relinearization keys "
              f"{t[2] - t[1]:.2f}, Bootstrapper {t[3] - t[2]:.2f}, "
              f"{len(ev.galois_keys.keys)} Galois keys {t[4] - t[3]:.2f}, "
              f"encryption {t[5] - t[4]:.2f}", file=sys.stderr, flush=True)
        self.bt, self.ev, self.x_data = bt, ev, x
        self.run = lambda: refresh(Ciphertext(x, scale, True), self.n_out)

    def instrument(self, spans: dict, sync):
        """Synchronised spans from ``Bootstrapper.on_stage``: ModRaise,
        CoeffToSlot and SlotToCoeff (linear), EvalMod; returns (before
        each pass, undo)."""
        mark = [0.0]

        def on_stage(name):
            sync()
            now = time.perf_counter()
            key = ("boot_linear_s" if name.startswith(("CoeffToSlot",
                                                       "SlotToCoeff"))
                   else "boot_evalmod_s" if name.startswith("EvalMod")
                   else "boot_modraise_s")
            spans[key] = spans.get(key, 0.0) + now - mark[0]
            mark[0] = now

        def before():
            sync()
            mark[0] = time.perf_counter()

        self.bt.on_stage = on_stage

        def undo():
            self.bt.on_stage = None
        return before, undo

    def free(self) -> None:
        del self.bt, self.ev, self.x_data, self.run


def reference(cfg: dict, traffic: dict, seed: int, dtype=torch.float64,
              device="cpu") -> torch.Tensor:
    """The refreshed batch's slot values as the plain reference holds
    them: the values drawn and encrypted, in ``dtype``."""
    N = 1 << cfg["ckks"]["logN"]
    return ref.slot_values(ref.values(seed, traffic["batch"], N // 2,
                                      traffic["value_bound"]), dtype, device)


def judge_spec(cfg: dict, traffic: dict, seed: int) -> dict:
    """What the judge reads besides the output: the seed, the sizes and
    the primes."""
    ck = cfg["ckks"]
    return {"seed": seed, "N": 1 << ck["logN"],
            "hamming_weight": ck["hamming_weight"],
            "q_primes": cfg["q_primes"], "out_limbs": cfg["out_limbs"]}


judge, pack = ref.judge, ref.pack


def setup(cfg: dict, traffic: dict, seed: int, device) -> Program:
    return Program(cfg, traffic, seed, device)
