"""Kind ``head``: the encrypted attention head, ``entry.build_head(...).fn``.

Set-up goes through ``entry.build_head`` itself: the context, the client's
keys from the seed, the Q/K/V CPMM plaintexts of the benchmark's weights,
and one encrypted batch of ``inputs_per_pass`` inputs of ``tokens``
tokens (the program draws their lengths and tokens from the seed; the
reference draws the same from the same seed).  A pass runs the head's
closure on that batch: the circuit is data-oblivious, so every pass does
the work of a fresh batch.
"""

from __future__ import annotations

import time

import torch

from fhe_bench.reference import head as ref

RATE = "head_inputs_per_s"


class Program:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from moai_tpu_torch.entry import build_head
        ck = cfg["ckks"]
        self.num_x, self.num_row = traffic["inputs_per_pass"], \
            traffic["tokens"]
        lo, hi = traffic["lengths"]
        if (lo, hi) != (self.num_row // 2, self.num_row):
            raise ValueError(f"the program draws lengths U{{"
                             f"{self.num_row // 2}..{self.num_row}}}, not "
                             f"U{{{lo}..{hi}}}")
        self.cfg, self.seed = cfg, seed
        self.items = self.num_x
        self.w = ref.weights(seed, cfg["hidden_size"], cfg["head_dim"])
        self.head = build_head(
            logN=ck["logN"], n_data_levels=ck["n_data_levels"],
            num_x=self.num_x, num_row=self.num_row,
            d_model=cfg["hidden_size"], head_dim=cfg["head_dim"],
            exp_r=cfg["exp_r"], inv_iters=cfg["inv_iters"],
            input_count=self.num_x, seed=seed, device=device,
            weights=self.w)
        check_chain(self.head.ctx, cfg)
        self.ev = self.head.ev

    @property
    def x_data(self):
        return self.head.x_data

    def run(self):
        return self.head.fn(self.head.x_data)

    def instrument(self, spans: dict, sync):
        """Synchronised spans around the CPMMs, both CCMMs and the softmax
        as ``entry`` calls them; returns (before each pass, undo)."""
        import moai_tpu_torch.entry as entry
        from moai_tpu_torch.ops.matmul import CPMM
        targets = [(CPMM, "__call__", "head_cpmm_s"),
                   (entry, "ccmm_col_to_diag", "head_ccmm_s"),
                   (entry, "ccmm_diag_to_col", "head_ccmm_s"),
                   (entry, "softmax_diag", "head_softmax_s")]
        saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in targets]

        def wrap(fn, key):
            def inner(*a, **k):
                sync()
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    sync()
                    spans[key] = spans.get(key, 0.0) + \
                        time.perf_counter() - t0
            return inner

        for (obj, attr, key), (_, _, fn) in zip(targets, saved):
            setattr(obj, attr, wrap(fn, key))

        def undo():
            for obj, attr, fn in saved:
                setattr(obj, attr, fn)
        return (lambda: None), undo

    def free(self) -> None:
        del self.head, self.ev


def check_chain(ctx, cfg: dict) -> None:
    """The program's CKKS parameters and primes are the configuration's."""
    ck = cfg["ckks"]
    got = {k: getattr(ctx.cfg, k) for k in ck if hasattr(ctx.cfg, k)}
    want = {k: tuple(v) if isinstance(v, list) else v
            for k, v in ck.items() if k in got}
    if got != want or list(ctx.q_primes) != cfg["q_primes"] \
            or list(ctx.p_primes) != cfg["p_primes"]:
        raise ValueError(f"the program's CKKS parameters {got} or primes "
                         f"are not the configuration's {want}")


def reference(cfg: dict, traffic: dict, seed: int, dtype=torch.float64,
              device="cpu") -> torch.Tensor:
    """The head's output as the plain reference computes it, in
    ``dtype``, from the benchmark's own draws."""
    lo, hi = traffic["lengths"]
    lens, xs = ref.inputs(seed, traffic["inputs_per_pass"],
                          traffic["tokens"], cfg["hidden_size"], lo, hi)
    w = ref.weights(seed, cfg["hidden_size"], cfg["head_dim"])
    return ref.head_output(xs, w, lens, cfg["exp_r"], cfg["inv_iters"],
                           traffic["tokens"], dtype=dtype, device=device)


def judge_spec(cfg: dict, traffic: dict, seed: int) -> dict:
    """What the judge reads besides the output: the seed, the sizes and
    the primes."""
    ck = cfg["ckks"]
    return {"seed": seed, "N": 1 << ck["logN"],
            "hamming_weight": ck["hamming_weight"],
            "q_primes": cfg["q_primes"], "out_limbs": cfg["out_limbs"],
            "head_dim": cfg["head_dim"],
            "num_x": traffic["inputs_per_pass"], "num_row": traffic["tokens"]}


judge, pack = ref.judge, ref.pack


def setup(cfg: dict, traffic: dict, seed: int, device) -> Program:
    return Program(cfg, traffic, seed, device)
