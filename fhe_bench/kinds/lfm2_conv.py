"""Kind ``lfm2_conv``: one chip's channel share of LFM2's gated
short-convolution mixer, ``entry.build_lfm2_conv(...).fn``.

Set-up goes through ``entry.build_lfm2_conv`` itself: the context, the
client's keys from the seed, the in_proj and out_proj CPMM weights and the
conv's mask-and-tap plaintexts from the benchmark's weights, and one
encrypted batch of ``inputs_per_pass`` sequences of ``tokens`` tokens (the
program draws their lengths and h from the seed; the reference draws the
same from the same seed).  A pass runs the mixer on that batch: the
circuit is data-oblivious, so every pass does the work of a fresh batch.
"""

from __future__ import annotations

import time

import torch

from fhe_bench.kinds.head import check_chain
from fhe_bench.reference import head as head_ref
from fhe_bench.reference import lfm2_conv as ref

RATE = "head_inputs_per_s"
SPANS = (("in_proj", "lfm2_inproj_s"), ("gate", "lfm2_gate_s"),
         ("shift", "lfm2_shift_s"), ("out_proj", "lfm2_outproj_s"))


class Program:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from moai_tpu_torch.entry import build_lfm2_conv
        from moai_tpu_torch.models.lfm2 import Lfm2ConvDims
        ck = cfg["ckks"]
        self.num_x, self.num_row = traffic["inputs_per_pass"], \
            traffic["tokens"]
        lo, hi = traffic["lengths"]
        if (lo, hi) != (self.num_row // 2, self.num_row):
            raise ValueError(f"the program draws lengths U{{"
                             f"{self.num_row // 2}..{self.num_row}}}, not "
                             f"U{{{lo}..{hi}}}")
        self.items = self.num_x
        H, L = cfg["hidden_size"], cfg["conv_L_cache"]
        self.conv = build_lfm2_conv(
            logN=ck["logN"], n_data_levels=ck["n_data_levels"],
            dims=Lfm2ConvDims(H, L, tuple(cfg["held_channels"]), self.num_x,
                              self.num_row),
            input_count=self.num_x, seed=seed, device=device,
            weights=ref.weights(seed, H, L))
        check_chain(self.conv.ctx, cfg)
        self.ev = self.conv.ev

    @property
    def x_data(self):
        return self.conv.x_data

    def run(self):
        return self.conv.fn(self.conv.x_data)

    def instrument(self, spans: dict, sync):
        """Synchronised spans around the mixer's in_proj, both gates, the
        shift conv and out_proj; returns (before each pass, undo)."""
        mixer = self.conv.mixer

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

        for attr, key in SPANS:
            setattr(mixer, attr, wrap(getattr(mixer, attr), key))

        def undo():
            for attr, _ in SPANS:
                delattr(mixer, attr)
        return (lambda: None), undo

    def free(self) -> None:
        del self.conv, self.ev


def reference(cfg: dict, traffic: dict, seed: int, dtype=torch.float64,
              device="cpu") -> torch.Tensor:
    """The share's partial y as the plain reference computes it, in
    ``dtype``, from the benchmark's own draws."""
    lo, hi = traffic["lengths"]
    H, L = cfg["hidden_size"], cfg["conv_L_cache"]
    lens, h = ref.inputs(seed, traffic["inputs_per_pass"],
                         traffic["tokens"], H, lo, hi)
    return ref.share_output(h, ref.weights(seed, H, L), lens,
                            tuple(cfg["held_channels"]), dtype=dtype,
                            device=device)


def judge_spec(cfg: dict, traffic: dict, seed: int) -> dict:
    """What the judge reads besides the output: the seed, the sizes and
    the primes; the output's columns under the head judge's name."""
    ck = cfg["ckks"]
    return {"seed": seed, "N": 1 << ck["logN"],
            "hamming_weight": ck["hamming_weight"],
            "q_primes": cfg["q_primes"], "out_limbs": cfg["out_limbs"],
            "head_dim": cfg["hidden_size"],
            "num_x": traffic["inputs_per_pass"], "num_row": traffic["tokens"]}


judge, pack = head_ref.judge, head_ref.pack


def setup(cfg: dict, traffic: dict, seed: int, device) -> Program:
    return Program(cfg, traffic, seed, device)
