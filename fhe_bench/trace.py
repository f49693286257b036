"""What the traced run records: the device profile of whole passes, the
program's launch counters, spans, and the primitives the evaluator runs.

``profile_passes`` traces CUDA activity only (the host's ops are left
alone, so the trace costs the host nothing per op) and reads the raw
kineto events, as the port's smoke run does: device time by kernel, the
busy time as the union of the activity intervals, the idle gaps between
them, and the port's own kernels (``ntt_*``, ``limb_ew``, ``base_conv``,
``ks_mac``, ``diag_mac``) by name, to hold against the launch counters.

``Recorder`` hangs on ``Evaluator.debug``, which the evaluator calls with
each primitive's name and result: relinearize, apply_galois,
rotate_hoisted (its result holds one ciphertext per rotation on a new
leading axis), multiply, multiply_plain, rescale, mod_drop_to.  With
``wrap_module_ops`` it also records the three primitives that bypass the
evaluator: the CPMM's digit GEMM (``ops.matmul.mod_matmul``), the CCMMs'
summed dyadic products (``ops.matmul._dyadic_sum``) and the bootstrap's
diagonal MAC (``mod_arith.diag_mac``).
"""

from __future__ import annotations

import time
from collections import Counter

import torch

PORT_KERNELS = ("ntt_", "limb_ew", "base_conv", "ks_mac", "diag_mac")
# an NTT call is two device kernels (ntt_cuda)
NTT_KERNELS_PER_LAUNCH = 2


def kernel_name(key: str) -> str:
    """A profiler name without namespace, return type, arguments and
    template arguments."""
    return key.replace("(anonymous namespace)::", "").replace(
        "void ", "").split("(")[0].split("<")[0].strip()


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _summary(prof, wall: float, passes: int) -> dict:
    from torch.autograd import DeviceType
    spans, by_name = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        start, dur = e.start_ns(), e.duration_ns()
        spans.append((start, start + dur, e.name()))
        acc = by_name.setdefault(e.name(), [0, 0])
        acc[0] += dur
        acc[1] += 1
    spans.sort()
    busy, gaps, end, prev = 0, [], None, None
    for s, t, name in spans:
        if end is not None and s > end:
            gaps.append(((s - end) / 1e9, f"after {kernel_name(prev)[:60]} "
                         f"before {kernel_name(name)[:60]}"))
        if end is None or s > end:
            busy += t - s
            end, prev = t, name
        elif t > end:
            busy += t - end
            end, prev = t, name
    kernels = {n: v for n, v in by_name.items()
               if not n.startswith(("Memcpy", "Memset"))}
    port = {}
    for n, (ns, cnt) in kernels.items():
        k = kernel_name(n)
        if k.startswith(PORT_KERNELS):
            acc = port.setdefault(k, [0.0, 0])
            acc[0] += ns / 1e9
            acc[1] += cnt
    merged = {}
    for n, (ns, _) in by_name.items():
        merged[kernel_name(n)[:80]] = merged.get(kernel_name(n)[:80], 0) + ns
    top = sorted(((ns / 1e9, n) for n, ns in merged.items()),
                 reverse=True)[:10]
    return {"window_s": wall, "busy_s": busy / 1e9, "passes": passes,
            "kernels": sum(c for _, c in kernels.values()),
            "port": port,
            "top": [[n, s] for s, n in top],
            "gaps": [[n, s] for s, n in sorted(gaps, reverse=True)[:10]]}


def launch_counts() -> tuple[dict, dict]:
    """The program's launch counters and base_conv/ks_mac launch shapes
    since they were last reset."""
    from moai_tpu_torch import limb_cuda, ntt_cuda
    return ({**ntt_cuda.launches, **limb_cuda.launches},
            {k: dict(v) for k, v in limb_cuda.shapes.items()})


def reset_launches() -> None:
    from moai_tpu_torch import limb_cuda, ntt_cuda
    ntt_cuda.reset_launches()
    limb_cuda.reset_launches()


def expected_port_kernels(launches: dict) -> int:
    return sum(v * (NTT_KERNELS_PER_LAUNCH if k.startswith("ntt_") else 1)
               for k, v in launches.items())


def profile_passes(run, passes: int, device: torch.device,
                   tries: int = 3) -> dict:
    """``passes`` whole passes under torch.profiler (CUDA activity), with
    the launch counters reset before: the summary, with the counters and
    the launch shapes of the same passes.  The tracer can drop records:
    a trace whose count of the port's kernels differs from the counters is
    taken again, at most ``tries`` times, and marked ``matched`` False if
    none agrees."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        sync(device)
        reset_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(passes):
                out = run()
                del out
            sync(device)
            wall = time.perf_counter() - t0
        launches, shapes = launch_counts()
        summ = _summary(prof, wall, passes)
        summ.update(launches=launches, shapes=shapes)
        got = sum(c for _, c in summ["port"].values())
        summ["matched"] = got == expected_port_kernels(launches)
        if summ["matched"]:
            break
    return summ


class Recorder:
    """Evaluator.debug hook and module-op wrapper: counts each primitive
    call by (op, B, n_q, and R, J, I, P or terms where the op has them);
    n_q is the result's limbs (a rescale's input has one more)."""

    def __init__(self):
        self.calls: Counter = Counter()

    def __call__(self, op: str, ct) -> None:
        shape = tuple(ct.data.shape)
        key = {"op": op, "n_q": shape[-2]}
        lead = shape[:-3]
        if op == "rotate_hoisted":
            key["R"], lead = lead[0], lead[1:]
        key["B"] = _numel(lead)
        self.calls[tuple(sorted(key.items()))] += 1

    def record(self, **key) -> None:
        self.calls[tuple(sorted(key.items()))] += 1

    def keyswitches(self) -> int:
        """Key switches: one per relinearize and apply_galois, one per
        rotation of a hoisted call."""
        n = 0
        for key, c in self.calls.items():
            k = dict(key)
            if k["op"] in ("relinearize", "apply_galois"):
                n += c
            elif k["op"] == "rotate_hoisted":
                n += c * k["R"]
        return n

    def records(self) -> list[dict]:
        return [dict(key, count=c) for key, c in sorted(self.calls.items())
                if dict(key)["op"] != "mod_drop_to"]


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def wrap_module_ops(rec: Recorder):
    """Record the CPMM digit GEMM and the diagonal MAC into ``rec``;
    returns the function that undoes it."""
    from moai_tpu_torch import mod_arith
    from moai_tpu_torch.ops import matmul
    mm, dm, ds = matmul.mod_matmul, mod_arith.diag_mac, matmul._dyadic_sum

    def mod_matmul(x, w_digits, *a, **k):
        J, P, n, _ = x.shape
        rec.record(op="mod_matmul", B=1, n_q=n, J=J, P=P,
                   I=w_digits.shape[-1])
        return mm(x, w_digits, *a, **k)

    def diag_mac(cts, pts, *a, **k):
        shape = tuple(cts[0].shape)
        rec.record(op="diag_mac", B=_numel(shape[:-3]), n_q=shape[-2],
                   terms=len(cts))
        return dm(cts, pts, *a, **k)

    def dyadic_sum(x0, x1, y0, y1, dim, *a, **k):
        shape = torch.broadcast_shapes(x0.shape, y0.shape)
        rec.record(op="dyadic_sum", B=1, n_q=shape[-2], X=x0.numel(),
                   Y=y0.numel(), P=_numel(shape),
                   O=_numel(shape) // shape[dim])
        return ds(x0, x1, y0, y1, dim, *a, **k)

    matmul.mod_matmul, mod_arith.diag_mac = mod_matmul, diag_mac
    matmul._dyadic_sum = dyadic_sum

    def undo():
        matmul.mod_matmul, mod_arith.diag_mac = mm, dm
        matmul._dyadic_sum = ds
    return undo


def kernel_roofline(rec: dict, kernel: str) -> float | None:
    """A limb kernel's share of its roofline in the profiled passes: the
    sum of its launches' bounds (``work.cost.kernel_bound_s`` of each
    launch shape the counters recorded) over its device time there, in %;
    None without a profile whose kernel count agrees with the counters, or
    without a launch."""
    from fhe_bench.work import cost
    prof = rec.get("profile")
    if not prof or not prof["matched"] or kernel not in prof["port"]:
        return None
    shapes = prof["shapes"].get(kernel, {})
    bound = sum(n * cost.kernel_bound_s(kernel, s) for s, n in shapes.items())
    secs = prof["port"][kernel][0]
    return 100.0 * bound / secs if bound and secs else None
