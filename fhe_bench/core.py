"""The harness: one run of one cell, driven by the files the cell names.

``BENCHMARK.json`` names the cell (a ``workloads`` entry), its
configuration (a ``configs`` entry and its file) and its traffic
(``fhe_bench/traffic/<traffic>.json``).  The configuration's ``kind``
names the module ``fhe_bench/kinds/<kind>.py`` that sets the program up,
runs one pass and names its reference and judge.  Each per-layer metric is
read by ``fhe_bench/metrics/<name>.py``, or, where that file is absent, by
the file of its name up to the first dot (``idle_share.head`` ->
``idle_share.py``).  Adding a cell, a configuration or a per-layer metric
adds files and entries; no code here changes.

A run: set-up (imports, the program's set-up, two warm-up passes of the
cell's batch); the window, closed loop, one pass at a time, each ending in
a synchronise, for ``seconds``; with ``trace``, after the window, whole
passes under the profiler and one pass with synchronising spans; then the
program's state freed and its last output judged against the plain
reference.  ``run`` returns the result; ``run.py`` prints it.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

import torch

from fhe_bench import trace
from fhe_bench.reference import ckks

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
GIB = float(1 << 30)
P95_MIN_PASSES = 20
PROFILE_PASSES = 2
CONTROL_SCALE = 2.0 ** 40


def log(*a) -> None:
    print("[fhe_bench]", *a, file=sys.stderr, flush=True)


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """BENCHMARK.json and the files it names, under ``root``."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / "fhe_bench"

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def kind(self, name: str):
        return _load_module(self.dir / "kinds" / f"{name}.py",
                            f"fhe_bench_kind_{name}")

    def metrics(self, cell: str, section: str) -> list[dict]:
        """The ``section`` metrics ("end_to_end" or "per_layer") this cell
        reports."""
        return [m for m in self.spec[section]
                if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        path = self.dir / "metrics" / f"{metric}.py"
        if not path.exists():
            path = self.dir / "metrics" / f"{metric.split('.')[0]}.py"
        return _load_module(path, "fhe_bench_metric_"
                            + path.stem.replace(".", "_")).read

    def work(self, config: str) -> dict | None:
        path = self.dir / "work" / f"{config}.json"
        return json.loads(path.read_text()) if path.exists() else None


def _checksum(out) -> torch.Tensor:
    """A pass's fingerprint, computed on the device without a sync."""
    return torch.sum(out.data, dtype=torch.int64)


def warm_up(prog, device) -> None:
    """Two passes of the cell's batch, the first one's output held while
    the second runs, as the window holds the last output while it runs the
    next: every kernel is built and the allocator holds what a pass in the
    window asks of it."""
    out = prog.run()
    out2 = prog.run()
    trace.sync(device)
    del out, out2


def window(prog, seconds: float, device) -> dict:
    """Closed loop for ``seconds``: one pass at a time, each ending in a
    synchronise.  Returns pass times, the window's length (start to the
    end of its last pass), the last output and the passes' fingerprints."""
    times, sums = [], []
    t0 = time.perf_counter()
    deadline, out = t0 + seconds, None
    while True:
        a = time.perf_counter()
        out = prog.run()
        sums.append(_checksum(out))
        trace.sync(device)
        b = time.perf_counter()
        times.append(b - a)
        if b >= deadline:
            break
    return {"times": times, "span": b - t0, "out": out,
            "sums": torch.stack(sums).cpu()}


def traced(prog, device) -> dict:
    """After the window: whole passes under the profiler, then one pass
    with the synchronising spans and the evaluator's recorder (so the
    spans' syncs never fall inside the profiled passes)."""
    rec = {"profile": None, "spans": {}, "keyswitches": None}
    if device.type == "cuda":
        rec["profile"] = trace.profile_passes(prog.run, PROFILE_PASSES,
                                              device)
    spans = {}
    recorder = trace.Recorder()
    before, undo = prog.instrument(spans, lambda: trace.sync(device))
    prog.ev.debug = recorder
    try:
        before()
        out = prog.run()
        trace.sync(device)
        del out
    finally:
        prog.ev.debug = None
        undo()
    rec["spans"] = spans
    rec["keyswitches"] = recorder.keyswitches()
    return rec


def end_to_end(name: str, kind, run: dict) -> float | None:
    """The end-to-end metrics, the same way in every cell; a name with a
    suffix (``boot_cts_per_s.b2``) is its base metric under another
    bound."""
    name = name.split(".")[0]
    if name == "setup_s":
        return run["setup_s"]
    if name == kind.RATE:
        return len(run["times"]) * run["items"] / run["span"]
    if name == "pass_p95_s":
        if len(run["times"]) < P95_MIN_PASSES:
            return None
        return statistics.quantiles(run["times"], n=20,
                                    method="inclusive")[-1]
    if name == "peak_mem_gib" and run["peak_bytes"] is not None:
        return run["peak_bytes"] / GIB
    return None


def judge(kind, cfg, traffic, seed, out_data, out_scale, sums, device
          ) -> dict:
    """{number: (value, limit)}: the kind's judge of the last output
    against the plain reference, and the passes whose fingerprint differs
    from the last one's."""
    want = kind.reference(cfg, traffic, seed, device=device)
    got = kind.judge(out_data, out_scale, kind.judge_spec(cfg, traffic, seed),
                     want)
    got["pass_mismatch"] = int((sums != sums[-1]).sum())
    limits = cfg["limits"]
    return {k: (got[k], limits[k]) for k in limits}


def run(cell_name: str, seed: int, seconds: float, trace_on: bool,
        device="cuda", root: Path = ROOT, t_start: float | None = None
        ) -> dict:
    """One run of a cell; returns the result (the contract's line)."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = Bench(root)
    cell = bench.cell(cell_name)
    cfg = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    kind = bench.kind(cfg["kind"])
    device = torch.device(device)
    cuda = device.type == "cuda"

    prog = kind.setup(cfg, traffic, seed, device)
    warm_up(prog, device)
    setup_s = time.perf_counter() - t_start
    peak_setup = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    log(f"set-up {setup_s:.3f} s, {peak_setup / GIB:.3f} GiB peak")
    w = window(prog, seconds, device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    t = w["times"]
    log(f"window {w['span']:.3f} s, {len(t)} passes (s): "
        f"{json.dumps([round(x, 4) for x in t])}; peak "
        f"{(peak or 0) / GIB:.3f} GiB, reserved "
        f"{(torch.cuda.max_memory_reserved(device) if cuda else 0) / GIB:.3f}"
        f" GiB")
    rec = traced(prog, device) if trace_on else None
    e2e = {"setup_s": setup_s, "times": w["times"], "span": w["span"],
           "items": prog.items, "peak_bytes": peak}
    out_data, out_scale, sums = w["out"].data, w["out"].scale, w["sums"]
    prog.free()
    del prog, w
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = judge(kind, cfg, traffic, seed, out_data, out_scale, sums,
                   device)
    correct = all(v <= lim for v, lim in checks.values())

    result = {"correct": correct, "attempted": len(e2e["times"]),
              "failed": 0 if correct else len(e2e["times"])}
    metrics = {}
    if not trace_on:
        for m in bench.metrics(cell_name, "end_to_end"):
            v = end_to_end(m["name"], kind, e2e)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        rec.update(items=e2e["items"], batch=traffic.get("batch",
                                                         e2e["items"]),
                   pass_s=statistics.fmean(e2e["times"]),
                   work=bench.work(cell["config"]))
        for m in bench.metrics(cell_name, "per_layer"):
            v = bench.reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = device_info(device, max(peak_setup, peak or 0))
    if rec is not None and rec["profile"] is not None:
        prof = rec["profile"]
        log("profile: port kernels (s, count)", json.dumps(prof["port"]),
            "launches", json.dumps(prof["launches"]), "spans",
            json.dumps(rec["spans"]))
        result["device"].update(busy_s=prof["busy_s"],
                                window_s=prof["window_s"])
        result["breakdown"] = {"device_ops": prof["top"],
                               "idle_gaps": prof["gaps"]}
        result["profile_matched"] = prof["matched"]
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def device_info(device, peak_bytes: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(peak_bytes)}


def control(kind, cfg, traffic, seed, device) -> dict:
    """The control, judged as a run judges the program's output: the
    plain reference computed in the configuration's ``control_dtype``
    (the precision below the one it states), put in the program's place
    as the ciphertext (m, 0) of its values on the output's limbs.
    Returns {number: (value, limit)}."""
    low = kind.reference(cfg, traffic, seed,
                         dtype=getattr(torch, cfg["control_dtype"]),
                         device=device)
    spec = kind.judge_spec(cfg, traffic, seed)
    data = ckks.trivial_ciphertext(kind.pack(low, spec), CONTROL_SCALE,
                                   cfg["q_primes"][:cfg["out_limbs"]])
    del low
    return judge(kind, cfg, traffic, seed, data, CONTROL_SCALE,
                 torch.zeros(1, dtype=torch.int64), device)
