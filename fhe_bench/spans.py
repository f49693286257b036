"""The program's spans beside the device profile: each idle interval of the
device charged to the span the host was in, and the set-up's spans.

    python3 fhe_bench/spans.py --workload <cell> --seed <n> [--passes 2] \\
        [--cost-passes 2]

The program opens spans at its layer boundaries (``moai_tpu_torch.utils.
debug``: the head's pass, its matmuls and softmax, the host encoder, the
bootstrap's stages, set-up's context and keys); inside ``debug.tracing()``
they are recorded on the host's clock, which ``Trace.epoch_ns`` puts on
the clock of torch.profiler's kineto events.  ``attribute`` then charges
each device-idle interval, piece by piece, to the self interval of the
innermost span that covers it (the span minus its children), and idle
outside every span to ``(outside)``: the idle time by what the host was
doing.

The command sets a cell up inside ``debug.tracing()`` (the set-up's
spans), warms it up as a run does, times ``cost-passes`` whole passes with
the recorder off and as many with it on, in turns (what recording costs
the host), then profiles ``passes`` whole passes (CUDA activity only)
inside ``debug.tracing()`` and prints one JSON line: the idle by span
path, each path's host seconds, idle seconds and launches, the ten
largest idle paths with the kernel pair of each one's largest gap, the
share of idle charged below the pass's root span, the host and idle
seconds a pass in the encoder's spans, the set-up's Galois keys' seconds,
and the NTT, ``limb_ew`` and ``diag_mac`` rooflines of the same passes.
Runs on the card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUTSIDE = "(outside)"
TOP_GAPS = 10
ROOFLINES = ("ntt_roofline", "limb_ew_roofline", "diag_mac_roofline")


def span_rows(trace) -> list[tuple]:
    """(path, parent, start, end, launches) of each closed span of a
    ``debug.Trace``, in the order they opened, start and end in Unix-epoch
    nanoseconds."""
    return [(trace.path(i), s.parent, trace.epoch_ns(s.start_ns),
             trace.epoch_ns(s.end_ns), s.launches)
            for i, s in enumerate(trace.spans) if s.end_ns >= 0]


def device_events(prof) -> list[tuple]:
    """(start, end, name) of each CUDA activity of a torch.profiler run,
    in Unix-epoch nanoseconds, sorted."""
    from torch.autograd import DeviceType
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA)


def idle_intervals(events, t0: int, t1: int) -> list[tuple]:
    """The device's idle intervals in [t0, t1] around ``events`` ((start,
    end, name), sorted), each (start, end, "after <kernel> before
    <kernel>"), "(start)" and "(end)" at the window's edges."""
    from fhe_bench.trace import kernel_name
    out, end, prev = [], t0, "(start)"
    for s, t, name in events:
        if s > end:
            out.append((end, min(s, t1), f"after {prev} before "
                        f"{kernel_name(name)[:60]}"))
        if t > end:
            end, prev = t, kernel_name(name)[:60]
    if t1 > end:
        out.append((end, t1, f"after {prev} before (end)"))
    return [g for g in out if g[1] > g[0]]


def self_segments(rows) -> list[tuple]:
    """(start, end, index) pieces of each span's self interval (the span
    minus its children's intervals), sorted; spans nest, so the pieces are
    disjoint and cover the union of the root spans."""
    children = [[] for _ in rows]
    for i, r in enumerate(rows):
        if r[1] >= 0:
            children[r[1]].append(i)
    segs = []
    for i, (_, _, start, end, _) in enumerate(rows):
        cur = start
        for c in sorted(children[i], key=lambda c: rows[c][2]):
            if rows[c][2] > cur:
                segs.append((cur, rows[c][2], i))
            cur = max(cur, rows[c][3])
        if end > cur:
            segs.append((cur, end, i))
    return sorted(segs)


def attribute(rows, idle) -> dict:
    """{path: [idle seconds, the most of one gap, that gap's label]}: each
    idle interval ((start, end, label), sorted) cut at the self intervals
    of ``rows`` (``span_rows``), each piece charged to its span's path,
    what no span covers to ``OUTSIDE``."""
    segs = self_segments(rows)
    out: dict = {}
    k = 0
    for a, b, label in idle:
        while k < len(segs) and segs[k][1] <= a:
            k += 1
        pieces: dict = {}
        cur, j = a, k
        while cur < b:
            if j < len(segs) and segs[j][0] < b:
                s, e, i = segs[j]
                path, stop = rows[i][0], min(e, b)
                if s > cur:
                    path, stop = OUTSIDE, s
                else:
                    j += 1
            else:
                path, stop = OUTSIDE, b
            pieces[path] = pieces.get(path, 0) + stop - cur
            cur = stop
        for path, ns in pieces.items():
            acc = out.setdefault(path, [0.0, 0.0, ""])
            acc[0] += ns / 1e9
            if ns / 1e9 > acc[1]:
                acc[1], acc[2] = ns / 1e9, label
    return out


def summarise(rows, idle) -> dict:
    """The attribution of ``idle`` to ``rows``, as the benchmark would
    report it: ``idle_by_span`` (path -> s), ``spans`` (path -> [host s,
    idle s, launches], host and launches over every span of the path),
    ``idle_gaps`` (the ``TOP_GAPS`` largest paths, "path | kernel pair of
    its largest gap", s), the idle in all and the share of it charged
    below a root span."""
    charged = attribute(rows, idle)
    spans: dict = {}
    for path, _, start, end, launches in rows:
        acc = spans.setdefault(path, [0.0, 0.0, 0])
        acc[0] += (end - start) / 1e9
        acc[2] += launches
    for path, (s, _, _) in charged.items():
        spans.setdefault(path, [0.0, 0.0, 0])[1] = s
    total = sum(v[0] for v in charged.values())
    below = sum(v[0] for p, v in charged.items() if "/" in p)
    top = sorted(charged.items(), key=lambda kv: -kv[1][0])[:TOP_GAPS]
    return {"idle_by_span": {p: v[0] for p, v in charged.items()},
            "spans": spans,
            "idle_gaps": [[f"{p} | {v[2]}", v[0]] for p, v in top],
            "idle_s": total,
            "below_root_share": below / total if total else None}


def host_in_s(rows, prefix: str) -> float:
    """Host seconds in spans named ``prefix``*, each counted where no
    span above it is of that family (nested spans counted once)."""
    total = 0.0
    for path, _, start, end, _ in rows:
        *above, name = path.split("/")
        if name.startswith(prefix) and \
                not any(n.startswith(prefix) for n in above):
            total += (end - start) / 1e9
    return total


def idle_in_s(idle_by_span: dict, prefix: str) -> float:
    """Idle seconds charged to spans named ``prefix``* or below them."""
    return sum(s for p, s in idle_by_span.items()
               if any(n.startswith(prefix) for n in p.split("/")))


def measure(bench, cell_name: str, seed: int, passes: int,
            cost_passes: int, device) -> dict:
    """The command's measurement of one cell on ``device`` (see the
    module's docstring); returns its JSON line as a dict."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from fhe_bench import core, trace
    from moai_tpu_torch.utils import debug
    cell = bench.cell(cell_name)
    cfg = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    kind = bench.kind(cfg["kind"])

    t = time.perf_counter()
    with debug.tracing() as setup:
        prog = kind.setup(cfg, traffic, seed, device)
    setup_s = time.perf_counter() - t
    core.warm_up(prog, device)
    setup_rows = span_rows(setup)
    split: dict = {}
    for path, _, start, end, _ in setup_rows:
        if "/" not in path:
            split[path] = split.get(path, 0.0) + (end - start) / 1e9

    cost = {"off": [], "on": []}
    for _ in range(cost_passes):
        for mode in ("off", "on"):
            t = time.perf_counter()
            if mode == "on":
                with debug.tracing():
                    out = prog.run()
            else:
                out = prog.run()
            trace.sync(device)
            cost[mode].append(time.perf_counter() - t)
            del out

    trace.sync(device)
    trace.reset_launches()
    # CUDA activity only on the card; the CPU's activity where there is
    # none (a rehearsal: no device events, all idle)
    activity = ProfilerActivity.CUDA if device.type == "cuda" else \
        ProfilerActivity.CPU
    with debug.tracing() as tr:
        with profile(activities=[activity]) as prof:
            t0 = time.perf_counter_ns()
            for _ in range(passes):
                out = prog.run()
                del out
            trace.sync(device)
            t1 = time.perf_counter_ns()
    prog.free()
    summ = trace._summary(prof, (t1 - t0) / 1e9, passes)
    launches, shapes = trace.launch_counts()
    summ.update(launches=launches, shapes=shapes)
    summ["matched"] = sum(c for _, c in summ["port"].values()) == \
        trace.expected_port_kernels(launches)
    rows = span_rows(tr)
    found = summarise(rows, idle_intervals(device_events(prof),
                                           tr.epoch_ns(t0),
                                           tr.epoch_ns(t1)))
    rec = {"profile": summ}
    return {
        "workload": cell_name, "seed": seed,
        "device": core.device_info(device, 0)["kind"],
        "setup_s": setup_s, "setup_split_s": split,
        "galois_keys_s": host_in_s(setup_rows, "keygen.galois"),
        "host_pass_s": {m: statistics.median(v) if v else None
                        for m, v in cost.items()},
        "host_pass_runs_s": cost,
        "passes": passes, "window_s": summ["window_s"],
        "busy_s": summ["busy_s"], "matched": summ["matched"],
        "host_encode_s": host_in_s(rows, "encode") / passes,
        "idle_in_encode_s": idle_in_s(found["idle_by_span"], "encode")
        / passes,
        **{m: bench.reader(m)(rec) for m in ROOFLINES},
        **found}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--cost-passes", type=int, default=2)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from fhe_bench import core
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    result = measure(core.Bench(ROOT), args.workload, args.seed,
                     args.passes, args.cost_passes, torch.device("cuda"))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
