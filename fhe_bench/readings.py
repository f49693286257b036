"""The readings a limit of ``correct`` is set from, for one cell.

    python3 fhe_bench/readings.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 4,5,6]

For each seed in one process: the program set up from the seed, one pass
of the timed path, the program freed and the output judged as a run
judges it (the lower readings); for each control seed, the control (the
plain reference in the configuration's ``control_dtype``, put in the
program's place and judged as a run judges it) at the cell's own size
(the upper readings).  One JSON line each.  Runs on the card.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from fhe_bench import core, trace
    dev = torch.device("cuda")
    bench = core.Bench(ROOT)
    cell = bench.cell(args.workload)
    cfg = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    kind = bench.kind(cfg["kind"])
    for s in [int(x) for x in args.control_seeds.split(",") if x]:
        checks = core.control(kind, cfg, traffic, s, dev)
        print(json.dumps({"seed": s, "control": cfg["control_dtype"],
                          "correct": all(v <= lim for v, lim in
                                         checks.values()),
                          "checks": {k: v for k, (v, _) in checks.items()}}),
              flush=True)
    for s in [int(x) for x in args.seeds.split(",") if x]:
        t0 = time.perf_counter()
        prog = kind.setup(cfg, traffic, s, dev)
        t1 = time.perf_counter()
        out = prog.run()
        trace.sync(dev)
        t2 = time.perf_counter()
        data, scale = out.data, out.scale
        prog.free()
        del prog, out
        gc.collect()
        torch.cuda.empty_cache()
        checks = core.judge(kind, cfg, traffic, s, data, scale,
                            torch.zeros(1, dtype=torch.int64), dev)
        del data
        print(json.dumps({"seed": s, "setup_s": t1 - t0,
                          "first_pass_s": t2 - t1,
                          "checks": {k: v for k, (v, _) in checks.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
