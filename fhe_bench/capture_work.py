"""Records the frozen work of a configuration: the primitive calls of one
pass, by level, into ``fhe_bench/work/<config>.json``.

    python3 fhe_bench/capture_work.py --workload <cell> --seed <n> \\
        [--out <file>]

Sets the cell's program up, runs one pass with ``trace.Recorder`` on
``Evaluator.debug`` and on the CPMM's digit GEMM and the bootstrap's
diagonal MAC, and writes the records with the context's sizes (N, L, K,
alpha, the digit ranges) and the batch they were taken at.  ``mfu.*``
reads that file and never the current code's launches, so the share
reads the same work whatever later implements it.  Run once, on the card,
at the cell's own configuration; the file is then part of the yardstick.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def capture(cell_name: str, seed: int, device="cuda", root=ROOT) -> dict:
    import torch
    from fhe_bench import core, trace
    bench = core.Bench(root)
    cell = bench.cell(cell_name)
    cfg = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    prog = bench.kind(cfg["kind"]).setup(cfg, traffic, seed,
                                         torch.device(device))
    rec = trace.Recorder()
    undo = trace.wrap_module_ops(rec)
    prog.ev.debug = rec
    try:
        out = prog.run()
        trace.sync(torch.device(device))
        del out
    finally:
        prog.ev.debug = None
        undo()
    ctx = prog.ev.ctx
    return {"config": cell["config"], "captured_from": cell_name,
            "batch": traffic.get("batch", prog.items),
            "ctx": {"N": ctx.cfg.N, "L": ctx.L, "K": ctx.K,
                    "alpha": ctx.alpha,
                    "digit_ranges": [list(r) for r in ctx.digit_ranges]},
            "records": rec.records()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    work = capture(args.workload, args.seed)
    out = Path(args.out or ROOT / "fhe_bench" / "work"
               / f"{work['config']}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(work, indent=1) + "\n")
    print(json.dumps({"wrote": str(out), "records": len(work["records"])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
