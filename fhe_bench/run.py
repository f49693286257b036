"""The benchmark of moai_tpu_torch, one run of one cell.

    python3 fhe_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for.  Prints, as the last line of its standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared with
the plain reference beside its limit (also the last lines of standard
error).  Exits non-zero and prints no result without enough CUDA cards,
without the package under test beside it, or when JAX or the JAX package
was loaded.  The kernels build into the package's ``_build/`` directory,
inside the checkout, at their first use.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse                                             # noqa: E402
import json                                                 # noqa: E402
import sys                                                  # noqa: E402
from pathlib import Path                                    # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "moai_tpu"}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import torch
    from fhe_bench import core
    import moai_tpu_torch                                   # noqa: F401

    chips = core.Bench(ROOT).cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = core.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), device="cuda", root=ROOT,
                      t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the measuring process: {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
