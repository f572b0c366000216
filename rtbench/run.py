"""Run one cell of the benchmark once and print its result line.

    python3 rtbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It needs as many CUDA cards as the cell asks
for (else it exits non-zero and prints no result), keeps every build
inside the checkout, and prints as its last line of standard output one
JSON object: correct, attempted, failed, metrics (the cell's end-to-end
metrics, or with --trace 1 its per-layer ones), device, with --trace 1 a
breakdown, and last the numbers compared with their limits (also the last
lines of standard error).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # Caches of anything that compiles stay at fixed paths in the checkout.
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / "rtbench" / sub)
    from rtbench.harness import cell as cell_mod
    from rtbench.harness import registry

    bench = registry.load(ROOT)
    cell = bench.cell(args.workload)
    import torch

    torch.set_num_threads(1)  # one host thread drives the card: steadier runs
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"rtbench: {cell.name} needs {cell.chips} CUDA card(s); this machine has {n}",
              file=sys.stderr)
        return 2
    torch.cuda.init()
    print(f"rtbench: torch and the card ready at {time.perf_counter() - T_START:.3f} s",
          file=sys.stderr)
    result = cell_mod.execute(bench, cell, args.seed, args.seconds, bool(args.trace), T_START)
    bad = cell_mod.forbidden_modules()
    if bad:
        print(f"rtbench: modules loaded that must not be: {bad}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
