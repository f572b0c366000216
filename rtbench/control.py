"""Readings that set a cell's limits: the program on many seeds, the
control (the reference in bfloat16 in the program's place) and the planted
faults on a few, all in one process at the cell's own size.

    python3 rtbench/control.py --workload <cell> --seeds 12 --control-seeds 3 --seconds 3

Each line of output is one run's compared numbers as JSON ("kind" is
"program", "control" or a fault's name); `--out` also writes them to a
file. The benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from rtbench.harness import cell as cell_mod  # noqa: E402
from rtbench.harness import program, registry  # noqa: E402

#: The faults each kind of cell can have.
FAULTS = {"train": ("frozen", "half_batch"), "render": ("altered",)}


def readings(bench, cell, seeds, control_seeds, seconds, device="cuda", traffic=None,
             kinds=None, sink=None):
    """-> list of {"kind", "seed", "correct", numbers...}: the program on
    `seeds`, the control and each fault on `control_seeds` (`kinds` keeps
    only those of these kinds); each also written to `sink` as a JSON line."""
    traffic = traffic or bench.traffic(cell)
    runs = [("program", s) for s in seeds]
    runs += [(k, s) for k in ("control",) + FAULTS[traffic["kind"]] for s in control_seeds]
    if kinds is not None:
        runs = [r for r in runs if r[0] in kinds]
    out = []
    for kind, seed in runs:
        t0 = time.perf_counter()
        fault = kind if kind in program.FAULTS else None
        log = io.StringIO()
        res = cell_mod.execute(bench, cell, seed, seconds, False, t0, device=device,
                               fault=fault, traffic=traffic, control=kind == "control", log=log)
        detail = json.loads(log.getvalue().split("rtbench: ", 1)[1].splitlines()[0])
        rec = {"kind": kind, "seed": seed, "correct": res["correct"],
               **{k: v["value"] for k, v in res["compared"].items()},
               "seconds": time.perf_counter() - t0, "detail": detail}
        out.append(rec)
        if sink is not None:
            print(json.dumps(rec), file=sink, flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--no-faults", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    bench = registry.load(ROOT)
    cell = bench.cell(args.workload)
    seeds = [args.first_seed + 7919 * k for k in range(args.seeds)]
    cseeds = [args.first_seed + 104729 * (k + 1) for k in range(args.control_seeds)]
    sinks = [sys.stdout]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        sinks.append(open(args.out, "a"))

    class Tee:
        def write(self, s):
            for f in sinks:
                f.write(s)

        def flush(self):
            for f in sinks:
                f.flush()

    kinds = ("program", "control") if args.no_faults else None
    readings(bench, cell, seeds, cseeds, args.seconds, kinds=kinds, sink=Tee())
    for f in sinks[1:]:
        f.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
