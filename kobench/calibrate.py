"""Readings that the limits of a cell's check are set from.

    python3 -m kobench.calibrate --workload <cell> [--seeds 12] [--control 3]
        [--faults half_batch,unchanged] [--fault-seeds 3] [--base-seed N]
        [--seconds S]

Runs, in one process (one set of ranks for a cell that spans cards): the
program on `--seeds` seeds, the control (the plain reference in fp8 in the
program's place) on `--control` seeds, and each planted fault
(`kobench/faults.py`) on `--fault-seeds` seeds, and prints every number
the check computes, one line per run, then the largest of each over the
sound runs and the smallest over the control's and each fault's. Training
runs need no window (``--seconds 0``); a serving run takes a short one at
the cell's own load. Writes the table as JSON to
``chiprun_out/calibrate-<cell>.json``. Benchmark runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

from kobench import harness
from kobench.run import cache_env


def _jobs(args) -> list[tuple[str, dict]]:
    seeds = [args.base_seed + 7919 * i
             for i in range(max(args.seeds, args.control, args.fault_seeds))]
    jobs = [("program", {"seed": s}) for s in seeds[: args.seeds]]
    jobs += [("control", {"seed": s, "control": True})
             for s in seeds[: args.control]]
    for fault in filter(None, args.faults.split(",")):
        jobs += [(f"fault:{fault}", {"seed": s, "fault": fault})
                 for s in seeds[: args.fault_seeds]]
    return jobs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--control", type=int, default=3)
    parser.add_argument("--faults", default="")
    parser.add_argument("--fault-seeds", type=int, default=3)
    parser.add_argument("--base-seed", type=int, default=2 ** 31 + 12345)
    parser.add_argument("--seconds", type=float, default=0.0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    root = Path.cwd()
    os.environ.update(cache_env(root))
    cell = harness.load_cell(root, args.workload)
    driver = harness.driver(cell)
    jobs = _jobs(args)
    if hasattr(driver, "run_jobs"):
        outs = driver.run_jobs(cell, [dict(j, seconds=args.seconds, trace=False)
                                      for _, j in jobs], args.device)
        rows = [(kind, j["seed"], o if j.get("control") else o["readings"])
                for (kind, j), o in zip(jobs, outs)]
    else:
        rows = []
        for kind, j in jobs:
            if j.get("control"):
                got = driver.control(cell, j["seed"], args.device)
            else:
                got = driver.run(cell, j["seed"], args.seconds, False,
                                 args.device, j.get("fault"))["readings"]
            rows.append((kind, j["seed"], got))
    table = {}
    for kind, seed, got in rows:
        print(f"calibrate {cell.name} {kind} seed {seed}: {json.dumps(got)}")
        table.setdefault(kind, []).append({"seed": seed, **got})
    for kind, runs in table.items():
        pick = max if kind == "program" else min
        names = [k for k in runs[0] if k != "seed"]
        print(f"calibrate {cell.name} {kind} {pick.__name__} over {len(runs)}: "
              + json.dumps({k: pick(r[k] for r in runs) for k in names}))
    out = root / "chiprun_out" / f"calibrate-{cell.name}.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(table, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
