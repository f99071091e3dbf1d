#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card.

    python3 portbench/readings.py --workload <cell> --seeds 11,12,... \
        [--steps 4] [--control-seeds 11,12,13]

For each seed, in one process: the program at the cell's own sizes and
load for ``--steps`` steps, its kept outputs compared with the reference
(the readings of every number, one an output); then, for the control seeds,
the same with the driver's control in the program's place.  Prints one
JSON line a run and, last, the largest program reading and the smallest
control reading of each number.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import run  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    for key, path in run.CACHE_ENV.items():
        run.os.environ[key] = str(path)
    worst, least = {}, {}
    plan = [(int(s), False) for s in args.seeds.split(",") if s]
    plan += [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, control in plan:
        res, info = run.run_cell(args.workload, seed, 0, False, args.device,
                           control=control, steps=args.steps, judge=False)
        side = "control" if control else "program"
        got = {k: max(v) for k, v in info["numbers"].items()}
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "side": side, "numbers": got,
                          "outputs": len(next(iter(
                              info["numbers"].values()))),
                          "kind": res["device"]["kind"],
                          "power_limit": res["device"]["power_limit"]}),
              flush=True)
        for k, v in got.items():
            if control:
                least[k] = min(least.get(k, v), v)
            else:
                worst[k] = max(worst.get(k, v), v)
    print(json.dumps({"workload": args.workload, "lower": worst,
                      "upper": least}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
