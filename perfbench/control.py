"""The readings that a cell's limits are set from: the program's compared
numbers on many seeds, the control's (the plain reference in TF32 in the
program's place) and, for a training cell, its planted faults', all at
the cell's own size, in one process.

    python3 -m perfbench.control --workload <cell> --seeds 11,12,13

Each seed sets the cell up as a run does (a training cell's readings need
no window), frees the program and reads. One JSON line a seed, then the
largest program reading and the smallest control and fault reading of
each number. The benchmark's own runs do not
run this.
"""

from __future__ import annotations

import argparse
import json
import sys

from perfbench.run import run_env, load_cell


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    args = parser.parse_args(argv)
    run_env()
    import torch

    from perfbench import reference
    from perfbench.drivers import DRIVERS

    cell = load_cell(args.workload)
    reference.strict_f32()
    prog_max, ctrl_min = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        driver = DRIVERS[cell["mix"]["kind"]](cell["cfg"], cell["mix"], seed)
        driver.setup()
        driver.finish()
        row = {"seed": seed, "failed": driver.failed,
               "program": driver.checks(), "control": driver.control(),
               "faults": driver.faults()}
        print(json.dumps(row), flush=True)
        for k, v in row["program"].items():
            prog_max[k] = max(prog_max.get(k, 0.0), v)
        for reading in [row["control"], *row["faults"].values()]:
            for k, v in reading.items():
                ctrl_min[k] = min(ctrl_min.get(k, float("inf")), v)
        del driver
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "program_max": prog_max,
                      "control_or_fault_min": ctrl_min,
                      "limits": cell["limits"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
