"""The readings that a cell's limits are set from (not run by the
benchmark's own runs): for each seed, one run of the cell at its own load
for ``--seconds`` seconds, every answer judged as the program served it and
as the control serves it (the traffic's judge's ``control``: for ``paths``,
the reference in the program's place, its states computed in bfloat16). One
process reads every seed. Prints a JSON line a seed:

    python3 -m portbench.readings --workload demo.single --seeds 101,102,103 --seconds 10
"""

import argparse
import json
import sys

from portbench import cells, run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, required=True)
    a = p.parse_args(argv)
    cell = cells.load_cell(a.workload)
    judge = cells.reader("judges", cell.traffic["judge"], cell.base)
    for seed in (int(s) for s in a.seeds.split(",")):
        args = argparse.Namespace(workload=a.workload, seed=seed, seconds=a.seconds,
                                  trace=0)
        part = run.run_once(args, cell)
        attempted = sum(c.problems for c in part["calls"])
        program = judge.read(part["answers"], attempted, cell.config)
        control = judge.read(judge.control(part["answers"], cell.config), attempted,
                             cell.config)
        print(json.dumps({"workload": a.workload, "seed": seed, "attempted": attempted,
                          "program": program, "control": control}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
