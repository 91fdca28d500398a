"""Run a cell with its control in the program's place, on several seeds,
and print what the comparison reads: each line has to read not correct.

    python3 portbench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...] [--device cuda|cpu]

The benchmark's own runs never run it.  The window is the cell's own
load, long enough to compare as many texts as a run does.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import harness
    from portbench.reference.control import CONTROLS, control_driver

    p = harness.plan(args.workload)
    name = p["cell"]["driver"]
    drv = harness._load_file(p["dir"] / "drivers" / f"{name}.py", "portbench_driver_" + name).Driver
    factory = control_driver(drv, CONTROLS[name])
    for seed in args.seeds:
        r = harness.run(args.workload, seed, args.seconds, False, device=args.device, driver_factory=factory)
        print(json.dumps({"control": name, "workload": args.workload, "seed": seed, "correct": r["correct"],
                          "attempted": r["attempted"], "compared": r["compared"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
