"""The readings that the limits of `correct` are set from: for each seed,
one short run of the cell as the program runs it, and one of its
control, the program's own lower setting (one mismatch fewer than the
configuration states, `-m`), which the comparison has to refuse.  One
process for all seeds; one JSON line per run.  The benchmark's own runs
never run the control.

    python3 benchmark/control.py --workload ecoli.warm --seeds 1,2,3 --seconds 3
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHES = os.path.join(ROOT, "build", "benchmark", "cache")
os.environ["DBGTPU_NATIVE_CACHE"] = os.path.join(CACHES, "native")
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--sides", default="program,control")
    args = p.parse_args(argv)

    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    bad = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        for side in args.sides.split(","):
            r = harness.run_cell(args.workload, seed, args.seconds, False,
                                 control=side == "control")
            bad += (side == "program") != r["correct"]
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "side": side, "correct": r["correct"],
                              "attempted": r["attempted"],
                              "compared": {k: v["value"] for k, v in
                                           r["compared"].items()}}),
                  flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
