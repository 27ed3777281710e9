"""Run one cell of the benchmark of dbgtpu_torch on the cards of this
machine and print its result as the last line of standard output.

    python3 benchmark/run.py --workload ecoli.warm --seed 7 --seconds 20 --trace 0

Exit codes: 0 a result was printed (its `correct` may be false); 1 no
card, or fewer than the cell asks for; 2 a bad argument; 3 a forbidden
module (JAX, jaxlib, flax or the JAX package dbgtpu) was loaded, or the
reference imports the program; 4 the run failed before a result.
"""

import os
import sys
import time

T_START = time.monotonic()


def _process_start() -> float:
    """The process's start on time.monotonic()'s clock (both count from
    the boot), or this module's first line where /proc does not say or
    its clock does not agree (more than 10 s before that line)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        t = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return T_START
    return t if 0 <= T_START - t <= 10 else T_START


T_PROCESS = _process_start()


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHES = os.path.join(ROOT, "build", "benchmark", "cache")
# every build cache of the program inside the checkout, at fixed paths
# (the kernel library builds into build/dbgtpu_torch/ by itself; torch's
# extension and Triton caches are set for a program that comes to use them)
os.environ["DBGTPU_NATIVE_CACHE"] = os.path.join(CACHES, "native")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHES, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHES, "triton")
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    import argparse
    import json

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    import torch

    from benchmark import harness

    try:
        cell, _, _ = harness.cell_parts(harness.load_spec(), args.workload)
    except KeyError as e:
        print(e, file=sys.stderr)
        return 2
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), t_process=T_PROCESS)
    except harness.Forbidden as e:
        print(f"forbidden: {e}", file=sys.stderr)
        return 3
    except Exception:       # no result without a whole run
        import traceback

        traceback.print_exc()
        return 4
    bad = harness.forbidden_modules()
    if bad:
        print("forbidden: loaded " + ", ".join(bad), file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
