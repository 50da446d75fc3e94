"""The comparison's two readings for a cell, on several seeds in one
process: what the program gives (the lower reading) and what the control
gives, the plain reference computed at 8-bit weight codes (the precision
below the configurations' signed 9-bit codes) put in the program's place
on the same requests (the upper reading).

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13 \
        --seconds 20

Each seed is one whole run of the cell at its own size and load.  Prints
one JSON line a seed, then a summary: every compared number's largest
program reading and smallest control reading.  The benchmark's own runs
never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from run import ROOT, _environment  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    _environment()
    import torch
    from perfbench import harness
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    low: dict[str, int] = {}
    high: dict[str, int] = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        rec = harness.run_cell(ROOT, args.workload, seed, args.seconds,
                               False, "cuda", time.perf_counter(),
                               control=True)
        prog = {k: c["value"] for k, c in rec["checks"].items()}
        ctrl = {k: c["value"] for k, c in rec["control_checks"].items()}
        for k, v in prog.items():
            low[k] = max(low.get(k, v), v)
        for k, v in ctrl.items():
            high[k] = min(high.get(k, v), v)
        print(json.dumps({"seed": seed, "program": prog, "control": ctrl,
                          "program_correct": all(
                              c["ok"] for c in rec["checks"].values()),
                          "control_correct": all(
                              c["ok"] for c in rec["control_checks"].values()),
                          **rec["counts"],
                          "window_s": rec["window_s"]}), flush=True)
    print(json.dumps({"workload": args.workload, "program_max": low,
                      "control_min": high}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
