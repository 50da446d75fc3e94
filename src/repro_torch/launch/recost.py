"""Offline re-costing: recompute the cost fields of the port's dry-run
JSONs from their archived op logs (``results/torch/oplog/``) without
running any step (port of ``repro.launch.recost``).

  PYTHONPATH=src python -m repro_torch.launch.recost --out results/torch/dryrun --log results/torch/oplog
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os

from .dryrun import cost_fields
from .op_cost import cost_log

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/torch/dryrun")
    ap.add_argument("--log", default="results/torch/oplog")
    args = ap.parse_args(argv)

    n = 0
    for jpath in sorted(glob.glob(os.path.join(args.out, "*.json"))):
        tag = os.path.basename(jpath)[:-5]
        lpath = os.path.join(args.log, tag + ".oplog.json.gz")
        if not os.path.exists(lpath):
            print(f"no op log for {tag}; skip")
            continue
        with gzip.open(lpath, "rt") as f:
            oc = cost_log(json.load(f))
        with open(jpath) as f:
            rec = json.load(f)
        cost_fields(rec, oc, rec["model_ways"])
        with open(jpath, "w") as f:
            json.dump(rec, f, indent=1)
        n += 1
        print(f"recosted {tag}: flops/dev="
              f"{rec['cost']['flops_per_device']:.3g} "
              f"bytes/dev={rec['cost']['bytes_per_device']:.3g}")
    print(f"{n} cells recosted")


if __name__ == "__main__":
    main()
