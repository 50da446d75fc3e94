"""Run one benchmark cell of the PyTorch/CUDA port on this machine's card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  Prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: every number the comparison with the reference held
against its limit, which are also the last lines of standard error.

Exits non-zero without a result when there is no CUDA card (or fewer than
the cell asks for), and when JAX or the JAX package is loaded once the
window has closed.  The port's kernels build into ``build/repro_torch/``
inside the checkout on a run's first launch; every other cache a library
might keep is pointed inside the checkout too.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "perfbench"


def _environment() -> None:
    """Pin what the program would read from the environment: no knob of
    the port (``REPRO_*``: dispatch cache, adaptive controller, fault plan,
    sparse-skip default, density threshold) and fixed cache directories
    inside the checkout."""
    for k in [k for k in os.environ if k.startswith("REPRO_")]:
        del os.environ[k]
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    from perfbench import harness
    cell, _, _ = harness.cell_files(harness.load_benchmark(ROOT),
                                    args.workload)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card and does not "
              "fall back to the CPU", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"the cell asks for {cell['chips']} cards, this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 3
    rec = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", T_START)
    found = harness.jax_loaded()
    if found:
        print(f"JAX or the JAX package is loaded: {found}", file=sys.stderr)
        return 4
    line = harness.result_line(ROOT, rec, bool(args.trace))
    print("setup " + " ".join(f"{k} {v:.3f}s" for k, v in
                              rec["setup_parts"].items()), file=sys.stderr)
    print(f"window {rec['window_s']:.3f}s " + " ".join(
        f"{k} {v}" for k, v in rec["counts"].items()) + " " + " ".join(
              f"{k} {v[0]:.3f}s/{v[1]}" for k, v in rec["spans"].items())
          + f" gc {rec['gc'][1]:.3f}s/{rec['gc'][0]}", file=sys.stderr)
    if "reference_s" in rec:
        print(f"reference {rec['reference_s']:.3f}s", file=sys.stderr)
    ticks = rec.get("ticks") or []
    print("calls by second " + " ".join(
        str(b[1] - a[1]) for a, b in zip(ticks, ticks[1:])), file=sys.stderr)
    for name, c in line["checks"].items():
        rel = ">=" if c["kind"] == "min" else "<="
        print(f"check {name} {c['value']} limit {rel} {c['limit']}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
