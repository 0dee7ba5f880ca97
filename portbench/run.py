#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one card.

    python3 portbench/run.py --workload clustered1m-pq.batch32 --seed 7 \\
        --seconds 10 --trace 0

Runs one cell of ``BENCHMARK.json`` from the root of a checkout and prints
one JSON object as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` and ``checks`` (each
number compared with the plain reference, beside its limit), with
``--trace 1`` also ``breakdown``.  The numbers compared are also the last
lines of standard error.  Without a CUDA card, or with fewer cards than the
cell asks for, it exits 2 and prints no result.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root, not this folder, and the port's sources
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    with open(ROOT / "BENCHMARK.json") as f:
        cells = {w["name"]: w for w in json.load(f)["workloads"]}
    if args.workload not in cells:
        print(f"portbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available():
        print("portbench: torch.cuda.is_available() is False; the benchmark "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} cards, the host has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from portbench import harness
    harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                     bool(args.trace), device="cuda", t_start=T_START)
    return 0


if __name__ == "__main__":
    sys.exit(main())
