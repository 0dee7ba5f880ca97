#!/usr/bin/env python3
"""Run one cell several times, each run its own process, and report each
metric's median and spread.

    python3 portbench/spread.py --workload clustered1m-pq.batch32 \\
        --seeds 11,12,13,14,15,16 --sets 2 --out runs.jsonl

Every set runs the same seeds in the same order.  The spread of a metric is
the distance between its first and third quartile (``statistics.quantiles``
with n=4) as a share of its median.  Each run's result line, exit code,
wall seconds and the compared numbers go to ``--out`` (JSON lines), and a
summary to standard output.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spread(values: list[float]) -> float:
    """Interquartile distance over the median (0 for fewer than 2 values)."""
    if len(values) < 2:
        return 0.0
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else float("inf")


def run_once(workload: str, seed: int, seconds: float, trace: int) -> dict:
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         workload, "--seed", str(seed), "--seconds", str(seconds), "--trace",
         str(trace)], cwd=ROOT, capture_output=True, text=True)
    wall = time.monotonic() - t0
    lines = proc.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        result = None
    notes = [ln for ln in proc.stderr.splitlines()
             if ln.startswith(("portbench: set-up", "portbench: window"))]
    return {"workload": workload, "seed": seed, "trace": trace,
            "rc": proc.returncode, "wall_s": wall, "result": result,
            "notes": notes,
            "stderr_tail": proc.stderr[-3000:] if proc.returncode or not
            (result or {}).get("correct") else proc.stderr[-600:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=None,
                    help="default: BENCHMARK.json's run_seconds")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    with open(ROOT / "BENCHMARK.json") as f:
        seconds = args.seconds or json.load(f)["run_seconds"]
    seeds = [int(s) for s in args.seeds.split(",")]
    out = open(args.out, "a") if args.out else None
    sets: list[list[dict]] = []
    for _ in range(args.sets):
        runs = []
        for seed in seeds:
            rec = run_once(args.workload, seed, seconds, args.trace)
            runs.append(rec)
            res = rec["result"] or {}
            print(json.dumps({"seed": seed, "rc": rec["rc"],
                              "wall_s": round(rec["wall_s"], 1),
                              "correct": res.get("correct"),
                              "metrics": {k: v["value"] for k, v in
                                          res.get("metrics", {}).items()},
                              "checks": {k: v["value"] for k, v in
                                         res.get("checks", {}).items()},
                              "notes": rec["notes"]}),
                  flush=True)
            if rec["rc"] or not res.get("correct"):
                print(rec["stderr_tail"], flush=True)
            if out:
                out.write(json.dumps(rec) + "\n")
                out.flush()
        sets.append(runs)
    for i, runs in enumerate(sets):
        by: dict[str, list[float]] = {}
        for rec in runs:
            for k, v in ((rec["result"] or {}).get("metrics") or {}).items():
                by.setdefault(k, []).append(v["value"])
        for k, vals in by.items():
            print(f"set {i} {k}: median {statistics.median(vals)!r} "
                  f"spread {spread(vals)!r} n {len(vals)}")
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
