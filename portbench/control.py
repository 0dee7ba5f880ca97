#!/usr/bin/env python3
"""The control of ``correct``: the reference in the program's place,
computed in the precision below the configuration's (TF32 for float32 with
TF32 off), judged by the same comparison as a run.

    python3 portbench/control.py --workload clustered1m-pq.batch32 \\
        --seeds 1,2,3

For each seed it makes the cell's corpus and the queries of the window's
first ``sample`` calls, answers them with ``reference.control_search`` and
prints one JSON line with the numbers ``compare`` gives.  A control that
the check does not refuse means the check cannot see a drop in precision.
It needs no program; it runs on the card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[0:1] = [str(ROOT)]


def control_numbers(root: Path, workload: str, seed: int,
                    device: str) -> dict:
    import numpy as np
    import torch

    from portbench import harness, reference, synth
    rc = harness.resolve(Path(root), workload)
    cfg, traffic = rc.cfg, rc.traffic
    k = int(traffic["k"])
    driver = harness.load_module(rc.driver, "driver")
    x = synth.corpus(cfg, device)
    x_np = x.to("cpu", copy=True).numpy()
    supply = driver.supply(cfg, x_np, seed, traffic, synth.QUERIES)
    qs = torch.from_numpy(np.concatenate(
        [supply.next().reshape(-1, cfg["d"])
         for _ in range(int(traffic["sample"]))])).to(device)
    dists, ids = reference.control_search(x, qs, k)
    check = cfg["check"]
    out = reference.compare(x, qs, ids, dists, k,
                            exact_rows=check["exact_rows"],
                            exact_tol=check.get("exact_tol", 0.0))
    return {"workload": workload, "seed": seed, "queries": qs.shape[0],
            **{name: out[name] for name in check["limits"]},
            "limits": check["limits"], "recall": out["recall"],
            "recall_min": min(out["recalls"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(control_numbers(ROOT, args.workload, seed, "cuda")),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
