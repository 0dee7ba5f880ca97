"""Quickstart with the PyTorch port: build a quantized ANN index and run a
large-k BBC query; the port's counterpart of ``examples/quickstart.py``,
at its sizes (20,000 x 64 synthetic vectors, 141 clusters, k=2000,
n_probe=100, three single queries).

  PYTHONPATH=src python examples/torch_quickstart.py                # card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu

The last stdout line is one JSON object: each query's recall@k,
re-ranked and second-pass counts, and the device it ran on (``run`` also
returns each query's ids).
"""
import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.data import synthetic  # noqa: E402
from repro_torch.index import flat, search  # noqa: E402
from repro_torch.kernels.platform import resolve_device  # noqa: E402

N, D, K, N_CLUSTERS, N_PROBE, N_QUERIES = 20_000, 64, 2_000, 141, 100, 3


def run(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    x_np = synthetic.clustered(rng, N, D)
    x = torch.from_numpy(x_np).to(dev)
    queries = torch.from_numpy(synthetic.queries_from(rng, x_np, N_QUERIES))

    print("building IVF+PQ index ...", flush=True)
    index = search.build_pq_index(x, n_clusters=N_CLUSTERS, device=dev)

    print(f"large-k query (k={K}) with the bucket-based collector (BBC) ...",
          flush=True)
    rows, ids = [], []
    for i, q in enumerate(queries.to(dev)):
        res = search.ivf_pq_search(index, q, k=K, n_probe=N_PROBE,
                                   n_cand=min(8 * K, N), use_bbc=True)
        _, gt = flat.search(x, q, K)
        ids.append(res.ids.tolist())
        recall = len(set(ids[-1]) & set(gt.tolist())) / K
        rows.append({"recall": recall, "n_reranked": int(res.n_reranked),
                     "n_second_pass": int(res.n_second_pass)})
        print(f"  query {i}: recall@{K} = {recall:.3f}, re-ranked "
              f"{rows[-1]['n_reranked']} candidates "
              f"({rows[-1]['n_second_pass']} in the second pass)",
              flush=True)
    print("done.", flush=True)
    return {"k": K, "queries": rows, "ids": ids,
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu")}


def main(argv=None) -> int:
    out = run(argv)
    print(json.dumps({k: v for k, v in out.items() if k != "ids"}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
