"""Distributed BBC search over a mesh of ranks with the PyTorch port: the
port's counterpart of ``examples/distributed_search.py``, at its sizes
(40,000 x 64 synthetic vectors, 141 clusters, k=2000, n_probe=48, a batch
of 16 queries).  It builds an IVF+PQ index, shards the candidate stream
over a ("model",) mesh of ranks and serves the batch through the sharded
engine (per-shard scan, per-query (m+1)-histogram all-reduce,
survivor-only all-gather, then the replicated re-rank and selection),
beside the same engine on one device.

  PYTHONPATH=src python examples/torch_distributed_search.py   # the cards
  PYTHONPATH=src python examples/torch_distributed_search.py --device cpu

On the card the ranks are the host's cards (NCCL; two NCCL ranks cannot
share one card); on the CPU, 8 gloo ranks (``--ranks``), as the reference
example's 8 host devices.  Inside an initialised process group (a caller's
``init_process_group``) it runs on that group's ranks instead.  The cost
model prices the reference's 8-shard mesh whatever the ranks: it is
arithmetic on k, m and the shard count.

``run`` returns rank 0's summary (None on the other ranks of a caller's
group), with the sharded engine's ids of each query.  The last stdout
line (rank 0's) is one JSON object: the summary without the ids: the
id-set overlap of the sharded and single-device results, the cost
model's bytes per link and ratio, the ranks and the device.
"""
import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import distributed  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.index import engine, search  # noqa: E402
from repro_torch.kernels.platform import resolve_device  # noqa: E402

N, D, K, N_CLUSTERS, N_PROBE, BATCH = 40_000, 64, 2_000, 141, 48, 16
COST_SHARDS = 8   # the reference example's mesh, which the cost model prices


def search_on_mesh(dev: torch.device, index=None) -> dict | None:
    """Every rank of an initialised group: rank 0 builds the index (or
    takes ``index``, an index of the same data made elsewhere) and sends
    it to the others, all serve the batch sharded, rank 0 also on one
    device.  Returns rank 0's summary, None elsewhere."""
    rank, world = dist.get_rank(), dist.get_world_size()
    rng = np.random.default_rng(0)
    x = synthetic.clustered(rng, N, D)
    qs = torch.from_numpy(synthetic.queries_from(rng, x, BATCH)).to(dev)
    payload = None
    if rank == 0:
        if index is None:
            print("building IVF+PQ index ...", flush=True)
            index = search.build_pq_index(x, n_clusters=N_CLUSTERS,
                                          device=dev)
        payload = search.index_to(index, "cpu")
    box = [payload]
    dist.broadcast_object_list(box, src=0,
                               device=dev if dev.type == "cuda" else None)
    index = box[0]
    mesh = distributed.make_mesh((world,), ("model",), device=dev)
    if rank == 0:
        print(f"sharding the candidate stream over {world} ranks ...",
              flush=True)
    sharded = engine.SearchEngine.build(index, k=K, n_probe=N_PROBE,
                                        mesh=mesh, device=dev)
    res = sharded.search(qs)          # (batch, k) through the sharded path
    if rank != 0:
        return None
    single = engine.SearchEngine.build(index, k=K, n_probe=N_PROBE,
                                       device=dev)
    ref = single.search(qs)           # the same engine on one device
    ids, ref_ids = res.ids.cpu().numpy(), ref.ids.cpu().numpy()
    match = float(np.mean([len(set(ids[b].tolist())
                               & set(ref_ids[b].tolist())) / K
                           for b in range(BATCH)]))
    print(f"sharded vs single-device top-{K} id overlap: {match:.4f}",
          flush=True)
    cm = distributed.collective_cost_model(k=K, m=128, n_shards=COST_SHARDS)
    print(f"collective payload vs naive distributed top-k: "
          f"{cm['ratio']:.1f}x less on the wire "
          f"({cm['bbc_bytes_per_link']:.0f} vs "
          f"{cm['naive_bytes_per_link']:.0f} bytes/link per query, "
          f"{COST_SHARDS} shards)", flush=True)
    return {"overlap": match, "ratio": cm["ratio"],
            "bbc_bytes_per_link": cm["bbc_bytes_per_link"],
            "naive_bytes_per_link": cm["naive_bytes_per_link"],
            "cost_shards": COST_SHARDS, "ranks": world,
            "ids": ids.tolist(),
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu")}


def _spawned(rank: int, world: int, device: str, store: str) -> None:
    dev = torch.device("cpu") if device == "cpu" else \
        torch.device("cuda", rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:       # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group("gloo" if dev.type == "cpu" else "nccl",
                            init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        out = search_on_mesh(dev)
    finally:
        dist.destroy_process_group()
    if out is not None:
        Path(store + ".json").write_text(json.dumps(out))


def run(argv=None) -> dict | None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks to spawn (default: 8 gloo ranks on the "
                         "CPU, one per card on the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dist.is_initialized():
        return search_on_mesh(dev)
    world = args.ranks or (8 if dev.type == "cpu"
                           else torch.cuda.device_count())
    if dev.type == "cuda" and torch.cuda.device_count() < world:
        raise RuntimeError(f"{world} NCCL ranks need {world} cards, this "
                           f"host has {torch.cuda.device_count()}")
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        mp.spawn(_spawned, args=(world, dev.type, store), nprocs=world,
                 join=True)
        return json.loads(Path(store + ".json").read_text())


def main(argv=None) -> int:
    out = run(argv)
    if out is not None:           # rank 0
        print(json.dumps({k: v for k, v in out.items() if k != "ids"}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
