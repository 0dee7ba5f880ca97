"""Spec-built engine host: the one place a (dataset, index) pair is
constructed from a declarative spec.

The transport tier needs the *same* engine in three different processes:
worker subprocesses (live serving), the replay driver (re-executing
recorded responses), and the direct-call parity baseline.  All three build
from one JSON-able spec through this module, so the record/replay checksum
contract (a replayed response must reproduce the recorded payload checksum
bit for bit) checks cross-process engine determinism rather than hoping
for it.

That promise holds within one framework and one device type.  The spec's
``device`` (``"cuda"`` unless the caller asks for ``"cpu"``) names where
every process builds and serves.  Two processes handed one spec build the
same index bits on the CPU, and on the card, whose k-means is
reproducible (``index/kmeans.py``).  A spec never reproduces the JAX
package's index: its build draws from ``jax.random``, which torch cannot
repeat.  Where a run must serve the reference's index (cross-framework
parity), the spec's ``index_npz`` names an ``.npz`` of that index's arrays,
with the keys ``convert.pq_index_from_numpy`` takes, and every process
loads it instead of building.  Replay across the two frameworks cannot be
bitwise (their distances differ in the last bit), but each side checksums
its own payload, so the live checksum check works across them.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import convert
from repro_torch.data import synthetic
from repro_torch.index import search as idx_search
from repro_torch.kernels.platform import resolve_device
from repro_torch.serving.batcher import ShapeBucket, bucket_of, k_ceilings
from repro_torch.serving.server import trim_topk
from repro_torch.serving.state import ServingState


def build_spec(*, n: int = 4096, d: int = 32, seed: int = 0,
               ks=(10, 100, 1000), n_probe: int = 8,
               data: str = "clustered", n_clusters: int | None = None,
               n_bits: int = 4, n_iter: int = 6,
               use_bbc: bool = True, device: str = "cuda",
               index_npz: str | None = None) -> dict:
    """A fully-determined, JSON-able engine description."""
    if data not in ("clustered", "isotropic", "manifold"):
        raise ValueError(f"unknown dataset kind {data!r}")
    return {"n": int(n), "d": int(d), "seed": int(seed),
            "ks": [int(k) for k in ks], "n_probe": int(n_probe),
            "data": data,
            "n_clusters": int(n_clusters or max(int(np.sqrt(n)), 16)),
            "n_bits": int(n_bits), "n_iter": int(n_iter),
            "use_bbc": bool(use_bbc), "device": str(device),
            "index_npz": index_npz}


def make_dataset(spec: dict) -> np.ndarray:
    rng = np.random.default_rng(int(spec["seed"]))
    kind = spec.get("data", "clustered")
    n, d = int(spec["n"]), int(spec["d"])
    if kind == "clustered":
        return synthetic.clustered(rng, n, d)
    if kind == "isotropic":
        return synthetic.isotropic(rng, n, d)
    return synthetic.manifold(rng, n, d)


def build_state_from_spec(spec: dict) -> tuple[ServingState, tuple[int, ...]]:
    """Spec -> (ServingState, k ceilings) on the spec's device (the card
    unless it says ``"cpu"``; raises when it says ``"cuda"`` and there is
    no card).  Deterministic within one device type: every process handed
    the same spec builds, or loads, a bit-identical index."""
    dev = resolve_device(spec.get("device", "cuda"))
    if spec.get("index_npz"):
        with np.load(spec["index_npz"]) as z:
            arrays = {key: z[key] for key in z.files}
        index, _ = convert.pq_index_from_numpy(arrays, device=dev)
    else:
        index = idx_search.build_pq_index(
            make_dataset(spec), int(spec["n_clusters"]),
            n_bits=int(spec["n_bits"]), n_iter=int(spec["n_iter"]),
            seed=int(spec["seed"]), device=dev)
    state = ServingState(index, use_bbc=bool(spec.get("use_bbc", True)),
                         device=dev)
    return state, k_ceilings(spec["ks"])


def make_exec_fn(state: ServingState, ceilings: tuple[int, ...]):
    """Singleton executor: run a (d,) query at its bucket ceiling, trim to
    the requested k.  This is the worker's hot path AND the replay /
    parity baseline — one definition, three processes.  The result is
    waited for on the card before it is copied, and comes back as host
    float32 distances and int32 ids, the reference's dtypes, whose bytes
    ``payload_checksum`` hashes."""
    def exec_fn(q: np.ndarray, k: int,
                n_probe: int) -> tuple[np.ndarray, np.ndarray]:
        bucket = bucket_of(int(k), int(n_probe), ceilings, 1)
        qt = torch.from_numpy(np.array(q, dtype=np.float32))    # a copy
        res = state.engine(bucket).search(qt.to(state.device))
        state.synchronize()
        return trim_topk(res.dists.cpu().numpy().astype(np.float32),
                         res.ids.cpu().numpy().astype(np.int32), int(k))
    return exec_fn


def warmup_and_measure(exec_fn, spec: dict,
                       ceilings: tuple[int, ...]) -> dict[str, float]:
    """Warm every serving bucket (engine build, kernel load) and measure
    warm singleton service times — the ``{"k,n_probe": seconds}`` map a
    worker's READY frame carries so the master's service EMA starts from
    evidence."""
    rng = np.random.default_rng(int(spec["seed"]) + 1)
    q = rng.standard_normal(int(spec["d"])).astype(np.float32)
    n_probe = int(spec["n_probe"])
    svc: dict[str, float] = {}
    for k in ceilings:
        exec_fn(q, k, n_probe)                  # build and warm
        t0 = time.perf_counter()
        exec_fn(q, k, n_probe)                  # measure warm
        svc[f"{k},{n_probe}"] = time.perf_counter() - t0
    return svc


def service_fn_from_svc(svc: dict[str, float], default: float = 0.005):
    """The sim-facing inverse of a READY frame's svc map."""
    table = {tuple(int(s) for s in key.split(",")): float(dt)
             for key, dt in svc.items()}

    def service_fn(bucket: ShapeBucket) -> float:
        return table.get((bucket.k, bucket.n_probe), default)
    return service_fn
