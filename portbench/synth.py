"""Corpus and query generators of the benchmark.

The corpus is made on the device, from the configuration's ``data.seed``,
in a few large calls of one ``torch.Generator``: a Gaussian mixture with the
parameters of the port's ``data/synthetic.py`` ``clustered``.  The same seed
on the same device gives the same corpus, so the reference makes it again
for itself once the window has closed, and trusts nothing the program held.

The queries are a frozen copy of ``queries_from`` from the port's
``data/synthetic.py``, made on the host from a host copy of the corpus:
the same draws in the same order, so a seed gives the same arrays.  The
benchmark keeps its own copies so that a later change to the program cannot
move the data it is measured on.
"""
from __future__ import annotations

import numpy as np

CORPUS, QUERIES, WARM, SAMPLE = 0, 1, 2, 3     # the run's streams


def seeds(seed: int, *tags: int) -> np.random.Generator:
    """The generator of one stream of the run: ``seed`` (any whole number)
    and the stream's tags."""
    return np.random.default_rng([seed % (1 << 64), *tags])


def torch_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for ``torch.Generator.manual_seed`` from ``seed`` (any
    whole number) and the stream's tags."""
    ss = np.random.SeedSequence([seed % (1 << 64), *tags])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def clustered(n: int, d: int, seed: int, device, n_centers: int = 256,
              center_scale: float = 2.0, point_scale: float = 0.5):
    """A Gaussian mixture on ``device``, (n, d) float32: ``n_centers``
    centres drawn at ``center_scale``, each point a uniformly chosen centre
    plus ``point_scale`` noise."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    centers = torch.randn(n_centers, d, generator=g, device=device)
    centers.mul_(center_scale)
    asg = torch.randint(0, n_centers, (n,), generator=g, device=device)
    x = torch.randn(n, d, generator=g, device=device).mul_(point_scale)
    return x.add_(centers[asg])


def queries_from(rng: np.random.Generator, x: np.ndarray, n_q: int,
                 jitter: float = 0.1) -> np.ndarray:
    """Queries near corpus points (the paper samples queries from the
    corpus): ``n_q`` distinct rows plus ``jitter`` noise."""
    idx = rng.choice(len(x), n_q, replace=False)
    return (x[idx] + rng.standard_normal((n_q, x.shape[1])) * jitter).astype(
        x.dtype)


def corpus(cfg: dict, device):
    """The configuration's corpus on ``device``, (n, d) float32: one data
    set, made from the configuration's own ``data.seed`` as a published
    corpus is one file; a run's seed draws the queries."""
    data = cfg["data"]
    if data["generator"] != "clustered":
        raise ValueError(f"unknown corpus generator {data['generator']!r}")
    return clustered(cfg["n"], cfg["d"], torch_seed(data["seed"], CORPUS),
                     device, n_centers=data["n_centers"],
                     center_scale=data["center_scale"],
                     point_scale=data["point_scale"])


def query_chunk(cfg: dict, x: np.ndarray, seed: int, stream: int,
                chunk: int, size: int) -> np.ndarray:
    """Chunk ``chunk`` of ``size`` queries of one stream: a function of the
    seed, the stream and the chunk's index alone."""
    q = cfg["queries"]
    if q["generator"] != "queries_from":
        raise ValueError(f"unknown query generator {q['generator']!r}")
    return queries_from(seeds(seed, stream, chunk), x, size,
                        jitter=q["jitter"])
