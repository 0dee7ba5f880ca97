"""End-to-end retrieval serving on the PyTorch port: an LM encoder making
query and document embeddings in front of the BBC large-k searcher (the
paper's document-retrieval pipeline, application #2 in its
introduction).  The port's counterpart of ``examples/serve_retrieval.py``,
at its sizes: 20,000 documents of 32 tokens, mean-pooled and normalised
embeddings with a 0.05 spread, IVF+RaBitQ over 141 clusters, one batch of
4 queries through ``SearchEngine`` at k=1000, n_probe=100 with BBC.

The encoder is the full-width ``smollm-135m`` (bf16, random weights from a
seeded ``torch.Generator``; no weights ship with the repository) on the
card by default; ``--smoke`` takes its smoke size in fp32.

  PYTHONPATH=src python examples/torch_serve_retrieval.py          # card
  PYTHONPATH=src python examples/torch_serve_retrieval.py --device cpu \\
      --smoke

The last stdout line is one JSON object: recall@k of the engine's ids
against exact search over the same embeddings, each query's
``n_reranked``, the kernel launches the run made (``ops.LAUNCHES``; none
on the CPU, where the plain versions run), the corpus and query embedding
ms and the search ms (wall clock, the card synchronised).
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.index import engine, flat, search  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.platform import resolve_device  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

# the reference example's sizes
ARCH, N_DOCS, SEQ, QUERIES = "smollm-135m", 20_000, 32, 4
K, N_PROBE, N_CLUSTERS = 1000, 100, 141


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain versions (default: the card)")
    ap.add_argument("--smoke", action="store_true",
                    help="the encoder's smoke size (fp32) instead of the "
                         "full width")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = configs.get(ARCH, smoke=args.smoke)
    model = model_mod.build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device=dev)

    @torch.inference_mode()
    def embed(tokens: np.ndarray) -> torch.Tensor:
        h = tf._hidden(params, cfg, torch.from_numpy(tokens).to(dev))
        e = h.float().mean(dim=1)
        return e / torch.linalg.vector_norm(e, dim=-1, keepdim=True)

    ops.reset_launches()
    rng = np.random.default_rng(1)
    doc_tokens = rng.integers(0, cfg.vocab, (N_DOCS, SEQ))
    t0 = time.perf_counter()
    embs = torch.cat([embed(doc_tokens[i:i + 2000])
                      for i in range(0, N_DOCS, 2000)])
    _sync(dev)
    embed_ms = 1e3 * (time.perf_counter() - t0)
    noise = rng.standard_normal((N_DOCS, cfg.d_model)).astype(
        np.float32) * 0.05                       # spread for realism
    corpus = embs + torch.from_numpy(noise).to(dev)

    index = search.build_rabitq_index(corpus, n_clusters=N_CLUSTERS,
                                      seed=1, device=dev)
    eng = engine.SearchEngine.build(index, k=K, n_probe=N_PROBE,
                                    use_bbc=True, device=dev)
    query_tokens = rng.integers(0, cfg.vocab, (QUERIES, SEQ))
    t0 = time.perf_counter()
    q_emb = embed(query_tokens)
    _sync(dev)
    query_ms = 1e3 * (time.perf_counter() - t0)
    eng.search(q_emb)                            # warm-up
    _sync(dev)
    t0 = time.perf_counter()
    res = eng.search(q_emb)                      # one batched engine call
    _sync(dev)
    search_ms = 1e3 * (time.perf_counter() - t0)

    _, gt = flat.search_batch(corpus, q_emb, K)
    ids, gt = res.ids.cpu().numpy(), gt.cpu().numpy()
    recall = float(np.mean([len(set(a.tolist()) & set(b.tolist())) / K
                            for a, b in zip(ids, gt)]))
    return {
        "arch": cfg.arch_id, "d_model": cfg.d_model,
        "dtype": str(cfg.dtype).removeprefix("torch."),
        "params": model_mod.param_count(params),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "n_docs": N_DOCS, "k": K, "n_probe": N_PROBE,
        "queries": QUERIES, "recall_at_k": recall,
        "n_reranked": [int(v) for v in res.n_reranked.cpu()],
        "launches": {k: v for k, v in ops.LAUNCHES.items() if v},
        "embed_ms": embed_ms, "query_embed_ms": query_ms,
        "search_ms": search_ms}


def main(argv=None) -> int:
    print(json.dumps(run(argv)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
