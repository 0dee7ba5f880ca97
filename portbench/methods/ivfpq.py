"""IVF+PQ(+BBC) through the port's engine: ``build_pq_index`` on the card,
then ``SearchEngine.build`` with every knob pinned and no tuned point."""
from repro_torch.index import engine, search


def build(x, cfg, traffic, device):
    ix, s, k = cfg["index"], cfg["search"], int(traffic["k"])
    index = search.build_pq_index(
        x, ix["n_clusters"], n_sub=ix["pq_m"], n_bits=ix["pq_bits"],
        n_iter=ix["kmeans_iters"], seed=cfg["index"]["seed"], device=device)
    n_cand = min(s["n_cand_per_k"] * k, cfg["n"])
    pred_count = min(max(5 * k // 2, k + 1024), n_cand)
    return engine.SearchEngine.build(
        index, k=k, n_probe=s["n_probe"], n_cand=n_cand,
        use_bbc=s["use_bbc"], m=s["m"], pred_count=pred_count,
        fused=s["fused"], device=device, tuned=None)
