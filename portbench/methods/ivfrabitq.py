"""IVF+RaBitQ(+BBC) through the port's engine: ``build_rabitq_index`` on
the card, then ``SearchEngine.build`` with every knob pinned and no tuned
point.  The engine takes no ``eps0``; the searcher's default must be the
configuration's."""
import inspect

from repro_torch.index import engine, search


def build(x, cfg, traffic, device):
    ix, s, k = cfg["index"], cfg["search"], int(traffic["k"])
    eps0 = inspect.signature(
        search.ivf_rabitq_search_batch).parameters["eps0"].default
    if eps0 != s["eps0"]:
        raise ValueError(f"the searcher's eps0 is {eps0}, the "
                         f"configuration's {s['eps0']}")
    index = search.build_rabitq_index(
        x, ix["n_clusters"], n_iter=ix["kmeans_iters"],
        seed=cfg["index"]["seed"], device=device)
    return engine.SearchEngine.build(
        index, k=k, n_probe=s["n_probe"], n_cand=None, use_bbc=s["use_bbc"],
        m=s["m"], pred_count=k, fused=s["fused"], device=device, tuned=None)
