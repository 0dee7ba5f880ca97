"""The port's search examples (``examples/torch_quickstart.py`` and
``examples/torch_distributed_search.py``) run with ``--device cpu``,
beside the reference's searches on the same seed-0 synthetic data at the
examples' sizes (in a subprocess with 8 placeholder XLA devices):

* the quickstart's large-k BBC queries reach recall@2000 >= 0.95 and
  return the reference example's id sets (each package builds its own
  index; both read recall 1.0);
* the distributed one, as a script on 2 gloo ranks, returns the single
  engine's id sets (overlap 1.0) and prints the reference's cost-model
  numbers;
* its sharded engine on 2 gloo ranks, serving the reference's index,
  returns the id sets of the reference's sharded engine on 8 devices
  (the bound of the search parity tests: equal sets)."""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro.core import distributed as jdist  # noqa: E402
from repro_torch import convert  # noqa: E402

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def example(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the reference examples' searches: the quickstart's three single BBC
# queries on its own index, and the distributed example's sharded engine
# on 8 devices, whose index arrays go to argv[1]
REF_SCRIPT = """
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.data import synthetic
from repro.index import engine, search
out = {}
rng = np.random.default_rng(0)
x = synthetic.clustered(rng, 20_000, 64)
qs = synthetic.queries_from(rng, x, 3)
index = search.build_pq_index(jax.random.key(0), jnp.asarray(x), 141)
out["quickstart"] = [np.asarray(search.ivf_pq_search(
    index, jnp.asarray(q), k=2000, n_probe=100, n_cand=16000,
    use_bbc=True).ids).tolist() for q in qs]
rng = np.random.default_rng(0)
x = synthetic.clustered(rng, 40_000, 64)
qs = synthetic.queries_from(rng, x, 16)
index = search.build_pq_index(jax.random.key(0), jnp.asarray(x), 141)
mesh = jax.make_mesh((8,), ("model",))
out["distributed"] = np.asarray(engine.SearchEngine.build(
    index, k=2000, n_probe=48, mesh=mesh).search(jnp.asarray(qs)).ids
    ).tolist()
np.savez(sys.argv[1], ivf_centroids=index.ivf.centroids,
         member_ids=index.ivf.member_ids,
         member_valid=index.ivf.member_valid,
         cluster_sizes=index.ivf.cluster_sizes,
         pq_centroids=index.pq.centroids, codes=index.codes,
         vectors=index.vectors)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's ids by example and the path of its distributed
    example's index arrays."""
    path = str(tmp_path_factory.mktemp("ref") / "index.npz")
    proc = subprocess.run(
        [sys.executable, "-c", REF_SCRIPT, path], capture_output=True,
        text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1]), path


def test_quickstart_on_the_cpu(capsys, reference):
    out = example("torch_quickstart").run(["--device", "cpu"])
    assert out["device"] == "cpu" and out["k"] == 2000
    assert len(out["queries"]) == 3
    for q in out["queries"]:
        assert q["recall"] >= 0.95, out
        assert q["n_reranked"] >= 2000
    assert "recall@2000" in capsys.readouterr().out
    for got, want in zip(out["ids"], reference[0]["quickstart"],
                         strict=True):
        assert set(got) == set(want)


def test_distributed_search_on_gloo_ranks():
    """As a script: its ranks are spawned from ``__main__``."""
    proc = subprocess.run(
        [sys.executable,
         str(ROOT / "examples" / "torch_distributed_search.py"),
         "--device", "cpu", "--ranks", "2"], capture_output=True, text=True,
        timeout=300, env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    ref = jdist.collective_cost_model(k=2000, m=128, n_shards=8)
    assert out["ranks"] == 2 and out["device"] == "cpu"
    assert out["overlap"] == 1.0
    assert (out["bbc_bytes_per_link"], out["naive_bytes_per_link"],
            out["ratio"]) == (ref["bbc_bytes_per_link"],
                              ref["naive_bytes_per_link"], ref["ratio"])
    assert (out["bbc_bytes_per_link"], out["naive_bytes_per_link"]) == \
        (36743, 112000)


def _serve_reference_index(rank, world, store, npz, out):
    sys.path.insert(0, str(ROOT / "examples"))
    import torch_distributed_search as tds
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        index = None
        if rank == 0:
            with np.load(npz) as f:
                index, _ = convert.pq_index_from_numpy(dict(f), "cpu")
        res = tds.search_on_mesh(torch.device("cpu"), index)
    finally:
        dist.destroy_process_group()
    if res is not None:
        Path(out).write_text(json.dumps(res))


def test_distributed_search_against_the_reference(reference, tmp_path):
    """The example's sharded engine on 2 gloo ranks, serving the
    reference's index: the reference's sharded id sets, query by query."""
    ref_ids, npz = reference[0]["distributed"], reference[1]
    out = tmp_path / "out.json"
    mp.spawn(_serve_reference_index,
             args=(2, str(tmp_path / "store"), npz, str(out)), nprocs=2,
             join=True)
    got = json.loads(out.read_text())
    assert got["ranks"] == 2 and got["overlap"] == 1.0
    assert len(got["ids"]) == len(ref_ids) == 16
    for b, (g, w) in enumerate(zip(got["ids"], ref_ids, strict=True)):
        assert set(g) == set(w), b
