"""Structural rules of the PyTorch port: it (its models, configs and
``examples/torch_*.py`` included) imports neither JAX nor the JAX
package, its entry points refuse to fall back to the CPU when CUDA is
missing, TF32 is off, and every kernel source carries its note."""
import ast
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402,F401
from repro_torch.index import engine, search  # noqa: E402
from repro_torch.kernels import _build, ops, platform  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serving.state import ServingState  # noqa: E402
from repro_torch.transport import enginehost, worker  # noqa: E402

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "examples").glob("torch_*.py"))


def _imports(path: Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            mods.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module.split(".")[0])
    return mods


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_repro(path):
    bad = _imports(path) & {"jax", "jaxlib", "repro"}
    assert not bad, f"{path} imports {bad}"


def test_models_and_configs_are_covered():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("layers", "moe", "ssm", "transformer", "encdec", "model"):
        assert f"src/repro_torch/models/{mod}.py" in names
    assert "src/repro_torch/configs/smollm_135m.py" in names
    assert "examples/torch_serve_retrieval.py" in names


def test_training_path_is_covered():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for path in ("data/pipeline.py", "optim/__init__.py", "optim/adamw.py",
                 "launch/train.py", "launch/roofline.py", "convert.py",
                 "checkpoint/manager.py"):
        assert f"src/repro_torch/{path}" in names
    assert "examples/torch_train_lm.py" in names


def test_dry_run_mesh_and_search_examples_are_covered():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for path in ("launch/dryrun.py", "launch/mesh.py", "launch/roofline.py",
                 "models/sharding.py"):
        assert f"src/repro_torch/{path}" in names
    assert "examples/torch_quickstart.py" in names
    assert "examples/torch_distributed_search.py" in names


def test_search_examples_raise_without_cuda(no_cuda):
    import importlib.util
    for name in ("torch_quickstart", "torch_distributed_search"):
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mod.run([])


def test_training_raises_without_cuda(no_cuda, tmp_path):
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.train(arch="smollm-135m", steps=2, ckpt_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.run_with_restarts(arch="smollm-135m", steps=2,
                                ckpt_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--steps", "2", "--ckpt-dir", str(tmp_path)])
    assert not list(tmp_path.iterdir())        # nothing trained or written


def test_model_entry_points_raise_without_cuda(no_cuda):
    from repro_torch import configs
    from repro_torch.models import model as model_mod
    m = model_mod.build(configs.get("smollm-135m", smoke=True))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        m.init(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        m.init_caches(2, 8)
    assert m.init(0, device="cpu").embed.device.type == "cpu"
    assert m.init(device="meta").embed.device.type == "meta"


def test_tf32_is_off():
    assert platform.tf32_off()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda, tmp_path):
    x = np.random.default_rng(0).standard_normal((300, 16)).astype(np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        search.build_pq_index(x, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        platform.resolve_device("cuda")
    idx = search.build_pq_index(x, 4, n_iter=2, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.SearchEngine.build(idx, k=10, n_probe=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--n", "300", "--d", "16", "--n-clusters", "4"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingState(idx)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--mode", "async", "--n", "300", "--d", "16",
                    "--n-clusters", "4"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--mode", "net", "--n", "300", "--d", "16",
                    "--n-clusters", "4", "--workers", "1"])
    spec = {"wid": 0, "addr": {"family": "unix",
                               "path": str(tmp_path / "none.sock")},
            "engine": enginehost.build_spec(n=300, d=16, ks=(10,))}
    assert spec["engine"]["device"] == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        worker.WorkerApp(spec)
    (tmp_path / "worker.json").write_text(json.dumps(spec))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        worker.main(["worker", str(tmp_path / "worker.json")])
    assert engine.SearchEngine.build(idx, k=10, n_probe=2,
                                     device="cpu").device.type == "cpu"
    assert ServingState(idx, device="cpu").device.type == "cpu"


def test_fused_default_follows_the_device(rng):
    x = rng.standard_normal((400, 16)).astype(np.float32)
    idx = search.build_pq_index(x, 4, n_iter=2, device="cpu")
    eng = engine.SearchEngine.build(idx, k=10, n_probe=2, device="cpu")
    res = eng.search(x[:3])      # fused=None resolves to the unfused form
    assert torch.equal(res.n_reranked, res.n_second_pass)


def test_kernel_sources_carry_their_notes():
    """Each source names the TPU kernel it replaces, or says it replaces
    none (a kernel for a composition the JAX package runs as XLA ops)."""
    for name in _build.KERNELS:
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert ("Replaces: src/repro/kernels/" in src
                or "Replaces no TPU kernel: the JAX package" in src), name
        assert "What bounds it on an H100" in src, name
        assert "What the design does about it" in src, name
        assert 'extern "C"' in src, name
    assert "--use_fast_math" not in _build.FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.FLAGS


def test_build_dir_is_gitignored():
    rel = _build.build_root().relative_to(ROOT)
    assert rel.parts[0] + "/" in (ROOT / ".gitignore").read_text().split()
    assert len(_build.source_hash()) == 16


def test_launch_counters_cover_the_four_kernels():
    """One counter per TPU kernel of the repository: the seven batched
    kernels, the RaBitQ estimator and the four single-query forms; and one
    each for the codebook sample's ADC, its RaBitQ upper bounds and the
    second pass's gather, which no TPU kernel computes; one for the fused
    scan's chunked-LUT form (#1 where a query's LUT outgrows a block); one
    for each mode of the sample plan's kernel (a row sorted in shared
    memory, a row read sorted), which no TPU kernel computes either; one
    for the routing's lane mask, which neither does; and one for the
    masked exact pass (RaBitQ's stragglers past the gather budget), where
    the TPU path runs the dense #3."""
    assert set(ops.LAUNCHES) == {"fused_scan_batch", "pq_adc_batch",
                                 "l2_exact_batch", "bucket_hist_batch",
                                 "fused_rabitq_scan_batch",
                                 "shard_collect_batch", "spec_compact_batch",
                                 "rabitq_est", "fused_scan", "pq_adc",
                                 "l2_exact", "bucket_hist",
                                 "pq_sample_adc_batch",
                                 "l2_gather_rows_batch",
                                 "rabitq_sample_ub_batch",
                                 "fused_scan_chunked_batch",
                                 "sample_plan_batch",
                                 "sample_plan_sorted_batch",
                                 "probe_mask_batch",
                                 "l2_exact_masked_batch"}
    assert set(_build.KERNELS) == {"fused_scan", "pq_adc", "l2_rerank",
                                   "bucket_hist", "rabitq_fused",
                                   "shard_collect", "rabitq_est",
                                   "sample_plan", "lane_mask"}
    ops.LAUNCHES["pq_adc_batch"] = 3
    ops.reset_launches()
    assert set(ops.LAUNCHES.values()) == {0}
