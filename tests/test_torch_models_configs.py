"""The port's config registry and full-size parameter shapes against the
JAX package's, and the retrieval example on the CPU.

For all ten ``full()`` configs and the three variants, the port's
parameters built on the ``meta`` device (nothing allocated) have the
names, shapes and dtypes of ``jax.eval_shape`` of the reference's init
(which allocates nothing either), stacked the reference's way, and
``param_count`` equals the reference's.  Every config's fields equal the
reference's, the dtype carried to torch.  Then
``examples/torch_serve_retrieval.py --device cpu --smoke`` runs the
retrieval pipeline at the reference example's sizes: recall@1000 against
exact search must reach 0.9.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from torch import nn  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FULL = [*configs.ARCHS, *configs.VARIANTS]
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def test_registry_is_the_reference_s():
    assert configs.ARCHS == jconfigs.ARCHS
    assert configs.ALIASES == jconfigs.ALIASES
    assert configs.VARIANTS == jconfigs.VARIANTS


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_config_fields_equal(arch, smoke):
    got = dataclasses.asdict(configs.get(arch, smoke=smoke))
    want = dataclasses.asdict(jconfigs.get(arch, smoke=smoke))
    assert got.pop("dtype") == DTYPES[np.dtype(want.pop("dtype")).name]
    assert got == want


def param_tree(params) -> dict:
    """The port's parameters in the reference's pytree layout: nested
    dicts by name, each ``ModuleList`` stacked on a leading axis (a
    hybrid's segments on two); on the meta device nothing is allocated."""
    tree = dict(params.named_parameters(recurse=False))
    for name, child in params.named_children():
        tree[name] = _stacked(child) if isinstance(child, nn.ModuleList) \
            else param_tree(child)
    return tree


def _stacked(mods):
    trees = [_stacked(m) if isinstance(m, nn.ModuleList) else param_tree(m)
             for m in mods]

    def stack(ts):
        if isinstance(ts[0], dict):
            return {k: stack([t[k] for t in ts]) for k in ts[0]}
        return torch.stack(ts)
    return stack(trees)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {"/".join(prefix): tree}


@pytest.mark.parametrize("arch", FULL)
def test_full_param_shapes_equal_eval_shape(arch):
    jcfg, cfg = jconfigs.get(arch), configs.get(arch)
    want = _flat(jax.eval_shape(jmodel.build(jcfg).init, jax.random.key(0)))
    params = model_mod.build(cfg).init(device="meta")
    assert all(p.device.type == "meta" for p in params.parameters())
    got = _flat(param_tree(params))
    assert got.keys() == want.keys()
    for name, t in got.items():
        assert tuple(t.shape) == tuple(want[name].shape), name
        assert t.dtype == DTYPES[np.dtype(want[name].dtype).name], name
    assert model_mod.param_count(params) == sum(
        int(np.prod(s.shape)) for s in want.values())


def test_decode_caches_on_meta_match_the_reference():
    """The full configs' decode caches (the int8 ``kv_quant`` variant too)
    have the reference's shapes and dtypes."""
    for arch in ("smollm-135m", "qwen1.5-32b-pad48-kvq", "zamba2-1.2b",
                 "mamba2-130m", "whisper-tiny"):
        jm, tm = jmodel.build(jconfigs.get(arch)), model_mod.build(
            configs.get(arch))
        want = jax.eval_shape(lambda: jm.init_caches(4, 256))
        got = tm.init_caches(4, 256, device="meta")
        assert got.keys() == want.keys()
        for name in got:
            assert tuple(got[name].shape) == tuple(want[name].shape)
            assert str(got[name].dtype).removeprefix("torch.") == \
                np.dtype(want[name].dtype).name


def test_retrieval_example_on_the_cpu():
    """The reference example's pipeline at its sizes (20,000 documents,
    141 clusters, k=1000, n_probe=100, 4 queries) with the smoke encoder:
    one JSON line; recall@1000 against exact search >= 0.9; no card
    launches on the CPU."""
    out = subprocess.run(
        [sys.executable, "examples/torch_serve_retrieval.py", "--device",
         "cpu", "--smoke"], capture_output=True, text=True, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH="src"), timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["device"] == "cpu" and res["arch"] == "smollm-smoke"
    assert (res["n_docs"], res["k"], res["n_probe"], res["queries"]) == (
        20_000, 1000, 100, 4)
    assert res["recall_at_k"] >= 0.9
    assert len(res["n_reranked"]) == 4 and min(res["n_reranked"]) >= 1000
    assert res["launches"] == {}
    for key in ("embed_ms", "query_embed_ms", "search_ms"):
        assert res[key] > 0
