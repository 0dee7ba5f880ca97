"""The port's dry run (``launch/dryrun.py``) and the counted half of its
roofline (``launch/roofline.py``: ``CollectiveCounter``, ``LiveBytes``,
``roofline_terms``), on the CPU over torch's single-process fake process
group (no rank exists, nothing is sent, nothing is allocated).

* ``roofline_terms`` equals the reference's with the reference module's
  peaks set to the port's H100 peaks.
* ``CollectiveCounter``'s byte rule on hand-worked redistributions on a
  fake 8-rank mesh, and ``LiveBytes`` on a hand-worked sequence of ops.
* Dry-run cells of the ten ``smoke()`` configs on a fake (2, 4) mesh: a
  prefill and a decode step of each, a train step of one dense, one MoE
  and one SSM config: ``ok``, the reference's record keys, the argument
  bytes, and the counted FLOPs equal to the analytic model on the dense
  prefill cells.
* The CLI: the reference's skip record for ``long_500k`` of a
  full-attention arch, and a full-size cell's record.
* Full-width ``smollm-135m`` cells (prefill_32k, decode_32k, train_4k)
  on the (16, 16) mesh, cut to two layers on both sides, against the
  reference's own dry run (``repro.launch.dryrun.run_cell`` on 512
  placeholder XLA devices, in a subprocess): the argument bytes equal,
  the temporary bytes, the collective bytes by group and in total
  within the factors below, the dominant roofline term the same.

Run as a script, it prints the two records side by side at any depth:

  PYTHONPATH=src python tests/test_torch_dryrun.py smollm-135m 30 \
      prefill_32k decode_32k train_4k
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch.distributed.device_mesh import DeviceMesh  # noqa: E402
from torch.distributed.tensor import (DTensor, Partial,  # noqa: E402
                                      Replicate, Shard)

from repro.launch import roofline as jroofline  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402

torch.set_num_threads(2)

# the keys scripts/make_experiments.py and the reference's record carry
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes",
               "temp_size_in_bytes", "generated_code_size_in_bytes",
               "alias_size_in_bytes", "per_chip_total_bytes",
               "fits_16gb_hbm"}
ROOFLINE_KEYS = {"compute_s", "memory_s", "collective_s", "dominant",
                 "analytic_flops_per_chip", "analytic_bytes_per_chip",
                 "hlo_flops_per_chip_measured", "hlo_bytes_per_chip_measured",
                 "collective_bytes_per_chip", "collective_breakdown",
                 "collective_op_counts", "model_flops_global",
                 "useful_flops_ratio", "roofline_fraction"}


@pytest.fixture
def fake_group():
    assert not dist.is_initialized()
    dryrun.fake_world()
    yield
    dist.destroy_process_group()


def test_roofline_terms_equal_the_reference(monkeypatch):
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(jroofline, name, getattr(roofline, name))
    cfg = configs.get("smollm-135m")
    coll = {"all-reduce": 3.0, "all-gather": 5e8, "reduce-scatter": 2e9,
            "all-to-all": 0.0, "collective-permute": 0.0, "total": 2.5e9,
            "op_counts": {"all-reduce": 1, "all-gather": 7}}
    for cost, af, ab in (({"flops": 1e12, "bytes accessed": 3e9}, None,
                          None),
                         ({"flops": 1e12}, 2.6e15, 4.2e9),
                         ({}, roofline.analytic_flops(cfg, "train", 4096, 256),
                          None)):
        mf = roofline.model_flops(cfg, "train", 4096, 256)
        assert roofline.roofline_terms(cost, coll, 256, mf, af, ab) == \
            jroofline.roofline_terms(cost, coll, 256, mf, af, ab)


def _dt(mesh, shape, pl):
    local = list(shape)
    for m, p in enumerate(pl):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.size(m)
    return DTensor.from_local(torch.empty(local, device="meta"), mesh, pl,
                              run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


def test_collective_counter_byte_rule(fake_group):
    """On 8 ranks, a (64, 32) fp32 tensor (8,192 bytes; a shard 1,024):
    Shard -> Replicate is an all-gather of the 1,024-byte shard (its
    output over the group), Partial -> Shard a reduce-scatter of the
    8,192-byte unscattered input, Partial -> Replicate an all-reduce of
    8,192 bytes; Shard(0) -> Shard(1) moves the shard (an all-gather on a
    CPU mesh, the operand an all-to-all would send)."""
    mesh = DeviceMesh("cpu", torch.arange(8), mesh_dim_names=("model",))
    cases = [([Shard(0)], [Replicate()], "all-gather", 1024),
             ([Partial()], [Shard(0)], "reduce-scatter", 8192),
             ([Partial()], [Replicate()], "all-reduce", 8192),
             ([Shard(0)], [Shard(1)], "all-gather", 1024)]
    for src, dst, kind, nbytes in cases:
        with roofline.CollectiveCounter() as cc:
            _dt(mesh, (64, 32), src).redistribute(mesh, dst)
        got = cc.counts()
        assert got[kind] == nbytes == got["total"], (src, dst, got)
        assert got["op_counts"][kind] == 1
        assert set(got) == set(roofline.CollectiveCounter.KINDS) | {
            "total", "op_counts"}


def test_live_bytes_counts_what_the_ops_hold():
    a = torch.empty(1000, device="meta")            # an input: not counted
    with roofline.LiveBytes(held=[a]) as lb:
        b = a * 2                                   # 4,000 live
        c = b + 1                                   # 8,000
        d = c[10:]                                  # a view: no new buffer
        del b                                       # 4,000
        e = c * 3                                   # 8,000
        del c, d, e                                 # 0
        a.mul_(2)                                   # in place: nothing
    assert (lb.peak, lb.live) == (8000, 0)


SMOKE_MESH = (2, 4)


def _smoke_cell(arch, mode, b=8, s=64, n_mb=2):
    cfg = configs.get(arch, smoke=True)
    mesh = DeviceMesh("cpu", torch.arange(math.prod(SMOKE_MESH))
                      .reshape(SMOKE_MESH), mesh_dim_names=("data", "model"))
    return cfg, dryrun.run_cell(arch, f"smoke_{mode}", mesh=mesh, cfg=cfg,
                                shape=dict(mode=mode, seq=s, batch=b),
                                n_microbatches=n_mb)


@pytest.mark.parametrize("arch", list(configs.ALIASES))
def test_smoke_prefill_and_decode_cells(arch, fake_group):
    for mode in ("prefill", "decode"):
        cfg, r = _smoke_cell(arch, mode)
        assert r["status"] == "ok", r
        assert MEMORY_KEYS <= set(r["memory"])
        assert ROOFLINE_KEYS <= set(r["roofline"])
        rf = r["roofline"]
        af = roofline.analytic_flops(cfg, mode, 64, 8)
        assert rf["analytic_flops_per_chip"] * r["n_chips"] == \
            pytest.approx(af)
        if mode == "prefill" and cfg.family == "dense":
            assert rf["counted_flops_global"] == af
        assert 0.5 < rf["counted_over_analytic"] < 2.0
        assert r["memory"]["temp_size_in_bytes"] > 0
        assert r["memory"]["argument_size_in_bytes"] > 0


@pytest.mark.parametrize("arch", ["smollm-135m", "granite-moe-1b-a400m",
                                  "mamba2-130m"])
def test_smoke_train_cells(arch, fake_group):
    _, r = _smoke_cell(arch, "train")
    assert r["status"] == "ok", r
    mem, rf = r["memory"], r["roofline"]
    # the parameters and the optimizer state come back in place of the
    # donated ones
    assert mem["alias_size_in_bytes"] <= mem["argument_size_in_bytes"]
    assert rf["collective_bytes_per_chip"] > 0
    assert 0.5 < rf["counted_over_analytic"] < 1.5


def test_cli_skip_and_cell_records(tmp_path, capsys):
    out = tmp_path / "dry.json"
    assert dryrun.main(["--arch", "smollm-135m", "--shape", "long_500k",
                        "--out", str(out)]) == 0
    (rec,) = json.loads(out.read_text())
    assert rec == {"arch": "smollm-135m", "shape": "long_500k",
                   "mesh": "single", "status": "skip",
                   "reason": rec["reason"]}
    assert rec["reason"].startswith("full-attention arch")
    assert dist.is_initialized()            # the CLI made the fake group
    try:
        assert dryrun.main(["--arch", "whisper-tiny", "--shape",
                            "decode_32k", "--out", str(out)]) == 0
    finally:
        dist.destroy_process_group()
    (rec,) = json.loads(out.read_text())
    assert rec["status"] == "ok" and rec["n_chips"] == 256
    assert MEMORY_KEYS <= set(rec["memory"])
    assert ROOFLINE_KEYS <= set(rec["roofline"])
    assert rec["memory"]["fits_hbm"] is True
    assert "DONE ok=1 skip=0 error=0" in capsys.readouterr().out


# --------------------------------------------------------------------------
# full-width cells against the reference's dry run
# --------------------------------------------------------------------------

REF_SCRIPT = """
import dataclasses, json, sys
from repro.launch import dryrun    # 512 placeholder devices before jax
from repro import configs
arch, layers, shapes = sys.argv[1], int(sys.argv[2]), sys.argv[3:]
get = configs.get
if layers:
    configs.get = lambda a: dataclasses.replace(get(a), n_layers=layers)
for shape in shapes:
    print(json.dumps(dryrun.run_cell(arch, shape, False)))
"""

# The two programs differ by design (PERF.md §6): XLA gathers weights and
# keeps every op on sequence shards, and attends in kv blocks (online
# softmax); the port runs DTensor's tensor-parallel products with a
# reduce-scatter on each branch output and attends in query chunks.  So
# the readings differ, by at most these factors (the two-layer readings:
# temp 5.83 / 1.21 / 6.52x, collective total 3.21 / 1.28 / 3.88x,
# groups 0.94-8.81x):
TEMP_FACTOR = 8.0
TOTAL_FACTOR = 5.0
GROUP_FACTOR = 10.0
GROUPS = {"reductions": ("all-reduce", "reduce-scatter"),
          "moves": ("all-gather", "all-to-all", "collective-permute",
                    "broadcast")}
REF_SHAPES = ("prefill_32k", "decode_32k", "train_4k")
REF_LAYERS = 2


def reference_cells(arch: str, layers: int, shapes) -> dict:
    """The reference's dry-run records of ``arch`` (cut to ``layers``
    layers; 0: as configured) on the single-pod mesh, by shape."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "src")
    env = dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", REF_SCRIPT, arch,
                          str(layers), *shapes], env=env, check=True,
                         capture_output=True, text=True, timeout=600)
    recs = [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]
    return {r["shape"]: r for r in recs}


def port_cell(arch: str, layers: int, shape: str) -> dict:
    cfg = configs.get(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return dryrun.run_cell(arch, shape, cfg=cfg)


def side_by_side(ref: dict, got: dict) -> dict:
    """name -> (reference, port, port / reference) for the memory terms,
    each collective kind, each group and the total."""
    rows = {k: (ref["memory"][k], got["memory"][k]) for k in (
        "argument_size_in_bytes", "temp_size_in_bytes",
        "output_size_in_bytes")}
    rb = ref["roofline"]["collective_breakdown"]
    gb = got["roofline"]["collective_breakdown"]
    for k in GROUPS["reductions"] + GROUPS["moves"]:
        rows[k] = (rb.get(k, 0), gb.get(k, 0))
    for name, kinds in GROUPS.items():
        rows[name] = tuple(sum(d.get(k, 0) for k in kinds) for d in (rb, gb))
    rows["collective total"] = (ref["roofline"]["collective_bytes_per_chip"],
                                got["roofline"]["collective_bytes_per_chip"])
    return {k: (a, b, b / a if a else (1.0 if not b else math.inf))
            for k, (a, b) in rows.items()}


@pytest.fixture(scope="module")
def reference_records():
    return reference_cells("smollm-135m", REF_LAYERS, REF_SHAPES)


@pytest.mark.parametrize("shape", REF_SHAPES)
def test_full_width_cell_against_the_reference(shape, reference_records,
                                               fake_group):
    ref = reference_records[shape]
    got = port_cell("smollm-135m", REF_LAYERS, shape)
    assert ref["status"] == got["status"] == "ok"
    rows = side_by_side(ref, got)
    print(shape, json.dumps(rows))
    assert rows["argument_size_in_bytes"][2] == 1.0
    assert 1 / TEMP_FACTOR <= rows["temp_size_in_bytes"][2] <= TEMP_FACTOR
    assert 1 / TOTAL_FACTOR <= rows["collective total"][2] <= TOTAL_FACTOR
    total = rows["collective total"][0]
    for name in GROUPS:
        r, _, ratio = rows[name]
        # a group the reference barely uses (under 1% of its total) has
        # no ratio to hold: prefill's reductions read 4,608 bytes there
        if r >= 0.01 * total:
            assert 1 / GROUP_FACTOR <= ratio <= GROUP_FACTOR, (name, rows)
    if shape != "train_4k":
        # the reference's train count finds no collective inside the
        # layer loop (the same bytes at 2 and 30 layers): its dominant
        # term is not comparable there
        assert got["roofline"]["dominant"] == ref["roofline"]["dominant"]
    assert got["roofline"]["counted_over_analytic"] == pytest.approx(
        1.0, abs=0.05)


if __name__ == "__main__":
    arch_, layers_, shapes_ = sys.argv[1], int(sys.argv[2]), sys.argv[3:]
    refs = reference_cells(arch_, layers_, shapes_)
    dryrun.fake_world()
    for shape_ in shapes_:
        got_ = port_cell(arch_, layers_, shape_)
        print(f"{arch_} x {shape_} x single, {layers_ or 'all'} layers: "
              f"reference | port | port/reference")
        for k, (a, b, r) in side_by_side(refs[shape_], got_).items():
            print(f"  {k:24s} {a:>18,.0f} {b:>18,.0f} {r:10.4f}")
        for k in ("dominant", "compute_s", "collective_s",
                  "hlo_flops_per_chip_measured"):
            print(f"  {k:24s} {refs[shape_]['roofline'][k]!s:>18} "
                  f"{got_['roofline'][k]!s:>18}")
        rf_ = got_["roofline"]
        print(f"  port counted/analytic {rf_['counted_over_analytic']}, "
              f"rank 0 over the even share "
              f"{rf_['local_over_even_share']}, {got_['seconds']:.1f} s")
