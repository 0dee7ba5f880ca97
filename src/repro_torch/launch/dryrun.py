"""Multi-pod dry run: one step of every (arch x shape x mesh) cell on a
fake mesh of 256 or 512 ranks, in one process, with nothing allocated.

The port of the JAX package's ``repro.launch.dryrun``.  The reference
lowers and compiles each cell on 512 placeholder XLA devices and reads
XLA's memory and cost analyses and the compiled HLO.  Here:

* the ranks are torch.distributed's single-process fake group (rank 0
  of 512; no rank exists, no collective is sent), initialised before the
  mesh is built, as the reference sets ``XLA_FLAGS`` before importing
  jax;
* parameters, optimizer state, batch and caches are ``meta`` tensors
  placed on the production mesh as ``DTensor``s by ``launch/mesh.py``'s
  specs, so each rank's shard has its real shape and no storage;
* the step runs eagerly (one train step with 8 microbatches and AdamW,
  a prefill, or a decode step) under four dispatch modes:
  two ``roofline.Flops`` count the global FLOPs and those rank 0 runs
  on its shards, ``roofline.CollectiveCounter`` the operand bytes of the
  collectives rank 0 issues, and ``roofline.LiveBytes`` the peak of rank
  0's live buffers.

The record keeps every key of the reference's (``scripts/
make_experiments.py`` reads them): ``argument_size_in_bytes`` is the
exact sum of rank 0's shards of the step's inputs (parameters, optimizer
state, batch, caches), ``temp_size_in_bytes`` the peak of what the step
allocates on top of them.  ``output_size_in_bytes`` and
``alias_size_in_bytes`` are the outputs' shards and the part of them that
replaces a donated input (the parameters and optimizer state of a train
step, the caches of a decode step); no code is generated
(``generated_code_size_in_bytes`` is None).  ``hbm_bytes`` and
``fits_hbm`` hold the total against one H100's 80 GB beside the
reference's 16 GB.  The roofline's measured per-chip FLOPs
(``hlo_flops_per_chip_measured``) are rank 0's own, and
``local_over_even_share`` is their ratio to the global count over the
ranks: above 1 where a layout repeats work on every rank; no byte count
is measured.

It uses no card: nothing is allocated.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \\
      --shape prefill_32k [--multi-pod] [--out out.json]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all  # 80 cells
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import roofline
from repro_torch.models import model as model_mod
from repro_torch.models import sharding as shard
from repro_torch.optim import adamw

SHAPES = {
    "train_4k": dict(mode="train", seq=4096, batch=256),
    "prefill_32k": dict(mode="prefill", seq=32768, batch=32),
    "decode_32k": dict(mode="decode", seq=32768, batch=128),
    "long_500k": dict(mode="decode", seq=524288, batch=1),
}

# long_500k needs sub-quadratic decode state growth: SSM / hybrid only.
LONG_OK_FAMILIES = ("ssm", "hybrid")

N_MICROBATCHES = 8
HBM_BYTES = 80e9           # one H100 SXM (NVIDIA data sheet)
WORLD = 512


def fake_world(n: int = WORLD) -> None:
    """Make the default process group torch's single-process fake group
    of ``n`` ranks (this process is rank 0), unless one exists."""
    if dist.is_initialized():
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)


def input_specs(cfg, sh: dict) -> dict:
    """Meta stand-ins for every model input of a cell of shape ``sh``."""
    b, s = sh["batch"], sh["seq"]

    def meta(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")

    if sh["mode"] in ("train", "prefill"):
        batch = {"tokens": meta(b, s), "targets": meta(b, s)}
        if cfg.family == "vlm":
            batch["patch_embeds"] = meta(b, cfg.n_patches, cfg.d_model,
                                         dtype=cfg.dtype)
        if cfg.family == "encdec":
            batch["frames"] = meta(b, cfg.n_frames, cfg.d_model,
                                   dtype=cfg.dtype)
        if sh["mode"] == "prefill":
            batch.pop("targets")
        return batch
    batch = {"token": meta(b), "pos": meta(b)}
    if cfg.family == "encdec":
        batch["enc_out"] = meta(b, cfg.n_frames, cfg.d_model, dtype=cfg.dtype)
    return batch


def _bytes(*trees) -> int:
    """Rank 0's bytes of every tensor in ``trees``."""
    return sum(mesh_mod.local_bytes(t) for t in _tensors(trees))


def _tensors(tree) -> list:
    """Every tensor of ``tree`` (modules, dicts, tuples, tensors)."""
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return _tensors(tuple(tree.values()))
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def cell_inputs(model, sh: dict, mesh) -> tuple:
    """A step's inputs on ``mesh`` as meta ``DTensor``s by the specs of
    ``launch/mesh.py``: (params, optimizer state, batch) for a train
    step, (params, batch) for a prefill, (params, batch, caches) for a
    decode step."""
    cfg = model.cfg
    params = model.init(device="meta")
    p_specs = mesh_mod.param_specs(params, cfg, mesh)
    batch = mesh_mod.distribute_batch(
        input_specs(cfg, sh), mesh_mod.batch_specs(cfg, mesh, sh["batch"],
                                                   sh["mode"]), mesh)
    if sh["mode"] == "train":
        opt = mesh_mod.distribute_opt_state(adamw.init(params), p_specs, mesh)
        return mesh_mod.distribute_params(params, p_specs, mesh), opt, batch
    params = mesh_mod.distribute_params(params, p_specs, mesh)
    if sh["mode"] == "prefill":
        return params, batch
    c_specs = mesh_mod.cache_specs(cfg, mesh, sh["batch"])
    caches = {k: mesh_mod.distribute(v, c_specs[k], mesh) for k, v in
              model.init_caches(sh["batch"], sh["seq"], device="meta").items()}
    return params, batch, caches


def run_cell(arch: str, shape_name: str, multi_pod: bool = False, *,
             mesh=None, shape: dict | None = None, cfg=None,
             n_microbatches: int = N_MICROBATCHES) -> dict:
    """One cell's record.  ``mesh``, ``shape`` and ``cfg`` replace the
    production mesh, ``SHAPES[shape_name]`` and ``configs.get(arch)``;
    ``n_microbatches`` splits a train step's batch."""
    sh = shape or SHAPES[shape_name]
    cfg = cfg or configs.get(arch)
    mesh_name = "multi" if multi_pod else "single"
    if shape_name == "long_500k" and cfg.family not in LONG_OK_FAMILIES:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skip",
                "reason": "full-attention arch: O(S^2) attention / O(S) KV "
                          "state per token makes 500k-decode quadratic; run "
                          "only for ssm/hybrid "
                          "(DESIGN.md §Arch-applicability)"}
    t0 = time.monotonic()
    mesh = mesh if mesh is not None else mesh_mod.make_production_mesh(
        multi_pod=multi_pod)
    n_chips = mesh.size()
    model = model_mod.build(cfg)
    args = cell_inputs(model, sh, mesh)
    if sh["mode"] == "train":
        fn = model_mod.make_train_step(model, adamw.AdamWConfig(),
                                       n_microbatches=n_microbatches)
    else:
        fn = model.prefill if sh["mode"] == "prefill" else model.decode_step
    flops, local = roofline.Flops(), roofline.Flops(per_rank=True)
    coll, live = roofline.CollectiveCounter(), roofline.LiveBytes(
        _tensors(args))
    with shard.use_mesh(mesh), local, coll, live, flops:
        outs = fn(*args)
    outs = outs if isinstance(outs, tuple) else (outs,)
    # what replaces a donated input: the parameters and optimizer state
    # of a train step, the caches of a decode step
    aliased = {"train": outs[:2], "prefill": (),
               "decode": outs[1:]}[sh["mode"]]

    n_mb = n_microbatches if sh["mode"] == "train" else 1
    counted = float(flops.flops)
    mf = roofline.model_flops(cfg, sh["mode"], sh["seq"], sh["batch"])
    af = roofline.analytic_flops(cfg, sh["mode"], sh["seq"], sh["batch"])
    ab = roofline.analytic_bytes(cfg, sh["mode"], sh["seq"], sh["batch"],
                                 n_chips, n_mb)
    rf = roofline.roofline_terms({"flops": float(local.flops)},
                                 coll.counts(), n_chips, mf,
                                 analytic_flops_global=af,
                                 analytic_bytes_chip=ab)
    rf["counted_flops_global"] = counted
    rf["counted_over_analytic"] = counted / af if af else None
    rf["local_over_even_share"] = (local.flops * n_chips / counted
                                   if counted else None)

    args_b = _bytes(*args)
    tmp_b = live.peak
    mem_d = {"argument_size_in_bytes": args_b,
             "output_size_in_bytes": _bytes(*outs),
             "temp_size_in_bytes": tmp_b,
             "generated_code_size_in_bytes": None,
             "alias_size_in_bytes": _bytes(*aliased),
             "per_chip_total_bytes": args_b + tmp_b,
             "fits_16gb_hbm": bool(args_b + tmp_b < 16e9),
             "hbm_bytes": HBM_BYTES,
             "fits_hbm": bool(args_b + tmp_b < HBM_BYTES)}
    return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
            "n_chips": int(n_chips), "status": "ok", "memory": mem_d,
            "roofline": rf, "seconds": time.monotonic() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not args.all and not args.arch:
        ap.error("--arch or --all")

    if args.all:
        arch_ids = list(configs.ALIASES.keys())
        shapes = list(SHAPES)
    else:
        arch_ids = [args.arch]
        shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if (args.both_meshes or args.all) \
        else [args.multi_pod]

    fake_world()
    results = []
    out_path = args.out or "dryrun_results_torch.json"
    for arch in arch_ids:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch} x {shape} x {'multi' if mp else 'single'}"
                print(f"=== {tag}", flush=True)
                try:
                    r = run_cell(arch, shape, mp)
                except Exception as e:  # noqa: BLE001 — record and continue
                    traceback.print_exc()
                    r = {"arch": arch, "shape": shape,
                         "mesh": "multi" if mp else "single",
                         "status": "error", "error": repr(e)[:2000]}
                results.append(r)
                print(json.dumps(r, indent=None, default=str)[:600],
                      flush=True)
                with open(out_path, "w") as f:
                    json.dump(results, f, indent=1, default=str)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skip" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"DONE ok={n_ok} skip={n_skip} error={n_err} -> {out_path}")
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
