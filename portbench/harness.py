"""One run of one cell: set-up, the measured window, the check, the result.

Everything that belongs to one configuration, traffic mix, driver, method or
per-layer metric is found by name under the benchmark's folder:

    configs/<config>.json      sizes, index and search knobs, the check
    traffic/<traffic>.json     calls, k, sample size, traced slice, driver
    drivers/<driver>.py        ``run_window(ctx) -> loop.Window``
    methods/<method>.py        ``build(x, cfg, traffic, device)`` -> engine
    metrics/<metric>.py        ``read(ctx) -> float | None``

``run_cell`` does the run; ``run.py`` is the command line around it.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from portbench import loop, profiling, reference, synth

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # top-level module names
HOST_THREADS = 2        # one caller: PyTorch's host threads stay few
TRACE_WARM = 2          # traced calls left uncounted: the tracer's start


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, tag: str):
    """Import the file ``path`` as a module of its own."""
    name = "portbench_" + tag + "_" + "".join(
        c if c.isalnum() else "_" for c in path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(root: Path, cell_name: str) -> SimpleNamespace:
    """Every file a cell of ``root/BENCHMARK.json`` runs, by name."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json")
    cell = cells[cell_name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = load_json(root / configs[cell["config"]]["file"])
    base = root / bench["paths"][0]
    traffic = load_json(base / "traffic" / f"{cell['traffic']}.json")
    per_layer = [m for m in bench["per_layer"]
                 if cell_name in m.get("workloads", [cell_name])]
    end_to_end = [m for m in bench["end_to_end"]
                  if cell_name in m.get("workloads", [cell_name])]
    return SimpleNamespace(
        cell=cell, cfg=cfg, traffic=traffic,
        end_to_end=end_to_end, per_layer=per_layer,
        driver=base / "drivers" / f"{traffic['driver']}.py",
        method=base / "methods" / f"{cfg['method']}.py",
        metrics={m["name"]: base / "metrics" / f"{m['name']}.py"
                 for m in per_layer})


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(root: Path, cell_name: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t_start: float | None = None,
             out=sys.stdout) -> dict:
    """Run one cell and return (and print, as the last line of ``out``) the
    result object.  ``device`` is "cuda" for every measured run; the tests
    drive the rest of a run on the CPU."""
    import torch

    t_start = time.monotonic() if t_start is None else t_start
    rc = resolve(Path(root), cell_name)
    cfg, traffic = rc.cfg, rc.traffic
    k, dev = int(traffic["k"]), torch.device(device)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    torch.set_num_threads(HOST_THREADS)

    # ---- set-up ---------------------------------------------------------
    stages = [("start", time.monotonic() - t_start)]
    x = synth.corpus(cfg, dev)
    x_np = x.to("cpu", copy=True).numpy()     # the queries' rows, host-side
    sync()
    stages.append(("corpus", time.monotonic() - t_start))
    method = load_module(rc.method, "method")
    driver = load_module(rc.driver, "driver")
    engine = method.build(x, cfg, traffic, dev)
    sync()
    stages.append(("index", time.monotonic() - t_start))
    warm = driver.supply(cfg, x_np, seed, traffic, synth.WARM)
    for _ in range(max(1, int(traffic["warm_calls"]))):
        like = engine.search(torch.from_numpy(warm.next()))
    reservoir = loop.Reservoir(int(traffic["sample"]), like,
                               synth.seeds(seed, synth.SAMPLE))
    del like
    sync()
    stages.append(("warm", time.monotonic() - t_start))
    if trace:
        warm_profiler(cuda, sync)
    del x          # the program's now; the check makes its own
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    mallocs = _segments(dev) if cuda else 0
    ctx = SimpleNamespace(
        engine=engine, cfg=cfg, traffic=traffic, device=dev, sync=sync,
        seconds=seconds,
        supply=driver.supply(cfg, x_np, seed, traffic, synth.QUERIES),
        reservoir=reservoir,
        trace=traffic["trace"] if trace else None,
        profiler_factory=lambda: profiler(cuda), window=None, profile=None)
    setup_s = time.monotonic() - t_start
    print("portbench: set-up " + ", ".join(
        f"{name} {t - prev:.2f} s" for (name, t), (_, prev)
        in zip(stages, [("", 0.0)] + stages)) + f", total {setup_s:.2f} s",
        file=sys.stderr)

    # ---- the window -------------------------------------------------------
    win = driver.run_window(ctx)
    ctx.window = win
    serve_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    lat = 1e3 * np.asarray(win.latencies or [0.0])
    print(f"portbench: window {len(win.latencies)} calls in "
          f"{win.seconds:.2f} s, call ms p50 {np.percentile(lat, 50):.3f} "
          f"p95 {np.percentile(lat, 95):.3f} max {lat.max():.3f}, "
          f"device allocations in the window "
          f"{(_segments(dev) - mallocs) if cuda else 0}", file=sys.stderr)

    result: dict = {"correct": False, "attempted": win.queries,
                    "failed": win.failed}
    metrics: dict = {}
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": 1,
                   "memory_peak_bytes": int(max(setup_peak, serve_peak))}
    breakdown = None
    if trace:
        if win.profiler is not None:
            t_read = time.monotonic()
            events = win.profiler.function_events
            ctx.profile = profiling.Trace.from_events(
                events, torch.autograd.DeviceType.CUDA, skip=TRACE_WARM)
            print(f"portbench: trace of {ctx.profile.n_calls} counted calls, "
                  f"{len(events)} events, {len(ctx.profile.device)} on the "
                  f"device, read in {time.monotonic() - t_read:.1f} s",
                  file=sys.stderr)
        readers = {name: load_module(path, "metric")
                   for name, path in rc.metrics.items()}
        for m in rc.per_layer:
            value = readers[m["name"]].read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        tr = ctx.profile
        if tr is not None and tr.n_calls:
            device_info["busy_s"] = tr.busy_us() * 1e-6
            device_info["window_s"] = tr.window_us * 1e-6
            breakdown = tr.breakdown()
    else:
        metrics = {
            "setup_s": setup_s,
            "qps": (win.queries - win.failed) / win.seconds,
            "latency_p95_ms": 1e3 * float(np.percentile(win.latencies, 95)),
            "serve_mem_gib": serve_peak / 2**30,
        }

    # ---- the check, once the program's state is freed ---------------------
    fresh = driver.supply(cfg, x_np, seed, traffic, synth.QUERIES)
    sample = [(fresh.call(r.index).reshape(-1, x_np.shape[1]),
               r.result.dists, r.result.ids) for r in win.sample]
    failed = win.failed
    del engine, ctx, win, reservoir, fresh, x_np
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    recall, checks = judge(synth.corpus(cfg, dev), sample, k, cfg["check"],
                           want=int(traffic["sample"]), failed=failed)
    if not trace:
        metrics["recall_at_k"] = recall
        units = {m["name"]: m["unit"] for m in rc.end_to_end}
        metrics = {name: {"value": float(metrics[name]), "unit": unit}
                   for name, unit in units.items()}
    result["correct"] = all(c["value"] <= c["limit"] for c in checks.values())
    result["metrics"] = metrics
    result["device"] = device_info
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": _number(c["value"]),
                               "limit": c["limit"]}
                        for name, c in checks.items()}
    found = forbidden_modules()       # the window has closed: what it loaded
    if found:
        raise SystemExit(f"portbench: {', '.join(found)} loaded in the "
                         f"measured process")
    for name, c in checks.items():
        print(f"portbench check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), file=out, flush=True)
    return result


def _segments(dev) -> int:
    """Device allocations the caching allocator has made so far."""
    import torch
    return int(torch.cuda.memory_stats(dev).get("segment.all.allocated", 0))


def _number(v: float) -> float:
    """``v`` as JSON can hold it (no infinities)."""
    return v if abs(v) < 1e308 else 1e308


def profiler(cuda: bool):
    """A kineto profiler of the host's operators and, on the card, the
    device's (``__enter__`` starts it, ``__exit__`` stops it)."""
    from torch.autograd import profiler as ap
    return ap.profile(use_device="cuda" if cuda else None, use_kineto=True)


def warm_profiler(cuda: bool, sync) -> None:
    """Start and stop a profiler once, so that the window's does not pay
    the tracer's first start (CUPTI's initialisation)."""
    import torch
    with profiler(cuda):
        torch.ones(1, device="cuda" if cuda else "cpu").add_(1)
        sync()


def judge(x, sample, k: int, check: dict, want: int, failed: int):
    """Compare the sampled calls' results with the reference, over the
    corpus ``x`` made again for it: the mean recall and each number that
    ``check["limits"]`` names beside its limit.  A run whose window made
    fewer calls than the sample asks for, or in which a call failed, is not
    correct."""
    import torch
    checks = {"failed_queries": {"value": failed, "limit": 0},
              "missing_sample_calls": {"value": max(0, want - len(sample)),
                                       "limit": 0}}
    limits = check["limits"]
    if not sample:
        checks.update({name: {"value": float("inf"), "limit": lim}
                       for name, lim in limits.items()})
        return 0.0, checks
    qs = torch.from_numpy(np.concatenate([q for q, _, _ in sample]))
    dists = torch.cat([d.reshape(q.shape[0], -1) for q, d, _ in sample])
    ids = torch.cat([i.reshape(q.shape[0], -1) for q, _, i in sample])
    out = reference.compare(x, qs.to(x.device), ids, dists, k,
                            exact_rows=check["exact_rows"],
                            exact_tol=check.get("exact_tol", 0.0))
    checks.update({name: {"value": out[name], "limit": lim}
                   for name, lim in limits.items()})
    return out["recall"], checks
