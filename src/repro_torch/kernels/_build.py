"""Build the CUDA kernels with ``nvcc`` at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles into its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds).  All sources are
compiled at once, one ``nvcc`` process each, into
``<checkout>/build/repro_torch/<hash>/``, where the hash covers every file
under ``csrc/`` and the flags: an edited source rebuilds, an unchanged one
loads the existing library.

Flags: ``sm_90a`` (Hopper) and no ``--use_fast_math``: the kernels' bucket
ids must equal the plain versions' for the same estimate, which needs IEEE
division, ``floorf`` and ``sqrtf``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
KERNELS = ("fused_scan", "pq_adc", "l2_rerank", "bucket_hist", "rabitq_fused",
           "shard_collect", "rabitq_est", "sample_plan", "lane_mask")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOGS: dict[str, str] = {}


def build_root() -> Path:
    """``build/repro_torch`` at the root of the checkout (gitignored)."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def source_hash() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def lib_path(name: str) -> Path:
    return build_root() / source_hash() / f"lib{name}.so"


def build_all() -> dict[str, Path]:
    """Compile every kernel library that is missing, all in parallel; raise
    with the compiler's output if any build fails."""
    paths = {name: lib_path(name) for name in KERNELS}
    todo = [n for n, p in paths.items() if not p.exists()]
    if not todo:
        return paths
    out_dir = paths[KERNELS[0]].parent
    out_dir.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [exe, *FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (exit {proc.returncode})\n{log}")
            os.unlink(tmp)
        else:
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all()[name]))
        _LIBS[name] = lib
    return lib
