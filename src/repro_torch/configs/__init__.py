"""Assigned architecture configs (--arch <id>) + reduced smoke variants.

The port of the JAX package's configs: the same ten architectures,
aliases and variants, with torch dtypes.

Each module exposes ``full()`` (the exact published config) and ``smoke()``
(same family, tiny dims — one CPU train step must pass).  ``get(arch_id)``
and ``ARCHS`` are the registry the launcher uses.
"""
from __future__ import annotations

import importlib

ARCHS = [
    "mamba2_130m",
    "granite_moe_1b_a400m",
    "dbrx_132b",
    "smollm_135m",
    "qwen15_32b",
    "deepseek_coder_33b",
    "qwen2_05b",
    "zamba2_12b",
    "internvl2_2b",
    "whisper_tiny",
]

# assigned ids (dashes) -> module names (underscores)
ALIASES = {
    "mamba2-130m": "mamba2_130m",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "dbrx-132b": "dbrx_132b",
    "smollm-135m": "smollm_135m",
    "qwen1.5-32b": "qwen15_32b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "qwen2-0.5b": "qwen2_05b",
    "zamba2-1.2b": "zamba2_12b",
    "internvl2-2b": "internvl2_2b",
    "whisper-tiny": "whisper_tiny",
}


VARIANTS = {
    # hillclimb variants (EXPERIMENTS.md §Perf)
    "qwen1.5-32b-pad48": ("qwen15_32b", "full_padded_heads"),
    "qwen1.5-32b-pad48-kvq": ("qwen15_32b", "full_padded_kvq"),
    "dbrx-132b-cf1": ("dbrx_132b", "full_cf1"),
}


def get(arch_id: str, smoke: bool = False):
    if arch_id in VARIANTS and not smoke:
        mod_name, fn = VARIANTS[arch_id]
        mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
        return getattr(mod, fn)()
    name = ALIASES.get(arch_id, arch_id.replace("-", "_").replace(".", ""))
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.smoke() if smoke else mod.full()
