"""Architecture registry: --arch <id> resolution + per-arch shape skips."""
from __future__ import annotations

import importlib

from .base import SHAPES, ArchConfig, ShapeConfig

_MODULES = {
    "deepseek-v2-236b": "deepseek_v2_236b",
    "qwen2-moe-a2.7b": "qwen2_moe_a27b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "rwkv6-1.6b": "rwkv6_16b",
    "command-r-plus-104b": "command_r_plus_104b",
    "phi3-mini-3.8b": "phi3_mini_38b",
    "minitron-4b": "minitron_4b",
    "phi3-medium-14b": "phi3_medium_14b",
    "hubert-xlarge": "hubert_xlarge",
    "recurrentgemma-9b": "recurrentgemma_9b",
}

ARCH_IDS = tuple(_MODULES)


def _mod(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; options: {ARCH_IDS}")
    return importlib.import_module(f".{_MODULES[arch]}", __package__)


# §Perf-validated production overrides (EXPERIMENTS.md): applied by
# launchers with --production; kept out of the defaults so the paper-
# faithful baseline artifacts stay reproducible.
PRODUCTION_OVERRIDES: dict[str, dict] = {
    "deepseek-v2-236b": {"moe_impl": "shard_map", "remat": "dots",
                         "grad_accum": 8, "mla_absorb": True},
    "qwen2-moe-a2.7b": {"moe_impl": "shard_map"},
    "command-r-plus-104b": {"kv_replicate_to": 16, "grad_accum": 8},
    "minitron-4b": {"kv_replicate_to": 16},
    "qwen2-vl-2b": {"kv_replicate_to": 16},
    "phi3-mini-3.8b": {"remat": "dots", "grad_accum": 8},
    "phi3-medium-14b": {"remat": "dots", "grad_accum": 8},
    "recurrentgemma-9b": {"kv_replicate_to": 16},
}


def with_production(cfg: ArchConfig, arch: str) -> ArchConfig:
    """``cfg`` (full, smoke or cut to depth) with ``arch``'s production
    overrides."""
    import dataclasses
    return dataclasses.replace(cfg, **PRODUCTION_OVERRIDES.get(arch, {}))


def get_config(arch: str, *, production: bool = False) -> ArchConfig:
    cfg = _mod(arch).CONFIG
    return with_production(cfg, arch) if production else cfg


def get_smoke(arch: str) -> ArchConfig:
    return _mod(arch).SMOKE


def shape_supported(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Per-assignment skips (DESIGN.md §7): returns (supported, reason)."""
    if cfg.family == "audio" and shape.kind == "decode":
        return False, "encoder-only: no decode step"
    sub_quadratic = cfg.family in ("ssm", "hybrid")
    if shape.seq_len > 100_000 and not sub_quadratic:
        return False, "long_500k needs sub-quadratic attention"
    return True, ""


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells, with skip annotations."""
    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            ok, why = shape_supported(cfg, shape)
            if ok or include_skipped:
                out.append((arch, shape.name, ok, why))
    return out
