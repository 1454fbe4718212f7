"""Architecture registry of the port: get_config / reduced_config for the
reference's ten architectures (the reference's `repro.configs`), in its
order, and the dry run's cells (`SHAPES`, `input_specs`, `cache_spec`).
Each module defines CONFIG (full size) and REDUCED (CPU tests), field
for field the reference's.
"""

from __future__ import annotations

import importlib

ARCHS = [
    "h2o_danube3_4b",
    "qwen3_14b",
    "minitron_8b",
    "granite_3_8b",
    "deepseek_v2_lite_16b",
    "dbrx_132b",
    "xlstm_350m",
    "paligemma_3b",
    "musicgen_large",
    "jamba_v01_52b",
]

ALIASES = {a.replace("_", "-"): a for a in ARCHS}


def _module(name: str):
    name = ALIASES.get(name, name).replace("-", "_").replace(".", "")
    if name not in ARCHS:
        raise ValueError(f"unknown architecture {name!r}; known: {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str):
    return _module(name).CONFIG


def reduced_config(name: str):
    return _module(name).REDUCED


def list_archs():
    return list(ARCHS)


from repro_torch.configs.shapes import SHAPES, cache_spec, input_specs  # noqa: E402

__all__ = ["ARCHS", "get_config", "list_archs", "reduced_config",
           "SHAPES", "input_specs", "cache_spec"]
