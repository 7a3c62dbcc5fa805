"""Architecture registry of the port: the three pool models it serves (two
dense, one Mamba-2 SSM).

`base.py`, `qwen3_4b.py`, `h2o_danube_1_8b.py` and `mamba2_370m.py` are
copies of the JAX package's config modules (`repro.configs`), kept here so
the port imports nothing of `repro`."""
from .base import ATTN_DENSE, SSM, ModelConfig, reduced
from . import h2o_danube_1_8b, mamba2_370m, qwen3_4b

ARCHS = {m.CONFIG.name: m.CONFIG
         for m in (h2o_danube_1_8b, mamba2_370m, qwen3_4b)}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; options: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "ATTN_DENSE", "SSM", "ModelConfig", "get_config",
           "reduced"]
