"""Architecture registry of the port: the reference's ten architectures
(dense, MoE, MLA + MoE, Mamba-2 SSM, the hybrid with a shared attention
block, the vision-language internvl2-76b with its patch prefix and the
encoder-decoder seamless-m4t-medium with cross attention).

`base.py` and the config modules are copies of the JAX package's
(`repro.configs`), kept here so the port imports nothing of `repro`."""
from .base import (ATTN_DENSE, INPUT_SHAPES, SSM, ModelConfig, ShapeConfig,
                   reduced)
from . import (deepseek_v2_236b, h2o_danube_1_8b, internvl2_76b,
               llama4_maverick_400b_a17b, mamba2_370m, qwen1_5_32b, qwen3_4b,
               seamless_m4t_medium, starcoder2_15b, zamba2_7b)

ARCHS = {m.CONFIG.name: m.CONFIG
         for m in (h2o_danube_1_8b, qwen3_4b, llama4_maverick_400b_a17b,
                   internvl2_76b, mamba2_370m, seamless_m4t_medium,
                   deepseek_v2_236b, qwen1_5_32b, starcoder2_15b, zamba2_7b)}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; options: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    return INPUT_SHAPES[name]


__all__ = ["ARCHS", "ATTN_DENSE", "INPUT_SHAPES", "SSM", "ModelConfig",
           "ShapeConfig", "get_config", "get_shape", "reduced"]
