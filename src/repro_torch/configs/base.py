"""Configuration dataclasses for the repro framework.

A ``ModelConfig`` fully describes one member of the serving pool (any of the
ten assigned architectures).  The layer stack is described by a *pattern* of
``LayerSpec`` entries that is scanned ``n_groups`` times (plus an optional
tail pattern), which keeps heterogeneous stacks (interleaved MoE, hybrid
SSM+shared-attention) exact while still lowering to a small ``lax.scan`` HLO.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Layer specification
# ---------------------------------------------------------------------------

# kind      : "attn" | "mla" | "ssm" | "shared_attn"
# ffn       : "dense" | "moe" | "none"
LayerSpec = Tuple[str, str]

ATTN_DENSE: LayerSpec = ("attn", "dense")
ATTN_MOE: LayerSpec = ("attn", "moe")
MLA_MOE: LayerSpec = ("mla", "moe")
SSM: LayerSpec = ("ssm", "none")
SHARED_ATTN: LayerSpec = ("shared_attn", "none")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                       # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int                        # total blocks (for bookkeeping)
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    # layer-stack pattern (scanned): pattern repeated n_groups times,
    # then tail_pattern repeated n_tail_groups times.
    pattern: Tuple[LayerSpec, ...] = (ATTN_DENSE,)
    n_groups: int = 0                    # 0 -> n_layers // len(pattern)
    tail_pattern: Tuple[LayerSpec, ...] = ()
    n_tail_groups: int = 0

    head_dim: int = 0                    # 0 -> d_model // n_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    sliding_window: int = 0              # 0 -> full attention
    rope_theta: float = 10000.0

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    experts_top_k: int = 1
    moe_d_ff: int = 0                    # routed expert intermediate size
    capacity_factor: float = 1.25

    # --- MLA (DeepSeek-V2) ---
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # --- SSM (Mamba-2 SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv: int = 4
    ssm_n_groups: int = 1                # B/C groups

    # --- hybrid (Zamba-2): shared attention block params are NOT scanned ---
    shared_attn_window: int = 0          # sliding window used in long mode

    # --- encoder-decoder (Seamless-M4T) ---
    encoder_layers: int = 0              # 0 -> decoder-only

    # --- modality frontend ---
    frontend: str = "text"               # text|vision|audio
    frontend_dim: int = 0                # dim of stubbed frontend embeddings
    num_patches: int = 0                 # vision: patches prepended to text

    # --- numerics / execution ---
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"           # full | dots (save matmul outputs)
    use_pallas: bool = False             # True only on real TPU
    moe_shard_map: bool = False          # explicit all-to-all expert parallel
    cross_kv_cache: bool = True          # cache enc-dec cross K/V at prefill
    mla_naive_decode: bool = False       # §Perf E baseline: expand latent cache

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))
        if self.n_groups == 0 and self.pattern:
            object.__setattr__(self, "n_groups", max(1, self.n_layers // len(self.pattern)))

    # ---- derived ----
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def attention_free(self) -> bool:
        kinds = {k for k, _ in self.pattern + self.tail_pattern}
        return kinds <= {"ssm"}

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k decode."""
        if self.arch_type in ("ssm", "hybrid"):
            return True
        return self.sliding_window > 0

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    def total_blocks(self) -> int:
        return len(self.pattern) * self.n_groups + len(self.tail_pattern) * self.n_tail_groups

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                            # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

INPUT_SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Reduced variant of the same architecture family for CPU smoke tests:
    2 layers, d_model<=512, <=4 experts."""
    d_model = min(cfg.d_model, 256)
    n_heads = min(cfg.n_heads, 4) or 4
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    # keep GQA ratio flavor
    if 0 < cfg.n_kv_heads < cfg.n_heads:
        n_kv = max(1, n_heads // 2)
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=2,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        head_dim=d_model // n_heads,
        n_groups=1,
        tail_pattern=(),
        n_tail_groups=0,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        shared_attn_window=min(cfg.shared_attn_window, 64) if cfg.shared_attn_window else 0,
        remat=False,
        dtype="float32",
    )
    # pattern: keep at most 2 blocks, preserving the family's flavor mix
    # (e.g. zamba2 (ssm x5, shared_attn) -> (ssm, shared_attn))
    if len(cfg.pattern) >= 2:
        pat = (cfg.pattern[0], cfg.pattern[-1])
    else:
        pat = cfg.pattern * 2
    kw["pattern"] = pat
    if cfg.n_experts:
        kw["n_experts"] = min(cfg.n_experts, 4)
        kw["experts_top_k"] = min(cfg.experts_top_k, 2)
        kw["n_shared_experts"] = min(cfg.n_shared_experts, 1)
        kw["moe_d_ff"] = min(cfg.moe_d_ff or cfg.d_ff, 256)
    if cfg.kv_lora_rank:
        kw["kv_lora_rank"] = 32
        kw["q_lora_rank"] = 32 if cfg.q_lora_rank else 0
        kw["qk_nope_dim"] = 32
        kw["qk_rope_dim"] = 16
        kw["v_head_dim"] = 32
        kw["head_dim"] = 32
    if cfg.ssm_state:
        kw["ssm_state"] = min(cfg.ssm_state, 16)
        kw["ssm_head_dim"] = 32
        kw["ssm_chunk"] = 16
    if cfg.encoder_layers:
        kw["encoder_layers"] = 1
    if cfg.frontend != "text":
        kw["frontend_dim"] = min(cfg.frontend_dim or 256, 128)
        kw["num_patches"] = min(cfg.num_patches or 16, 8)
    kw.update(overrides)
    return cfg.replace(**kw)
