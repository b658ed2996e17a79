"""Model/architecture configuration schema (the port's copy of
``repro.configs.base``: the same fields, defaults and derived properties).

One ``ModelConfig`` drives the whole zoo: dense decoders, GQA/MQA,
sliding-window (gemma3), MoE (granite/dbrx/jamba), Mamba SSM
(falcon-mamba), hybrid attention:mamba interleave (jamba), encoder-decoder
(whisper) and VLM prefix stubs (internvl2). Every assigned architecture is
a concrete instance in :mod:`repro.configs` — see the per-arch files.
"""

from __future__ import annotations

import dataclasses

from repro_torch.quant.config import QuantConfig

__all__ = ["ModelConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int                # 0 => attention-free (pure SSM)
    n_kv_heads: int
    d_ff: int                   # dense FFN hidden (per-expert size for MoE)
    vocab: int
    head_dim: int = 0           # 0 => d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1          # MoE FFN on layers with index % moe_every == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25
    n_groups: int = 0           # dispatch groups (0 => auto: token shards)

    # --- attention pattern ---
    window: int = 0             # sliding-window size for local layers
    global_every: int = 0       # gemma3: layer i is global iff i % global_every == global_every-1
    attn_chunk: int = 0         # online-softmax KV-chunk (0 => dense scores)

    # --- SSM / hybrid ---
    ssm_state: int = 0          # mamba d_state (0 => no SSM layers)
    d_conv: int = 4
    expand: int = 2             # mamba d_inner = expand * d_model
    dt_rank: int = 0            # 0 => ceil(d_model / 16)
    ssm_chunk: int = 64
    attn_every: int = 0         # jamba: layer i is attention iff i % attn_every == 0

    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_len: int = 0        # precomputed frame embeddings (frontend stub)

    # --- VLM (internvl2) ---
    vision_prefix: int = 0      # precomputed patch embeddings (frontend stub)

    # --- numerics / training ---
    act: str = "silu"           # silu (SwiGLU) | gelu (plain MLP)
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    quant: QuantConfig = QuantConfig()
    remat: str = "layer"        # none | layer  (checkpoint each scanned layer)
    schedule: str = "cosine"    # cosine | wsd (minicpm)

    # --- parallelism hints ---
    fsdp: bool = False          # additionally shard params over the data axis
    seq_shard_kv: bool = True   # shard long KV caches over the data axis
    # KV-cache storage format. "fp8_e4m3" stores K/V in the paper's E4M3
    # (1 byte/elem) — the MGS narrow-format theme applied to cache memory.
    kv_cache_dtype: str = "bfloat16"
    # training memory knobs (set for the 100B+ archs)
    opt_factored: bool = False  # Adafactor-style factored second moment
    grad_accum: int = 1         # microbatch gradient accumulation

    def __post_init__(self):
        if self.n_heads and self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.ssm_state and self.dt_rank == 0:
            object.__setattr__(self, "dt_rank", -(-self.d_model // 16))

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_hybrid(self) -> bool:
        return self.ssm_state > 0 and self.attn_every > 0

    @property
    def is_ssm_only(self) -> bool:
        return self.ssm_state > 0 and self.n_heads == 0

    @property
    def full_attention_only(self) -> bool:
        """True when every layer is full (quadratic) attention — such archs
        skip long_500k (see DESIGN.md §Arch-applicability)."""
        return (self.ssm_state == 0) and (self.window == 0)

    def layer_is_attn(self, i: int) -> bool:
        if self.is_ssm_only:
            return False
        if self.is_hybrid:
            return i % self.attn_every == 0
        return True

    def layer_is_global_attn(self, i: int) -> bool:
        if self.global_every <= 0:
            return True
        return i % self.global_every == self.global_every - 1

    def layer_is_moe(self, i: int) -> bool:
        if not self.is_moe:
            return False
        return i % self.moe_every == self.moe_offset

    def n_params(self) -> int:
        """Analytic parameter count (embedding + per-layer blocks)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        total = v * d  # embedding (tied head)
        if not self.tie_embeddings:
            total += v * d
        glu = 3 if self.act == "silu" else 2
        dense_ffn = glu * d * f
        moe_ffn = self.n_experts * (glu * d * f) + d * self.n_experts
        attn = 0
        if self.n_heads:
            attn = (d * self.n_heads * self.head_dim * 2
                    + d * self.n_kv_heads * self.head_dim * 2)
        mamba = 0
        if self.ssm_state:
            di, r, n = self.d_inner, self.dt_rank, self.ssm_state
            mamba = (d * 2 * di + di * self.d_conv + di * (r + 2 * n)
                     + r * di + di * n + di + di * d)
        for i in range(self.n_layers):
            total += 2 * d  # norms
            if self.layer_is_attn(i):
                total += attn
            elif self.ssm_state:
                total += mamba
            total += moe_ffn if self.layer_is_moe(i) else dense_ffn
        for _ in range(self.encoder_layers):
            total += attn + dense_ffn + 2 * d
            total += attn + d * self.n_heads * self.head_dim * 2  # cross-attn kv proj in decoder... approximated
        return total

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: top_k of n_experts)."""
        if not self.is_moe:
            return self.n_params()
        d, f = self.d_model, self.d_ff
        glu = 3 if self.act == "silu" else 2
        per_layer_inactive = (self.n_experts - self.top_k) * glu * d * f
        n_moe_layers = sum(self.layer_is_moe(i) for i in range(self.n_layers))
        return self.n_params() - n_moe_layers * per_layer_inactive
