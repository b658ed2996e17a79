"""Assigned-architecture registry, the port's copy of ``repro.configs``:
10 archs from the public pool plus the paper's own evaluation proxy.
``get_config(name)`` returns the full config; ``reduced_config(name)``
returns a structurally-identical small variant for CPU tests.
"""

from __future__ import annotations

import dataclasses

from .base import ModelConfig

__all__ = ["ARCHS", "get_config", "reduced_config", "ModelConfig"]


ARCHS = {
    # [moe] 32 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base]
    "granite-moe-1b-a400m": ModelConfig(
        name="granite-moe-1b-a400m", family="moe", n_layers=24, d_model=1024,
        n_heads=16, n_kv_heads=8, d_ff=512, vocab=49155, n_experts=32,
        top_k=8, attn_chunk=1024),
    # [moe] 16 experts top-4, fine-grained [hf:databricks/dbrx-base]
    "dbrx-132b": ModelConfig(
        name="dbrx-132b", family="moe", n_layers=40, d_model=6144,
        param_dtype="bfloat16", opt_factored=True, grad_accum=4,
        n_heads=48, n_kv_heads=8, d_ff=10752, vocab=100352, n_experts=16,
        top_k=4, attn_chunk=1024, fsdp=True),
    # [dense] WSD schedule, llama-like [arXiv:2404.06395]
    "minicpm-2b": ModelConfig(
        name="minicpm-2b", family="dense", n_layers=40, d_model=2304,
        n_heads=36, n_kv_heads=36, d_ff=5760, vocab=122753,
        attn_chunk=1024, schedule="wsd"),
    # [dense] 5:1 local:global, 128k context [hf:google/gemma-3]
    "gemma3-27b": ModelConfig(
        name="gemma3-27b", family="dense", n_layers=62, d_model=5376,
        n_heads=32, n_kv_heads=16, d_ff=21504, vocab=262144, window=1024,
        global_every=6, attn_chunk=1024, fsdp=True),
    # [dense] llama-arch, code, MQA [arXiv:2405.04324]
    "granite-20b": ModelConfig(
        name="granite-20b", family="dense", n_layers=52, d_model=6144,
        n_heads=48, n_kv_heads=1, d_ff=24576, vocab=49152, act="gelu",
        attn_chunk=1024, fsdp=True),
    # [dense] llama-arch [arXiv:2401.02954]
    "deepseek-7b": ModelConfig(
        name="deepseek-7b", family="dense", n_layers=30, d_model=4096,
        n_heads=32, n_kv_heads=32, d_ff=11008, vocab=102400,
        attn_chunk=1024),
    # [vlm] InternViT frontend (stub) + InternLM2 backbone [arXiv:2404.16821]
    "internvl2-2b": ModelConfig(
        name="internvl2-2b", family="vlm", n_layers=24, d_model=2048,
        n_heads=16, n_kv_heads=8, d_ff=8192, vocab=92553, head_dim=128,
        vision_prefix=256, attn_chunk=1024),
    # [hybrid] Mamba+attn 1:7 interleave, MoE every 2 [arXiv:2403.19887]
    "jamba-1.5-large-398b": ModelConfig(
        name="jamba-1.5-large-398b", family="hybrid", n_layers=72,
        param_dtype="bfloat16", opt_factored=True, grad_accum=8,
        d_model=8192, n_heads=64, n_kv_heads=8, d_ff=24576, vocab=65536,
        n_experts=16, top_k=2, moe_every=2, moe_offset=1, attn_every=8,
        ssm_state=16, attn_chunk=1024, fsdp=True),
    # [ssm] mamba-1 arch [arXiv:2410.05355]
    "falcon-mamba-7b": ModelConfig(
        name="falcon-mamba-7b", family="ssm", n_layers=64, d_model=4096,
        grad_accum=8,
        n_heads=0, n_kv_heads=0, d_ff=0, vocab=65024, ssm_state=16),
    # [audio] enc-dec, conv frontend (stub) [arXiv:2212.04356]
    "whisper-tiny": ModelConfig(
        name="whisper-tiny", family="encdec", n_layers=4, d_model=384,
        n_heads=6, n_kv_heads=6, d_ff=1536, vocab=51865, act="gelu",
        encoder_layers=4, encoder_len=1500, attn_chunk=1024,
        tie_embeddings=True),
    # The paper's own evaluation scale: a ViT-Small-like decoder proxy used
    # for the Table-1 style accuracy benchmark (see benchmarks/).
    "mgs-paper-eval": ModelConfig(
        name="mgs-paper-eval", family="dense", n_layers=12, d_model=384,
        n_heads=6, n_kv_heads=6, d_ff=1536, vocab=32768),
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def reduced_config(name: str) -> ModelConfig:
    """Structurally-identical tiny variant: same family/pattern, small dims.

    Used by the per-arch smoke tests (one forward/train step on CPU)."""
    cfg = get_config(name)
    kw = dict(
        n_layers=min(cfg.n_layers, 4), d_model=64, d_ff=128, vocab=256,
        attn_chunk=0, head_dim=0, fsdp=False, remat="none",
    )
    if cfg.n_heads:
        kw["n_heads"] = 4
        kw["n_kv_heads"] = 1 if cfg.n_kv_heads == 1 else (
            4 if cfg.n_kv_heads == cfg.n_heads else 2)
    if cfg.is_moe:
        kw.update(n_experts=4, top_k=min(cfg.top_k, 2),
                  capacity_factor=2.0)
    if cfg.window:
        kw.update(window=8, global_every=3, n_layers=6)
    if cfg.ssm_state:
        kw.update(ssm_state=4, ssm_chunk=8, expand=2)
    if cfg.is_hybrid:
        kw.update(n_layers=4, attn_every=2, moe_every=2, moe_offset=1)
    if cfg.encoder_layers:
        kw.update(encoder_layers=2, encoder_len=16, n_layers=2)
    if cfg.vision_prefix:
        kw["vision_prefix"] = 8
    if cfg.d_ff == 0:
        kw["d_ff"] = 0
    return dataclasses.replace(cfg, name=cfg.name + "-reduced", **kw)
