"""The dense decoder stack of the port: init, serving cache, prefill and
decode (``repro.models.transformer``, dense family).

Layers run in a Python loop over the stacked parameters (the reference's
``lax.scan``): :func:`layer_params` indexes one layer of every stacked
tensor and :class:`~repro_torch.quant.PreparedWeight`. The serving cache
is updated in place; ``cache["pos"]`` is a host integer (every row of a
group decodes the same position).

The other families (MoE, hybrid, SSM, encoder-decoder, VLM) are ROADMAP
item A10 and raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.quant import PreparedWeight, QuantizedKVCache, qeinsum
from repro_torch.quant.kvcache import init_quantized_kv
from .attention import KVCache, attention_apply
from .common import dtype_of, normal_param, rms_norm
from .ffn import ffn_apply

__all__ = ["init_params", "init_cache", "prefill", "decode_step",
           "layer_params", "cast_params"]


def _require_dense(cfg: ModelConfig):
    if (cfg.is_moe or cfg.is_hybrid or cfg.is_ssm_only or cfg.encoder_layers
            or cfg.vision_prefix or not cfg.n_heads):
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}): the port runs the dense decoder "
            "family; MoE, hybrid, SSM, encoder-decoder and VLM stacks are "
            "ROADMAP item A10")


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None):
    """Random parameters with the reference's tree, shapes and per-weight
    scales (``repro.models.init_params``), drawn from ``seed`` with a
    ``torch.Generator`` on ``device`` — not the reference's numbers (use
    :func:`repro_torch.convert.params_from_numpy` for those)."""
    _require_dense(cfg)
    device = torch.device("cpu") if device is None else torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    pdt = dtype_of(cfg.param_dtype)
    L, d, H, KV, hd = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                       cfg.n_kv_heads, cfg.head_dim)

    def w(shape, fan_in, scale=None):
        return normal_param(gen, shape, dtype=pdt, device=device,
                            scale=fan_in ** -0.5 if scale is None else scale)

    def ones(shape):
        return torch.ones(shape, dtype=pdt, device=device)

    params: Dict[str, Any] = {
        "embed": w((cfg.vocab, d), d),
        "final_norm": ones((d,)),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = w((d, cfg.vocab), d)
    ffn = ({"wg": w((L, d, cfg.d_ff), d), "wu": w((L, d, cfg.d_ff), d)}
           if cfg.act == "silu" else {"wi": w((L, d, cfg.d_ff), d)})
    ffn["wd"] = w((L, cfg.d_ff, d), cfg.d_ff)
    params["layers"] = {
        "ln1": ones((L, d)),
        "attn": {"wq": w((L, d, H, hd), d), "wk": w((L, d, KV, hd), d),
                 "wv": w((L, d, KV, hd), d),
                 "wo": w((L, H, hd, d), H * hd)},
        "ln2": ones((L, d)),
        "ffn": ffn,
    }
    return params


def layer_params(tree, i: int):
    """Layer ``i`` of a stacked parameter (sub)tree."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    if isinstance(tree, PreparedWeight):
        return tree.slice(i)
    return tree[i]


def cast_params(params, cfg: ModelConfig):
    """Raw float32 matrices (rank >= 2) to the compute dtype; prepared
    weights and rank-1 leaves (norms) unchanged (``_cast_params``)."""
    cdt = dtype_of(cfg.compute_dtype)
    if dtype_of(cfg.param_dtype) == cdt:
        return params

    def cast(p):
        if isinstance(p, dict):
            return {k: cast(v) for k, v in p.items()}
        if (isinstance(p, torch.Tensor) and p.dim() >= 2
                and p.dtype == torch.float32):
            return p.to(cdt)
        return p

    return cast(params)


def _embed_tokens(params, cfg: ModelConfig, tokens):
    cdt = dtype_of(cfg.compute_dtype)
    x = params["embed"][tokens].to(cdt)
    # the reference multiplies by sqrt(d_model) rounded to the compute dtype
    s = torch.tensor(math.sqrt(cfg.d_model), dtype=cdt).item()
    return x * s


def _logits(params, cfg: ModelConfig, x):
    pw = params.get("unembed_prepared")
    if pw is not None:
        return qeinsum("btd,dv->btv", x, pw, cfg.quant,
                       out_dtype=torch.float32)
    if cfg.tie_embeddings:
        return qeinsum("btd,vd->btv", x, params["embed"], cfg.quant,
                       out_dtype=torch.float32)
    return qeinsum("btd,dv->btv", x, params["unembed"], cfg.quant,
                   out_dtype=torch.float32)


def _dense_body(pl, x, positions, cfg: ModelConfig, is_global, cache,
                cache_pos: int):
    h, _ = attention_apply(pl["attn"], rms_norm(x, pl["ln1"], cfg.norm_eps),
                           cfg, positions=positions, is_global=is_global,
                           cache=cache, cache_pos=cache_pos)
    x = x + h
    x = x + ffn_apply(pl["ffn"], rms_norm(x, pl["ln2"], cfg.norm_eps), cfg)
    return x


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device=None):
    """The serving cache: ``{"pos": 0, "k", "v"[, "k_scale", "v_scale"]}``.

    Packed (``cfg.quant.kv_cache == "packed"``): uint8 code planes
    ``(L, B, KV, S, hd)`` + float32 scale planes ``(L, B, KV, S)`` with
    ``S`` rounded up to the flash kernel's chunk (``quant.block_k``).
    Float: ``(L, B, max_len, KV, hd)`` in ``cfg.kv_cache_dtype``.
    """
    _require_dense(cfg)
    L = cfg.n_layers
    cache: Dict[str, Any] = {"pos": 0}
    if cfg.quant.quantized_kv:
        chunk = cfg.quant.block_k
        s_alloc = -(-max_len // chunk) * chunk
        qkv = init_quantized_kv((L, batch), cfg.n_kv_heads, s_alloc,
                                cfg.head_dim, device=device)
        cache.update(k=qkv.k_codes, v=qkv.v_codes, k_scale=qkv.k_scale,
                     v_scale=qkv.v_scale)
    else:
        shape = (L, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        kv_dtype = dtype_of(cfg.kv_cache_dtype)
        cache.update(k=torch.zeros(shape, dtype=kv_dtype, device=device),
                     v=torch.zeros(shape, dtype=kv_dtype, device=device))
    return cache


def _layer_cache(cache, i: int):
    if cache["k"].dtype == torch.uint8:
        return QuantizedKVCache(cache["k"][i], cache["v"][i],
                                cache["k_scale"][i], cache["v_scale"][i])
    return KVCache(cache["k"][i], cache["v"][i])


def _run_layers(params, cfg: ModelConfig, x, positions, cache, pos: int):
    for i in range(cfg.n_layers):
        x = _dense_body(layer_params(params["layers"], i), x, positions, cfg,
                        cfg.layer_is_global_attn(i), _layer_cache(cache, i),
                        pos)
    return x


def prefill(params, cfg: ModelConfig, batch, cache):
    """Run the prompt ``batch["tokens"]`` (B, T) through the stack, filling
    ``cache`` in place. Returns (last-position logits (B, V), cache)."""
    _require_dense(cfg)
    params = cast_params(params, cfg)
    tokens = batch["tokens"]
    B, T = tokens.shape
    x = _embed_tokens(params, cfg, tokens)
    positions = torch.arange(T, device=x.device)[None].expand(B, T)
    x = _run_layers(params, cfg, x, positions, cache, 0)
    cache["pos"] = T
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, x[:, -1:])[:, 0], cache


def decode_step(params, cfg: ModelConfig, tokens, cache):
    """One decode step. tokens: (B, 1). Returns (logits (B, V), cache)."""
    _require_dense(cfg)
    params = cast_params(params, cfg)
    B = tokens.shape[0]
    pos = int(cache["pos"])
    x = _embed_tokens(params, cfg, tokens)
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    x = _run_layers(params, cfg, x, positions, cache, pos)
    cache["pos"] = pos + 1
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, x)[:, 0], cache
