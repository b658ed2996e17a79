"""The model stack of the port: init, the teacher-forced forward and its
loss, serving caches, prefill, decode, and the paged slot pool of
continuous batching with its speculative draft / verify / rewind steps
(``repro.models.transformer``; every family: dense, MoE, pure SSM, the
attention / Mamba hybrid, encoder-decoder and the vision-prefix decoder).

Layers run in a Python loop over the stacked parameters (the reference's
``lax.scan``): :func:`layer_params` indexes one layer of every stacked
tensor and :class:`~repro_torch.quant.PreparedWeight`. Serving caches are
updated in place. In the group cache ``cache["pos"]`` is a host integer
(every row of a group decodes the same position); in the paged cache it
is a ``(slots,)`` device tensor beside the ``(slots, nb)`` block table.

A hybrid runs its periods (one attention and ``attn_every - 1`` Mamba
sublayers, FFN / MoE alternating) in a loop over groups. Only plain dense
stacks take the paged path; the other families serve on the group path,
as the reference's do.

On a mesh of ranks (dense and MoE stacks on the group path) every
prepared weight holds this rank's slice of its planes, the residual stream
and every batch-indexed activation are replicated (the reference's
``shard_batch=False``), and the reference's constraint sites are
honoured (``parallel.sharding.constrain``). The serving cache is built by
its logical dims: this rank's kv heads and, where the rules cut it, its
range of the sequence. The logits come out whole on every rank.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel.sharding import (constrain, current_rules,
                                           local_slices, replicate,
                                           resolve_spec, spec_axes,
                                           spec_entry)
from repro_torch.quant import (LaidOutWeight, PagedKVCache,
                               QuantizedKVCache, qeinsum)
from repro_torch.quant.kvcache import (init_paged_kv, init_quantized_kv,
                                       paged_rollback_kv, quantize_kv)
from .attention import KVCache, KVSeqShard, attention_apply
from .common import dtype_of, normal_param, rms_norm
from .ffn import ffn_apply
from .linear import proj
from .mamba import SSMCache, mamba_apply, mamba_decode_step
from .moe import moe_apply

__all__ = ["init_params", "param_shapes", "param_dims", "forward", "loss_fn",
           "init_cache",
           "prefill", "decode_step", "layer_params", "cast_params",
           "init_paged_cache", "adopt_slot", "release_slot",
           "decode_step_paged", "verify_step_paged",
           "draft_step_paged", "rewind_slots"]


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None):
    """Random parameters with the reference's tree, shapes and per-weight
    scales (``repro.models.init_params``), drawn from ``seed`` with a
    ``torch.Generator`` on ``device`` — not the reference's numbers (use
    :func:`repro_torch.convert.params_from_numpy` for those).

    Stacks lead with ``(n_layers,)``; a hybrid's with ``(groups,)`` and,
    below it, ``(sub,)`` for its Mamba / FFN / MoE sublayers; an
    encoder-decoder adds the ``encoder`` stack, ``encoder_norm`` and the
    decoder's ``cross`` stack."""
    device = torch.device("cpu") if device is None else torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    pdt = dtype_of(cfg.param_dtype)

    def w(shape, fan_in, scale=None):
        return normal_param(gen, shape, dtype=pdt, device=device,
                            scale=fan_in ** -0.5 if scale is None else scale)

    def ones(shape):
        return torch.ones(shape, dtype=pdt, device=device)

    def zeros(shape):
        return torch.zeros(shape, dtype=pdt, device=device)

    def a_log(shape):
        rates = torch.log(torch.arange(1, shape[-1] + 1, dtype=torch.float32,
                                       device=device))
        return rates.expand(shape).to(pdt).contiguous()

    return _param_tree(cfg, w, ones, zeros, a_log)


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """The shape of every leaf of :func:`init_params`'s tree, as tuples,
    with nothing allocated (what a mesh lays out before any rank holds a
    leaf)."""
    def shape(s, *_, **__):
        return tuple(s)
    return _param_tree(cfg, shape, shape, shape, shape)


def _param_tree(cfg: ModelConfig, w, ones, zeros, a_log):
    """:func:`init_params`'s tree with each leaf made by ``w(shape, fan_in[,
    scale])``, ``ones(shape)``, ``zeros(shape)`` or ``a_log(shape)``, in
    the order the generator draws them."""
    L, d, H, KV, hd = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                       cfg.n_kv_heads, cfg.head_dim)

    def attn(n):
        return {"wq": w(n + (d, H, hd), d), "wk": w(n + (d, KV, hd), d),
                "wv": w(n + (d, KV, hd), d), "wo": w(n + (H, hd, d), H * hd)}

    def ffn(n):
        h = cfg.d_ff
        mlp = ({"wg": w(n + (d, h), d), "wu": w(n + (d, h), d)}
               if cfg.act == "silu" else {"wi": w(n + (d, h), d)})
        mlp["wd"] = w(n + (h, d), h)
        return mlp

    def moe(n):
        # the reference's default fan-in is shape[0]: the expert count for
        # the (E, d, h) gate / up / in projections
        h, E = cfg.d_ff, cfg.n_experts
        mlp = ({"wg": w(n + (E, d, h), E), "wu": w(n + (E, d, h), E)}
               if cfg.act == "silu" else {"wi": w(n + (E, d, h), E)})
        mlp.update(wr=w(n + (d, E), d), wd=w(n + (E, h, d), h))
        return mlp

    def ssm(n):
        di, N, r, k = cfg.d_inner, cfg.ssm_state, cfg.dt_rank, cfg.d_conv
        return {"wx": w(n + (d, di), d), "wz": w(n + (d, di), d),
                "conv_w": w(n + (k, di), k, 1.0 / k),
                "conv_b": zeros(n + (di,)),
                "wdt_down": w(n + (di, r), di), "wdt_up": w(n + (r, di), r),
                "dt_bias": zeros(n + (di,)),
                "wB": w(n + (di, N), di), "wC": w(n + (di, N), di),
                "A_log": a_log(n + (di, N)),
                "D": ones(n + (di,)), "wo": w(n + (di, d), di)}

    params: Dict[str, Any] = {
        "embed": w((cfg.vocab, d), d),
        "final_norm": ones((d,)),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = w((d, cfg.vocab), d)
    if cfg.is_hybrid:
        G, per = _hybrid_groups(cfg), cfg.attn_every
        n_moe = _n_moe_sub(cfg)
        params["layers"] = {
            "ln_mix": ones((G, per, d)), "ln_ffn": ones((G, per, d)),
            "attn": attn((G,)), "ssm": ssm((G, per - 1)),
            "ffn": ffn((G, per - n_moe)), "moe": moe((G, n_moe))}
    elif cfg.is_ssm_only:
        params["layers"] = {"ln1": ones((L, d)), "ssm": ssm((L,))}
    else:
        mlp = moe((L,)) if cfg.is_moe else ffn((L,))
        params["layers"] = {"ln1": ones((L, d)), "attn": attn((L,)),
                            "ln2": ones((L, d)),
                            "moe" if cfg.is_moe else "ffn": mlp}
    if cfg.encoder_layers:
        Le = cfg.encoder_layers
        enc_ffn = ffn((Le,))
        params["encoder"] = {"ln1": ones((Le, d)), "attn": attn((Le,)),
                             "ln2": ones((Le, d)), "ffn": enc_ffn}
        params["encoder_norm"] = ones((d,))
        params["cross"] = {"ln": ones((L, d)), "attn": attn((L,))}
    return params


def param_dims(cfg: ModelConfig) -> Dict[str, Any]:
    """The logical dims of every leaf of :func:`init_params`'s tree (the
    reference's ``param_dims``): a tuple of dim names per leaf, stacks led
    by ``"layers"`` (a hybrid's by ``"groups"`` and, below it, ``"sub"``),
    MoE expert weights by ``"experts"``. The sharding rules resolve them
    into layouts (``parallel.sharding``)."""

    def attn():
        return {"wq": ("embed", "heads", "head_dim"),
                "wk": ("embed", "kv_heads", "head_dim"),
                "wv": ("embed", "kv_heads", "head_dim"),
                "wo": ("heads", "head_dim", "embed")}

    def ffn():
        mlp = ({"wg": ("embed", "ffn"), "wu": ("embed", "ffn")}
               if cfg.act == "silu" else {"wi": ("embed", "ffn")})
        mlp["wd"] = ("ffn", "embed")
        return mlp

    def moe():
        mlp = ({"wg": ("experts", "embed", "ffn"),
                "wu": ("experts", "embed", "ffn")} if cfg.act == "silu"
               else {"wi": ("experts", "embed", "ffn")})
        mlp.update(wr=("embed", "experts"), wd=("experts", "ffn", "embed"))
        return mlp

    def ssm():
        return {"wx": ("embed", "inner"), "wz": ("embed", "inner"),
                "conv_w": ("conv_k", "inner"), "conv_b": ("inner",),
                "wdt_down": ("inner", "dt_rank"),
                "wdt_up": ("dt_rank", "inner"), "dt_bias": ("inner",),
                "wB": ("inner", "ssm_state"), "wC": ("inner", "ssm_state"),
                "A_log": ("inner", "ssm_state"), "D": ("inner",),
                "wo": ("inner", "embed")}

    def lead(tree, prefix):
        if isinstance(tree, dict):
            return {k: lead(v, prefix) for k, v in tree.items()}
        return tuple(prefix) + tree

    def dense_layer(moe_layer: bool):
        return {"ln1": ("embed",), "attn": attn(), "ln2": ("embed",),
                "moe" if moe_layer else "ffn": moe() if moe_layer else ffn()}

    dims: Dict[str, Any] = {"embed": ("vocab", "embed"),
                            "final_norm": ("embed",)}
    if not cfg.tie_embeddings:
        dims["unembed"] = ("embed", "vocab")
    if cfg.is_hybrid:
        dims["layers"] = lead({
            "ln_mix": ("sub", "embed"), "ln_ffn": ("sub", "embed"),
            "attn": attn(), "ssm": lead(ssm(), ("sub",)),
            "ffn": lead(ffn(), ("sub",)), "moe": lead(moe(), ("sub",))},
            ("groups",))
    elif cfg.is_ssm_only:
        dims["layers"] = lead({"ln1": ("embed",), "ssm": ssm()},
                              ("layers",))
    else:
        dims["layers"] = lead(dense_layer(cfg.is_moe), ("layers",))
    if cfg.encoder_layers:
        dims["encoder"] = lead(dense_layer(False), ("layers",))
        dims["encoder_norm"] = ("embed",)
        dims["cross"] = lead({"ln": ("embed",), "attn": attn()},
                             ("layers",))
    return dims


def _hybrid_groups(cfg: ModelConfig) -> int:
    """A hybrid's periods: one attention and ``attn_every - 1`` Mamba
    sublayers each."""
    return cfg.n_layers // cfg.attn_every


def _n_moe_sub(cfg: ModelConfig) -> int:
    """The MoE sublayers of one hybrid period (the rest have a dense FFN)."""
    return sum(1 for j in range(cfg.attn_every)
               if j % cfg.moe_every == cfg.moe_offset)


def layer_params(tree, i: int):
    """Layer ``i`` of a stacked parameter (sub)tree."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    if isinstance(tree, LaidOutWeight):
        return tree.slice(i)
    return tree[i]


_KEEP_F32 = ("A_log",)  # SSM decay rates: exp() is precision-sensitive


def cast_params(params, cfg: ModelConfig):
    """Raw float32 matrices (rank >= 2) to the compute dtype; prepared
    weights, rank-1 leaves (norms) and ``_KEEP_F32`` leaves unchanged
    (``_cast_params``)."""
    cdt = dtype_of(cfg.compute_dtype)
    if dtype_of(cfg.param_dtype) == cdt:
        return params

    def cast(p, name=""):
        if isinstance(p, dict):
            return {k: cast(v, k) for k, v in p.items()}
        if (isinstance(p, torch.Tensor) and p.dim() >= 2
                and p.dtype == torch.float32 and name not in _KEEP_F32):
            return p.to(cdt)
        return p

    return cast(params)


def _embed_tokens(params, cfg: ModelConfig, tokens):
    """The embedding rows of ``tokens`` times ``sqrt(d_model)``.

    The reference's training forward takes a one-hot matmul lookup for MoE
    stacks with ``vocab % 128 == 0`` (``for_train``; a sharding choice for
    its gradient). Each of its outputs is a single term, so its values are
    the gather's: the port always gathers."""
    cdt = dtype_of(cfg.compute_dtype)
    x = params["embed"][tokens].to(cdt)
    # the reference multiplies by sqrt(d_model) rounded to the compute dtype
    s = torch.tensor(math.sqrt(cfg.d_model), dtype=cdt).item()
    return x * s


_LOGIT_DIMS = ("batch", "seq", "vocab_act")


def _logits(params, cfg: ModelConfig, x):
    pw = params.get("unembed_prepared")
    if pw is None and isinstance(params.get("unembed"), LaidOutWeight):
        pw = params["unembed"]
    if pw is not None and pw.layout is not None:
        # this rank's vocab columns, at the reference's constraint site,
        # then whole for the caller (the engine's argmax, the host)
        out = qeinsum("btd,dv->btv", x, pw, cfg.quant, site="logits",
                      out_dtype=torch.float32, gather=False)
        src = (None, None, spec_entry(pw.layout.n_axes))
        out = constrain(out, _LOGIT_DIMS, src)
        rules = current_rules()
        dst = rules.resolve(_LOGIT_DIMS, tuple(out.shape[:2])
                            + (pw.layout.shape[-1],)) if rules else src
        return replicate(out, dst, pw.layout.mesh)
    if pw is not None:
        return qeinsum("btd,dv->btv", x, pw, cfg.quant, site="logits",
                       out_dtype=torch.float32)
    if cfg.tie_embeddings:
        return qeinsum("btd,vd->btv", x, params["embed"], cfg.quant,
                       site="logits", out_dtype=torch.float32)
    return qeinsum("btd,dv->btv", x, params["unembed"], cfg.quant,
                   site="logits", out_dtype=torch.float32)


def _dense_body(pl, x, positions, cfg: ModelConfig, is_global, cache,
                cache_pos, block_table=None, lengths=None, cross_kv=None,
                cross_p=None, kv_seq=None):
    """One dense / MoE layer (serving: the MoE aux loss is dropped)."""
    return _dense_body_aux(pl, x, positions, cfg, is_global, cache,
                           cache_pos, block_table, lengths, cross_kv,
                           cross_p, kv_seq)[0]


def _dense_body_aux(pl, x, positions, cfg: ModelConfig, is_global, cache,
                    cache_pos, block_table=None, lengths=None, cross_kv=None,
                    cross_p=None, kv_seq=None):
    """One dense / MoE layer. Returns (x, the MoE aux loss: ``0.0`` for a
    dense FFN)."""
    h, _ = attention_apply(pl["attn"], rms_norm(x, pl["ln1"], cfg.norm_eps),
                           cfg, positions=positions, is_global=is_global,
                           cache=cache, cache_pos=cache_pos,
                           block_table=block_table, lengths=lengths,
                           kv_seq=kv_seq)
    x = constrain(x + h, ("batch", "seq", "embed_act"))
    if cross_p is not None:
        h, _ = attention_apply(cross_p["attn"],
                               rms_norm(x, cross_p["ln"], cfg.norm_eps), cfg,
                               positions=positions, cross_kv=cross_kv)
        x = x + h
    xn = rms_norm(x, pl["ln2"], cfg.norm_eps)
    if "moe" in pl:
        h, aux = moe_apply(pl["moe"], xn, cfg)
    else:
        h, aux = ffn_apply(pl["ffn"], xn, cfg), 0.0
    return constrain(x + h, ("batch", "seq", "embed_act")), aux


def _hybrid_group_body(pg, x, positions, cfg: ModelConfig, attn_cache,
                       cache_pos, ssm_cache, decode: bool):
    """:func:`_hybrid_group_aux` without the aux loss (serving)."""
    return _hybrid_group_aux(pg, x, positions, cfg, attn_cache, cache_pos,
                             ssm_cache, decode)[:2]


def _hybrid_group_aux(pg, x, positions, cfg: ModelConfig, attn_cache,
                      cache_pos, ssm_cache, decode: bool):
    """One hybrid period: attention on sublayer 0, Mamba on the others, MoE
    on sublayers ``j % moe_every == moe_offset`` and the dense FFN on the
    rest. Returns (x, the period's new SSM state, stacked over sublayers,
    the period's MoE aux loss)."""
    eps = cfg.norm_eps
    hs, convs = [], []
    aux = 0.0
    i_ffn = i_moe = 0
    for j in range(cfg.attn_every):
        xn = rms_norm(x, pg["ln_mix"][j], eps)
        if j == 0:
            h, _ = attention_apply(pg["attn"], xn, cfg, positions=positions,
                                   cache=attn_cache, cache_pos=cache_pos)
        else:
            sub = layer_params(pg["ssm"], j - 1)
            if decode:
                h, sc = mamba_decode_step(
                    sub, xn, SSMCache(ssm_cache.h[j - 1],
                                      ssm_cache.conv[j - 1]), cfg)
            else:
                h, sc = mamba_apply(sub, xn, cfg, return_state=True)
            hs.append(sc.h)
            convs.append(sc.conv)
        x = x + h
        xf = rms_norm(x, pg["ln_ffn"][j], eps)
        if j % cfg.moe_every == cfg.moe_offset:
            h, a = moe_apply(layer_params(pg["moe"], i_moe), xf, cfg)
            aux = aux + a
            i_moe += 1
        else:
            h = ffn_apply(layer_params(pg["ffn"], i_ffn), xf, cfg)
            i_ffn += 1
        x = x + h
    return x, SSMCache(torch.stack(hs), torch.stack(convs)), aux


def _ssm_body(pl, x, cfg: ModelConfig, cache, decode: bool):
    xn = rms_norm(x, pl["ln1"], cfg.norm_eps)
    if decode:
        h, new_cache = mamba_decode_step(pl["ssm"], xn, cache, cfg)
    else:
        h, new_cache = mamba_apply(pl["ssm"], xn, cfg, return_state=True)
    return x + h, new_cache


def _encode(params, cfg: ModelConfig, audio_embeds):
    """The encoder over precomputed frame embeddings (the frontend is a
    stub): non-causal self-attention with RoPE at positions 0..S-1, the
    FFN, then ``encoder_norm``."""
    x = audio_embeds.to(dtype_of(cfg.compute_dtype))
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    for i in range(cfg.encoder_layers):
        pl = layer_params(params["encoder"], i)
        h, _ = attention_apply(pl["attn"],
                               rms_norm(x, pl["ln1"], cfg.norm_eps), cfg,
                               positions=positions, causal=False)
        x = x + h
        x = x + ffn_apply(pl["ffn"], rms_norm(x, pl["ln2"], cfg.norm_eps),
                          cfg)
    return rms_norm(x, params["encoder_norm"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# Teacher-forced forward and loss (training and evaluation)
# ---------------------------------------------------------------------------


def _maybe_remat(cfg: ModelConfig):
    """``fn(*args)``, or under ``cfg.remat == "layer"`` while autograd
    records, the same call rematerialized in the backward pass (the
    reference's ``jax.checkpoint`` of each scanned layer body)."""
    if cfg.remat == "layer" and torch.is_grad_enabled():
        return lambda fn, *a: checkpoint(fn, *a, use_reentrant=False)
    return lambda fn, *a: fn(*a)


def forward(params, cfg: ModelConfig, batch: Dict[str, Any],
            return_features: bool = False):
    """Teacher-forced logits. ``batch``: ``tokens`` (B, T) [+
    ``vision_embeds`` (B, P, d) / ``audio_embeds`` (B, encoder_len, d) per
    family]. Returns (logits (B, T, V) float32, the summed MoE aux loss) —
    or (features (B, T, d), aux) with ``return_features`` (the streamed
    cross entropy's input).

    Layers run one at a time, a hybrid one period at a time, each
    checkpointed under ``cfg.remat == "layer"``. The reference barriers the
    scanned carry (``grad_barrier``: an XLA optimization barrier with an
    identity gradient, which keeps the saved carry in bf16); eager PyTorch
    keeps every tensor in the dtype it was made in, so here it is the
    identity and is left out. An encoder-decoder projects each decoder
    layer's cross K / V from the encoder output inside that layer; a VLM's
    vision prefix is prepended, then sliced off before the logits."""
    params = cast_params(params, cfg)
    tokens = batch["tokens"]
    B = tokens.shape[0]
    x = _embed_tokens(params, cfg, tokens)
    prefix = 0
    if cfg.vision_prefix:
        ve = batch["vision_embeds"].to(x.dtype)
        prefix = ve.shape[1]
        x = torch.cat([ve, x], dim=1)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    run = _maybe_remat(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    if cfg.is_hybrid:
        def gbody(x, pg):
            x, _, a = _hybrid_group_aux(pg, x, positions, cfg, None, 0, None,
                                        False)
            return x, a
        for g in range(_hybrid_groups(cfg)):
            x, a = run(gbody, x, layer_params(params["layers"], g))
            aux = aux + a
    elif cfg.is_ssm_only:
        def sbody(x, pl):
            return _ssm_body(pl, x, cfg, None, False)[0]
        for i in range(cfg.n_layers):
            x = run(sbody, x, layer_params(params["layers"], i))
    elif cfg.encoder_layers:
        enc = _encode(params, cfg, batch["audio_embeds"])

        def dbody(x, pl, pc):
            ckv = KVCache(k=proj(enc, pc["attn"]["wk"], cfg.quant),
                          v=proj(enc, pc["attn"]["wv"], cfg.quant))
            return _dense_body(pl, x, positions, cfg, True, None, 0,
                               cross_kv=ckv, cross_p=pc)
        for i in range(cfg.n_layers):
            x = run(dbody, x, layer_params(params["layers"], i),
                    layer_params(params["cross"], i))
    else:
        def body(x, pl, is_global):
            return _dense_body_aux(pl, x, positions, cfg, is_global, None, 0)
        for i in range(cfg.n_layers):
            x, a = run(body, x, layer_params(params["layers"], i),
                       cfg.layer_is_global_attn(i))
            aux = aux + a

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if prefix:
        x = x[:, prefix:]
    if return_features:
        return x, aux
    return _logits(params, cfg, x), aux


_CE_CHUNK_THRESHOLD = 65536  # stream the CE over vocab chunks above this
_CE_VCHUNK = 16384


def _streamed_ce(x, table, labels):
    """Per-token cross entropy without the (tokens, V) logits.

    Walks the (tied) embedding ``table`` in ``_CE_VCHUNK``-row chunks (the
    tail padded and masked) carrying a running (max, sumexp, label
    logit); each chunk is rematerialized in the backward pass, so the
    peak is O(tokens x chunk). Returns the nll, shaped as ``labels``."""
    B, T, D = x.shape
    V = table.shape[0]
    n = -(-V // _CE_VCHUNK)
    chunks = F.pad(table, (0, 0, 0, n * _CE_VCHUNK - V)).reshape(
        n, _CE_VCHUNK, D)
    labels = labels.to(torch.int64)
    cols = torch.arange(_CE_VCHUNK, device=x.device)
    neg_inf = torch.full((), float("-inf"), device=x.device)

    def step(m, s, ll, tc, base: int):
        logits = torch.einsum("btd,vd->btv", x.to(torch.float32),
                              tc.to(x.dtype).to(torch.float32))
        logits = torch.where((base + cols < V)[None, None], logits, neg_inf)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        s = s * torch.exp(m - m_new) + torch.exp(
            logits - m_new[..., None]).sum(-1)
        hit = cols[None, None] == (labels - base)[..., None]
        ll = ll + torch.where(hit, logits, torch.zeros_like(logits)).sum(-1)
        return m_new, s, ll

    remat = torch.is_grad_enabled()
    m = torch.full((B, T), float("-inf"), device=x.device)
    s = torch.zeros((B, T), device=x.device)
    ll = torch.zeros((B, T), device=x.device)
    for i in range(n):
        if remat:
            m, s, ll = checkpoint(step, m, s, ll, chunks[i], i * _CE_VCHUNK,
                                  use_reentrant=False)
        else:
            m, s, ll = step(m, s, ll, chunks[i], i * _CE_VCHUNK)
    return (m + torch.log(s)) - ll


def loss_fn(params, cfg: ModelConfig, batch):
    """Next-token cross entropy over ``batch["labels"]`` (weighted by an
    optional ``loss_mask``) plus 0.01 x the MoE load-balance aux loss.
    Tied vocabularies past 65536 take the streamed cross entropy. Returns
    (total, {"loss", "aux_loss", "tokens"})."""
    labels = batch["labels"].to(torch.int64)
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    if cfg.vocab > _CE_CHUNK_THRESHOLD and cfg.tie_embeddings:
        x, aux = forward(params, cfg, batch, return_features=True)
        nll = _streamed_ce(x, params["embed"], labels) * mask
    else:
        logits, aux = forward(params, cfg, batch)
        logits = logits.to(torch.float32)
        m = logits.amax(dim=-1, keepdim=True)
        lse = m[..., 0] + torch.log(torch.exp(logits - m).sum(-1))
        ll = torch.gather(logits, -1, labels[..., None])[..., 0]
        nll = (lse - ll) * mask
    tokens = mask.sum()
    loss = nll.sum() / torch.clamp_min(tokens, 1.0)
    return loss + 0.01 * aux, {"loss": loss, "aux_loss": aux,
                               "tokens": tokens}


def _n_attn_layers(cfg: ModelConfig) -> int:
    if cfg.is_ssm_only:
        return 0
    if cfg.is_hybrid:
        return _hybrid_groups(cfg)
    return cfg.n_layers


def _n_ssm_layers(cfg: ModelConfig) -> int:
    if cfg.is_ssm_only:
        return cfg.n_layers
    if cfg.is_hybrid:
        return cfg.n_layers - _hybrid_groups(cfg)
    return 0


def _local_planes(shape, dims, rules):
    """(this rank's shape, the :class:`KVSeqShard` or None) of a cache
    plane of global ``shape`` with logical ``dims`` under ``rules``."""
    if rules is None or getattr(rules.mesh, "size", 1) == 1:
        return tuple(shape), None
    spec = rules.resolve(dims, tuple(shape))
    sl = local_slices(spec, tuple(shape), rules.mesh)
    i = dims.index("kv_seq")
    seq = (KVSeqShard(rules.mesh, spec_axes(spec, i), sl[i].start,
                      sl[i].stop - sl[i].start)
           if spec_axes(spec, i) else None)
    return tuple(s.stop - s.start for s in sl), seq


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device=None,
               rules=None):
    """The serving cache: ``{"pos": 0}`` plus, per family, the attention
    planes ``"k", "v"[, "k_scale", "v_scale"]``, the SSM state
    ``"ssm_h", "ssm_conv"`` and the cross-attention planes ``"cross_k",
    "cross_v"[, "cross_k_scale", "cross_v_scale"]``.

    Packed (``cfg.quant.kv_cache == "packed"``): uint8 code planes
    ``(La, B, KV, S, hd)`` + float32 scale planes ``(La, B, KV, S)`` with
    ``S`` rounded up to the flash kernel's chunk (``quant.block_k``); the
    cross planes likewise, ``(L, B, KV, encoder_len rounded up, hd)``.
    Float: ``(La, B, max_len, KV, hd)`` and ``(L, B, encoder_len, KV, hd)``
    in ``cfg.kv_cache_dtype``. ``La`` is one a layer, one a hybrid
    period. SSM: the recurrent state ``(L, B, d_inner, N)`` in float32 and
    the conv state ``(L, B, d_conv - 1, d_inner)`` in bfloat16, as the
    reference keeps them; a hybrid's lead with ``(groups, sub)``.

    With ``rules`` on a mesh of ranks (dense / MoE stacks) the attention
    planes are this rank's part under their logical dims
    (``("layers", "batch", "kv_heads", "kv_seq", "head_dim")`` packed,
    ``("layers", "batch", "kv_seq", "kv_heads", "head_dim")`` float), and
    ``cache["kv_seq"]`` is the :class:`KVSeqShard` where the sequence is
    cut.
    """
    cache: Dict[str, Any] = {"pos": 0}
    packed = cfg.quant.quantized_kv
    chunk = cfg.quant.block_k
    La = _n_attn_layers(cfg)
    if rules is not None and getattr(rules.mesh, "size", 1) > 1 and (
            _n_ssm_layers(cfg) or cfg.encoder_layers):
        raise NotImplementedError(
            f"{cfg.name}: a serving cache on a mesh covers dense and MoE "
            "stacks (SSM / hybrid / encoder-decoder: ROADMAP A12.2c)")
    if La and packed:
        s_alloc = -(-max_len // chunk) * chunk
        (_, _, kv, s_loc, _), seq = _local_planes(
            (La, batch, cfg.n_kv_heads, s_alloc, cfg.head_dim),
            ("layers", "batch", "kv_heads", "kv_seq", "head_dim"), rules)
        qkv = init_quantized_kv((La, batch), kv, s_loc, cfg.head_dim,
                                device=device)
        cache.update(k=qkv.k_codes, v=qkv.v_codes, k_scale=qkv.k_scale,
                     v_scale=qkv.v_scale)
        if seq is not None:
            cache["kv_seq"] = seq
    elif La:
        shape, seq = _local_planes(
            (La, batch, max_len, cfg.n_kv_heads, cfg.head_dim),
            ("layers", "batch", "kv_seq", "kv_heads", "head_dim"), rules)
        if seq is not None:
            cache["kv_seq"] = seq
        kv_dtype = dtype_of(cfg.kv_cache_dtype)
        cache.update(k=torch.zeros(shape, dtype=kv_dtype, device=device),
                     v=torch.zeros(shape, dtype=kv_dtype, device=device))
    if _n_ssm_layers(cfg):
        lead = ((_hybrid_groups(cfg), cfg.attn_every - 1) if cfg.is_hybrid
                else (cfg.n_layers,))
        cache["ssm_h"] = torch.zeros(
            lead + (batch, cfg.d_inner, cfg.ssm_state), dtype=torch.float32,
            device=device)
        cache["ssm_conv"] = torch.zeros(
            lead + (batch, cfg.d_conv - 1, cfg.d_inner),
            dtype=torch.bfloat16, device=device)
    if cfg.encoder_layers:
        if packed:
            enc_pad = -(-cfg.encoder_len // chunk) * chunk
            cq = init_quantized_kv((cfg.n_layers, batch), cfg.n_kv_heads,
                                   enc_pad, cfg.head_dim, device=device)
            cache.update(cross_k=cq.k_codes, cross_v=cq.v_codes,
                         cross_k_scale=cq.k_scale, cross_v_scale=cq.v_scale)
        else:
            shape = (cfg.n_layers, batch, cfg.encoder_len, cfg.n_kv_heads,
                     cfg.head_dim)
            kv_dtype = dtype_of(cfg.kv_cache_dtype)
            cache.update(
                cross_k=torch.zeros(shape, dtype=kv_dtype, device=device),
                cross_v=torch.zeros(shape, dtype=kv_dtype, device=device))
    return cache


def _layer_cache(cache, i: int):
    if cache["k"].dtype == torch.uint8:
        return QuantizedKVCache(cache["k"][i], cache["v"][i],
                                cache["k_scale"][i], cache["v_scale"][i])
    return KVCache(cache["k"][i], cache["v"][i])


def _cross_cache(cache, i: int):
    """Layer ``i``'s stored cross K/V: packed codes or float planes."""
    if cache["cross_k"].dtype == torch.uint8:
        return QuantizedKVCache(cache["cross_k"][i], cache["cross_v"][i],
                                cache["cross_k_scale"][i],
                                cache["cross_v_scale"][i])
    return KVCache(cache["cross_k"][i], cache["cross_v"][i])


def _store_cross(pc, cfg: ModelConfig, enc, cache, i: int) -> KVCache:
    """Project layer ``i``'s cross K/V (``pc``: its ``cross`` params) from
    the encoder output, with no calibration site as in the reference; store
    them in the cache (packed: quantized once, the pad tail left zero) and
    return what the prefill attends: the fresh float K/V (packed), or the
    stored planes (float)."""
    k = proj(enc, pc["attn"]["wk"], cfg.quant)
    v = proj(enc, pc["attn"]["wv"], cfg.quant)
    S = k.shape[1]
    if cache["cross_k"].dtype == torch.uint8:
        for name, x in (("cross_k", k), ("cross_v", v)):
            codes, scale = quantize_kv(x, cfg.quant.kv_fmt)
            cache[name][i, :, :, :S] = codes.transpose(1, 2)
            cache[name + "_scale"][i, :, :, :S] = scale.transpose(1, 2)
        return KVCache(k, v)
    cache["cross_k"][i] = k
    cache["cross_v"][i] = v
    return _cross_cache(cache, i)


def _run_layers(params, cfg: ModelConfig, x, positions, cache, pos: int,
                decode: bool, enc=None):
    if cfg.is_ssm_only:
        for i in range(cfg.n_layers):
            sc = (SSMCache(cache["ssm_h"][i], cache["ssm_conv"][i])
                  if decode else None)
            x, sc = _ssm_body(layer_params(params["layers"], i), x, cfg, sc,
                              decode)
            cache["ssm_h"][i] = sc.h        # to the cache's dtypes
            cache["ssm_conv"][i] = sc.conv
        return x
    if cfg.is_hybrid:
        for g in range(_hybrid_groups(cfg)):
            sc = (SSMCache(cache["ssm_h"][g], cache["ssm_conv"][g])
                  if decode else None)
            x, sc = _hybrid_group_body(layer_params(params["layers"], g), x,
                                       positions, cfg, _layer_cache(cache, g),
                                       pos, sc, decode)
            cache["ssm_h"][g] = sc.h
            cache["ssm_conv"][g] = sc.conv
        return x
    for i in range(cfg.n_layers):
        cross_kv = cross_p = None
        if cfg.encoder_layers:
            cross_p = layer_params(params["cross"], i)
            cross_kv = (_store_cross(cross_p, cfg, enc, cache, i)
                        if enc is not None else _cross_cache(cache, i))
        x = _dense_body(layer_params(params["layers"], i), x, positions, cfg,
                        cfg.layer_is_global_attn(i), _layer_cache(cache, i),
                        pos, cross_kv=cross_kv, cross_p=cross_p,
                        kv_seq=cache.get("kv_seq"))
    return x


def prefill(params, cfg: ModelConfig, batch, cache):
    """Run the prompt ``batch["tokens"]`` (B, T) through the stack, filling
    ``cache`` in place. A VLM takes ``batch["vision_embeds"]`` (B, P, d),
    prepended to the tokens (positions and ``cache["pos"]`` count them); an
    encoder-decoder takes ``batch["audio_embeds"]`` (B, encoder_len, d),
    whose encoding fills the cross planes. Returns (last-position logits
    (B, V), cache)."""
    params = cast_params(params, cfg)
    tokens = batch["tokens"]
    x = _embed_tokens(params, cfg, tokens)
    if cfg.vision_prefix:
        x = torch.cat([batch["vision_embeds"].to(x.dtype), x], dim=1)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    enc = (_encode(params, cfg, batch["audio_embeds"])
           if cfg.encoder_layers else None)
    x = _run_layers(params, cfg, x, positions, cache, 0, decode=False,
                    enc=enc)
    cache["pos"] = S
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, x[:, -1:])[:, 0], cache


def decode_step(params, cfg: ModelConfig, tokens, cache):
    """One decode step. tokens: (B, 1). Returns (logits (B, V), cache)."""
    params = cast_params(params, cfg)
    B = tokens.shape[0]
    pos = int(cache["pos"])
    x = _embed_tokens(params, cfg, tokens)
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    x = _run_layers(params, cfg, x, positions, cache, pos, decode=True)
    cache["pos"] = pos + 1
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, x)[:, 0], cache


# ---------------------------------------------------------------------------
# Serving: paged KV pool (continuous batching)
# ---------------------------------------------------------------------------


def _require_paged_arch(cfg: ModelConfig):
    """The paged decode path covers plain dense decoder-only stacks with
    the packed cache (the reference's guard).

    Hybrid and SSM towers carry recurrent state (not paged),
    encoder-decoder and vision archs have prefill-time side inputs, and MoE
    routing couples tokens across the batch (expert capacity +
    per-expert-slice quantization scales), which would break the
    continuous engine's traffic-invariance contract: all of them keep the
    group engine.
    """
    if (cfg.is_hybrid or cfg.is_ssm_only or cfg.encoder_layers
            or cfg.vision_prefix or cfg.is_moe):
        raise NotImplementedError(
            "paged decode supports plain dense attention-only stacks "
            "(no SSM/hybrid, encoder-decoder, vision prefix, or MoE)")
    if not cfg.quant.quantized_kv:
        raise ValueError("paged decode requires quant.kv_cache='packed' "
                         "(the pool stores packed FP8 codes)")


def _paged_shapes(cfg: ModelConfig, slots: int, max_len: int,
                  n_blocks: int) -> Dict[str, tuple]:
    bs = cfg.quant.block_k
    full = (cfg.n_layers, n_blocks, cfg.n_kv_heads, bs, cfg.head_dim)
    return {"k": full, "v": full, "k_scale": full[:-1],
            "v_scale": full[:-1], "block_table": (slots, -(-max_len // bs)),
            "pos": (slots,)}


def paged_cache_specs(cfg: ModelConfig, slots: int, max_len: int,
                      n_blocks: int, rules) -> Dict[str, tuple]:
    """The spec of each entry of the pool under ``rules``, from the logical
    dims the reference's ``init_paged_cache`` gives them (the serve rules
    cut ``kv_heads`` over ``model`` where it divides, the rest whole)."""
    d = ("layers", "blocks", "kv_heads", "block", "head_dim")
    dims = {"k": d, "v": d, "k_scale": d[:-1], "v_scale": d[:-1],
            "block_table": ("slots", "table"), "pos": ("slots",)}
    return resolve_spec(dims, _paged_shapes(cfg, slots, max_len, n_blocks),
                        rules)


def init_paged_cache(cfg: ModelConfig, slots: int, max_len: int,
                     n_blocks: int, *, device=None, rules=None):
    """The paged decode state: one pool of ``n_blocks`` KV blocks (block
    size ``cfg.quant.block_k``, the flash kernel's chunk) shared by
    ``slots`` decode slots, each with a ``block_table`` row of width
    ``ceil(max_len / block_k)`` and a ``pos`` (next write position;
    ``pos == 0`` marks a free slot). Block 0 is the trash block.

    With ``rules`` on a mesh of ranks the pool holds this rank's kv heads
    (:func:`paged_cache_specs`); blocks, tables and positions are whole on
    every rank, so every rank's allocator sees the same calls.
    """
    _require_paged_arch(cfg)
    bs = cfg.quant.block_k
    kv = cfg.n_kv_heads
    if rules is not None and getattr(rules.mesh, "size", 1) > 1:
        sl = local_slices(
            paged_cache_specs(cfg, slots, max_len, n_blocks, rules)["k"],
            _paged_shapes(cfg, slots, max_len, n_blocks)["k"], rules.mesh)
        kv = sl[2].stop - sl[2].start
    nb = -(-max_len // bs)
    pool = init_paged_kv((cfg.n_layers,), n_blocks, kv, bs, cfg.head_dim,
                         device=device)
    return {"k": pool.k_codes, "v": pool.v_codes,
            "k_scale": pool.k_scale, "v_scale": pool.v_scale,
            "block_table": torch.zeros((slots, nb), dtype=torch.int32,
                                       device=device),
            "pos": torch.zeros((slots,), dtype=torch.int32, device=device)}


def _paged_kv_stack(cache) -> PagedKVCache:
    return PagedKVCache(cache["k"], cache["v"], cache["k_scale"],
                        cache["v_scale"])


def _paged_layer(cache, i: int) -> PagedKVCache:
    return PagedKVCache(cache["k"][i], cache["v"][i], cache["k_scale"][i],
                        cache["v_scale"][i])


def adopt_slot(cache, prefill_cache, slot: int, phys):
    """Copy a batch-1 packed prefill cache into pool blocks and activate
    ``slot``, in place.

    ``prefill_cache`` comes from :func:`prefill` at batch 1 (planes
    ``(L, 1, KV, S, hd)``, ``S`` a multiple of the block size). ``phys``
    is the slot's whole table row ``(nb,)``: the first ``S // bs``
    entries receive the prefill, the rest of the allocated entries are
    decode headroom, unallocated entries are the trash block.

    On a mesh of ranks both hold this rank's kv heads; a prefill cache
    whose sequence is cut (``prefill_cache["kv_seq"]``) is gathered whole
    first (the pool has no sequence dim).
    """
    k = cache["k"]
    L, P, KV, bs, hd = k.shape
    seq = prefill_cache.get("kv_seq")
    planes = {name: (prefill_cache[name] if seq is None else
                     seq.mesh.all_gather(prefill_cache[name], 3, seq.axes))
              for name in ("k", "v", "k_scale", "v_scale")}
    S = planes["k"].shape[3]
    if S % bs:
        raise ValueError(f"prefill length {S} not a multiple of block {bs}")
    if planes["k"].shape[2] != KV:
        raise ValueError(f"prefill cache of {planes['k'].shape[2]} kv heads "
                         f"for a pool of {KV}")
    ns = S // bs
    phys = torch.as_tensor(phys, dtype=torch.int32, device=k.device)
    pb = phys[:ns].to(torch.int64)
    for name, plane in planes.items():
        tail = tuple(plane.shape[4:])
        cache[name][:, pb] = plane.reshape((L, KV, ns, bs) + tail
                                           ).transpose(1, 2)
    cache["block_table"][slot] = phys
    cache["pos"][slot] = int(prefill_cache["pos"])
    return cache


def release_slot(cache, slot: int):
    """Free ``slot``: zero its table row (-> trash block) and its pos. Its
    blocks keep their bits until an adoption overwrites them, so no
    co-resident slot can be perturbed."""
    cache["block_table"][slot] = 0
    cache["pos"][slot] = 0
    return cache


def _paged_layers(params, cfg: ModelConfig, x, positions, cache, cache_pos,
                  lengths, n_layers: int):
    bt = cache["block_table"]
    for i in range(n_layers):
        x = _dense_body(layer_params(params["layers"], i), x, positions, cfg,
                        cfg.layer_is_global_attn(i), _paged_layer(cache, i),
                        cache_pos, block_table=bt, lengths=lengths)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, cfg, x)


def decode_step_paged(params, cfg: ModelConfig, tokens, cache):
    """One decode step over the paged slot pool. tokens: (slots, 1).

    Returns (logits (slots, V), cache). A free slot (``pos == 0``) walks
    no KV chunk and appends into the trash block, so it cannot change a
    live slot's bits; with ``quant.per_row_act`` the whole step is
    row-independent (the continuous engine's determinism contract).
    """
    _require_paged_arch(cfg)
    params = cast_params(params, cfg)
    pos = cache["pos"]
    live = pos > 0
    lengths = torch.where(live, pos + 1, 0)
    x = _embed_tokens(params, cfg, tokens)
    logits = _paged_layers(params, cfg, x, pos[:, None].to(torch.int64),
                           cache, pos, lengths, cfg.n_layers)
    cache["pos"] = torch.where(live, pos + 1, pos)
    return logits[:, 0], cache


# ---------------------------------------------------------------------------
# Serving: speculative decoding over the paged pool (draft -> verify ->
# rewind). Only rewind_slots advances ``pos``, by the accepted count.
# ---------------------------------------------------------------------------


def verify_step_paged(params, cfg: ModelConfig, tokens, cache):
    """Score ``k`` candidate tokens per slot in one multi-query step.

    tokens: ``(slots, k)`` — each slot's current token and its ``k - 1``
    drafts at positions ``pos .. pos + k - 1``. All ``k`` entries are
    appended, then each (slot, token) attends its own causal horizon, so
    ``logits[:, j]`` is bitwise the sequential step's at ``pos + j``.
    ``pos`` is not advanced. Returns ``(logits (slots, k, V), cache)``.
    """
    _require_paged_arch(cfg)
    params = cast_params(params, cfg)
    T = tokens.shape[1]
    pos = cache["pos"]
    lengths = torch.where(pos > 0, pos + 1, 0)
    x = _embed_tokens(params, cfg, tokens)
    positions = pos[:, None].to(torch.int64) + torch.arange(
        T, device=x.device)[None, :]
    logits = _paged_layers(params, cfg, x, positions, cache, pos, lengths,
                           cfg.n_layers)
    return logits, cache


def draft_step_paged(params, cfg: ModelConfig, tokens, cache, offset: int):
    """One self-draft step at position ``pos + offset`` through the first
    ``cfg.quant.draft_layers`` layers (plus final norm and logits head).

    The draft's K/V appends in those layers are overwritten by the verify
    append before any verify read, so draft numerics move only the
    acceptance rate. ``pos`` is not advanced.
    tokens: ``(slots, 1)``. Returns ``(logits (slots, V), cache)``.
    """
    _require_paged_arch(cfg)
    L = min(cfg.quant.draft_layers or cfg.n_layers, cfg.n_layers)
    params = cast_params(params, cfg)
    pos = cache["pos"]
    live = pos > 0
    dpos = torch.where(live, pos + offset, pos)
    lengths = torch.where(live, dpos + 1, 0)
    x = _embed_tokens(params, cfg, tokens)
    logits = _paged_layers(params, cfg, x, dpos[:, None].to(torch.int64),
                           cache, dpos, lengths, L)
    return logits[:, 0], cache


def rewind_slots(cache, keep, max_tokens: int):
    """Commit ``keep`` verified entries per slot and zero the rejected tail.

    After a verify appended ``max_tokens`` entries at ``pos ..`` and
    acceptance kept ``keep``, entries ``pos + keep ..`` are physically
    zeroed (codes and scales) and ``pos`` advances by ``keep``, so the pool
    is exactly what sequential decode would have left. Free slots pass
    through. keep: ``(slots,)`` int in ``[1, max_tokens]`` for live slots.
    """
    pos = cache["pos"]
    live = pos > 0
    keep = torch.as_tensor(keep, dtype=torch.int32, device=pos.device)
    start = torch.where(live, pos + keep, 0)
    count = torch.where(live, max_tokens - keep, 0)
    paged_rollback_kv(_paged_kv_stack(cache), cache["block_table"], start,
                      count, max_tokens)
    cache["pos"] = torch.where(live, pos + keep, pos)
    return cache
