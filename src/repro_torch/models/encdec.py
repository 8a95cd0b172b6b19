"""Encoder-decoder trunk (the seamless-m4t backbone).

Port of ``repro/models/encdec.py``.  Encoder: a bidirectional
self-attention stack over precomputed frame embeddings (the audio frontend
is a stub: the caller supplies (B, S, D) embeddings) or source token ids.
Decoder: causal self-attention, cross-attention over the encoder's output,
and the MLP.  The decode cache keeps the reference's layout: ``k`` and
``v`` (L, B, Hkv, cap, hd), written in place by decode, and ``enc_out``
(B, S_enc, D); decode recomputes each layer's cross K/V from ``enc_out``
every step, as the reference does.

On the card the decoder's prefill self-attention runs the hand-written
flash kernel (positions 0..S-1, one launch a layer); the encoder's
attention and cross-attention are bidirectional, which the causal kernel
does not compute, and run the reference's plain ``sdpa`` on both devices.
Under autograd (training) every attention takes the plain route, and each
encoder and decoder layer is recomputed in the backward pass unless
cfg.remat is "none", as the reference checkpoints its scan bodies.  Over a
mesh (a ``parallel.ShardedLM``) every attention runs on each rank's heads,
the encoder's output whole on each model rank.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models import parallel as P
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (Block, _param, _prefill_cache,
                                            init_block, project_logits)

Tensor = torch.Tensor


class EncDecLM(nn.Module):
    """The encoder-decoder's parameters: ``embed`` (V, D), ``enc_blocks``
    (``ln1``, ``attn``, ``ln2``, ``mlp``), ``enc_norm``, ``blocks`` (the
    decoder layers, with ``lnx`` + ``xattn``), ``final_norm``, ``lm_head``
    (D, V) unless the embeddings are tied, and ``src_embed`` (V, D) unless
    the source is embeddings.  ``forward`` / ``decode`` below run it;
    ``trainable`` leaves require grad."""

    def __init__(self, cfg: ModelConfig, tensors: Mapping,
                 trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        self.embed = _param(tensors["embed"], trainable)
        self.enc_blocks = nn.ModuleList(Block(t, trainable)
                                        for t in tensors["enc_blocks"])
        self.enc_norm = _param(tensors["enc_norm"], trainable)
        self.blocks = nn.ModuleList(Block(t, trainable)
                                    for t in tensors["blocks"])
        self.final_norm = _param(tensors["final_norm"], trainable)
        for name in ("lm_head", "src_embed"):
            if name in tensors:
                setattr(self, name, _param(tensors[name], trainable))


def init_enc_block(gen, cfg: ModelConfig, device=None) -> dict:
    dev = L._device(gen, device)
    return {"ln1": torch.ones((cfg.d_model,), device=dev),
            "attn": L.init_attention(gen, cfg, dev),
            "ln2": torch.ones((cfg.d_model,), device=dev),
            "mlp": L.init_mlp(gen, cfg, dev)}


def init_dec_block(gen, cfg: ModelConfig, device=None) -> dict:
    dev = L._device(gen, device)
    p = init_block(gen, cfg, dev)
    p["lnx"] = torch.ones((cfg.d_model,), device=dev)
    p["xattn"] = L.init_attention(gen, cfg, dev, cross=True)
    return p


def init_params(gen, cfg: ModelConfig, device=None,
                trainable: bool = False, place=None) -> EncDecLM:
    """Random parameters from the torch.Generator `gen` (on its device, or
    `device`), or shapes only when `device` is "meta"; ``trainable`` leaves
    require grad.  Parity runs carry the reference's over
    (``convert.lm_params_from_reference``).  ``place`` cuts each layer
    into its rank shards as it is drawn (``transformer.init_params``)."""
    dev = L._device(gen, device)
    keep = place if place is not None else (lambda path, t: t)
    tensors = {
        "embed": keep("embed", L.dense_init(gen, (cfg.vocab, cfg.d_model),
                                            dev)),
        "enc_blocks": [keep("enc_blocks", init_enc_block(gen, cfg, dev))
                       for _ in range(cfg.enc_layers)],
        "enc_norm": keep("enc_norm", torch.ones((cfg.d_model,), device=dev)),
        "blocks": [keep("blocks", init_dec_block(gen, cfg, dev))
                   for _ in range(cfg.n_layers)],
        "final_norm": keep("final_norm", torch.ones((cfg.d_model,),
                                                    device=dev)),
    }
    if not cfg.tie_embeddings:
        tensors["lm_head"] = keep("lm_head", L.dense_init(
            gen, (cfg.d_model, cfg.vocab), dev))
    if not cfg.embed_inputs:
        tensors["src_embed"] = keep("src_embed", L.dense_init(
            gen, (cfg.vocab, cfg.d_model), dev))
    if place is not None:
        return place.build(EncDecLM, cfg, tensors, trainable)
    return EncDecLM(cfg, tensors, trainable)


def _enc_block_apply(cfg: ModelConfig, p: Block, x: Tensor,
                     positions: Tensor) -> Tensor:
    h = L.rms_norm(x, p.ln1, cfg.norm_eps)
    x = x + L.encoder_attention_apply(cfg, p.attn, h, positions)
    h2 = L.rms_norm(x, p.ln2, cfg.norm_eps)
    return x + L.mlp_apply(cfg, p.mlp, h2)


def encode(cfg: ModelConfig, params: EncDecLM, src: Tensor) -> Tensor:
    """src: (B, S, D) embeddings (the stub frontend) or (B, S) token ids.
    Returns the normed encoder output (B, S, D)."""
    dt = cfg.activation_dtype()
    x = params.src_embed[src].to(dt) if src.ndim == 2 else src.to(dt)
    b, s = x.shape[0], x.shape[1]
    positions = L.default_positions(b, s, device=x.device).expand(b, s)
    for blk in params.enc_blocks:
        x = L.remat(cfg, _enc_block_apply, cfg, blk, x, positions)
    return L.rms_norm(x, params.enc_norm, cfg.norm_eps)


def _dec_block_apply(cfg: ModelConfig, p: Block, x: Tensor,
                     enc_out: Tensor):
    """One decoder layer over the whole target sequence at positions
    0..S-1.  Returns (x, (k, v) rotated, (B, S, Hkv, hd))."""
    h = L.rms_norm(x, p.ln1, cfg.norm_eps)
    attn_out, kv = L.attention_apply(cfg, p.attn, h, None, 0)
    x = x + attn_out
    hx = L.rms_norm(x, p.lnx, cfg.norm_eps)
    ek, ev = L.cross_kv(cfg, p.xattn, enc_out)
    x = x + L.cross_attention_apply(cfg, p.xattn, hx, ek, ev)
    h2 = L.rms_norm(x, p.ln2, cfg.norm_eps)
    return x + L.mlp_apply(cfg, p.mlp, h2), kv


def forward(cfg: ModelConfig, params: EncDecLM, *, src: Tensor,
            tokens: Tensor, cache_capacity: Optional[int] = None):
    """Teacher-forced forward of tokens (B, S) over the encoded src.
    Returns (hidden, aux 0.0, cache or None): with cache_capacity the
    decode cache holds the last min(S, cap) keys and values at slots 0..
    and the encoder's output."""
    enc_out = encode(cfg, params, src)
    x = params.embed[tokens].to(cfg.activation_dtype())
    b, s = tokens.shape
    cache = None
    if cache_capacity is not None:
        cache = init_cache(cfg, b, cache_capacity, enc_out.shape[1],
                           device=x.device)
        cache["enc_out"] = enc_out
    for i, blk in enumerate(params.blocks):
        x, (k, v) = L.remat(cfg, _dec_block_apply, cfg, blk, x, enc_out)
        if cache is not None:
            _prefill_cache(cfg, cache, i, {"k": k, "v": v}, 0, s)
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    return x, 0.0, cache


def init_cache(cfg: ModelConfig, batch: int, capacity: int, enc_len: int,
               device=None) -> dict:
    dt = cfg.activation_dtype()
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, capacity, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "enc_out": torch.zeros((batch, enc_len, cfg.d_model), dtype=dt,
                                   device=device)}


def decode(cfg: ModelConfig, params: EncDecLM, cache: dict, token: Tensor,
           cache_index: int, positions: Optional[Tensor] = None):
    """One decoder step against the cached self-attention K/V and the
    encoder's output.  token (B, 1) -> (logits (B, 1, V), cache), the
    cache written in place."""
    x = params.embed[token].to(cfg.activation_dtype())
    enc_out = cache["enc_out"]
    for i, blk in enumerate(params.blocks):
        h = L.rms_norm(x, blk.ln1, cfg.norm_eps)
        attn_out, _, _ = L.attention_decode(
            cfg, blk.attn, h, positions, 0, cache["k"][i], cache["v"][i],
            cache_index)
        x = x + attn_out
        hx = L.rms_norm(x, blk.lnx, cfg.norm_eps)
        ek, ev = L.cross_kv(cfg, blk.xattn, enc_out)
        x = x + L.cross_attention_apply(cfg, blk.xattn, hx, ek, ev)
        h2 = L.rms_norm(x, blk.ln2, cfg.norm_eps)
        x = x + L.mlp_apply(cfg, blk.mlp, h2)
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    return project_logits(cfg, params, x), cache


# ---------------------------------------------------------------------------
# over a (data, model) mesh (models/parallel.py): one list entry a rank
# ---------------------------------------------------------------------------


def _add(sm, xs: list, outs: list) -> list:
    return sm.px.map(torch.add, xs, P.combine(sm.px, outs, xs[0].dtype))


def _enc_layer_tp(cfg: ModelConfig, sm, li: int, xs: list,
                  pos: list) -> list:
    """``_enc_block_apply`` of encoder layer li over the mesh."""
    px, blk = sm.px, f"enc_blocks.{li}"
    hs = T._norm_tp(cfg, sm, xs, blk + ".ln1")
    xs = _add(sm, xs, [L.encoder_attention_apply_tp(
        cfg, px, sm.parts(blk + ".attn"), hs, pos)])
    h2 = T._norm_tp(cfg, sm, xs, blk + ".ln2")
    return _add(sm, xs, [L.mlp_apply_tp(cfg, px, sm.parts(blk + ".mlp"), h2,
                                        prefix="enc_blocks/mlp")])


def encode_tp(cfg: ModelConfig, sm, src: Tensor, split: bool) -> list:
    """``encode`` over the mesh, each attention on its rank's heads (plain
    on both devices): the encoder's output whole on each model rank, its
    batch `split` over the data axes or not; each layer recomputed in the
    backward pass as ``encode`` recomputes it."""
    px, dt = sm.px, cfg.activation_dtype()
    if src.ndim == 2:
        xs = T.embed_tp(cfg, sm, px.scatter(src, split), "src_embed")
    else:
        xs = px.scatter(src.to(dt), split)
    pos = px.map(lambda x: L.default_positions(
        x.shape[0], x.shape[1], device=x.device).expand(x.shape[0],
                                                        x.shape[1]), xs)
    for li in range(cfg.enc_layers):
        xs = P.remat(cfg, _enc_layer_tp, cfg, sm, li, xs, pos)
    return T._norm_tp(cfg, sm, xs, "enc_norm")


def _cross_tp(cfg: ModelConfig, sm, blk: str, xs: list, enc: list) -> list:
    """A decoder layer's cross-attention sub-layer over the mesh."""
    px = sm.px
    hx = T._norm_tp(cfg, sm, xs, blk + ".lnx")
    ps = sm.parts(blk + ".xattn")
    ek, ev = L.cross_kv_tp(cfg, px, ps, enc)
    return _add(sm, xs, [L.cross_attention_apply_tp(cfg, px, ps, hx, ek, ev)])


def _dec_layer_tp(cfg: ModelConfig, sm, li: int, xs: list, enc: list,
                  split: bool, seq: bool = False):
    """``_dec_block_apply`` of decoder layer li over the mesh: (xs, each
    rank's (k, v)), every KV head where `seq` (a cache split by
    positions)."""
    px, blk = sm.px, f"blocks.{li}"
    hs = T._norm_tp(cfg, sm, xs, blk + ".ln1")
    out, kv = L.attention_apply_tp(cfg, px, sm.parts(blk + ".attn"), hs,
                                   [None] * px.p, 0, seq=seq)
    xs = _cross_tp(cfg, sm, blk, _add(sm, xs, [out]), enc)
    xs, _ = T._ffn_tp(cfg, sm, blk, xs, split)
    return xs, kv


def forward_tp(cfg: ModelConfig, sm, split: bool, *, src: Tensor,
               tokens: Tensor, cache_capacity: Optional[int] = None):
    """``forward`` over the mesh: the decoder's self-attention on the flash
    kernel a rank on the card.  Returns (each rank's hidden state, 0.0,
    a ``parallel.ShardedCache`` or None)."""
    px = sm.px
    enc = encode_tp(cfg, sm, src, split)
    xs = T.embed_tp(cfg, sm, px.scatter(tokens, split))
    b, s = tokens.shape
    caches = None
    if cache_capacity is not None:
        caches = px.new_caches(init_cache(cfg, b, cache_capacity,
                                          src.shape[1], device="meta"))
        for rc, e in zip(caches.ranks, enc):
            rc["enc_out"] = e
    seq = caches is not None and caches.by_positions()
    for li in range(cfg.n_layers):
        xs, kv = P.remat(cfg, _dec_layer_tp, cfg, sm, li, xs, enc, split,
                         seq)
        if caches is not None:
            for r, (rc, (k, v)) in enumerate(zip(caches.ranks, kv)):
                _prefill_cache(cfg, rc, li, {"k": k, "v": v}, 0, s,
                               (r % px.tp, px.tp) if seq else None)
    return T._norm_tp(cfg, sm, xs, "final_norm"), 0.0, caches


def decode_tp(cfg: ModelConfig, sm, split: bool, cache, token: Tensor,
              cache_index: int, positions: Optional[Tensor] = None):
    """``decode`` over the mesh: (logits (B, 1, V) on the first rank's
    device, cache)."""
    px = sm.px
    xs = T.embed_tp(cfg, sm, px.scatter(token, split))
    pos = px.scatter(positions, split)
    enc = [rc["enc_out"] for rc in cache.ranks]
    for li in range(cfg.n_layers):
        blk = f"blocks.{li}"
        hs = T._norm_tp(cfg, sm, xs, blk + ".ln1")
        xs = _add(sm, xs, [L.attention_decode_tp(
            cfg, px, sm.parts(blk + ".attn"), hs, pos, 0,
            [rc["k"][li] for rc in cache.ranks],
            [rc["v"][li] for rc in cache.ranks], cache_index,
            seq=cache.by_positions())])
        xs = _cross_tp(cfg, sm, blk, xs, enc)
        xs, _ = T._ffn_tp(cfg, sm, blk, xs, split)
    xs = T._norm_tp(cfg, sm, xs, "final_norm")
    return T.project_logits_tp(cfg, sm, xs, split), cache


__all__ = ["EncDecLM", "init_params", "init_enc_block", "init_dec_block",
           "encode", "forward", "decode", "init_cache", "encode_tp",
           "forward_tp", "decode_tp"]
