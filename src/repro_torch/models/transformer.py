"""Decoder-only LM trunk, with layers grouped into runs of equal window.

Port of ``repro/models/transformer.py``.  ``forward_tp`` and
``decode_tp`` run parameters placed over a mesh (a ``parallel.ShardedLM``)
through the layers' tensor-parallel forms (``*_tp``), the batch split over
data; the serving steps call them when given the reference's ``policy=``
(``models/steps.py``).  Layers are grouped into
maximal *runs* of consecutive layers sharing an attention-window class (full
vs SWA): hymba's {global, swa, ..., global} pattern yields 5 runs, uniform
archs 1.  The parameters are ``nn.Module``s, one ``Block`` a layer; a loop
over layers replaces the reference's ``lax.scan``.  Decode caches keep the
reference's layout, one dict a run: ``k`` and ``v`` of shape (cnt, B, Hkv,
cap, hd), SWA runs with window-bounded ring buffers, and the SSM state
``ssm_h`` (cnt, B, d_inner, state) / ``conv`` (cnt, B, d_conv - 1,
d_inner).  Decode writes them in place (the reference donates them).
"""

from __future__ import annotations

from typing import List, Mapping, Optional, Tuple

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models import parallel as P
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig

Tensor = torch.Tensor


def layer_runs(cfg: ModelConfig) -> Tuple[Tuple[int, int, int], ...]:
    """Maximal runs of consecutive layers with equal window.
    Returns ((window, start, count), ...)."""
    ws = cfg.layer_windows() if cfg.family != "ssm" else (0,) * cfg.n_layers
    runs: List[Tuple[int, int, int]] = []
    for i, w in enumerate(ws):
        if runs and runs[-1][0] == w:
            w0, s0, c0 = runs[-1]
            runs[-1] = (w0, s0, c0 + 1)
        else:
            runs.append((w, i, 1))
    return tuple(runs)


def _has_attn(cfg: ModelConfig) -> bool:
    return cfg.family != "ssm"


def _has_ssm(cfg: ModelConfig) -> bool:
    return cfg.family == "ssm" or cfg.hybrid


def _has_mlp(cfg: ModelConfig) -> bool:
    return cfg.family != "ssm"


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def _param(t: Tensor, trainable: bool = False) -> nn.Parameter:
    """A leaf: frozen for serving, or requiring grad for training; a
    placed shard comes as the ``nn.Parameter`` its ranks share
    (``parallel.Placement.build``)."""
    if isinstance(t, nn.Parameter):
        return t
    return nn.Parameter(t, requires_grad=trainable)


def _pdict(tensors: Mapping[str, Tensor],
           trainable: bool = False) -> nn.ParameterDict:
    return nn.ParameterDict({k: _param(v, trainable)
                             for k, v in tensors.items()})


class Block(nn.Module):
    """One layer's parameters: ``ln1``, and ``attn`` / ``ssm`` / ``ln2`` +
    ``mlp`` or ``moe`` as the family has them (an encoder-decoder's decoder
    layers add ``lnx`` + ``xattn``), each sub-layer an ``nn.ParameterDict``
    under the reference's leaf names.  It holds no config: ``block_apply``
    / ``block_decode`` run it under the caller's, as the reference's steps
    pass theirs.  ``trainable`` leaves require grad."""

    def __init__(self, tensors: Mapping, trainable: bool = False):
        super().__init__()
        self.ln1 = _param(tensors["ln1"], trainable)
        for name in ("attn", "xattn", "ssm", "mlp", "moe"):
            if name in tensors:
                setattr(self, name, _pdict(tensors[name], trainable))
        for name in ("ln2", "lnx"):
            if name in tensors:
                setattr(self, name, _param(tensors[name], trainable))


class DecoderLM(nn.Module):
    """The whole decoder-only LM's parameters: ``embed`` (V, D), ``blocks``,
    ``final_norm``, and ``lm_head`` (D, V) unless the embeddings are tied.
    ``forward`` / ``decode`` below run it.  Serving holds frozen leaves;
    ``trainable`` ones require grad (``models/steps.make_train_step``)."""

    def __init__(self, cfg: ModelConfig, tensors: Mapping,
                 trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        self.embed = _param(tensors["embed"], trainable)
        self.blocks = nn.ModuleList(Block(t, trainable)
                                    for t in tensors["blocks"])
        self.final_norm = _param(tensors["final_norm"], trainable)
        if "lm_head" in tensors:
            self.lm_head = _param(tensors["lm_head"], trainable)


def init_block(gen, cfg: ModelConfig, device=None) -> dict:
    dev = L._device(gen, device)
    p: dict = {"ln1": torch.ones((cfg.d_model,), device=dev)}
    if _has_attn(cfg):
        p["attn"] = L.init_attention(gen, cfg, dev)
    if _has_ssm(cfg):
        p["ssm"] = S.init_ssm(gen, cfg, dev)
    if _has_mlp(cfg):
        p["ln2"] = torch.ones((cfg.d_model,), device=dev)
        if cfg.uses_moe:
            p["moe"] = L.init_moe(gen, cfg, dev)
        else:
            p["mlp"] = L.init_mlp(gen, cfg, dev)
    return p


def init_params(gen, cfg: ModelConfig, device=None,
                trainable: bool = False, place=None) -> DecoderLM:
    """Random parameters from the torch.Generator `gen` (on its device, or
    `device`), or shapes only when `device` is "meta"; ``trainable`` leaves
    require grad.  Not the reference's jax.random draws: parity runs carry
    the reference's parameters over
    (``convert.lm_params_from_reference``).  ``place``, a
    ``parallel.Placement``, cuts each layer into its rank shards as soon
    as it is drawn (the same draws, in the same order) and returns a
    ``parallel.ShardedLM``: the whole model never sits on one device."""
    dev = L._device(gen, device)
    keep = place if place is not None else (lambda path, t: t)
    tensors = {
        "blocks": [keep("blocks", init_block(gen, cfg, dev))
                   for _ in range(cfg.n_layers)],
        "embed": keep("embed", L.dense_init(gen, (cfg.vocab, cfg.d_model),
                                            dev)),
        "final_norm": keep("final_norm", torch.ones((cfg.d_model,),
                                                    device=dev)),
    }
    if not cfg.tie_embeddings:
        tensors["lm_head"] = keep("lm_head", L.dense_init(
            gen, (cfg.d_model, cfg.vocab), dev))
    if place is not None:
        return place.build(DecoderLM, cfg, tensors, trainable)
    return DecoderLM(cfg, tensors, trainable)


# ---------------------------------------------------------------------------
# block application (single layer)
# ---------------------------------------------------------------------------


def block_apply(cfg: ModelConfig, p: Block, x: Tensor,
                positions: Optional[Tensor], window: int,
                return_cache: bool = False, index_mask: bool = False):
    """One decoder layer, full-sequence.  Returns (x, aux, cache_piece|None).
    cache_piece holds raw per-layer state: kv (B,S,Hkv,hd) and/or ssm state.
    aux is the MoE layer's load-balance loss, 0.0 without MoE.  index_mask:
    the mask's position stream is 0..S-1 (``L.attention_apply``)."""
    aux = 0.0
    h = L.rms_norm(x, p.ln1, cfg.norm_eps)
    delta = torch.zeros_like(x)
    piece: dict = {}
    if _has_attn(cfg):
        attn_out, kv = L.attention_apply(cfg, p.attn, h, positions, window,
                                         index_mask=index_mask)
        delta = delta + attn_out
        if return_cache:
            piece["k"], piece["v"] = kv
    if _has_ssm(cfg):
        ssm_out, (h_last, conv_tail) = S.ssm_apply(cfg, p.ssm, h)
        delta = delta + ssm_out
        if return_cache:
            piece["ssm_h"], piece["conv"] = h_last, conv_tail
    x = x + delta
    if _has_mlp(cfg):
        h2 = L.rms_norm(x, p.ln2, cfg.norm_eps)
        if cfg.uses_moe:
            mo, aux = L.moe_apply(cfg, p.moe, h2)
            x = x + mo
        else:
            x = x + L.mlp_apply(cfg, p.mlp, h2)
    return x, aux, (piece if return_cache else None)


def block_decode(cfg: ModelConfig, p: Block, x: Tensor, positions,
                 window: int, block_cache: dict, cache_index: int):
    """One decoder layer, single token.  Returns (x, new_block_cache)."""
    h = L.rms_norm(x, p.ln1, cfg.norm_eps)
    delta = torch.zeros_like(x)
    new_cache = dict(block_cache)
    if _has_attn(cfg):
        attn_out, k_c, v_c = L.attention_decode(
            cfg, p.attn, h, positions, window,
            block_cache["k"], block_cache["v"], cache_index)
        new_cache["k"], new_cache["v"] = k_c, v_c
        delta = delta + attn_out
    if _has_ssm(cfg):
        ssm_out, h_s, conv_c = S.ssm_decode(
            cfg, p.ssm, h, block_cache["ssm_h"], block_cache["conv"])
        new_cache["ssm_h"], new_cache["conv"] = h_s, conv_c
        delta = delta + ssm_out
    x = x + delta
    if _has_mlp(cfg):
        h2 = L.rms_norm(x, p.ln2, cfg.norm_eps)
        if cfg.uses_moe:   # the B one-token rows routed as the reference does
            mo, _ = L.moe_apply(cfg, p.moe, h2)
            x = x + mo
        else:
            x = x + L.mlp_apply(cfg, p.mlp, h2)
    return x, new_cache


# ---------------------------------------------------------------------------
# trunk forward (train / prefill)
# ---------------------------------------------------------------------------


def forward(cfg: ModelConfig, params: DecoderLM, *,
            tokens: Optional[Tensor] = None,
            embeds: Optional[Tensor] = None,
            positions: Optional[Tensor] = None,
            cache_capacity: Optional[int] = None):
    """Full-sequence forward of tokens (B, S) or embeddings (B, S, D) (the
    VLM's stub frontend).  Returns (hidden, aux, caches).

    `caches` is a per-run list of decode caches (or None) when
    cache_capacity is given (prefill).  The returned hidden state is
    post-final-norm; callers project to logits.  positions: (B, S), the
    (B, 3, S) m-rope streams, or None for 0..S-1.  Whether the mask's
    stream is 0..S-1, which lets the card's flash kernel take every
    attention layer, is decided here once (``L.index_stream``).  Under
    autograd each layer is recomputed in the backward pass unless
    cfg.remat is "none" (``L.remat``, the reference's jax.checkpoint of
    its scan body).
    """
    if embeds is not None:
        x = embeds.to(cfg.activation_dtype())
        b, s = x.shape[0], x.shape[1]
    else:
        # gathering rows, then casting: the bits of casting the whole table
        x = params.embed[tokens].to(cfg.activation_dtype())
        b, s = tokens.shape
    index_mask = L.index_stream(positions)

    total_aux = 0.0
    caches = [] if cache_capacity is not None else None
    for (w, start, cnt) in layer_runs(cfg):
        run_cache = None
        if caches is not None:
            run_cache = _init_run_cache(cfg, w, cnt, b, cache_capacity,
                                        x.device)
            caches.append(run_cache)
        for i in range(cnt):
            x, a, piece = L.remat(
                cfg, block_apply, cfg, params.blocks[start + i], x,
                positions, w, run_cache is not None, index_mask)
            total_aux = total_aux + a
            if run_cache is not None:
                _prefill_cache(cfg, run_cache, i, piece, w, s)

    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    return x, total_aux, caches


def _prefill_cache(cfg: ModelConfig, cache: dict, i: int, piece: dict,
                   window: int, s: int, part=None) -> None:
    """Write layer i's prefill state into its run's decode cache: the last
    min(s, cap) positions, at slot position % cap in an SWA ring, at slots
    0.. in a full-context cache.  part = (m, tp): the cache holds slice m
    of tp of the slots (sequence mode), and only the positions landing
    there are written."""
    if "k" in piece:
        m, tp = part or (0, 1)
        n = cache["k"].shape[3]
        cap = n * tp
        take = min(s, cap)
        slots = (torch.arange(s - take, s) % cap) if window > 0 else \
            torch.arange(take)
        rows = torch.arange(s - take, s)
        if part is not None:   # host index arithmetic: no device values
            mine = (slots >= m * n) & (slots < (m + 1) * n)
            slots, rows = slots[mine] - m * n, rows[mine]
        dev = cache["k"].device
        slots = slots.to(dev)
        for name in ("k", "v"):  # (B, S, Hkv, hd) -> (B, Hkv, cap, hd)
            src = piece[name][:, s - take:] if part is None else \
                piece[name].index_select(1, rows.to(dev))
            cache[name][i].index_copy_(2, slots,
                                       src.transpose(1, 2).to(
                                           cache[name].dtype))
    if "ssm_h" in piece:
        cache["ssm_h"][i] = piece["ssm_h"]
        cache["conv"][i] = piece["conv"].to(cache["conv"].dtype)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _init_run_cache(cfg: ModelConfig, w: int, cnt: int, batch: int,
                    capacity: int, device) -> dict:
    c: dict = {}
    dt = cfg.activation_dtype()
    if _has_attn(cfg):
        cap = min(w, capacity) if w > 0 else capacity
        shape = (cnt, batch, cfg.n_kv_heads, cap, cfg.hd)
        c["k"] = torch.zeros(shape, dtype=dt, device=device)
        c["v"] = torch.zeros(shape, dtype=dt, device=device)
    if _has_ssm(cfg):
        c["ssm_h"] = torch.zeros((cnt, batch, cfg.d_inner, cfg.ssm_state),
                                 device=device)
        c["conv"] = torch.zeros((cnt, batch, cfg.ssm_conv - 1, cfg.d_inner),
                                dtype=dt, device=device)
    return c


def init_cache(cfg: ModelConfig, batch: int, capacity: int,
               device=None) -> list:
    """Zeroed per-run decode caches; SWA runs get window-sized ring buffers."""
    return [_init_run_cache(cfg, w, cnt, batch, capacity, device)
            for (w, start, cnt) in layer_runs(cfg)]


def decode(cfg: ModelConfig, params: DecoderLM, cache: list, token: Tensor,
           cache_index: int, positions: Optional[Tensor] = None):
    """One decode step.  token (B, 1) -> (logits (B, 1, V), cache), the
    cache written in place."""
    x = params.embed[token].to(cfg.activation_dtype())
    for run_idx, (w, start, cnt) in enumerate(layer_runs(cfg)):
        run_cache = cache[run_idx]
        for i in range(cnt):
            bc = {name: t[i] for name, t in run_cache.items()}
            x, nc = block_decode(cfg, params.blocks[start + i], x, positions,
                                 w, bc, cache_index)
            for name in ("ssm_h", "conv"):   # the rest was written in place
                if name in nc:
                    run_cache[name][i] = nc[name]
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    return project_logits(cfg, params, x), cache


def project_logits(cfg: ModelConfig, params: DecoderLM, x: Tensor) -> Tensor:
    """Logits (B, S, V) of hidden states x (B, S, D)."""
    head = (params.embed.T if cfg.tie_embeddings
            else params.lm_head).to(x.dtype)
    return (x @ head).to(getattr(torch, cfg.logits_dtype))


# ---------------------------------------------------------------------------
# over a (data, model) mesh (models/parallel.py): one list entry a rank;
# `split` is whether the batch is split over the data axes
# (``Placement.batch_split``), decided once a step
# ---------------------------------------------------------------------------


def embed_tp(cfg: ModelConfig, sm, ids: list, name: str = "embed") -> list:
    """Each rank's embedding rows of its ids (B, S), in the activations'
    dtype: vocab-parallel where the specs split V (each rank looks up its
    rows, zeros for the others, all-reduced: exact), d_model-parallel where
    they split D (all-gathered: exact), whole otherwise."""
    px, dt = sm.px, cfg.activation_dtype()
    tables = sm.parts(name)
    dim = px.tp_dim(name)
    if dim == 0:
        parts = []
        for r, (t, i) in enumerate(zip(tables, ids)):
            n = t.shape[0]
            local = i - (r % px.tp) * n
            hit = (local >= 0) & (local < n)
            rows = t[local.clamp(0, n - 1)]
            parts.append(torch.where(hit[..., None], rows, 0.0))
        return px.all_reduce(parts, dt)
    rows = px.map(lambda t, i: t[i].to(dt), tables, ids)
    return px.all_gather(rows, -1) if dim == 1 else rows


def logits_tp(cfg: ModelConfig, sm, xs: list, d: int) -> Tensor:
    """``project_logits`` of data group d's hidden states `xs` (one a rank
    of the group, by model index), in their dtype, on the group's first
    rank's device: vocab-parallel where the specs split V (each rank's
    columns, concatenated), row-parallel over D where they split D (float32
    partials summed in rank order, rounded once), the whole head's
    otherwise."""
    px, dt = sm.px, xs[0].dtype
    name = "embed" if cfg.tie_embeddings else "lm_head"
    g = px.group(d)
    owner = px.devices[g[0]]
    heads = [sm.leaf(r, name) for r in g]
    if cfg.tie_embeddings:
        heads = [h.T for h in heads]
    dim = px.tp_dim(name)
    vocab_dim, d_dim = (0, 1) if cfg.tie_embeddings else (1, 0)
    record = d == 0 and px.tp > 1    # one record a call: group 0's
    if dim == d_dim:
        w = heads[0].shape[0]
        with px._span(owner):
            total = None
            for m, (h, x) in enumerate(zip(heads, xs)):
                part = P.mm32(x[..., m * w:(m + 1) * w], h)
                with px._quiet():
                    if total is None:
                        operand = torch.empty_like(part, device="meta")
                    part = part.to(owner)
                    total = part if total is None else total + part
            with px._quiet():
                out = total.to(dt)
        if record:
            px.record("all-reduce", operand, px.group_name(model=True), out)
        return out
    if dim == vocab_dim:
        with px._span(owner):
            parts = [x @ h.to(dt) for h, x in zip(heads, xs)]
            with px._quiet():
                out = torch.cat([part.to(owner) for part in parts], -1)
        if record:
            px.record("all-gather", parts[0], px.group_name(model=True), out)
        return out
    return xs[0] @ heads[0].to(dt)


def project_logits_tp(cfg: ModelConfig, sm, xs: list, split: bool) -> Tensor:
    """``project_logits`` over the mesh (``logits_tp`` a data group): the
    data groups' rows collected on the first rank's device."""
    px = sm.px
    out_dt = getattr(torch, cfg.logits_dtype)
    parts: list = [None] * px.p
    for d in range(px.dp if split else 1):
        parts[d * px.tp] = logits_tp(cfg, sm, [xs[r] for r in px.group(d)],
                                     d).to(out_dt)
    return px.collect(parts, split)


def _norm_tp(cfg: ModelConfig, sm, xs: list, name: str) -> list:
    return sm.px.map(lambda x, w: L.rms_norm(x, w, cfg.norm_eps), xs,
                     sm.parts(name))


def block_apply_tp(cfg: ModelConfig, sm, li: int, xs: list, positions: list,
                   window: int, split: bool, index_mask: bool = False,
                   seq: bool = False):
    """``block_apply`` of layer li over the mesh.  A layer with attention
    and an SSM sums their row-parallel partials before one all-reduce.
    `seq`: the layer's cache is split by positions, so each rank's piece
    holds every KV head.  Returns (xs, aux, each rank's cache piece)."""
    px, dt, blk = sm.px, xs[0].dtype, f"blocks.{li}"
    hs = _norm_tp(cfg, sm, xs, blk + ".ln1")
    outs, pieces, aux = [], [dict() for _ in range(px.p)], 0.0
    if _has_attn(cfg):
        out, kv = L.attention_apply_tp(cfg, px, sm.parts(blk + ".attn"), hs,
                                       positions, window, index_mask,
                                       seq=seq)
        outs.append(out)
        for piece, (k, v) in zip(pieces, kv):
            piece["k"], piece["v"] = k, v
    if _has_ssm(cfg):
        out, states = S.ssm_apply_tp(cfg, px, sm.parts(blk + ".ssm"), hs)
        outs.append(out)
        for piece, (h, tail) in zip(pieces, states):
            piece["ssm_h"], piece["conv"] = h, tail
    xs = px.map(torch.add, xs, P.combine(px, outs, dt))
    if _has_mlp(cfg):
        xs, aux = _ffn_tp(cfg, sm, blk, xs, split)
    return xs, aux, pieces


def _ffn_tp(cfg: ModelConfig, sm, blk: str, xs: list, split: bool):
    """The MLP or MoE half of a layer over the mesh: (xs, aux)."""
    px, aux = sm.px, 0.0
    h2 = _norm_tp(cfg, sm, xs, blk + ".ln2")
    if cfg.uses_moe:
        out, aux = L.moe_apply_tp(cfg, px, sm.parts(blk + ".moe"), h2,
                                  split=split)
    else:
        out = L.mlp_apply_tp(cfg, px, sm.parts(blk + ".mlp"), h2)
    return px.map(torch.add, xs, P.combine(px, [out], xs[0].dtype)), aux


def block_decode_tp(cfg: ModelConfig, sm, li: int, xs: list, positions: list,
                    window: int, caches: list, cache_index: int,
                    split: bool, seq: bool = False) -> list:
    """``block_decode`` of layer li over the mesh, each rank's block cache
    (views of its run's caches) written in place; `seq`: the KV caches
    are split by positions."""
    px, blk = sm.px, f"blocks.{li}"
    hs = _norm_tp(cfg, sm, xs, blk + ".ln1")
    outs = []
    if _has_attn(cfg):
        outs.append(L.attention_decode_tp(
            cfg, px, sm.parts(blk + ".attn"), hs, positions, window,
            [c["k"] for c in caches], [c["v"] for c in caches], cache_index,
            seq=seq))
    if _has_ssm(cfg):
        out, h, conv = S.ssm_decode_tp(cfg, px, sm.parts(blk + ".ssm"), hs,
                                       [c["ssm_h"] for c in caches],
                                       [c["conv"] for c in caches])
        outs.append(out)
        for c, hh, cc in zip(caches, h, conv):
            c["ssm_h"].copy_(hh)
            c["conv"].copy_(cc)
    xs = px.map(torch.add, xs, P.combine(px, outs, xs[0].dtype))
    if _has_mlp(cfg):
        xs, _ = _ffn_tp(cfg, sm, blk, xs, split)
    return xs


def forward_tp(cfg: ModelConfig, sm, split: bool, *,
               tokens: Optional[Tensor] = None,
               embeds: Optional[Tensor] = None,
               positions: Optional[Tensor] = None,
               cache_capacity: Optional[int] = None):
    """``forward`` over the mesh of ``sm`` (a ``parallel.ShardedLM``);
    returns (each rank's hidden state, aux, a ``parallel.ShardedCache`` or
    None).  Under autograd each layer over every rank is recomputed in the
    backward pass unless cfg.remat is "none", its cross-card copies and
    FSDP gathers issued again (``parallel.remat``)."""
    px = sm.px
    index_mask = L.index_stream(positions)
    if embeds is not None:
        xs = px.scatter(embeds.to(cfg.activation_dtype()), split)
        b, s = embeds.shape[0], embeds.shape[1]
    else:
        xs = embed_tp(cfg, sm, px.scatter(tokens, split))
        b, s = tokens.shape
    pos = px.scatter(positions, split)
    caches = None
    if cache_capacity is not None:
        caches = px.new_caches(init_cache(cfg, b, cache_capacity, "meta"))
    total_aux = 0.0
    for run, (w, start, cnt) in enumerate(layer_runs(cfg)):
        seq = caches is not None and caches.by_positions(run)
        for i in range(cnt):
            xs, a, pieces = P.remat(cfg, block_apply_tp, cfg, sm, start + i,
                                    xs, pos, w, split, index_mask, seq)
            total_aux = total_aux + a
            if caches is not None:
                for r, (rc, piece) in enumerate(zip(caches.ranks, pieces)):
                    _prefill_cache(cfg, rc[run], i, piece, w, s,
                                   (r % px.tp, px.tp) if seq else None)
    return _norm_tp(cfg, sm, xs, "final_norm"), total_aux, caches


def decode_tp(cfg: ModelConfig, sm, split: bool, cache, token: Tensor,
              cache_index: int, positions: Optional[Tensor] = None):
    """``decode`` over the mesh: (logits (B, 1, V) on the first rank's
    device, cache)."""
    px = sm.px
    xs = embed_tp(cfg, sm, px.scatter(token, split))
    pos = px.scatter(positions, split)
    for run, (w, start, cnt) in enumerate(layer_runs(cfg)):
        seq = cache.by_positions(run)
        for i in range(cnt):
            bcs = [{name: t[i] for name, t in rc[run].items()}
                   for rc in cache.ranks]
            xs = block_decode_tp(cfg, sm, start + i, xs, pos, w, bcs,
                                 cache_index, split, seq)
    xs = _norm_tp(cfg, sm, xs, "final_norm")
    return project_logits_tp(cfg, sm, xs, split), cache


__all__ = ["layer_runs", "init_params", "init_block", "forward", "decode",
           "init_cache", "project_logits", "block_apply", "block_decode",
           "forward_tp", "decode_tp", "project_logits_tp", "logits_tp",
           "block_apply_tp",
           "block_decode_tp", "embed_tp", "Block",
           "DecoderLM"]
