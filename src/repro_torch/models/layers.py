"""Model building blocks: norms, RoPE, GQA / sliding-window attention,
cross-attention, MLPs, sort-based capacity-routed MoE.

Port of ``repro/models/layers.py``.  The same convention:
  init_*(gen, cfg, device) -> param dict for ONE layer
  *_apply(cfg, p, x, ...) -> output(s)
where ``p`` is any mapping of names to tensors (a dict, or the
``nn.ParameterDict`` of a block in ``transformer.py``).

Dtypes: params live in float32; activations are in ``cfg.dtype`` and each
weight is cast at its use (``p.to(x.dtype)``); softmax / normalization
statistics accumulate in float32.

Prefill self-attention dispatches by device, as every kernel wrapper of the
port does: on a CUDA tensor it runs the hand-written flash kernel
(``kernels.ops.flash_mha``), which raises if it cannot build or launch; on
a CPU tensor it runs the reference's plain ``sdpa`` / ``_chunked_sdpa``.
The flash kernel masks by index 0..S-1, so the card takes it only where
the mask's position stream is that index (``index_stream``, asked once a
prefill by ``transformer.forward``); other streams, such as an image's
patches sharing one temporal position, take the plain route on the card
too.  So does attention under autograd (training): the kernel has no
backward, as the reference's has none, and the reference trains on XLA
attention.  Decode attention (one query against a ring buffer), the
encoder's bidirectional attention and cross-attention are plain tensor
code on both devices, as in the reference, where no Pallas kernel
computes them.  So is the MoE layer: the reference routes, dispatches and
combines in plain XLA, outside any Pallas kernel.

The ``*_tp`` forms run a layer over a (data, model) mesh
(``models/parallel.py``): one list entry a rank, each rank's parameters
its shards.  Attention is split by heads (``head_plan``): each rank's
self-attention runs on its own heads, on the card one flash launch a rank
a layer; the MLP by F; MoE experts expert-parallel, or by F.  A KV cache
split by positions (``kv_cache_shard="sequence"``) decodes as
flash-decoding over the model axis: each rank attends every head over its
slice of the cache's slots, and the partial softmaxes are combined
(``attention_decode_tp``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.parallel import Out, mm32

Tensor = torch.Tensor
# the largest flash block; the wrapper's blk only validates the window
FLASH_BLK = 128


def dense_init(gen: Optional[torch.Generator], shape, device=None,
               scale: float = 0.02) -> Tensor:
    """Normal(0, scale^2) float32 from `gen` (on the generator's device),
    or shapes only on the meta device."""
    device = torch.device(device) if device is not None else gen.device
    if device.type == "meta":
        return torch.empty(shape, device=device)
    return torch.randn(shape, generator=gen, device=device) * scale


def _device(gen, device) -> torch.device:
    return torch.device(device) if device is not None else gen.device


def remat(cfg: ModelConfig, fn, *args):
    """fn(*args), recomputed in the backward pass when cfg.remat is not
    "none" and autograd records (``torch.utils.checkpoint``, non-reentrant),
    where the reference wraps the same body in ``jax.checkpoint``: each
    layer, each q-chunk of attention, each SSM chunk, each loss chunk."""
    if cfg.remat != "none" and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def rms_norm(x: Tensor, w: Tensor, eps: float) -> Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * w.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (standard / half / m-rope)
# ---------------------------------------------------------------------------


def _rope_angles(positions: Tensor, n_freq: int, theta: float) -> Tensor:
    """positions (..., S) -> angles (..., S, n_freq), float32."""
    exps = torch.arange(n_freq, dtype=torch.float32,
                        device=positions.device) / n_freq
    freqs = 1.0 / (theta ** exps)
    return positions.float()[..., None] * freqs


def _rotate(x: Tensor, angles: Tensor) -> Tensor:
    """x (..., S, H, 2*n_freq) rotated pairwise by angles (..., S, n_freq)."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def apply_rope(cfg: ModelConfig, x: Tensor, positions: Tensor) -> Tensor:
    """x: (B, S, Hx, hd).  positions: (B, S) int, or (B, 3, S) for m-rope.

    standard: rotate all hd dims.  half: rotate the first hd/2 dims only
    (ChatGLM 2d-RoPE).  mrope: three position streams rotate disjoint
    frequency sections (Qwen2-VL M-RoPE).
    """
    hd = x.shape[-1]
    dt = x.dtype
    if cfg.rope == "none":
        return x
    if cfg.rope == "standard":
        ang = _rope_angles(positions, hd // 2, cfg.rope_theta)
        return _rotate(x, ang).to(dt)
    if cfg.rope == "half":
        half = hd // 2
        ang = _rope_angles(positions, half // 2, cfg.rope_theta)
        rotated = _rotate(x[..., :half], ang)
        return torch.cat([rotated, x[..., half:].float()], dim=-1).to(dt)
    if cfg.rope == "mrope":
        # positions (B, 3, S); sections partition the hd/2 frequency axis
        sections = cfg.mrope_sections
        n_freq = hd // 2
        if sum(sections) != n_freq:
            raise ValueError(f"mrope sections {sections} != hd/2 = {n_freq}")
        angs = []
        for comp in range(len(sections)):
            freqs_idx = torch.arange(sum(sections[:comp]),
                                     sum(sections[:comp + 1]),
                                     device=x.device)
            freqs = 1.0 / (cfg.rope_theta ** (freqs_idx.float() / n_freq))
            pos = positions[:, comp, :].float()
            angs.append(pos[..., None] * freqs)
        ang = torch.cat(angs, dim=-1)  # (B, S, n_freq)
        return _rotate(x, ang).to(dt)
    raise ValueError(f"unknown rope mode {cfg.rope}")


def default_positions(batch: int, seq: int, offset=0, device=None) -> Tensor:
    return torch.arange(seq, dtype=torch.int32, device=device)[None, :] \
        + offset


# ---------------------------------------------------------------------------
# Attention (GQA + optional sliding window)
# ---------------------------------------------------------------------------


def init_attention(gen, cfg: ModelConfig, device=None,
                   cross: bool = False) -> dict:
    """One attention layer's projections; a cross-attention layer
    (``cross``) has no biases."""
    hd, h, hkv, d = cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    dev = _device(gen, device)
    p = {
        "wq": dense_init(gen, (d, h * hd), dev),
        "wk": dense_init(gen, (d, hkv * hd), dev),
        "wv": dense_init(gen, (d, hkv * hd), dev),
        "wo": dense_init(gen, (h * hd, d), dev,
                         scale=0.02 / max(cfg.n_layers, 1) ** 0.5),
    }
    if cfg.attn_bias and not cross:
        for name, width in (("bq", h * hd), ("bk", hkv * hd),
                            ("bv", hkv * hd)):
            p[name] = torch.zeros((width,), device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), device=dev)
        p["k_norm"] = torch.ones((hd,), device=dev)
    return p


def _project_qkv(cfg: ModelConfig, p: Mapping[str, Tensor], xq: Tensor,
                 xkv: Tensor):
    b, sq, _ = xq.shape
    skv = xkv.shape[1]
    hd, h, hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    q = xq @ p["wq"].to(xq.dtype)
    k = xkv @ p["wk"].to(xkv.dtype)
    v = xkv @ p["wv"].to(xkv.dtype)
    if "bq" in p:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    q = q.reshape(b, sq, h, hd)
    k = k.reshape(b, skv, hkv, hd)
    v = v.reshape(b, skv, hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def sdpa(cfg: ModelConfig, q: Tensor, k: Tensor, v: Tensor, *,
         q_pos: Tensor, k_pos: Tensor, window: int, causal: bool,
         k_valid: Optional[Tensor] = None) -> Tensor:
    """Grouped-head attention.  q (B,Sq,H,hd); k,v (B,Sk,Hkv,hd).

    window: 0 = unlimited.  q_pos (B,Sq) / k_pos (B,Sk) are absolute token
    positions (mask built from them, so ring-buffer caches just pass the
    right positions).  k_valid (B,Sk) masks dead cache slots.  Query head h
    reads KV head h // (H / Hkv); the logits are divided by sqrt(hd) after
    the dot, as in the reference.
    """
    b, sq, h, hd = q.shape
    hkv = k.shape[2]
    rep = h // hkv
    qg = q.reshape(b, sq, hkv, rep, hd)
    logits = torch.einsum("bqgrh,bkgh->bgrqk", qg.float(), k.float()) \
        / math.sqrt(hd)
    mask = torch.ones((b, sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[:, None, :] <= q_pos[:, :, None]
    if window > 0:
        mask &= k_pos[:, None, :] > q_pos[:, :, None] - window
    if k_valid is not None:
        mask &= k_valid[:, None, :]
    logits = logits.masked_fill(~mask[:, None, None], -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrqk,bkgh->bqgrh", probs, v.float())
    return out.reshape(b, sq, h * hd).to(q.dtype)


def _plain_route(cfg: ModelConfig, q: Tensor, k: Tensor, v: Tensor,
                 pos: Tensor, window: int) -> Tensor:
    """The reference's self-attention: q-chunked when cfg.attn_chunk > 0
    divides S, else one sdpa.  q (B,S,H,hd); k,v (B,S,Hkv,hd); pos (B,S).
    Returns (B, S, H*hd)."""
    c = cfg.attn_chunk
    s = q.shape[1]
    if c > 0 and s > c and s % c == 0:
        return _chunked_sdpa(cfg, q, k, v, pos, window, c)
    return sdpa(cfg, q, k, v, q_pos=pos, k_pos=pos, window=window,
                causal=True)


def _flash_route(cfg: ModelConfig, q: Tensor, k: Tensor, v: Tensor,
                 window: int) -> Tensor:
    """Causal / sliding-window self-attention through the hand-written
    flash kernel at positions 0..S-1: one launch.  q (B,S,H,hd); k,v
    (B,S,Hkv,hd).  Returns (B, S, H*hd) in q's dtype.  The wrapper's blk
    only validates the window: the largest power of two up to FLASH_BLK
    that divides it."""
    b, s, h, hd = q.shape
    blk = math.gcd(window, FLASH_BLK) if window > 0 else FLASH_BLK
    out = ops.flash_mha(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2),
                        window=window if window > 0 else None, blk=blk)
    return out.transpose(1, 2).reshape(b, s, h * hd)


def index_stream(positions: Optional[Tensor]) -> bool:
    """Whether the attention mask's position stream (the temporal stream
    positions[:, 0, :] of (B, 3, S) m-rope streams, or (B, S) positions) is
    0..S-1 in every row, so that the flash kernel's index mask is the
    reference's.  None is the index.  One comparison and one host sync:
    ``transformer.forward`` asks once a prefill, not once a layer."""
    if positions is None:
        return True
    stream = positions[:, 0, :] if positions.ndim == 3 else positions
    if stream.is_meta:     # no values: the general route, masked by stream
        return False
    index = torch.arange(stream.shape[-1], dtype=stream.dtype,
                         device=stream.device)
    return torch.equal(stream, index.expand_as(stream))


def records_grad(*tensors: Tensor) -> bool:
    """Whether autograd records an op on these tensors."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def self_attention(cfg: ModelConfig, q: Tensor, k: Tensor, v: Tensor,
                   positions: Optional[Tensor], window: int) -> Tensor:
    """Prefill self-attention of rotated q (B,S,H,hd) against k, v
    (B,S,Hkv,hd).  positions None masks by index 0..S-1: the flash kernel
    on the card, the plain route on the CPU and under autograd (the
    kernel has no backward).  Explicit positions (B,S) mask by that
    stream: the plain route on both devices."""
    if positions is None:
        if q.device.type == "cuda" and not records_grad(q, k, v):
            return _flash_route(cfg, q, k, v, window)
        positions = default_positions(q.shape[0], q.shape[1],
                                      device=q.device).expand(q.shape[0], -1)
    return _plain_route(cfg, q, k, v, positions, window)


def attention_apply(cfg: ModelConfig, p: Mapping[str, Tensor], x: Tensor,
                    positions: Optional[Tensor], window: int,
                    index_mask: bool = False):
    """Full-sequence self-attention (train/prefill).  positions: (B, S),
    (B, 3, S) for m-rope, or None for 0..S-1; they always rotate q and k.
    The mask takes their (temporal) stream, or the index 0..S-1 when
    positions is None or the caller has found the stream to be the index
    (``index_mask``, from ``index_stream``).  Returns (out (B,S,D), (k, v)
    rotated, (B,S,Hkv,hd)).

    cfg.attn_chunk > 0 selects the reference's q-chunked path on the plain
    route; on the card the flash kernel takes an index-masked layer whole.
    """
    b, s = x.shape[0], x.shape[1]
    q, k, v = _project_qkv(cfg, p, x, x)
    rope_pos = positions if positions is not None else \
        default_positions(b, s, device=x.device).expand(b, -1)
    q = apply_rope(cfg, q, rope_pos)
    k = apply_rope(cfg, k, rope_pos)
    pos1d = None
    if positions is not None and not index_mask:
        pos1d = positions[:, 0, :] if positions.ndim == 3 else positions
    out = self_attention(cfg, q, k, v, pos1d, window)
    return out @ p["wo"].to(out.dtype), (k, v)


def encoder_attention_apply(cfg: ModelConfig, p: Mapping[str, Tensor],
                            x: Tensor, positions: Tensor) -> Tensor:
    """The encoder's bidirectional self-attention
    (``repro/models/encdec.py`` ``_enc_block_apply``): q, k rotated at
    positions (B, S), no causal mask, q-chunked when cfg.attn_chunk > 0
    divides S.  Plain tensor code on both devices.  Returns (B, S, D)."""
    q, k, v = _project_qkv(cfg, p, x, x)
    q = apply_rope(cfg, q, positions)
    k = apply_rope(cfg, k, positions)
    out = _bidirectional_sdpa(cfg, q, k, v, positions, positions)
    return out @ p["wo"].to(out.dtype)


def _bidirectional_sdpa(cfg: ModelConfig, q: Tensor, k: Tensor, v: Tensor,
                        q_pos: Tensor, k_pos: Tensor) -> Tensor:
    """sdpa with no causal mask, q-chunked when cfg.attn_chunk > 0 divides
    S_q (the reference's scan over query chunks)."""
    s, c = q.shape[1], cfg.attn_chunk
    if c > 0 and s > c and s % c == 0:
        def chunk(qi, pi):
            return sdpa(cfg, qi, k, v, q_pos=pi, k_pos=k_pos, window=0,
                        causal=False)
        return torch.cat([remat(cfg, chunk, q[:, i:i + c], q_pos[:, i:i + c])
                          for i in range(0, s, c)], dim=1)
    return sdpa(cfg, q, k, v, q_pos=q_pos, k_pos=k_pos, window=0,
                causal=False)


def _chunked_sdpa(cfg: ModelConfig, q: Tensor, k: Tensor, v: Tensor,
                  pos: Tensor, window: int, c: int) -> Tensor:
    """A loop over query chunks of size c.  Static-window layers (cfg.window
    > 0 uniformly) additionally slice keys to a (c + window) band.

    attn_impl == "causal_sliced": chunk i's keys are sliced to the causal
    prefix [0, (i+1)*c): attention FLOPs drop from S^2 to the triangle
    S(S+c)/2, the paper's C1 insight in static shapes.
    """
    b, s, h, hd = q.shape
    nc = s // c
    band = (cfg.window > 0 and not cfg.global_layers
            and not cfg.global_layer_stride and cfg.window + c < s)
    kw = cfg.window + c if band else None
    sliced = cfg.attn_impl == "causal_sliced" and not band

    def chunk(qi, pi, kk, vv, kp):
        return sdpa(cfg, qi, kk, vv, q_pos=pi, k_pos=kp, window=window,
                    causal=True)

    outs = []
    for i in range(nc):
        qi, pi = q[:, i * c:(i + 1) * c], pos[:, i * c:(i + 1) * c]
        if sliced:
            hi = (i + 1) * c
            kk, vv, kp = k[:, :hi], v[:, :hi], pos[:, :hi].expand(b, hi)
        elif band:
            start = min(max(i * c - cfg.window, 0), s - kw)
            kk, vv = k[:, start:start + kw], v[:, start:start + kw]
            kp = (start + torch.arange(kw, device=q.device))[None, :] \
                .expand(b, kw)
        else:
            kk, vv, kp = k, v, pos[:, :s].expand(b, s)
        # the reference's unrolled causal_sliced loop has no jax.checkpoint;
        # its scan body has
        outs.append(chunk(qi, pi, kk, vv, kp) if sliced else
                    remat(cfg, chunk, qi, pi, kk, vv, kp))
    return torch.cat(outs, dim=1).reshape(b, s, h * hd)


def attention_decode(cfg: ModelConfig, p: Mapping[str, Tensor], x: Tensor,
                     positions: Optional[Tensor], window: int,
                     k_cache: Tensor, v_cache: Tensor,
                     cache_index: int) -> Tuple[Tensor, Tensor, Tensor]:
    """Single-token decode against a (B, Hkv, cap, hd) cache.

    Full-attention layers use cap = max context (slot = position); SWA
    layers use cap = window (ring buffer, slot = position % cap).  Either
    way absolute slot positions are reconstructed in closed form, so masking
    is uniform.  The caches are written in place (the reference donates
    them) and returned.
    """
    q, k, v = _project_qkv(cfg, p, x, x)  # sq = 1
    t = int(cache_index)  # number of tokens already cached
    rope_pos = _decode_rope_pos(positions, x.shape[0], t, x.device)
    q = apply_rope(cfg, q, rope_pos)
    k = apply_rope(cfg, k, rope_pos)
    _write_slot(k_cache, v_cache, k, v, t)
    out = _decode_sdpa(cfg, q, window, k_cache, v_cache, t)
    return out @ p["wo"].to(out.dtype), k_cache, v_cache


def _decode_rope_pos(positions: Optional[Tensor], b: int, t: int,
                     device) -> Tensor:
    """Decode's rotary positions: the (B, 3, 1) m-rope streams as given,
    else position t."""
    if positions is not None and positions.ndim == 3:
        return positions
    return torch.full((b, 1), t, dtype=torch.int32, device=device)


def _write_slot(k_cache: Tensor, v_cache: Tensor, k: Tensor, v: Tensor,
                t: int) -> None:
    """Token t's k, v (B, 1, Hkv, hd) into slot t % cap of the caches."""
    slot = t % k_cache.shape[2]
    k_cache[:, :, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[:, :, slot] = v[:, 0].to(v_cache.dtype)


def _decode_sdpa(cfg: ModelConfig, q: Tensor, window: int, k_cache: Tensor,
                 v_cache: Tensor, t: int) -> Tensor:
    """q (B, 1, H, hd) at position t against the cache's slots, each at
    its absolute position: with t+1 tokens written, slot s holds
    p(s) = t - ((t - s) mod cap) (the newest, t, at slot t % cap); slots
    with p(s) < 0 are dead.  Returns (B, 1, H*hd)."""
    b, cap = q.shape[0], k_cache.shape[2]
    s_idx = torch.arange(cap, dtype=torch.int64, device=q.device)
    slot_pos = t - torch.remainder(t - s_idx, cap)
    valid = slot_pos >= 0
    q_pos = torch.full((b, 1), t, dtype=torch.int64, device=q.device)
    k_pos = slot_pos[None, :].expand(b, cap)
    k_valid = valid[None, :].expand(b, cap)
    kc = k_cache.transpose(1, 2)  # (B, cap, Hkv, hd)
    vc = v_cache.transpose(1, 2)
    return sdpa(cfg, q, kc, vc, q_pos=q_pos, k_pos=k_pos, window=window,
                causal=True, k_valid=k_valid)


def cross_attention_apply(cfg: ModelConfig, p: Mapping[str, Tensor],
                          x: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """Cross-attention of x (B, S_q, D) against precomputed encoder K/V
    (B, S_enc, Hkv, hd): every position 0, no causal mask, q-chunked like
    self-attention when cfg.attn_chunk > 0 divides S_q.  Plain tensor code
    on both devices.  Returns (B, S_q, D)."""
    b, sq, _ = x.shape
    hd, h = cfg.hd, cfg.n_heads
    q = (x @ p["wq"].to(x.dtype)).reshape(b, sq, h, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    q_pos = torch.zeros((b, sq), dtype=torch.int32, device=x.device)
    k_pos = torch.zeros((b, k.shape[1]), dtype=torch.int32, device=x.device)
    out = _bidirectional_sdpa(cfg, q, k, v, q_pos, k_pos)
    return out @ p["wo"].to(out.dtype)


def cross_kv(cfg: ModelConfig, p: Mapping[str, Tensor],
             enc_out: Tensor) -> Tuple[Tensor, Tensor]:
    """A cross-attention layer's K and V (B, S_enc, Hkv, hd) of the
    encoder's output."""
    b, sk, _ = enc_out.shape
    hkv, hd = cfg.n_kv_heads, cfg.hd
    k = (enc_out @ p["wk"].to(enc_out.dtype)).reshape(b, sk, hkv, hd)
    v = (enc_out @ p["wv"].to(enc_out.dtype)).reshape(b, sk, hkv, hd)
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return k, v


# ---------------------------------------------------------------------------
# MLP variants
# ---------------------------------------------------------------------------


def init_mlp(gen, cfg: ModelConfig, device=None) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    dev = _device(gen, device)
    p = {"w1": dense_init(gen, (d, f), dev),
         "w2": dense_init(gen, (f, d), dev,
                          scale=0.02 / max(cfg.n_layers, 1) ** 0.5)}
    if cfg.activation == "swiglu":
        p["w3"] = dense_init(gen, (d, f), dev)
    return p


def mlp_apply(cfg: ModelConfig, p: Mapping[str, Tensor], x: Tensor,
              partial: bool = False) -> Tensor:
    """The MLP of x (B, S, D).  ``partial``: p holds a rank's columns of
    w1 / w3 and rows of w2, and the result is the float32 partial
    (``mm32``) of a row-parallel w2."""
    h = x @ p["w1"].to(x.dtype)
    if cfg.activation == "swiglu":
        g = x @ p["w3"].to(x.dtype)
        h = F.silu(h.float()).to(x.dtype) * g
    elif cfg.activation == "squared_relu":
        r = torch.clamp_min(h, 0)
        h = r * r
    elif cfg.activation == "gelu":
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    else:
        raise ValueError(f"unknown activation {cfg.activation}")
    return mm32(h, p["w2"]) if partial else h @ p["w2"].to(x.dtype)


# ---------------------------------------------------------------------------
# MoE (sort-based capacity routing; no one-hot dispatch einsum)
# ---------------------------------------------------------------------------


def init_moe(gen, cfg: ModelConfig, device=None) -> dict:
    d, fm, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    dev = _device(gen, device)
    p = {"router": dense_init(gen, (d, e), dev),
         "w1": dense_init(gen, (e, d, fm), dev),
         "w2": dense_init(gen, (e, fm, d), dev,
                          scale=0.02 / max(cfg.n_layers, 1) ** 0.5)}
    if cfg.activation == "swiglu":
        p["w3"] = dense_init(gen, (e, d, fm), dev)
    return p


def moe_capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots an expert has for a routing group of `tokens` tokens, in the
    reference's Python arithmetic."""
    return max(1, int(cfg.capacity_factor * tokens * cfg.top_k
                      / cfg.n_experts))


def moe_choose(cfg: ModelConfig, router: Tensor, x: Tensor):
    """Each token's k experts: (probs (R, N, E) the router's float32
    softmax, top_p (R, N, k) the chosen ones' probabilities normalised to
    sum 1, top_i (R, N, k) the experts, the larger first, the lower expert
    first on equal values)."""
    k = cfg.top_k
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[..., :k], top_i[..., :k]
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    return probs, top_p, top_i


def moe_route(cfg: ModelConfig, router: Tensor, x: Tensor, cap: int):
    """Token-choice top-k routing of R independent groups of N tokens,
    x (R, N, D), into `cap` slots an expert.  Returns
      dest (R, N*k)   buffer row of each sorted assignment, E*cap if dropped
      st, sw (R, N*k) its token and normalised weight
      keep (R, N*k)   whether it got a slot
      probs (R, N, E) the router's softmax (float32)
      flat_e (R, N*k) the chosen experts in token order.
    The reference's route_one: the router logits are a float32 product;
    the k largest probabilities by a stable descending sort (jax.lax.top_k's
    rule: the lower expert first on equal values); assignments stably
    sorted by expert; an assignment's slot is its rank in its expert's run
    (searchsorted, left); over-capacity ones go to the scratch row E*cap.
    Indices are int64 (the reference's int32 values)."""
    r, n, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    probs, top_p, top_i = moe_choose(cfg, router, x)
    flat_e = top_i.reshape(r, n * k)
    flat_t = torch.arange(n, device=x.device).repeat_interleave(k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    st = flat_t[order]
    sw = torch.gather(top_p.reshape(r, n * k), 1, order)
    experts = torch.arange(e, device=x.device).expand(r, e).contiguous()
    group_start = torch.searchsorted(se, experts, side="left")
    pos = torch.arange(n * k, device=x.device) \
        - torch.gather(group_start, 1, se)
    keep = pos < cap
    dest = torch.where(keep, se * cap + pos, e * cap)
    return dest, st, sw, keep, probs, flat_e


def _expert_ffn(cfg: ModelConfig, p: Mapping[str, Tensor],
                xe: Tensor, partial: bool = False) -> Tensor:
    """The experts' FFN on (E, C, D) buffers: the reference's
    'ecd,edf->ecf' einsums as batched matmuls, each weight cast to the
    activations' dtype at its use.  ``partial``: p holds a rank's F
    columns of every expert, and the result is the float32 partial of a
    row-parallel w2."""
    dt = xe.dtype
    h = torch.bmm(xe, p["w1"].to(dt))
    if cfg.activation == "swiglu":
        g = torch.bmm(xe, p["w3"].to(dt))
        h = F.silu(h.float()).to(dt) * g
    elif cfg.activation == "squared_relu":
        r = torch.clamp_min(h, 0)
        h = r * r
    else:
        h = F.gelu(h.float(), approximate="tanh").to(dt)
    return mm32(h, p["w2"]) if partial else torch.bmm(h, p["w2"].to(dt))


def _moe_groups(cfg: ModelConfig, p: Mapping[str, Tensor], x: Tensor,
                cap: int) -> Tuple[Tensor, Tensor]:
    """Route, dispatch, run the experts and combine R groups x (R, N, D).
    Returns (out (R, N, D), Switch-style aux loss)."""
    xe, state = _moe_dispatch(cfg, p["router"], x, cap)
    return _moe_combine(cfg, _expert_ffn(cfg, p, xe), state)


def _moe_dispatch(cfg: ModelConfig, router: Tensor, x: Tensor, cap: int):
    """Route R groups x (R, N, D) and scatter their tokens into the
    experts' buffers.  Returns (xe (E, R*cap, D), the routing state that
    ``_moe_combine`` reads)."""
    r, n, d = x.shape
    e = cfg.n_experts
    dest, st, sw, keep, probs, flat_e = moe_route(cfg, router, x, cap)
    rows = torch.arange(r, device=x.device)[:, None]
    # dispatch: one scatter into (R, E*cap + 1, D); dropped assignments
    # land on each group's scratch row, which is discarded
    buf = x.new_zeros((r, e * cap + 1, d))
    buf[rows, dest] = x[rows, st]
    xe = buf[:, :e * cap].reshape(r, e, cap, d).transpose(0, 1)
    return xe.reshape(e, r * cap, d), (dest, st, sw, keep, probs, flat_e,
                                       (r, n, d, cap))


def _moe_combine(cfg: ModelConfig, ye: Tensor, state) -> Tuple[Tensor,
                                                                  Tensor]:
    """The experts' outputs ye (E, R*cap, D) combined into each token's
    weighted sum over its k assignments, and the aux loss: (out (R, N, D),
    aux)."""
    dest, st, sw, keep, probs, flat_e, (r, n, d, cap) = state
    e, k = cfg.n_experts, cfg.top_k
    rows = torch.arange(r, device=ye.device)[:, None]
    ye = ye.reshape(e, r, cap, d).transpose(0, 1).reshape(r, e * cap, d)
    # combine without atomics: each token's k assignments, in sorted
    # (expert-ascending) order as the reference's scatter-add visits them,
    # gathered once as (R, N, k, D) rows and summed over k
    by_token = torch.argsort(st, dim=-1, stable=True)
    dest, sw, keep = (torch.gather(a, 1, by_token) for a in (dest, sw, keep))
    y = ye[rows, dest.clamp(max=e * cap - 1)]
    y = y.masked_fill(~keep[..., None], 0) * sw[..., None].to(y.dtype)
    out = y.reshape(r, n, k, d).sum(2)
    return out, _moe_aux(cfg, *_moe_balance(cfg, state))


def _moe_balance(cfg: ModelConfig, state) -> Tuple[Tensor, Tensor]:
    """A routing state's mean router probabilities and share of the
    assignments, (E,) each: the terms of the Switch-style aux loss."""
    probs, flat_e, (r, n, _, _) = state[4], state[5], state[6]
    # an exact integer count, without bincount's host sync on CUDA
    flat = flat_e.reshape(-1)
    ce = flat.new_zeros(cfg.n_experts).scatter_add_(
        0, flat, torch.ones_like(flat)).float() / (r * n * cfg.top_k)
    return probs.mean(dim=(0, 1)), ce


def _moe_aux(cfg: ModelConfig, me: Tensor, ce: Tensor) -> Tensor:
    return cfg.n_experts * torch.sum(me * ce) * cfg.router_aux_weight


def moe_apply(cfg: ModelConfig, p: Mapping[str, Tensor],
              x: Tensor) -> Tuple[Tensor, Tensor]:
    if cfg.moe_impl == "per_example":
        return moe_apply_per_example(cfg, p, x)
    return moe_apply_global(cfg, p, x)


def moe_apply_global(cfg: ModelConfig, p: Mapping[str, Tensor],
                     x: Tensor) -> Tuple[Tensor, Tensor]:
    """Token-choice top-k MoE with sort-based dispatch over all B*S tokens
    as one group: capacity C = cf * B*S * k / E, over-capacity assignments
    dropped.  Returns (out (B, S, D), aux_loss)."""
    b, s, d = x.shape
    out, aux = _moe_groups(cfg, p, x.reshape(1, b * s, d),
                           moe_capacity(cfg, b * s))
    return out.reshape(b, s, d), aux


def moe_apply_per_example(cfg: ModelConfig, p: Mapping[str, Tensor],
                          x: Tensor) -> Tuple[Tensor, Tensor]:
    """Per-example (batch-local) routing: each batch row is its own group
    (the reference's vmap of route_one), capacity C = cf * S * k / E."""
    return _moe_groups(cfg, p, x, moe_capacity(cfg, x.shape[1]))


# ---------------------------------------------------------------------------
# Tensor-parallel forms (models/parallel.py): one list entry a rank
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HeadPlan:
    """Which heads each model index m computes in one attention layer.

    ``rows[m]`` is (lo, hi), m's rows of wo in the flattened H*hd ((0,
    H*hd) where wo is whole); ``q[m]`` the query heads covering them,
    widened to whole GQA groups; ``reads[m]`` the KV heads those read;
    ``kv[m]`` the KV heads m projects: its cache's heads in cached
    self-attention (all of them where the cache is whole or split by
    positions), else ``reads[m]``; sequence-mode decode (``all_q``)
    computes every query head on every rank.  ``gather[w]``: the
    projection w's column shards do not hold every rank's heads, so they
    are all-gathered first (the specs cut columns, not heads: hymba's 25
    heads at tp 4, or wq cut while wk is whole)."""
    q: tuple
    kv: tuple
    reads: tuple
    rows: tuple
    gather: dict
    wo_split: bool


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def head_plan(cfg: ModelConfig, px, prefix: str, cached: bool,
              seq: bool = False, all_q: bool = False) -> HeadPlan:
    """The HeadPlan of the attention leaves under `prefix` ("blocks/attn",
    "blocks/xattn", "enc_blocks/attn"), made once a placement.  `seq`: the
    cache is split by positions, so it holds every KV head; `all_q`: every
    rank computes every query head (sequence-mode decode)."""
    def make():
        hd, h, hkv, tp = cfg.hd, cfg.n_heads, cfg.n_kv_heads, px.tp
        rep = h // hkv
        wo_split = px.tp_dim(f"{prefix}/wo") == 0
        kv_split = cached and not seq and px.policy._div(hkv, tp)
        q, kv, reads, rows = [], [], [], []
        for m in range(tp):
            lo, hi = ((m * h * hd // tp, (m + 1) * h * hd // tp)
                      if wo_split else (0, h * hd))
            h0 = 0 if all_q else lo // hd // rep * rep
            h1 = h if all_q else _ceil(_ceil(hi, hd), rep) * rep
            need = (h0 // rep, h1 // rep)
            own = need
            if cached:
                own = ((m * hkv // tp, (m + 1) * hkv // tp) if kv_split
                       else (0, hkv))
                if not own[0] <= need[0] <= need[1] <= own[1]:
                    raise AssertionError(f"{prefix}: rank {m} reads KV "
                                         f"heads {need}, holds {own}")
            q.append((h0, h1))
            kv.append(own)
            reads.append(need)
            rows.append((lo, hi))

        def gathered(w, ranges, width):
            if px.tp_dim(f"{prefix}/{w}") != 1:
                return False
            cols = width // tp
            return any(not (m * cols <= a * hd and b * hd <= (m + 1) * cols)
                       for m, (a, b) in enumerate(ranges))
        gather = {"wq": gathered("wq", q, h * hd),
                  "wk": gathered("wk", kv, hkv * hd),
                  "wv": gathered("wv", kv, hkv * hd)}
        return HeadPlan(tuple(q), tuple(kv), tuple(reads), tuple(rows),
                        gather, wo_split)
    return px.cached_plan(("heads", prefix, cached, seq, all_q), make)


def _heads_tp(cfg: ModelConfig, px, plan: HeadPlan, prefix: str, ps, xs,
              w: str, ranges, norm: Optional[str]) -> list:
    """Every rank's heads ranges[m] of the projection x @ p[w] (+ its
    bias), (B, S, n, hd), q / k-normed by p[norm]: each rank projects its
    columns (all of them where w is whole), gathered over the model axis
    where they do not hold its heads."""
    hd = cfg.hd
    ys = px.map(lambda x, wt: x @ wt.to(x.dtype), xs, [p[w] for p in ps])
    b = "b" + w[1]
    if b in ps[0]:
        ys = px.map(lambda y, bt: y + bt.to(y.dtype), ys, [p[b] for p in ps])
    split = px.tp_dim(f"{prefix}/{w}") == 1
    if plan.gather[w]:
        ys, split = px.all_gather(ys, -1), False
    out = []
    for r, y in enumerate(ys):
        m = r % px.tp
        a, e = ranges[m]
        c0 = m * y.shape[-1] if split else 0
        piece = y[..., a * hd - c0:e * hd - c0]
        out.append(piece.reshape(*piece.shape[:-1], e - a, hd))
    if norm is not None and cfg.qk_norm:
        out = px.map(lambda t, n: rms_norm(t, n, cfg.norm_eps), out,
                     [p[norm] for p in ps])
    return out


def _kv_reads(plan: HeadPlan, m: int) -> slice:
    """The KV heads that rank m's queries read, within those it holds."""
    k0 = plan.kv[m][0]
    return slice(plan.reads[m][0] - k0, plan.reads[m][1] - k0)


def _wo_tp(cfg: ModelConfig, px, plan: HeadPlan, ps, outs) -> Out:
    """Each rank's attention output (B, S, n*hd) over its heads plan.q[m]
    through its rows of wo: float32 partials where wo is row-split, the
    whole output where it is whole."""
    hd = cfg.hd
    parts = []
    for r, o in enumerate(outs):
        m = r % px.tp
        lo, hi = plan.rows[m]
        base = plan.q[m][0] * hd
        o = o[..., lo - base:hi - base]
        wo = ps[r]["wo"]
        parts.append(mm32(o, wo) if plan.wo_split else o @ wo.to(o.dtype))
    return Out(parts, plan.wo_split)


def _rope_positions(px, xs, positions) -> list:
    """Each rank's rotary positions: its rows of `positions`, or 0..S-1."""
    return list(positions) if positions[0] is not None else px.map(
            lambda x: default_positions(x.shape[0], x.shape[1],
                                        device=x.device).expand(
                                            x.shape[0], -1), xs)


def attention_apply_tp(cfg: ModelConfig, px, ps, xs, positions, window: int,
                       index_mask: bool = False,
                       prefix: str = "blocks/attn", seq: bool = False):
    """``attention_apply`` over the model axis: q, k, v column-parallel by
    the specs, each rank's self-attention on its heads (the flash kernel
    on the card: one launch a rank, at (B, n_q, S, hd) against (B, n_kv,
    S, hd)), wo row-parallel.  positions: one (B, S) / (B, 3, S) a rank, or
    Nones.  Returns (Out, each rank's rotated (k, v) of the KV heads it
    holds, (B, S, n, hd)): every KV head where `seq` (a cache split by
    positions)."""
    plan = head_plan(cfg, px, prefix, cached=True, seq=seq)
    q = _heads_tp(cfg, px, plan, prefix, ps, xs, "wq", plan.q, "q_norm")
    k = _heads_tp(cfg, px, plan, prefix, ps, xs, "wk", plan.kv, "k_norm")
    v = _heads_tp(cfg, px, plan, prefix, ps, xs, "wv", plan.kv, None)
    rope = _rope_positions(px, xs, positions)
    q = px.map(lambda t, pos: apply_rope(cfg, t, pos), q, rope)
    k = px.map(lambda t, pos: apply_rope(cfg, t, pos), k, rope)
    outs = []
    for r in range(px.p):
        pos1d = positions[r]
        if pos1d is not None:
            pos1d = None if index_mask else \
                (pos1d[:, 0, :] if pos1d.ndim == 3 else pos1d)
        sl = _kv_reads(plan, r % px.tp)
        outs.append(self_attention(cfg, q[r], k[r][:, :, sl], v[r][:, :, sl],
                                   pos1d, window))
    return _wo_tp(cfg, px, plan, ps, outs), list(zip(k, v))


def attention_decode_tp(cfg: ModelConfig, px, ps, xs, positions,
                        window: int, k_caches, v_caches, cache_index: int,
                        prefix: str = "blocks/attn", seq: bool = False) -> Out:
    """``attention_decode`` over the model axis: each rank writes the
    token's k, v of the KV heads its cache holds, (B, n_kv, cap, hd), and
    attends over those its query heads read.  Where `seq` the caches hold
    every KV head and a slice of the slots each (``_decode_seq_tp``)."""
    if seq:
        return _decode_seq_tp(cfg, px, ps, xs, positions, window, k_caches,
                              v_caches, int(cache_index), prefix)
    plan = head_plan(cfg, px, prefix, cached=True)
    t = int(cache_index)
    q = _heads_tp(cfg, px, plan, prefix, ps, xs, "wq", plan.q, "q_norm")
    k = _heads_tp(cfg, px, plan, prefix, ps, xs, "wk", plan.kv, "k_norm")
    v = _heads_tp(cfg, px, plan, prefix, ps, xs, "wv", plan.kv, None)
    rope = px.map(lambda x, pos: _decode_rope_pos(pos, x.shape[0], t,
                                                  x.device), xs, positions)
    q = px.map(lambda a, pos: apply_rope(cfg, a, pos), q, rope)
    k = px.map(lambda a, pos: apply_rope(cfg, a, pos), k, rope)
    outs = []
    for r in range(px.p):
        _write_slot(k_caches[r], v_caches[r], k[r], v[r], t)
        sl = _kv_reads(plan, r % px.tp)
        outs.append(_decode_sdpa(cfg, q[r], window, k_caches[r][:, sl],
                                 v_caches[r][:, sl], t))
    return _wo_tp(cfg, px, plan, ps, outs)


def _decode_seq_tp(cfg: ModelConfig, px, ps, xs, positions, window: int,
                   k_caches, v_caches, t: int, prefix: str) -> Out:
    """Flash-decoding over the model axis, for caches split by positions
    (rank m holds slots [m n, (m + 1) n) of a cap of tp n, every KV head):
    q, k and v are gathered to whole heads; the rank that owns slot t %
    cap writes the token's k, v there; each rank attends every head over
    its slice (``_decode_partial``); the partial (max, sum, unnormalised
    out) triples are all-gathered over the model axis and combined in
    float32, m = max_r m_r, out = sum_r e^(m_r - m) o_r / sum_r e^(m_r -
    m) l_r; each rank keeps the heads covering its rows of wo."""
    plan = head_plan(cfg, px, prefix, cached=True, seq=True, all_q=True)
    q = _heads_tp(cfg, px, plan, prefix, ps, xs, "wq", plan.q, "q_norm")
    k = _heads_tp(cfg, px, plan, prefix, ps, xs, "wk", plan.kv, "k_norm")
    v = _heads_tp(cfg, px, plan, prefix, ps, xs, "wv", plan.kv, None)
    rope = px.map(lambda x, pos: _decode_rope_pos(pos, x.shape[0], t,
                                                  x.device), xs, positions)
    q = px.map(lambda a, pos: apply_rope(cfg, a, pos), q, rope)
    k = px.map(lambda a, pos: apply_rope(cfg, a, pos), k, rope)
    n = k_caches[0].shape[2]
    cap = n * px.tp
    owner, slot = divmod(t % cap, n)
    packed = []
    for r in range(px.p):
        m = r % px.tp
        if m == owner:
            k_caches[r][:, :, slot] = k[r][:, 0].to(k_caches[r].dtype)
            v_caches[r][:, :, slot] = v[r][:, 0].to(v_caches[r].dtype)
        o, l, mx = _decode_partial(cfg, q[r], window, k_caches[r],
                                   v_caches[r], t, cap, m * n)
        packed.append(torch.cat([o, l[..., None], mx[..., None]], -1)[None])
    gathered = px.all_gather(packed, 0)      # (tp, B, 1, H, hd + 2)
    hd, dt = cfg.hd, q[0].dtype

    def merge(g):
        o, l, mx = g[..., :hd], g[..., hd], g[..., hd + 1]
        w = torch.exp(mx - mx.amax(0))
        out = (w[..., None] * o).sum(0) / (w * l).sum(0)[..., None]
        return out.reshape(*out.shape[:2], -1).to(dt)
    return _wo_tp(cfg, px, plan, ps, px.map(merge, gathered))


def _decode_partial(cfg: ModelConfig, q: Tensor, window: int,
                    k_cache: Tensor, v_cache: Tensor, t: int, cap: int,
                    lo: int):
    """One rank's share of ``_decode_sdpa``: q (B, 1, H, hd) at position t
    against the slots lo .. lo + n of a cache of `cap` slots, given as
    k_cache / v_cache (B, Hkv, n, hd), each slot at its absolute position
    (``_decode_sdpa``).  Returns the float32 unnormalised output (B, 1, H,
    hd), the sum of the exponentials (B, 1, H) and the logits' max (B, 1,
    H), masked slots at -1e30 (a rank without a live slot gives a max of
    -1e30, whose weight in the combine is 0)."""
    b, _, h, hd = q.shape
    hkv, n = k_cache.shape[1], k_cache.shape[2]
    rep = h // hkv
    s_idx = lo + torch.arange(n, dtype=torch.int64, device=q.device)
    slot_pos = t - torch.remainder(t - s_idx, cap)
    live = slot_pos >= 0
    if window > 0:
        live &= slot_pos > t - window
    qg = q.reshape(b, hkv, rep, hd)
    logits = torch.einsum("bgrh,bgkh->bgrk", qg.float(), k_cache.float()) \
        / math.sqrt(hd)
    logits = logits.masked_fill(~live, -1e30)
    mx = logits.amax(-1, keepdim=True)
    e = torch.exp(logits - mx)
    o = torch.einsum("bgrk,bgkh->bgrh", e, v_cache.float())
    return (o.reshape(b, 1, h, hd), e.sum(-1).reshape(b, 1, h),
            mx.reshape(b, 1, h))


def encoder_attention_apply_tp(cfg: ModelConfig, px, ps, xs, positions,
                               prefix: str = "enc_blocks/attn") -> Out:
    """``encoder_attention_apply`` over the model axis (plain on both
    devices), each rank on its heads."""
    plan = head_plan(cfg, px, prefix, cached=False)
    q = _heads_tp(cfg, px, plan, prefix, ps, xs, "wq", plan.q, "q_norm")
    k = _heads_tp(cfg, px, plan, prefix, ps, xs, "wk", plan.kv, "k_norm")
    v = _heads_tp(cfg, px, plan, prefix, ps, xs, "wv", plan.kv, None)
    q = px.map(lambda a, pos: apply_rope(cfg, a, pos), q, positions)
    k = px.map(lambda a, pos: apply_rope(cfg, a, pos), k, positions)
    outs = [_bidirectional_sdpa(cfg, q[r], k[r], v[r], positions[r],
                                positions[r]) for r in range(px.p)]
    return _wo_tp(cfg, px, plan, ps, outs)


def cross_kv_tp(cfg: ModelConfig, px, ps, enc_outs,
                prefix: str = "blocks/xattn"):
    """``cross_kv`` over the model axis: each rank's K and V (B, S_enc, n,
    hd) of the heads its queries read."""
    plan = head_plan(cfg, px, prefix, cached=False)
    k = _heads_tp(cfg, px, plan, prefix, ps, enc_outs, "wk", plan.kv,
                  "k_norm")
    v = _heads_tp(cfg, px, plan, prefix, ps, enc_outs, "wv", plan.kv, None)
    return k, v


def cross_attention_apply_tp(cfg: ModelConfig, px, ps, xs, ks, vs,
                             prefix: str = "blocks/xattn") -> Out:
    """``cross_attention_apply`` over the model axis (plain on both
    devices), each rank on its heads against ``cross_kv_tp``'s K, V."""
    plan = head_plan(cfg, px, prefix, cached=False)
    q = _heads_tp(cfg, px, plan, prefix, ps, xs, "wq", plan.q, "q_norm")
    outs = []
    for r in range(px.p):
        b, sq = q[r].shape[0], q[r].shape[1]
        q_pos = torch.zeros((b, sq), dtype=torch.int32, device=q[r].device)
        k_pos = torch.zeros((b, ks[r].shape[1]), dtype=torch.int32,
                            device=q[r].device)
        outs.append(_bidirectional_sdpa(cfg, q[r], ks[r], vs[r], q_pos,
                                        k_pos))
    return _wo_tp(cfg, px, plan, ps, outs)


def mlp_apply_tp(cfg: ModelConfig, px, ps, xs,
                 prefix: str = "blocks/mlp") -> Out:
    """``mlp_apply`` over the model axis: w1 / w3 column-parallel, w2
    row-parallel, where the specs split F; whole on every rank else."""
    split = px.tp_dim(f"{prefix}/w2") == 0
    return Out([mlp_apply(cfg, p, x, partial=split)
                for p, x in zip(ps, xs)], split)


def moe_apply_tp(cfg: ModelConfig, px, ps, xs, *, split: bool,
                 prefix: str = "blocks/moe"):
    """``moe_apply`` over the model axis.  The routing runs on every rank
    on the replicated router, as on one device; global routing over a
    batch `split` over data gathers the data ranks' tokens first, so that
    capacity and drops are the global batch's.  The experts run
    expert-parallel where the specs split E (each rank's experts' outputs
    all-gathered, so the combine is the one-device combine's, bitwise),
    intra-expert tensor-parallel where they split F (float32 partials,
    all-reduced), or whole on every rank.  Returns (Out, aux), the aux
    loss once for the whole batch."""
    gathered = cfg.moe_impl != "per_example" and split
    xin = px.gather_data(xs) if gathered else xs
    b, s, d = xin[0].shape
    if cfg.moe_impl == "per_example":
        groups, cap = xin, moe_capacity(cfg, s)
    else:
        groups = px.map(lambda x: x.reshape(1, b * s, d), xin)
        cap = moe_capacity(cfg, b * s)
    disp = px.map(lambda router, g: _moe_dispatch(cfg, router, g, cap),
                  [p["router"] for p in ps], groups)
    mode = px.tp_dim(f"{prefix}/w1")
    if mode == 0:          # expert parallel
        el = cfg.n_experts // px.tp
        ye = px.all_gather(
            [_expert_ffn(cfg, ps[r], disp[r][0][(r % px.tp) * el:
                                                (r % px.tp + 1) * el])
             for r in range(px.p)], 0)
    elif mode == 2:        # intra-expert tensor parallel
        ye = px.all_reduce([_expert_ffn(cfg, ps[r], disp[r][0], partial=True)
                            for r in range(px.p)], xs[0].dtype)
    else:
        ye = [_expert_ffn(cfg, ps[r], disp[r][0]) for r in range(px.p)]
    res = px.map(lambda y, st: _moe_combine(cfg, y, st), ye,
                 [dd[1] for dd in disp])
    outs = []
    for r, (o, _) in enumerate(res):
        o = o.reshape(b, s, d)
        if gathered:
            n = b // px.dp
            o = o.narrow(0, (r // px.tp) * n, n)
        outs.append(o)
    aux = res[0][1]     # the global batch's where it was gathered
    if split and not gathered:
        # batch-local routing of a split batch: the aux loss's means are
        # over every data group's rows (equal counts), as on one device
        home = px.devices[0]
        terms = [[t.to(home) for t in _moe_balance(cfg, disp[g * px.tp][1])]
                 for g in range(px.dp)]
        aux = _moe_aux(cfg, *(sum(ts) / px.dp for ts in zip(*terms)))
    return Out(outs, False), aux


__all__ = [
    "dense_init", "remat", "records_grad", "rms_norm", "apply_rope",
    "default_positions",
    "init_attention", "attention_apply", "attention_decode", "sdpa",
    "self_attention", "index_stream", "encoder_attention_apply",
    "cross_attention_apply", "cross_kv", "init_mlp", "mlp_apply", "init_moe",
    "moe_capacity", "moe_choose", "moe_route", "moe_apply", "moe_apply_global",
    "moe_apply_per_example", "HeadPlan", "head_plan", "attention_apply_tp",
    "attention_decode_tp", "encoder_attention_apply_tp", "cross_kv_tp",
    "cross_attention_apply_tp", "mlp_apply_tp", "moe_apply_tp",
]
