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
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig

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
    b = x.shape[0]
    cap = k_cache.shape[2]
    q, k, v = _project_qkv(cfg, p, x, x)  # sq = 1
    t = int(cache_index)  # number of tokens already cached
    rope_pos = positions if (positions is not None and positions.ndim == 3) \
        else torch.full((b, 1), t, dtype=torch.int32, device=x.device)
    q = apply_rope(cfg, q, rope_pos)
    k = apply_rope(cfg, k, rope_pos)
    slot = t % cap
    k_cache[:, :, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[:, :, slot] = v[:, 0].to(v_cache.dtype)
    # absolute position of each slot s given t+1 total tokens written:
    #   p(s) = t - ((t - s) mod cap)   (newest written at slot t%cap holds t)
    s_idx = torch.arange(cap, dtype=torch.int64, device=x.device)
    slot_pos = t - torch.remainder(t - s_idx, cap)
    valid = slot_pos >= 0
    q_pos = torch.full((b, 1), t, dtype=torch.int64, device=x.device)
    k_pos = slot_pos[None, :].expand(b, cap)
    k_valid = valid[None, :].expand(b, cap)
    kc = k_cache.transpose(1, 2)  # (B, cap, Hkv, hd)
    vc = v_cache.transpose(1, 2)
    out = sdpa(cfg, q, kc, vc, q_pos=q_pos, k_pos=k_pos, window=window,
               causal=True, k_valid=k_valid)
    return out @ p["wo"].to(out.dtype), k_cache, v_cache


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


def mlp_apply(cfg: ModelConfig, p: Mapping[str, Tensor], x: Tensor) -> Tensor:
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
    return h @ p["w2"].to(x.dtype)


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
                xe: Tensor) -> Tensor:
    """The experts' FFN on (E, C, D) buffers: the reference's
    'ecd,edf->ecf' einsums as batched matmuls, each weight cast to the
    activations' dtype at its use."""
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
    return torch.bmm(h, p["w2"].to(dt))


def _moe_groups(cfg: ModelConfig, p: Mapping[str, Tensor], x: Tensor,
                cap: int) -> Tuple[Tensor, Tensor]:
    """Route, dispatch, run the experts and combine R groups x (R, N, D).
    Returns (out (R, N, D), Switch-style aux loss)."""
    r, n, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    dest, st, sw, keep, probs, flat_e = moe_route(cfg, p["router"], x, cap)
    rows = torch.arange(r, device=x.device)[:, None]
    # dispatch: one scatter into (R, E*cap + 1, D); dropped assignments
    # land on each group's scratch row, which is discarded
    buf = x.new_zeros((r, e * cap + 1, d))
    buf[rows, dest] = x[rows, st]
    xe = buf[:, :e * cap].reshape(r, e, cap, d).transpose(0, 1)
    ye = _expert_ffn(cfg, p, xe.reshape(e, r * cap, d))
    ye = ye.reshape(e, r, cap, d).transpose(0, 1).reshape(r, e * cap, d)
    # combine without atomics: each token's k assignments, in sorted
    # (expert-ascending) order as the reference's scatter-add visits them,
    # gathered once as (R, N, k, D) rows and summed over k
    by_token = torch.argsort(st, dim=-1, stable=True)
    dest, sw, keep = (torch.gather(a, 1, by_token) for a in (dest, sw, keep))
    y = ye[rows, dest.clamp(max=e * cap - 1)]
    y = y.masked_fill(~keep[..., None], 0) * sw[..., None].to(y.dtype)
    out = y.reshape(r, n, k, d).sum(2)
    me = probs.mean(dim=(0, 1))
    # an exact integer count, without bincount's host sync on CUDA
    flat = flat_e.reshape(-1)
    ce = flat.new_zeros(e).scatter_add_(0, flat, torch.ones_like(flat)) \
        .float() / (r * n * k)
    aux = e * torch.sum(me * ce) * cfg.router_aux_weight
    return out, aux


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


__all__ = [
    "dense_init", "remat", "records_grad", "rms_norm", "apply_rope",
    "default_positions",
    "init_attention", "attention_apply", "attention_decode", "sdpa",
    "self_attention", "index_stream", "encoder_attention_apply",
    "cross_attention_apply", "cross_kv", "init_mlp", "mlp_apply", "init_moe",
    "moe_capacity", "moe_choose", "moe_route", "moe_apply", "moe_apply_global",
    "moe_apply_per_example",
]
