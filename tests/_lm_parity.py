"""Shared runs of the LM parity tests (tests/test_torch_lm_*.py): one SMOKE
config through the reference's jitted prefill and decode steps and through
the port's, on the same parameters (the reference's, carried over by
``convert.lm_params_from_reference``) and the same prompts (numpy seed 1).

Each side runs once per (arch, dtype, stream, chunk) in a test process: a
prefill of PROMPT tokens for BATCH rows into caches of PROMPT + STEPS
slots, then STEPS greedy decode steps fed the reference's tokens, so both
sides see the same inputs at every step.  hymba SMOKE's window is 32 and
its ssm_chunk 16: PROMPT = 48 crosses the window (the ring holds the last
32 positions) and three chunks, and the decode steps wrap the ring.

The prompts are numpy draws (seed 1): the tokens, then, as the reference's
launcher draws them, an encoder-decoder's source frames (B, PROMPT, D) or
the VLM's embeddings.  The VLM's m-rope streams (``stream``): "arange",
the launcher's broadcast 0..S-1; "image", IMAGE_STREAM's text and image
blocks, whose patches share a temporal position, so that the reference's
mask (by that stream) differs from an index mask.  ``chunk`` overrides
attn_chunk on both sides (16 at PROMPT = 48: the q-chunked path, its
chunks cut through the image blocks).

Tolerances: float32 configs, every logit and cache tensor within 1e-5 of
the reference's largest |value| of that tensor (TOL_F32: the same float32
terms added in other orders, a few ulps after the layers); bf16 configs,
every logit and cache element within the reference's own 2e-2
(tests/test_models.py, TOL_BF16).  The greedy tokens agree wherever the
reference's top-2 margin exceeds twice the tolerance.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_get_config
from repro.models import steps as ref_steps
from repro.models.registry import build_model as ref_build_model
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import steps

PROMPT, BATCH, STEPS = 48, 2, 6
TOL_F32 = 1e-5
TOL_BF16 = 2e-2


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# (kind, length, grid) blocks of PROMPT = 48 positions in Qwen2-VL's
# M-RoPE layout (arXiv:2409.12191 SS2.1): text advances t, h and w together;
# an h x w image block shares one t, its h and w the grid coordinates, all
# offset by the position it starts at; the text after it continues from
# that position + max(h, w).  Both blocks cross a 16-chunk boundary.
IMAGE_STREAM = (("text", 6), ("image", (3, 4)), ("text", 4),
                ("image", (4, 4)), ("text", 10))


def mrope_stream(blocks):
    """The (3, S) int32 m-rope streams of `blocks` and the next position."""
    t, h, w, nxt = [], [], [], 0
    for kind, size in blocks:
        if kind == "text":
            run = list(range(nxt, nxt + size))
            t += run
            h += run
            w += run
            nxt += size
        else:
            rows, cols = size
            for r in range(rows):
                for c in range(cols):
                    t.append(nxt)
                    h.append(nxt + r)
                    w.append(nxt + c)
            nxt += max(rows, cols)
    return np.array([t, h, w], np.int32), nxt


def configs(arch, dtype=None, chunk=None, extra=()):
    """The SMOKE configs of both packages, with `dtype`, attn_chunk `chunk`
    and the (field, value) pairs `extra` replaced."""
    ref, port = ref_get_config(arch, smoke=True), get_config(arch, smoke=True)
    fields = dict(extra)
    if dtype is not None:
        fields["dtype"] = dtype
    if chunk is not None:
        fields["attn_chunk"] = chunk
    return dataclasses.replace(ref, **fields), \
        dataclasses.replace(port, **fields)


def _caches(cache):
    """An encoder-decoder's one cache dict, or the per-run list."""
    return cache if isinstance(cache, list) else [cache]


def inputs(cfg, stream=None):
    """The numpy prompts of a config (module docstring): a dict of the
    prefill's inputs, and the VLM's (B, 3, 1) m-rope streams of decode step
    t (None for the other families)."""
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (BATCH, PROMPT)).astype(np.int32)
    if not (cfg.enc_dec or cfg.embed_inputs):
        return {"tokens": toks}, None
    frames = rng.standard_normal((BATCH, PROMPT, cfg.d_model)).astype(
        np.float32)
    if cfg.enc_dec:
        return {"src": frames, "tokens": toks}, None
    batch = {"embeds": frames}   # the VLM: m-rope streams
    if stream == "image":
        pos, nxt = mrope_stream(IMAGE_STREAM)
        assert pos.shape[1] == PROMPT
    else:
        pos, nxt = np.broadcast_to(np.arange(PROMPT, dtype=np.int32),
                                   (3, PROMPT)), PROMPT
    batch["positions"] = np.ascontiguousarray(
        np.broadcast_to(pos, (BATCH, 3, PROMPT)))
    return batch, lambda t: np.full((BATCH, 3, 1), nxt + t, np.int32)


@functools.lru_cache(maxsize=None)
def reference_run(arch, dtype=None, stream=None, chunk=None, extra=()):
    """The reference's params (numpy), inputs, and per step (the prefill
    first) the logits and caches as float32 numpy, the token fed next."""
    rcfg, _ = configs(arch, dtype, chunk, extra)
    params = ref_build_model(rcfg).init(jax.random.PRNGKey(0))
    batch, dec_pos = inputs(rcfg, stream)
    dt = rcfg.activation_dtype()
    jbatch = {k: jnp.asarray(v, dt if v.dtype == np.float32 else None)
              for k, v in batch.items()}
    prefill = jax.jit(ref_steps.make_prefill_step(
        rcfg, cache_capacity=PROMPT + STEPS))
    decode = jax.jit(ref_steps.make_decode_step(rcfg))
    logits, cache = prefill(params, **jbatch)
    runs = []
    for t in range(STEPS + 1):
        tok = np.asarray(jnp.argmax(logits[:, -1], -1)[:, None], np.int32)
        runs.append({"logits": _np(logits),
                     "cache": [{k: _np(v) for k, v in c.items()}
                               for c in _caches(cache)],
                     "next": tok})
        if t < STEPS:
            dkw = {} if dec_pos is None else \
                {"positions": jnp.asarray(dec_pos(t))}
            logits, cache = decode(params, token=jnp.asarray(tok),
                                   cache=cache,
                                   cache_index=jnp.int32(PROMPT + t), **dkw)
    return jax.tree.map(np.asarray, params), batch, runs


def port_inputs(cfg, batch):
    """The port's tensors of numpy inputs: ids as int64, frames in the
    activations' dtype."""
    return {k: torch.from_numpy(v).to(cfg.activation_dtype())
            if v.dtype == np.float32 else torch.from_numpy(v).long()
            for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def port_run(arch, dtype=None, stream=None, chunk=None):
    """The port's steps on the reference's params and inputs, as
    reference_run gives them."""
    _, cfg = configs(arch, dtype, chunk)
    params, batch, ref_runs = reference_run(arch, dtype, stream, chunk)
    _, dec_pos = inputs(cfg, stream)
    model = lm_params_from_reference(cfg, params, device="cpu")
    prefill = steps.make_prefill_step(cfg, cache_capacity=PROMPT + STEPS)
    decode = steps.make_decode_step(cfg)
    logits, cache = prefill(model, **port_inputs(cfg, batch))
    runs = []
    for t in range(STEPS + 1):
        runs.append({"logits": logits.float().numpy(),
                     "cache": [{k: v.float().numpy().copy()
                                for k, v in c.items()}
                               for c in _caches(cache)]})
        if t < STEPS:
            tok = torch.tensor(ref_runs[t]["next"], dtype=torch.long)
            dkw = {} if dec_pos is None else \
                {"positions": torch.from_numpy(dec_pos(t))}
            logits, cache = decode(model, token=tok, cache=cache,
                                   cache_index=PROMPT + t, **dkw)
    return runs


def within(want, got, rel=None, atol=None):
    """max |got - want|, and whether it is within `rel` of max |want| or
    `atol`."""
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    bound = rel * max(float(np.abs(want).max()), 1e-30) if rel else atol
    return err, err <= bound


def _check(want, got, dtype, what):
    if dtype is None:
        err, ok = within(want, got, rel=TOL_F32)
    else:
        err, ok = within(want, got, atol=TOL_BF16)
    assert ok, f"{what}: max |port - reference| = {err:.3e}"


def check_prefill(arch, dtype, stream=None, chunk=None):
    _, _, ref = reference_run(arch, dtype, stream, chunk)
    got = port_run(arch, dtype, stream, chunk)
    _check(ref[0]["logits"], got[0]["logits"], dtype, "prefill logits")
    assert len(got[0]["cache"]) == len(ref[0]["cache"])
    for i, (rc, pc) in enumerate(zip(ref[0]["cache"], got[0]["cache"])):
        assert sorted(rc) == sorted(pc)
        for name in rc:
            _check(rc[name], pc[name], dtype,
                   f"prefill cache run {i} {name}")


def check_decode(arch, dtype, stream=None, chunk=None):
    _, _, ref = reference_run(arch, dtype, stream, chunk)
    got = port_run(arch, dtype, stream, chunk)
    tol = TOL_F32 if dtype is None else TOL_BF16
    for t in range(1, STEPS + 1):
        _check(ref[t]["logits"], got[t]["logits"], dtype,
               f"decode step {t} logits")
        for i, (rc, pc) in enumerate(zip(ref[t]["cache"], got[t]["cache"])):
            for name in rc:
                _check(rc[name], pc[name], dtype,
                       f"decode step {t} cache run {i} {name}")
    for t in range(STEPS + 1):
        want = ref[t]["logits"][:, -1]
        top2 = np.sort(want, axis=-1)[:, -2:]
        scale = np.abs(want).max() if dtype is None else 1.0
        clear = (top2[:, 1] - top2[:, 0]) > 2 * tol * scale
        port_tok = got[t]["logits"][:, -1].argmax(-1)
        np.testing.assert_array_equal(port_tok[clear],
                                      ref[t]["next"][clear, 0])


def reference_routing(cfg, p, x):
    """dest, keep and top_i of the reference's routing, restated from
    repro/models/layers.py:423-438 (global: one group of all B*S tokens)
    and its route_one (per_example: a group a batch row), in JAX, with
    leading group axes as moe_route returns them."""
    e, k = cfg.n_experts, cfg.top_k

    def route(xg, cap):
        logits = xg.astype(jnp.float32) @ p["router"].astype(jnp.float32)
        top_i = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)[1]
        flat_e = top_i.reshape(-1)
        order = jnp.argsort(flat_e, stable=True)
        se = flat_e[order]
        group_start = jnp.searchsorted(se, jnp.arange(e, dtype=se.dtype))
        pos = jnp.arange(flat_e.shape[0], dtype=jnp.int32) - group_start[se]
        keep = pos < cap
        return jnp.where(keep, se * cap + pos, e * cap), keep, top_i

    b, s, d = x.shape
    if cfg.moe_impl == "per_example":
        cap = max(1, int(cfg.capacity_factor * s * k / e))
        out = jax.vmap(lambda xg: route(xg, cap))(jnp.asarray(x))
    else:
        cap = max(1, int(cfg.capacity_factor * b * s * k / e))
        out = [a[None] for a in route(jnp.asarray(x).reshape(b * s, d), cap)]
    return [np.asarray(a) for a in out]
