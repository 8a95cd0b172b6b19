"""The port's training step against the reference's, on the CPU.

One SMOKE config of each family (dense llama3.2-3b, SSM falcon-mamba-7b,
hybrid hymba-1.5b, MoE qwen3-moe-30b-a3b, the VLM qwen2-vl-72b from
embeddings with m-rope streams, the encoder-decoder seamless-m4t-medium),
with the reference's parameters carried over
(``convert.lm_params_from_reference(..., trainable=True)``) and one numpy
batch (seed 3) of B = 2 rows of S = 48 tokens, at logits_chunk = 16 and
attn_chunk = 16 so that the loss and attention run their chunked,
recomputed paths (hymba's window of 32 is crossed, its SSM in 3 chunks).

Held apart, as an end-to-end step is not comparable leaf by leaf (Adam's
first step is lr * sign(g) wherever |g| >> eps, and a gradient near zero
may take either sign in two packages):
  * the loss and ``chunked_xent`` within 1e-5 relative;
  * every gradient leaf within 1e-5 of the reference leaf's largest |g|
    in float32, 2e-2 in bf16 (the reference's own bf16 tolerance), the MoE
    config in bf16 only when every routing decision agrees;
  * AdamW's ``update``, ``schedule`` and ``global_norm``, fed the
    reference's own gradients, within 1e-7 of each leaf's largest value,
    float32 and bf16 moments, over two steps.  The update is the
    reference's compiled arithmetic bit for bit (optim/adamw.py
    ``_update_chunk``) but for the learning rate's cosine, which XLA
    approximates its own way: one float32 ulp of lr can move a parameter
    by one ulp, which at the leaf's largest magnitude (a norm weight near
    1.0: 2^-23 = 1.19e-7) exceeds 1e-7 of it; so a leaf may also be off by
    one ulp of its largest value;
  * grad_accum 2 against one batch, remat "block" against "none".
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import layers as RL
from repro.models import steps as ref_steps
from repro.models.registry import build_model as ref_build_model
from repro.optim import adamw as ref_adamw
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import layers as L
from repro_torch.models import steps
from repro_torch.optim import adamw
from repro_torch.tree import named_leaves, reference_path

ARCHS = ("llama3.2-3b", "falcon-mamba-7b", "hymba-1.5b",
         "qwen3-moe-30b-a3b", "qwen2-vl-72b", "seamless-m4t-medium")
B, S, CHUNK = 2, 48, 16
TOL_F32 = 1e-5
TOL_BF16 = 2e-2
TOL_ADAM = 1e-7


def configs(arch, dtype="float32", **fields):
    fields = dict(dtype=dtype, logits_chunk=CHUNK, attn_chunk=CHUNK,
                  **fields)
    return (dataclasses.replace(ref_get_config(arch, smoke=True), **fields),
            dataclasses.replace(get_config(arch, smoke=True), **fields))


def make_batch(cfg):
    """numpy (seed 3): tokens and labels; an encoder-decoder's source
    frames, the VLM's embeddings and broadcast 0..S-1 m-rope streams."""
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.enc_dec or cfg.embed_inputs:
        frames = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        batch["src" if cfg.enc_dec else "embeds"] = frames
    if cfg.embed_inputs and not cfg.enc_dec:
        del batch["tokens"]
    if cfg.rope == "mrope":
        batch["positions"] = np.ascontiguousarray(np.broadcast_to(
            np.arange(S, dtype=np.int32), (B, 3, S)))
    return batch


@functools.lru_cache(maxsize=None)
def reference_params(arch):
    rcfg, _ = configs(arch)
    params = ref_build_model(rcfg).init(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(
        v.astype(jnp.float32) if v.dtype == jnp.bfloat16 else v)
        for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def reference_grads(arch, dtype):
    """The reference's jitted value_and_grad of loss_fn: (loss, metrics,
    flat gradients by path), numpy; and the MoE calls' top-k experts."""
    rcfg, _ = configs(arch, dtype)
    batch = make_batch(rcfg)
    routes, ref_moe = [], RL.moe_apply

    def spy(c, p, x):
        logits = x.astype(jnp.float32) @ p["router"].astype(jnp.float32)
        top = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), c.top_k)[1]
        jax.debug.callback(lambda t: routes.append(np.asarray(t)), top,
                           ordered=True)
        return ref_moe(c, p, x)

    fn = jax.value_and_grad(lambda p: ref_steps.loss_fn(rcfg, p, batch),
                            has_aux=True)
    with _patched(RL, "moe_apply", spy):
        (loss, metrics), grads = jax.jit(fn)(reference_params(arch))
        jax.effects_barrier()
    metrics = {k: float(v) for k, v in metrics.items()}
    return float(loss), metrics, _flat(grads), routes


class _patched:
    def __init__(self, mod, name, value):
        self.mod, self.name, self.value = mod, name, value

    def __enter__(self):
        self.old = getattr(self.mod, self.name)
        setattr(self.mod, self.name, self.value)

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.old)


def port_model(arch, dtype="float32", **fields):
    _, cfg = configs(arch, dtype, **fields)
    return cfg, lm_params_from_reference(cfg, reference_params(arch),
                                         device="cpu", trainable=True)


def port_grads(arch, dtype="float32", **fields):
    """The port's (metrics, gradients by port name, MoE top-k experts)."""
    cfg, model = port_model(arch, dtype, **fields)
    routes, route = [], L.moe_route

    def spy(c, router, x, cap):
        out = route(c, router, x, cap)
        routes.append(out[5].reshape(-1, c.top_k).numpy().copy())
        return out

    with _patched(L, "moe_route", spy):
        metrics, grads = steps.grads_of(
            cfg, model, steps.as_batch(make_batch(cfg), "cpu"))
    names = [n for n, _ in named_leaves(model)]
    return metrics, dict(zip(names, grads)), routes


def reference_leaf(flat, name):
    path, layer = reference_path(name)
    return flat[path] if layer is None else flat[path][layer]


def grad_shares(ref_flat, port):
    """Each leaf's largest |port - reference| over the reference leaf's
    largest |g| (over the whole stacked leaf)."""
    out = {}
    for name, g in port.items():
        path, _ = reference_path(name)
        scale = max(float(np.abs(ref_flat[path]).max()), 1e-30)
        want = reference_leaf(ref_flat, name)
        out[name] = float(np.abs(g.float().numpy() - want).max()) / scale
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_chunked_xent_match_the_reference(arch):
    rcfg, cfg = configs(arch)
    loss, metrics, _, _ = reference_grads(arch, "float32")
    batch = make_batch(cfg)
    _, model = port_model(arch)
    with torch.no_grad():
        got, got_m = steps.loss_fn(cfg, model, steps.as_batch(batch, "cpu"))
    assert set(got_m) == {"loss", "xent", "aux"}
    assert abs(float(got) - loss) <= TOL_F32 * abs(loss)
    for key in ("xent", "aux"):
        assert abs(float(got_m[key]) - metrics[key]) <= TOL_F32 * abs(loss)
    # chunked_xent alone, on one hidden state (3 chunks of 16) with pads
    rng = np.random.default_rng(4)
    hidden = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    labels = batch["labels"].copy()
    labels[0, -5:] = -1
    want = float(ref_steps.chunked_xent(rcfg, reference_params(arch),
                                        jnp.asarray(hidden),
                                        jnp.asarray(labels)))
    with torch.no_grad():
        got = float(steps.chunked_xent(cfg, model, torch.from_numpy(hidden),
                                       torch.from_numpy(labels)))
    assert abs(got - want) <= TOL_F32 * abs(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_the_reference_float32(arch):
    _, _, ref_flat, _ = reference_grads(arch, "float32")
    _, grads, _ = port_grads(arch)
    shares = grad_shares(ref_flat, grads)
    worst = max(shares, key=shares.get)
    assert shares[worst] <= TOL_F32, (worst, shares[worst])
    # every reference leaf has its port leaves
    paths = {reference_path(n)[0] for n in grads}
    assert paths == set(ref_flat)


def forced_choice(ref_tops):
    """A stand-in for ``L.moe_choose`` that keeps the port's router
    probabilities but takes each call's experts from `ref_tops` (the
    reference's calls in order: the forward's layers, then the backward's
    recomputations), so that both packages route alike."""
    calls = iter(ref_tops)

    def choose(c, router, x):
        probs = torch.softmax(x.float() @ router.float(), dim=-1)
        top_i = torch.from_numpy(np.array(next(calls))).long().reshape(
            *probs.shape[:-1], c.top_k)
        top_p = torch.gather(probs, -1, top_i)
        return probs, top_p / torch.clamp_min(
            top_p.sum(-1, keepdim=True), 1e-9), top_i
    return choose


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_the_reference_bf16(arch):
    _, _, ref_flat, ref_routes = reference_grads(arch, "bfloat16")
    if ref_routes:
        # MoE: a bf16 router may flip a near-tie; gradients compare where
        # the routing agrees, so the port takes the reference's choices
        # (and must then make every call the reference made)
        choose = forced_choice(ref_routes)
        with _patched(L, "moe_choose", choose):
            _, grads, routes = port_grads(arch, "bfloat16")
        assert len(routes) == len(ref_routes)
    else:
        _, grads, routes = port_grads(arch, "bfloat16")
        assert not routes
    shares = grad_shares(ref_flat, grads)
    worst = max(shares, key=shares.get)
    assert shares[worst] <= TOL_BF16, (worst, shares[worst])


def test_bf16_routing_flips_only_at_near_ties():
    """Unforced, the port's bf16 routing of the MoE config differs from
    the reference's only where the reference's k-th and (k+1)-th router
    probabilities lie within TOL_BF16 of each other."""
    arch = "qwen3-moe-30b-a3b"
    _, _, _, ref_routes = reference_grads(arch, "bfloat16")
    margins = reference_margins(arch)
    _, _, routes = port_grads(arch, "bfloat16")
    assert len(routes) == len(ref_routes) == len(margins)
    flips = 0
    for got, want, margin in zip(routes, ref_routes, margins):
        want = np.asarray(want).reshape(got.shape)
        rows = np.nonzero((np.sort(got, -1) != np.sort(want, -1)).any(-1))[0]
        flips += len(rows)
        assert (margin.reshape(-1)[rows] <= TOL_BF16).all(), rows
    assert flips < sum(r.size for r in routes) // 10


@functools.lru_cache(maxsize=None)
def reference_margins(arch):
    """Each MoE call's relative gap between the reference's k-th and
    (k+1)-th router probabilities, a token each, in the reference's bf16
    loss."""
    rcfg, _ = configs(arch, "bfloat16")
    batch = make_batch(rcfg)
    margins, ref_moe = [], RL.moe_apply

    def spy(c, p, x):
        logits = x.astype(jnp.float32) @ p["router"].astype(jnp.float32)
        top = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), c.top_k + 1)[0]
        gap = (top[..., -2] - top[..., -1]) / top[..., -2]
        jax.debug.callback(lambda g: margins.append(np.asarray(g)), gap,
                           ordered=True)
        return ref_moe(c, p, x)

    with _patched(RL, "moe_apply", spy):
        jax.jit(jax.grad(lambda p: ref_steps.loss_fn(rcfg, p, batch)[0]))(
            reference_params(arch))
        jax.effects_barrier()
    return margins


def _port_grads_list(model, ref_flat):
    return [torch.from_numpy(np.array(reference_leaf(ref_flat, n)))
            for n, _ in named_leaves(model)]


def _ulp(scale):
    """One float32 unit in the last place of `scale`."""
    return float(np.spacing(np.float32(scale)))


@pytest.mark.parametrize("moment_dtype,clip", [
    ("float32", "off"), ("float32", "on"), ("bfloat16", "off")])
@pytest.mark.parametrize("arch", ["llama3.2-3b", "hymba-1.5b"])
def test_adamw_matches_the_reference_on_its_gradients(arch, moment_dtype,
                                                      clip):
    """Two updates fed the reference's gradients (the second from the
    first's moments, step 2, gradients doubled): parameters and moments
    against the reference's; decay on the reference's stacked (L, ...)
    rank, so a layer's norm weight decays.

    Clipping off (clip_norm 1e3, above both global norms: scale exactly
    1): within 1e-7 of each leaf's largest value, or one ulp of it (the
    cosine of lr, module docstring); the moments bitwise.  Clipping on
    (clip_norm 1.0, the norms 3.7-7.5; float32 moments): the global
    norm's float32 sum over the leaves runs in another order (the
    reference sums its stacked leaves), one ulp of the norm moves the clip
    scale and with it the scaled gradient by an ulp: within 8 ulps of each
    leaf's largest value.  (With bf16 moments such an ulp may round a
    moment to the next bf16 value, and the next step's update moves by a
    bf16 ulp of it, so that case is held with clipping off.)"""
    opt = dict(peak_lr=1e-2, warmup_steps=1, total_steps=10,
               moment_dtype=moment_dtype,
               clip_norm=1e3 if clip == "off" else 1.0)
    _, _, ref_flat, _ = reference_grads(arch, "float32")
    ref_params = jax.tree.map(jnp.asarray, reference_params(arch))
    rgrads = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(ref_params),
        [jnp.asarray(ref_flat["/".join(str(getattr(k, "key", k))
                                       for k in path)])
         for path, _ in jax.tree_util.tree_flatten_with_path(ref_params)[0]])
    rcfg_opt, cfg_opt = ref_adamw.AdamWConfig(**opt), adamw.AdamWConfig(**opt)
    rstate = ref_adamw.init(rcfg_opt, ref_params)
    _, model = port_model(arch)
    state = adamw.init(cfg_opt, model)
    grads = _port_grads_list(model, ref_flat)
    rupdate = jax.jit(functools.partial(ref_adamw.update, rcfg_opt))
    for scale in (1.0, 2.0):
        ref_params, rstate, rm = rupdate(
            jax.tree.map(lambda g: g * scale, rgrads), rstate, ref_params)
        _, state, m = adamw.update(cfg_opt, [g * scale for g in grads],
                                   state, model)
        assert float(m["grad_norm"]) == pytest.approx(float(rm["grad_norm"]),
                                                      rel=1e-6)
        assert float(m["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-7)
        assert (float(rm["grad_norm"]) > opt["clip_norm"]) == (clip == "on")
    assert int(state["step"]) == int(rstate["step"]) == 2
    assert state["step"].dtype == torch.int32
    rp, rmom, rvel = _flat(ref_params), _flat(rstate["m"]), _flat(rstate["v"])
    for (name, p), mm, vv in zip(named_leaves(model), state["m"],
                                 state["v"]):
        assert mm.dtype == vv.dtype == getattr(torch, moment_dtype)
        path, _ = reference_path(name)
        for got, flat, moment in ((p, rp, False), (mm, rmom, True),
                                  (vv, rvel, True)):
            scale = max(float(np.abs(flat[path]).max()), 1e-30)
            err = np.abs(got.detach().float().numpy()
                         - reference_leaf(flat, name)).max()
            if clip == "off":
                tol = 0.0 if moment else max(TOL_ADAM * scale,
                                             _ulp(scale))
            else:
                tol = 8 * _ulp(scale)
            assert err <= tol, (name, moment, err / scale)


def test_schedule_and_global_norm_match_the_reference():
    cfg = dict(peak_lr=1.0, warmup_steps=10, total_steps=100,
               min_lr_ratio=0.1)
    rc, pc = ref_adamw.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
    for s in range(0, 120, 3):
        want = float(ref_adamw.schedule(rc, s))
        got = float(adamw.schedule(pc, torch.tensor(s, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=1e-7, abs=1e-9), s
    rng = np.random.default_rng(5)
    tree = {"a": rng.standard_normal((7, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal(3).astype(np.float32)}}
    want = float(ref_adamw.global_norm(jax.tree.map(jnp.asarray, tree)))
    got = float(adamw.global_norm(jax.tree.map(torch.from_numpy, tree)))
    assert got == pytest.approx(want, rel=1e-7)


def _captured_step(cfg, model, batch, monkeypatch):
    """One make_train_step call; returns the gradients it hands AdamW."""
    seen = {}
    real = adamw.update

    def spy(opt_cfg, grads, state, params):
        seen["grads"] = [g.clone() for g in grads]
        return real(opt_cfg, grads, state, params)
    monkeypatch.setattr(steps.adamw, "update", spy)
    opt = adamw.AdamWConfig(total_steps=10)
    _, _, metrics = steps.make_train_step(cfg, opt, device="cpu")(
        model, adamw.init(opt, model), **batch)
    return seen["grads"], metrics


def test_grad_accum_two_matches_one_batch(monkeypatch):
    """Two micro-batches of one row, no pads: the mean of their gradients
    is the one-batch gradient (equal token counts)."""
    arch = "llama3.2-3b"
    cfg, model = port_model(arch)
    batch = make_batch(cfg)
    one, m1 = _captured_step(cfg, model, batch, monkeypatch)
    cfg2, model2 = port_model(arch, grad_accum=2)
    two, m2 = _captured_step(cfg2, model2, batch, monkeypatch)
    for a, b in zip(one, two):
        scale = max(float(a.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= TOL_F32 * scale
    # the metrics are the last micro-batch's, as the reference's scan's
    with torch.no_grad():
        last, _ = steps.loss_fn(cfg, port_model(arch)[1], steps.as_batch(
            {k: v[1:] for k, v in batch.items()}, "cpu"))
    assert float(m2["loss"]) == pytest.approx(float(last), rel=1e-6)
    assert set(m1) == {"loss", "xent", "aux", "grad_norm", "lr"}


@pytest.mark.parametrize("arch", ["llama3.2-3b", "hymba-1.5b",
                                  "seamless-m4t-medium"])
def test_remat_block_matches_none(arch):
    """Recomputing each layer, attention chunk, SSM chunk and loss chunk
    in the backward pass gives the gradients of storing them: bitwise
    (one intra-op thread: several may reduce in another order from one
    call to the next)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, block, _ = port_grads(arch, remat="block")
        _, none, _ = port_grads(arch, remat="none")
    finally:
        torch.set_num_threads(threads)
    for name in block:
        assert torch.equal(block[name], none[name]), name


def test_train_step_runs_and_needs_a_card_by_default():
    cfg, model = port_model("llama3.2-3b")
    opt = adamw.AdamWConfig(total_steps=10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        steps.make_train_step(cfg, opt)
    step = steps.make_train_step(cfg, opt, device="cpu")
    before = [p.detach().clone() for p in model.parameters()]
    state = adamw.init(opt, model)
    batch = make_batch(cfg)
    _, state, m1 = step(model, state, **batch)
    _, state, m2 = step(model, state, **batch)
    assert np.isfinite(float(m1["loss"])) and np.isfinite(
        float(m1["grad_norm"]))
    assert float(m2["loss"]) < float(m1["loss"]) * 1.05
    assert all(not torch.equal(a, p) for a, p in
               zip(before, model.parameters()) if a.ndim >= 1)
    assert int(state["step"]) == 2


def test_flash_refuses_inputs_that_require_grad():
    from repro_torch.kernels import ops
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 2, 16, 8, generator=g, requires_grad=True)
    k = torch.randn(1, 2, 16, 8, generator=g)
    v = torch.randn(1, 2, 16, 8, generator=g)
    with pytest.raises(ValueError, match="no backward"):
        ops.flash_mha(q, k, v, blk=16)
    with torch.no_grad():
        assert ops.flash_mha(q, k, v, blk=16).shape == q.shape
    assert L.records_grad(q, k) and not L.records_grad(k, v)
