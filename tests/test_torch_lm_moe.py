"""The MoE slice on the CPU: the port's sort-based capacity routing
(``models/layers.py`` ``moe_route`` / ``moe_apply``) against the
reference's ``moe_apply`` on the same numpy inputs and parameters, for both
``moe_impl`` values and capacity factors that drop most assignments (0.1),
some (1.25, the configs' own) and none (8.0); a router tied exactly at the
k-th place; the SMOKE configs of qwen3-moe-30b-a3b and mixtral-8x22b end to
end through the reference's jitted steps (tests/_lm_parity.py, which states
the tolerances) in float32; in bf16 every MoE call of that run on the
reference's own inputs, the prefill's logits and caches before the first
token whose routing differs, each decode step from the reference's cache,
and the routing's differences held to what the inputs' roundings allow;
and decode against a full forward where nothing drops.

Tolerances: routing (each assignment's buffer row ``dest``, ``keep``, the
chosen experts) equal; float32 outputs within 1e-5 of the reference's
largest |value| (the same float32 products summed in other orders); bf16
outputs within 2e-2 of it (the reference's own 2e-2, taken relative: the
MoE outputs are ~1e-2, so an absolute 2e-2 would pass a zero output); the
aux loss within 1e-6 (a mean of float32 probabilities times exact
counts)."""

import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_parity import (BATCH, PROMPT, STEPS, check_decode, check_prefill,
                        reference_routing, reference_run)
from _lm_parity import configs as lm_configs
from repro.configs import get_config as ref_get_config
from repro.models import layers as RL
from repro.models import steps as ref_steps
from repro.models.registry import build_model as ref_build_model
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import layers as L
from repro_torch.models import steps, transformer
from repro_torch.models.registry import build_model

ARCHS = ["qwen3-moe-30b-a3b", "mixtral-8x22b"]
IMPLS = ["global_sort", "per_example"]
TOL_F32, TOL_BF16, TOL_AUX = 1e-5, 2e-2, 1e-6


def _configs(arch, **kw):
    return (dataclasses.replace(ref_get_config(arch, smoke=True), **kw),
            dataclasses.replace(get_config(arch, smoke=True), **kw))


def _moe_inputs(rcfg, seed=0, shape=(3, 20)):
    p = jax.tree.map(np.array, RL.init_moe(jax.random.PRNGKey(seed), rcfg))
    x = np.random.default_rng(seed).standard_normal(
        shape + (rcfg.d_model,)).astype(np.float32)
    return p, x


def _port_routing(cfg, p, x):
    b, s, d = x.shape
    xt = torch.from_numpy(x)
    if cfg.moe_impl == "per_example":
        groups, cap = xt, L.moe_capacity(cfg, s)
    else:
        groups, cap = xt.reshape(1, b * s, d), L.moe_capacity(cfg, b * s)
    return L.moe_route(cfg, torch.from_numpy(p["router"]), groups, cap)


def _assert_same_routing(rcfg, cfg, p, x):
    want_dest, want_keep, want_top = reference_routing(rcfg, p, x)
    dest, _, _, keep, _, flat_e = _port_routing(cfg, p, x)
    np.testing.assert_array_equal(flat_e.numpy(),
                                  want_top.reshape(flat_e.shape))
    np.testing.assert_array_equal(dest.numpy(), want_dest)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    return keep.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [0.1, 1.25, 8.0])
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch, impl, cf, dtype):
    rcfg, cfg = _configs(arch, moe_impl=impl, capacity_factor=cf,
                         dtype=dtype)
    p, x = _moe_inputs(rcfg)
    if dtype == "bfloat16":   # both sides see the same bf16 inputs
        x = np.array(jnp.asarray(x).astype(jnp.bfloat16)
                       .astype(jnp.float32))
    keep = _assert_same_routing(rcfg, cfg, p, x)
    if cf == 8.0:
        assert keep.all()
    elif cf == 0.1:
        assert keep.mean() < 0.5
    want, want_aux = RL.moe_apply(
        rcfg, p, jnp.asarray(x).astype(rcfg.activation_dtype()))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got, aux = L.moe_apply(
        cfg, tp, torch.from_numpy(x).to(cfg.activation_dtype()))
    assert got.dtype == cfg.activation_dtype() and got.shape == x.shape
    want = np.asarray(want.astype(jnp.float32))
    err = np.abs(got.float().numpy() - want).max()
    assert err <= (TOL_F32 if dtype == "float32" else TOL_BF16) \
        * np.abs(want).max(), err
    assert abs(float(aux) - float(want_aux)) <= TOL_AUX
    assert aux.dtype == torch.float32


@pytest.mark.parametrize("impl", IMPLS)
def test_a_tie_at_the_kth_place_takes_the_lower_expert(impl):
    """Router columns 1, 3, 5 and 6 are equal and the rest lower: top-2
    must pick experts 1 and 3 for every token, as jax.lax.top_k does.
    Inputs and weights are small multiples of powers of two, so every
    logit is exact whatever the summation order, and the tie is exact."""
    rcfg, cfg = _configs("qwen3-moe-30b-a3b", moe_impl=impl)
    p, _ = _moe_inputs(rcfg)
    d, e = p["router"].shape
    rng = np.random.default_rng(5)
    router = np.zeros((d, e), np.float32)
    col = rng.integers(1, 4, d).astype(np.float32) / 4
    for j in range(e):
        router[:, j] = col - (0 if j in (1, 3, 5, 6) else 0.25 * (j + 1))
    p = dict(p, router=router)
    x = rng.integers(1, 3, (2, 6, d)).astype(np.float32)
    keep = _assert_same_routing(rcfg, cfg, p, x)
    _, _, _, _, probs, flat_e = _port_routing(cfg, p, x)
    assert (probs[..., 1] == probs[..., 6]).all()
    assert (probs[..., 1] > probs[..., 0]).all()
    assert set(flat_e.unique().tolist()) == {1, 3}
    assert not keep.all()   # 12 tokens for 2 experts of few slots
    want, _ = RL.moe_apply(rcfg, p, jnp.asarray(x))
    got, _ = L.moe_apply(cfg, {k: torch.from_numpy(v) for k, v in
                               p.items()}, torch.from_numpy(x))
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= TOL_F32 * np.abs(want).max()


def test_route_sorts_assignments_by_expert_into_capacity_slots():
    """dest lists the kept assignments expert by expert, in token order
    within an expert, at rows expert * cap + rank; the dropped ones at the
    scratch row; the weights of a token sum to 1."""
    _, cfg = _configs("mixtral-8x22b")
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((1, 16, cfg.d_model))
                         .astype(np.float32))
    router = torch.from_numpy(rng.standard_normal(
        (cfg.d_model, cfg.n_experts)).astype(np.float32))
    e, k, cap = cfg.n_experts, cfg.top_k, 5
    dest, st, sw, keep, probs, flat_e = L.moe_route(cfg, router, x, cap)
    assert dest.shape == st.shape == sw.shape == keep.shape == (1, 16 * k)
    assert probs.shape == (1, 16, e) and flat_e.shape == (1, 16 * k)
    for j in range(e):
        toks = [int(t) for t, fe in zip(
            torch.arange(16).repeat_interleave(k), flat_e[0]) if fe == j]
        rows = [(int(dd), int(t)) for dd, t, kk in zip(dest[0], st[0],
                                                       keep[0]) if kk
                and j * cap <= dd < (j + 1) * cap]
        assert rows == [(j * cap + r, t) for r, t in
                        enumerate(toks[:cap])]
    assert (dest[~keep] == e * cap).all()
    sums = torch.zeros(16).index_add_(0, st[0], sw[0])
    torch.testing.assert_close(sums, torch.ones(16))


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_params_from_reference_carries_the_experts(arch):
    rcfg, cfg = _configs(arch)
    params = jax.tree.map(np.asarray, ref_build_model(rcfg).init(
        jax.random.PRNGKey(0)))
    model = lm_params_from_reference(cfg, params, device="cpu")
    for name in ("router", "w1", "w2", "w3"):
        want = params["blocks"]["moe"][name]
        assert want.shape[:2] == (cfg.n_layers,) + (
            (cfg.d_model,) if name == "router" else (cfg.n_experts,))
        for i in range(cfg.n_layers):
            assert torch.equal(model.blocks[i].moe[name],
                               torch.from_numpy(want[i]))
    assert not hasattr(model.blocks[0], "mlp")
    assert sum(p.numel() for p in model.parameters()) == \
        cfg.param_count() == ref_build_model(rcfg).param_count()
    missing = dict(params, blocks=dict(params["blocks"]))
    missing["blocks"]["moe"] = {k: v for k, v in params["blocks"]["moe"]
                                .items() if k != "w3"}
    with pytest.raises(ValueError, match="lack blocks/moe/w3"):
        lm_params_from_reference(cfg, missing, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_caches(arch):
    check_prefill(arch, None)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_decode_steps(arch):
    check_decode(arch, None)


@functools.lru_cache(maxsize=None)
def _bf16_runs(arch):
    """The parity prompt (tests/_lm_parity.py) in bf16.  The reference's
    jitted prefill and STEPS greedy decode steps, recording each MoE
    layer's input and output; the port's prefill, then each decode step
    from the reference's cache of the step before, fed the reference's
    token, recording each MoE layer's input and routing.  Returns (params,
    reference steps, port steps), a step (the prefill first) holding its
    logits and caches as float32 numpy and its MoE calls."""
    rcfg, cfg = lm_configs(arch, "bfloat16")
    params, batch, _ = reference_run(arch, "bfloat16")
    toks = batch["tokens"]
    ref_moe, calls, ref = RL.moe_apply, [], []

    def ref_spy(c, p, x):
        out, aux = ref_moe(c, p, x)
        jax.debug.callback(
            lambda a, b: calls.append((np.asarray(a), np.asarray(b))),
            x.astype(jnp.float32), out.astype(jnp.float32), ordered=True)
        return out, aux

    with mock.patch.object(RL, "moe_apply", ref_spy):
        prefill = jax.jit(ref_steps.make_prefill_step(
            rcfg, cache_capacity=PROMPT + STEPS))
        decode = jax.jit(ref_steps.make_decode_step(rcfg))
        logits, cache = prefill(params, tokens=jnp.asarray(toks))
        for t in range(STEPS + 1):
            jax.effects_barrier()
            tok = np.asarray(jnp.argmax(logits[:, -1], -1)[:, None],
                             np.int32)
            ref.append({"logits": _f32(logits), "next": tok,
                        "cache": [{n: _f32(v) for n, v in c.items()}
                                  for c in cache], "moe": calls[:]})
            calls.clear()
            if t < STEPS:
                logits, cache = decode(params, token=jnp.asarray(tok),
                                       cache=cache,
                                       cache_index=jnp.int32(PROMPT + t))
    route, routed, port = L.moe_route, [], []

    def port_spy(c, router, x, cap):
        out = route(c, router, x, cap)
        routed.append((x.float().numpy().copy(), out))
        return out

    model = lm_params_from_reference(cfg, params, device="cpu")
    with mock.patch.object(L, "moe_route", port_spy):
        logits, cache = steps.make_prefill_step(
            cfg, cache_capacity=PROMPT + STEPS)(
                model, tokens=torch.from_numpy(toks).long())
        dtypes = [{n: v.dtype for n, v in c.items()} for c in cache]
        decode = steps.make_decode_step(cfg)
        for t in range(STEPS + 1):
            port.append({"logits": logits.float().numpy(),
                         "cache": [{n: v.float().numpy().copy()
                                    for n, v in c.items()} for c in cache],
                         "moe": routed[:]})
            routed.clear()
            if t < STEPS:
                start = [{n: torch.from_numpy(v).to(dt[n])
                          for n, v in c.items()}
                         for c, dt in zip(ref[t]["cache"], dtypes)]
                logits, cache = decode(
                    model, token=torch.from_numpy(ref[t]["next"]).long(),
                    cache=start, cache_index=PROMPT + t)
    return params, ref, port


def _f32(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _layer_params(params, i):
    return {n: v[i] for n, v in params["blocks"]["moe"].items()}


def _first_flip(rcfg, params, ref_step, port_step):
    """The first token, in the routing group's row-major order, whose
    chosen experts differ between the reference's routing of its own input
    and the port's of its own, over a step's MoE layers (the step's token
    count if none).  An assignment's slot is its rank among the earlier
    assignments to its expert, so before that token the kept assignments
    agree too."""
    k, first = rcfg.top_k, None
    for i, ((x_ref, _), (_, got)) in enumerate(zip(ref_step["moe"],
                                                   port_step["moe"])):
        top = reference_routing(rcfg, _layer_params(params, i), x_ref)[2]
        top = top.reshape(-1, k)
        flips = np.flatnonzero((got[5].numpy().reshape(-1, k) != top)
                               .any(-1))
        here = int(flips[0]) if flips.size else top.shape[0]
        first = here if first is None else min(first, here)
    return first


def _held(want, got, what):
    """got within TOL_BF16 of the reference's largest |value| (want)."""
    err = float(np.abs(got - want).max(initial=0))
    bound = TOL_BF16 * float(np.abs(want).max(initial=0))
    assert err <= bound, f"{what}: max |port - reference| {err:.3e} > " \
        f"{bound:.3e}"


def _slot_positions(cap, s):
    """The position each of a cache's `cap` slots holds after `s` tokens
    (ring or full: the last p < s with p % cap == slot), -1 if none."""
    slots = np.arange(cap)
    return np.where(slots < s, slots + (s - 1 - slots) // cap * cap, -1)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_moe_layers_match_on_the_reference_inputs(arch):
    """Each MoE call of the bf16 parity run (the prefill's layers and every
    decode step's), the port's moe_apply on the reference's own input:
    the same routing, and the output within 2e-2 of the reference's
    largest |value| (bf16 carries 8 bits: a few ulps at the largest value,
    and a combine that lost or scaled a contribution would be off by about
    that value)."""
    rcfg, cfg = lm_configs(arch, "bfloat16")
    params, ref, _ = _bf16_runs(arch)
    n = 0
    for t, step in enumerate(ref):
        for i, (x, want) in enumerate(step["moe"]):
            p = _layer_params(params, i)
            _assert_same_routing(rcfg, cfg, p, x)
            got, _ = L.moe_apply(cfg, {k: torch.from_numpy(v) for k, v in
                                       p.items()},
                                 torch.from_numpy(x).to(torch.bfloat16))
            _held(want, got.float().numpy(), f"step {t} layer {i}")
            n += 1
    assert n == (STEPS + 1) * cfg.n_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_prefill_where_the_routing_agrees(arch):
    """bf16 prefill logits and caches within 2e-2 of the reference's
    largest |value| at every position before the first token whose experts
    differ between the two sides in some layer (a token whose inputs
    differ by a rounding picks another expert when its k-th and (k+1)-th
    logits lie that close: test_bf16_routing_differs_only_where_the_inputs
    _allow; from there on the rows' values part by far more than any
    tolerance).  Causal attention and routing groups in row-major order
    keep the earlier positions apart from it."""
    rcfg, cfg = lm_configs(arch, "bfloat16")
    params, ref, port = _bf16_runs(arch)
    first = _first_flip(rcfg, params, ref[0], port[0])
    assert first >= PROMPT // 4          # the check holds something
    upto = np.clip(first - PROMPT * np.arange(BATCH), 0, PROMPT)
    for b in range(BATCH):
        _held(ref[0]["logits"][b, :upto[b]], port[0]["logits"][b, :upto[b]],
              f"prefill logits row {b}")
    for r, (rc, pc) in enumerate(zip(ref[0]["cache"], port[0]["cache"])):
        for name in rc:     # (layers, B, Hkv, cap, hd)
            pos = _slot_positions(rc[name].shape[3], PROMPT)
            for b in range(BATCH):
                held = (pos >= 0) & (pos < upto[b])
                _held(rc[name][:, b][:, :, held], pc[name][:, b][:, :, held],
                      f"prefill cache run {r} {name} row {b}")


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_decode_steps_from_the_reference_caches(arch):
    """Each bf16 decode step run from the reference's cache of the step
    before on the reference's token: the rows before the step's first
    token whose experts differ in some layer (row-major, as in the
    prefill) give logits and caches within 2e-2 of the reference's largest
    |value|; at most one step has a row that cannot be held."""
    rcfg, cfg = lm_configs(arch, "bfloat16")
    params, ref, port = _bf16_runs(arch)
    held = []
    for t in range(1, STEPS + 1):
        rows = _first_flip(rcfg, params, ref[t], port[t])
        held.append(rows)
        _held(ref[t]["logits"][:rows], port[t]["logits"][:rows],
              f"decode step {t} logits")
        for r, (rc, pc) in enumerate(zip(ref[t]["cache"], port[t]["cache"])):
            for name in rc:
                _held(rc[name][:, :rows], pc[name][:, :rows],
                      f"decode step {t} cache run {r} {name}")
    assert sum(h < BATCH for h in held) <= 1, held


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_routing_differs_only_where_the_inputs_allow(arch):
    """bf16 end to end.  The attention before each MoE layer rounds to
    bf16 on both sides, so a layer's MoE inputs differ by an ulp here and
    there, and a token whose k-th and (k+1)-th router logits lie closer
    than that can pick another expert (on equal inputs the routing is the
    same: test_bf16_moe_layers_match_on_the_reference_inputs).  Over the
    bf16 parity prefill every layer's routing on each side's own inputs
    may differ from the other only for pairs of experts (i chosen by the
    reference, j by the port) whose reference logits differ by at most
    what the input difference can move them: l[i] - l[j] <= |dx| @
    |router| at i plus at j."""
    rcfg, cfg = lm_configs(arch, "bfloat16")
    params, ref, port = _bf16_runs(arch)
    k = cfg.top_k
    assert len(ref[0]["moe"]) == len(port[0]["moe"]) == cfg.n_layers
    for i, ((a, _), (b, _)) in enumerate(zip(ref[0]["moe"],
                                             port[0]["moe"])):
        router = params["blocks"]["moe"]["router"][i]
        a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
        la, lb = a @ router, b @ router
        moved = np.abs(a - b) @ np.abs(router) + 1e-6
        ta = np.argsort(-la, axis=-1, kind="stable")[:, :k]
        tb = np.argsort(-lb, axis=-1, kind="stable")[:, :k]
        for t in range(a.shape[0]):
            only_a = set(ta[t]) - set(tb[t])
            only_b = set(tb[t]) - set(ta[t])
            for ei in only_a:
                for ej in only_b:
                    assert la[t, ei] - la[t, ej] <= moved[t, ei] + \
                        moved[t, ej], (i, t, ei, ej)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_a_full_forward_when_nothing_drops(arch, impl,
                                                          monkeypatch):
    """At capacity_factor = E / k every expert has a slot for every token
    of its group (cap = B*S, or S a row), so nothing drops in the prefill
    or in decode, and a prefill of S - 1 tokens then one decode step gives
    the full forward's last logits (float32, within 1e-5 of the largest
    |logit|).  At the config's own factor decode's groups are B tokens (or
    one), whose capacity is a slot an expert: the reference drops there,
    and so does the port."""
    _, base = _configs(arch, moe_impl=impl)
    cfg = dataclasses.replace(base, capacity_factor=base.n_experts
                              / base.top_k)
    kept = []
    route = L.moe_route

    def spy(*args):
        out = route(*args)
        kept.append(out[3])
        return out

    monkeypatch.setattr(L, "moe_route", spy)
    # drawn under the config's own factor: the steps follow their cfg
    params = build_model(base).init(torch.Generator().manual_seed(0),
                                    device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (3, 24)))
    full, _ = steps.make_prefill_step(cfg)(params, tokens=toks)
    _, cache = steps.make_prefill_step(cfg, cache_capacity=24)(
        params, tokens=toks[:, :-1])
    step, _ = steps.make_decode_step(cfg)(params, token=toks[:, -1:],
                                          cache=cache, cache_index=23)
    assert len(kept) == 3 * cfg.n_layers and all(k.all() for k in kept)
    scale = float(full.abs().max())
    assert float((step - full).abs().max()) <= TOL_F32 * scale
    kept.clear()
    _, cache = steps.make_prefill_step(base, cache_capacity=24)(
        params, tokens=toks[:, :-1])
    transformer.decode(base, params, cache, toks[:, -1:], 23)
    assert L.moe_capacity(base, 3 if impl == "global_sort" else 1) == 1
    for keep in kept[cfg.n_layers:]:
        assert keep.numel() == 3 * cfg.top_k
        if impl == "per_example":   # a row's k experts differ: one slot each
            assert keep.all()
        else:                       # one slot an expert for 3k assignments
            assert int(keep.sum()) <= min(3 * cfg.top_k, cfg.n_experts)
