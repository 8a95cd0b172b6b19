"""Port parity of the LM layers: repro_torch.models.{layers, ssm} against
repro.models.{layers, ssm}, each function on the same numpy inputs (seeded)
and the same parameters (the reference's init, carried over as numpy, with
the zero biases and unit norms replaced by random values so that every
term counts).

Tolerance: float32 throughout, each result within 1e-5 of the reference's
largest |value| (TOL): the two packages add the same float32 terms in other
orders (einsum contractions, the SSM scan's tree), a few ulps of the
largest term.  On the CPU the port's prefill attention runs the reference's
plain route; the card's flash route is held against it in
tests/test_torch_kernels_gpu.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as RL
from repro.models import ssm as RS
from repro.models.config import ModelConfig as RefConfig
from repro_torch.models import layers as PL
from repro_torch.models import ssm as PS
from repro_torch.models.config import ModelConfig

TOL = 1e-5


def _cfgs(**kw):
    """The reference's config and the port's, from the same fields."""
    base = dict(arch="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                head_dim=8, d_ff=64, vocab=64, dtype="float32")
    base.update(kw)
    ref = RefConfig(**base)
    return ref, ModelConfig(**dataclasses.asdict(ref))


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(want, got, tol=TOL):
    want = _np(want)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"max |port - reference| = {err:.3e} of max |ref|"


def _params(tree, seed):
    """(reference params, port params) from the reference's init tree:
    biases and norm weights drawn at random, everything float32."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in tree.items():
        a = np.asarray(v, np.float32)
        if k in ("bq", "bk", "bv", "q_norm", "k_norm", "conv_b", "D"):
            a = (rng.standard_normal(a.shape) * 0.5 + (k in (
                "q_norm", "k_norm", "D"))).astype(np.float32)
        out[k] = a
    return ({k: jnp.asarray(a) for k, a in out.items()},
            {k: torch.from_numpy(a.copy()) for k, a in out.items()})


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_rms_norm():
    x, w = _x((2, 5, 16), 0), _x((16,), 1)
    want = RL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    _close(want, PL.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5))


@pytest.mark.parametrize("mode", ["standard", "half", "mrope", "none"])
def test_apply_rope(mode):
    rc, pc = _cfgs(rope=mode, rope_theta=500_000.0, head_dim=16,
                   mrope_sections=(2, 3, 3))
    x = _x((2, 9, 3, 16), 2)
    rng = np.random.default_rng(3)
    shape = (2, 3, 9) if mode == "mrope" else (2, 9)
    pos = rng.integers(0, 5_000, shape).astype(np.int32)
    want = RL.apply_rope(rc, jnp.asarray(x), jnp.asarray(pos))
    _close(want, PL.apply_rope(pc, torch.from_numpy(x),
                               torch.from_numpy(pos)))


@pytest.mark.parametrize("h,hkv,hd,window,causal,valid", [
    (4, 2, 8, 0, True, False),
    (4, 2, 8, 3, True, True),      # GQA, a window and dead slots
    (6, 1, 8, 0, False, True),     # MQA, no causal mask
    (25, 5, 64, 32, True, False),  # hymba FULL's head grouping
])
def test_sdpa(h, hkv, hd, window, causal, valid):
    rc, pc = _cfgs(n_heads=h, n_kv_heads=hkv, head_dim=hd)
    b, sq, sk = 2, 7, 40
    q, k, v = _x((b, sq, h, hd), 4), _x((b, sk, hkv, hd), 5), \
        _x((b, sk, hkv, hd), 6)
    rng = np.random.default_rng(7)
    q_pos = rng.integers(10, 40, (b, sq)).astype(np.int32)
    k_pos = np.broadcast_to(np.arange(sk, dtype=np.int32), (b, sk)).copy()
    k_valid = rng.random((b, sk)) < 0.8 if valid else None
    want = RL.sdpa(rc, *map(jnp.asarray, (q, k, v)), q_pos=jnp.asarray(q_pos),
                   k_pos=jnp.asarray(k_pos), window=window, causal=causal,
                   k_valid=None if k_valid is None else jnp.asarray(k_valid))
    got = PL.sdpa(pc, *map(torch.from_numpy, (q, k, v)),
                  q_pos=torch.from_numpy(q_pos),
                  k_pos=torch.from_numpy(k_pos), window=window,
                  causal=causal,
                  k_valid=None if k_valid is None else
                  torch.from_numpy(k_valid))
    _close(want, got)


@pytest.mark.parametrize("window", [None, 32, 64])
def test_flash_route_groups_heads_as_sdpa(window):
    """The card's route (q, k, v transposed to (B, H, S, hd) for
    ops.flash_mha, KV head h // (H / Hkv), q scaled before the dot), run on
    the CPU through the wrapper's plain version, against the reference's
    sdpa at hymba FULL's head grouping (H = 25, Hkv = 5, hd = 64)."""
    rc, pc = _cfgs(n_heads=25, n_kv_heads=5, head_dim=64, d_model=1600)
    b, s = 1, 96
    q, k, v = _x((b, s, 25, 64), 8), _x((b, s, 5, 64), 9), \
        _x((b, s, 5, 64), 10)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    want = RL.sdpa(rc, *map(jnp.asarray, (q, k, v)), q_pos=jnp.asarray(pos),
                   k_pos=jnp.asarray(pos), window=window or 0, causal=True)
    got = PL._flash_route(pc, *map(torch.from_numpy, (q, k, v)),
                          window or 0)
    _close(want, got)


ATTN_CASES = {  # name: (config fields, S, layer window)
    "unchunked": (dict(), 24, 0),
    "unchunked-window": (dict(window=8, global_layers=(0,)), 24, 8),
    "chunked": (dict(attn_chunk=8), 32, 0),
    "chunked-window": (dict(attn_chunk=8, window=8, global_layers=(0,)), 32,
                       8),
    "band": (dict(attn_chunk=8, window=8), 40, 8),
    "causal_sliced": (dict(attn_chunk=8, attn_impl="causal_sliced"), 32, 0),
    "bias-half-rope": (dict(attn_bias=True, rope="half"), 24, 0),
    "qk-norm-chunked": (dict(qk_norm=True, attn_chunk=8), 32, 0),
}


@functools.lru_cache(maxsize=None)
def _attention_case(name):
    """The inputs of a case and the reference's outputs, computed once for
    both of its tests."""
    fields, s, window = ATTN_CASES[name]
    rc, pc = _cfgs(**fields)
    rp, pp = _params(RL.init_attention(jax.random.PRNGKey(1), rc), 11)
    x = _x((2, s, rc.d_model), 12)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s)).copy()
    want = jax.jit(lambda x_, p_: RL.attention_apply(rc, rp, x_, p_, window))(
        jnp.asarray(x), jnp.asarray(pos))
    return pc, pp, x, pos, window, want


@pytest.mark.parametrize("name", sorted(ATTN_CASES))
@pytest.mark.parametrize("explicit", [False, True])
def test_attention_apply(name, explicit):
    pc, pp, x, pos, window, (want, (wk, wv)) = _attention_case(name)
    got, (gk, gv) = PL.attention_apply(
        pc, pp, torch.from_numpy(x),
        torch.from_numpy(pos) if explicit else None, window)
    _close(want, got)
    _close(wk, gk)
    _close(wv, gv)


@pytest.mark.parametrize("window,cap", [(0, 16), (6, 6)])
def test_attention_decode_across_a_ring_wrap(window, cap):
    """13 decode steps from an empty cache: the SWA ring of 6 slots wraps
    twice; outputs and caches after every step."""
    rc, pc = _cfgs(window=window, attn_bias=True, rope="standard")
    rp, pp = _params(RL.init_attention(jax.random.PRNGKey(2), rc), 13)
    b = 2
    shape = (b, rc.n_kv_heads, cap, rc.hd)
    rk = rv = jnp.zeros(shape, jnp.float32)
    pk, pv = torch.zeros(shape), torch.zeros(shape)
    step = jax.jit(lambda x, kc, vc, t: RL.attention_decode(
        rc, rp, x, None, window, kc, vc, t))
    for t in range(13):
        x = _x((b, 1, rc.d_model), 100 + t)
        want, rk, rv = step(jnp.asarray(x), rk, rv, jnp.int32(t))
        got, pk, pv = PL.attention_decode(pc, pp, torch.from_numpy(x), None,
                                          window, pk, pv, t)
        _close(want, got)
        _close(rk, pk)
        _close(rv, pv)


@pytest.mark.parametrize("activation", ["swiglu", "squared_relu", "gelu"])
def test_mlp_apply(activation):
    rc, pc = _cfgs(activation=activation)
    rp, pp = _params(RL.init_mlp(jax.random.PRNGKey(3), rc), 14)
    x = _x((2, 5, rc.d_model), 15)
    _close(RL.mlp_apply(rc, rp, jnp.asarray(x)),
           PL.mlp_apply(pc, pp, torch.from_numpy(x)))


def _ssm_cfgs():
    return _cfgs(family="ssm", n_heads=0, n_kv_heads=1, d_ff=0,
                 ssm_state=8, ssm_chunk=8)


@pytest.mark.parametrize("s", [32, 20, 8, 3])
def test_ssm_apply_chunked_and_ragged(s):
    """S = 32: four chunks of 8; S = 20: ragged, one chunk; S = 8: one chunk;
    S = 3: shorter than the conv's tail."""
    rc, pc = _ssm_cfgs()
    rp, pp = _params(RS.init_ssm(jax.random.PRNGKey(4), rc), 16)
    x = _x((2, s, rc.d_model), 17)
    h0 = np.abs(_x((2, rc.d_inner, rc.ssm_state), 18))
    want, (wh, wt) = jax.jit(lambda x_, h_: RS.ssm_apply(rc, rp, x_, h_))(
        jnp.asarray(x), jnp.asarray(h0))
    got, (gh, gt) = PS.ssm_apply(pc, pp, torch.from_numpy(x),
                                 torch.from_numpy(h0))
    _close(want, got)
    _close(wh, gh)
    _close(wt, gt)


def test_ssm_decode_continues_the_scan():
    rc, pc = _ssm_cfgs()
    rp, pp = _params(RS.init_ssm(jax.random.PRNGKey(5), rc), 19)
    x = _x((2, 16, rc.d_model), 20)
    _, (rh, rconv) = jax.jit(lambda x_: RS.ssm_apply(rc, rp, x_))(
        jnp.asarray(x))
    _, (ph, pconv) = PS.ssm_apply(pc, pp, torch.from_numpy(x))
    step = jax.jit(lambda x_, h_, c_: RS.ssm_decode(rc, rp, x_, h_, c_))
    for t in range(5):
        xt = _x((2, 1, rc.d_model), 30 + t)
        want, rh, rconv = step(jnp.asarray(xt), rh, rconv)
        got, ph, pconv = PS.ssm_decode(pc, pp, torch.from_numpy(xt), ph,
                                       pconv)
        _close(want, got)
        _close(rh, ph)
        _close(rconv, pconv)


def test_doubling_scan_is_the_sequential_recurrence():
    """The Hillis-Steele scan against the token-by-token recurrence
    h_t = a_t h_{t-1} + b_t, in float64."""
    rng = np.random.default_rng(21)
    a = torch.from_numpy(rng.random((2, 13, 3)))
    b = torch.from_numpy(rng.standard_normal((2, 13, 3)))
    a_cum, b_cum = PS._doubling_scan(a, b)
    h = torch.zeros(2, 3, dtype=torch.float64)
    p = torch.ones(2, 3, dtype=torch.float64)
    for t in range(13):
        h = a[:, t] * h + b[:, t]
        p = a[:, t] * p
        torch.testing.assert_close(b_cum[:, t], h, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(a_cum[:, t], p, rtol=1e-12, atol=1e-12)
