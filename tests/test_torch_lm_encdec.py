"""The encoder-decoder (seamless-m4t-medium) on the CPU: its modules
against the reference's (cross_kv, cross_attention_apply unchunked and
q-chunked, the encoder block and encode from frames or source ids), then
the port's prefill (source frames and target tokens) and greedy decode
against the reference's jitted steps on its SMOKE config
(tests/_lm_parity.py, which states the end-to-end tolerances).

Module tolerance: float32, each result within 1e-5 of the reference's
largest |value| (TOL), as tests/test_torch_lm_layers.py.  The decoder's
prefill self-attention takes the flash kernel on the card
(tests/test_torch_kernels_gpu.py); the encoder's and the cross-attention
run the reference's plain sdpa on both devices."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_parity import check_decode, check_prefill
from repro.models import encdec as RE
from repro.models import layers as RL
from repro.models.config import ModelConfig as RefConfig
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import encdec as PE
from repro_torch.models import layers as PL
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import build_model

ARCH = "seamless-m4t-medium"
TOL = 1e-5
CASES = [(None, None), (None, 16), ("bfloat16", None)]


def _cfgs(**kw):
    """The reference's encoder-decoder config and the port's, from the
    same fields."""
    base = dict(arch="t", family="audio", enc_dec=True, n_layers=2,
                n_enc_layers=3, d_model=32, n_heads=4, n_kv_heads=2,
                head_dim=8, d_ff=64, vocab=64, activation="gelu",
                embed_inputs=True, dtype="float32")
    base.update(kw)
    ref = RefConfig(**base)
    return ref, ModelConfig(**dataclasses.asdict(ref))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(want, got, tol=TOL):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)
    assert err <= tol, f"max |port - reference| = {err:.3e} of max |ref|"


def _attn_params(rc, seed, cross=True):
    """A reference attention layer's params with random norms (numpy), for
    both sides."""
    tree = RL.init_attention(jax.random.PRNGKey(seed), rc, cross=cross)
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in tree.items():
        a = np.asarray(v, np.float32)
        if k in ("q_norm", "k_norm", "bq", "bk", "bv"):
            a = (rng.standard_normal(a.shape) * 0.5 + 1).astype(np.float32)
        out[k] = a
    return ({k: jnp.asarray(a) for k, a in out.items()},
            {k: torch.from_numpy(a.copy()) for k, a in out.items()})


@pytest.mark.parametrize("cross", [False, True])
def test_init_attention_cross_has_no_biases(cross):
    rc, pc = _cfgs(attn_bias=True)
    want = RL.init_attention(jax.random.PRNGKey(0), rc, cross=cross)
    got = PL.init_attention(torch.Generator().manual_seed(0), pc, "cpu",
                            cross=cross)
    assert sorted(got) == sorted(want)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert ("bq" in got) == (not cross)


@pytest.mark.parametrize("qk_norm", [False, True])
def test_cross_kv(qk_norm):
    rc, pc = _cfgs(qk_norm=qk_norm)
    rp, pp = _attn_params(rc, 1)
    enc = _x((2, 20, rc.d_model), 2)
    wk, wv = RL.cross_kv(rc, rp, jnp.asarray(enc))
    gk, gv = PL.cross_kv(pc, pp, torch.from_numpy(enc))
    _close(wk, gk)
    _close(wv, gv)


CROSS_CASES = {   # name: (config fields, S_q, S_enc)
    "unchunked": (dict(), 24, 20),
    "chunked": (dict(attn_chunk=8), 32, 20),
    "chunked-qk-norm": (dict(attn_chunk=8, qk_norm=True), 32, 44),
    "ragged": (dict(attn_chunk=8), 20, 12),   # 8 does not divide 20
}


@pytest.mark.parametrize("name", sorted(CROSS_CASES))
def test_cross_attention_apply(name):
    fields, sq, sk = CROSS_CASES[name]
    rc, pc = _cfgs(**fields)
    rp, pp = _attn_params(rc, 3)
    x, enc = _x((2, sq, rc.d_model), 4), _x((2, sk, rc.d_model), 5)
    rk, rv = RL.cross_kv(rc, rp, jnp.asarray(enc))
    want = jax.jit(lambda x_: RL.cross_attention_apply(rc, rp, x_, rk, rv))(
        jnp.asarray(x))
    pk, pv = PL.cross_kv(pc, pp, torch.from_numpy(enc))
    _close(want, PL.cross_attention_apply(pc, pp, torch.from_numpy(x), pk,
                                          pv))


def _encoder(pc, seed):
    """Random float32 parameters in the reference's tree (the layers'
    leaves stacked), norms around 1, and the port's EncDecLM carrying them
    over."""
    rng = np.random.default_rng(seed)
    depth = {"blocks": pc.n_layers, "enc_blocks": pc.enc_layers}
    params = {}
    for name, p in build_model(pc).init_shapes().named_parameters():
        parts = name.split(".")
        shape = tuple(p.shape)
        if parts[0] in depth:
            if parts[1] != "0":
                continue
            parts, shape = [parts[0]] + parts[2:], (depth[parts[0]],) + shape
        node = params
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        a = rng.standard_normal(shape) * 0.2
        node[parts[-1]] = (a + 1 if "norm" in parts[-1] or
                           parts[-1].startswith("ln") else a).astype(
                               np.float32)
    return params, lm_params_from_reference(pc, params, device="cpu")


@pytest.mark.parametrize("chunk", [0, 8])
def test_enc_block_apply(chunk):
    """One encoder layer: bidirectional attention (no causal mask: a query
    reads keys after it) and the MLP."""
    rc, pc = _cfgs(attn_chunk=chunk)
    params, model = _encoder(pc, 6)
    x = _x((2, 24, rc.d_model), 7)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24))
    bp = jax.tree.map(lambda a: jnp.asarray(a[1]), params["enc_blocks"])
    want = jax.jit(lambda x_, p_: RE._enc_block_apply(rc, bp, x_, p_))(
        jnp.asarray(x), jnp.asarray(pos))
    got = PE._enc_block_apply(pc, model.enc_blocks[1], torch.from_numpy(x),
                              torch.from_numpy(pos.copy()))
    _close(want, got)


@pytest.mark.parametrize("src", ["frames", "frames-chunked", "ids"])
def test_encode(src):
    """encode from (B, S, D) frames (unchunked, q-chunked) or from (B, S)
    source ids through src_embed (a config without embed_inputs)."""
    rc, pc = _cfgs(attn_chunk=8 if src == "frames-chunked" else 0,
                   embed_inputs=src != "ids")
    params, model = _encoder(pc, 8)
    if src == "ids":
        inp = np.random.default_rng(9).integers(0, rc.vocab, (2, 24))
        ref_in, port_in = jnp.asarray(inp, jnp.int32), torch.from_numpy(inp)
        assert "src_embed" in params
    else:
        inp = _x((2, 24, rc.d_model), 9)
        ref_in, port_in = jnp.asarray(inp), torch.from_numpy(inp)
        assert "src_embed" not in params
    want = jax.jit(lambda s_: RE.encode(rc, jax.tree.map(jnp.asarray, params),
                                        s_))(ref_in)
    _close(want, PE.encode(pc, model, port_in))


@pytest.mark.parametrize("arch,dtype,chunk",
                         [(ARCH, d, c) for d, c in CASES])
def test_prefill_logits_and_caches(arch, dtype, chunk):
    check_prefill(arch, dtype, chunk=chunk)


@pytest.mark.parametrize("arch,dtype,chunk",
                         [(ARCH, d, c) for d, c in CASES])
def test_greedy_decode_steps(arch, dtype, chunk):
    check_decode(arch, dtype, chunk=chunk)
