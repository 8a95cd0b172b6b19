"""Port parity of flash attention: repro_torch's flash_attention, flash_mha,
mha_plain and grid_savings against repro's Pallas flash_attention in
interpret mode, its ops.flash_mha and its oracle ref.mha_ref.

The same numpy arrays go to both packages.  On the CPU the port's wrapper
runs its plain version, so these tests hold that plain version (and the
wrapper's checks) against the reference; the CUDA kernel is held against
the plain version on the card (tests/test_torch_kernels_gpu.py).
Tolerances are the reference's own (tests/test_kernels.py): 2e-6 in
float32, 3e-2 in bfloat16 and float16.  The padding of the head dimension
that the tensor-core kernel needs for D % 8 != 0 is host code, tested here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.kernels.flash_attention import grid_savings as ref_grid_savings
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain,
                                                 grid_savings, mha_plain,
                                                 pad_head_dim)

TOL_F32 = 2e-6
TOL_BF16 = 3e-2


def _qkv(b, h, hkv, s, d, seed, sq=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, s if sq is None else sq, d))
    k = rng.standard_normal((b, hkv, s, d))
    v = rng.standard_normal((b, hkv, s, d))
    return [a.astype(np.float32) for a in (q, k, v)]


def _both(arrays, jdtype=jnp.float32, tdtype=torch.float32):
    return ([jnp.asarray(a, jdtype) for a in arrays],
            [torch.from_numpy(a).to(tdtype) for a in arrays])


@pytest.mark.parametrize("b,h,hkv,s,d,blk", [
    (1, 2, 2, 32, 16, 16),     # MHA, exact blocks
    (2, 4, 2, 70, 16, 16),     # GQA, padded seq
    (1, 8, 1, 64, 32, 16),     # MQA
    (2, 2, 2, 17, 8, 16),      # seq < block
])
def test_flash_attention_matches_reference_kernel(b, h, hkv, s, d, blk):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(b, h, hkv, s, d, 1))
    want = np.asarray(ref_flash(jq, jk, jv, blk_q=blk, blk_k=blk,
                                interpret=True))
    got = flash_attention(tq, tk, tv, blk_q=blk, blk_k=blk)
    assert got.dtype == torch.float32 and got.shape == (b, h, s, d)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_F32,
                               rtol=TOL_F32)


@pytest.mark.parametrize("window", [16, 32, 48])
def test_flash_attention_windowed_matches_reference_kernel(window):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, 4, 2, 96, 16, 2))
    want = np.asarray(ref_flash(jq, jk, jv, window=window, blk_q=16,
                                blk_k=16, interpret=True))
    got = flash_attention(tq, tk, tv, window=window, blk_q=16, blk_k=16)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_F32)


def test_flash_attention_bf16_matches_reference_kernel():
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, 4, 2, 70, 16, 3),
                                       jnp.bfloat16, torch.bfloat16)
    want = ref_flash(jq, jk, jv, window=32, blk_q=16, blk_k=16,
                     interpret=True)
    got = flash_attention(tq, tk, tv, window=32, blk_q=16, blk_k=16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL_BF16, rtol=TOL_BF16)


def test_flash_attention_fp16_matches_reference_kernel():
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, 4, 2, 70, 16, 10),
                                       jnp.float16, torch.float16)
    want = ref_flash(jq, jk, jv, window=32, blk_q=16, blk_k=16,
                     interpret=True)
    got = flash_attention(tq, tk, tv, window=32, blk_q=16, blk_k=16)
    assert got.dtype == torch.float16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL_BF16, rtol=TOL_BF16)


@pytest.mark.parametrize("d", [100, 17])
def test_head_dim_padding_changes_no_value(d):
    """The tensor-core kernel's operands are padded to a multiple of 8
    columns: with the true scale 1 / sqrt(D), the padded attention sliced
    back is the unpadded one."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 2, 40, d, 11))
    pq, pk, pv = pad_head_dim(q, k, v)
    assert pq.shape[-1] % 8 == 0 and pq.shape[-1] - d < 8
    assert torch.equal(pq[..., :d], q) and not pq[..., d:].any()
    got = mha_plain(pq, pk, pv, window=16, scale=1.0 / np.sqrt(d))[..., :d]
    want = mha_plain(q, k, v, window=16)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-7)


def test_head_dim_padding_leaves_multiples_of_8_alone():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 2, 40, 24, 12))
    got = pad_head_dim(q, k, v)
    assert all(a is b for a, b in zip(got, (q, k, v)))


@pytest.mark.parametrize("s,window", [(32, 16), (96, 80), (40, 32)])
def test_window_kept_where_the_reference_kernel_drops_it(s, window):
    """At (m_blocks - 1) * blk <= window < S the reference kernel sets
    w_blocks = None (src/repro/kernels/flash_attention.py:153-155) and
    computes full causal attention, while its own oracle masks keys at
    k <= q - window.  The port keeps the window, so it is held against the
    oracle ref.mha_ref here, not against the reference kernel."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, 2, 1, s, 16, 4))
    want = np.asarray(ref.mha_ref(jq, jk, jv, causal=True, window=window))
    got = flash_attention(tq, tk, tv, window=window, blk_q=16, blk_k=16)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_F32)


@pytest.mark.parametrize("sq,sk,causal,window", [
    (32, 32, True, None),
    (32, 32, True, 8),
    (5, 40, True, 16),       # right-aligned queries (decode)
    (7, 40, False, 12),      # window without the causal mask
    (24, 24, True, 0),       # every row fully masked: zeros
])
def test_mha_plain_matches_mha_ref(sq, sk, causal, window):
    q, k, v = _qkv(2, 6, 3, sk, 8, 5, sq=sq)
    (jq, jk, jv), (tq, tk, tv) = _both([q, k, v])
    want = np.asarray(ref.mha_ref(jq, jk, jv, causal=causal, window=window))
    got = mha_plain(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_F32)
    assert np.isfinite(got.numpy()).all()


def test_flash_plain_matches_mha_ref_in_float64():
    """The kernel's plain version (q scaled before the dot) against the
    oracle (logits scaled after it), both on the same inputs."""
    q, k, v = _qkv(1, 4, 2, 130, 64, 6)
    want = mha_plain(*(torch.from_numpy(a).double() for a in (q, k, v)),
                     window=64)
    got = flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                window=64)
    assert float((got.double() - want).abs().max()) <= TOL_F32


@pytest.mark.parametrize("s,blk,window", [
    (4096, 128, None), (32768, 128, 4096), (96, 16, 16), (96, 16, 80),
    (40, 16, 32), (17, 16, None), (1000, 64, 128), (1000, 64, 2048),
])
def test_grid_savings_equals_reference(s, blk, window):
    assert grid_savings(s, blk, window) == ref_grid_savings(s, blk, window)


@pytest.mark.parametrize("case", ["heads", "blocks", "window"])
def test_errors_match_reference(case):
    q, k, v = _qkv(1, 4, 2, 32, 8, 7)
    kw = {"heads": dict(), "blocks": dict(blk_q=16, blk_k=32),
          "window": dict(window=24, blk_q=16, blk_k=16)}[case]
    if case == "heads":
        k, v = k[:, :1].repeat(3, axis=1), v[:, :1].repeat(3, axis=1)
    (jq, jk, jv), (tq, tk, tv) = _both([q, k, v])
    with pytest.raises(ValueError) as want:
        ref_flash(jq, jk, jv, interpret=True, **kw)
    with pytest.raises(ValueError) as got:
        flash_attention(tq, tk, tv, **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("window", [None, 16])
def test_flash_mha_equals_flash_attention_and_reference(window):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, 4, 2, 48, 16, 8))
    got = ops.flash_mha(tq, tk, tv, window=window, blk=16)
    assert torch.equal(got, flash_attention(tq, tk, tv, window=window,
                                            blk_q=16, blk_k=16))
    want = np.asarray(ref_ops.flash_mha(jq, jk, jv, window=window, blk=16,
                                        impl="interpret"))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_F32)


@pytest.mark.parametrize("window,chunk", [(None, 16), (None, 33), (8, 16),
                                          (40, 7), (0, 16)])
def test_plain_in_row_chunks_matches_whole(window, chunk):
    tq, tk, tv = (torch.from_numpy(a) for a in _qkv(2, 4, 2, 70, 16, 9))
    whole = flash_attention_plain(tq, tk, tv, window=window)
    got = flash_attention_plain(tq, tk, tv, window=window, chunk=chunk)
    torch.testing.assert_close(got, whole, rtol=0, atol=TOL_F32)
