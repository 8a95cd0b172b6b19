"""The VLM (qwen2-vl-72b) end to end on the CPU: the port's prefill from
embeddings and m-rope streams, then greedy decode, against the reference's
jitted steps (tests/_lm_parity.py, which states the tolerances and the
streams) on its SMOKE config.

Two streams: the launcher's broadcast 0..S-1, and IMAGE_STREAM, whose
image patches share one temporal position, unchunked and q-chunked (16 at
S = 48).  The reference masks by the temporal stream, so the image stream
is the case an index mask gets wrong: the port with its mask forced to the
index is held to fail it.  On the card the index decision picks the flash
kernel (tests/test_torch_kernels_gpu.py)."""

import numpy as np
import pytest
import torch

from _lm_parity import (PROMPT, STEPS, TOL_F32, check_decode, check_prefill,
                        configs, inputs, mrope_stream, port_inputs,
                        reference_run, within, IMAGE_STREAM)
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import layers, steps

ARCH = "qwen2-vl-72b"
CASES = [(None, "arange", None), (None, "image", None), (None, "image", 16),
         ("bfloat16", "arange", None), ("bfloat16", "image", None)]


@pytest.mark.parametrize("dtype,stream,chunk", CASES)
def test_prefill_logits_and_caches(dtype, stream, chunk):
    check_prefill(ARCH, dtype, stream, chunk)


@pytest.mark.parametrize("dtype,stream,chunk", CASES)
def test_greedy_decode_steps(dtype, stream, chunk):
    check_decode(ARCH, dtype, stream, chunk)


def test_image_stream_layout():
    """IMAGE_STREAM in Qwen2-VL's layout: text 0..5; a 3 x 4 image at t 6,
    h 6..8, w 6..9; text from 10; a 4 x 4 image at t 14; text from 18."""
    pos, nxt = mrope_stream(IMAGE_STREAM)
    assert pos.shape == (3, PROMPT) and nxt == 28
    np.testing.assert_array_equal(pos[:, :6], np.tile(np.arange(6), (3, 1)))
    assert (pos[0, 6:18] == 6).all()
    np.testing.assert_array_equal(pos[1, 6:18], np.repeat([6, 7, 8], 4))
    np.testing.assert_array_equal(pos[2, 6:18], np.tile([6, 7, 8, 9], 3))
    np.testing.assert_array_equal(pos[:, 18:22],
                                  np.tile(np.arange(10, 14), (3, 1)))
    assert (pos[0, 22:38] == 14).all()
    np.testing.assert_array_equal(pos[:, 38:], np.tile(np.arange(18, 28),
                                                       (3, 1)))


def test_index_stream():
    s = 12
    idx = torch.arange(s, dtype=torch.int32)
    assert layers.index_stream(None)
    assert layers.index_stream(idx.expand(3, 2, s))   # (B, 3, S)
    assert layers.index_stream(idx[None, :])          # (B, S)
    assert not layers.index_stream(idx[None, :] + 1)
    img = torch.from_numpy(mrope_stream(IMAGE_STREAM)[0])[None]
    assert not layers.index_stream(img)
    rows = idx.expand(2, 3, s).clone()
    rows[1, 0, 5] = 4                                  # one row, temporal
    assert not layers.index_stream(rows)
    rows = idx.expand(2, 3, s).clone()
    rows[:, 1:] = 0                                    # h, w do not mask
    assert layers.index_stream(rows)


def _prefill_shares(stream, chunk):
    """max |port - reference| over the float32 prefill's logits and caches,
    each a share of TOL_F32 x the reference's max |value|."""
    _, cfg = configs(ARCH, None, chunk)
    params, batch, ref = reference_run(ARCH, None, stream, chunk)
    model = lm_params_from_reference(cfg, params, device="cpu")
    logits, cache = steps.make_prefill_step(
        cfg, cache_capacity=PROMPT + STEPS)(model, **port_inputs(cfg, batch))
    got = [logits] + [c[n] for c in cache for n in sorted(c)]
    want = [ref[0]["logits"]] + [c[n] for c in ref[0]["cache"]
                                 for n in sorted(c)]
    return [within(w, g.float().numpy(), rel=TOL_F32)[0]
            / (TOL_F32 * np.abs(w).max()) for w, g in zip(want, got)]


@pytest.mark.parametrize("chunk", [None, 16])
def test_an_index_mask_fails_the_image_stream(monkeypatch, chunk):
    """The port with its mask forced to 0..S-1 (the flash kernel's) misses
    the reference on the image stream by far more than TOL_F32 (the image
    rows' keys and values in the second layer's cache), and only there: on
    the arange stream the forced mask is the reference's."""
    monkeypatch.setattr(layers, "index_stream", lambda positions: True)
    assert max(_prefill_shares("image", chunk)) > 100
    assert max(_prefill_shares("arange", None)) <= 1


def test_the_mask_is_decided_once_a_prefill(monkeypatch):
    """transformer.forward asks index_stream once a prefill, not once a
    layer (on the card each ask is a host sync)."""
    asked = []
    original = layers.index_stream

    def counting(positions):
        asked.append(positions)
        return original(positions)

    monkeypatch.setattr(layers, "index_stream", counting)
    _, cfg = configs(ARCH)
    assert cfg.n_layers > 1
    batch, _ = inputs(cfg, "image")
    model = lm_params_from_reference(cfg, reference_run(ARCH, None, "image")
                                     [0], device="cpu")
    steps.make_prefill_step(cfg)(model, **port_inputs(cfg, batch))
    assert len(asked) == 1
