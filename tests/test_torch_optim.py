"""The port's gradient compression (optim/compression.py) and synthetic
token stream (data/synthetic.py) against the reference's, on the CPU.

The reference's ``compressed_psum`` reduces over a named axis inside
``shard_map``; here it runs under ``jax.vmap(..., axis_name=...)``, which
gives each rank's result on one device, and the port takes the same
per-rank tensors in rank order.  Average and residuals must be bitwise the
reference's and every rank's average bitwise the others'.  The reference's
own properties of the codecs (tests/test_optim.py) hold on the port, and
``batch_at`` is bitwise the reference's for every (seed, step, slice).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic as ref_synthetic
from repro.optim import compression as ref_comp
from repro_torch.data import synthetic
from repro_torch.optim import compression as comp


def _ranks(seed, n_ranks, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal((n_ranks, *shape)) * scale).astype(np.float32)
    e = (rng.standard_normal((n_ranks, *shape)) * 1e-3 * scale).astype(
        np.float32)
    return g, e


def _reference_psum(g, e):
    fn = jax.vmap(lambda gi, ei: ref_comp.compressed_psum(gi, "d", ei),
                  axis_name="d")
    avg, err = fn(jnp.asarray(g), jnp.asarray(e))
    return np.asarray(avg), np.asarray(err)


@pytest.mark.parametrize("n_ranks,shape,scale", [
    (2, (64,), 1.0), (4, (33, 7), 1e-3), (8, (256,), 50.0), (1, (10,), 1.0)])
def test_compressed_psum_is_bitwise_the_reference(n_ranks, shape, scale):
    g, e = _ranks(n_ranks * 10 + len(shape), n_ranks, shape, scale)
    want_avg, want_err = _reference_psum(g, e)
    avg, err = comp.compressed_psum([torch.from_numpy(x) for x in g],
                                    [torch.from_numpy(x) for x in e])
    for r in range(n_ranks):
        np.testing.assert_array_equal(avg[r].numpy(), want_avg[r])
        np.testing.assert_array_equal(err[r].numpy(), want_err[r])
        assert torch.equal(avg[r], avg[0])
        assert avg[r].dtype == err[r].dtype == torch.float32
    # distinct tensors: a rank's in-place update leaves the others alone
    assert len({a.data_ptr() for a in avg}) == n_ranks


def test_compressed_psum_over_steps_with_feedback():
    """Ten steps of error feedback on 4 ranks, each step's residuals fed to
    the next: bitwise the reference at every step; the compressed sum
    tracks the true mean (the residual does not grow)."""
    rng = np.random.default_rng(7)
    err = np.zeros((4, 128), np.float32)
    perr = [torch.zeros(128) for _ in range(4)]
    total_true = np.zeros(128)
    total_comp = np.zeros(128)
    for _ in range(10):
        g = rng.standard_normal((4, 128)).astype(np.float32)
        want_avg, err = _reference_psum(g, err)
        avg, perr = comp.compressed_psum([torch.from_numpy(x) for x in g],
                                         perr)
        np.testing.assert_array_equal(avg[0].numpy(), want_avg[0])
        np.testing.assert_array_equal(np.stack([e.numpy() for e in perr]),
                                      err)
        total_true += g.mean(0)
        total_comp += avg[0].numpy()
    assert np.abs(total_true - total_comp).max() < 0.1
    assert max(float(e.abs().max()) for e in perr) > 0


def test_compress_tree_psum_is_leafwise():
    rng = np.random.default_rng(8)
    shapes = [(5, 3), (7,), (2, 2, 2)]
    grads = [[torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for s in shapes] for _ in range(3)]
    errs = [[torch.zeros(s) for s in shapes] for _ in range(3)]
    avgs, new_errs = comp.compress_tree_psum(grads, errs)
    assert len(avgs) == len(new_errs) == 3
    for i, s in enumerate(shapes):
        a, e = comp.compressed_psum([g[i] for g in grads],
                                    [x[i] for x in errs])
        for r in range(3):
            assert avgs[r][i].shape == s
            assert torch.equal(avgs[r][i], a[r])
            assert torch.equal(new_errs[r][i], e[r])
    with pytest.raises(ValueError):
        comp.compressed_psum([grads[0][0]], [])


@pytest.mark.parametrize("seed", range(20))
def test_int8_quantize_matches_the_reference_and_bounds_error(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(256).astype(np.float32)
    q, scale = comp.quantize_int8(torch.from_numpy(x))
    rq, rscale = ref_comp.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert q.dtype == torch.int8
    assert float(scale) == float(rscale)
    back = comp.dequantize_int8(q, scale)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(ref_comp.dequantize_int8(rq, rscale)))
    # max quantisation error is half a step
    assert np.abs(back.numpy() - x).max() <= float(scale) * 0.5 + 1e-6


def test_topk_sparsify():
    x = torch.arange(-10, 10, dtype=torch.float32)
    y = comp.topk_sparsify(x, 0.25).numpy()
    assert (y != 0).sum() == 5
    assert set(np.abs(y[y != 0])) <= {10, 9, 8, 7, 6}
    rng = np.random.default_rng(9)
    z = rng.standard_normal((16, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        comp.topk_sparsify(torch.from_numpy(z), 0.1).numpy(),
        np.asarray(ref_comp.topk_sparsify(jnp.asarray(z), 0.1)))


def test_error_feedback_unbiased_over_time():
    """With error feedback the accumulated compressed sum tracks the true
    sum (the reference's property, tests/test_optim.py)."""
    rng = np.random.default_rng(0)
    err = torch.zeros(64)
    total_true = np.zeros(64)
    total_comp = np.zeros(64)
    for _ in range(50):
        g = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
        gi = g + err
        q, s = comp.quantize_int8(gi)
        out = comp.dequantize_int8(q, s)
        err = gi - out
        total_true += g.numpy()
        total_comp += out.numpy()
    assert np.abs(total_true - total_comp).max() < 0.1


@pytest.mark.parametrize("seed,step,vocab,seq,batch,rows", [
    (0, 0, 256, 64, 8, None), (0, 7, 256, 64, 8, slice(2, 6)),
    (3, 11, 128_256, 256, 8, slice(0, 4)), (5, 2, 512, 15, 4, None),
    (1, 100, 1000, 33, 6, slice(3, 6))])
def test_batch_at_is_bitwise_the_reference(seed, step, vocab, seq, batch,
                                           rows):
    kw = dict(vocab=vocab, seq_len=seq, global_batch=batch, seed=seed)
    got = synthetic.batch_at(synthetic.TokenStreamSpec(**kw), step, rows)
    want = ref_synthetic.batch_at(ref_synthetic.TokenStreamSpec(**kw), step,
                                  rows)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in got:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


def test_stream_replays_batch_at():
    spec = synthetic.TokenStreamSpec(vocab=300, seq_len=16, global_batch=4)
    it = synthetic.stream(spec, start_step=5)
    for step in range(5, 8):
        b = next(it)
        want = synthetic.batch_at(spec, step)
        np.testing.assert_array_equal(b["tokens"], want["tokens"])
