"""Port parity of the tile kernel's plain version and of EpilogueSpec.

repro_torch's pcc_tiles_plain against repro's Pallas pcc_tiles in interpret
mode, on the same prepared operand.  Tolerance 3e-6: the reference's own
Pearson parity bound (tests/test_distributed.py); the two sum the same
products in different float32 orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.plan import pad_operands as ref_pad
from repro.core.pcc import transform as ref_transform
from repro.kernels.pcc_tile import EpilogueSpec as RefEpilogue
from repro.kernels.pcc_tile import pcc_tiles as ref_pcc_tiles
from repro_torch.kernels.pcc_tile import (EpilogueSpec, pcc_tiles,
                                          pcc_tiles_plain)

ATOL = 3e-6

EPILOGUES = {
    "none": None,
    "clip": (None, (-1.0, 1.0)),
    "div_clip": (7.0, (-0.05, 0.05)),
}


def _operand(n, l, t, l_blk, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, l)).astype(np.float32)
    u = ref_transform(jnp.asarray(x), dtype=jnp.float32)
    return np.array(ref_pad(u, t, l_blk))


def _specs(name):
    ep = EPILOGUES[name]
    if ep is None:
        return None, None
    return EpilogueSpec(div=ep[0], clip=ep[1]), RefEpilogue(div=ep[0],
                                                            clip=ep[1])


@pytest.mark.parametrize("epilogue", list(EPILOGUES))
@pytest.mark.parametrize("n,l,t,l_blk,j_start,pass_tiles", [
    (37, 29, 8, 8, 0, 15),      # full launch, padded rows and samples
    (37, 29, 8, 8, 12, 3),      # ragged last pass: ids 12..14 of 15
    (37, 29, 8, 8, 13, 6),      # j_start + pass_tiles > total: clamped
    (70, 100, 16, 32, 2, 9),    # several sample blocks
    (20, 64, 16, 64, 0, 5),     # two ids past the end of a 3-tile triangle
])
def test_plain_matches_interpret_pallas(n, l, t, l_blk, j_start, pass_tiles,
                                        epilogue):
    u = _operand(n, l, t, l_blk)
    spec, ref_spec = _specs(epilogue)
    got = pcc_tiles_plain(torch.from_numpy(u), j_start, t=t, l_blk=l_blk,
                          pass_tiles=pass_tiles, epilogue=spec)
    want = ref_pcc_tiles(jnp.asarray(u), j_start, t=t, l_blk=l_blk,
                         pass_tiles=pass_tiles, interpret=True,
                         epilogue=ref_spec)
    assert got.shape == (pass_tiles, t, t) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_clamped_slots_repeat_the_last_tile():
    u = torch.from_numpy(_operand(37, 29, 8, 8))
    out = pcc_tiles_plain(u, 13, t=8, l_blk=8, pass_tiles=6)
    for i in range(2, 6):
        assert torch.equal(out[i], out[1])


def test_cpu_tensor_dispatches_to_plain_and_counts_no_launch():
    u = torch.from_numpy(_operand(37, 29, 8, 8))
    before = pcc_tiles.launches
    out = pcc_tiles(u, 3, t=8, l_blk=8, pass_tiles=5,
                    epilogue=EpilogueSpec(clip=(-1.0, 1.0)))
    want = pcc_tiles_plain(u, 3, t=8, l_blk=8, pass_tiles=5,
                           epilogue=EpilogueSpec(clip=(-1.0, 1.0)))
    assert torch.equal(out, want)
    assert pcc_tiles.launches == before


@pytest.mark.parametrize("div,clip", [
    (None, None), (None, (-1.0, 1.0)), (3.0, None), (4999.0, (-1.0, 1.0)),
    (7.0, (-0.05, 0.05)), (1e-3, (-2.5, 0.125)),
])
def test_epilogue_apply_bitwise_equals_reference(div, clip):
    rng = np.random.default_rng(11)
    v = (rng.standard_normal(4096) * 3).astype(np.float32)
    v[:4] = [0.0, -0.0, 1.0, -1.0]
    got = EpilogueSpec(div=div, clip=clip).apply(torch.from_numpy(v.copy()))
    want = np.asarray(RefEpilogue(div=div, clip=clip).apply(jnp.asarray(v)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


def test_epilogue_kernel_args_carry_the_canonical_reciprocal():
    spec = EpilogueSpec(div=4999.0, clip=(-1.0, 1.0))
    has_div, recip, has_clip, lo, hi = spec.kernel_args()
    assert (has_div, has_clip, lo, hi) == (1, 1, -1.0, 1.0)
    assert np.float32(recip) == np.float32(1.0) / np.float32(4999.0)
    assert float(np.float32(recip)) == recip
    assert EpilogueSpec().kernel_args()[::2] == (0, 0, 0.0)
    assert EpilogueSpec().is_identity()


def test_epilogue_clip_keeps_nan_like_the_reference():
    v = np.array([np.nan, 2.0, -2.0], np.float32)
    got = EpilogueSpec(clip=(-1.0, 1.0)).apply(torch.from_numpy(v)).numpy()
    want = np.asarray(RefEpilogue(clip=(-1.0, 1.0)).apply(jnp.asarray(v)))
    np.testing.assert_array_equal(got, want)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    u = torch.from_numpy(_operand(37, 29, 8, 8))
    ok = dict(t=8, l_blk=8, pass_tiles=2)
    bad = [
        (u.double(), 0, ok),                          # dtype
        (u.t(), 0, ok),                               # contiguity
        (u[:, :-1].contiguous(), 0, ok),              # l_pad % l_blk
        (u, 0, dict(t=16, l_blk=8, pass_tiles=2)),    # n_pad % t (40 % 16)
        (u, 0, dict(t=8, l_blk=8, pass_tiles=0)),     # empty launch
        (u, -1, ok),                                  # negative tile id
        (u[0], 0, ok),                                # not 2-D
        (u.to(torch.device("meta")), 0, ok),          # device
    ]
    for fn in (pcc_tiles, pcc_tiles_plain):
        for arr, j0, kw in bad:
            with pytest.raises(ValueError):
                fn(arr, j0, **kw)
