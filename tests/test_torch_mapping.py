"""Port parity: the tile-id bijection, the pass split and the lower-triangle
and band bijections of flash attention of repro_torch equal repro's exactly
(host ints, no tolerance)."""

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import mapping as ref_mapping
from repro.core import tiling as ref_tiling
from repro_torch.core import mapping, tiling


@pytest.mark.parametrize("m", [1, 2, 7, 69, 250])
def test_job_coord_batch_equals_reference_for_every_id(m):
    total = mapping.tri_count(m)
    assert total == ref_mapping.tri_count(m)
    ids = np.arange(total, dtype=np.int64)
    ys, xs = mapping.job_coord_batch(m, ids)
    rys, rxs = ref_mapping.job_coord_batch(m, ids)
    np.testing.assert_array_equal(ys, rys)
    np.testing.assert_array_equal(xs, rxs)
    # and the forward map inverts it, id for id
    back = [mapping.job_id(m, int(y), int(x)) for y, x in zip(ys, xs)]
    np.testing.assert_array_equal(back, ids)
    for j in {0, total // 2, total - 1}:
        assert mapping.job_coord(m, j) == ref_mapping.job_coord(m, j)


@pytest.mark.parametrize("m", [10 ** 5, 3 * 10 ** 6])
def test_job_coord_batch_exact_at_large_m(m):
    """The int64 repair stays exact where the tile grid is huge."""
    total = mapping.tri_count(m)
    ids = np.array([0, 1, m - 1, m, total // 3, total - m, total - 2,
                    total - 1], dtype=np.int64)
    ys, xs = mapping.job_coord_batch(m, ids)
    rys, rxs = ref_mapping.job_coord_batch(m, ids)
    np.testing.assert_array_equal(ys, rys)
    np.testing.assert_array_equal(xs, rxs)


def test_job_coord_batch_rejects_out_of_range():
    for bad in ([-1], [mapping.tri_count(7)]):
        with pytest.raises(ValueError):
            mapping.job_coord_batch(7, bad)
    with pytest.raises(ValueError):
        mapping.job_id(7, 3, 2)


@pytest.mark.parametrize("mtp", [1, 2, 7, 64])
@pytest.mark.parametrize("residue", ["zero", "one", "mtp_minus_one"])
def test_pass_split_equals_reference(mtp, residue):
    r = {"zero": 0, "one": 1, "mtp_minus_one": mtp - 1}[residue]
    span = 3 * mtp + r
    assert (tiling.pass_launch_sizes(span, mtp)
            == ref_tiling.pass_launch_sizes(span, mtp))
    assert (list(tiling.passes(5, 5 + span, mtp))
            == list(ref_tiling.passes(5, 5 + span, mtp)))
    assert sum(tiling.pass_launch_sizes(span, mtp)) == span


def test_tile_plan_and_ranges_equal_reference():
    for n, l, t in [(1, 1, 1), (130, 70, 16), (17_555, 5_072, 256)]:
        a = tiling.TilePlan.create(n, l, t)
        b = ref_tiling.TilePlan.create(n, l, t)
        assert (a.n, a.l, a.t, a.m, a.n_pad, a.total_tiles) == \
            (b.n, b.l, b.t, b.m, b.n_pad, b.total_tiles)
    for total, p in [(45, 1), (45, 4), (2415, 16), (3, 8)]:
        assert (tiling.contiguous_ranges(total, p)
                == ref_tiling.contiguous_ranges(total, p))
    for bad in [(0, 1, 1), (1, 0, 1), (1, 1, 0)]:
        with pytest.raises(ValueError):
            tiling.TilePlan.create(*bad)
    with pytest.raises(ValueError):
        tiling.pass_launch_sizes(0, 4)
    with pytest.raises(ValueError):
        list(tiling.passes(0, 4, 0))


# -- the lower-triangle and band bijections of flash attention ---------------

M_SMALL = range(1, 41)


def test_lower_triangle_equals_reference_exhaustively():
    for j in range(0, 41 * 42 // 2):
        y, x = mapping.lower_job_coord(j)
        assert (y, x) == ref_mapping.lower_job_coord(j)
        assert mapping.lower_job_id(y, x) == ref_mapping.lower_job_id(y, x)
        assert mapping.lower_job_id(y, x) == j
    for bad in [(0, 1), (3, 4), (-1, 0)]:
        with pytest.raises(ValueError):
            mapping.lower_job_id(*bad)
    with pytest.raises(ValueError):
        mapping.lower_job_coord(-1)


@pytest.mark.parametrize("j", [10 ** 12, 10 ** 15 + 7, 2 ** 62 - 1])
def test_lower_job_coord_exact_at_large_ids(j):
    y, x = mapping.lower_job_coord(j)
    assert (y, x) == ref_mapping.lower_job_coord(j)
    assert 0 <= x <= y and mapping.lower_job_id(y, x) == j


def test_lower_job_coord_equals_reference_f32_inverse_where_it_holds():
    """The reference's float32 inverse for its Pallas index maps agrees with
    the exact one up to its stated range (~2,000 block rows)."""
    ids = np.unique(np.linspace(0, mapping.tri_count(1500) - 1, 4001)
                    .astype(np.int64))
    ys, xs = ref_mapping.lower_job_coord_f32(jnp.asarray(ids, jnp.int32))
    want = [mapping.lower_job_coord(int(j)) for j in ids]
    assert [tuple(p) for p in zip(np.asarray(ys).tolist(),
                                  np.asarray(xs).tolist())] == want


@pytest.mark.parametrize("m", M_SMALL)
def test_band_lower_equals_reference_for_every_width_and_id(m):
    for w in range(1, m + 2):
        count = mapping.band_lower_count(m, w)
        assert count == ref_mapping.band_lower_count(m, w)
        seen = []
        for j in range(count):
            y, x = mapping.band_lower_job_coord(m, w, j)
            assert (y, x) == ref_mapping.band_lower_job_coord(m, w, j)
            seen.append((y, x))
        # the band, row-major: each row's jobs consecutive
        assert seen == [(y, x) for y in range(m)
                        for x in range(max(0, y - w + 1), y + 1)]
        for bad in (-1, count):
            with pytest.raises(ValueError):
                mapping.band_lower_job_coord(m, w, bad)


@pytest.mark.parametrize("n", M_SMALL)
def test_upper_band_equals_reference_for_every_width_and_id(n):
    for w in range(1, n + 2):
        count = mapping.band_count(n, w)
        assert count == ref_mapping.band_count(n, w)
        assert tiling.band_tile_count(n, w) == ref_tiling.band_tile_count(n, w)
        for j in range(count):
            y, x = mapping.band_job_coord(n, w, j)
            assert (y, x) == ref_mapping.band_job_coord(n, w, j)
            assert (y, x) == tiling.band_tile_coord(n, w, j)
            assert mapping.band_job_id(n, w, y, x) == j
            assert ref_mapping.band_job_id(n, w, y, x) == j
        for bad in (-1, count):
            with pytest.raises(ValueError):
                mapping.band_job_coord(n, w, bad)
    with pytest.raises(ValueError):
        mapping.band_job_id(n, 1, 0, 1)     # outside a band of width 1
