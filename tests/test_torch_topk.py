"""Port parity of the per-row top-k path: the canonical merge, the top-k
kernel's plain version (whole, and as its two kernels' plain versions,
select then merge), TopKSink and DeviceTopKSink, against ``repro``.

Tolerances: values within 3e-6, the reference's own Pearson parity bound
(tests/test_distributed.py; both compute in float32 in different orders).
Column indices are compared exactly on data drawn so that no two |r| of a
row lie within 1e-4 (asserted below), so the float32 differences cannot
reorder them.  The merge itself does no arithmetic and is bit-identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.api import corr as ref_corr
from repro.core.plan import ExecutionPlan as RefPlan
from repro.core.sinks import DeviceTopKSink as RefDeviceTopKSink
from repro.core.sinks import TopKSink as RefTopKSink
from repro.core.sinks import topk_merge_rows as ref_merge
from repro.kernels.pcc_tile import pcc_topk_tiles as ref_topk_tiles
from repro_torch import convert
from repro_torch.core.allpairs import execute_plan
from repro_torch.core.api import corr
from repro_torch.core.mapping import job_coord_batch
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.sinks import DeviceTopKSink, TopKSink, topk_merge_rows
from repro_torch.kernels.pcc_tile import (CTA_BLOCK, KK_MAX, EpilogueSpec,
                                          pcc_tiles_plain, pcc_topk_tiles,
                                          pcc_topk_tiles_plain,
                                          topk_fold_plain,
                                          topk_fold_states, topk_merge,
                                          topk_merge_plain, topk_select,
                                          topk_select_plain)

ATOL = 3e-6
GAP = 1e-4
N, N_COLS, L = 30, 21, 20     # n not a multiple of t = 8 or 16


def _data(seed=36):
    """Rows on three shared latent factors, which spreads |r| over [0, 1];
    seed 36 leaves every row's |r| at least GAP apart (checked below)."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((3, L))
    x = (rng.normal(scale=2.0, size=(N, 3)) @ z
         + rng.standard_normal((N, L))).astype(np.float32)
    y = (rng.normal(scale=2.0, size=(N_COLS, 3)) @ z
         + rng.standard_normal((N_COLS, L))).astype(np.float32)
    return x, y


def _min_gap(a, b, self_pairs):
    def unit(m):
        m = m.astype(np.float64) - m.mean(axis=1, keepdims=True)
        return m / np.linalg.norm(m, axis=1, keepdims=True)
    r = np.abs(unit(a) @ unit(b).T)
    if self_pairs:
        np.fill_diagonal(r, np.inf)
    s = np.sort(r, axis=1)[:, :-1 if self_pairs else None]
    return float(np.diff(s, axis=1).min())


def test_data_keeps_correlations_apart():
    x, y = _data()
    assert _min_gap(x, x, True) > GAP
    assert _min_gap(x, y, False) > GAP


# -- the canonical merge -----------------------------------------------------


def _candidates(rng, rows, cols, count, exact_ties):
    r_ids = rng.integers(0, rows, count)
    c_ids = np.empty(count, np.int64)
    for r in np.unique(r_ids):         # unique columns within a row
        at = np.nonzero(r_ids == r)[0]
        c_ids[at] = rng.choice(cols, at.size, replace=False)
    v = rng.standard_normal(count).astype(np.float32)
    if exact_ties:   # few distinct |v|, both signs: exact ties everywhere
        v = (rng.integers(-3, 4, count) / 4).astype(np.float32)
    return r_ids, c_ids, v


@pytest.mark.parametrize("k", [1, 4, 9])
@pytest.mark.parametrize("exact_ties", [False, True])
def test_topk_merge_rows_bit_identical_to_reference(k, exact_ties):
    rng = np.random.default_rng(k + 10 * exact_ties)
    rows, cols = 12, 40
    ours = (np.zeros((rows, k), np.float32), np.full((rows, k), -1, np.int64))
    ref = (ours[0].copy(), ours[1].copy())
    seen = [set() for _ in range(rows)]
    for _round in range(4):
        r_ids, c_ids, v = _candidates(rng, rows, cols, 60, exact_ties)
        # the contract: no column a row already holds
        fresh = np.array([c not in seen[r] for r, c in zip(r_ids, c_ids)])
        r_ids, c_ids, v = r_ids[fresh], c_ids[fresh], v[fresh]
        for r, c in zip(r_ids, c_ids):
            seen[r].add(c)
        topk_merge_rows(*ours, r_ids, c_ids, v, k)
        ref_merge(*ref, r_ids, c_ids, v, k)
        np.testing.assert_array_equal(ours[1], ref[1])
        assert ours[0].tobytes() == ref[0].tobytes()


@pytest.mark.parametrize("exact_ties", [False, True])
def test_topk_merge_rows_dedup_bit_identical_to_reference(exact_ties):
    rng = np.random.default_rng(3 + exact_ties)
    k, rows, cols = 5, 9, 30
    ours = (np.zeros((rows, k), np.float32), np.full((rows, k), -1, np.int64))
    ref = (ours[0].copy(), ours[1].copy())
    r_ids, c_ids, v = _candidates(rng, rows, cols, 50, exact_ties)
    for _round in range(3):   # re-delivered candidates: exact duplicates
        topk_merge_rows(*ours, r_ids, c_ids, v, k, dedup=True)
        ref_merge(*ref, r_ids, c_ids, v, k, dedup=True)
        np.testing.assert_array_equal(ours[1], ref[1])
        assert ours[0].tobytes() == ref[0].tobytes()
    # a duplicated column with the opposite sign is not an exact duplicate
    both = (np.array([0, 0]), np.array([7, 7]),
            np.array([0.5, -0.5], np.float32))
    topk_merge_rows(*ours, *both, k, dedup=True)
    ref_merge(*ref, *both, k, dedup=True)
    np.testing.assert_array_equal(ours[1], ref[1])
    assert ours[0].tobytes() == ref[0].tobytes()
    topk_merge_rows(*ours, np.array([], np.int64), np.array([], np.int64),
                    np.array([], np.float32), k)   # nothing to merge
    np.testing.assert_array_equal(ours[1], ref[1])


# -- the kernel's plain version -----------------------------------------------


def _ref_operands(grid, t, l_blk):
    x, y = _data()
    plan = RefPlan.create(N, L, n_cols=N_COLS if grid else None, t=t,
                          l_blk=l_blk, interpret=True)
    if grid:
        u, v = plan.prepare_pair(jnp.asarray(x), jnp.asarray(y))
    else:
        u, v = plan.prepare(jnp.asarray(x)), None
    return plan, u, v


@pytest.mark.parametrize("grid", [False, True])
@pytest.mark.parametrize("t,l_blk,j_start,pass_tiles,short,kk", [
    (8, 8, 0, 10 ** 6, 0, 4),     # the whole workload in one launch
    (8, 8, 3, 5, 0, 3),           # j_start > 0, mid range
    (8, 8, 2, 6, 2, 6),           # dev_hi below the launch's end
    (16, 16, 0, 10 ** 6, 0, 40),  # kk above every row's valid partners
    (16, 8, 1, 4, 1, 2),          # clamped slots past the end
])
def test_topk_plain_matches_interpret_pallas(grid, t, l_blk, j_start,
                                             pass_tiles, short, kk):
    ref_plan, ru, rv = _ref_operands(grid, t, l_blk)
    total = ref_plan.total_tiles
    pass_tiles = min(pass_tiles, total - j_start + (2 if short else 0))
    dev_hi = min(total, j_start + pass_tiles - short)
    n_valid = N_COLS if grid else N
    gc = ref_plan.workload.grid_cols
    want = ref_topk_tiles(ru, j_start, dev_hi, t=t, l_blk=l_blk,
                          pass_tiles=pass_tiles, kk=kk,
                          n_cols_valid=n_valid, symmetric_problem=not grid,
                          interpret=True, epilogue=ref_plan.epilogue_spec,
                          v_pad=rv, grid_cols=gc)
    plan = convert.plan_from_reference(ref_plan.spec_dict())
    u = convert.operand_from_reference(np.asarray(ru), device="cpu")
    v = (None if rv is None
         else convert.operand_from_reference(np.asarray(rv), device="cpu"))
    kw = dict(t=t, l_blk=l_blk, pass_tiles=pass_tiles, kk=kk,
              n_cols_valid=n_valid, symmetric_problem=not grid,
              epilogue=plan.epilogue_spec, v_pad=v, grid_cols=gc)
    got = pcc_topk_tiles_plain(u, j_start, dev_hi, **kw)
    assert len(got) == len(want) == (2 if grid else 4)
    for ours, theirs in zip(got, want):
        theirs = np.asarray(theirs)
        assert tuple(ours.shape) == theirs.shape
        if ours.dtype == torch.int32:
            np.testing.assert_array_equal(ours.numpy(), theirs)
        else:
            np.testing.assert_allclose(ours.numpy(), theirs, rtol=0,
                                       atol=ATOL)
    # on a CPU tensor the wrapper runs exactly the plain version
    for a, b in zip(pcc_topk_tiles(u, j_start, dev_hi, **kw), got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("grid", [False, True])
@pytest.mark.parametrize("kk", [7, 65, 256])
def test_topk_plain_matches_interpret_pallas_on_exact_ties(grid, kk):
    """Small integer samples, taken as the operands themselves: every
    product is exact in any order, so |v| ties exactly and with both signs
    all over each row, and the plain version's state (the order the CUDA
    select must reproduce slot for slot) equals the reference's bit for
    bit, for kk below and above the kernel's 64-entry partial lists."""
    rng = np.random.default_rng(kk + grid)
    t, l_blk, n, n_cols = 16, 4, 150, 90
    u = rng.integers(-2, 3, size=(160, 12)).astype(np.float32)
    u[n:] = 0.0
    v = rng.integers(-2, 3, size=(96, 12)).astype(np.float32) if grid else None
    if grid:
        v[n_cols:] = 0.0
    m = u.shape[0] // t
    gc = v.shape[0] // t if grid else None
    total = m * gc if grid else m * (m + 1) // 2
    kw = dict(t=t, l_blk=l_blk, pass_tiles=total, kk=kk,
              n_cols_valid=n_cols if grid else n, symmetric_problem=not grid,
              grid_cols=gc)
    want = ref_topk_tiles(jnp.asarray(u), 0, total, interpret=True,
                          v_pad=None if v is None else jnp.asarray(v), **kw)
    got = pcc_topk_tiles_plain(torch.from_numpy(u), 0, total,
                               v_pad=None if v is None
                               else torch.from_numpy(v), **kw)
    assert len(got) == len(want) == (2 if grid else 4)
    for ours, theirs in zip(got, want):
        theirs = np.asarray(theirs)
        assert ours.numpy().tobytes() == theirs.astype(
            ours.numpy().dtype).tobytes()
    vals, cols = got[0], got[1]
    held = cols >= 0
    # row block 0 ranks every column: kk entries, or all its candidates
    assert int(held[0].sum(dim=-1).min()) == min(
        kk, n_cols if grid else n - 1)
    # ties of both signs do occur among the entries held
    a = vals[held].abs()
    assert a.unique().numel() < a.numel() // 4
    assert bool((vals[held] > 0).any()) and bool((vals[held] < 0).any())


# -- the two kernels' plain versions: select to scratch, merge to state ------

PLAIN_SHAPES = [  # t, l_blk, j_start, pass_tiles, short, kk
    (8, 8, 0, 10 ** 6, 0, 4),     # the whole workload in one launch
    (8, 8, 3, 5, 0, 3),           # j_start > 0, mid range
    (8, 8, 2, 6, 2, 6),           # dev_hi below the launch's end
    (16, 16, 0, 10 ** 6, 0, 40),  # kk above every row's valid partners
    (16, 8, 1, 4, 1, 2),          # clamped slots past the end
]


def _port_operands(grid, t, l_blk, ties=False, seed=0, n=N, n_cols=N_COLS):
    """Prepared operands and epilogue of the module's data, or, with
    `ties`, n and n_cols rows of small integer samples taken as they are
    (exact products, so |v| ties exactly and with both signs)."""
    if ties:
        rng = np.random.default_rng(seed)
        n_pad, c_pad = -(-n // t) * t, -(-n_cols // t) * t
        u = rng.integers(-2, 3, size=(n_pad, 16)).astype(np.float32)
        u[n:] = 0.0
        v = rng.integers(-2, 3, size=(c_pad, 16)).astype(np.float32)
        v[n_cols:] = 0.0
        u, v = torch.from_numpy(u), torch.from_numpy(v)
        return u, (v if grid else None), EpilogueSpec(div=3.0)
    x, y = _data()
    plan = ExecutionPlan.create(N, L, n_cols=N_COLS if grid else None, t=t,
                                l_blk=l_blk)
    if grid:
        u, v = plan.prepare_pair(torch.from_numpy(x), torch.from_numpy(y))
    else:
        u, v = plan.prepare(torch.from_numpy(x)), None
    return u, v, plan.epilogue_spec


def _plain_args(u, v, grid, t, l_blk, j_start, pass_tiles, short, kk, spec):
    m = u.shape[0] // t
    gc = v.shape[0] // t if grid else None
    total = m * gc if grid else m * (m + 1) // 2
    pass_tiles = min(pass_tiles, total - j_start + (2 if short else 0))
    dev_hi = min(total, j_start + pass_tiles - short)
    kw = dict(t=t, l_blk=l_blk, pass_tiles=pass_tiles, kk=kk,
              n_cols_valid=N_COLS if grid else N, symmetric_problem=not grid,
              epilogue=spec, v_pad=v, grid_cols=gc)
    return m, gc, dev_hi, kw


def _same_bits(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.numpy().tobytes() == b.numpy().tobytes()


@pytest.mark.parametrize("grid", [False, True])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("t,l_blk,j_start,pass_tiles,short,kk", PLAIN_SHAPES)
def test_plain_select_then_merge_equals_fold(grid, ties, t, l_blk, j_start,
                                            pass_tiles, short, kk):
    """The select kernel's plain version to the pass scratch, then the merge
    kernel's plain version, gives the state of ranking the whole tiles
    (topk_fold_plain, so pcc_topk_tiles_plain, which the reference holds
    above) bit for bit: each 64-wide block's top-min(kk, 64) holds every
    candidate of the row's top-kk."""
    u, v, spec = _port_operands(grid, t, l_blk, ties)
    m, gc, dev_hi, kw = _plain_args(u, v, grid, t, l_blk, j_start,
                                    pass_tiles, short, kk, spec)
    scratch = topk_select_plain(u, j_start, dev_hi, **kw)
    got = topk_merge_plain(scratch, j_start, dev_hi, m=m, t=t,
                           pass_tiles=kw["pass_tiles"], kk=kk, grid_cols=gc)
    n_valid = dev_hi - j_start
    tiles = pcc_tiles_plain(u, j_start, t=t, l_blk=l_blk,
                            pass_tiles=n_valid, epilogue=spec, v_pad=v,
                            grid_cols=gc) if n_valid > 0 else None
    fold = topk_fold_plain(tiles, j_start, m=m, t=t, kk=kk,
                           n_cols_valid=kw["n_cols_valid"],
                           symmetric_problem=not grid, grid_cols=gc,
                           device="cpu")
    _same_bits(got, fold)
    _same_bits(got, pcc_topk_tiles_plain(u, j_start, dev_hi, **kw))


@pytest.mark.parametrize("grid", [False, True])
@pytest.mark.parametrize("t,kk", [(8, 3), (16, 40), (96, 70), (70, 1)])
def test_plain_select_scratch_contract(grid, t, kk):
    """The scratch every select fills, slot for slot: per side (pass_tiles,
    t, ceil(t/64), min(kk, 64)); each list is its line's top of one 64-wide
    block of candidates in canonical order (|v| descending, column
    ascending), masked entries (value 0, column -1) last; valid columns lie
    in the list's block of the tile and are never the row itself; the
    lists the merge does not read are masked."""
    n, n_cols = 10 * t - 3, 7 * t + 5     # both cut inside a block
    u, v, spec = _port_operands(grid, t, 4, ties=True, seed=t + kk, n=n,
                                n_cols=n_cols)
    m = u.shape[0] // t
    gc = v.shape[0] // t if grid else None
    total = m * gc if grid else m * (m + 1) // 2
    dev_hi = total - 1
    kw = dict(t=t, l_blk=4, pass_tiles=total, kk=kk,
              n_cols_valid=n_cols if grid else n, symmetric_problem=not grid,
              epilogue=spec, v_pad=v, grid_cols=gc)
    scratch = topk_select_plain(u, 0, dev_hi, **kw)
    nb, kc = -(-t // CTA_BLOCK), min(kk, CTA_BLOCK)
    assert len(scratch) == (2 if grid else 4)
    assert all(x.shape == (total, t, nb, kc) for x in scratch)
    ids = np.arange(total)
    ys, xs = np.divmod(ids, gc) if grid else job_coord_batch(m, ids)
    for side in range(len(scratch) // 2):
        vals, cols = scratch[2 * side].numpy(), scratch[2 * side + 1].numpy()
        ok = cols >= 0
        assert (vals[~ok] == 0).all()
        # valid entries first, then canonical order within the valid ones
        assert (ok[..., 1:] <= ok[..., :-1]).all()
        a = np.abs(vals)
        later = ok[..., 1:]
        assert (a[..., 1:][later] <= a[..., :-1][later]).all()
        tie = later & (a[..., 1:] == a[..., :-1])
        assert (cols[..., 1:][tie] > cols[..., :-1][tie]).all()
        line_blk = (ys if side == 1 else xs)[:, None, None, None] * t
        blk = np.arange(nb)[None, None, :, None] * CTA_BLOCK
        rel = cols - line_blk - blk
        assert ((rel >= 0) & (rel < CTA_BLOCK))[ok].all()
        if side == 0 and not grid:
            own = ys[:, None, None, None] * t + np.arange(t)[None, :, None,
                                                             None]
            assert (cols != own)[ok].all()
        assert not ok[dev_hi:].any()           # slots past dev_hi
        if side == 1:
            assert not ok[ys == xs].any()      # diagonal tiles' columns
        assert ok[:dev_hi].any()


@pytest.mark.parametrize("grid", [False, True])
@pytest.mark.parametrize("kk", [1, 7, 33, 70])
@pytest.mark.parametrize("data", ["ties", "equal"])
def test_plain_merge_is_the_canonical_merge(grid, kk, data):
    """topk_merge_plain against the sinks' canonical merge
    (topk_merge_rows, bitwise the reference's) fed every valid scratch
    entry of each output row, on scratch with exact ties of both signs
    ("ties"), or with every |v| equal ("equal": +-1 samples over one
    sample, so the columns alone order them), and masked entries."""
    t = 16
    rng = np.random.default_rng(kk + 2 * grid)
    rows, cols_ = -(-N // t) * t, -(-N_COLS // t) * t
    width = 12 if data == "ties" else 1
    lo, hi = (-2, 3) if data == "ties" else (0, 2)
    def draw(r, n):
        x = rng.integers(lo, hi, size=(r, width)).astype(np.float32)
        x = 2 * x - 1 if data == "equal" else x
        x[n:] = 0.0
        return torch.from_numpy(x)
    u = draw(rows, N)
    v = draw(cols_, N_COLS) if grid else None
    m = rows // t
    gc = cols_ // t if grid else None
    total = m * gc if grid else m * (m + 1) // 2
    j0, pt = 1, total - 1
    kw = dict(t=t, l_blk=width if data == "equal" else 4, pass_tiles=pt,
              kk=kk, n_cols_valid=N_COLS if grid else N,
              symmetric_problem=not grid, v_pad=v, grid_cols=gc)
    scratch = topk_select_plain(u, j0, total, **kw)
    got = topk_merge_plain(scratch, j0, total, m=m, t=t, pass_tiles=pt,
                           kk=kk, grid_cols=gc)
    ids = j0 + np.arange(pt)
    ys, xs = np.divmod(ids, gc) if grid else job_coord_batch(m, ids)
    for side in range(len(scratch) // 2):
        pv = scratch[2 * side].numpy()
        pc = scratch[2 * side + 1].numpy()
        owner = ys if side == 0 else xs
        slot, line, b, e = np.nonzero(pc >= 0)
        r_ids = owner[slot] * t + line
        vals = np.zeros((rows, kk), np.float32)
        idx = np.full((rows, kk), -1, np.int64)
        topk_merge_rows(vals, idx, r_ids, pc[slot, line, b, e].astype(
            np.int64), pv[slot, line, b, e], kk)
        assert got[2 * side].numpy().reshape(rows, kk).tobytes() == \
            vals.tobytes()
        np.testing.assert_array_equal(
            got[2 * side + 1].numpy().reshape(rows, kk), idx)
    # the candidates of the data rows are what the data promises
    vals = scratch[0][scratch[1] >= 0]
    vals = vals[vals != 0] if data == "equal" else vals   # padding rows
    a = vals.abs()
    assert a.unique().numel() == 1 if data == "equal" else \
        a.unique().numel() < a.numel()     # exact ties
    assert bool((vals < 0).any()) and bool((vals > 0).any())


def fold_case(m, t, kk, n_states, seed):
    """n_states (values, columns) states of (m, t, kk), each a row's
    canonical top-kk of candidates with columns of its own (ties of |v|
    across states and signs), and every candidate as (rows, cols, vals)."""
    rng = np.random.default_rng(seed)
    rows_n = m * t
    states, cands = [], ([], [], [])
    for s in range(n_states):
        n_c = int(rng.integers(0, 2 * kk + 2))
        r_ids = np.repeat(np.arange(rows_n), n_c)
        c_ids = np.tile(s + n_states * np.arange(n_c), rows_n)
        v = (rng.integers(-4, 5, r_ids.size) / 4).astype(np.float32)
        vals = np.zeros((rows_n, kk), np.float32)
        idx = np.full((rows_n, kk), -1, np.int64)
        topk_merge_rows(vals, idx, r_ids, c_ids, v, kk)
        states.append((torch.from_numpy(vals.reshape(m, t, kk)),
                       torch.from_numpy(idx.astype(np.int32)
                                        .reshape(m, t, kk))))
        for out, a in zip(cands, (r_ids, c_ids, v)):
            out.append(a)
    return states, [np.concatenate(a) for a in cands]


@pytest.mark.parametrize("t", [8, 16, 128])
@pytest.mark.parametrize("kk", [1, 7, 33, 70])
@pytest.mark.parametrize("n_states", [2, 3, 5])
def test_fold_states_is_the_canonical_merge(t, kk, n_states):
    """topk_fold_states (on the CPU: the merge's plain version over the
    states laid out as a pass scratch) is the canonical merge of every
    candidate the states saw: folding a mesh's rank states on the card
    and merging the result on the host is bitwise merging each state."""
    m = 3
    states, (r_ids, c_ids, v) = fold_case(m, t, kk, n_states,
                                          seed=t + kk + n_states)
    got_v, got_c = topk_fold_states(states)
    vals = np.zeros((m * t, kk), np.float32)
    idx = np.full((m * t, kk), -1, np.int64)
    topk_merge_rows(vals, idx, r_ids, c_ids, v, kk)
    assert got_v.numpy().reshape(m * t, kk).tobytes() == vals.tobytes()
    np.testing.assert_array_equal(got_c.numpy().reshape(m * t, kk), idx)


@pytest.mark.parametrize("grid", [False, True])
def test_topk_kernel_wrappers_run_plain_on_cpu(grid):
    """On CPU tensors the select and merge wrappers run their plain
    versions, and the two give pcc_topk_tiles' state."""
    u, v, spec = _port_operands(grid, 8, 8)
    m, gc, dev_hi, kw = _plain_args(u, v, grid, 8, 8, 2, 9, 1, 5, spec)
    scratch = topk_select(u, 2, dev_hi, **kw)
    _same_bits(scratch, topk_select_plain(u, 2, dev_hi, **kw))
    mkw = dict(m=m, t=8, pass_tiles=kw["pass_tiles"], kk=5, grid_cols=gc)
    got = topk_merge(scratch, 2, dev_hi, **mkw)
    _same_bits(got, topk_merge_plain(scratch, 2, dev_hi, **mkw))
    _same_bits(got, pcc_topk_tiles(u, 2, dev_hi, **kw))


def test_topk_wrapper_checks_its_arguments():
    u = torch.zeros(32, 8)
    kw = dict(t=8, l_blk=8, pass_tiles=3, n_cols_valid=30)
    with pytest.raises(ValueError, match="kk"):
        pcc_topk_tiles(u, 0, 10, kk=0, **kw)
    with pytest.raises(ValueError, match="kk"):
        pcc_topk_tiles(u, 0, 10, kk=KK_MAX + 1, **kw)
    with pytest.raises(ValueError, match="dev_hi"):
        pcc_topk_tiles(u, 0, 11, kk=3, **kw)     # 10 tiles in the triangle
    with pytest.raises(ValueError, match="n_cols_valid"):
        pcc_topk_tiles(u, 0, 10, kk=3, **{**kw, "n_cols_valid": 33})
    with pytest.raises(ValueError, match="float32"):
        pcc_topk_tiles(u.double(), 0, 10, kk=3, **kw)
    with pytest.raises(NotImplementedError, match="slice 5"):
        pcc_topk_tiles(u, 0, 10, kk=3, v_pad=u, **kw)


# -- the sinks ----------------------------------------------------------------


@pytest.mark.parametrize("grid", [False, True])
@pytest.mark.parametrize("k,t,l_blk,mtp", [(3, 8, 8, 4), (7, 16, 8, 1),
                                           (25, 8, 16, None)])
def test_topk_sinks_match_reference(grid, k, t, l_blk, mtp):
    x, y = _data()
    kw = dict(t=t, l_blk=l_blk, max_tiles_per_pass=mtp)
    yy = y if grid else None
    got = corr(x, yy, sink=DeviceTopKSink(k), device="cpu", **kw)
    want = ref_corr(jnp.asarray(x), None if yy is None else jnp.asarray(yy),
                    sink=RefDeviceTopKSink(k), **kw)
    np.testing.assert_array_equal(got["indices"], np.asarray(want["indices"]))
    np.testing.assert_allclose(got["values"], np.asarray(want["values"]),
                               rtol=0, atol=ATOL)
    host = corr(x, yy, sink=TopKSink(k), device="cpu", **kw)
    ref_host = ref_corr(jnp.asarray(x),
                        None if yy is None else jnp.asarray(yy),
                        sink=RefTopKSink(k), **kw)
    np.testing.assert_array_equal(host["indices"],
                                  np.asarray(ref_host["indices"]))
    # inside the port the two sinks agree bit for bit
    np.testing.assert_array_equal(got["indices"], host["indices"])
    assert got["values"].tobytes() == host["values"].tobytes()
    assert got["indices"].dtype == np.int64 and got["values"].dtype == \
        np.float32
    assert got["indices"].shape == (N, k)
    rows_short = (got["indices"] < 0).any(axis=1)
    assert rows_short.any() == (k > (N_COLS if grid else N - 1))


@pytest.mark.parametrize("grid", [False, True])
def test_device_topk_result_independent_of_pass_split(grid):
    x, y = _data()
    yy = y if grid else None
    base = corr(x, yy, sink=DeviceTopKSink(5), t=8, l_blk=8, device="cpu")
    for mtp in (1, 2, 7, 1000):
        got = corr(x, yy, sink=DeviceTopKSink(5), t=8, l_blk=8,
                   max_tiles_per_pass=mtp, device="cpu")
        np.testing.assert_array_equal(got["indices"], base["indices"])
        assert got["values"].tobytes() == base["values"].tobytes()


def test_device_topk_supports_predicate_and_refusals():
    x, _ = _data()
    plan = ExecutionPlan.create(N, L, t=8, l_blk=8)
    assert DeviceTopKSink.supports(plan)
    unfused = ExecutionPlan.create(N, L, t=8, l_blk=8, fuse_epilogue=False)
    assert not DeviceTopKSink.supports(unfused)
    with pytest.raises(ValueError, match="fused epilogue"):
        DeviceTopKSink(3).open(unfused, torch.device("cpu"))
    u = unfused.prepare(torch.from_numpy(x))
    with pytest.raises(ValueError, match="fused epilogue"):
        execute_plan(unfused, u, sink=DeviceTopKSink(3), device="cpu")
    # TopKSink ranks the finalised tiles of an unfused run as well
    got = execute_plan(unfused, u, sink=TopKSink(3), device="cpu")
    want = corr(x, sink=TopKSink(3), t=8, l_blk=8, device="cpu")
    np.testing.assert_array_equal(got["indices"], want["indices"])
    with pytest.raises(ValueError):
        TopKSink(0)
    assert DeviceTopKSink.wants_device_state and DeviceTopKSink.merge_dedups
