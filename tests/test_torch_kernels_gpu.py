"""The CUDA kernels on the card: each held against its plain version, and
the main paths against their CPU runs.  Every test here needs an NVIDIA GPU
(marker ``gpu``) and skips without one; this file imports no JAX, so it runs
on a GPU host with only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core.api import corr
from repro_torch.core.mapping import grid_job_coord_batch, job_coord_batch
from repro_torch.core.pcc import transform
from repro_torch.core.plan import pad_operands, pad_scales
from repro_torch.core.quantize import quantize_rows
from repro_torch.core.allpairs import assemble_from_stream, stream_tiles
from repro_torch.core.api import clear_prepared_cache, prepared_cache_stats
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.sinks import (DeviceTopKSink, EdgeCountSink,
                                    ReductionSink, RowBlockSink, TopKSink)
from repro_torch.kernels.narrow_gate import (FAULT_SHARE, gate_share,
                                             narrow_gate,
                                             planted_fault_shares)
from repro_torch.kernels.pcc_tile import (EpilogueSpec, pcc_tiles,
                                          pcc_tiles_plain, pcc_topk_tiles,
                                          pcc_topk_tiles_plain,
                                          topk_fold_plain, topk_merge,
                                          topk_merge_plain, topk_select,
                                          topk_select_plain)

# same products, two float32 summation orders, l <= 300: the reference's
# own Pearson bound
ATOL = 3e-6


def _within_narrow_gate(u, j_start, kw, faults=True):
    """pcc_tiles' bf16 / fp8 tiles on (u, j_start, **kw) within the narrow
    gate of the plain version's (kernels/narrow_gate.py), and the
    gate refusing the planted faults by FAULT_SHARE; returns the tiles."""
    got = pcc_tiles(u, j_start, **kw)
    want = pcc_tiles_plain(u, j_start, **kw)
    gate = narrow_gate(u, j_start, **kw)
    torch.cuda.synchronize()
    assert gate_share(got, want, gate) <= 1.0
    if faults:
        shares = planted_fault_shares(u, j_start, **kw)
        assert len(shares) == 2
        assert all(f >= FAULT_SHARE for f in shares.values()), shares
    return got


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operand(n, l, t, l_blk, device, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, l)).astype(np.float32))
    return pad_operands(transform(x.to(device)), t, l_blk)


@pytest.mark.gpu
@pytest.mark.parametrize("n,l,t,l_blk,j_start,pass_tiles", [
    (37, 29, 8, 8, 0, 15),
    (37, 20, 8, 8, 13, 6),
    (300, 300, 96, 64, 1, 5),
    (600, 300, 256, 512, 2, 5),
])
@pytest.mark.parametrize("spec", [None, EpilogueSpec(clip=(-1.0, 1.0)),
                                  EpilogueSpec(div=7.0, clip=(-0.05, 0.05))])
def test_kernel_matches_plain(cuda, n, l, t, l_blk, j_start, pass_tiles,
                              spec):
    u = _operand(n, l, t, l_blk, cuda)
    before = pcc_tiles.launches
    got = pcc_tiles(u, j_start, t=t, l_blk=l_blk, pass_tiles=pass_tiles,
                    epilogue=spec)
    want = pcc_tiles_plain(u, j_start, t=t, l_blk=l_blk,
                           pass_tiles=pass_tiles, epilogue=spec)
    torch.cuda.synchronize()
    assert pcc_tiles.launches == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


@pytest.mark.gpu
def test_corr_on_card_matches_cpu_and_is_split_invariant(cuda):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((200, 90)).astype(np.float32)
    r = corr(x, t=32, l_blk=32, device=cuda)
    assert r.device.type == "cuda" and torch.equal(r, r.T)
    assert torch.equal(r, corr(x, t=32, l_blk=32, max_tiles_per_pass=4,
                               device=cuda))
    torch.testing.assert_close(r.cpu(), corr(x, t=32, l_blk=32, device="cpu"),
                               rtol=0, atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("n,n_cols,l,t,l_blk,j_start,pass_tiles", [
    (37, 21, 29, 8, 8, 0, 15),
    (37, 21, 29, 8, 8, 13, 6),       # clamped ids past the end
    (300, 170, 300, 96, 64, 1, 5),   # t not a multiple of the CTA block
    (600, 300, 300, 256, 512, 2, 4),
])
def test_grid_kernel_matches_plain(cuda, n, n_cols, l, t, l_blk, j_start,
                                   pass_tiles):
    u = _operand(n, l, t, l_blk, cuda)
    v = _operand(n_cols, l, t, l_blk, cuda, seed=1)
    gc = v.shape[0] // t
    spec = EpilogueSpec(clip=(-1.0, 1.0))
    before = pcc_tiles.launches
    got = pcc_tiles(u, j_start, t=t, l_blk=l_blk, pass_tiles=pass_tiles,
                    epilogue=spec, v_pad=v, grid_cols=gc)
    want = pcc_tiles_plain(u, j_start, t=t, l_blk=l_blk,
                           pass_tiles=pass_tiles, epilogue=spec, v_pad=v,
                           grid_cols=gc)
    torch.cuda.synchronize()
    assert pcc_tiles.launches == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


def _dense(u, v, t, grid_cols, spec):
    """The padded (rows, cols) float64 matrix the tiles cut up."""
    r = u.double() @ v.double().T
    return spec.apply(r) if spec is not None else r


def check_topk_state(got, want, dense, t, tol):
    """Hold one (vals, cols) state side of the kernel against the plain
    version's: the same masked slots, each value within `tol` of the
    float64 value at its own column, the |v| sequence within `tol`
    position by position, and the columns equal except where the two
    candidates' float64 |v| lie within 2 * tol (a near-tie).  Returns the
    number of near-ties."""
    gv, gc = got
    wv, wc = want
    assert torch.equal(gc < 0, wc < 0)
    ok = gc >= 0
    m, tt, kk = gv.shape
    rows = (torch.arange(m * tt, device=gv.device).view(m, tt, 1)
            .expand(m, tt, kk))
    d_got = dense[rows[ok], gc[ok].long()]
    d_want = dense[rows[ok], wc[ok].long()]
    assert float((gv[ok].double() - d_got).abs().max()) <= tol
    assert float((wv[ok].double() - d_want).abs().max()) <= tol
    assert float((gv[ok].abs() - wv[ok].abs()).abs().max()) <= tol
    differ = gc[ok] != wc[ok]
    gap = (d_got[differ].abs() - d_want[differ].abs()).abs()
    assert float(gap.max()) <= 2 * tol if gap.numel() else True
    return int(differ.sum())


def _dense_from_tiles(tiles, m, t, n_rows, n_cols, gc, device):
    """The (n_rows, n_cols) padded matrix that the tiles of ids 0 ..
    total-1 cut up; the triangle mirrored."""
    ids = np.arange(tiles.shape[0])
    ys, xs = (grid_job_coord_batch(m, gc, ids) if gc
              else job_coord_batch(m, ids))
    r = torch.zeros(n_rows, n_cols, device=device)
    r.view(m, t, -1, t)[torch.as_tensor(ys, device=device), :,
                        torch.as_tensor(xs, device=device), :] = tiles
    if not gc:
        r = torch.where(torch.ones_like(r, dtype=torch.bool).triu(), r, r.T)
    return r


def _topk_operands(dtype, ties, n, n_cols, l, t, l_blk, device, grid):
    """(u, v) for the top-k kernel tests: Pearson operands (float32, or
    bf16 widened from them), Kendall-like int8 signs, or, with `ties`,
    small integer samples taken as they are, whose products are exact in
    any order, so |v| ties exactly and with both signs."""
    def one(rows, seed):
        if ties:
            rng = np.random.default_rng(seed)
            x = torch.from_numpy(rng.integers(-2, 3, size=(rows, l)).astype(
                np.float32)).to(device)
            x = x.to(torch.int8 if dtype == "int8" else getattr(torch, dtype))
            return pad_operands(x, t, l_blk)
        if dtype == "int8":
            return pad_operands(_signs(rows, l, device, seed), t, l_blk)
        return _operand(rows, l, t, l_blk, device, seed).to(
            getattr(torch, dtype))
    u = one(n, 0)
    return u, (one(n_cols, 1) if grid else u)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "int8", "bfloat16"])
@pytest.mark.parametrize("grid", [False, True])
@pytest.mark.parametrize("kk", [1, 10, 32, 33, 64, 65, 256])
@pytest.mark.parametrize("n,n_cols,l,t,l_blk,j_start,pass_tiles,short,ties", [
    (70, 45, 29, 8, 8, 0, 200, 0, False),    # whole workload, one pass
    (70, 45, 29, 8, 8, 7, 11, 3, False),     # mid range, dev_hi below end
    (300, 170, 300, 64, 64, 2, 9, 0, False),
    (600, 330, 300, 256, 512, 1, 5, 1, False),
    (300, 170, 40, 64, 8, 0, 200, 0, True),  # exact ties of both signs
    (400, 300, 24, 96, 8, 1, 50, 2, True),   # ties, t past one 64 block
    # t = 128 and 192: 128-blocks partly past the tile (t = 192), the
    # valid rows and columns cut inside a 64-block
    (700, 450, 40, 128, 8, 0, 200, 0, False),
    (500, 333, 50, 192, 16, 1, 200, 1, True),
    # 125 row blocks: each row merges many chunks of lists once full
    (2000, 1500, 24, 16, 8, 0, 20_000, 0, False),
])
def test_topk_kernel_matches_plain(cuda, dtype, grid, kk, n, n_cols, l, t,
                                   l_blk, j_start, pass_tiles, short, ties):
    """The float32, int8 and bf16 selects (and the merge) against the plain
    version, for kk below and above the 64-entry partial lists (kc capped
    at 64) and on both sides of the select's extraction / rank-counting
    edge (kc 32 / 33): the state is bitwise the plain ranking of
    pcc_tiles' own tiles (so its values are those tiles' bits and its
    order canonical), and within ATOL of the plain version's state
    (float32), or bitwise it (int8, and exact ties in every dtype)."""
    u, v = _topk_operands(dtype, ties, n, n_cols, l, t, l_blk, cuda, grid)
    m = u.shape[0] // t
    gc = v.shape[0] // t if grid else None
    total = m * gc if grid else m * (m + 1) // 2
    pass_tiles = min(pass_tiles, total - j_start)
    dev_hi = j_start + pass_tiles - short
    spec = (EpilogueSpec(div=3.0) if ties
            else EpilogueSpec(clip=(-1.0, 1.0)))
    kw = dict(t=t, l_blk=l_blk, pass_tiles=pass_tiles, kk=kk,
              n_cols_valid=n_cols if grid else n, symmetric_problem=not grid,
              epilogue=spec, v_pad=v if grid else None, grid_cols=gc)
    before = dict(pcc_topk_tiles.launches)
    before_dtype = dict(pcc_topk_tiles.select_by_dtype)
    got = pcc_topk_tiles(u, j_start, dev_hi, **kw)
    want = pcc_topk_tiles_plain(u, j_start, dev_hi, **kw)
    torch.cuda.synchronize()
    assert pcc_topk_tiles.launches == {k: c + 1 for k, c in before.items()}
    assert pcc_topk_tiles.select_by_dtype[dtype] == before_dtype[dtype] + 1
    assert len(got) == (2 if grid else 4)
    # the plain ranking of the kernel's own tiles, bit for bit
    tiles = pcc_tiles(u, j_start, t=t, l_blk=l_blk,
                      pass_tiles=dev_hi - j_start, epilogue=spec,
                      v_pad=v if grid else None, grid_cols=gc)
    fold = topk_fold_plain(tiles, j_start, m=m, t=t, kk=kk,
                           n_cols_valid=kw["n_cols_valid"],
                           symmetric_problem=not grid, grid_cols=gc,
                           device=cuda)
    assert all(torch.equal(a, b) for a, b in zip(got, fold))
    if ties or dtype == "int8":
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    elif dtype == "float32":
        dense = _dense(u, v, t, gc, spec)
        for side in range(len(got) // 2):
            check_topk_state(got[2 * side:2 * side + 2],
                             want[2 * side:2 * side + 2],
                             dense if side == 0 else dense.T, t, ATOL)
    # the kernel's values are bitwise those of pcc_tiles for the same tiles
    tiles = pcc_tiles(u, 0, t=t, l_blk=l_blk, pass_tiles=total,
                      epilogue=spec, v_pad=v if grid else None, grid_cols=gc)
    r = _dense_from_tiles(tiles, m, t, u.shape[0], v.shape[0], gc, cuda)
    for side in range(len(got) // 2):
        vals, cols = got[2 * side], got[2 * side + 1]
        ok = cols >= 0
        rows = (torch.arange(vals.shape[0] * t, device=cuda)
                .view(-1, t, 1).expand_as(cols))
        ref = (r if side == 0 else r.T)[rows[ok], cols[ok].long()]
        assert torch.equal(vals[ok], ref)


def _tie_operands(data, n, n_cols, t, width, seed, device, grid):
    """Operands whose tiles are exact in every order: small integers
    ("ties": |v| ties exactly, with both signs), or +-1 over one sample
    ("equal": every |v| is 1, so the columns alone order a row); rows past
    n and n_cols are zero."""
    rng = np.random.default_rng(seed)
    def one(rows, valid):
        pad = -(-rows // t) * t
        if data == "equal":
            x = 2.0 * rng.integers(0, 2, size=(pad, width)) - 1.0
        else:
            x = rng.integers(-2, 3, size=(pad, width)).astype(np.float64)
        x[valid:] = 0.0
        return torch.from_numpy(x.astype(np.float32)).to(device)
    u = one(n, n)
    return u, (one(n_cols, n_cols) if grid else None)


@pytest.mark.gpu
@pytest.mark.parametrize("grid", [False, True])
@pytest.mark.parametrize("kk", [1, 10, 32, 33, 64, 65, 256])
@pytest.mark.parametrize("data", ["ties", "equal"])
def test_topk_merge_kernel_bitwise_plain_merge(cuda, grid, kk, data):
    """The merge kernel alone against topk_merge_plain on the same pass
    scratch (the select's plain version, on the card), bit for bit:
    exact ties of both signs, every |v| equal, masked entries (t = 40
    leaves 24 of each list's 64 candidates masked, and the valid rows and
    columns end inside a tile), kk from 1 to 256, a whole pass and a pass
    inside the tile range with dev_hi short of its end."""
    t, width = 40, (12 if data == "ties" else 1)
    n, n_cols = 1_000, 700
    u, v = _tie_operands(data, n, n_cols, t, width, kk, cuda, grid)
    m = u.shape[0] // t
    gc = v.shape[0] // t if grid else None
    total = m * gc if grid else m * (m + 1) // 2
    empty = False
    for j0, pt, short in ((0, total, 0), (total // 3, total // 2, 5)):
        dev_hi = j0 + pt - short
        kw = dict(t=t, l_blk=width if data == "equal" else 4, pass_tiles=pt,
                  kk=kk, n_cols_valid=n_cols if grid else n,
                  symmetric_problem=not grid, epilogue=EpilogueSpec(div=3.0),
                  v_pad=v, grid_cols=gc)
        scratch = topk_select_plain(u, j0, dev_hi, **kw)
        mkw = dict(m=m, t=t, pass_tiles=pt, kk=kk, grid_cols=gc)
        before = pcc_topk_tiles.launches["merge"]
        got = topk_merge(scratch, j0, dev_hi, **mkw)
        want = topk_merge_plain(scratch, j0, dev_hi, **mkw)
        torch.cuda.synchronize()
        assert pcc_topk_tiles.launches["merge"] == before + 1
        assert len(got) == len(want) == (2 if grid else 4)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        held = got[1] >= 0
        assert bool(held.any())
        empty |= bool((~held).any())
        if data == "equal":      # the data rows' entries: +-1 / 3 each
            vals = got[0].reshape(-1, kk)[:n]
            rows_held = held.reshape(-1, kk)[:n]
            assert bool((vals[rows_held].abs()
                         == float(np.float32(1) / np.float32(3))).all())
    assert empty              # rows short of kk entries, or of any tile


@pytest.mark.gpu
@pytest.mark.parametrize("kk", [1, 10, 70])
@pytest.mark.parametrize("n_states", [2, 4])
def test_topk_fold_states_kernel_bitwise_plain(cuda, kk, n_states):
    """The merge kernel folding rank states (a mesh's DeviceTopKSink) is
    bitwise its plain version on the same states."""
    from repro_torch.kernels.pcc_tile import topk_fold_states

    rng = np.random.default_rng(kk + n_states)
    m, t = 5, 256
    states = []
    for s in range(n_states):
        v = torch.from_numpy(
            (rng.integers(-8, 9, (m * t, kk)) / 8).astype(np.float32))
        c = torch.from_numpy(
            (s + n_states * np.arange(kk))[None].repeat(m * t, 0)
            .astype(np.int32))
        key = torch.where(c < 0, -torch.inf, v.abs())
        order = torch.argsort(-key, dim=1, stable=True)
        v, c = v.gather(1, order), c.gather(1, order)
        c[:, kk - kk // 3:] = -1     # masked entries last
        v[c < 0] = 0.0
        states.append((v.reshape(m, t, kk), c.reshape(m, t, kk)))
    want = topk_fold_states(states)
    got = topk_fold_states([(a.to(cuda), b.to(cuda)) for a, b in states])
    for g, w in zip(got, want):
        assert g.cpu().numpy().tobytes() == w.numpy().tobytes()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "int8", "bfloat16"])
@pytest.mark.parametrize("grid", [False, True])
@pytest.mark.parametrize("kk", [1, 10, 32, 33, 64, 65])
def test_topk_select_kernel_scratch_bitwise_plain(cuda, dtype, grid, kk):
    """Each select kernel's pass scratch, list for list, against
    topk_select_plain's on exact tiles: every list the merge reads (the
    valid slots' rows; on the triangle, the off-diagonal slots' columns)
    holds the same entries in the same slots, by extraction (kc <= 32) and
    by rank counting (kc > 32), with t = 192 (the 128-blocks' second half
    past the tile) and the valid rows and columns cut inside a 64-block."""
    t, n, n_cols = 192, 500, 333
    u, v = _tie_operands("ties", n, n_cols, t, 16, kk + 7, cuda, grid)
    cast = torch.int8 if dtype == "int8" else getattr(torch, dtype)
    u = u.to(cast)
    v = v.to(cast) if grid else None
    m = u.shape[0] // t
    gc = v.shape[0] // t if grid else None
    total = m * gc if grid else m * (m + 1) // 2
    j0, pt = 1, total - 1
    dev_hi = total - 1
    kw = dict(t=t, l_blk=16, pass_tiles=pt, kk=kk,
              n_cols_valid=n_cols if grid else n, symmetric_problem=not grid,
              epilogue=EpilogueSpec(div=3.0), v_pad=v, grid_cols=gc)
    before = pcc_topk_tiles.select_by_dtype[dtype]
    got = topk_select(u, j0, dev_hi, **kw)
    want = topk_select_plain(u, j0, dev_hi, **kw)
    torch.cuda.synchronize()
    assert pcc_topk_tiles.select_by_dtype[dtype] == before + 1
    n_valid = dev_hi - j0
    ids = j0 + np.arange(n_valid)
    ys, xs = (np.divmod(ids, gc) if grid else job_coord_batch(m, ids))
    read = [torch.ones(n_valid, dtype=torch.bool, device=cuda),
            torch.as_tensor(ys != xs, device=cuda)]
    for side in range(len(got) // 2):
        for a, b in zip(got[2 * side:2 * side + 2],
                        want[2 * side:2 * side + 2]):
            a, b = a[:n_valid][read[side]], b[:n_valid][read[side]]
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert bool((got[1][:n_valid] >= 0).any())


@pytest.mark.gpu
@pytest.mark.parametrize("n,l,t,l_blk", [
    (300, 50, 96, 5),     # t below one 128-row block, l_pad 50
    (260, 90, 130, 6),    # t two rows past a block, l_pad 90
    (300, 70, 200, 10),   # l_pad 70
    (129, 33, 129, 3),    # odd t (scalar stores), odd l_pad
])
def test_f32_ragged_tiles_and_unaligned_samples(cuda, n, l, t, l_blk):
    """The float32 kernel's 128 x 128 blocks on t not a multiple of 128,
    and sample axes whose rows break 16-byte strides (its 4-byte copies
    take them as they are): triangle, triangle with a second operand, grid
    and replica tiles within ATOL of plain, bitwise across pass splits and
    against 2-D launches; the float32 select's values (its 128 x 128 blocks)
    bitwise these tiles."""
    u = _operand(n, l, t, l_blk, cuda)
    u2 = _operand(n, l, t, l_blk, cuda, seed=2)
    v = _operand(n // 2 + 3, l, t, l_blk, cuda, seed=1)
    assert u.shape[1] % 4      # rows of l_pad * 4 bytes, not 16-aligned
    m = u.shape[0] // t
    spec = EpilogueSpec(div=3.0, clip=(-1.0, 1.0))
    for gc, vv in ((None, None), (None, u2), (v.shape[0] // t, v)):
        total = m * gc if gc else m * (m + 1) // 2
        kw = dict(t=t, l_blk=l_blk, epilogue=spec, v_pad=vv, grid_cols=gc)
        before = pcc_tiles.launches_by_dtype["float32"]
        got = pcc_tiles(u, 0, pass_tiles=total, **kw)
        want = pcc_tiles_plain(u, 0, pass_tiles=total, **kw)
        torch.cuda.synchronize()
        assert pcc_tiles.launches_by_dtype["float32"] == before + 1
        torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
        parts = torch.cat([pcc_tiles(u, j, pass_tiles=min(2, total - j),
                                     **kw) for j in range(0, total, 2)])
        assert torch.equal(got, parts)
        if vv is u2:
            continue                   # the select takes no second operand
        cols = (v if gc else u).shape[0]
        tk = pcc_topk_tiles(u, 0, total, pass_tiles=total, kk=5,
                            n_cols_valid=cols, symmetric_problem=gc is None,
                            **kw)
        r = _dense_from_tiles(got, m, t, u.shape[0], cols, gc, cuda)
        for side in range(len(tk) // 2):
            vals, cc = tk[2 * side], tk[2 * side + 1]
            ok = cc >= 0
            rows = (torch.arange(vals.shape[0] * t, device=cuda)
                    .view(-1, t, 1).expand_as(cc))
            assert torch.equal(vals[ok], (r if side == 0 else r.T)[
                rows[ok], cc[ok].long()])
    # replica stacks on the grid and on the triangle
    for gc, stack in ((v.shape[0] // t, torch.stack([v, v.flip(0)])),
                      (None, torch.stack([u2, u, u2]))):
        kw = dict(t=t, l_blk=l_blk, pass_tiles=3, epilogue=spec,
                  grid_cols=gc)
        got = pcc_tiles(u, 1, v_pad=stack, **kw)
        want = pcc_tiles_plain(u, 1, v_pad=stack, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
        for r_ in range(stack.shape[0]):
            assert torch.equal(got[r_], pcc_tiles(u, 1, v_pad=stack[r_],
                                                  **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("n_cols", [None, 150])
def test_device_topk_sink_bit_identical_to_topk_sink_on_card(cuda, n_cols):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((200, 90)).astype(np.float32)
    y = (None if n_cols is None
         else rng.standard_normal((n_cols, 90)).astype(np.float32))
    for mtp in (None, 3):
        kw = dict(t=32, l_blk=32, max_tiles_per_pass=mtp, device=cuda)
        before = dict(pcc_topk_tiles.launches)
        got = corr(x, y, sink=DeviceTopKSink(7), **kw)
        assert pcc_topk_tiles.launches["select"] > before["select"]
        want = corr(x, y, sink=TopKSink(7), **kw)
        np.testing.assert_array_equal(got["indices"], want["indices"])
        np.testing.assert_array_equal(got["values"], want["values"])
    r = corr(x, y, t=32, l_blk=32, device=cuda)
    torch.testing.assert_close(r.cpu(), corr(x, y, t=32, l_blk=32,
                                              device="cpu"),
                               rtol=0, atol=ATOL)


def _signs(n, width, device, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-1, 2, size=(n, width)).astype(
        np.int8)).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("grid", [False, True])
@pytest.mark.parametrize("n,l,t,l_blk,j_start,pass_tiles", [
    (37, 29, 8, 8, 0, 15),
    (37, 20, 8, 4, 13, 6),       # l_pad not a multiple of 8
    (300, 300, 96, 64, 1, 5),
    (600, 300, 256, 512, 2, 5),
])
def test_bf16_kernel_bitwise_equals_f32_kernel_on_widened(
        cuda, grid, n, l, t, l_blk, j_start, pass_tiles):
    """bf16 tiles run on the tensor cores: within the narrow gate of the
    plain version (no longer bitwise the float32 kernel on the widened
    operand), the gate refusing the planted faults."""
    u = _operand(n, l, t, l_blk, cuda).to(torch.bfloat16)
    v = _operand(170, l, t, l_blk, cuda, seed=1).to(torch.bfloat16) \
        if grid else None
    gc = v.shape[0] // t if grid else None
    spec = EpilogueSpec(clip=(-1.0, 1.0))
    kw = dict(t=t, l_blk=l_blk, pass_tiles=pass_tiles, epilogue=spec,
              grid_cols=gc, v_pad=v)
    before = dict(pcc_tiles.launches_by_dtype)
    _within_narrow_gate(u, j_start, kw)
    assert pcc_tiles.launches_by_dtype["bfloat16"] == before["bfloat16"] + 3


@pytest.mark.gpu
@pytest.mark.parametrize("grid", [False, True])
@pytest.mark.parametrize("n,width,t,l_blk,j_start,pass_tiles", [
    (37, 28, 8, 4, 0, 15),
    (37, 13, 8, 13, 13, 6),      # l_pad not a multiple of 4: byte loads
    (300, 2016, 96, 64, 1, 5),
    (600, 2016, 256, 512, 2, 5),
])
def test_int8_kernel_bitwise_equals_plain(cuda, grid, n, width, t, l_blk,
                                          j_start, pass_tiles):
    u = pad_operands(_signs(n, width, cuda), t, l_blk)
    v = pad_operands(_signs(170, width, cuda, seed=1), t, l_blk) \
        if grid else None
    gc = v.shape[0] // t if grid else None
    for spec in (None, EpilogueSpec(div=float(width), clip=(-1.0, 1.0))):
        kw = dict(t=t, l_blk=l_blk, pass_tiles=pass_tiles, epilogue=spec,
                  grid_cols=gc)
        before = dict(pcc_tiles.launches_by_dtype)
        got = pcc_tiles(u, j_start, v_pad=v, **kw)
        want = pcc_tiles_plain(u, j_start, v_pad=v, **kw)
        torch.cuda.synchronize()
        assert pcc_tiles.launches_by_dtype["int8"] == before["int8"] + 1
        assert torch.equal(got, want)
    # full-range bytes: the int32 sums, converted once
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.integers(-128, 128, size=(64, 1024),
                                      dtype=np.int8)).to(cuda)
    assert torch.equal(pcc_tiles(w, 0, t=32, l_blk=64, pass_tiles=3),
                       pcc_tiles_plain(w, 0, t=32, l_blk=64, pass_tiles=3))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["triangle", "grid", "pair", "scaled",
                                  "replica"])
@pytest.mark.parametrize("n,width,t,l_blk,j_start,pass_tiles", [
    (37, 200, 8, 100, 0, 15),     # l_pad 200, padded to 400 for TMA
    (300, 136, 96, 8, 1, 5),      # l_pad 136, padded to 144: 2 stages
    (130, 2016, 128, 2016, 2, 4),  # Kendall's pair columns, unpadded
])
def test_int8_tensor_core_tiles_bitwise_plain(cuda, mode, n, width, t, l_blk,
                                              j_start, pass_tiles):
    """int8 tiles run on the tensor cores (one int32 sum over the sample
    axis, converted once) and stay bitwise the plain version's in every
    mode, with sample axes that are not a multiple of the kernel's
    128-sample stage; the int8 select's values are those tiles' bits."""
    u = pad_operands(_signs(n, width, cuda), t, l_blk)
    kw = dict(t=t, l_blk=l_blk, pass_tiles=pass_tiles,
              epilogue=EpilogueSpec(div=float(width), clip=(-1.0, 1.0)))
    if mode == "grid":
        kw.update(v_pad=pad_operands(_signs(170, width, cuda, seed=1), t,
                                     l_blk), grid_cols=-(-170 // t))
    elif mode == "pair":
        kw["v_pad"] = pad_operands(_signs(n, width, cuda, seed=1), t, l_blk)
    elif mode == "scaled":
        scale = torch.rand(u.shape[0], device=cuda) + 0.5
        kw.update(row_scale=scale, col_scale=scale.flip(0).contiguous())
    elif mode == "replica":
        kw["v_pad"] = torch.stack([pad_operands(
            _signs(n, width, cuda, seed=s), t, l_blk) for s in (1, 2, 3)])
    before = dict(pcc_tiles.launches_by_dtype)
    got = pcc_tiles(u, j_start, **kw)
    want = pcc_tiles_plain(u, j_start, **kw)
    torch.cuda.synchronize()
    assert pcc_tiles.launches_by_dtype["int8"] == before["int8"] + 1
    assert torch.equal(got, want)
    if mode in ("triangle", "grid"):
        grid = mode == "grid"
        m, gc = u.shape[0] // t, kw.get("grid_cols")
        total = m * gc if grid else m * (m + 1) // 2
        kw_all = {**kw, "pass_tiles": total}
        state = pcc_topk_tiles(u, 0, total, kk=10,
                               n_cols_valid=170 if grid else n,
                               symmetric_problem=not grid, **kw_all)
        tiles = pcc_tiles(u, 0, **kw_all)
        ids = np.arange(total)
        ys, xs = (grid_job_coord_batch(m, gc, ids) if grid
                  else job_coord_batch(m, ids))
        cols_pad = kw["v_pad"].shape[0] if grid else u.shape[0]
        r = torch.zeros(u.shape[0], cols_pad, device=cuda)
        r.view(m, t, -1, t)[torch.as_tensor(ys, device=cuda), :,
                            torch.as_tensor(xs, device=cuda), :] = tiles
        if not grid:
            r = torch.where(torch.ones_like(r, dtype=torch.bool).triu(), r,
                            r.T)
        for side in range(len(state) // 2):
            vals, cols = state[2 * side], state[2 * side + 1]
            ok = cols >= 0
            rows = (torch.arange(vals.shape[0] * t, device=cuda)
                    .view(-1, t, 1).expand_as(cols))
            ref = (r if side == 0 else r.T)[rows[ok], cols[ok].long()]
            assert torch.equal(vals[ok], ref)


@pytest.mark.gpu
def test_int8_tiles_at_the_int32_edge(cuda):
    """Rows of -128 and 127 over l_pad = 131,056 <= INT8_MAX_L_PAD: the
    largest sums, 131,056 x 16,384 = 2,147,221,504, stay inside int32 and
    match the plain version's float64 sums rounded once."""
    from repro_torch.kernels.pcc_tile import INT8_MAX_L_PAD
    width = 131_056
    assert width <= INT8_MAX_L_PAD
    u = torch.full((64, width), -128, dtype=torch.int8, device=cuda)
    u[1::2] = 127
    u[5, :7] = 0
    got = pcc_tiles(u, 0, t=32, l_blk=16, pass_tiles=3)
    want = pcc_tiles_plain(u, 0, t=32, l_blk=16, pass_tiles=3)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert float(got[0, 0, 0]) == float(np.float32(width * 16_384))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("grid", [False, True])
def test_narrow_topk_values_are_pcc_tiles_bits(cuda, dtype, grid):
    if dtype == "int8":
        u = pad_operands(_signs(300, 120, cuda), 64, 64)
        v = pad_operands(_signs(170, 120, cuda, seed=1), 64, 64)
    else:
        u = _operand(300, 120, 64, 64, cuda).to(torch.bfloat16)
        v = _operand(170, 120, 64, 64, cuda, seed=1).to(torch.bfloat16)
    if not grid:
        v = None
    t, m = 64, u.shape[0] // 64
    gc = v.shape[0] // t if grid else None
    total = m * gc if grid else m * (m + 1) // 2
    spec = EpilogueSpec(div=7.0, clip=(-1.0, 1.0))
    kw = dict(t=t, l_blk=64, pass_tiles=total, kk=10,
              n_cols_valid=170 if grid else 300, symmetric_problem=not grid,
              epilogue=spec, v_pad=v, grid_cols=gc)
    before = dict(pcc_topk_tiles.select_by_dtype)
    got = pcc_topk_tiles(u, 0, total, **kw)
    want = pcc_topk_tiles_plain(u, 0, total, **kw)
    torch.cuda.synchronize()
    assert pcc_topk_tiles.select_by_dtype[dtype] == before[dtype] + 1
    if dtype == "int8":
        # exact values: ties are exact and resolve by column, as in plain
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    tiles = pcc_tiles(u, 0, t=t, l_blk=64, pass_tiles=total, epilogue=spec,
                      v_pad=v, grid_cols=gc)
    ids = np.arange(total)
    ys, xs = (grid_job_coord_batch(m, gc, ids) if grid
              else job_coord_batch(m, ids))
    r = torch.zeros(u.shape[0], (u if v is None else v).shape[0],
                    device=cuda)
    r.view(m, t, -1, t)[torch.as_tensor(ys, device=cuda), :,
                        torch.as_tensor(xs, device=cuda), :] = tiles
    if not grid:
        r = torch.where(torch.ones_like(r, dtype=torch.bool).triu(), r, r.T)
    for side in range(len(got) // 2):
        vals, cols = got[2 * side], got[2 * side + 1]
        ok = cols >= 0
        rows = (torch.arange(vals.shape[0] * t, device=cuda)
                .view(-1, t, 1).expand_as(cols))
        ref = (r if side == 0 else r.T)[rows[ok], cols[ok].long()]
        assert torch.equal(vals[ok], ref)


@pytest.mark.gpu
@pytest.mark.parametrize("grid", [False, True])
@pytest.mark.parametrize("n,n_cols,width,t,l_blk,kk", [
    (300, 170, 29, 64, 29, 10),     # l_pad 29: a zero-padded copy for TMA
    (300, 170, 48, 64, 16, 33),     # kk 33: rank counting, not extraction
    (333, 250, 40, 72, 8, 10),      # t = 72: blocks and quarters past t
])
def test_int8_select_on_the_tensor_cores(cuda, grid, n, n_cols, width, t,
                                         l_blk, kk):
    """The int8 select on the tensor-core mainloop of the int8 tiles: its
    pass scratch bitwise topk_select_plain's list for list, its values
    bitwise pcc_tiles' tiles, and the merged state bitwise the plain
    version's, with an unaligned sample axis (the wrapper's padded copy),
    the rank-counting route and a ragged t."""
    u = pad_operands(_signs(n, width, cuda), t, l_blk)
    v = pad_operands(_signs(n_cols, width, cuda, seed=1), t, l_blk)
    assert (u.shape[1] % 16 == 0) == (width % 16 == 0)
    m = u.shape[0] // t
    gc = v.shape[0] // t if grid else None
    total = m * gc if grid else m * (m + 1) // 2
    j0, dev_hi = 1, total - 2
    pt = total - j0
    spec = EpilogueSpec(div=float(width), clip=(-1.0, 1.0))
    kw = dict(t=t, l_blk=l_blk, pass_tiles=pt, kk=kk,
              n_cols_valid=n_cols if grid else n, symmetric_problem=not grid,
              epilogue=spec, v_pad=v if grid else None, grid_cols=gc)
    before = pcc_topk_tiles.select_by_dtype["int8"]
    got = topk_select(u, j0, dev_hi, **kw)
    want = topk_select_plain(u, j0, dev_hi, **kw)
    torch.cuda.synchronize()
    assert pcc_topk_tiles.select_by_dtype["int8"] == before + 1
    n_valid = dev_hi - j0
    ids = j0 + np.arange(n_valid)
    ys, xs = (grid_job_coord_batch(m, gc, ids) if grid
              else job_coord_batch(m, ids))
    read = [torch.ones(n_valid, dtype=torch.bool, device=cuda),
            torch.as_tensor(ys != xs, device=cuda)]
    for side in range(len(got) // 2):
        for a, b in zip(got[2 * side:2 * side + 2],
                        want[2 * side:2 * side + 2]):
            a, b = a[:n_valid][read[side]], b[:n_valid][read[side]]
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    # values: the tiles' bits at the listed columns
    tiles = pcc_tiles(u, j0, t=t, l_blk=l_blk, pass_tiles=n_valid,
                      epilogue=spec, v_pad=v if grid else None, grid_cols=gc)
    vals, cols = got[0][:n_valid], got[1][:n_valid]
    ok = cols >= 0
    assert bool(ok.any())
    slot = (torch.arange(n_valid, device=cuda).view(-1, 1, 1, 1)
            .expand_as(cols))
    line = torch.arange(t, device=cuda).view(1, -1, 1, 1).expand_as(cols)
    xs_t = torch.as_tensor(xs, device=cuda).view(-1, 1, 1, 1).expand_as(cols)
    ref = tiles[slot[ok], line[ok], cols[ok].long() - xs_t[ok] * t]
    assert torch.equal(vals[ok], ref)
    state = pcc_topk_tiles(u, j0, dev_hi, **kw)
    plain = pcc_topk_tiles_plain(u, j0, dev_hi, **kw)
    assert all(torch.equal(a, b) for a, b in zip(state, plain))


@pytest.mark.gpu
@pytest.mark.parametrize("measure,dtype", [
    ("spearman", None), ("covariance", None), ("kendall", "int8"),
    ("pearson", "bfloat16"), ("kendall_tau_b", "bfloat16")])
def test_measures_on_card_match_cpu(cuda, measure, dtype):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((200, 40)) / np.sqrt(40)).astype(np.float32)
    kw = dict(measure=measure, compute_dtype=dtype, t=32, l_blk=32)
    r = corr(x, device=cuda, **kw)
    want = corr(x, device="cpu", **kw)
    if dtype == "int8":
        assert torch.equal(r.cpu(), want)
    else:
        torch.testing.assert_close(r.cpu(), want, rtol=0, atol=ATOL)
    got = corr(x, sink=DeviceTopKSink(7), device=cuda, **kw)
    want = corr(x, sink=TopKSink(7), device=cuda, **kw)
    np.testing.assert_array_equal(got["indices"], want["indices"])
    np.testing.assert_array_equal(got["values"], want["values"])


def _quantized(n, l, t, l_blk, device, qdtype, seed=0):
    """A Pearson operand quantized with per-row scales, padded."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, l)).astype(np.float32))
    q, s = quantize_rows(transform(x.to(device)), qdtype)
    return pad_operands(q, t, l_blk), pad_scales(s, t)


@pytest.mark.gpu
@pytest.mark.parametrize("qdtype", ["int8", "float8_e4m3fn", "float8_e5m2"])
@pytest.mark.parametrize("grid", [False, True])
@pytest.mark.parametrize("n,l,t,l_blk,j_start,pass_tiles", [
    (37, 29, 8, 8, 0, 15),
    (37, 20, 8, 8, 12, 3),
    (300, 700, 96, 64, 1, 5),
    (600, 1000, 256, 512, 4, 5),
])
def test_scaled_kernel_bitwise_invariants(cuda, qdtype, grid, n, l, t, l_blk,
                                          j_start, pass_tiles):
    """Scaled int8 tiles are bitwise the plain version's; fp8 tiles are
    within the narrow gate of it, the gate refusing the planted faults."""
    u, su = _quantized(n, l, t, l_blk, cuda, qdtype)
    v, sv = (_quantized(n // 2 + 3, l, t, l_blk, cuda, qdtype, seed=1)
             if grid else (None, su))
    gc = v.shape[0] // t if grid else None
    for spec in (None, EpilogueSpec(clip=(-1.0, 1.0)),
                 EpilogueSpec(div=7.0, clip=(-0.05, 0.05))):
        kw = dict(t=t, l_blk=l_blk, pass_tiles=pass_tiles, epilogue=spec,
                  v_pad=v, grid_cols=gc, row_scale=su, col_scale=sv)
        before = (dict(pcc_tiles.launches_by_dtype),
                  pcc_tiles.scaled_launches)
        if qdtype == "int8":
            got = pcc_tiles(u, j_start, **kw)
            want = pcc_tiles_plain(u, j_start, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
            launches = 1
        else:   # the tiles, then the two planted faults without a clip
            faults = spec is None
            _within_narrow_gate(u, j_start, kw, faults=faults)
            launches = 3 if faults else 1
        assert (pcc_tiles.launches_by_dtype[qdtype]
                == before[0][qdtype] + launches)
        assert pcc_tiles.scaled_launches == before[1] + launches


def _narrow_operand(n, l, t, l_blk, device, dtype, seed=0):
    """A bf16 Pearson operand (scales None) or an fp8-quantized one."""
    if dtype == "bfloat16":
        return _operand(n, l, t, l_blk, device, seed).to(torch.bfloat16), None
    return _quantized(n, l, t, l_blk, device, dtype, seed)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float8_e4m3fn",
                                   "float8_e5m2"])
@pytest.mark.parametrize("n,l,t,l_blk", [
    (300, 50, 96, 4),     # t below one 128-row block, l_pad 52
    (260, 90, 130, 6),    # t one row past a block, l_pad 90
    (300, 70, 200, 10),   # l_pad 70
    (129, 33, 129, 3),    # odd t (scalar stores), odd l_pad
])
def test_narrow_ragged_tiles_and_unaligned_samples(cuda, dtype, n, l, t,
                                                   l_blk):
    """t not a multiple of the 128-row block, and sample axes whose rows
    break TMA's 16-byte stride (the wrapper pads them with zero samples):
    triangle, grid and replica tiles within the narrow gate, split- and
    replica-invariant bitwise; bf16 top-k values bitwise pcc_tiles'."""
    from repro_torch.kernels.pcc_tile import tma_operand
    u, su = _narrow_operand(n, l, t, l_blk, cuda, dtype)
    v, sv = _narrow_operand(n // 2 + 3, l, t, l_blk, cuda, dtype, seed=1)
    assert tma_operand(u, l_blk) is not u        # the padded copy is used
    m = u.shape[0] // t
    spec = EpilogueSpec(div=3.0, clip=(-1.0, 1.0))
    for gc, vv, sc in ((None, None, su), (v.shape[0] // t, v, sv)):
        total = m * gc if gc else m * (m + 1) // 2
        kw = dict(t=t, l_blk=l_blk, epilogue=spec, v_pad=vv, grid_cols=gc,
                  row_scale=su, col_scale=sc)
        got = _within_narrow_gate(u, 0, {**kw, "pass_tiles": total},
                                  faults=False)
        parts = torch.cat([pcc_tiles(u, j, pass_tiles=min(2, total - j),
                                     **kw) for j in range(0, total, 2)])
        assert torch.equal(got, parts)
        if dtype == "bfloat16":
            tk = pcc_topk_tiles(u, 0, total, pass_tiles=total, kk=5,
                                n_cols_valid=(v if gc else u).shape[0],
                                symmetric_problem=gc is None, **{
                                    k_: kw[k_] for k_ in
                                    ("t", "l_blk", "epilogue", "v_pad",
                                     "grid_cols")})
            ids = np.arange(total)
            ys, xs = (grid_job_coord_batch(m, gc, ids) if gc
                      else job_coord_batch(m, ids))
            r = torch.zeros(u.shape[0], (v if gc else u).shape[0],
                            device=cuda)
            r.view(m, t, -1, t)[torch.as_tensor(ys, device=cuda), :,
                                torch.as_tensor(xs, device=cuda), :] = got
            if gc is None:
                r = torch.where(torch.ones_like(r, dtype=torch.bool).triu(),
                                r, r.T)
            for side in range(len(tk) // 2):
                vals, cols = tk[2 * side], tk[2 * side + 1]
                ok = cols >= 0
                rows = (torch.arange(vals.shape[0] * t, device=cuda)
                        .view(-1, t, 1).expand_as(cols))
                assert torch.equal(vals[ok], (r if side == 0 else r.T)[
                    rows[ok], cols[ok].long()])
    # a replica stack of two column operands on the grid
    stack = torch.stack([v.view(torch.uint8), _narrow_operand(
        n // 2 + 3, l, t, l_blk, cuda, dtype, seed=2)[0].view(torch.uint8)])
    stack = stack.view(u.dtype)
    scol = None if su is None else torch.stack([sv, _narrow_operand(
        n // 2 + 3, l, t, l_blk, cuda, dtype, seed=2)[1]])
    kw = dict(t=t, l_blk=l_blk, pass_tiles=3, epilogue=spec,
              grid_cols=v.shape[0] // t, row_scale=su)
    got = _within_narrow_gate(u, 1, {**kw, "v_pad": stack,
                                     "col_scale": scol}, faults=False)
    for r_ in range(2):
        assert torch.equal(got[r_], pcc_tiles(
            u, 1, v_pad=stack[r_], col_scale=None if scol is None
            else scol[r_], **kw))


@pytest.mark.gpu
def test_narrow_tiles_run_only_on_the_tensor_core_kernel(cuda):
    """The SIMT tile library keeps float32 only; bf16, fp8 and int8 tiles
    launch the tensor-core library's entry points."""
    from repro_torch.kernels import _build
    simt = _build.load("pcc_tile")
    assert hasattr(simt, "pcc_tiles_f32")
    for sfx in ("bf16", "f16", "e4m3", "e5m2", "i8"):
        assert not hasattr(simt, f"pcc_tiles_{sfx}")
        assert hasattr(_build.load("pcc_tile_sm90"), f"pcc_tiles_sm90_{sfx}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,l,t,l_blk,j_start,pass_tiles", [
    (37, 29, 8, 8, 0, 15),
    (37, 29, 8, 8, 13, 6),       # clamped ids past the end
    (300, 700, 96, 64, 1, 5),
    (600, 1000, 256, 512, 0, 6),
])
def test_triangle_second_operand_equals_grid_tiles(cuda, dtype, n, l, t,
                                                   l_blk, j_start,
                                                   pass_tiles):
    """A triangle tile with a same-shape second operand is bitwise the grid
    tile at the same (y, x) with that operand."""
    u = _operand(n, l, t, l_blk, cuda).to(getattr(torch, dtype))
    w = _operand(n, l, t, l_blk, cuda, seed=2).to(getattr(torch, dtype))
    m = u.shape[0] // t
    spec = EpilogueSpec(clip=(-1.0, 1.0))
    before = pcc_tiles.triangle_pair_launches
    got = pcc_tiles(u, j_start, t=t, l_blk=l_blk, pass_tiles=pass_tiles,
                    epilogue=spec, v_pad=w)
    assert pcc_tiles.triangle_pair_launches == before + 1
    ys, xs = job_coord_batch(m, np.minimum(
        j_start + np.arange(pass_tiles), m * (m + 1) // 2 - 1))
    grid = pcc_tiles(u, 0, t=t, l_blk=l_blk, pass_tiles=m * m, epilogue=spec,
                     v_pad=w, grid_cols=m)
    torch.cuda.synchronize()
    assert torch.equal(got, grid[torch.as_tensor(ys * m + xs, device=cuda)])
    kw = dict(t=t, l_blk=l_blk, pass_tiles=pass_tiles, epilogue=spec,
              v_pad=w)
    want = pcc_tiles_plain(u, j_start, **kw)
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    else:
        assert gate_share(got, want, narrow_gate(u, j_start, **kw)) <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("measure", ["pearson", "cosine", "covariance"])
@pytest.mark.parametrize("compute_dtype", [None, "int8", "float8_e4m3fn"])
def test_masked_and_quantized_corr_on_card_match_cpu(cuda, measure,
                                                     compute_dtype):
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((200, 40)) / np.sqrt(40)).astype(np.float32)
    kw = dict(measure=measure, t=32, l_blk=32, max_tiles_per_pass=7)
    if compute_dtype is None:     # masked: 20 % missing
        x[rng.random(x.shape) < 0.2] = np.nan
        kw["where"] = "nan"
    else:
        kw["compute_dtype"] = compute_dtype
    r = corr(x, device=cuda, **kw)
    assert torch.equal(r, r.T)
    y = x[:70]
    kw_y = {**kw, "where": (None, None)} if compute_dtype is None else kw
    for got, want, yy in ((r, corr(x, device="cpu", **kw), None),
                          (corr(x, y, device=cuda, **kw_y),
                           corr(x, y, device="cpu", **kw_y), y)):
        if compute_dtype == "float8_e4m3fn":   # the tensor-core kernel
            assert gate_share(got.cpu(), want, _dense_narrow_gate(
                x, yy, measure, compute_dtype, 32, 32)) <= 1.0
        else:
            torch.testing.assert_close(got.cpu(), want, rtol=0, atol=ATOL)


def _dense_narrow_gate(x, y, measure, compute_dtype, t, l_blk):
    """The narrow gate (kernels/narrow_gate.py) on corr's dense result:
    the gate of the grid launch over the plan's quantized operands (on the
    CPU), its tiles laid out as the dense matrix."""
    from repro_torch.core.plan import ExecutionPlan
    kw = dict(t=t, l_blk=l_blk, measure=measure, compute_dtype=compute_dtype)
    if y is None:
        plan = ExecutionPlan.create(*x.shape, **kw)
        a = b = plan.prepare(torch.from_numpy(x))
    else:
        plan = ExecutionPlan.create(*x.shape, n_cols=y.shape[0], **kw)
        a, b = plan.prepare_pair(torch.from_numpy(x), torch.from_numpy(y))
    m, gc = a.data.shape[0] // t, b.data.shape[0] // t
    g = narrow_gate(a.data, 0, t=t, l_blk=l_blk, pass_tiles=m * gc,
                    epilogue=plan.epilogue_spec, v_pad=b.data, grid_cols=gc,
                    row_scale=a.scale, col_scale=b.scale)
    g = g.view(m, gc, t, t).transpose(1, 2).reshape(m * t, gc * t)
    return g[:x.shape[0], :(x if y is None else y).shape[0]]


def _replica_stack(dtype, n, n_cols, l, t, l_blk, device, reps, grid):
    """(u, stack, row_scale, col_scale) for the replica mode: `reps` column
    operands of type `dtype` ("int8s": scaled int8; "int8": Kendall-like
    signs), each u's shape on the triangle or (n_cols rows) on the grid."""
    rows = n_cols if grid else n
    if dtype in ("int8s", "float8_e4m3fn", "float8_e5m2"):
        q = "int8" if dtype == "int8s" else dtype
        u, su = _quantized(n, l, t, l_blk, device, q)
        cols = [_quantized(rows, l, t, l_blk, device, q, seed=s)
                for s in range(1, reps + 1)]
        stack = torch.stack([c.view(torch.uint8) for c, _ in cols])
        return (u, stack.view(u.dtype), su,
                torch.stack([s for _, s in cols]))
    if dtype == "int8":
        u = pad_operands(_signs(n, l, device), t, l_blk)
        stack = torch.stack([pad_operands(_signs(rows, l, device, seed=s), t,
                                          l_blk) for s in range(1, reps + 1)])
        return u, stack, None, None
    dt = getattr(torch, dtype)
    u = _operand(n, l, t, l_blk, device).to(dt)
    stack = torch.stack([_operand(rows, l, t, l_blk, device, seed=s).to(dt)
                         for s in range(1, reps + 1)])
    return u, stack, None, None


@pytest.mark.gpu
@pytest.mark.parametrize("reps", [1, 3, 5])
@pytest.mark.parametrize("grid", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "int8s",
                                   "float8_e4m3fn", "float8_e5m2"])
@pytest.mark.parametrize("n,n_cols,l,t,l_blk,j_start,pass_tiles", [
    (37, 21, 29, 8, 8, 3, 12),        # ragged, clamped ids past the end
    (300, 170, 700, 96, 64, 1, 5),    # t not a multiple of the CTA block
])
def test_replica_kernel_bitwise_invariants(cuda, dtype, grid, reps, n,
                                           n_cols, l, t, l_blk, j_start,
                                           pass_tiles):
    """Replica r's tiles are bitwise the 2-D kernel's tiles with v_pad =
    stack[r]; float32 within ATOL of the plain version; int8 and scaled
    int8 bitwise the plain version; bf16 and fp8 within the narrow gate of
    it."""
    u, stack, su, scol = _replica_stack(dtype, n, n_cols, l, t, l_blk, cuda,
                                        reps, grid)
    gc = stack.shape[1] // t if grid else None
    spec = EpilogueSpec(div=7.0, clip=(-0.05, 0.05))
    kw = dict(t=t, l_blk=l_blk, pass_tiles=pass_tiles, epilogue=spec,
              grid_cols=gc, row_scale=su)
    before = (pcc_tiles.replica_launches, pcc_tiles.replicas_launched,
              pcc_tiles.triangle_pair_launches)
    got = pcc_tiles(u, j_start, v_pad=stack, col_scale=scol, **kw)
    torch.cuda.synchronize()
    assert (pcc_tiles.replica_launches, pcc_tiles.replicas_launched,
            pcc_tiles.triangle_pair_launches) == (before[0] + 1,
                                                  before[1] + reps, before[2])
    assert got.shape == (reps, pass_tiles, t, t)
    for r in range(reps):
        assert torch.equal(got[r], pcc_tiles(
            u, j_start, v_pad=stack[r].contiguous(),
            col_scale=None if scol is None else scol[r], **kw))
    want = pcc_tiles_plain(u, j_start, v_pad=stack, col_scale=scol, **kw)
    if dtype in ("int8", "int8s"):
        assert torch.equal(got, want)
    elif dtype == "float32":
        torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    else:
        assert gate_share(got, want, narrow_gate(
            u, j_start, v_pad=stack, col_scale=scol, **kw)) <= 1.0
    if scol is not None:   # one scale vector expanded over the replicas
        one = pcc_tiles(u, j_start, v_pad=stack,
                        col_scale=scol[:1].expand(reps, -1), **kw)
        assert torch.equal(one, pcc_tiles(
            u, j_start, v_pad=stack,
            col_scale=scol[:1].expand(reps, -1).contiguous(), **kw))


def _pvalue_near_ties(x, y, idx, tie=1e-5):
    """Per entry of a Pearson significance run, the replicas whose float64
    |r| lies within `tie` of the observed float64 |r| (upper triangle
    mirrored for symmetric runs)."""
    u = transform(torch.from_numpy(x).double())
    v = u if y is None else transform(torch.from_numpy(y).double())
    obs = torch.clamp(u @ v.T, -1.0, 1.0).abs()
    ties = torch.zeros(obs.shape, dtype=torch.int64)
    for row in idx:
        rep = torch.clamp(u @ v[:, row].T, -1.0, 1.0).abs()
        ties += (rep - obs).abs() <= tie
    if y is None:
        ties = torch.where(torch.ones_like(ties, dtype=torch.bool).triu(),
                           ties, ties.T)
    return ties


@pytest.mark.gpu
@pytest.mark.parametrize("rect", [False, True])
def test_significance_corr_on_card_matches_cpu(cuda, rect):
    """corr(pvalues=) on the card: r within ATOL of the CPU run and bitwise
    corr(x) on the card; p equal to the CPU's except at counted float64
    near-ties (two summation orders); int8 Kendall bitwise the CPU's."""
    from repro_torch.core.significance import (PermutationSpec,
                                               iteration_indices)
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((200, 40)) / np.sqrt(40)).astype(np.float32)
    y = x[:70] + 0.1 * rng.standard_normal((70, 40)).astype(np.float32) \
        if rect else None
    spec = PermutationSpec(iterations=37, key=3, chunk=16)
    kw = dict(t=32, l_blk=32, max_tiles_per_pass=7, pvalues=spec)
    before = pcc_tiles.replicas_launched
    r, p = corr(x, y, device=cuda, **kw)
    n_pass = -(-((7 * 3) if rect else 28) // 7)
    assert pcc_tiles.replicas_launched == before + 37 * n_pass
    assert torch.equal(r, corr(x, y, t=32, l_blk=32, device=cuda))
    r_cpu, p_cpu = corr(x, y, device="cpu", **kw)
    torch.testing.assert_close(r.cpu(), r_cpu, rtol=0, atol=ATOL)
    ties = _pvalue_near_ties(x, y, iteration_indices(spec, 40))
    d = torch.round((p.cpu().double() - p_cpu.double()).abs() * 38)
    assert torch.equal(p.cpu()[ties == 0], p_cpu[ties == 0])
    assert bool((d <= ties).all())
    if not rect:
        assert torch.equal(p, p.T)
    xk = x[:, :12]
    kk = dict(measure="kendall", compute_dtype="int8", t=32, l_blk=32,
              pvalues=spec)
    rk, pk = corr(xk, device=cuda, **kk)
    rk_cpu, pk_cpu = corr(xk, device="cpu", **kk)
    assert torch.equal(rk.cpu(), rk_cpu) and torch.equal(pk.cpu(), pk_cpu)


# -- pass stream: the sinks' copies run off the compute stream ---------------

@pytest.mark.gpu
@pytest.mark.parametrize("rect", [False, True])
def test_multipass_sinks_bitwise_equal_one_pass_on_card(cuda, rect):
    """A multi-pass run (the sinks' copies and merges on a side stream,
    overlapping the next pass's kernel) is bitwise its one-pass run, and
    DeviceTopKSink is bitwise TopKSink, on the card."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((300, 70)).astype(np.float32)
    y = rng.standard_normal((130, 70)).astype(np.float32) if rect else None
    kw = dict(t=32, l_blk=32, device=cuda)
    dense = corr(x, y, **kw)
    assert torch.equal(dense, corr(x, y, max_tiles_per_pass=3, **kw))
    for sink in (TopKSink, DeviceTopKSink):
        one = corr(x, y, sink=sink(10), **kw)
        split = corr(x, y, sink=sink(10), max_tiles_per_pass=3, **kw)
        assert np.array_equal(one["indices"], split["indices"])
        assert one["values"].tobytes() == split["values"].tobytes()
        ref = corr(x, y, sink=TopKSink(10), **kw)
        assert one["values"].tobytes() == ref["values"].tobytes()
        assert np.array_equal(one["indices"], ref["indices"])



# -- streaming reductions and the transform cache ----------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("labelled", [False, True])
def test_edge_count_on_card_equals_cpu_on_the_same_tiles(cuda, labelled):
    """EdgeCountSink counting on the card equals the same sink on the CPU
    fed the same tiles (a threshold at a value the tiles hold included),
    and the end-to-end run equals the dense adjacency."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((300, 70)).astype(np.float32)
    labels = np.arange(300) % 7 if labelled else None
    kw = dict(t=32, l_blk=32, max_tiles_per_pass=7)
    plan = ExecutionPlan.create(300, 70, **kw)
    passes = [(ids, buf) for ids, buf in stream_tiles(x, device=cuda,
                                                      **kw)]
    vals = torch.cat([b.reshape(-1) for _, b in passes]).abs()
    for thr in (0.2, float(vals.sort().values[-500])):
        on_card, on_cpu = (EdgeCountSink(thr, labels=labels)
                           for _ in range(2))
        on_card.open(plan, cuda)
        on_cpu.open(plan, torch.device("cpu"))
        for ids, buf in passes:
            on_card.consume(ids, buf)
            on_cpu.consume(ids, buf.cpu())
        got, want = on_card.result(), on_cpu.result()
        assert got["edges"] == want["edges"] > 0
        assert np.array_equal(got["degrees"], want["degrees"])
        assert got.get("intra_edges") == want.get("intra_edges")
    dense = corr(x, device=cuda, **kw).cpu().numpy()
    adj = (np.abs(dense) >= np.float32(0.2)) & ~np.eye(300, dtype=bool)
    run = corr(x, device=cuda, sink=EdgeCountSink(0.2, labels=labels), **kw)
    assert run["edges"] == int(adj.sum()) // 2
    assert np.array_equal(run["degrees"], adj.sum(1))


@pytest.mark.gpu
@pytest.mark.parametrize("mtp", [None, 5])
def test_row_block_sink_on_card_is_dense_sink(cuda, mtp):
    """Ragged row ranges (straddling tile edges, overlapping) of a
    RowBlockSink are bitwise DenseSink's rows, and the stream assembled on
    the host and a ReductionSink row max are DenseSink's bits."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal((150, 70)).astype(np.float32)
    y = rng.standard_normal((230, 70)).astype(np.float32)
    kw = dict(t=32, l_blk=32, max_tiles_per_pass=mtp, device=cuda)
    bounds = [(0, 31), (31, 33), (33, 100), (100, 150), (10, 140)]
    dense = corr(x, y, **kw).cpu().numpy()
    got = corr(x, y, sink=RowBlockSink(bounds), **kw)
    for (lo, hi), g in zip(bounds, got):
        assert g.tobytes() == dense[lo:hi].tobytes()
    sym = corr(x, **kw).cpu().numpy()
    plan = ExecutionPlan.create(150, 70, t=32)
    assembled = assemble_from_stream(150, 32, plan.m, stream_tiles(
        x, t=32, l_blk=32, max_tiles_per_pass=mtp, device=cuda))
    assert assembled.tobytes() == sym.tobytes()

    def row_max(state, ids, tiles, ys, xs, plan_):
        t, n = plan_.t, plan_.n
        span = np.arange(t)
        for v, rb, cb in ((tiles, ys, xs),
                          (np.transpose(tiles, (0, 2, 1)), xs, ys)):
            rows = (rb[:, None] * t + span)[:, :, None]
            cols = (cb[:, None] * t + span)[:, None, :]
            ok = (rows < n) & (cols < n) & (rows != cols)
            r = np.broadcast_to(rows, v.shape)
            np.maximum.at(state, r[ok], np.abs(v)[ok])
        return state

    got_max = corr(x, sink=ReductionSink(row_max, np.full(150, -1.0,
                                                          np.float32)),
                   **kw)
    np.fill_diagonal(sym, 0.0)
    assert got_max.tobytes() == np.abs(sym).max(1).tobytes()


@pytest.mark.gpu
def test_transform_cache_on_card(cuda):
    """A repeat corr on the same card tensor hits the cache and is bitwise
    the first; an in-place change misses and gives the uncached bits."""
    clear_prepared_cache()
    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.standard_normal((300, 70)).astype(np.float32)
                         ).to(cuda)
    kw = dict(t=32, l_blk=32, measure="spearman", device=cuda)
    first = corr(x, **kw)
    second = corr(x, **kw)
    stats = prepared_cache_stats()
    assert (stats["misses"], stats["hits"]) == (1, 1)
    assert torch.equal(first, second)
    x[0] += torch.from_numpy(rng.standard_normal(70).astype(np.float32)
                             ).to(cuda)
    changed = corr(x, **kw)
    assert prepared_cache_stats()["misses"] == 2
    clear_prepared_cache()
    assert torch.equal(changed, corr(x, **kw))
    assert not torch.equal(changed, first)
    clear_prepared_cache()


# -- flash attention ---------------------------------------------------------

FLASH_SHAPES = [  # b, h, hkv, s, d, window
    (1, 2, 2, 32, 16, None), (2, 4, 2, 70, 16, None), (1, 8, 1, 64, 32, None),
    (2, 2, 2, 17, 8, None), (2, 4, 2, 96, 16, 16), (2, 4, 2, 96, 16, 32),
    (2, 4, 2, 96, 16, 48),
    # the reference kernel drops these windows; the port keeps them
    (1, 2, 1, 32, 16, 16), (1, 2, 1, 96, 16, 80), (1, 2, 1, 40, 16, 32),
    # the head tiles of the model cases and the edges of the kernel
    (1, 3, 1, 300, 64, 64), (1, 4, 2, 200, 128, None), (1, 2, 1, 150, 100,
                                                        None),
    (1, 1, 1, 130, 256, 128), (1, 2, 1, 257, 64, 16),
]


def _flash_inputs(b, h, hkv, s, d, device, seed=1):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(device) for shape in ((b, h, s, d), (b, hkv, s, d),
                                      (b, hkv, s, d))]


# bf16 / fp16 (the tensor-core kernel) against the plain version on the same
# inputs, on every element:
#   |got - want| <= min(ULP * |want| + ROW * rms(want's row),
#                       TOL_NARROW * (1 + |want|)).
# The second is the reference's own bf16 bound (tests/test_kernels.py); at
# long rows it is as large as the output itself (row i's outputs are
# ~sqrt(e / i)), so the first, scaled to each row, holds those rows.  The
# kernel rounds P to the input type before P V (unit roundoff u = 2^-8 in
# bf16, 2^-11 in fp16) where the plain version keeps float32, which moves
# an output by ~u / sqrt(3) of its row's rms: ROW = 8 u.  Each output is
# rounded once to the dtype, so two may differ by an ulp: ULP.
TOL_NARROW = 3e-2
NARROW_ULP = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}
NARROW_ROW = {torch.bfloat16: 2.0 ** -5, torch.float16: 2.0 ** -8}


def _narrow_gate_share(got, want):
    """Largest |got - want| / gate over the elements (<= 1: within)."""
    dt = want.dtype
    want = want.double()
    rms = want.square().mean(-1, keepdim=True).sqrt()
    gate = torch.minimum(NARROW_ULP[dt] * want.abs() + NARROW_ROW[dt] * rms,
                         TOL_NARROW * (1 + want.abs()))
    return float(((got.double() - want).abs() / gate).max())


def _check_narrow_flash(cuda, b, h, hkv, s, d, window, blk):
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    q, k, v = _flash_inputs(b, h, hkv, s, d, cuda)
    for dt in (torch.bfloat16, torch.float16):
        qn, kn, vn = q.to(dt), k.to(dt), v.to(dt)
        before = dict(flash_attention.launches_by_dtype)
        got = flash_attention(qn, kn, vn, window=window, blk_q=blk,
                              blk_k=blk)
        want = flash_attention_plain(qn, kn, vn, window=window)
        torch.cuda.synchronize()
        name = str(dt).removeprefix("torch.")
        assert flash_attention.launches_by_dtype[name] == before[name] + 1
        assert got.dtype == dt and got.shape == qn.shape
        assert _narrow_gate_share(got, want) <= 1


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,hkv,s,d,window", FLASH_SHAPES)
def test_flash_kernel_matches_plain(cuda, b, h, hkv, s, d, window):
    """float32 (the SIMT kernel) within the reference's 2e-6 of the plain
    version; bf16 and fp16 (the tensor-core kernel) within the row-scaled
    gate of it on the same inputs."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    q, k, v = _flash_inputs(b, h, hkv, s, d, cuda)
    blk = 16
    before = flash_attention.launches
    got = flash_attention(q, k, v, window=window, blk_q=blk, blk_k=blk)
    want = flash_attention_plain(q, k, v, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=2e-6)
    _check_narrow_flash(cuda, b, h, hkv, s, d, window, blk)


# The float32 kernel's blocks: 64 keys a step, 64 query rows a CTA (32 at
# D = 256); S below, at and one past each.
@pytest.mark.gpu
@pytest.mark.parametrize("window", [None, 32])
@pytest.mark.parametrize("d", [8, 16, 64, 100, 128, 256])
@pytest.mark.parametrize("s", [31, 32, 33, 63, 64, 65, 127, 128, 129])
def test_flash_f32_ragged_rows_and_head_dims(cuda, s, d, window):
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    q, k, v = _flash_inputs(1, 4, 2, s, d, cuda, seed=s * 1000 + d)
    before = flash_attention.launches_by_dtype["float32"]
    got = flash_attention(q, k, v, window=window, blk_q=16, blk_k=16)
    want = flash_attention_plain(q, k, v, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches_by_dtype["float32"] == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=2e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,hkv,s,d,window", [
    shape for shape in FLASH_SHAPES
    if (shape[3], shape[5]) in {(32, 16), (96, 80), (40, 32)}])
def test_flash_f32_keeps_the_windows_the_reference_drops(cuda, b, h, hkv, s,
                                                          d, window):
    """The reference kernel computes full causal attention at these
    windows; the float32 kernel keeps the window, as the oracle mha_ref
    (mha_plain) does, within the reference's 2e-6."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     mha_plain)
    q, k, v = _flash_inputs(b, h, hkv, s, d, cuda)
    got = flash_attention(q, k, v, window=window, blk_q=16, blk_k=16)
    want = mha_plain(q, k, v, window=window)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,hkv,s,d,window", [
    (1, 24, 8, 1024, 128, None),    # llama-3.2-3B's heads
    (1, 25, 5, 2048, 64, 1024),     # hymba-1.5B's sliding-window layers
])
def test_flash_narrow_kernel_at_model_widths(cuda, b, h, hkv, s, d, window):
    _check_narrow_flash(cuda, b, h, hkv, s, d, window, 128)
    # The gate refuses the kernel's output on v with one key block zeroed,
    # on the rows past it, where the reference's bound alone is loose.
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    q, k, v = (a.to(torch.bfloat16)
               for a in _flash_inputs(b, h, hkv, s, d, cuda))
    j0 = s // 2
    holed = v.clone()
    holed[:, :, j0:j0 + 128] = 0
    got = flash_attention(q, k, holed, window=window)[:, :, j0 + 128:]
    want = flash_attention_plain(q, k, v, window=window)[:, :, j0 + 128:]
    assert _narrow_gate_share(got, want) > 1


@pytest.mark.gpu
def test_flash_on_card_never_runs_plain(cuda, monkeypatch):
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.kernels import ops

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    dtypes = (torch.float32, torch.bfloat16, torch.float16)
    inputs = {dt: [a.to(dt) for a in _flash_inputs(1, 4, 2, 80, 32, cuda)]
              for dt in dtypes}
    want = {dt: fmod.flash_attention_plain(*inputs[dt], window=32)
            for dt in dtypes}
    monkeypatch.setattr(fmod, "flash_attention_plain", refuse)
    for dt in dtypes:
        name = str(dt).removeprefix("torch.")
        before = dict(fmod.flash_attention.launches_by_dtype)
        got = ops.flash_mha(*inputs[dt], window=32, blk=16)
        assert fmod.flash_attention.launches_by_dtype[name] == \
            before[name] + 1
        if dt == torch.float32:
            torch.testing.assert_close(got, want[dt], rtol=0, atol=2e-6)
        else:
            assert _narrow_gate_share(got, want[dt]) <= 1
    with pytest.raises(ValueError):
        ops.flash_mha(*_flash_inputs(1, 4, 2, 80, 32, cuda), window=24,
                      blk=16)


# -- the LM side's prefill attention on the flash kernel (models/layers.py) --

def _lm_attention_inputs(cfg, s, device, dtype, seed=3):
    """Rotated-attention inputs at a config's head shapes: q (1, S, H, hd),
    k and v (1, S, Hkv, hd), standard normal."""
    rng = np.random.default_rng(seed)
    shapes = ((1, s, cfg.n_heads, cfg.hd), (1, s, cfg.n_kv_heads, cfg.hd),
              (1, s, cfg.n_kv_heads, cfg.hd))
    return [torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
            .to(device=device, dtype=dtype) for sh in shapes]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,s", [(0, 80), (32, 80), (32, 29)])
def test_lm_flash_route_matches_the_plain_route(cuda, dtype, window, s):
    """hymba SMOKE's heads (H 4, Hkv 2, hd 32): the flash route (one launch,
    blk dividing the window 32) against the reference's plain route on the
    same rotated q, k, v."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import layers

    cfg = get_config("hymba-1.5b", smoke=True)
    q, k, v = _lm_attention_inputs(cfg, s, cuda, dtype)
    name = str(dtype).removeprefix("torch.")
    before = flash_attention.launches_by_dtype[name]
    got = layers.self_attention(cfg, q, k, v, None, window)
    assert flash_attention.launches_by_dtype[name] == before + 1
    pos = torch.arange(s, device=cuda)[None, :]
    want = layers._plain_route(cfg, q, k, v, pos, window)
    assert got.shape == want.shape == (1, s, cfg.n_heads * cfg.hd)
    assert got.dtype == dtype
    b_, h_, hd_ = 1, cfg.n_heads, cfg.hd
    g4, w4 = got.reshape(b_, s, h_, hd_), want.reshape(b_, s, h_, hd_)
    if dtype == torch.float32:
        torch.testing.assert_close(g4, w4, rtol=0, atol=2e-6)
    else:
        assert _narrow_gate_share(g4.transpose(1, 2),
                                  w4.transpose(1, 2)) <= 1


def _lm_smoke_batch(cfg, device, stream="arange", s=48, b=2):
    """A SMOKE config's prefill inputs (numpy seed 1) on `device` and the
    decode step's m-rope positions: tokens; the VLM's embeddings with m-rope
    streams ("arange": broadcast 0..S-1; "image": a 4 x 4 image block of
    patches sharing t = 8 after 8 text positions, text after it from 12);
    the encoder-decoder's source frames and target tokens."""
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s))).to(device)
    if not (cfg.enc_dec or cfg.embed_inputs):
        return {"tokens": toks}, {}
    frames = torch.from_numpy(rng.standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)).to(
            device=device, dtype=cfg.activation_dtype())
    if cfg.enc_dec:
        return {"src": frames, "tokens": toks}, {}
    if stream == "image":
        grid = np.arange(16)
        t = np.r_[np.arange(8), np.full(16, 8), np.arange(12, 12 + s - 24)]
        h = np.r_[np.arange(8), 8 + grid // 4, t[24:]]
        w = np.r_[np.arange(8), 8 + grid % 4, t[24:]]
        pos, nxt = np.stack([t, h, w]), int(t[-1]) + 1
    else:
        pos, nxt = np.tile(np.arange(s), (3, 1)), s
    pos = torch.from_numpy(pos.astype(np.int32)).to(device).expand(b, 3, s)
    return {"embeds": frames, "positions": pos}, {
        "positions": torch.full((b, 3, 1), nxt, dtype=torch.int32,
                                device=device)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_index_streams_take_the_flash_kernel(cuda, monkeypatch, dtype):
    """The VLM with broadcast 0..S-1 m-rope streams on the card: the mask
    decision (one a prefill) finds the index, so every layer launches the
    flash kernel once and the plain route never runs."""
    from repro_torch.configs import get_config, override
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.models import layers, steps
    from repro_torch.models.registry import build_model

    cfg = override(get_config("qwen2-vl-72b", smoke=True), dtype=dtype)
    params = build_model(cfg).init(
        torch.Generator(device=cuda).manual_seed(0), device=cuda)
    batch, _ = _lm_smoke_batch(cfg, cuda)

    def refuse(*args, **kwargs):
        raise AssertionError("an index stream reached the plain route")

    monkeypatch.setattr(layers, "_plain_route", refuse)
    before = dict(fmod.flash_attention.launches_by_dtype)
    logits, _ = steps.make_prefill_step(cfg)(params, **batch)
    torch.cuda.synchronize()
    after = dict(fmod.flash_attention.launches_by_dtype)
    assert after[dtype] - before[dtype] == cfg.n_layers
    assert sum(after.values()) - sum(before.values()) == cfg.n_layers
    assert bool(torch.isfinite(logits).all())


@pytest.mark.gpu
def test_lm_image_stream_takes_the_plain_route_on_card(cuda, monkeypatch):
    """The VLM with an image block (patches sharing t) on the card: no
    flash launch, the plain route once a layer, masked by the temporal
    stream; the float32 prefill's logits and caches and a decode step's
    logits within 1e-5 of the CPU's largest |value| (the same float32
    terms in other orders)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.models import layers, steps
    from repro_torch.models.registry import build_model

    cfg = get_config("qwen2-vl-72b", smoke=True)    # float32
    params = build_model(cfg).init(torch.Generator().manual_seed(0),
                                   device="cpu")
    batch, dkw = _lm_smoke_batch(cfg, "cpu", stream="image")
    plain_route, routed = layers._plain_route, []

    def counting(*args, **kwargs):
        routed.append(args[1].device.type)
        return plain_route(*args, **kwargs)

    monkeypatch.setattr(layers, "_plain_route", counting)
    prefill = steps.make_prefill_step(cfg, cache_capacity=56)
    decode = steps.make_decode_step(cfg)
    want, cache_c = prefill(params, **batch)
    tok = want[:, -1].argmax(-1)[:, None]
    want_d, _ = decode(params, token=tok, cache=cache_c, cache_index=48,
                       **dkw)
    routed.clear()
    params = params.to(cuda)
    on = {k: v.to(cuda) for k, v in batch.items()}
    before = dict(fmod.flash_attention.launches_by_dtype)
    got, cache = prefill(params, **on)
    torch.cuda.synchronize()
    assert dict(fmod.flash_attention.launches_by_dtype) == before
    assert routed == ["cuda"] * cfg.n_layers
    got_d, _ = decode(params, token=tok.to(cuda), cache=cache,
                      cache_index=48,
                      **{k: v.to(cuda) for k, v in dkw.items()})
    for w, g in [(want, got), (want_d, got_d)] + [
            (cache_c[0][n], cache[0][n]) for n in ("k", "v")]:
        err = float((g.cpu() - w).abs().max())
        assert err <= 1e-5 * float(w.abs().max()), err


@pytest.mark.gpu
@pytest.mark.parametrize("arch,dtype", [("hymba-1.5b", "float32"),
                                        ("hymba-1.5b", "bfloat16"),
                                        ("llama3.2-3b", "bfloat16"),
                                        ("qwen2-vl-72b", "float32"),
                                        ("qwen2-vl-72b", "bfloat16"),
                                        ("seamless-m4t-medium", "float32"),
                                        ("seamless-m4t-medium",
                                         "bfloat16")])
def test_lm_smoke_prefill_on_card_runs_the_flash_kernel(cuda, monkeypatch,
                                                        arch, dtype):
    """A SMOKE prefill (S = 48, across hymba's window 32; the VLM from
    embeddings with broadcast 0..S-1 m-rope streams; the encoder-decoder
    from source frames, its decoder's self-attention) on the card: one
    flash launch per (decoder) attention layer, none of the plain route or
    the wrapper's plain version; every layer's flash output against the
    plain route on the same inputs (float32 within 2e-6, bf16 within the
    row-scaled gate); the last logits against a prefill through the plain
    route (float32 within 1e-4 of the largest |logit|, bf16 within the
    reference's 2e-2), and one decode step launching no flash kernel."""
    from repro_torch.configs import get_config, override
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.models import layers, steps
    from repro_torch.models.registry import build_model

    cfg = override(get_config(arch, smoke=True), dtype=dtype)
    params = build_model(cfg).init(
        torch.Generator(device=cuda).manual_seed(0), device=cuda)
    batch, dkw = _lm_smoke_batch(cfg, cuda)
    toks = batch.get("tokens")
    if toks is None:   # the VLM's decode tokens
        toks = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab, (2, 48))).to(cuda)
    plain_route, flash_route = layers._plain_route, layers._flash_route
    records = []

    def recording(cfg_, q, k, v, window):
        out = flash_route(cfg_, q, k, v, window)
        records.append((q, k, v, window, out))
        return out

    def refuse(*args, **kwargs):
        raise AssertionError("the card's prefill reached a plain version")

    monkeypatch.setattr(layers, "_flash_route", recording)
    monkeypatch.setattr(layers, "_plain_route", refuse)
    monkeypatch.setattr(fmod, "flash_attention_plain", refuse)
    before = dict(fmod.flash_attention.launches_by_dtype)
    logits, cache = steps.make_prefill_step(cfg, cache_capacity=56)(
        params, **batch)
    torch.cuda.synchronize()
    after = dict(fmod.flash_attention.launches_by_dtype)
    assert after[dtype] - before[dtype] == cfg.n_layers == len(records)
    assert sum(after.values()) - sum(before.values()) == cfg.n_layers
    assert [r[3] for r in records] == [w for w in cfg.layer_windows()]
    steps.make_decode_step(cfg)(params, token=toks[:, -1:], cache=cache,
                                cache_index=48, **dkw)
    assert dict(fmod.flash_attention.launches_by_dtype) == after
    monkeypatch.setattr(layers, "_plain_route", plain_route)
    pos = torch.arange(48, device=cuda)[None, :].expand(2, -1)
    for q, k, v, window, out in records:
        want = plain_route(cfg, q, k, v, pos, window)
        g4 = out.reshape(2, 48, cfg.n_heads, cfg.hd).transpose(1, 2)
        w4 = want.reshape(2, 48, cfg.n_heads, cfg.hd).transpose(1, 2)
        if dtype == "float32":
            torch.testing.assert_close(g4, w4, rtol=0, atol=2e-6)
        else:
            assert _narrow_gate_share(g4, w4) <= 1
    monkeypatch.setattr(
        layers, "_flash_route",
        lambda cfg_, q, k, v, window: plain_route(cfg_, q, k, v, pos,
                                                  window))
    want, _ = steps.make_prefill_step(cfg, cache_capacity=56)(
        params, **batch)
    err = float((logits - want).abs().max())
    if dtype == "float32":
        assert err <= 1e-4 * float(want.abs().max())
    else:
        assert err <= 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("arch,dtype", [("llama3.2-3b", "float32"),
                                        ("hymba-1.5b", "bfloat16"),
                                        ("qwen3-moe-30b-a3b", "float32")])
def test_lm_tensor_parallel_on_two_logical_ranks(cuda, arch, dtype):
    """SMOKE prefill and decode over a (1, 2) mesh of two logical ranks on
    cuda:0 (models/parallel.py) against the one-device run on the same
    parameters: one flash launch a layer a rank in the prefill, the logits
    within 1e-4 of the largest |logit| in float32 (float32 partials summed
    in another order, then the layers) or the reference's 2e-2 in bf16, and
    a decode step under ``torch.cuda.set_sync_debug_mode("error")``: the
    executor never waits on the host."""
    from repro_torch.configs import get_config, override
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import steps
    from repro_torch.models.registry import build_model
    from repro_torch.models.sharding import make_policy

    cfg = override(get_config(arch, smoke=True), dtype=dtype)
    mesh = make_mesh((1, 2), ("data", "model"), devices=["cuda:0"] * 2)
    policy = make_policy(cfg, mesh)
    model = build_model(cfg)
    one = model.init(torch.Generator(device=cuda).manual_seed(0),
                     device=cuda)
    sm = model.init(torch.Generator(device=cuda).manual_seed(0), mesh=mesh)
    batch, _ = _lm_smoke_batch(cfg, cuda)
    want, cache1 = steps.make_prefill_step(cfg, cache_capacity=56)(
        one, **batch)
    before = fmod.flash_attention.launches
    got, cache2 = steps.make_prefill_step(cfg, cache_capacity=56,
                                          policy=policy)(sm, **batch)
    torch.cuda.synchronize()
    assert fmod.flash_attention.launches - before == 2 * cfg.n_layers
    tol = 1e-4 * float(want.abs().max()) if dtype == "float32" else 2e-2
    assert float((got - want).abs().max()) <= tol
    tok = want[:, -1].argmax(-1)[:, None]
    want, _ = steps.make_decode_step(cfg)(one, token=tok, cache=cache1,
                                          cache_index=48)
    decode = steps.make_decode_step(cfg, policy=policy)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, _ = decode(sm, token=tok, cache=cache2, cache_index=48)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert float((got - want).abs().max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_training_over_two_logical_ranks(cuda, dtype):
    """llama3.2-3b SMOKE trained over a (1, 2) mesh of two logical ranks
    on cuda:0 (``make_train_step(policy=)``; the ranks share one
    Parameter a shard) beside one device's step on the same parameters:
    after a first step, a step under
    ``torch.cuda.set_sync_debug_mode("error")`` (the mesh's forward,
    backward through the collectives, the float32-output row-parallel
    products' backward in bf16, and AdamW never wait on the host); the
    losses within 1e-5 relative in float32, 2e-2 in bf16; no flash launch
    (training attention is plain)."""
    from repro_torch.configs import get_config, override
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import steps
    from repro_torch.models.registry import build_model
    from repro_torch.models.sharding import make_policy
    from repro_torch.optim import adamw

    cfg = override(get_config("llama3.2-3b", smoke=True), dtype=dtype)
    mesh = make_mesh((1, 2), ("data", "model"), devices=["cuda:0"] * 2)
    model = build_model(cfg)
    one = model.init(torch.Generator(device=cuda).manual_seed(0), cuda,
                     trainable=True)
    sm = model.init(torch.Generator(device=cuda).manual_seed(0), mesh=mesh,
                    trainable=True)
    assert any(sh.key != (-1, -1) for sh in sm.shards)
    assert len(sm.copies) == len(sm.shards)   # one card: ranks share
    assert sm.ranks[0].final_norm is sm.ranks[1].final_norm
    opt = adamw.AdamWConfig(peak_lr=1e-2, warmup_steps=1, total_steps=10)
    rng = np.random.default_rng(3)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 48))).to(
        cuda) for k in ("tokens", "labels")}
    one_step = steps.make_train_step(cfg, opt, device=cuda)
    mesh_step = steps.make_train_step(cfg, opt,
                                      policy=make_policy(cfg, mesh))
    s1, s2 = adamw.init(opt, one), adamw.init(opt, sm)
    before = fmod.flash_attention.launches
    _, s1, want = one_step(one, s1, **batch)
    _, s2, got = mesh_step(sm, s2, **batch)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert float(got["loss"]) == pytest.approx(float(want["loss"]), rel=tol)
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, s2, got = mesh_step(sm, s2, **batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _, s1, want = one_step(one, s1, **batch)
    torch.cuda.synchronize()
    assert fmod.flash_attention.launches == before
    assert float(got["loss"]) == pytest.approx(float(want["loss"]), rel=tol)
    assert int(s2["step"]) == 2


@pytest.mark.gpu
def test_lm_training_over_distinct_cards_repeats_bitwise(cuda):
    """llama3.2-3b SMOKE in bf16 trained three steps over one rank a card
    ((2, 2) with FSDP over data on four cards, else (1, n)), twice from
    the same draw: the losses, gradient norms, every copy of every shard
    and its moments bitwise the same in both runs (the backward's sums
    keep their order across cards).  Needs two or more cards."""
    from repro_torch.configs import get_config, override
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import steps
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw

    n = min(torch.cuda.device_count(), 4)
    if n < 2:
        pytest.skip("needs two or more NVIDIA GPUs")
    shape = (2, 2) if n == 4 else (1, n)
    cfg = override(get_config("llama3.2-3b", smoke=True), dtype="bfloat16",
                   param_sharding="fsdp_tp")
    mesh = make_mesh(shape, ("data", "model"),
                     devices=[f"cuda:{i}" for i in range(n)])
    opt = adamw.AdamWConfig(peak_lr=1e-2, warmup_steps=1, total_steps=10)
    rng = np.random.default_rng(5)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 64)))
             for k in ("tokens", "labels")}
    runs = []
    for _ in range(2):
        sm = build_model(cfg).init(
            torch.Generator(device=cuda).manual_seed(0), mesh=mesh,
            trainable=True)
        step = steps.make_train_step(cfg, opt, policy=sm.policy)
        state = adamw.init(opt, sm)
        metrics = []
        for _ in range(3):
            _, state, m = step(sm, state, **batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        runs.append((metrics, [t.detach().cpu() for t in
                               sm.copies + state["m"] + state["v"]]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


# -- the MoE layer on the card (models/layers.py moe_route / moe_apply) ----

def _moe_layer(arch, seed, impl="global_sort", cf=None):
    """A SMOKE config's MoE layer (parameters drawn on the CPU, seed) and
    (3, 40, D) standard normal inputs, float32, on the CPU."""
    from repro_torch.configs import get_config, override
    from repro_torch.models import layers

    cfg = get_config(arch, smoke=True)
    cfg = override(cfg, moe_impl=impl, capacity_factor=cf or
                   cfg.capacity_factor)
    p = layers.init_moe(torch.Generator().manual_seed(seed), cfg, "cpu")
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (3, 40, cfg.d_model)).astype(np.float32))
    return cfg, p, x


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("impl", ["global_sort", "per_example"])
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mixtral-8x22b"])
def test_lm_moe_routing_on_card_is_the_cpu_routing(cuda, arch, impl, seed):
    """The router logits are an IEEE float32 product (no TF32): the card
    routes the same inputs as the CPU does, bitwise (chosen experts,
    buffer rows, keep), at capacity factor 0.5 (some dropped); the
    float32 output within 1e-5 of the CPU's largest |value|."""
    from repro_torch.models import layers

    cfg, p, x = _moe_layer(arch, seed, impl, cf=0.5)
    b, s, d = x.shape
    cap = layers.moe_capacity(cfg, s if impl == "per_example" else b * s)
    groups = x if impl == "per_example" else x.reshape(1, b * s, d)
    want = layers.moe_route(cfg, p["router"], groups, cap)
    got = layers.moe_route(cfg, p["router"].to(cuda), groups.to(cuda), cap)
    for i, name in ((0, "dest"), (1, "st"), (3, "keep"), (5, "flat_e")):
        assert torch.equal(got[i].cpu(), want[i]), name
    assert not bool(want[3].all())
    out_c, aux_c = layers.moe_apply(cfg, p, x)
    out_g, aux_g = layers.moe_apply(
        cfg, {k: v.to(cuda) for k, v in p.items()}, x.to(cuda))
    err = float((out_g.cpu() - out_c).abs().max())
    assert err <= 1e-5 * float(out_c.abs().max())
    assert abs(float(aux_g) - float(aux_c)) <= 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mixtral-8x22b"])
def test_lm_moe_combine_is_bitwise_repeatable(cuda, arch, dtype):
    """No float atomics: the combine gathers each token's k rows and sums
    them in a fixed order, so two calls on the card give the same bits."""
    from repro_torch.models import layers

    cfg, p, x = _moe_layer(arch, 4)
    p = {k: v.to(cuda) for k, v in p.items()}
    x = x.to(cuda, dtype)
    first, aux1 = layers.moe_apply(cfg, p, x)
    second, aux2 = layers.moe_apply(cfg, p, x)
    assert first.dtype == dtype
    assert torch.equal(first, second) and torch.equal(aux1, aux2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch,window", [("qwen3-moe-30b-a3b", 0),
                                         ("mixtral-8x22b", 32)])
def test_lm_moe_flash_route_matches_the_plain_route(cuda, arch, window,
                                                    dtype):
    """The flash route at qwen3-moe SMOKE's heads (H 4, Hkv 2, hd 32,
    causal) and mixtral SMOKE's (window 32), S = 80: one launch, against
    the plain route on the same rotated q, k, v."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import layers

    cfg = get_config(arch, smoke=True)
    assert cfg.window == window
    q, k, v = _lm_attention_inputs(cfg, 80, cuda, dtype)
    name = str(dtype).removeprefix("torch.")
    before = flash_attention.launches_by_dtype[name]
    got = layers.self_attention(cfg, q, k, v, None, window)
    assert flash_attention.launches_by_dtype[name] == before + 1
    pos = torch.arange(80, device=cuda)[None, :]
    want = layers._plain_route(cfg, q, k, v, pos, window)
    g4 = got.reshape(1, 80, cfg.n_heads, cfg.hd).transpose(1, 2)
    w4 = want.reshape(1, 80, cfg.n_heads, cfg.hd).transpose(1, 2)
    if dtype == torch.float32:
        torch.testing.assert_close(g4, w4, rtol=0, atol=2e-6)
    else:
        assert _narrow_gate_share(g4, w4) <= 1


# -- merge-sort Kendall (kernels/kendall_merge.py, csrc/kendall_merge.cu) ---

def _kendall_rows(n, l, kind, seed):
    """(n, l) float32 rows: normal ("float", "narrow") or integer levels
    floor(8 u) ("ties", ~12 % of a row a value); row 1 constant (one run as
    long as the row); row 0 one tied pair, its only tie; above l = 33, row 5
    a run of exactly SHORT_RUN_MAX samples; "float" and "ties" also row 4
    one value but in its last sample (a run of l - 1) and, above 33, row 6
    a run of SHORT_RUN_MAX + 1, so a launch takes the kernel's uint32 keys
    and its two-sort path; "narrow" has neither, so its launches keep
    uint16 keys and one sort a pair."""
    from repro_torch.kernels.kendall_merge import SHORT_RUN_MAX as r
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, l)) if kind != "ties"
         else np.floor(8 * rng.random((n, l)))).astype(np.float32)
    x[1] = 2.5
    if kind != "ties":
        x[0, 1] = x[0, 0]
    if n > 4 and kind != "narrow":
        x[4, :-1] = -1.0
    if n > 6 and l > r + 1:
        x[5] = rng.standard_normal(l)
        x[5, :r] = 7.0
        if kind != "narrow":
            x[6] = rng.standard_normal(l)
            x[6, :r + 1] = 7.0
    return torch.from_numpy(x)


def _kendall_operand(x, t, device):
    from repro_torch.core.measures import kendall_rank_transform
    return pad_operands(kendall_rank_transform(x.to(device)), t, 8)


# P E of every instantiation of the kendall_merge kernel, in its order
# (csrc/kendall_merge.cu KM_SHAPES; test_kendall_tops_are_the_instantiations
# holds this against the library's list)
KENDALL_TOPS = (64, 96, 128, 192, 256, 384, 512, 768, 1024, 1536, 2048, 2560,
                3072, 4096, 5120, 6144, 8192, 10240, 12288, 14336, 16384)


def _kendall_shapes():
    """(n, n_cols, l, t, j_start, pass_tiles): l at the top of every E
    instantiation of the kernel and one past it (the next E's first), l =
    2, 31, 32, 33, the paper's 5,072 and 16,384 (MAX_KERNEL_L); the triangle
    and the grid in turn, ids past the end at some."""
    ls = {2, 31, 32, 33, 5072}
    for top in KENDALL_TOPS:
        ls |= {top, min(top + 1, 16_384)}
    shapes = []
    for i, l in enumerate(sorted(ls)):
        t = 4 if l > 6_144 else 8
        shapes.append((9 + i % 5, (7 + i % 3) if i % 2 else None, l, t,
                       i % 4, 3))
    return shapes


@pytest.mark.gpu
def test_kendall_tops_are_the_instantiations(cuda):
    """KENDALL_TOPS, the edges the kernel tests take, are the P E of the
    kernel's instantiations as its library lists them, and a launch at each
    takes that instantiation."""
    import ctypes
    from repro_torch.kernels import _build
    lib = _build.load("kendall_merge")
    buf = (ctypes.c_int * 192)()
    n = lib.kendall_merge_instantiations(buf, 64)
    shapes = [tuple(buf[3 * k:3 * k + 3]) for k in range(n)]
    assert tuple(p * e for p, e, _ in shapes) == KENDALL_TOPS
    out = (ctypes.c_int * 8)()
    for p, e, groups in shapes:
        assert lib.kendall_merge_occupancy(p * e, 8, 0, out) == 0
        assert tuple(out[:3]) == (p, e, groups) and out[5] >= 1


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["float", "ties", "narrow"])
@pytest.mark.parametrize("tau_b", [False, True])
@pytest.mark.parametrize("n,n_cols,l,t,j_start,pass_tiles", [
    (13, None, 2, 4, 0, 10),       # l = 2
    (37, None, 96, 8, 0, 15),      # every tile; padding rows
    (37, None, 97, 8, 13, 6),      # ids past the end clamp
    (29, 21, 130, 16, 0, 4),       # the grid
    (21, None, 257, 8, 1, 5),
    (10, 19, 1100, 8, 0, 3),
    (8, None, 5072, 8, 0, 1),      # the paper's sample count
    *_kendall_shapes(),
])
def test_kendall_merge_kernel_matches_plain(cuda, kind, tau_b, n, n_cols,
                                            l, t, j_start, pass_tiles):
    from repro_torch.kernels.kendall_merge import (
        SHORT_RUN_MAX, kendall_merge_tiles, kendall_merge_tiles_plain,
        rank_structure)
    u = _kendall_operand(_kendall_rows(n, l, kind, n + l), t, cuda)
    v = gc = None
    if n_cols is not None:
        v = _kendall_operand(_kendall_rows(n_cols, l, kind, l), t, cuda)
        gc = v.shape[0] // t
    # the launch's key width: uint32 when a non-constant row of the row
    # operand has a run longer than SHORT_RUN_MAX (rows 4 and 6)
    st = rank_structure(u[:, :l].float())
    if kind == "narrow":
        assert not st.wide
    elif l > SHORT_RUN_MAX + 1:
        assert st.wide
    if l > SHORT_RUN_MAX + 1:
        assert int(st.longest[5]) == SHORT_RUN_MAX
    div = None if tau_b else float(l * (l - 1) // 2)
    for spec in (None, EpilogueSpec(div=div, clip=(-1.0, 1.0))):
        kw = dict(t=t, l_blk=8, pass_tiles=pass_tiles, epilogue=spec,
                  v_pad=v, grid_cols=gc, l=l, tau_b=tau_b)
        before = kendall_merge_tiles.launches
        got = kendall_merge_tiles(u, j_start, **kw)
        want = kendall_merge_tiles_plain(u, j_start, **kw)
        torch.cuda.synchronize()
        assert kendall_merge_tiles.launches == before + 1
        assert got.device.type == "cuda"
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["float", "ties", "narrow"])
@pytest.mark.parametrize("l", [96, 1100, 5072])
def test_kendall_merge_kernel_diagonal_tiles(cuda, kind, l):
    """Every diagonal tile of the triangle: with the rows as their own
    columns the kernel counts each pair once and writes it to both cells;
    with a second operand of the same shape it counts both.  Bitwise the
    plain version either way, tau-a and tau-b, and exactly symmetric."""
    from repro_torch.kernels.kendall_merge import (
        kendall_merge_tiles, kendall_merge_tiles_plain)
    u = _kendall_operand(_kendall_rows(37, l, kind, l), 8, cuda)
    v = _kendall_operand(_kendall_rows(37, l, kind, l + 1), 8, cuda)
    diagonal = [0, 5, 9, 12, 14]        # m = 5 tiles of 8 rows
    for tau_b in (False, True):
        for second in (None, v):
            kw = dict(t=8, l_blk=8, pass_tiles=15, v_pad=second, l=l,
                      tau_b=tau_b)
            got = kendall_merge_tiles(u, 0, **kw)
            want = kendall_merge_tiles_plain(u, 0, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
            if second is None:
                d = got[diagonal]
                assert torch.equal(d, d.transpose(1, 2))


@pytest.mark.gpu
def test_kendall_merge_kernel_at_and_above_its_shared_memory_limit(cuda):
    from repro_torch.kernels.kendall_merge import (
        MAX_KERNEL_L, kendall_merge_tiles, kendall_merge_tiles_plain)
    x = _kendall_rows(8, MAX_KERNEL_L + 1, "ties", 3)
    u = _kendall_operand(x, 8, cuda)
    kw = dict(t=8, l_blk=8, pass_tiles=1, l=MAX_KERNEL_L)
    got = kendall_merge_tiles(u, 0, **kw)
    assert torch.equal(got, kendall_merge_tiles_plain(u, 0, **kw))
    with pytest.raises(ValueError, match=f"l <= {MAX_KERNEL_L}"):
        kendall_merge_tiles(u, 0, **{**kw, "l": MAX_KERNEL_L + 1})


@pytest.mark.gpu
@pytest.mark.parametrize("measure", ["kendall", "kendall_tau_b"])
def test_kendall_corr_on_card_runs_the_merge_kernel(cuda, measure):
    """corr at l >= 96 on the card: the merge kernel's launches, no
    pcc_tiles launch, and the bits of the CPU run (the plain version),
    tau-b too: its per-row scales come from the host's correctly rounded
    float32 sqrt and division on either device (tau_b_scale)."""
    from repro_torch.kernels.kendall_merge import kendall_merge_tiles
    x = _kendall_rows(300, 200, "ties", 5)
    y = _kendall_rows(70, 200, "float", 6)
    for yy in (None, y):
        kw = dict(measure=measure, t=64, l_blk=64, max_tiles_per_pass=4)
        a0, p0 = kendall_merge_tiles.launches, pcc_tiles.launches
        got = corr(x.to(cuda), None if yy is None else yy.to(cuda), **kw)
        torch.cuda.synchronize()
        assert kendall_merge_tiles.launches > a0
        assert pcc_tiles.launches == p0
        want = corr(x, yy, device="cpu", **kw)
        assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_kendall_tau_b_scale_same_bits_on_card_and_cpu(cuda):
    """The tau-b scales of every tie count up to n0 at l = 5,072: the same
    bits from card and CPU ties, each the correctly rounded float32
    1/sqrt(n0 - ties) (torch.sqrt on the CPU is not; the card's is)."""
    from repro_torch.kernels.kendall_merge import tau_b_scale
    l = 5072
    n0 = l * (l - 1) // 2
    ties = torch.arange(0, n0 + 1, dtype=torch.int32)
    host = tau_b_scale(ties, l)
    card = tau_b_scale(ties.to(cuda), l)
    assert card.device.type == "cuda"
    assert torch.equal(card.cpu(), host)
    nz = (n0 - ties[:-1]).double()
    torch_card = 1.0 / torch.sqrt(nz.to(cuda).float())
    assert torch.equal(torch_card.cpu(), host[:-1])
    assert host[-1] == 0.0


# -- float16 and int16 operands, inference tensors, serving ------------------


@pytest.mark.gpu
@pytest.mark.parametrize("grid", [False, True])
@pytest.mark.parametrize("n,l,t,l_blk,kk", [
    (300, 120, 64, 64, 10),
    (260, 90, 130, 6, 33),     # t past a block, l_pad 90 (a padded copy)
    (600, 1000, 256, 512, 10),
])
def test_f16_kernels_within_the_narrow_gate(cuda, grid, n, l, t, l_blk, kk):
    """float16 tiles (pcc_tiles_sm90_f16) within the narrow gate of the
    plain version, the planted faults refused by FAULT_SHARE, split-
    invariant bitwise; the float16 select's (pcc_topk_select_f16) values
    bitwise the tiles'; each counted under float16."""
    u = _operand(n, l, t, l_blk, cuda).half()
    v = _operand(n // 2 + 3, l, t, l_blk, cuda, seed=1).half() if grid \
        else None
    m = u.shape[0] // t
    gc = v.shape[0] // t if grid else None
    total = m * gc if grid else m * (m + 1) // 2
    spec = EpilogueSpec(div=3.0, clip=(-1.0, 1.0))
    kw = dict(t=t, l_blk=l_blk, epilogue=spec, v_pad=v, grid_cols=gc)
    before = pcc_tiles.launches_by_dtype["float16"]
    got = _within_narrow_gate(u, 0, {**kw, "pass_tiles": total})
    assert pcc_tiles.launches_by_dtype["float16"] > before
    parts = torch.cat([pcc_tiles(u, j, pass_tiles=min(3, total - j), **kw)
                       for j in range(0, total, 3)])
    assert torch.equal(got, parts)
    sel0 = pcc_topk_tiles.select_by_dtype["float16"]
    tk = pcc_topk_tiles(u, 0, total, pass_tiles=total, kk=kk,
                        n_cols_valid=(v if grid else u).shape[0],
                        symmetric_problem=not grid, **kw)
    assert pcc_topk_tiles.select_by_dtype["float16"] == sel0 + 1
    ids = np.arange(total)
    ys, xs = (grid_job_coord_batch(m, gc, ids) if grid
              else job_coord_batch(m, ids))
    r = torch.zeros(u.shape[0], (v if grid else u).shape[0], device=cuda)
    r.view(m, t, -1, t)[torch.as_tensor(ys, device=cuda), :,
                        torch.as_tensor(xs, device=cuda), :] = got
    if not grid:
        r = torch.where(torch.ones_like(r, dtype=torch.bool).triu(), r, r.T)
    for side in range(len(tk) // 2):
        vals, cols = tk[2 * side], tk[2 * side + 1]
        ok = cols >= 0
        rows = (torch.arange(vals.shape[0] * t, device=cuda)
                .view(-1, t, 1).expand_as(cols))
        assert torch.equal(vals[ok], (r if side == 0 else r.T)[
            rows[ok], cols[ok].long()])


@pytest.mark.gpu
def test_f16_corr_on_card_runs_the_f16_kernels(cuda):
    """corr(compute_dtype=float16) on the card: only the float16 kernels
    launch, the result lies within the narrow gate's scale of the CPU run
    (the plain version), and DeviceTopKSink is bitwise TopKSink."""
    rng = np.random.default_rng(31)
    x = torch.from_numpy(rng.standard_normal((300, 200)).astype(np.float32))
    kw = dict(t=64, l_blk=64, max_tiles_per_pass=5, compute_dtype="float16")
    t0 = dict(pcc_tiles.launches_by_dtype)
    got = corr(x.to(cuda), **kw)
    torch.cuda.synchronize()
    launched = {k: v - t0[k] for k, v in pcc_tiles.launches_by_dtype.items()
                if v != t0[k]}
    assert set(launched) == {"float16"}
    want = corr(x, device="cpu", **kw)
    # |kernel - plain| <= 16 * 2^-24 * sqrt(l_pad) * G, G <= 1 for Pearson
    assert float((got.cpu() - want).abs().max()) <= 16 * 2.0 ** -24 * 16
    dev = corr(x.to(cuda), sink=DeviceTopKSink(7), **kw)
    host = corr(x.to(cuda), sink=TopKSink(7), **kw)
    np.testing.assert_array_equal(dev["indices"], host["indices"])
    np.testing.assert_array_equal(dev["values"], host["values"])


@pytest.mark.gpu
def test_int16_kendall_on_card_is_the_int8_run(cuda):
    """int16 Kendall signs run the int8 kernels (narrowed exactly): bitwise
    the int8 run and the CPU run, on the tiles and the top-k."""
    x = torch.from_numpy(np.random.default_rng(32).standard_normal(
        (300, 40)).astype(np.float32))
    kw = dict(measure="kendall", t=64, l_blk=64)
    i8 = pcc_tiles.launches_by_dtype["int8"]
    got = corr(x.to(cuda), compute_dtype="int16", **kw)
    torch.cuda.synchronize()
    assert pcc_tiles.launches_by_dtype["int8"] == i8 + 1
    assert torch.equal(got, corr(x.to(cuda), compute_dtype="int8", **kw))
    assert torch.equal(got.cpu(), corr(x, compute_dtype="int16",
                                       device="cpu", **kw))
    a = corr(x.to(cuda), compute_dtype="int16", sink=DeviceTopKSink(5), **kw)
    b = corr(x.to(cuda), compute_dtype="int8", sink=DeviceTopKSink(5), **kw)
    np.testing.assert_array_equal(a["indices"], b["indices"])
    np.testing.assert_array_equal(a["values"], b["values"])


@pytest.mark.gpu
@pytest.mark.parametrize("measure", ["pearson", "kendall"])
def test_inference_tensor_on_card_runs_uncached(cuda, measure):
    """A card tensor made under torch.inference_mode(): corr gives the bits
    of a normal tensor of the same values and leaves no cache entry (l =
    120: kendall takes the merge kernel, 4-tile passes)."""
    clear_prepared_cache()
    a = np.random.default_rng(33).standard_normal((300, 120)).astype(
        np.float32)
    kw = dict(t=64, l_blk=64, max_tiles_per_pass=4, measure=measure)
    with torch.inference_mode():
        xi = torch.from_numpy(a).to(cuda)
        inside = corr(xi, **kw)
    outside = corr(xi, **kw)
    assert prepared_cache_stats()["size"] == 0
    want = corr(torch.from_numpy(a).to(cuda), **kw)
    assert torch.equal(inside, want) and torch.equal(outside, want)
    clear_prepared_cache()


@pytest.mark.gpu
def test_served_query_bitwise_corr_on_card(cuda):
    """A CorrServer on the card: coalesced dense and top-k answers are
    bitwise standalone corr(probes, corpus) on the card, through the
    kernels (launches < requests), one corpus transform."""
    import threading

    from repro_torch.serving import CorrServer
    rng = np.random.default_rng(34)
    corpus = rng.random((700, 300), dtype=np.float32)
    probes = [rng.random((m, 300), dtype=np.float32) for m in (1, 7, 64, 30)]
    kw = dict(t=64, l_blk=64)
    p0 = pcc_tiles.launches
    s0 = pcc_topk_tiles.launches["select"]
    with CorrServer(corpus, max_wait_s=0.2, device=cuda, **kw) as srv:
        futs = [None] * 8

        def go(i):
            futs[i] = srv.submit(probes[i % 4], k=None if i < 4 else 10)

        threads = [threading.Thread(target=go, args=(i,)) for i in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        res = [f.result(timeout=60) for f in futs]
        stats = srv.stats()
        x = srv.corpus.x
    for i, r in enumerate(res):
        p = probes[i % 4]
        if i < 4:
            want = corr(torch.from_numpy(p).to(cuda), x, **kw).cpu().numpy()
            np.testing.assert_array_equal(r.value, want)
        else:
            want = corr(torch.from_numpy(p).to(cuda), x, sink=TopKSink(10),
                        **kw)
            np.testing.assert_array_equal(r.value["indices"],
                                          want["indices"])
            np.testing.assert_array_equal(r.value["values"], want["values"])
    assert stats["batches"] < 8 and stats["corpus"]["misses"] == 1
    assert pcc_tiles.launches > p0
    assert pcc_topk_tiles.launches["select"] > s0


@pytest.mark.gpu
@pytest.mark.parametrize("n_cols", [None, 150])
def test_recovery_on_card_injected_transient_and_oom_bitwise(cuda, n_cols):
    """corr(recovery=) on the card under a transient fault twice and an
    out-of-memory error at the pass launch: the log reads retry, retry,
    shrink_pass, the kernels ran (never a plain version), and the dense
    and DeviceTopKSink(10) results are bitwise the fault-free runs."""
    from repro_torch.runtime.faults import FaultPlan, FaultSpec, RetryPolicy
    rng = np.random.default_rng(35)
    x = torch.from_numpy(rng.random((600, 300), dtype=np.float32)).to(cuda)
    y = (None if n_cols is None else torch.from_numpy(
        rng.random((n_cols, 300), dtype=np.float32)).to(cuda))
    kw = dict(t=96, l_blk=64, max_tiles_per_pass=6)
    for sink in (None, DeviceTopKSink):
        base = corr(x, y, sink=None if sink is None else sink(10), **kw)
        plan = FaultPlan([FaultSpec("pass_launch", "transient", (2, 3)),
                          FaultSpec("pass_launch", "oom", (6,))])
        pol = RetryPolicy(sleep=lambda s: None)
        p0 = pcc_tiles.launches
        s0 = pcc_topk_tiles.launches["select"]
        with plan.armed():
            got = corr(x, y, sink=None if sink is None else sink(10),
                       recovery=pol, **kw)
        torch.cuda.synchronize()
        assert [e["action"] for e in pol.log] == ["retry", "retry",
                                                  "shrink_pass"]
        assert pol.log[-1]["max_tiles_per_pass"] == 3
        if sink is None:
            assert pcc_tiles.launches > p0
            assert got.device == x.device and torch.equal(got, base)
        else:
            assert pcc_topk_tiles.launches["select"] > s0
            np.testing.assert_array_equal(got["indices"], base["indices"])
            assert got["values"].tobytes() == base["values"].tobytes()


@pytest.mark.gpu
def test_partial_write_and_crash_on_card_bitwise(cuda, tmp_path):
    """HostSink(path=) on the card: a partial write is retried, a crash at
    the sidecar commit propagates, and corr(resume_from=) launches only the
    passes the sidecar lacks; the result is bitwise DenseSink's .cpu()."""
    from repro_torch.core.sinks import HostSink
    from repro_torch.runtime.faults import (CrashFault, FaultPlan,
                                            FaultSpec, RetryPolicy)
    rng = np.random.default_rng(36)
    x = torch.from_numpy(rng.random((600, 300), dtype=np.float32)).to(cuda)
    kw = dict(t=96, l_blk=64, max_tiles_per_pass=6)   # 28 tiles, 5 passes
    want = corr(x, **kw).cpu().numpy()
    path = str(tmp_path / "r.mm")
    # sink_commit: 1 open, then passes 0, 1, ...: the crash kills pass 3's
    plan = FaultPlan([FaultSpec("sink_write", "partial_write", (2,), 0.5),
                      FaultSpec("sink_commit", "crash", (5,))])
    pol = RetryPolicy(sleep=lambda s: None)
    with plan.armed(), pytest.raises(CrashFault):
        corr(x, sink=HostSink(path=path), recovery=pol, **kw)
    assert [e["action"] for e in pol.log] == ["retry", "raise"]
    p0 = pcc_tiles.launches
    got = corr(x, resume_from=path, **kw)
    assert pcc_tiles.launches - p0 == 2     # passes 3 and 4
    np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
def test_sharded_host_sink_on_card_assembles_bitwise(cuda, tmp_path):
    """Three simulated hosts' ShardedHostSink shards on the card assemble
    bitwise DenseSink's .cpu(); rows read lazily the same."""
    from repro_torch.core.sinks import ShardedHostSink, assemble, \
        open_manifest
    rng = np.random.default_rng(37)
    x = torch.from_numpy(rng.random((600, 300), dtype=np.float32)).to(cuda)
    kw = dict(t=96, l_blk=64, max_tiles_per_pass=6)
    want = corr(x, **kw).cpu().numpy()
    d = str(tmp_path)
    for h in range(3):
        r = corr(x, sink=ShardedHostSink(d, host=h, n_hosts=3), **kw)
        assert r["complete"]
    np.testing.assert_array_equal(assemble(d), want)
    np.testing.assert_array_equal(open_manifest(d).rows(100, 250),
                                  want[100:250])


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["dense", "split", "shard_u", "topk",
                                  "grid", "masked", "pvalues"])
def test_two_rank_mesh_on_one_card_is_the_one_device_run(cuda, case):
    """A mesh of 2 logical ranks on cuda:0 (two streams, per-rank pieces,
    the sinks on their side streams): bitwise the one-device run, through
    the CUDA kernels."""
    from repro_torch.core.significance import PermutationSpec
    from repro_torch.launch.mesh import make_mesh
    rng = np.random.default_rng(38)
    x = torch.from_numpy(rng.random((600, 300), dtype=np.float32)).to(cuda)
    y = torch.from_numpy(rng.random((250, 300), dtype=np.float32)).to(cuda)
    mesh = make_mesh((2,), ("d",), devices=["cuda:0"] * 2)
    kw = dict(t=96, l_blk=64)                       # 28 tiles
    if case == "split":
        kw["max_tiles_per_pass"] = 5
    args, extra = (x,), {}
    if case == "shard_u":
        extra = dict(shard_u=True, max_tiles_per_pass=5)
    elif case == "topk":
        kw["max_tiles_per_pass"] = 5
    elif case == "grid":
        args = (x, y)
    elif case == "masked":
        x[3, :7] = float("nan")
        extra = dict(where="nan", max_tiles_per_pass=5)
    elif case == "pvalues":
        extra = dict(pvalues=PermutationSpec(16, key=0, chunk=6),
                     max_tiles_per_pass=5)
    p0, s0 = pcc_tiles.launches, pcc_topk_tiles.launches["select"]
    if case == "topk":
        got = corr(x, mesh=mesh, sink=DeviceTopKSink(10), **kw)
        plan = ExecutionPlan.create(600, 300, p=2, **kw)
        # one select a rank with tiles in a pass
        assert pcc_topk_tiles.launches["select"] - s0 == sum(
            1 for k in range(plan.n_pass) for _, c in plan.rank_slots(k) if c)
        want = corr(x, sink=DeviceTopKSink(10), **kw)
        np.testing.assert_array_equal(got["indices"], want["indices"])
        assert got["values"].tobytes() == want["values"].tobytes()
        return
    got = corr(*args, mesh=mesh, **kw, **extra)
    n_launch = pcc_tiles.launches - p0
    extra.pop("shard_u", None)
    want = corr(*args, **kw, **extra)
    torch.cuda.synchronize()
    assert n_launch > 0
    if case == "pvalues":
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    else:
        assert got.device == x.device and torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["dense", "shard_u", "topk", "grid",
                                  "pvalues", "sharded", "device_loss"])
def test_mesh_over_distinct_cards_is_the_one_device_run(cuda, case,
                                                        tmp_path):
    """A mesh with one rank a card (peer copies into the first card's
    DenseSink, host copies from each card): bitwise the one-device run.
    Needs two or more cards."""
    from repro_torch.core.significance import PermutationSpec
    from repro_torch.core.sinks import ShardedHostSink, assemble
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.faults import FaultPlan, RetryPolicy
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more NVIDIA GPUs")
    rng = np.random.default_rng(39)
    x = torch.from_numpy(rng.random((600, 300), dtype=np.float32)).to(cuda)
    y = torch.from_numpy(rng.random((250, 300), dtype=np.float32)).to(cuda)
    mesh = make_mesh((torch.cuda.device_count(),), ("d",))
    kw = dict(t=96, l_blk=64, max_tiles_per_pass=3)
    if case == "topk":
        got = corr(x, mesh=mesh, sink=DeviceTopKSink(10), **kw)
        want = corr(x, sink=DeviceTopKSink(10), **kw)
        np.testing.assert_array_equal(got["indices"], want["indices"])
        assert got["values"].tobytes() == want["values"].tobytes()
        return
    if case == "sharded":
        d = str(tmp_path)
        for h in range(2 if mesh.size % 2 == 0 else mesh.size):
            n_hosts = 2 if mesh.size % 2 == 0 else mesh.size
            r = corr(x, mesh=mesh, sink=ShardedHostSink(
                d, host=h, n_hosts=n_hosts), **kw)
            assert r["complete"]
        np.testing.assert_array_equal(assemble(d), corr(x, **kw).cpu())
        return
    if case == "device_loss":
        pol = RetryPolicy(sleep=lambda s: None)
        with FaultPlan.single("pass_launch", "device_loss", at=2).armed():
            got = corr(x, mesh=mesh, recovery=pol, **kw)
        assert [e["p"] for e in pol.log] == [mesh.size - 1]
        assert torch.equal(got, corr(x, **kw))
        return
    args = (x, y) if case == "grid" else (x,)
    extra = {}
    if case == "shard_u":
        extra = dict(shard_u=True)
    elif case == "pvalues":
        extra = dict(pvalues=PermutationSpec(16, key=0, chunk=6))
    got = corr(*args, mesh=mesh, **kw, **extra)
    extra.pop("shard_u", None)
    want = corr(*args, **kw, **extra)
    if case == "pvalues":
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    else:
        assert got.device == x.device and torch.equal(got, want)


# -- LM training on the card (models/steps.make_train_step) ------------------


def _train_grads(cfg, model, batch):
    from repro_torch.models import steps
    from repro_torch.tree import named_leaves
    metrics, grads = steps.grads_of(cfg, model, batch)
    return metrics, dict(zip([n for n, _ in named_leaves(model)], grads))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3.2-3b", "hymba-1.5b",
                                  "seamless-m4t-medium"])
def test_lm_training_on_card_takes_the_plain_route(cuda, arch):
    """A SMOKE training step's gradients on the card (float32, S = 48,
    across hymba's window): no flash launch under autograd (the kernel has
    no backward), every attention leaf's gradient non-zero and within 1e-5
    of the CPU's largest |g| of that leaf, the loss within 1e-5; then a
    no_grad prefill of the same model still launches the flash kernel once
    a (decoder) attention layer, as serving does."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fmod
    from repro_torch.models import steps
    from repro_torch.models.registry import build_model

    cfg = get_config(arch, smoke=True)
    cpu_model = build_model(cfg).init(torch.Generator().manual_seed(0),
                                      "cpu", trainable=True)
    card_model = copy.deepcopy(cpu_model).to(cuda)
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 48)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (2, 48)).astype(np.int32)}
    if cfg.enc_dec:
        batch["src"] = rng.standard_normal((2, 48, cfg.d_model)).astype(
            np.float32)
    before = fmod.flash_attention.launches
    m_card, g_card = _train_grads(cfg, card_model,
                                  steps.as_batch(batch, cuda))
    torch.cuda.synchronize()
    assert fmod.flash_attention.launches == before
    m_cpu, g_cpu = _train_grads(cfg, cpu_model, steps.as_batch(batch, "cpu"))
    assert float(m_card["loss"]) == pytest.approx(float(m_cpu["loss"]),
                                                  rel=1e-5)
    attn = [n for n in g_cpu if ".attn." in n or ".xattn." in n]
    assert attn
    for name, want in g_cpu.items():
        got = g_card[name].cpu()
        scale = float(want.abs().max())
        if name in attn:
            assert float(got.abs().max()) > 0, name
        assert float((got - want).abs().max()) <= 1e-5 * max(scale, 1e-30), \
            name
    # serving is unchanged: a no_grad prefill launches the kernel
    n_attn = cfg.n_layers
    before = fmod.flash_attention.launches
    prefill = steps.make_prefill_step(cfg, cache_capacity=64)
    kw = {"tokens": torch.from_numpy(batch["tokens"]).long().to(cuda)}
    if cfg.enc_dec:
        kw["src"] = torch.from_numpy(batch["src"]).to(cuda)
    prefill(card_model, **kw)
    torch.cuda.synchronize()
    assert fmod.flash_attention.launches == before + n_attn


@pytest.mark.gpu
def test_lm_flash_refuses_autograd_inputs_on_card(cuda):
    from repro_torch.kernels import ops
    q = torch.randn(1, 4, 64, 32, device=cuda, requires_grad=True)
    k = torch.randn(1, 2, 64, 32, device=cuda)
    v = torch.randn(1, 2, 64, 32, device=cuda)
    with pytest.raises(ValueError, match="no backward"):
        ops.flash_mha(q, k, v, blk=64)
    with torch.no_grad():
        assert ops.flash_mha(q, k, v, blk=64).shape == q.shape


@pytest.mark.gpu
def test_lm_train_step_and_adamw_on_card_match_the_cpu(cuda):
    """make_train_step on the card for llama SMOKE: AdamW fed the CPU's
    gradients gives the CPU's update within 1e-6 of each leaf's largest
    value, and three steps on one batch lower the loss."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models import steps
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw
    from repro_torch.tree import named_leaves

    cfg = get_config("llama3.2-3b", smoke=True)
    opt = adamw.AdamWConfig(peak_lr=1e-2, warmup_steps=1, total_steps=10)
    cpu_model = build_model(cfg).init(torch.Generator().manual_seed(0),
                                      "cpu", trainable=True)
    card_model = copy.deepcopy(cpu_model).to(cuda)
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 48)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (2, 48)).astype(np.int32)}
    _, grads = steps.grads_of(cfg, cpu_model, steps.as_batch(batch, "cpu"))
    s_cpu, s_card = adamw.init(opt, cpu_model), adamw.init(opt, card_model)
    adamw.update(opt, grads, s_cpu, cpu_model)
    adamw.update(opt, [g.to(cuda) for g in grads], s_card, card_model)
    for (name, a), (_, b) in zip(named_leaves(cpu_model),
                                 named_leaves(card_model)):
        scale = float(a.detach().abs().max())
        assert float((b.detach().cpu() - a.detach()).abs().max()) <= \
            1e-6 * scale, name
    step = steps.make_train_step(cfg, opt, device=cuda)
    losses = []
    for _ in range(3):
        _, s_card, m = step(card_model, s_card, **batch)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0] * 1.05


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["nemotron-4-340b", "qwen2-vl-72b"])
def test_sequence_cache_decode_on_card_matches_the_cpu(cuda, arch):
    """kv_cache_shard="sequence" over a (1, 2) mesh of two logical ranks
    on cuda:0 at float32 SMOKE (each rank half the cache's slots, decode
    combining the ranks' partial softmaxes) against the same mesh of CPU
    ranks on the same parameters: the prefill and 4 decode steps' logits
    within 1e-5 of the largest |logit|, the assembled caches too."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_reference
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import steps
    from repro_torch.models.registry import build_model
    from repro_torch.models.sharding import make_policy
    from repro_torch.tree import named_leaves, stacked_tree

    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              kv_cache_shard="sequence")
    one = build_model(cfg).init(torch.Generator().manual_seed(0),
                                device="cpu")
    names, leaves = zip(*named_leaves(one))
    tree = stacked_tree(names, leaves)

    def as_numpy(node):
        return {k: as_numpy(v) for k, v in node.items()} \
            if isinstance(node, dict) else node.numpy()
    params = as_numpy(tree)
    runs, feed = [], []
    for dev in ("cpu", "cuda:0"):
        mesh = make_mesh((1, 2), ("data", "model"), devices=[dev] * 2)
        policy = make_policy(cfg, mesh)
        sm = lm_params_from_reference(cfg, params, mesh=mesh)
        batch, dpos = _lm_smoke_batch(cfg, dev)
        logits, cache = steps.make_prefill_step(
            cfg, cache_capacity=56, policy=policy)(sm, **batch)
        assert cache.by_positions(0)
        decode = steps.make_decode_step(cfg, policy=policy)
        got = [logits.float().cpu()]
        for t in range(4):
            if len(feed) == t:      # the CPU run's greedy tokens, fed to both
                feed.append(got[-1][:, -1].argmax(-1)[:, None])
            tok = feed[t].to(dev)
            kw = {} if not dpos else {"positions": dpos["positions"] + t}
            logits, cache = decode(sm, token=tok, cache=cache,
                                   cache_index=48 + t, **kw)
            got.append(logits.float().cpu())
        runs.append((got, [{k: v.float().cpu() for k, v in c.items()}
                           for c in cache.assemble()]))
    (cpu, cpu_cache), (card, card_cache) = runs
    for a, b in zip(cpu, card):
        assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max())
    for a, b in zip(cpu_cache, card_cache):
        for k in a:
            assert float((a[k] - b[k]).abs().max()) <= \
                1e-5 * max(float(a[k].abs().max()), 1e-30)
