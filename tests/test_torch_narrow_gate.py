"""The narrow gate (kernels/narrow_gate.py), which holds the
tensor-core tiles of bf16 and fp8 operands against the plain version, and
the wrapper's sample-axis padding for TMA (tma_operand, for the bf16, fp8
and int8 operands of the tensor-core kernel), on the CPU.

- The gate accepts the plain version summed the way the tensor-core kernel
  sums, in float32 chunks of 128 samples (fp8's promotion interval) added
  into a float32 accumulator, and the reference's tiles (JAX, interpret
  mode) on the same operands: both are the same exact products summed in
  float32 in other orders.
- The gate refuses the two planted faults (a 128-sample chunk of U zeroed,
  and counted twice) by at least 10x.
- Zero-padding the sample axis leaves the plain version's tiles bitwise
  unchanged (zero samples add exactly zero).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.plan import ExecutionPlan as RefPlan
from repro.kernels.pcc_tile import pcc_tiles as ref_pcc_tiles
from repro_torch import convert
from repro_torch.core.pcc import transform
from repro_torch.core.plan import pad_operands, pad_scales
from repro_torch.core.quantize import quantize_rows
from repro_torch.kernels.narrow_gate import (FAULT_CHUNK, FAULT_SHARE,
                                             NARROW_GATE, gate_share,
                                             narrow_gate, narrow_gate_unit,
                                             planted_fault_shares,
                                             planted_faults)
from repro_torch.kernels.pcc_tile import (TMA_ALIGN, EpilogueSpec,
                                          pcc_tiles_plain, tma_operand)

DTYPES = ["bfloat16", "float8_e4m3fn", "float8_e5m2"]
# the operand types the tensor-core tile kernel reads through TMA
TMA_DTYPES = DTYPES + ["int8"]
# n, l, t, l_blk, j_start, pass_tiles: ragged n and l, a tile narrower than
# the kernel's 128-row block, sample axes shorter and longer than a chunk
SHAPES = [(37, 29, 8, 8, 0, 15), (60, 300, 16, 20, 2, 9),
          (90, 700, 32, 64, 1, 12)]


def _operand(n, l, t, l_blk, dtype, seed):
    """A Pearson operand of `dtype`: bf16 (no scales) or fp8- or
    int8-quantized."""
    rng = np.random.default_rng(seed)
    u = transform(torch.from_numpy(rng.standard_normal((n, l)).astype(
        np.float32)))
    if dtype == "bfloat16":
        return pad_operands(u, t, l_blk).to(torch.bfloat16), None
    q, s = quantize_rows(u, dtype)
    return pad_operands(q, t, l_blk), pad_scales(s, t)


def _kwargs(n, l, t, l_blk, tiles, dtype, grid, spec):
    u, su = _operand(n, l, t, l_blk, dtype, 0)
    v, sv = _operand(n // 2 + 3, l, t, l_blk, dtype, 1)
    kw = dict(t=t, l_blk=l_blk, pass_tiles=tiles, epilogue=spec,
              v_pad=v if grid else None,
              grid_cols=v.shape[0] // t if grid else None, row_scale=su,
              col_scale=(sv if grid else su))
    return u, kw


def _chunked(u, j0, kw):
    """The plain version summed as the tensor-core kernel sums: float32
    products of each 128-sample chunk, added into a float32 accumulator
    (the operands zero-padded to whole chunks)."""
    def whole_chunks(x):
        if x is None:
            return None
        width = -(-x.shape[-1] // FAULT_CHUNK) * FAULT_CHUNK
        out = torch.zeros(*x.shape[:-1], width, dtype=torch.float32)
        out[..., :x.shape[-1]] = x.float()
        return out
    return pcc_tiles_plain(whole_chunks(u), j0, **{
        **kw, "l_blk": FAULT_CHUNK, "v_pad": whole_chunks(kw["v_pad"])})


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grid", [False, True])
@pytest.mark.parametrize("n,l,t,l_blk,j0,tiles", SHAPES)
def test_gate_accepts_chunked_float32_sums(dtype, grid, n, l, t, l_blk, j0,
                                           tiles):
    spec = EpilogueSpec(div=3.0, clip=(-0.5, 0.5))
    u, kw = _kwargs(n, l, t, l_blk, tiles, dtype, grid, spec)
    want = pcc_tiles_plain(u, j0, **kw)
    gate = narrow_gate(u, j0, **kw)
    assert gate.shape == want.shape and bool((gate >= 0).all())
    assert gate_share(_chunked(u, j0, kw), want, gate) <= 1.0
    assert gate_share(want, want, gate) == 0.0


@pytest.mark.parametrize("dtype", ["bfloat16", "float8_e4m3fn"])
@pytest.mark.parametrize("grid", [False, True])
def test_gate_accepts_reference_tiles(dtype, grid):
    """The reference's tiles (JAX, interpret mode) on the same operands lie
    within the gate of the port's plain version."""
    n, n_cols, l, t, l_blk = 37, 21, 29, 8, 8
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((n, l)).astype(np.float32))
    y = jnp.asarray(rng.standard_normal((n_cols, l)).astype(np.float32))
    plan = RefPlan.create(n, l, n_cols=n_cols if grid else None, t=t,
                          l_blk=l_blk, compute_dtype=dtype)
    ru, rv = plan.prepare_pair(x, y) if grid else (plan.prepare(x), None)
    u = convert.operand_from_reference(ru, device="cpu")
    v = None if rv is None else convert.operand_from_reference(rv,
                                                               device="cpu")
    scaled = dtype != "bfloat16"
    col = u if v is None else v
    tiles = plan.total_tiles
    want = ref_pcc_tiles(
        ru.data if scaled else ru, 0, t=t, l_blk=l_blk, pass_tiles=tiles,
        interpret=True, v_pad=None if rv is None else (
            rv.data if scaled else rv),
        grid_cols=plan.workload.grid_cols,
        row_scale=ru.scale if scaled else None,
        col_scale=(ru if rv is None else rv).scale if scaled else None)
    kw = dict(t=t, l_blk=l_blk, pass_tiles=tiles,
              v_pad=None if v is None else (v.data if scaled else v),
              grid_cols=plan.workload.grid_cols,
              row_scale=u.scale if scaled else None,
              col_scale=col.scale if scaled else None)
    ud = u.data if scaled else u
    got = pcc_tiles_plain(ud, 0, **kw)
    assert gate_share(torch.from_numpy(np.array(want)), got,
                      narrow_gate(ud, 0, **kw)) <= 1.0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grid", [False, True])
@pytest.mark.parametrize("n,l,t,l_blk,j0,tiles", SHAPES)
def test_gate_refuses_planted_faults(dtype, grid, n, l, t, l_blk, j0, tiles):
    """On the CPU pcc_tiles is the plain version: each fault alone against
    the gate, read without the clip, which would pin a raised diagonal."""
    u, kw = _kwargs(n, l, t, l_blk, tiles, dtype, grid,
                    EpilogueSpec(div=2.0, clip=(-0.5, 0.5)))
    faults = planted_faults(u, kw["v_pad"], l_blk)
    assert [name for name, _, _ in faults] == ["chunk zeroed",
                                               "chunk twice"]
    for name, fu, fv in faults:   # the chunk: FAULT_CHUNK samples, or all
        width = min(FAULT_CHUNK, u.shape[1])
        assert bool((fu.float()[:, :width] == 0).all()) if \
            name == "chunk zeroed" else torch.equal(
                fu.float()[:, u.shape[1]:u.shape[1] + width],
                u.float()[:, :width])
    shares = planted_fault_shares(u, j0, **kw)
    assert list(shares) == ["chunk zeroed", "chunk twice"]
    assert min(shares.values()) >= FAULT_SHARE, shares


def test_gate_unit():
    """c 2^-24 sqrt(l_pad), plus a 2^-13 for fp8's 13-bit partial sums."""
    for dtype, (c, a) in NARROW_GATE.items():
        assert narrow_gate_unit(dtype, 400) == pytest.approx(
            c * 2.0 ** -24 * 20 + a * 2.0 ** -13)
    assert NARROW_GATE["bfloat16"][1] == 0.0
    # a gate of zero takes exact agreement only
    z = torch.zeros(3)
    assert gate_share(z, z, z) == 0.0
    assert gate_share(z + 1e-30, z, z) == float("inf")
    assert np.isnan(gate_share(z + float("nan"), z, z + 1.0))


@pytest.mark.parametrize("dtype", TMA_DTYPES)
@pytest.mark.parametrize("l,l_blk", [(20, 4), (29, 29), (36, 12), (90, 6),
                                     (300, 100), (32, 8), (64, 64)])
def test_tma_padding_leaves_plain_tiles_bitwise(dtype, l, l_blk):
    t, n = 8, 37
    u, su = _operand(n, l, t, l_blk, dtype, 0)
    v, sv = _operand(21, l, t, l_blk, dtype, 1)
    per = TMA_ALIGN // u.element_size()
    pu, pv = tma_operand(u, l_blk), tma_operand(v, l_blk)
    if u.shape[1] % per == 0:
        assert pu is u
    else:
        assert pu.shape[1] % per == 0 and pu.shape[1] % l_blk == 0
        assert pu.shape[1] - u.shape[1] < np.lcm(per, l_blk)
        assert bool((pu[:, u.shape[1]:].float() == 0).all())
        assert torch.equal(pu[:, :u.shape[1]].view(torch.uint8),
                           u.view(torch.uint8))
    m = u.shape[0] // t
    for kw, a, b in (
            (dict(pass_tiles=m * (m + 1) // 2, row_scale=su,
                  col_scale=su), (u, None), (pu, None)),
            (dict(pass_tiles=m * 3, grid_cols=3, row_scale=su,
                  col_scale=sv), (u, v), (pu, pv))):
        spec = EpilogueSpec(div=2.0, clip=(-1.0, 1.0))
        want = pcc_tiles_plain(a[0], 0, t=t, l_blk=l_blk, epilogue=spec,
                               v_pad=a[1], **kw)
        got = pcc_tiles_plain(b[0], 0, t=t, l_blk=l_blk, epilogue=spec,
                              v_pad=b[1], **kw)
        assert torch.equal(got, want)
    # a replica stack pads along its sample axis, replica by replica
    stack = torch.stack([v.view(torch.uint8)] * 2).view(v.dtype)
    ps = tma_operand(stack, l_blk)
    assert ps.shape[:2] == stack.shape[:2] and ps.shape[2] == pv.shape[1]
    assert torch.equal(ps[1].view(torch.uint8), pv.view(torch.uint8))
