"""Which CUDA kernel and entry point each operand dtype of pcc_tiles and
pcc_topk_tiles reaches, the operands the wrappers hand them, and the
kernel libraries' C interfaces against their sources, on the CPU (the
launches themselves need an NVIDIA GPU: tests/test_torch_kernels_gpu.py).

int8 tiles and the int8 top-k select run on the tensor cores and read
their operands through TMA, so both wrappers pad int8 rows to 16 bytes.
Each top-k select runs the mainloop of the tiles of its dtype, so they
agree bit for bit: float32 the SGEMM mainloop of pcc_sgemm.cuh, bf16 and
int8 the tensor-core one of pcc_mma.cuh.  pcc_accum.cuh keeps no
accumulation routine of its own, and no source keeps a __dp4a chain.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pcc_tile import (OPERAND_DTYPES, SELECT_SM90_DTYPES,
                                          SM90_DTYPES, TMA_ALIGN, TOPK_DTYPES,
                                          _kernel_operands, tile_kernel)

CSRC = Path(_build.__file__).resolve().parent / "csrc"


@pytest.mark.parametrize("dtype,library,entry", [
    (torch.float32, "pcc_tile", "pcc_tiles_f32"),
    (torch.bfloat16, "pcc_tile_sm90", "pcc_tiles_sm90_bf16"),
    (torch.float16, "pcc_tile_sm90", "pcc_tiles_sm90_f16"),
    (torch.int8, "pcc_tile_sm90", "pcc_tiles_sm90_i8"),
    (torch.float8_e4m3fn, "pcc_tile_sm90", "pcc_tiles_sm90_e4m3"),
    (torch.float8_e5m2, "pcc_tile_sm90", "pcc_tiles_sm90_e5m2"),
])
def test_tile_kernel_by_dtype(dtype, library, entry):
    assert tile_kernel(dtype) == (library, entry)
    assert entry in _build.SIGNATURES[library]
    assert (dtype in SM90_DTYPES) == (library == "pcc_tile_sm90")


def test_simt_tile_library_keeps_float32_only():
    assert sorted(_build.SIGNATURES["pcc_tile"]) == [
        "pcc_tile_error_string", "pcc_tiles_f32"]
    assert not re.search(r"\bpcc_tiles_i8\b",
                         (CSRC / "pcc_tile.cu").read_text())


# select entry point -> (its launcher, the kernel it launches, the
# accumulation routine that kernel calls)
SELECT_ROUTES = {
    torch.float32: ("launch_select_f32", "pcc_topk_select_f32_kernel",
                    "sgemm::accumulate_block"),
    torch.bfloat16: ("launch_select_sm90", "pcc_topk_select_sm90<T>",
                     "mma::mma_block"),
    torch.float16: ("launch_select_sm90", "pcc_topk_select_sm90<T>",
                    "mma::mma_block"),
    torch.int8: ("launch_select_sm90", "pcc_topk_select_sm90<T>",
                 "mma::mma_block"),
}


def _function_body(src, head):
    """The text of the function defined at the first `head` in `src`, from
    its opening brace to the matching closing one."""
    start = src.index("{", src.index(head))
    depth = 0
    for i in range(start, len(src)):
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        if depth == 0:
            return src[start:i + 1]
    raise AssertionError(f"unbalanced braces after {head!r}")


@pytest.mark.parametrize("dtype", TOPK_DTYPES)
def test_topk_select_entry_by_dtype(dtype):
    """Every top-k dtype has its select entry point, bound for its library,
    whose launcher launches its kernel, which accumulates on the mainloop
    of that dtype's tiles: float32 on pcc_sgemm.cuh (the 128 x 128 SGEMM of
    the float32 tiles), bf16, fp16 and int8 on pcc_mma.cuh.  bf16, fp16 and
    int8 select through TMA, so their operands are padded for it; float32's
    are not."""
    entry = f"pcc_topk_select_{OPERAND_DTYPES[dtype]}"
    assert entry in _build.SIGNATURES["pcc_topk"]
    assert (dtype in SELECT_SM90_DTYPES) == (dtype != torch.float32)
    src = (CSRC / "pcc_topk.cu").read_text()
    launcher, kernel, mainloop = SELECT_ROUTES[dtype]
    assert re.search(rf"_ENTRY\(\s*{entry}\s*,[^)]*\b{launcher}\)", src)
    assert kernel + "<<<" in _function_body(src, f"int {launcher}(")
    name = kernel.split("<")[0]
    body = _function_body(src, f"\n{name}(")
    assert re.search(rf"(?<![:\w]){re.escape(mainloop)}[<(]", body), (
        kernel, mainloop)


def test_float32_select_left_the_64_block():
    """pcc_accum.cuh keeps no accumulation routine (the 64 x 64 SIMT block
    is gone for every dtype), and no kernel source keeps a __dp4a chain: no
    select has a slower path to fall back on."""
    src = (CSRC / "pcc_accum.cuh").read_text()
    assert not re.findall(r"void accumulate_block\(", src)
    for path in sorted(CSRC.glob("*.cu*")):
        assert "__dp4a" not in path.read_text(), path.name
    topk = (CSRC / "pcc_topk.cu").read_text()
    assert '#include "pcc_sgemm.cuh"' in topk
    assert "sgemm::accumulate_block(" in _function_body(
        topk, "\npcc_topk_select_f32_kernel(")
    assert not re.search(r"(?<![:\w])accumulate_block\(", topk)


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_signatures_name_functions_of_their_source(name):
    """Each C function bound for a library is defined by its source (an
    extern "C" definition or an entry macro's first argument)."""
    src = (CSRC / f"{name}.cu").read_text()
    for fn in _build.SIGNATURES[name]:
        assert re.search(rf"\b{fn}\s*\(", src) or \
            re.search(rf"_ENTRY\(\s*{fn}\s*,", src), fn


@pytest.mark.parametrize("width,l_blk", [(20, 4), (29, 29), (32, 8),
                                         (2016, 2016), (136, 8)])
def test_int8_operands_padded_for_the_tiles_not_the_select(width, l_blk):
    """int8 operands reach the tile kernel and the top-k select alike: as
    they are when their rows are 16-byte aligned, else zero-padded copies
    whose sample axis is a multiple of 16 and of l_blk."""
    rng = np.random.default_rng(width)
    u = torch.from_numpy(rng.integers(-128, 128, size=(16, width),
                                      dtype=np.int8))
    v = torch.from_numpy(rng.integers(-128, 128, size=(24, width),
                                      dtype=np.int8))
    per = TMA_ALIGN // u.element_size()
    for col in (u, v):   # the triangle (v is u) and a second operand
        tu, tv = _kernel_operands(u, col, l_blk)
        su, sv = _kernel_operands(u, col, l_blk, SELECT_SM90_DTYPES)
        assert (tv is tu) == (col is u) and (sv is su) == (col is u)
        for got, x in ((tu, u), (tv, col), (su, u), (sv, col)):
            if width % per == 0:
                assert got is x
                continue
            assert got.shape[1] % per == 0 and got.shape[1] % l_blk == 0
            assert torch.equal(got[:, :width], x)
            assert bool((got[:, width:] == 0).all())
