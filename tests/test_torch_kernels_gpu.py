"""The CUDA kernel on the card: held against its plain version and the
main path against its CPU run.  Every test here needs an NVIDIA GPU (marker
``gpu``) and skips without one; this file imports no JAX, so it runs on a
GPU host with only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core.api import corr
from repro_torch.core.pcc import transform
from repro_torch.core.plan import pad_operands
from repro_torch.kernels.pcc_tile import (EpilogueSpec, pcc_tiles,
                                          pcc_tiles_plain)

# same products, two float32 summation orders, l <= 300: the reference's
# own Pearson bound
ATOL = 3e-6


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
