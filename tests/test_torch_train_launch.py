"""The port's training launcher (launch/train.py) on the CPU.

``main`` at SMOKE on one CPU rank and on two (``--devices cpu,cpu``), its
refusal without a card, and ``pick_mesh_shape`` against the reference's.
"""

import os

import numpy as np
import pytest
import torch

from repro.launch.train import pick_mesh_shape as ref_pick_mesh_shape
from repro_torch.launch import train

ARGS = ["--arch", "llama3.2-3b", "--smoke", "--steps", "3",
        "--global-batch", "4", "--seq", "32"]


def test_pick_mesh_shape_is_the_reference():
    for n in range(1, 300):
        for axis in (1, 2, 16):
            assert train.pick_mesh_shape(n, axis) == \
                ref_pick_mesh_shape(n, axis)
        assert train.pick_mesh_shape(n) == ref_pick_mesh_shape(n)


@pytest.mark.parametrize("ranks", [1, 2, 4])
def test_main_trains_on_the_cpu(tmp_path, capsys, ranks):
    """Every device is a data rank: mesh (n, 1), where the reference's
    layout would keep a model axis (4 devices: (1, 4)), which this slice
    cannot execute."""
    where = (["--device", "cpu"] if ranks == 1
             else ["--devices", ",".join(["cpu"] * ranks)])
    loop = train.main(ARGS + where + ["--ckpt-dir", str(tmp_path)])
    assert f"devices={ranks} mesh=({ranks}, 1)" in capsys.readouterr().out
    assert dict(loop.mesh.shape) == {"data": ranks, "model": 1}
    assert [m["step"] for m in loop.metrics_log] == [0, 1, 2]
    losses = [m["loss"] for m in loop.metrics_log]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert len(loop.replicas) == ranks
    first = list(loop.replicas[0].parameters())
    assert all(p.device.type == "cpu" for p in first)
    for other in loop.replicas[1:]:
        assert all(torch.equal(a, b)
                   for a, b in zip(first, other.parameters()))
    assert os.path.isdir(tmp_path / "step_00000000")


def test_main_needs_a_card_by_default(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(ARGS + ["--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(ARGS + ["--devices", "cuda:0,cuda:1",
                           "--ckpt-dir", str(tmp_path)])

