"""The port's training launcher (launch/train.py) on the CPU.

``main`` at SMOKE on one, two and four CPU ranks (``--devices cpu,cpu``):
the reference's default layout, every rank on the model axis, and
``--model-axis 1`` for data ranks; its refusal without a card, and
``pick_mesh_shape`` against the reference's.
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
    """The mesh is the reference's default layout, (1, n) for n <= 16
    devices: every leaf the specs cut is cut over the model axis, and the
    ranks train it."""
    where = (["--device", "cpu"] if ranks == 1
             else ["--devices", ",".join(["cpu"] * ranks)])
    loop = train.main(ARGS + where + ["--ckpt-dir", str(tmp_path)])
    assert f"devices={ranks} mesh=(1, {ranks})" in capsys.readouterr().out
    assert dict(loop.mesh.shape) == {"data": 1, "model": ranks}
    assert [m["step"] for m in loop.metrics_log] == [0, 1, 2]
    losses = [m["loss"] for m in loop.metrics_log]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert len(loop.params.ranks) == ranks
    assert all(p.device.type == "cpu" for p in loop.params.parameters())
    assert (len(loop.params.shards) > len(loop.names)) == (ranks > 1)
    assert os.path.isdir(tmp_path / "step_00000000")


def test_main_takes_the_model_axis(tmp_path, capsys):
    """Four CPU devices: (1, 4) by default, (4, 1) with --model-axis 1,
    (2, 2) with --model-axis 2; two steps each."""
    argv = ["--arch", "llama3.2-3b", "--smoke", "--steps", "2",
            "--global-batch", "4", "--seq", "16",
            "--devices", "cpu,cpu,cpu,cpu"]
    for extra, shape in (([], (1, 4)), (["--model-axis", "1"], (4, 1)),
                         (["--model-axis", "2"], (2, 2))):
        loop = train.main(argv + extra + ["--ckpt-dir",
                                          str(tmp_path / str(shape))])
        assert f"devices=4 mesh={shape}" in capsys.readouterr().out
        assert tuple(loop.mesh.shape.values()) == shape
        assert [m["step"] for m in loop.metrics_log] == [0, 1]


def test_main_needs_a_card_by_default(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(ARGS + ["--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(ARGS + ["--devices", "cuda:0,cuda:1",
                           "--ckpt-dir", str(tmp_path)])

