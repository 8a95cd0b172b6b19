"""The port's checkpoint IO and manager (checkpoint/) on the reference's
cases (tests/test_checkpoint.py), and checkpoints restored across the two
packages by leaf name, bitwise, in both directions: trees of float32,
int32, 0-d and bf16 leaves, and a train loop's {"params", "opt"} tree of a
model (the port's layers stacked as the reference's (L, ...) leaves), with
float32 and bf16 moments.  A bf16 leaf is numpy's two-byte void record on
disk ('<V2', read back as '|V2'); the port reads it through the manifest's
dtype, without ml_dtypes.
"""

import gc
import json
import os
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as ref_io
from repro.configs import get_config as ref_get_config
from repro.models.registry import build_model as ref_build_model
from repro.optim import adamw as ref_adamw
from repro_torch.checkpoint import io
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.optim import adamw
from repro_torch.tree import named_leaves, scatter_tree, stacked_tree


@pytest.fixture
def tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.int32),
                  "d": torch.tensor(3.5)}}


def _leaves(t):
    return [leaf for _, leaf in named_leaves(t)]


def test_save_restore_roundtrip(tmp_path, tree):
    path = io.save(str(tmp_path), 7, tree, metadata={"x": 1})
    got, meta = io.restore(path, like=tree)
    assert meta == {"x": 1}
    for a, b in zip(_leaves(tree), _leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    flat, _ = io.restore(path)
    assert [tuple(t.shape) for t in flat] == [(3, 4), (5,), ()]


def test_atomicity_tmp_never_visible(tmp_path, tree):
    io.save(str(tmp_path), 1, tree)
    stale = tmp_path / "step_00000002.tmp-dead"
    stale.mkdir()
    (stale / "arr_00000.npy").write_bytes(b"garbage")
    assert io.available_steps(str(tmp_path)) == [1]
    assert io.gc_tmp(str(tmp_path)) == 1
    assert not stale.exists()


def test_incomplete_step_ignored(tmp_path, tree):
    io.save(str(tmp_path), 1, tree)
    (tmp_path / "step_00000005").mkdir()  # no manifest.json
    assert io.available_steps(str(tmp_path)) == [1]


def test_manager_retention(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path), keep_last=2, async_save=False)
    for s in range(6):
        mgr.save(s, tree)
    assert io.available_steps(str(tmp_path)) == [4, 5]
    mgr.close()


def test_manager_keep_every_anchors(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path), keep_last=1, keep_every=4,
                            async_save=False)
    for s in range(9):
        mgr.save(s, tree)
    assert io.available_steps(str(tmp_path)) == [0, 4, 8]
    mgr.close()


def test_manager_async_and_resume(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path), keep_last=3)
    mgr.save(3, tree, metadata={"cursor": 42})
    mgr.wait()
    got, meta, step = mgr.restore_latest(like=tree)
    assert step == 3 and meta["cursor"] == 42
    for a, b in zip(_leaves(tree), _leaves(got)):
        assert torch.equal(a, b)
    mgr.close()


def test_restore_latest_empty(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    assert mgr.restore_latest(like=tree) is None
    mgr.close()


def test_restored_leaves_are_freed_without_gc(tmp_path, tree):
    """A restored tree's leaves die with the tree, with the garbage
    collector off: nothing of the restore (a nested function calling
    itself) holds them in a reference cycle."""
    path = io.save(str(tmp_path), 2, tree)
    gc.collect()
    gc.disable()
    try:
        got, _ = io.restore(path, like=tree)
        refs = [weakref.ref(t) for t in _leaves(got)]
        del got
        assert refs and not any(r() is not None for r in refs)
    finally:
        gc.enable()


def test_restore_by_name_checks_names_and_shapes(tmp_path, tree):
    path = io.save(str(tmp_path), 1, tree)
    with pytest.raises(ValueError, match="no leaf named"):
        io.restore(path, like={"zz": torch.zeros(1)})
    with pytest.raises(ValueError, match="expected"):
        io.restore(path, like={"a": torch.zeros(4, 3)})


def _mixed(rng):
    return {"w": rng.standard_normal((4, 6)).astype(np.float32),
            "n": {"i": np.arange(7, dtype=np.int32),
                  "s": np.float32(2.25),
                  "h": rng.standard_normal((3, 5)).astype(np.float32)}}


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    rng = np.random.default_rng(0)
    tree = _mixed(rng)
    port_tree = {"w": torch.from_numpy(tree["w"]),
                 "n": {"i": torch.from_numpy(tree["n"]["i"]),
                       "s": torch.tensor(2.25),
                       "h": torch.from_numpy(tree["n"]["h"]).bfloat16()}}
    path = io.save(str(tmp_path), 12, port_tree, metadata={"k": "v"})
    got, meta = ref_io.restore(path, like=tree)
    assert meta == {"k": "v"} and ref_io.available_steps(
        str(tmp_path)) == [12]
    np.testing.assert_array_equal(got["w"], tree["w"])
    np.testing.assert_array_equal(got["n"]["i"], tree["n"]["i"])
    assert got["n"]["s"].shape == () and got["n"]["s"] == np.float32(2.25)
    # the bf16 leaf: numpy's void records, the reference's bits
    want = np.asarray(jnp.asarray(tree["n"]["h"], jnp.bfloat16))
    assert got["n"]["h"].dtype.kind == "V"
    np.testing.assert_array_equal(got["n"]["h"].view(np.uint16),
                                  want.view(np.uint16))
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert [r["name"] for r in manifest["leaves"]] == \
        ["n/h", "n/i", "n/s", "w"]
    assert manifest["leaves"][0]["dtype"] == "bfloat16"


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    rng = np.random.default_rng(1)
    tree = _mixed(rng)
    ref_tree = jax.tree.map(jnp.asarray, tree)
    ref_tree["n"]["h"] = ref_tree["n"]["h"].astype(jnp.bfloat16)
    path = ref_io.save(str(tmp_path), 3, ref_tree, metadata={"m": 2})
    like = {"w": torch.zeros(4, 6), "n": {"i": torch.zeros(7),
                                          "s": torch.zeros(()),
                                          "h": torch.zeros(3, 5)}}
    got, meta = io.restore(path, like=like)
    assert meta == {"m": 2}
    assert torch.equal(got["w"], torch.from_numpy(tree["w"]))
    assert got["n"]["i"].dtype == torch.int32
    assert got["n"]["s"].shape == () and float(got["n"]["s"]) == 2.25
    assert got["n"]["h"].dtype == torch.bfloat16
    want = np.asarray(ref_tree["n"]["h"]).view(np.uint16)
    np.testing.assert_array_equal(got["n"]["h"].view(torch.int16).numpy()
                                  .view(np.uint16), want)


def _train_state(arch, moment_dtype):
    """The reference's parameters and a one-update AdamW state, and the
    port's model and state carried over from them."""
    rcfg = ref_get_config(arch, smoke=True)
    params = ref_build_model(rcfg).init(jax.random.PRNGKey(0))
    opt = dict(moment_dtype=moment_dtype, warmup_steps=1, total_steps=5)
    rcfg_opt = ref_adamw.AdamWConfig(**opt)
    grads = jax.tree.map(lambda p: jnp.sin(p * 7.0) * 1e-2, params)
    params, state, _ = ref_adamw.update(rcfg_opt, grads,
                                        ref_adamw.init(rcfg_opt, params),
                                        params)
    model = lm_params_from_reference(get_config(arch, smoke=True),
                                     jax.tree.map(np.asarray, params),
                                     device="cpu", trainable=True)
    return params, state, model, adamw.AdamWConfig(**opt)


def _port_tree(model, state):
    names = [n for n, _ in named_leaves(model)]
    return names, {"params": stacked_tree(names, [p for _, p in
                                                  named_leaves(model)]),
                   "opt": {"m": stacked_tree(names, state["m"]),
                           "v": stacked_tree(names, state["v"]),
                           "step": state["step"]}}


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["llama3.2-3b", "seamless-m4t-medium"])
def test_train_state_crosses_both_ways(tmp_path, arch, moment_dtype):
    """A train loop's tree: the reference's checkpoint scatters into the
    port's model and moments bitwise, and the port's, written from them,
    restores in the reference equal to its own arrays."""
    params, state, model, opt = _train_state(arch, moment_dtype)
    ref_tree = {"params": params, "opt": state}
    path = ref_io.save(str(tmp_path / "ref"), 1, ref_tree)
    # into the port: zeroed leaves, filled by name
    pstate = adamw.init(opt, model)
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    names, like = _port_tree(model, pstate)
    got, _ = io.restore(path, like=like)
    scatter_tree(names, [p for _, p in named_leaves(model)], got["params"])
    scatter_tree(names, pstate["m"], got["opt"]["m"])
    scatter_tree(names, pstate["v"], got["opt"]["v"])
    assert int(got["opt"]["step"]) == 1
    pstate["step"] = got["opt"]["step"]
    # back to the reference: the port's checkpoint of what it restored
    _, port_tree = _port_tree(model, pstate)
    path2 = io.save(str(tmp_path / "port"), 1, port_tree)
    back, _ = ref_io.restore(path2, like=ref_tree)
    want = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    have = jax.tree.leaves(back)
    assert len(want) == len(have)
    for (keypath, a), b in zip(want, have):
        a = np.asarray(a)
        if a.dtype.kind == "V" or str(a.dtype) == "bfloat16":
            a, b = a.view(np.uint16), np.asarray(b).view(np.uint16)
        assert a.shape == b.shape, keypath
        np.testing.assert_array_equal(a, b, err_msg=str(keypath))
    with open(os.path.join(path, "manifest.json")) as f:
        ref_names = [r["name"] for r in json.load(f)["leaves"]]
    with open(os.path.join(path2, "manifest.json")) as f:
        port_names = [r["name"] for r in json.load(f)["leaves"]]
    assert port_names == ref_names
