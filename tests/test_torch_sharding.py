"""The port's sharding policy (models/sharding.py) against the
reference's, and the train loop over the placements it once refused, on
the CPU.

For every architecture, FULL and SMOKE, at mesh shapes (1, 1), (2, 4),
(4, 2) and (16, 16) over ("data", "model"): each parameter leaf's spec
(``params_specs``, at the reference's stacked shapes), each decode-cache
leaf's (``cache_specs``, heads and sequence modes), ``batch_spec`` and
``make_policy``'s axes equal the tuple of the reference's
``PartitionSpec``.  The reference's policy runs over an ``AbstractMesh``
(``param_spec`` reads only its shape and axis names; no devices), the
port's over a mesh of logical CPU ranks.  FSDP (``param_sharding
fsdp_tp``) is checked by overriding the configs that do not set it.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as ref_get_config
from repro.configs import list_archs as ref_list_archs
from repro.models.registry import build_model as ref_build_model
from repro.models.sharding import make_policy as ref_make_policy
from repro_torch.configs import get_config, list_archs
from repro_torch.data.synthetic import TokenStreamSpec
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import steps
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import build_model
from repro_torch.models.sharding import axes_of, make_policy, spec
from repro_torch.optim import adamw
from repro_torch.runtime.train_loop import LoopConfig, TrainLoop

SHAPES = [(1, 1), (2, 4), (4, 2), (16, 16)]
AXES = ("data", "model")


def _policies(arch, smoke, shape, **fields):
    rcfg = dataclasses.replace(ref_get_config(arch, smoke=smoke), **fields)
    cfg = dataclasses.replace(get_config(arch, smoke=smoke), **fields)
    ref = ref_make_policy(rcfg, AbstractMesh(shape, AXES))
    mesh = make_mesh(shape, AXES, devices=["cpu"] * int(np.prod(shape)))
    return rcfg, cfg, ref, make_policy(cfg, mesh)


def _path(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def test_port_and_reference_list_the_same_archs():
    assert list_archs() == ref_list_archs()


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_equal_the_reference(arch, smoke, shape, fsdp):
    fields = {"param_sharding": "fsdp_tp"} if fsdp else {}
    rcfg, cfg, ref, port = _policies(arch, smoke, shape, **fields)
    assert (port.dp_axes, port.tp_axis, port.fsdp, port.seq_shard) == \
        (ref.dp_axes, ref.tp_axis, ref.fsdp, ref.seq_shard)
    assert (port.dp_size, port.tp_size) == (ref.dp_size, ref.tp_size)
    shapes = jax.eval_shape(ref_build_model(rcfg).init,
                            jax.random.PRNGKey(0))
    want = {_path(p): tuple(ref.param_spec(_path(p), leaf.shape, rcfg))
            for p, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = port.params_specs(cfg, build_model(cfg).init_shapes())
    assert got == want
    for ndim in (2, 3):
        assert port.batch_spec(ndim) == tuple(ref.batch_spec(ndim))


@pytest.mark.parametrize("seq", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", list_archs())
def test_cache_specs_equal_the_reference(arch, shape, seq):
    rcfg, cfg, ref, port = _policies(arch, False, shape)
    batch, cap = 16, 64
    model = ref_build_model(rcfg)
    cache = jax.eval_shape(lambda: model.init_cache(batch, cap))
    want = jax.tree.map(lambda s: tuple(s.spec),
                        ref.cache_shardings(rcfg, cache, kv_seq_axis=seq))
    got = port.cache_specs(cfg, steps.init_cache(cfg, batch, cap,
                                                 device="meta"),
                           kv_seq_axis=seq)
    flat_want = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, tuple))[0]
    flat_got = jax.tree_util.tree_flatten_with_path(
        got, is_leaf=lambda x: isinstance(x, tuple))[0]
    assert [(_path(p), v) for p, v in flat_got] == \
        [(_path(p), v) for p, v in flat_want]


def test_spec_canonicalises_as_partition_spec():
    from jax.sharding import PartitionSpec as P
    for entries in [(("data",), None), (("pod", "data"), "model"),
                    ((), None), ("a", ["b"])]:
        assert spec(*entries) == tuple(P(*entries))
    assert axes_of((None, ("pod", "data"), "model")) == \
        ("pod", "data", "model")


def test_constraints_are_the_identity():
    _, _, _, port = _policies("llama3.2-3b", True, (2, 4))
    x = torch.zeros(2, 8, 16)
    assert port.constrain_residual(x) is x
    assert port.constrain_logits(x) is x


_TINY = ModelConfig(arch="t", n_layers=2, d_model=64, n_heads=4,
                    n_kv_heads=2, d_ff=128, vocab=256, dtype="float32")


def _loop(tmp_path, cfg, shape, mode="pjit"):
    mesh = make_mesh(shape, AXES, devices=["cpu"] * int(np.prod(shape)))
    return TrainLoop(cfg, adamw.AdamWConfig(total_steps=4),
                     LoopConfig(total_steps=2, ckpt_every=5,
                                ckpt_dir=str(tmp_path), mode=mode),
                     mesh, data_spec=TokenStreamSpec(vocab=cfg.vocab,
                                                     seq_len=16,
                                                     global_batch=8))


def _losses(loop):
    return [m["loss"] for m in loop.metrics_log]


@pytest.mark.parametrize("shape,fields,what", [
    ((1, 2), {}, "model"),                            # tensor parallelism
    ((2, 1), {"param_sharding": "fsdp_tp"}, "data"),  # FSDP
])
def test_train_loop_refuses_a_spec_over_a_wide_axis(tmp_path, shape,
                                                    fields, what):
    """Once refused, a spec over an axis of size > 1 now trains: leaves
    are cut over that axis, and the loop's losses are the one-rank loop's
    within 1e-5 relative."""
    cfg = dataclasses.replace(_TINY, **fields)
    loop = _loop(tmp_path / "mesh", cfg, shape)
    specs = loop.policy.params_specs(cfg, loop.model.init_shapes())
    assert any(what in axes_of(s) for s in specs.values())
    assert any(sh.key != (-1, -1)
               for sh in loop.params.shards), "nothing was cut"
    loop.run()
    one = _loop(tmp_path / "one", cfg, (1, 1))
    one.run()
    assert _losses(loop) == pytest.approx(_losses(one), rel=1e-5)


def test_train_loop_refuses_moe_in_pjit_over_data_ranks(tmp_path):
    """Once refused, MoE in pjit mode at data size 2 now trains: each data
    group routes the global batch (capacity, drops and the aux loss of
    the whole batch, the aux counted once), so the losses are the one-rank
    loop's within 1e-5 relative; dp_compressed runs too."""
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b", smoke=True),
                              vocab=256)
    two = _loop(tmp_path / "two", cfg, (2, 1))
    two.run()
    one = _loop(tmp_path / "one", cfg, (1, 1))
    one.run()
    assert _losses(two) == pytest.approx(_losses(one), rel=1e-5)
    assert all(float(m["aux"]) > 0 for m in [two.step_fn(
        two.params, two.opt_state, **_batch(cfg))[2]])
    _loop(tmp_path / "dp", cfg, (2, 1), mode="dp_compressed").run()


def _batch(cfg):
    rng = np.random.default_rng(0)
    return {"tokens": rng.integers(0, cfg.vocab, (8, 16)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (8, 16)).astype(np.int32)}
