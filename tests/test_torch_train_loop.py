"""The port's fault-tolerant train loop (runtime/train_loop.py) on the CPU.

The reference's tiny config (tests/test_train_loop.py) over two logical
data ranks on the CPU (``make_mesh((2, 1), ("data", "model"),
devices=["cpu"] * 2)``), both modes: failure and recovery (the steps after
a restore bitwise an uninterrupted run's), resume from a checkpoint by a
new loop, every replica bitwise equal to the others, the pjit step over
two ranks against the one-device step, a lost host shrinking the data
axis, and the checkpoint's leaves named as the reference's tree.

The tests run with one intra-op thread: with several, the CPU's parallel
reductions in the backward pass may sum in another order from one call to
the next (gradients ~1e-7 apart), and "bitwise" means the same order.
"""

import json
import os

import jax
import pytest
import torch

from repro.models.config import ModelConfig as RefModelConfig
from repro.models.registry import build_model as ref_build_model
from repro.optim import adamw as ref_adamw
from repro_torch.checkpoint import io
from repro_torch.data.synthetic import TokenStreamSpec, batch_at
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import steps
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.runtime.train_loop import (FailureInjected, LoopConfig,
                                            TrainLoop)

FIELDS = dict(arch="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
              d_ff=128, vocab=256, dtype="float32")
CFG = ModelConfig(**FIELDS)
SPEC = TokenStreamSpec(vocab=256, seq_len=64, global_batch=8)
OPT = adamw.AdamWConfig(total_steps=20, warmup_steps=2)


def _loop(ckpt_dir, total, ranks=2, mode="pjit", hook=None, ckpt_every=3):
    mesh = make_mesh((ranks, 1), ("data", "model"),
                     devices=["cpu"] * ranks)
    return TrainLoop(CFG, OPT, LoopConfig(total_steps=total,
                                          ckpt_every=ckpt_every,
                                          ckpt_dir=str(ckpt_dir), mode=mode),
                     mesh, data_spec=SPEC, failure_hook=hook)


def _fail_once(at, lost_hosts=0):
    state = {"done": False}

    def hook(step):
        if step == at and not state["done"]:
            state["done"] = True
            raise FailureInjected("injected", lost_hosts=lost_hosts)
    return hook, state


def _losses(loop):
    out = {}
    for m in loop.metrics_log:
        out.setdefault(m["step"], []).append(m["loss"])
    return out


def _replicas_equal(loop):
    first = loop.replicas[0]
    for other in loop.replicas[1:]:
        for a, b in zip(first.parameters(), other.parameters()):
            assert torch.equal(a, b)
    for st in loop.opt_states[1:]:
        for a, b in zip(loop.opt_states[0]["m"] + loop.opt_states[0]["v"],
                        st["m"] + st["v"]):
            assert torch.equal(a, b)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory, one_thread):
    loop = _loop(tmp_path_factory.mktemp("clean"), 10)
    loop.run()
    return loop


@pytest.mark.chaos
def test_failure_recovery_replays_bitwise(tmp_path, uninterrupted):
    hook, state = _fail_once(7)
    loop = _loop(tmp_path, 10, hook=hook)
    loop.run()
    assert state["done"]
    got, want = _losses(loop), _losses(uninterrupted)
    steps_seen = [m["step"] for m in loop.metrics_log]
    # checkpoints at 0, 3, 6: step 7 fails, 6 is restored, 7 re-runs
    assert steps_seen == list(range(10))
    assert all(len(v) == 1 for v in got.values())
    assert got == want          # bitwise, every step, after recovery too
    assert got[9][0] < got[0][0]
    _replicas_equal(loop)


@pytest.mark.chaos
def test_failure_after_a_checkpoint_reruns_steps(tmp_path, uninterrupted):
    """A failure two steps past the last checkpoint re-runs the step in
    between: its loss is logged twice, both times the uninterrupted
    run's."""
    hook, _ = _fail_once(5)
    loop = _loop(tmp_path, 8, hook=hook)
    loop.run()
    got, want = _losses(loop), _losses(uninterrupted)
    assert [m["step"] for m in loop.metrics_log] == [0, 1, 2, 3, 4, 4, 5,
                                                     6, 7]
    for step, losses in got.items():
        assert losses == want[step] * len(losses)


def test_resume_from_checkpoint(tmp_path, uninterrupted):
    _loop(tmp_path, 6).run()              # checkpoints at 0 and 3
    l2 = _loop(tmp_path, 10)
    l2.run()
    first_resumed = l2.metrics_log[0]["step"]
    assert first_resumed == 4             # did not start from scratch
    assert l2.metrics_log[-1]["step"] == 9
    want = _losses(uninterrupted)
    for m in l2.metrics_log:
        assert [m["loss"]] == want[m["step"]]


def test_checkpoint_leaves_are_the_reference_tree(tmp_path):
    loop = _loop(tmp_path, 1, ranks=1)
    loop.run()
    rcfg = RefModelConfig(**FIELDS)
    params = jax.eval_shape(ref_build_model(rcfg).init, jax.random.PRNGKey(0))
    opt = jax.eval_shape(lambda p: ref_adamw.init(ref_adamw.AdamWConfig(),
                                                   p), params)
    want = [("/".join(str(getattr(k, "key", k)) for k in path), leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                {"params": params, "opt": opt})[0]]
    path = os.path.join(str(tmp_path), "step_00000000")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert [(r["name"], tuple(r["shape"])) for r in manifest["leaves"]] \
        == [(n, tuple(s)) for n, s in want]
    assert manifest["metadata"] == {"step": 0, "data_seed": 0}
    flat, _ = io.restore(path)
    assert len(flat) == len(want)


def test_pjit_over_two_ranks_is_the_one_device_step(tmp_path):
    """Two data ranks (each its 4 rows, the token losses summed over the
    global count) against make_train_step on the 8 rows on one device: the
    first loss within 1e-6, three steps' losses within 1e-5; one rank's
    loop is make_train_step's bits."""
    two = _loop(tmp_path / "two", 3, ranks=2)
    two.run()
    one = _loop(tmp_path / "one", 3, ranks=1)
    one.run()
    model = one.model.init(torch.Generator().manual_seed(0), "cpu",
                           trainable=True)
    step = steps.make_train_step(CFG, OPT, device="cpu")
    state = adamw.init(OPT, model)
    for s in range(3):
        _, state, m = step(model, state, **batch_at(SPEC, s))
        assert float(m["loss"]) == one.metrics_log[s]["loss"]
        assert two.metrics_log[s]["loss"] == pytest.approx(
            float(m["loss"]), rel=1e-6 if s == 0 else 1e-5)
    for a, b in zip(one.params.parameters(), model.parameters()):
        assert torch.equal(a, b)
    _replicas_equal(two)


@pytest.mark.chaos
def test_dp_compressed_trains_and_recovers(tmp_path):
    """Per-rank steps, the int8 error-feedback all-reduce, one update on
    every rank: the replicas stay bitwise equal and the loss falls.  A
    failure restores the checkpoint and rebuilds (the residuals start
    again from zero, as the reference's rebuild starts them): the steps
    after it are bitwise a new loop's resumed from that checkpoint."""
    hook, state = _fail_once(5)
    loop = _loop(tmp_path / "a", 8, mode="dp_compressed", hook=hook)
    loop.run()
    assert state["done"]
    _replicas_equal(loop)
    losses = [m["loss"] for m in loop.metrics_log]
    assert losses[-1] < losses[0]
    # a new loop resumed from the same checkpoint (step 3)
    first = _loop(tmp_path / "b", 4, mode="dp_compressed")
    first.run()
    resumed = _loop(tmp_path / "b", 8, mode="dp_compressed")
    resumed.run()
    want = _losses(resumed)
    got = _losses(loop)
    for s in range(4, 8):
        assert got[s][-1] == want[s][0]
    # the compressed average differs from the exact one
    exact = _loop(tmp_path / "c", 4)
    exact.run()
    assert [m["loss"] for m in exact.metrics_log][1:] != losses[1:4]


@pytest.mark.chaos
def test_lost_host_shrinks_the_data_axis(tmp_path, uninterrupted):
    hook, state = _fail_once(4, lost_hosts=1)
    loop = _loop(tmp_path, 7, hook=hook)
    loop.run()
    assert state["done"]
    assert dict(loop.mesh.shape) == {"data": 1, "model": 1}
    assert len(loop.replicas) == 1
    want = _losses(uninterrupted)
    got = _losses(loop)
    assert [m["step"] for m in loop.metrics_log] == list(range(7))
    # one rank computes the global mean in another summation order
    for s in range(4, 7):
        assert got[s][0] == pytest.approx(want[s][0], rel=1e-5)


@pytest.mark.chaos
@pytest.mark.parametrize("mode,lost_hosts", [("pjit", 0), ("pjit", 1),
                                             ("dp_compressed", 0)])
def test_recovery_overwrites_the_state_in_place(tmp_path, mode,
                                                lost_hosts):
    """A recovery allocates no second copy of the parameters and moments:
    the restore writes the checkpoint into the surviving replica's own
    tensors, so their storage is the one the loop started with."""
    hook, state = _fail_once(4, lost_hosts=lost_hosts)
    loop = _loop(tmp_path, 6, mode=mode, hook=hook)

    def storage(lp):
        opt = lp.opt_states[0]
        return [t.data_ptr() for t in list(lp.replicas[0].parameters())
                + opt["m"] + opt["v"]]
    before = storage(loop)
    loop.run()
    assert state["done"]
    assert storage(loop) == before
    assert len(loop.replicas) == len(loop.opt_states) == 2 - lost_hosts
    assert [m["step"] for m in loop.metrics_log] == list(range(6))


def test_train_loop_needs_a_card_by_default(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainLoop(CFG, OPT, LoopConfig(ckpt_dir=str(tmp_path)))
    with pytest.raises(ValueError, match="'data', 'model'"):
        TrainLoop(CFG, OPT, LoopConfig(ckpt_dir=str(tmp_path)),
                  make_mesh((1,), ("d",), devices=["cpu"]))
