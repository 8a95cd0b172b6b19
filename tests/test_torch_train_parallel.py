"""LM training over a (data, model) mesh of CPU ranks (models/parallel.py,
``steps.make_train_step(policy=)``, ``runtime/train_loop.TrainLoop``
in pjit mode) against the reference's unsharded step.

Each SMOKE config, with the reference's parameters carried into the ranks'
shards (``convert.lm_params_from_reference(mesh=, trainable=True)``) and
tests/test_torch_train_step.py's batch (B = 2 rows of S = 48 tokens, seed
3, loss and attention chunks of 16), takes one step's gradients over a
mesh of ``["cpu"] * p``; each shard's copies' gradients are summed
(``ShardedLM.sum_copies``) and each leaf assembled from its shards
(``ShardedLM.whole``).  The loss and every gradient leaf lie within 1e-5
of the reference's (of the leaf's largest |g|) in float32, 2e-2 in bf16:
llama3.2-3b at (1, 2), (2, 2) and (1, 3); hymba-1.5b at (1, 4) (half-head
``wk``, ``in_proj``'s ``[x | z]``); qwen3-moe-30b-a3b at (1, 2) (expert
parallelism) and (2, 2) (the global batch routed in each data group, the
aux loss once; batch-local routing too); mixtral-8x22b and nemotron-4-340b
(``grad_accum`` 2) with ``param_sharding="fsdp_tp"`` replaced in at (2,
2); seamless-m4t-medium at (1, 2).

Also: AdamW over the shards against the one-device update on the same
gradients (1e-6); every copy of a shard bitwise equal to its others after
three steps (each rank on the CPU holds its own copies, as on distinct
cards); checkpoints written from shards are the
reference's whole-leaf tree and resume on other meshes; a lost host
shrinks a (2, 2) mesh to (1, 2) and replays bitwise; dp_compressed over
a model axis is bitwise the (d, 1) run.  One intra-op thread where runs
are held bitwise.
"""

import dataclasses
import functools
import gc
import json
import os
import shutil
import threading
from weakref import ref as weakref_of

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import steps as ref_steps
from repro.models.registry import build_model as ref_build_model
from repro.optim import adamw as ref_adamw
from repro_torch.checkpoint import io
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.data.synthetic import TokenStreamSpec
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import parallel, steps
from repro_torch.models.parallel import ShardedLM
from repro_torch.models.sharding import make_policy
from repro_torch.optim import adamw
from repro_torch.runtime.train_loop import (FailureInjected, LoopConfig,
                                            TrainLoop)
from repro_torch.tree import named_leaves, reference_path
from test_torch_train_step import (B, CHUNK, S, TOL_BF16, TOL_F32,
                                   grad_shares)

AXES = ("data", "model")
FSDP = {"param_sharding": "fsdp_tp"}
CASES = [("llama3.2-3b", (1, 2), {}), ("llama3.2-3b", (2, 2), {}),
         ("llama3.2-3b", (1, 3), {}), ("hymba-1.5b", (1, 4), {}),
         ("qwen3-moe-30b-a3b", (1, 2), {}),
         ("qwen3-moe-30b-a3b", (2, 2), {}),
         ("qwen3-moe-30b-a3b", (2, 2), {"moe_impl": "per_example"}),
         ("mixtral-8x22b", (2, 2), FSDP),
         ("nemotron-4-340b", (2, 2), dict(FSDP, grad_accum=2)),
         ("seamless-m4t-medium", (1, 2), {})]
BF16_CASES = [("llama3.2-3b", (2, 2), {}), ("hymba-1.5b", (1, 4), {})]
TOL_ADAM = 1e-6


def _mesh(shape):
    return make_mesh(shape, AXES, devices=["cpu"] * int(np.prod(shape)))


def configs(arch, dtype="float32", **fields):
    fields = dict(dtype=dtype, logits_chunk=CHUNK, attn_chunk=CHUNK,
                  **fields)
    return (dataclasses.replace(ref_get_config(arch, smoke=True), **fields),
            dataclasses.replace(get_config(arch, smoke=True), **fields))


def make_batch(cfg):
    """tests/test_torch_train_step.py's batch (numpy, seed 3) at B rows a
    micro-batch: tokens and labels, and an encoder-decoder's source
    frames."""
    rows = B * cfg.grad_accum
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab, (rows, S)).astype(
        np.int32), "labels": rng.integers(0, cfg.vocab, (rows, S)).astype(
        np.int32)}
    if cfg.enc_dec:
        batch["src"] = rng.standard_normal((rows, S, cfg.d_model)).astype(
            np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def reference_params(arch):
    rcfg, _ = configs(arch)
    params = ref_build_model(rcfg).init(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(
        v.astype(jnp.float32) if v.dtype == jnp.bfloat16 else v)
        for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def reference_grads(arch, dtype, fields):
    """The reference's jitted value_and_grad of its loss over the whole
    batch: (loss, flat gradients by path).  With grad_accum 2 and no pads
    (equal token counts) the two micro-batches' mean gradient is this
    one."""
    rcfg, _ = configs(arch, dtype, **dict(fields))
    batch = make_batch(rcfg)
    fn = jax.value_and_grad(lambda p: ref_steps.loss_fn(rcfg, p, batch),
                            has_aux=True)
    (loss, _), grads = jax.jit(fn)(reference_params(arch))
    return float(loss), _flat(grads)


def placed(arch, shape, dtype="float32", **fields):
    _, cfg = configs(arch, dtype, **fields)
    return cfg, lm_params_from_reference(cfg, reference_params(arch),
                                         mesh=_mesh(shape), trainable=True)


def mesh_grads(cfg, sm):
    """(metrics, every leaf's whole gradient by port name) of one step's
    gradients over the mesh."""
    metrics, grads = steps.accumulated_grads(
        cfg, steps.as_batch(make_batch(cfg), "cpu"),
        lambda mb: steps.grads_of(cfg, sm, mb))
    grads = sm.sum_copies(grads)
    names = dict.fromkeys(sh.name for sh in sm.shards)
    return metrics, {n: sm.whole(n, grads) for n in names}


@pytest.mark.parametrize("arch,shape,fields,dtype",
                         [c + ("float32",) for c in CASES]
                         + [c + ("bfloat16",) for c in BF16_CASES],
                         ids=lambda v: str(v))
def test_mesh_gradients_match_the_reference(arch, shape, fields, dtype):
    loss, ref_flat = reference_grads(arch, dtype, tuple(fields.items()))
    cfg, sm = placed(arch, shape, dtype, **fields)
    assert isinstance(sm, ShardedLM) and sm.px.tp * sm.px.dp == np.prod(
        shape)
    metrics, grads = mesh_grads(cfg, sm)
    if cfg.grad_accum == 1:   # else the last micro-batch's, as the scan's
        tol = TOL_F32 if dtype == "float32" else TOL_BF16
        assert abs(float(metrics["loss"]) - loss) <= tol * abs(loss)
    shares = grad_shares(ref_flat, grads)
    worst = max(shares, key=shares.get)
    assert shares[worst] <= (TOL_F32 if dtype == "float32" else TOL_BF16), \
        (worst, shares[worst])
    assert {reference_path(n)[0] for n in grads} == set(ref_flat)
    if shape != (1, 3):   # at (1, 3) SMOKE's 128 columns stay whole
        assert any(sh.key != (-1, -1) for sh in sm.shards), "nothing cut"


def test_mesh_moe_aux_counts_once():
    """qwen3 at (2, 2): every data group routes the global batch and holds
    its aux loss; the mesh's aux is the one-device aux, not twice it."""
    cfg, sm = placed("qwen3-moe-30b-a3b", (2, 2))
    _, one = configs("qwen3-moe-30b-a3b")
    model = lm_params_from_reference(one, reference_params(
        "qwen3-moe-30b-a3b"), device="cpu")
    batch = steps.as_batch(make_batch(cfg), "cpu")
    with torch.no_grad():
        _, want = steps.loss_fn(cfg, model, batch)
        _, got = steps.loss_fn(cfg, sm, batch)
    assert float(want["aux"]) > 0
    assert float(got["aux"]) == pytest.approx(float(want["aux"]), rel=1e-6)


def _one_device(arch, **fields):
    _, cfg = configs(arch, **fields)
    return lm_params_from_reference(cfg, reference_params(arch),
                                    device="cpu", trainable=True)


@pytest.mark.parametrize("arch,shape,fields", [
    ("llama3.2-3b", (2, 2), {}), ("mixtral-8x22b", (2, 2), FSDP)])
def test_adamw_over_shards_is_the_one_device_update(arch, shape, fields):
    """Two updates (clipping on) fed the one-device gradients cut into
    every copy: each leaf within 1e-6 of its largest value of the
    one-device update (the global norm sums in shard order)."""
    opt = adamw.AdamWConfig(peak_lr=1e-2, warmup_steps=1, total_steps=10,
                            clip_norm=1.0)
    cfg, sm = placed(arch, shape, **fields)
    model = _one_device(arch, **fields)
    _, grads = steps.grads_of(cfg, model, steps.as_batch(make_batch(cfg),
                                                         "cpu"))
    by_name = dict(zip([n for n, _ in named_leaves(model)], grads))
    cut = [sm.px.piece(reference_path(sh.name)[0], by_name[sh.name],
                       sh.key).clone()
           for sh in sm.shards for _ in sh.copies]
    s1, s2 = adamw.init(opt, model), adamw.init(opt, sm)
    for scale in (1.0, 2.0):
        _, s1, m1 = adamw.update(opt, [g * scale for g in grads], s1, model)
        _, s2, m2 = adamw.update(opt, [g * scale for g in cut], s2, sm)
        assert float(m2["grad_norm"]) == pytest.approx(
            float(m1["grad_norm"]), rel=1e-6)
        assert float(m2["lr"]) == float(m1["lr"])
    assert int(s2["step"]) == 2 and s2["step"].dtype == torch.int32
    for name, p in named_leaves(model):
        want = p.detach()
        got = sm.whole(name, sm.copies).detach()
        assert float((got - want).abs().max()) <= TOL_ADAM * float(
            want.abs().max()), name


def test_a_step_and_a_dropped_model_free_their_tensors_without_gc(
        monkeypatch):
    """A step's gradients are freed when the step returns, and a placed
    model and its moments when dropped, with the garbage collector off:
    no reference cycle holds them (a nested function that calls itself
    would, keeping GBs on the card until a collection)."""
    import torch._dynamo  # noqa: F401  (torch.utils.checkpoint imports it
    # at its first call, and the import's frames form a cycle)
    opt = adamw.AdamWConfig(total_steps=10)
    seen = []
    real = adamw.update

    def spy(cfg_, grads, state, params):
        seen.extend(weakref_of(g) for g in grads)
        return real(cfg_, grads, state, params)
    monkeypatch.setattr(adamw, "update", spy)
    gc.collect()
    gc.disable()
    try:
        cfg, sm = placed("llama3.2-3b", (1, 2))
        state = adamw.init(opt, sm)
        steps.make_train_step(cfg, opt, policy=sm.policy)(
            sm, state, **make_batch(cfg))
        held = [weakref_of(t) for t in sm.copies + state["m"] + state["v"]]
        del sm, state
        assert seen and not any(r() is not None for r in seen)
        assert not any(r() is not None for r in held)
    finally:
        gc.enable()


@pytest.mark.parametrize("arch,fields", [("llama3.2-3b", {}),
                                         ("mixtral-8x22b", FSDP)])
def test_copies_stay_bitwise_equal(one_thread, arch, fields):
    """Each rank on the CPU its own copy of every shard it reads, as on
    distinct cards: three steps over (2, 2) leave every copy of a shard and its
    moments bitwise equal, and the losses within 1e-5 of one device's."""
    opt = adamw.AdamWConfig(peak_lr=1e-2, warmup_steps=1, total_steps=10)
    cfg, sm = placed(arch, (2, 2), **fields)
    assert len(sm.copies) > len(sm.shards)
    model = _one_device(arch, **fields)
    batch = make_batch(cfg)
    mesh_step = steps.make_train_step(cfg, opt, policy=sm.policy)
    one_step = steps.make_train_step(cfg, opt, device="cpu")
    s_mesh, s_one = adamw.init(opt, sm), adamw.init(opt, model)
    for _ in range(3):
        _, s_mesh, got = mesh_step(sm, s_mesh, **batch)
        _, s_one, want = one_step(model, s_one, **batch)
        assert float(got["loss"]) == pytest.approx(float(want["loss"]),
                                                   rel=1e-5)
    i = 0
    for sh in sm.shards:
        n = len(sh.copies)
        for ts in (sm.copies, s_mesh["m"], s_mesh["v"]):
            for t in ts[i + 1:i + n]:
                assert torch.equal(ts[i], t), sh.name
        i += n


@pytest.mark.parametrize("arch,shape", [("llama3.2-3b", (2, 2)),
                                        ("seamless-m4t-medium", (1, 2))])
def test_mesh_remat_block_matches_none(one_thread, arch, shape):
    """Each layer and loss chunk over the mesh recomputed in the backward
    pass (``parallel.remat``) gives the gradients of storing them,
    bitwise."""
    out = []
    for mode in ("block", "none"):
        cfg, sm = placed(arch, shape, remat=mode)
        _, grads = mesh_grads(cfg, sm)
        out.append(grads)
    for name in out[0]:
        assert torch.equal(out[0][name], out[1][name]), name


def test_mesh_remat_recomputes_once_for_concurrent_backward_threads():
    """Backward passes on four threads at once (as four cards' autograd
    threads run one) ask a region for its saved tensors together: it
    recomputes once, under its lock, and every gradient is right."""
    calls = []

    def fn(xs):
        calls.append(len(xs))
        return [torch.sin(x) * x for x in xs]

    gen = torch.Generator().manual_seed(0)
    xs = [torch.randn(4096, generator=gen, requires_grad=True)
          for _ in range(4)]
    cfg = _tiny(remat="block")
    outs = parallel.remat(cfg, fn, xs)
    got = [None] * 4

    def backward(k):
        got[k] = torch.autograd.grad(outs[k].sum(), xs[k])[0]
    threads = [threading.Thread(target=backward, args=(k,))
               for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 2          # the forward and one recompute
    for x, g in zip(xs, got):
        want = torch.sin(x) + x * torch.cos(x)
        torch.testing.assert_close(g, want.detach())


# --- the loop: checkpoints, restores on other meshes, a lost host ----------

SPEC = TokenStreamSpec(vocab=256, seq_len=32, global_batch=8)
OPT = adamw.AdamWConfig(total_steps=20, warmup_steps=2)


def _tiny(**fields):
    return dataclasses.replace(get_config("llama3.2-3b", smoke=True),
                               vocab=256, **fields)


def _loop(ckpt_dir, cfg, shape, total, hook=None, ckpt_every=2,
          mode="pjit"):
    return TrainLoop(cfg, OPT, LoopConfig(total_steps=total,
                                          ckpt_every=ckpt_every,
                                          ckpt_dir=str(ckpt_dir), mode=mode),
                     _mesh(shape), data_spec=SPEC, failure_hook=hook)


def _losses(loop):
    return {m["step"]: m["loss"] for m in loop.metrics_log}


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_checkpoint_from_shards_is_the_reference_tree(tmp_path):
    """One step at (2, 2) with FSDP: the step-0 checkpoint holds the
    reference's names, shapes and dtypes in its order, and its bytes are
    the live state's leaves assembled from their shards."""
    cfg = _tiny(**FSDP)
    loop = _loop(tmp_path, cfg, (2, 2), 1)
    loop.run()
    assert any(dp is not None for _, dp in loop.params.px.splits.values())
    rcfg = dataclasses.replace(ref_get_config("llama3.2-3b", smoke=True),
                               vocab=256, **FSDP)
    params = jax.eval_shape(ref_build_model(rcfg).init,
                            jax.random.PRNGKey(0))
    opt = jax.eval_shape(lambda p: ref_adamw.init(ref_adamw.AdamWConfig(),
                                                   p), params)
    want = [("/".join(str(getattr(k, "key", k)) for k in path), leaf.shape,
             str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                {"params": params, "opt": opt})[0]]
    path = os.path.join(str(tmp_path), "step_00000000")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert [(r["name"], tuple(r["shape"]), r["dtype"])
            for r in manifest["leaves"]] == [(n, tuple(s), d)
                                             for n, s, d in want]
    flat, _ = io.restore(path)
    live = dict(named_leaves(loop._tree()))
    assert [r["name"] for r in manifest["leaves"]] == list(live)
    for rec, got in zip(manifest["leaves"], flat):
        assert torch.equal(got, live[rec["name"]]), rec["name"]


@pytest.mark.parametrize("shape", [(1, 2), (1, 1)])
def test_checkpoint_from_2x2_resumes_on_another_mesh(tmp_path, shape):
    """Written at (2, 2) (checkpoints at 0 and 2), resumed by a loop at
    `shape` from step 3: its losses are the uninterrupted one-device
    loop's within 1e-5 relative."""
    cfg = _tiny(**FSDP)
    _loop(tmp_path / "ck", cfg, (2, 2), 3).run()
    resumed = _loop(tmp_path / "ck", cfg, shape, 5)
    resumed.run()
    assert [m["step"] for m in resumed.metrics_log] == [3, 4]
    one = _loop(tmp_path / "one", cfg, (1, 1), 5)
    one.run()
    want = _losses(one)
    for step, loss in _losses(resumed).items():
        assert loss == pytest.approx(want[step], rel=1e-5), step


@pytest.mark.chaos
@pytest.mark.parametrize("fields", [FSDP, {}], ids=["fsdp", "tp"])
def test_lost_host_shrinks_2x2_to_1x2_and_replays(tmp_path, one_thread,
                                                  fields):
    """A failure losing two ranks at step 4 of a (2, 2) loop (checkpoints
    every 3) shrinks it to (1, 2): FSDP's shards are placed anew from the
    checkpoint, tensor-parallel ones keep their storage; the steps after
    the restore are bitwise those of a (1, 2) loop resumed from the same
    checkpoint."""
    cfg = _tiny(**fields)
    fired = []

    def hook(step):
        if step == 4 and not fired:
            fired.append(step)
            raise FailureInjected("lost", lost_hosts=2)
    loop = _loop(tmp_path / "a", cfg, (2, 2), 7, hook=hook, ckpt_every=3)
    before = {t.data_ptr() for t in loop.params.parameters()}
    loop.run()
    assert fired and tuple(loop.mesh.shape.values()) == (1, 2)
    assert [m["step"] for m in loop.metrics_log] == list(range(7))
    kept = {t.data_ptr() for t in loop.params.parameters()}
    assert (kept <= before) == (not fields)
    os.makedirs(tmp_path / "b")
    shutil.copytree(tmp_path / "a" / "step_00000003",
                    tmp_path / "b" / "step_00000003")
    fresh = _loop(tmp_path / "b", cfg, (1, 2), 7, ckpt_every=3)
    fresh.run()
    got = _losses(loop)
    assert {s: got[s] for s in (4, 5, 6)} == _losses(fresh)


def test_dp_compressed_over_a_model_axis_is_the_data_run(tmp_path,
                                                         one_thread):
    """dp_compressed at (2, 2): each model rank of a data row holds the
    row's replica, so the run is bitwise the (2, 1) run."""
    cfg = _tiny()
    runs = []
    for shape in ((2, 1), (2, 2)):
        loop = _loop(tmp_path / str(shape), cfg, shape, 3,
                     mode="dp_compressed")
        loop.run()
        runs.append(loop)
    assert _losses(runs[0]) == _losses(runs[1])
    for a, b in zip(runs[0].params.parameters(),
                    runs[1].params.parameters()):
        assert torch.equal(a, b)


def test_mesh_step_runs_only_the_parameters_its_policy_placed():
    """A step with a policy refuses one device's parameters, and a batch
    that does not split over two data groups."""
    cfg, sm = placed("llama3.2-3b", (2, 1))
    opt = adamw.AdamWConfig(total_steps=10)
    step = steps.make_train_step(cfg, opt, policy=sm.policy)
    one = _one_device("llama3.2-3b")
    batch = make_batch(cfg)
    with pytest.raises(ValueError, match="placed by it"):
        step(one, adamw.init(opt, one), **batch)
    odd = {k: v[:1] for k, v in batch.items()}
    with pytest.raises(ValueError, match="does not split over 2 data"):
        step(sm, adamw.init(opt, sm), **odd)
    assert B % 2 == 0
    other = make_policy(cfg, _mesh((1, 2)))
    with pytest.raises(ValueError, match="the step's policy"):
        steps.make_train_step(cfg, opt, policy=other)(
            sm, adamw.init(opt, sm), **batch)
