"""The LM serving path over a (data, model) mesh of CPU ranks
(models/parallel.py) against the reference's unsharded run.

Each family's SMOKE config, with the reference's parameters carried into
the ranks' shards (``convert.lm_params_from_reference(mesh=)``), prefills
the prompts of tests/_lm_parity.py and decodes three greedy steps fed the
reference's tokens over meshes of ``["cpu"] * p``: (1, 2), (2, 2) (the
batch of 2 split over data) and (1, 3), where most SMOKE leaves stay whole
(128 columns do not split in three) and others are cut: hymba's vocabulary
of 513, qwen3's expert F of 96 (intra-expert tensor parallelism).  More
placements: nemotron at (1, 3) cuts wq (192 columns, 2 heads a rank)
while wk (64) stays whole, so the queries are gathered to whole GQA
groups; hymba at (1, 4) cuts wk into half heads; mixtral with
``param_sharding="fsdp_tp"`` at (2, 2) gathers its FSDP leaves over data
at their use.  Every logit, and every prefill cache element once the
ranks' pieces are put together, is held to tests/_lm_parity.py's
tolerances (float32 1e-5 of the reference's largest |value|, bf16 2e-2),
and the greedy tokens equal the reference's.

Also: each rank's shard of each leaf has the shape its spec gives; the
MoE layer under expert parallelism is bitwise the one-device layer; the
launcher serves every architecture over two CPU ranks.
"""

import re

import numpy as np
import pytest
import torch

from _lm_parity import (PROMPT, STEPS, TOL_BF16, TOL_F32, _caches, configs,
                        inputs, port_inputs, reference_run, within)
from repro_torch.configs import get_config, list_archs
from repro_torch.convert import lm_params_from_reference
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import layers, steps
from repro_torch.models.parallel import Placement, ShardedLM
from repro_torch.models.registry import build_model
from repro_torch.models.sharding import make_policy
from repro_torch.tree import reference_path

AXES = ("data", "model")
SHAPES = [(1, 2), (2, 2), (1, 3)]
FAMILIES = ["llama3.2-3b", "hymba-1.5b", "falcon-mamba-7b",
            "qwen3-moe-30b-a3b", "qwen2-vl-72b", "seamless-m4t-medium"]
FSDP = (("param_sharding", "fsdp_tp"),)
DECODE = 3
CASES = ([(arch, None, (), shape) for arch in FAMILIES for shape in SHAPES]
         + [("nemotron-4-340b", None, (), (1, 3)),
            ("hymba-1.5b", None, (), (1, 4)),
            ("mixtral-8x22b", None, FSDP, (2, 2)),
            ("hymba-1.5b", "bfloat16", (), (2, 2)),
            ("llama3.2-3b", "bfloat16", (), (1, 2))])


def _mesh(shape):
    return make_mesh(shape, AXES, devices=["cpu"] * int(np.prod(shape)))


def _check(want, got, dtype, what):
    if dtype is None:
        err, ok = within(want, got, rel=TOL_F32)
    else:
        err, ok = within(want, got, atol=TOL_BF16)
    assert ok, f"{what}: max |mesh - reference| = {err:.3e}"


@pytest.mark.parametrize("arch,dtype,extra,shape", CASES)
def test_mesh_prefill_and_decode_match_the_reference(arch, dtype, extra,
                                                     shape):
    _, cfg = configs(arch, dtype, None, extra)
    params, batch, ref = reference_run(arch, dtype, None, None, extra)
    _, dec_pos = inputs(cfg)
    mesh = _mesh(shape)
    policy = make_policy(cfg, mesh)
    model = lm_params_from_reference(cfg, params, mesh=mesh)
    assert isinstance(model, ShardedLM)
    prefill = steps.make_prefill_step(cfg, cache_capacity=PROMPT + STEPS,
                                      policy=policy)
    decode = steps.make_decode_step(cfg, policy=policy)
    logits, cache = prefill(model, **port_inputs(cfg, batch))
    _check(ref[0]["logits"], logits.float().numpy(), dtype, "prefill logits")
    whole = _caches(cache.assemble())
    assert len(whole) == len(ref[0]["cache"])
    for i, (rc, pc) in enumerate(zip(ref[0]["cache"], whole)):
        assert sorted(rc) == sorted(pc)
        for name in rc:
            _check(rc[name], pc[name].float().numpy(), dtype,
                   f"prefill cache run {i} {name}")
    for t in range(DECODE + 1):
        got = logits.float().numpy()
        np.testing.assert_array_equal(got[:, -1].argmax(-1),
                                      ref[t]["next"][:, 0])
        if t == DECODE:
            break
        dkw = {} if dec_pos is None else \
            {"positions": torch.from_numpy(dec_pos(t))}
        tok = torch.tensor(ref[t]["next"], dtype=torch.long)
        logits, cache = decode(model, token=tok, cache=cache,
                               cache_index=PROMPT + t, **dkw)
        _check(ref[t + 1]["logits"], logits.float().numpy(), dtype,
               f"decode step {t + 1} logits")


def _local_shape(shape, px, path):
    tp_dim, dp_dim = px.splits[path]
    out = list(shape)
    if tp_dim is not None:
        out[tp_dim] //= px.tp
    if dp_dim is not None:
        out[dp_dim] //= px.dp
    return tuple(out)


SHARD_CASES = ([(arch, (), shape) for arch in FAMILIES for shape in SHAPES]
               + [("nemotron-4-340b", (), (1, 3)),
                  ("mixtral-8x22b", FSDP, (2, 2))])


@pytest.mark.parametrize("arch,extra,shape", SHARD_CASES)
def test_each_rank_holds_the_shard_its_spec_gives(arch, extra, shape):
    _, cfg = configs(arch, None, None, extra)
    mesh = _mesh(shape)
    policy = make_policy(cfg, mesh)
    model = build_model(cfg)
    one = model.init(torch.Generator().manual_seed(0), "cpu")
    sm = model.init(torch.Generator().manual_seed(0), mesh=mesh)
    specs = policy.params_specs(cfg, model.init_shapes())
    px = sm.px
    split = 0
    whole = dict(one.named_parameters())
    for r, rank in enumerate(sm.ranks):
        got = dict(rank.named_parameters())
        assert sorted(got) == sorted(whole)
        for name, leaf in got.items():
            path, layer = reference_path(name)
            spec = specs[path][1:] if layer is not None else specs[path]
            want = _local_shape(whole[name].shape, px, path)
            assert tuple(leaf.shape) == want, (name, spec)
            split += want != tuple(whole[name].shape)
            if path.endswith("ssm/in_proj") and px.tp_dim(path) == 1:
                # each rank's x and z columns together
                di, w, m = cfg.d_inner, leaf.shape[1] // 2, r % px.tp
                full = whole[name]
                assert torch.equal(leaf, torch.cat(
                    [full[:, m * w:(m + 1) * w],
                     full[:, di + m * w:di + (m + 1) * w]], 1))
            elif px.splits[path] == (None, None):
                assert torch.equal(leaf, whole[name])
    if px.tp > 1 and shape != (1, 3):
        assert split, "nothing was cut"


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("arch,shape", [
    ("qwen3-moe-30b-a3b", (1, 2)), ("qwen3-moe-30b-a3b", (1, 4)),
    ("qwen3-moe-30b-a3b", (2, 2)), ("mixtral-8x22b", (1, 4)),
    ("mixtral-8x22b", (2, 2))])
def test_moe_layer_under_expert_parallelism_is_bitwise_one_device(
        arch, shape, dtype):
    _, cfg = configs(arch, dtype)
    mesh = _mesh(shape)
    assert Placement(cfg, make_policy(cfg, mesh)).tp_dim("blocks/moe/w1") \
        == 0, "expert parallel"
    model = build_model(cfg)
    one = model.init(torch.Generator().manual_seed(0), "cpu")
    sm = model.init(torch.Generator().manual_seed(0), mesh=mesh)
    x = torch.randn((4, 24, cfg.d_model), generator=torch.Generator()
                    .manual_seed(5)).to(cfg.activation_dtype())
    want, _ = layers.moe_apply(cfg, one.blocks[1].moe, x)
    split = sm.px.batch_split(x.shape[0])
    out, _ = layers.moe_apply_tp(cfg, sm.px, sm.parts("blocks.1.moe"),
                                 sm.px.scatter(x, split), split=split)
    assert not out.partial
    assert torch.equal(sm.px.collect(out.parts, split), want)


def test_moe_layer_under_intra_expert_parallelism():
    """F split over three ranks: float32 partials, within 1e-5."""
    _, cfg = configs("qwen3-moe-30b-a3b")
    mesh = _mesh((1, 3))
    model = build_model(cfg)
    one = model.init(torch.Generator().manual_seed(0), "cpu")
    sm = model.init(torch.Generator().manual_seed(0), mesh=mesh)
    assert sm.px.tp_dim("blocks/moe/w1") == 2
    x = torch.randn((4, 24, cfg.d_model),
                    generator=torch.Generator().manual_seed(5))
    want, _ = layers.moe_apply(cfg, one.blocks[0].moe, x)
    split = sm.px.batch_split(x.shape[0])
    out, _ = layers.moe_apply_tp(cfg, sm.px, sm.parts("blocks.0.moe"),
                                 sm.px.scatter(x, split), split=split)
    err, ok = within(want.numpy(), sm.px.collect(out.parts, split).numpy(),
                     rel=TOL_F32)
    assert ok, err


LINE = re.compile(r"^\S+: prefill=\d+ms decode \d+ steps=\d+ms "
                  r"\(\d+ tok/s\)$")


@pytest.mark.parametrize("arch", list_archs())
def test_launcher_serves_over_two_cpu_ranks(arch, capsys):
    serve_mod.main(["--arch", arch, "--smoke", "--model-axis", "2",
                    "--devices", "cpu,cpu", "--prompt-len", "16",
                    "--gen", "3"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and LINE.match(out[0]), out


def test_launcher_mesh_matches_one_device():
    cfg = get_config("llama3.2-3b", smoke=True)
    one = serve_mod.serve(cfg, batch=2, prompt_len=16, gen=4, device="cpu")
    two = serve_mod.serve(cfg, batch=2, prompt_len=16, gen=4,
                          devices=["cpu"] * 4, model_axis=2)
    assert one["policy"] is None and two["policy"].tp_size == 2
    assert torch.equal(one["tokens"], two["tokens"])
    err, ok = within(one["first_logits"].numpy(),
                     two["first_logits"].numpy(), rel=TOL_F32)
    assert ok, err


def test_mesh_entry_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_mod.main(["--arch", "llama3.2-3b", "--smoke", "--model-axis",
                        "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_mod.serve(get_config("llama3.2-3b", smoke=True),
                        devices=["cuda:0", "cuda:0"])


@pytest.mark.parametrize("tp", [2, 3, 4, 8])
@pytest.mark.parametrize("arch", [a for a in list_archs()
                                  if get_config(a).n_heads])
def test_head_plans_cover_every_row_of_wo(arch, tp):
    """At full width over (1, tp): each rank's query heads are whole GQA
    groups covering its rows of wo, its KV heads hold those the queries
    read, and the ranks' rows are wo's rows, each once where wo is cut."""
    cfg = get_config(arch)
    mesh = _mesh((1, tp))
    px = Placement(cfg, make_policy(cfg, mesh))
    hd, h, rep = cfg.hd, cfg.n_heads, cfg.n_heads // cfg.n_kv_heads
    for prefix, cached in [("blocks/attn", True)] + (
            [("blocks/xattn", False), ("enc_blocks/attn", False)]
            if cfg.enc_dec else []):
        plan = layers.head_plan(cfg, px, prefix, cached)
        rows = []
        for m in range(tp):
            (q0, q1), (k0, k1) = plan.q[m], plan.kv[m]
            (r0, r1), (lo, hi) = plan.reads[m], plan.rows[m]
            assert q0 % rep == 0 and q1 % rep == 0
            assert q0 * hd <= lo < hi <= q1 * hd
            assert (r0, r1) == (q0 // rep, q1 // rep)
            assert k0 <= r0 <= r1 <= k1
            rows.append((lo, hi))
        if plan.wo_split:
            assert rows == [(m * h * hd // tp, (m + 1) * h * hd // tp)
                            for m in range(tp)]
        else:
            assert set(rows) == {(0, h * hd)}


def test_training_refuses_a_sharded_placement():
    from repro_torch.optim import adamw
    cfg = get_config("llama3.2-3b", smoke=True)
    with pytest.raises(NotImplementedError, match="ROADMAP A part 5"):
        build_model(cfg).init(torch.Generator().manual_seed(0),
                              mesh=_mesh((1, 2)), trainable=True)
    sm = build_model(cfg).init(torch.Generator().manual_seed(0),
                               mesh=_mesh((1, 2)))
    step = steps.make_train_step(cfg, adamw.AdamWConfig(), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A part 5"):
        step(sm, None, tokens=np.zeros((2, 8), np.int32),
             labels=np.zeros((2, 8), np.int32))


@pytest.mark.parametrize("build", ["prefill", "decode"])
def test_serving_steps_run_the_placement_their_policy_names(build):
    """A step with a policy runs only parameters placed by it; a step
    without one runs only one device's."""
    cfg = get_config("llama3.2-3b", smoke=True)
    model = build_model(cfg)
    one = model.init(torch.Generator().manual_seed(0), "cpu")
    sm = model.init(torch.Generator().manual_seed(0), mesh=_mesh((1, 2)))
    other = make_policy(cfg, _mesh((1, 2)))

    def make(policy):
        if build == "prefill":
            return steps.make_prefill_step(cfg, cache_capacity=9,
                                           policy=policy)
        return steps.make_decode_step(cfg, policy=policy)

    kw = ({"tokens": torch.zeros((2, 8), dtype=torch.long)}
          if build == "prefill" else
          {"token": torch.zeros((2, 1), dtype=torch.long), "cache": None,
           "cache_index": 0})
    with pytest.raises(ValueError, match="policy= that placed them"):
        make(None)(sm, **kw)
    with pytest.raises(ValueError, match="placed by it"):
        make(sm.policy)(one, **kw)
    with pytest.raises(ValueError, match="the step's policy"):
        make(other)(sm, **kw)
