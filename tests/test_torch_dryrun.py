"""The dry run (launch/dryrun.py), its stand-ins (models/config.py
``input_specs`` / ``cache_specs``), the production mesh and the
collectives' records (runtime/hlo.py) against the reference.

The reference's dry-run modules set XLA_FLAGS when imported, which would
give every later JAX test of this process 512 CPU devices: they run in one
subprocess here (4 forced CPU devices, ``make_production_mesh`` patched to
a (2, 2) mesh, SMOKE configs, shapes cut to a few rows), which compiles
nemotron's decode and llama's train cell and lists hillclimb's
experiments.  The port's records of the same cells must give the same
``params``, ``active_params``, ``seq``, ``batch``, ``chips``, ``mesh`` and
argument bytes a device.  Other reference modules (config, plan, tiling,
lightpcc) are safe to import here.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import lightpcc as ref_lightpcc
from repro.core import plan as ref_plan
from repro.core import tiling as ref_tiling
from repro.models import config as ref_config
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (make_mesh, make_production_mesh,
                                     mesh_device)
from repro_torch.models import config
from repro_torch.models import steps
from repro_torch.models.parallel import Placement
from repro_torch.models.registry import build_model
from repro_torch.models.sharding import make_policy
from repro_torch.optim import adamw
from repro_torch.runtime import hlo

# the cells' shapes in both packages' subprocess and test runs: (seq,
# batch, kind), the batch divisible by the data axis
SMALL = {"train_4k": (64, 8, "train"), "prefill_32k": (128, 4, "prefill"),
         "decode_32k": (128, 8, "decode")}
CELLS = [("nemotron-4-340b", "decode_32k"), ("llama3.2-3b", "train_4k")]


def _dtype_name(d) -> str:
    return str(d).rsplit(".", 1)[-1]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: (tuple(tree.shape), _dtype_name(tree.dtype))}


@pytest.mark.parametrize("arch", list_archs())
def test_input_and_cache_specs_are_the_references(arch):
    """Every shape cell of every FULL config: the same keys, shapes and
    dtypes, meta tensors only; a shape the arch does not list raises."""
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    for shape in cfg.shapes:
        got = config.input_specs(cfg, shape)
        want = ref_config.input_specs(rcfg, shape)
        assert list(got) == list(want)
        g, w = _flat(got), _flat(want)
        assert g == w, shape
        for t in torch.utils._pytree.tree_leaves(got):
            assert t.is_meta
    seq, batch, _ = config.SHAPES[cfg.shapes[0]]
    assert _flat(config.cache_specs(cfg, 2, 64)) == \
        _flat(ref_config.cache_specs(rcfg, 2, 64))
    missing = [s for s in config.SHAPES if s not in cfg.shapes]
    for s in missing + ["nope"]:
        with pytest.raises(ValueError):
            config.input_specs(cfg, s)
        with pytest.raises(ValueError):
            ref_config.input_specs(rcfg, s)


def test_production_mesh_is_meta_ranks():
    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert one.axis_names == ("data", "model")
    assert tuple(one.devices.shape) == (16, 16)
    assert two.axis_names == ("pod", "data", "model")
    assert tuple(two.devices.shape) == (2, 16, 16)
    assert {d.type for d in two.ranks} == {"meta"}
    assert dryrun.describe(one) == "Mesh(data=16 x model=16; 256 devices)"
    assert mesh_device("meta") == torch.device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            mesh_device("cuda")


def test_full_nemotron_decode_cache_is_a_sixteenth_a_device():
    """nemotron-4-340b FULL decode_32k on the production mesh: Hkv = 8
    cannot split over 16 model ranks, so heads mode would hold the whole
    cache (its batch rows) on each; sequence mode holds 1/16 of it."""
    cfg = get_config("nemotron-4-340b")
    assert cfg.kv_cache_shard == "sequence"
    seq, batch, _ = config.SHAPES["decode_32k"]
    meta = config.cache_specs(cfg, batch, seq)
    whole = sum(t.numel() * t.element_size() for c in meta
                for t in c.values())
    px = Placement(cfg, make_policy(cfg, make_production_mesh()))
    cache = px.new_caches(meta)
    assert cache.by_positions(0)
    for rank in (cache.ranks[0], cache.ranks[-1]):
        held = sum(t.numel() * t.element_size() for c in rank
                   for t in c.values())
        assert held * 16 * 16 == whole    # 1/16 of its data group's rows
        assert tuple(rank[0]["k"].shape) == (96, 8, 8, 2048, 192)


def _small_cells(monkeypatch, shape=(2, 2)):
    """The port's dry run over a mesh of `shape` meta ranks, SMOKE configs,
    SMALL shapes."""
    monkeypatch.setattr(dryrun, "make_production_mesh",
                        lambda multi_pod=False: make_mesh(
                            shape, ("data", "model"),
                            devices=["meta"] * int(np.prod(shape))))
    monkeypatch.setattr(dryrun, "get_config",
                        lambda arch: get_config(arch, smoke=True))
    for k, v in SMALL.items():
        monkeypatch.setitem(config.SHAPES, k, v)


_REFERENCE = textwrap.dedent("""
    import contextlib, io, json, sys
    import jax
    import numpy as np
    from repro.launch import dryrun, hillclimb
    from repro.configs import get_config
    from repro.models import config as C
    assert jax.device_count() == 4, jax.device_count()
    dryrun.make_production_mesh = lambda multi_pod=False: jax.sharding.Mesh(
        np.array(jax.devices()).reshape(2, 2), ("data", "model"))
    dryrun.get_config = lambda a: get_config(a, smoke=True)
    C.SHAPES.update({SMALL})
    out = {{"cells": {{}}}}
    for arch, shape in {CELLS}:
        rec = dryrun.run_cell(arch, shape, False, save=False)
        out["cells"][arch + "/" + shape] = rec
    buf = io.StringIO()
    sys.argv = ["hillclimb", "--list"]
    with contextlib.redirect_stdout(buf):
        hillclimb.main()
    out["hillclimb"] = buf.getvalue()
    print("JSON" + json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference_records():
    code = _REFERENCE.format(SMALL=repr(SMALL), CELLS=repr(CELLS))
    env = dict(os.environ, JAX_PLATFORMS="cpu", REPRO_EXTRA_XLA_FLAGS=(
        "--xla_force_host_platform_device_count=4"))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.path.join(root, "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    line = [x for x in res.stdout.splitlines() if x.startswith("JSON")][-1]
    return json.loads(line[4:])


@pytest.mark.parametrize("arch,shape", CELLS)
def test_dry_run_records_match_the_reference_compile(
        arch, shape, monkeypatch, reference_records):
    _small_cells(monkeypatch)
    want = reference_records["cells"][f"{arch}/{shape}"]
    got = dryrun.run_cell(arch, shape, False, save=False)
    for key in ("arch", "shape", "kind", "params", "active_params", "seq",
                "batch", "chips", "mesh", "label"):
        assert got[key] == want[key], key
    # the parameters', moments', inputs' and cache's bytes a device
    assert got["memory"]["argument_size_in_bytes"] == \
        want["memory"]["argument_size_in_bytes"]
    assert set(got["memory"]) >= {"argument_size_in_bytes",
                                  "output_size_in_bytes",
                                  "temp_size_in_bytes"}
    assert got["cost"]["flops"] > 0 and got["cost"]["bytes accessed"] > 0
    assert got["collectives"]["total_bytes"] == sum(
        got["collectives"]["bytes_by_kind"].values())
    json.dumps(got)     # a record is JSON


def test_hillclimb_lists_the_references_experiments(reference_records,
                                                    capsys):
    from repro_torch.launch import hillclimb
    argv = sys.argv
    sys.argv = ["hillclimb", "--list"]
    try:
        hillclimb.main()
    finally:
        sys.argv = argv
    assert capsys.readouterr().out == reference_records["hillclimb"]


def test_every_cell_composes_on_a_small_mesh(monkeypatch):
    """Each family's SMOKE cells over (2, 2) meta ranks (the MoE, SSM,
    hybrid, VLM and encoder-decoder paths on the meta device) give a record
    with FLOPs, bytes and argument bytes."""
    _small_cells(monkeypatch)
    for arch in ("qwen3-moe-30b-a3b", "hymba-1.5b", "qwen2-vl-72b",
                 "seamless-m4t-medium", "falcon-mamba-7b"):
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            rec = dryrun.run_cell(arch, shape, False, save=False)
            assert rec["cost"]["flops"] > 0, (arch, shape)
            assert rec["memory"]["argument_size_in_bytes"] > 0


@pytest.mark.parametrize("multi_pod", [False, True])
def test_run_pcc_gives_the_references_analytic_fields(multi_pod):
    from repro_torch.configs import lightpcc
    p = 512 if multi_pod else 256
    ref = {c.name: c for t in ref_lightpcc.TABLES.values() for c in t}
    for table in lightpcc.TABLES.values():
        for c in table:
            assert vars(c) == vars(ref[c.name])
            got = dryrun.run_pcc(c.name, multi_pod, save=False)
            plan = ref_tiling.TilePlan.create(c.n, c.l, c.t)
            l_pad = -(-c.l // c.l_blk) * c.l_blk
            per_dev = ref_plan.tiles_per_device(plan.total_tiles, p)
            pass_tiles = min(per_dev, c.max_tiles_per_pass)
            want = {
                "label": f"lightpcc-{c.name}__allpairs__"
                         f"{'pod2' if multi_pod else 'pod1'}",
                "arch": f"lightpcc-{c.name}", "shape": "allpairs",
                "kind": "pcc", "chips": p, "n": c.n, "l": c.l, "t": c.t,
                "tiles_total": plan.total_tiles, "tiles_per_device": per_dev,
                "pass_tiles": pass_tiles,
                "paper_unit_ops": ref_lightpcc.flops(c),
                "analytic_flops_per_dev": pass_tiles * c.t * c.t * 2 * l_pad,
                "analytic_hbm_bytes_per_dev":
                    pass_tiles * (2 * c.t * l_pad + c.t * c.t) * 4,
            }
            assert {k: got[k] for k in want} == want
            assert got["memory"]["argument_size_in_bytes"] >= \
                plan.n_pad * l_pad * 4


def test_collective_records_are_hand_counted():
    """llama3.2-3b SMOKE (D 128, F 256, 2 layers, tied 512-row embedding)
    over (2, 2) CPU ranks, 4 x 16 tokens (2 rows a data group).

    Forward (a prefill): the vocabulary-parallel embedding and each
    layer's attention and MLP all-reduce their float32 (2, 16, 128)
    partials over the model axis (5), and the last position's logits are
    all-gathered from the ranks' 256-column pieces (2, 1, 256).

    Train step (remat per layer, the loss chunk recomputed too): those 5
    all-reduces, their 4 layers' again in the recompute and 5 duals in the
    backward (14); the logits' all-gather of (2, 16, 256) and its
    recompute (2), its dual a reduce-scatter of the (2, 16, 512) gradient;
    and a gradient all-reduce for every leaf its ranks share: over data,
    each layer's wq (128, 64), wk and wv (128, 32), wo (64, 128), w1, w2
    and w3 (128, 128), and the embedding's (256, 128) rows; over data and
    model the two layers' two norms and the final norm (128,): 2 + 4 + 2
    + 6 + 1 + 5 = 20."""
    cfg = get_config("llama3.2-3b", smoke=True)
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    policy = make_policy(cfg, mesh)
    sm = build_model(cfg).init(torch.Generator().manual_seed(0), mesh=mesh,
                               trainable=True)
    toks = torch.randint(0, cfg.vocab, (4, 16),
                         generator=torch.Generator().manual_seed(1))
    sm.px.recorder = []
    steps.make_prefill_step(cfg, policy=policy)(sm, tokens=toks)
    st = hlo.collective_stats(sm.px.recorder)
    assert st.count_by_kind == {"all-reduce": 5, "all-gather": 1}
    assert st.bytes_by_kind == {"all-reduce": 5 * 2 * 16 * 128 * 4,
                                "all-gather": 2 * 1 * 256 * 4}
    assert st.redundant == [("all-reduce", "[('f32', '2,16,128')]", 5)]

    opt = adamw.AdamWConfig()
    sm.px.recorder = []
    steps.make_train_step(cfg, opt, policy=policy)(
        sm, adamw.init(opt, sm), tokens=toks, labels=toks)
    st = hlo.collective_stats(sm.px.recorder)
    grads = {(128, 64): 2, (128, 32): 4, (64, 128): 2, (128, 128): 6,
             (128,): 5, (256, 128): 1}
    assert st.count_by_kind == {"all-reduce": 14 + sum(grads.values()),
                                "all-gather": 2, "reduce-scatter": 1}
    assert st.bytes_by_kind == {
        "all-reduce": 14 * 2 * 16 * 128 * 4 + sum(
            n * 4 * int(np.prod(s)) for s, n in grads.items()),
        "all-gather": 2 * 2 * 16 * 256 * 4,
        "reduce-scatter": 2 * 16 * 512 * 4}
    redundant = {sig: n for _, sig, n in st.redundant}
    assert redundant["[('f32', '2,16,128')]"] == 14
    assert redundant["[('f32', '2,16,256')]"] == 2
    assert redundant["[('f32', '128')]"] == 5
    assert "[('f32', '2,16,512')]" not in redundant
