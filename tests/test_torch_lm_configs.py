"""The LM side's configs, counts, parameter carry-over and entry points on
the CPU: every ported config equal to the reference's field by field, the
parameter counts equal to the reference's (counted on the meta device, no
allocation), unported architectures refused with their ROADMAP slice, and
``python -m repro_torch.launch.serve`` on the CPU (without ``--device cpu``
and without a card it raises)."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models.registry import build_model as ref_build_model
from repro_torch import configs
from repro_torch.convert import lm_params_from_reference
from repro_torch.launch.serve import serve, summary
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import build_model

REPO = Path(__file__).resolve().parent.parent
PORTED = ["llama3.2-3b", "nemotron-4-340b", "starcoder2-3b", "chatglm3-6b",
          "falcon-mamba-7b", "hymba-1.5b", "qwen3-moe-30b-a3b",
          "mixtral-8x22b"]
UNPORTED = ["qwen2-vl-72b", "seamless-m4t-medium"]


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", PORTED)
def test_config_equals_reference(arch, smoke):
    got = configs.get_config(arch, smoke=smoke)
    want = ref_get_config(arch, smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.hd, got.dt_rank, got.d_inner, got.layer_windows()) == \
        (want.hd, want.dt_rank, want.d_inner, want.layer_windows())


def test_registry_lists_the_ported_archs():
    assert configs.list_archs() == PORTED
    assert sorted(PORTED + UNPORTED) == sorted(
        __import__("repro.configs", fromlist=["ARCHS"]).ARCHS)


@pytest.mark.parametrize("arch", PORTED)
def test_param_count_matches_reference_on_meta(arch):
    cfg = configs.get_config(arch)
    model = build_model(cfg)
    shapes = model.init_shapes()
    assert all(p.device.type == "meta" for p in shapes.parameters())
    ref = ref_build_model(ref_get_config(arch))
    assert cfg.param_count() == model.param_count() == ref.param_count()
    if cfg.uses_moe:   # experts scaled by top_k / E
        assert model.active_param_count() == ref.active_param_count() < \
            model.param_count()
    else:
        assert model.active_param_count() == ref.param_count()


@pytest.mark.parametrize("arch", UNPORTED)
def test_unported_archs_raise_not_implemented(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP slice 12b"):
        configs.get_config(arch)
    cfg = ModelConfig(**dataclasses.asdict(ref_get_config(arch, smoke=True)))
    with pytest.raises(NotImplementedError, match="ROADMAP slice 12b"):
        build_model(cfg)


def test_unknown_arch_and_override():
    with pytest.raises(KeyError):
        configs.get_config("gpt-2")
    cfg = configs.override(configs.get_config("hymba-1.5b"), dtype="float32")
    assert cfg.activation_dtype() == torch.float32
    with pytest.raises(ValueError):
        configs.override(cfg, n_kv_heads=4)   # 25 heads over 4


def _reference_params(arch):
    cfg = ref_get_config(arch, smoke=True)
    return jax.tree.map(np.asarray,
                        ref_build_model(cfg).init(jax.random.PRNGKey(0)))


def test_lm_params_from_reference_checks_every_leaf():
    cfg = configs.get_config("chatglm3-6b", smoke=True)  # qkv bias, lm_head
    params = _reference_params("chatglm3-6b")
    model = lm_params_from_reference(cfg, params, device="cpu")
    assert torch.equal(model.blocks[1].attn["bq"],
                       torch.tensor(params["blocks"]["attn"]["bq"][1]))
    assert torch.equal(model.lm_head, torch.tensor(params["lm_head"]))
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count()
    missing = dict(params, blocks=dict(params["blocks"]))
    del missing["blocks"]["ln2"]
    with pytest.raises(ValueError, match="lack blocks/ln2"):
        lm_params_from_reference(cfg, missing, device="cpu")
    extra = dict(params, extra=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="does not have"):
        lm_params_from_reference(cfg, extra, device="cpu")
    reshaped = dict(params, final_norm=np.ones(7, np.float32))
    with pytest.raises(ValueError, match="final_norm"):
        lm_params_from_reference(cfg, reshaped, device="cpu")
    narrow = dict(params, embed=params["embed"].astype(np.float16))
    with pytest.raises(ValueError, match="embed"):
        lm_params_from_reference(cfg, narrow, device="cpu")


def test_serve_function_on_cpu():
    cfg = configs.get_config("falcon-mamba-7b", smoke=True)
    res = serve(cfg, batch=2, prompt_len=20, gen=4, device="cpu")
    assert res["tokens"].shape == (2, 4)
    assert res["first_logits"].shape == (2, 1, cfg.vocab)
    assert bool(torch.isfinite(res["first_logits"]).all())
    assert summary(res).startswith("falcon-mamba-7b-smoke: prefill=")


def _serve_cli(*extra):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "hymba-1.5b", "--smoke", "--batch", "2", "--prompt-len", "40",
         "--gen", "4", *extra], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)


def test_serve_cli_runs_on_cpu():
    out = _serve_cli("--device", "cpu")
    assert out.returncode == 0, out.stderr[-2000:]
    line = out.stdout.strip().splitlines()[-1]
    assert line.startswith("hymba-1.5b-smoke: prefill=")
    assert "decode 3 steps=" in line and line.endswith("tok/s)")


def test_serve_cli_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    out = _serve_cli()
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr
