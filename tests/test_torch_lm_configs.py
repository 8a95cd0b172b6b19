"""The LM side's configs, counts, parameter carry-over and entry points on
the CPU: every config equal to the reference's field by field, the
parameter counts equal to the reference's (counted on the meta device, no
allocation), every architecture of the reference served, and
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
          "mixtral-8x22b", "qwen2-vl-72b", "seamless-m4t-medium"]
# the embedding-input VLM and the encoder-decoder
NEW_FAMILIES = ["qwen2-vl-72b", "seamless-m4t-medium"]


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", PORTED)
def test_config_equals_reference(arch, smoke):
    got = configs.get_config(arch, smoke=smoke)
    want = ref_get_config(arch, smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.hd, got.dt_rank, got.d_inner, got.layer_windows()) == \
        (want.hd, want.dt_rank, want.d_inner, want.layer_windows())


def test_registry_lists_the_ported_archs():
    ref = __import__("repro.configs", fromlist=["list_archs"])
    assert configs.list_archs() == ref.list_archs()
    assert sorted(PORTED) == sorted(configs.list_archs())


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


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_new_families_build_without_refusal(arch, smoke):
    """The VLM and the encoder-decoder, once refused, build: the VLM a
    DecoderLM with its embedding table (decode tokens) and qkv biases, the
    encoder-decoder an EncDecLM with enc_layers encoder blocks and
    cross-attention (no biases) in every decoder block."""
    from repro_torch.models.encdec import EncDecLM
    from repro_torch.models.transformer import DecoderLM

    cfg = ModelConfig(**dataclasses.asdict(ref_get_config(arch,
                                                          smoke=smoke)))
    model = build_model(cfg).init_shapes()
    if cfg.enc_dec:
        assert isinstance(model, EncDecLM)
        assert len(model.enc_blocks) == cfg.enc_layers
        assert all(hasattr(b, "xattn") and hasattr(b, "lnx")
                   and "bq" not in b.xattn for b in model.blocks)
        assert not hasattr(model, "src_embed")   # embed_inputs
    else:
        assert isinstance(model, DecoderLM)
        assert tuple(model.embed.shape) == (cfg.vocab, cfg.d_model)
        assert "bq" in model.blocks[0].attn


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


@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_lm_params_from_reference_new_families(arch):
    """The VLM's tree (qkv biases, untied head) and the encoder-decoder's
    (enc_blocks stacked enc_layers, enc_norm, lnx and xattn in the decoder
    blocks) carried over leaf by leaf; a missing, extra or reshaped leaf
    refused."""
    cfg = configs.get_config(arch, smoke=True)
    params = _reference_params(arch)
    model = lm_params_from_reference(cfg, params, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count()
    assert torch.equal(model.lm_head, torch.tensor(params["lm_head"]))
    if cfg.enc_dec:
        enc = params["enc_blocks"]
        assert enc["attn"]["wq"].shape[0] == cfg.enc_layers
        assert torch.equal(model.enc_blocks[1].attn["wq"],
                           torch.tensor(enc["attn"]["wq"][1]))
        assert torch.equal(model.blocks[1].xattn["wk"],
                           torch.tensor(params["blocks"]["xattn"]["wk"][1]))
        assert torch.equal(model.enc_norm, torch.tensor(params["enc_norm"]))
        stack, leaf = "enc_blocks", "ln2"
    else:
        assert torch.equal(model.blocks[1].attn["bk"],
                           torch.tensor(params["blocks"]["attn"]["bk"][1]))
        stack, leaf = "blocks", "ln1"
    missing = dict(params, **{stack: dict(params[stack])})
    del missing[stack][leaf]
    with pytest.raises(ValueError, match=f"lack {stack}/{leaf}"):
        lm_params_from_reference(cfg, missing, device="cpu")
    extra = dict(params, **{stack: dict(params[stack],
                                        extra=np.zeros(3, np.float32))})
    with pytest.raises(ValueError, match="does not have"):
        lm_params_from_reference(cfg, extra, device="cpu")
    shallow = dict(params, **{stack: dict(params[stack], **{
        leaf: params[stack][leaf][:1]})})
    with pytest.raises(ValueError, match=leaf):
        lm_params_from_reference(cfg, shallow, device="cpu")


def test_serve_function_on_cpu():
    cfg = configs.get_config("falcon-mamba-7b", smoke=True)
    res = serve(cfg, batch=2, prompt_len=20, gen=4, device="cpu")
    assert res["tokens"].shape == (2, 4)
    assert res["first_logits"].shape == (2, 1, cfg.vocab)
    assert bool(torch.isfinite(res["first_logits"]).all())
    assert summary(res).startswith("falcon-mamba-7b-smoke: prefill=")


@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_serve_function_on_cpu_new_families(arch):
    """serve() builds the reference launcher's inputs: the VLM's
    embeddings and broadcast m-rope streams, the encoder-decoder's source
    frames and target prompts; decode continues from the embedding table."""
    cfg = configs.get_config(arch, smoke=True)
    res = serve(cfg, batch=2, prompt_len=20, gen=4, device="cpu")
    assert res["tokens"].shape == (2, 4)
    assert res["first_logits"].shape == (2, 1, cfg.vocab)
    assert bool(torch.isfinite(res["first_logits"]).all())
    assert summary(res).startswith(f"{arch}-smoke: prefill=")


def _serve_cli(*extra, arch="hymba-1.5b"):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         arch, "--smoke", "--batch", "2", "--prompt-len", "40",
         "--gen", "4", *extra], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)


def test_serve_cli_runs_on_cpu():
    out = _serve_cli("--device", "cpu")
    assert out.returncode == 0, out.stderr[-2000:]
    line = out.stdout.strip().splitlines()[-1]
    assert line.startswith("hymba-1.5b-smoke: prefill=")
    assert "decode 3 steps=" in line and line.endswith("tok/s)")


@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_serve_cli_runs_new_families_on_cpu(arch):
    out = _serve_cli("--device", "cpu", arch=arch)
    assert out.returncode == 0, out.stderr[-2000:]
    line = out.stdout.strip().splitlines()[-1]
    assert line.startswith(f"{arch}-smoke: prefill=")
    assert "decode 3 steps=" in line and line.endswith("tok/s)")


def test_serve_cli_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    out = _serve_cli()
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr
