"""Sequence-mode KV caches over a model axis (``kv_cache_shard="sequence"``)
against the reference's unsharded serve.

nemotron-4-340b and qwen2-vl-72b FULL set the mode, with 8 KV heads
below the production model axis of 16, so splitting their caches by
heads is impossible.  Here their float32 SMOKE configs (and mixtral's,
whose sliding window makes the cache a ring) take the mode by
``dataclasses.replace`` and run over meshes of CPU ranks (1, 2), (1, 4)
and (2, 2): SMOKE's 2 KV heads do not split over 4 ranks, so (1, 4) is
the case heads mode cannot place.  The caches hold CAP = 56 slots (a
multiple of 4, so that every mesh splits them; mixtral's ring is its
window of 32); the prompt is tests/_lm_parity.py's 48 tokens (the VLM's
embeddings and broadcast m-rope streams) and 4 decode steps are fed the
reference's greedy tokens.

Held: every logit within 1e-5 of the reference's largest |logit| and the
greedy tokens equal (the reference runs its own cache of 54 slots, which
masks the slots a token has not reached, so its logits do not depend on
the capacity); each rank holds 1 / tp of the slots and every KV head;
``ShardedCache.assemble`` is the port's one-device cache within 1e-5 after
the prefill and after the last step.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from _lm_parity import (PROMPT, TOL_F32, configs, inputs, port_inputs,
                        reference_run, within)
from repro_torch.convert import lm_params_from_reference
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import steps
from repro_torch.models.parallel import Placement
from repro_torch.models.sharding import make_policy

SEQ = (("kv_cache_shard", "sequence"),)
CAP = 56
DECODE = 4
ARCHS = ["nemotron-4-340b", "qwen2-vl-72b", "mixtral-8x22b"]
MESHES = [(1, 2), (1, 4), (2, 2)]


def _check(want, got, what):
    err, ok = within(want, got, rel=TOL_F32)
    assert ok, f"{what}: max |got - want| = {err:.3e}"


@functools.lru_cache(maxsize=None)
def _run(arch, shape=None):
    """The port's run on the reference's parameters, on one CPU device
    (`shape` None) or a mesh of CPU ranks: the logits a step (the prefill
    first), the whole cache after the prefill and after the last step,
    and the last cache as the steps hold it."""
    _, cfg = configs(arch, None, None, SEQ)
    params, batch, ref = reference_run(arch, None, None, None, SEQ)
    _, dec_pos = inputs(cfg)
    mesh = pol = None
    if shape is not None:
        mesh = make_mesh(shape, ("data", "model"),
                         devices=["cpu"] * int(np.prod(shape)))
        pol = make_policy(cfg, mesh)
    model = lm_params_from_reference(cfg, params, device="cpu", mesh=mesh)
    prefill = steps.make_prefill_step(cfg, cache_capacity=CAP, policy=pol)
    decode = steps.make_decode_step(cfg, policy=pol)
    logits, cache = prefill(model, **port_inputs(cfg, batch))
    run = {"logits": [logits.float().numpy()], "whole": [_whole(cache)]}
    for t in range(DECODE):
        dkw = {} if dec_pos is None else \
            {"positions": torch.from_numpy(dec_pos(t))}
        tok = torch.tensor(ref[t]["next"], dtype=torch.long)
        logits, cache = decode(model, token=tok, cache=cache,
                               cache_index=PROMPT + t, **dkw)
        run["logits"].append(logits.float().numpy())
    run["whole"].append(_whole(cache))
    run["cache"] = cache
    return run


def _whole(cache):
    """A copy of the one-device cache structure (a mesh's assembled)."""
    if not isinstance(cache, list):
        cache = cache.assemble()
    return [{k: v.clone().numpy() for k, v in c.items()} for c in cache]


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sequence_caches_decode_as_the_reference(arch, shape):
    _, cfg = configs(arch, None, None, SEQ)
    ref = reference_run(arch, None, None, None, SEQ)[2]
    one, mesh = _run(arch), _run(arch, shape)
    tp = shape[1]
    cache = mesh["cache"]
    assert cache.by_positions(0)
    for rank in cache.ranks:
        k = rank[0]["k"]
        assert k.shape[2] == cfg.n_kv_heads
        assert k.shape[3] * tp == one["whole"][0][0]["k"].shape[3]
    for t, (want, got) in enumerate(zip(ref, mesh["logits"])):
        what = "prefill" if t == 0 else f"decode step {t}"
        _check(want["logits"], got, f"{what} logits")
        np.testing.assert_array_equal(got[:, -1].argmax(-1),
                                      want["next"][:, 0])
    for c1, cm, what in zip(one["whole"], mesh["whole"],
                            ("prefill", "last step")):
        for i, (a, b) in enumerate(zip(c1, cm)):
            assert sorted(a) == sorted(b)
            for name in a:
                _check(a[name], b[name], f"{what} cache run {i} {name}")


def test_heads_mode_cannot_split_what_sequence_mode_does():
    """At (1, 4) SMOKE's 2 KV heads stay whole on every rank in heads mode;
    in sequence mode each rank holds a quarter of the slots."""
    _, cfg = configs("nemotron-4-340b")
    mesh = make_mesh((1, 4), ("data", "model"), devices=["cpu"] * 4)
    meta = steps.init_cache(cfg, 2, CAP, device="meta")
    heads = Placement(cfg, make_policy(cfg, mesh)).new_caches(meta)
    seq_cfg = dataclasses.replace(cfg, kv_cache_shard="sequence")
    seq = Placement(seq_cfg, make_policy(seq_cfg, mesh)).new_caches(meta)
    assert not heads.by_positions(0) and seq.by_positions(0)
    assert tuple(heads.ranks[0][0]["k"].shape) == (2, 2, 2, CAP, 32)
    assert tuple(seq.ranks[0][0]["k"].shape) == (2, 2, 2, CAP // 4, 32)
