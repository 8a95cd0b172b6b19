"""Batched serving launcher: prefill a batch of prompts, then greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
        [--smoke] --batch 4 --prompt-len 64 --gen 32 [--device cpu] \\
        [--model-axis MA] [--devices cpu,cpu | cuda:0,cuda:1,...]

Port of ``repro/launch/serve.py`` for every LM family.  It runs on
``cuda`` (decoder prefill self-attention on the hand-written flash kernel)
and raises without a card unless ``--device cpu`` is given.  Parameters are
random, from a seeded ``torch.Generator``; the inputs are the reference's
draws (numpy seed 0): the prompts, then an encoder-decoder's source frames
or the VLM's embeddings (B, P, D), with broadcast 0..P-1 m-rope streams
and (B, 3, 1) streams at P + t in decode.

Over more than one device the launcher serves on a (data, model) mesh as
the reference does: ``ma = --model-axis or n``, mesh (n // ma, ma), the
reference's sharding policy, and every parameter placed by it
(``models/parallel.py``); with one device, no policy.  The devices are the
visible cards when ``--model-axis`` is given without ``--devices``, or the
explicit list, whose entries may repeat (logical ranks: ``--devices
cpu,cpu`` on the CPU, ``cuda:0,cuda:0`` on one card).
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.core.allpairs import resolve_device
from repro_torch.launch.mesh import make_mesh, visible_devices
from repro_torch.models import steps
from repro_torch.models.config import ModelConfig
from repro_torch.models.parallel import ShardedLM
from repro_torch.models.registry import build_model
from repro_torch.models.sharding import make_policy


def _sync(devs) -> None:
    for dev in dict.fromkeys(devs):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def serve(cfg: ModelConfig, *, batch: int = 4, prompt_len: int = 64,
          gen: int = 32, device=None, params=None, seed: int = 0,
          devices=None, model_axis: int = 0) -> dict:
    """Prefill `batch` prompts of `prompt_len` tokens (or embeddings, or
    source frames and target tokens), then decode `gen` - 1 greedy steps.
    `params` defaults to a model drawn from ``torch.Generator`` seed `seed`
    on the device.  With `devices` (more than one; they may repeat) the
    run is on the reference launcher's mesh, (n // ma, ma) over ("data",
    "model") with ma = `model_axis` or n, under the reference's policy,
    `params` placed by it (drawn on the first rank's device by default,
    the same numbers as on one device); `params` already placed (a
    ``ShardedLM``) run on their own mesh and policy.  Returns the times
    (host clock to synchronised cards), the tokens (batch, gen), the first
    step's logits (on the first rank's device) and the policy (None on one
    device)."""
    policy = None
    if isinstance(params, ShardedLM):
        policy = params.policy
    elif devices is not None and len(devices) > 1:
        n = len(devices)
        ma = model_axis or n     # the reference launcher's mesh
        if ma <= 0 or n % ma:
            raise ValueError(f"a model axis of {ma} does not divide {n} "
                             f"devices")
        policy = make_policy(cfg, make_mesh((n // ma, ma), ("data", "model"),
                                            devices=devices))
    if policy is not None:
        dev, ranks = policy.mesh.ranks[0], policy.mesh.ranks
    else:
        dev = resolve_device(devices[0] if devices else device)
        ranks = (dev,)
    model = build_model(cfg)
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(seed),
                            device=dev,
                            mesh=None if policy is None else policy.mesh)
    cap = prompt_len + gen
    prefill = steps.make_prefill_step(cfg, cache_capacity=cap, policy=policy)
    decode = steps.make_decode_step(cfg, policy=policy)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (batch, prompt_len), dtype=np.int32)).long().to(dev)
    dt = cfg.activation_dtype()
    kw = {"tokens": prompts}
    if cfg.enc_dec or cfg.embed_inputs:
        frames = torch.from_numpy(rng.standard_normal(
            (batch, prompt_len, cfg.d_model))).to(dt).to(dev)
        if cfg.enc_dec:
            kw["src"] = frames
        else:
            kw = {"embeds": frames}
            if cfg.rope == "mrope":
                kw["positions"] = torch.arange(
                    prompt_len, dtype=torch.int32, device=dev).expand(
                        batch, 3, prompt_len)

    _sync(ranks)
    t0 = time.perf_counter()
    logits, cache = prefill(params, **kw)
    _sync(ranks)
    t_pre = time.perf_counter() - t0

    first = logits
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    out = [tok]
    t0 = time.perf_counter()
    for t in range(gen - 1):
        dkw = {}
        if cfg.rope == "mrope":
            dkw["positions"] = torch.full((batch, 3, 1), prompt_len + t,
                                          dtype=torch.int32, device=dev)
        logits, cache = decode(params, token=tok, cache=cache,
                               cache_index=prompt_len + t, **dkw)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        out.append(tok)
    _sync(ranks)
    t_dec = time.perf_counter() - t0
    return {"arch": cfg.arch, "batch": batch, "prompt_len": prompt_len,
            "gen": gen, "prefill_s": t_pre, "decode_s": t_dec,
            "tok_s": batch * (gen - 1) / t_dec if t_dec > 0 else float("inf"),
            "tokens": torch.cat(out, dim=1), "first_logits": first,
            "policy": policy}


def summary(res: dict) -> str:
    """The reference launcher's line."""
    return (f"{res['arch']}: prefill={res['prefill_s'] * 1e3:.0f}ms "
            f"decode {res['gen'] - 1} steps={res['decode_s'] * 1e3:.0f}ms "
            f"({res['tok_s']:.0f} tok/s)")


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--model-axis", type=int, default=0,
                    help="the mesh's model axis (default: every device)")
    ap.add_argument("--devices", default=None,
                    help="comma-separated mesh devices, which may repeat "
                         "(cpu,cpu; cuda:0,cuda:1); default with "
                         "--model-axis: the visible cards")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch, smoke=args.smoke)
    devices = args.devices.split(",") if args.devices else None
    if devices is None and args.model_axis:
        if args.device != "cuda":
            ap.error("--model-axis without --devices takes the visible "
                     "cards; a mesh of CPU ranks is --devices cpu,cpu")
        devices = visible_devices()
    res = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                gen=args.gen, device=args.device, devices=devices,
                model_axis=args.model_axis)
    print(summary(res))


if __name__ == "__main__":
    main()
