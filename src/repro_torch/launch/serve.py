"""Batched serving launcher: prefill a batch of prompts, then greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \\
        [--smoke] --batch 4 --prompt-len 64 --gen 32 [--device cpu]

Port of ``repro/launch/serve.py`` for every LM family.  It runs on
``cuda`` (decoder prefill self-attention on the hand-written flash kernel)
and raises without a card unless ``--device cpu`` is given.  Parameters are
random, from a seeded ``torch.Generator``; the inputs are the reference's
draws (numpy seed 0): the prompts, then an encoder-decoder's source frames
or the VLM's embeddings (B, P, D), with broadcast 0..P-1 m-rope streams
and (B, 3, 1) streams at P + t in decode.  The sharded path
(``--model-axis``) is ROADMAP A part 5: ``models/sharding.py`` computes
its specs, and nothing executes them yet.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.core.allpairs import resolve_device
from repro_torch.models import steps
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import build_model


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(cfg: ModelConfig, *, batch: int = 4, prompt_len: int = 64,
          gen: int = 32, device=None, params=None, seed: int = 0) -> dict:
    """Prefill `batch` prompts of `prompt_len` tokens (or embeddings, or
    source frames and target tokens), then decode `gen` - 1 greedy steps.
    `params` defaults to a model drawn from ``torch.Generator`` seed `seed`
    on the device.  Returns the times (host
    clock to a synchronised card), the tokens (batch, gen) and the first
    step's logits."""
    dev = resolve_device(device)
    model = build_model(cfg)
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(seed),
                            device=dev)
    cap = prompt_len + gen
    prefill = steps.make_prefill_step(cfg, cache_capacity=cap)
    decode = steps.make_decode_step(cfg)
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

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, **kw)
    _sync(dev)
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
    _sync(dev)
    t_dec = time.perf_counter() - t0
    return {"arch": cfg.arch, "batch": batch, "prompt_len": prompt_len,
            "gen": gen, "prefill_s": t_pre, "decode_s": t_dec,
            "tok_s": batch * (gen - 1) / t_dec if t_dec > 0 else float("inf"),
            "tokens": torch.cat(out, dim=1), "first_logits": first}


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
    args = ap.parse_args(argv)
    cfg = get_config(args.arch, smoke=args.smoke)
    res = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                gen=args.gen, device=args.device)
    print(summary(res))


if __name__ == "__main__":
    main()
