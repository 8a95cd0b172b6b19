"""Batched serving demo with the PyTorch port: prefill a batch of prompts,
then decode with the per-run KV caches (ring buffers for SWA layers).

    PYTHONPATH=src python examples/torch_serve_lm.py [--arch hymba-1.5b]
        [--device cpu]

The counterpart of examples/serve_lm.py for ``repro_torch``, with its
defaults (the arch's smoke config).  Every arch of the registry serves:
``--arch qwen2-vl-72b`` prefills embeddings with broadcast m-rope streams,
``--arch seamless-m4t-medium`` encodes source frames and decodes target
tokens against the encoder's output.  ``--device`` defaults to ``cuda``
(decoder prefill self-attention on the hand-written flash kernel; the
encoder's attention and cross-attention on the plain route; it raises
without a card); ``--device cpu`` runs the plain versions.
"""

import argparse

from repro_torch.configs import get_config
from repro_torch.launch.serve import serve


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args()

    cfg = get_config(args.arch, smoke=args.smoke)
    res = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                gen=args.gen, device=args.device)
    gen = res["tokens"].cpu().numpy()
    print(f"arch={cfg.arch} batch={args.batch} "
          f"prefill({args.prompt_len} tok)={res['prefill_s'] * 1e3:.0f}ms "
          f"decode={res['decode_s'] * 1e3:.0f}ms ({res['tok_s']:.0f} tok/s)")
    print(f"sample continuation: {gen[0][:16].tolist()}")
    assert gen.shape == (args.batch, args.gen)
    print("OK")


if __name__ == "__main__":
    main()
