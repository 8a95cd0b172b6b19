"""Assignments dropped by layer in qwen3-moe-30b-a3b at full width, the
reference against the port, on the same parameters and tokens, on the CPU.

chip_smoke.py's phase 27 reads how many routed assignments the port's
prefill drops at the config's own capacity factor, layer by layer.  This
run shows whether the reference drops as many at the same layers.  It
takes the first --layers layers of the FULL config (the down projections
scaled as for a model of --scale-layers layers, the depth the card runs),
draws each layer with the reference's init_block and carries the arrays
into the port's Block as they are, and embeds one row of --tokens tokens
(numpy seed 2) with the reference's embedding draw.  Each side runs its
own forward, layer by layer: the reference's block_apply (JAX, eager) and
the port's.  For each layer and each activation dtype it prints the share
of assignments each side drops, the tokens whose chosen experts differ,
and the largest difference of the two sides' hidden states relative to
the reference's largest |value|.

Run from the repository root (one layer's parameters at a time, 2.5 GB in
float32, held once by JAX and once by numpy; about 8 GB at the peak):

    PYTHONPATH=src python tests/moe_drop_witness.py [--layers 4]
        [--tokens 512] [--out drops.json]
"""

import argparse
import dataclasses
import json
import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from _lm_parity import reference_routing  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch.configs import get_config, override  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ARCH = "qwen3-moe-30b-a3b"
DTYPES = ("float32", "bfloat16")


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--scale-layers", type=int, default=24)
    ap.add_argument("--tokens", type=int, default=512)
    ap.add_argument("--out", default=None, help="write the rows as JSON")
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
    rcfg = {dt: dataclasses.replace(ref_get_config(ARCH),
                                    n_layers=args.scale_layers, dtype=dt)
            for dt in DTYPES}
    cfg = {dt: override(get_config(ARCH), n_layers=args.scale_layers,
                        dtype=dt) for dt in DTYPES}
    keys = jax.random.split(jax.random.PRNGKey(0), args.layers + 1)
    toks = np.random.default_rng(2).integers(0, rcfg["float32"].vocab,
                                             (1, args.tokens))
    emb = np.array(RL.dense_init(keys[-1], (rcfg["float32"].vocab,
                                              rcfg["float32"].d_model))
                     [jnp.asarray(toks)])
    h_ref = {dt: jnp.asarray(emb).astype(rcfg[dt].activation_dtype())
             for dt in DTYPES}
    h_port = {dt: torch.from_numpy(emb).to(cfg[dt].activation_dtype())
              for dt in DTYPES}
    positions = RL.default_positions(1, args.tokens)
    ref_moe, port_route = RL.moe_apply, L.moe_route
    seen = {}

    def ref_spy(c, p, x):
        seen["ref"] = np.asarray(x.astype(jnp.float32))
        return ref_moe(c, p, x)

    def port_spy(c, router, x, cap):
        out = port_route(c, router, x, cap)
        seen["port"] = out
        return out

    rows = []
    print(f"{ARCH} FULL width, layers 0..{args.layers - 1} (w2 scaled for "
          f"{args.scale_layers}), {args.tokens} tokens, capacity factor "
          f"{cfg['float32'].capacity_factor:g} (capacity "
          f"{L.moe_capacity(cfg['float32'], args.tokens)}), "
          f"{cfg['float32'].moe_impl}")
    for i in range(args.layers):
        p = jax.tree.map(np.asarray,
                         RT.init_block(keys[i], rcfg["float32"]))
        p_jax = jax.tree.map(jnp.asarray, p)
        blk = T.Block(_tensors(p))
        del p
        window = cfg["float32"].layer_windows()[i]
        for dt in DTYPES:
            with mock.patch.object(RL, "moe_apply", ref_spy):
                h_ref[dt] = RT.block_apply(rcfg[dt], p_jax, h_ref[dt],
                                           positions, window)[0]
            with mock.patch.object(L, "moe_route", port_spy), \
                    torch.no_grad():
                h_port[dt] = T.block_apply(cfg[dt], blk, h_port[dt], None,
                                           window)[0]
            moe_p = {n: np.asarray(v) for n, v in p_jax["moe"].items()}
            _, keep, top = reference_routing(rcfg[dt], moe_p, seen["ref"])
            got = seen["port"]
            k = cfg[dt].top_k
            differ = int((got[5].numpy().reshape(-1, k)
                          != top.reshape(-1, k)).any(-1).sum())
            a = np.asarray(h_ref[dt].astype(jnp.float32))
            b = h_port[dt].float().numpy()
            row = {"layer": i, "dtype": dt,
                   "dropped_reference": float(1 - keep.mean()),
                   "dropped_port": float(1 - got[3].float().mean()),
                   "tokens_routed_otherwise": differ,
                   "hidden_rel_diff": float(np.abs(a - b).max()
                                            / np.abs(a).max())}
            rows.append(row)
            print(f"  layer {i} {dt:8s}: dropped reference "
                  f"{row['dropped_reference']:.4f}, port "
                  f"{row['dropped_port']:.4f}; tokens routed otherwise "
                  f"{differ} of {args.tokens}; hidden max|ref - port| / "
                  f"max|ref| {row['hidden_rel_diff']:.3e}", flush=True)
        del p_jax, blk, moe_p
    if args.out:
        Path(args.out).write_text(json.dumps(
            {"arch": ARCH, "layers": args.layers, "tokens": args.tokens,
             "scale_layers": args.scale_layers, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
