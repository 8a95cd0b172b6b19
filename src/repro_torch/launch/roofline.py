"""Roofline analysis per (arch x shape) on the single-pod production mesh.

Counterpart of ``repro/launch/roofline.py``.  Three terms, all in seconds,
from the dry run's counts of a cell (``launch/dryrun.py``: the step run on
the meta device over 256 logical ranks, nothing allocated):

    compute    = FLOPs_per_device / PEAK_FLOPS
    memory     = bytes_per_device / HBM_BW
    collective = collective_bytes_per_device / LINK_BW

with the card's published peaks, each for an NVIDIA H100 80GB HBM3 SXM at
its 700 W limit (NVIDIA's H100 data sheet): PEAK_FLOPS = 989e12 (bf16
dense tensor-core FLOP/s), HBM_BW = 3.35e12 bytes/s, LINK_BW = 450e9
bytes/s (NVLink 4, one direction).  The collective term assumes every
collective stays inside one NVLink domain; a 256-rank mesh spans nodes,
whose NICs are slower (ROADMAP B).  These are predictions against
published peaks, not measurements.

Method, as the reference's: the analysis variant of a cell
(cfg.analysis_unroll=True, scan_layers=False, grad_accum=1, coarser
attention / SSM / logits chunks) is counted at two reduced depths L1 = 2 <
L2 = 4 and fit to cost(L) = a + b L (layers are identical, so the counts
are affine in L; hymba's three global layers sit in the intercept, with
L1, L2 raised to 4, 8), then evaluated at the full depth.  The port
unrolls nothing (its layers are a Python loop), but a meta run costs time
per rank per op, so the fit keeps a full-depth 256-rank run out of every
cell; ``--validate`` checks it against a direct full-depth count.

MODEL_FLOPS is 6 N_active D (train) / 2 N_active D (inference); the ratio
MODEL_FLOPS / counted FLOPs exposes remat recompute, attention and
dispatch overheads.
"""

import argparse
import dataclasses
import json
import os
import time
from typing import Callable, Optional

from repro_torch.configs import get_config, list_archs
from repro_torch.launch import dryrun
from repro_torch.models.config import SHAPES

# NVIDIA H100 80GB HBM3 SXM, 700 W, NVIDIA data sheet
PEAK_FLOPS = 989e12      # bf16 dense tensor-core FLOP/s per card
HBM_BW = 3.35e12         # bytes/s per card
LINK_BW = 450e9          # bytes/s per card, NVLink 4, one direction

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "experiments", "torch", "roofline")


def _analysis_transform(n_layers: Optional[int]) -> Callable:
    def tf(cfg):
        kw = dict(analysis_unroll=True, scan_layers=False, grad_accum=1)
        # Coarser chunking for the analysis count: matmul FLOP totals are
        # chunk-size invariant (attention sees full K per chunk; the SSM
        # scan changes only by its log(Q) factor), and 4x fewer chunk
        # bodies keep a 256-rank meta run short.
        if cfg.attn_chunk:
            kw["attn_chunk"] = min(cfg.attn_chunk * 4, 8192)
        if cfg.ssm_chunk:
            kw["ssm_chunk"] = min(cfg.ssm_chunk * 4, 2048)
        if cfg.logits_chunk:
            kw["logits_chunk"] = min(cfg.logits_chunk * 4, 4096)
        if n_layers is not None:
            kw["n_layers"] = n_layers
            if cfg.enc_dec:
                kw["n_enc_layers"] = n_layers
            if cfg.global_layers:
                kw["global_layers"] = tuple(sorted(
                    {0, n_layers // 2, n_layers - 1}))
        return dataclasses.replace(cfg, **kw)
    return tf


def _fit(l1: int, v1: float, l2: int, v2: float, l_full: int) -> float:
    b = (v2 - v1) / (l2 - l1)
    a = v1 - b * l1
    return a + b * l_full


def analyze_cell(arch: str, shape: str, *, l1: int = 2, l2: int = 4,
                 direct: bool = False, save: bool = True,
                 cfg_extra: Optional[Callable] = None,
                 tag: str = "") -> dict:
    """Roofline record for one cell (single-pod mesh)."""
    cfg = get_config(arch)
    if cfg_extra is not None:
        base_tf = _analysis_transform

        # compose: cfg_extra applies on top of the analysis transform
        def _analysis_transform_wrapped(n):
            tf = base_tf(n)
            return lambda c: cfg_extra(tf(c))
        transform_factory = _analysis_transform_wrapped
    else:
        transform_factory = _analysis_transform

    def count_at(n_layers):
        fn, args, kwargs, info = dryrun.build_cell(
            arch, shape, multi_pod=False,
            cfg_transform=transform_factory(n_layers))
        t0 = time.time()
        m = dryrun.measure(fn, args, kwargs)
        dt = time.time() - t0
        stats = m["stats"]
        return {
            "flops": float(m["flops"]),
            "bytes": float(m["bytes"]),
            "coll_bytes": float(stats.total_bytes),
            "coll_by_kind": dict(stats.bytes_by_kind),
            "coll_count": stats.total_count,
            "redundant": stats.redundant[:10],
            "compile_s": round(dt, 1),
            "info": info,
        }

    l_full = cfg.n_layers
    if cfg.global_layers:          # keep >= 3 globals representable
        l1, l2 = max(l1, 4), max(l2, 8)
    if direct or l_full <= l2:
        m = count_at(None)
        flops, nbytes, coll = m["flops"], m["bytes"], m["coll_bytes"]
        coll_kind = m["coll_by_kind"]
        method = "direct-unroll"
        fits = [m]
    else:
        m1 = count_at(l1)
        m2 = count_at(l2)
        flops = _fit(l1, m1["flops"], l2, m2["flops"], l_full)
        nbytes = _fit(l1, m1["bytes"], l2, m2["bytes"], l_full)
        coll = _fit(l1, m1["coll_bytes"], l2, m2["coll_bytes"], l_full)
        kinds = set(m1["coll_by_kind"]) | set(m2["coll_by_kind"])
        coll_kind = {k: _fit(l1, m1["coll_by_kind"].get(k, 0),
                             l2, m2["coll_by_kind"].get(k, 0), l_full)
                     for k in kinds}
        method = f"affine-fit(L={l1},{l2})"
        m = m2
        fits = [m1, m2]

    info = m["info"]
    chips = info["chips"]
    seq, batch, kind = SHAPES[shape]
    tokens = seq * batch if kind != "decode" else batch
    # MODEL_FLOPS must use the FULL architecture's active params (the
    # analysis count may have run at reduced depth)
    from repro_torch.models.registry import build_model
    n_active = build_model(cfg).active_param_count()
    mf_per_tok = 6 * n_active if kind == "train" else 2 * n_active
    model_flops = mf_per_tok * tokens

    compute_t = flops / PEAK_FLOPS
    memory_t = nbytes / HBM_BW
    coll_t = coll / LINK_BW
    terms = {"compute_s": compute_t, "memory_s": memory_t,
             "collective_s": coll_t}
    bottleneck = max(terms, key=terms.get)
    useful_t = (model_flops / chips) / PEAK_FLOPS
    bound_t = max(compute_t, memory_t, coll_t)
    rec = {
        "label": f"{arch}__{shape}__pod1" + (f"__{tag}" if tag else ""),
        "arch": arch, "shape": shape, "kind": kind, "chips": chips,
        "method": method,
        "hlo_flops_per_chip": flops,
        "hlo_bytes_per_chip": nbytes,
        "coll_bytes_per_chip": coll,
        "coll_by_kind": coll_kind,
        "terms_s": terms,
        "bottleneck": bottleneck,
        "model_flops_global": model_flops,
        "model_flops_per_chip": model_flops / chips,
        "useful_fraction": useful_t / bound_t if bound_t else 0.0,
        "model_vs_hlo_flops": (model_flops / chips) / flops if flops else 0.0,
        "redundant_collectives": m["redundant"],
        "compiles": [{k: v for k, v in f.items() if k != "info"}
                     for f in fits],
    }
    if save:
        os.makedirs(RESULTS_DIR, exist_ok=True)
        with open(os.path.join(RESULTS_DIR, rec["label"] + ".json"),
                  "w") as f:
            json.dump(rec, f, indent=1)
    print(f"[roofline] {rec['label']}: {method} "
          f"compute={compute_t*1e3:.1f}ms memory={memory_t*1e3:.1f}ms "
          f"coll={coll_t*1e3:.1f}ms -> {bottleneck} "
          f"useful={rec['useful_fraction']:.2%}")
    return rec


def validate_fit(arch: str = "llama3.2-3b", shape: str = "train_4k") -> dict:
    """Cross-check the affine-fit method against a direct full-depth
    count."""
    fit = analyze_cell(arch, shape, save=False)
    direct = analyze_cell(arch, shape, direct=True, save=False)
    err = abs(fit["hlo_flops_per_chip"] - direct["hlo_flops_per_chip"]) / \
        direct["hlo_flops_per_chip"]
    print(f"[roofline] fit-vs-direct flops error: {err:.3%}")
    return {"fit": fit, "direct": direct, "rel_err": err}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--validate", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()

    if args.validate:
        validate_fit()
        return
    jobs = []
    if args.all:
        for arch in list_archs():
            for shape in get_config(arch).shapes:
                jobs.append((arch, shape))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all required")
        jobs = [(args.arch, args.shape)]
    os.makedirs(RESULTS_DIR, exist_ok=True)
    failures = []
    for arch, shape in jobs:
        path = os.path.join(RESULTS_DIR, f"{arch}__{shape}__pod1.json")
        if os.path.exists(path) and not args.force:
            print(f"[roofline] {arch}__{shape}: cached")
            continue
        try:
            analyze_cell(arch, shape)
        except Exception as e:
            import traceback
            traceback.print_exc()
            failures.append((arch, shape, repr(e)))
    if failures:
        for f in failures:
            print("FAILED:", f)
        raise SystemExit(1)


if __name__ == "__main__":
    main()
