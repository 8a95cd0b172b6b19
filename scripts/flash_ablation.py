#!/usr/bin/env python3
"""Where the float32 flash kernel's time goes, on one NVIDIA GPU.

    python3 scripts/flash_ablation.py          # from the repository root

Builds src/repro_torch/kernels/csrc/flash_attention.cu as it is and in
variants that each leave one part of the work out (text replaced in a
copy of the source, built beside the package's own libraries under
kernels/_build/ablation/), then times every build at the flash cases of
chip_smoke.py (llama-3.2-3B's heads at S = 4,096 and 32,768, hymba-1.5B's
window layers at S = 32,768), in the order A B .. B A, with CUDA events.
A variant's outputs are wrong by design; only the kernel as it is is
held against the plain version (within 1e-5).  The difference between
the kernel's time and a variant's is what the left-out part costs there:

    no-qk     the Q K^T FFMAs and their shared-memory reads
    no-pv     the P V FFMAs and their shared-memory reads
    no-copy   the K and V cp.async copies (the ring's barriers stay)
    no-soft   the softmax (masks, maxima, exponentials, the correction)

Prints the card's name and power limit, then one line per case and
build: ms (both runs), TFLOP/s and the share of the FP32 bound.
"""

from __future__ import annotations

import statistics
import sys

from ablation_common import ROOT, build, card, event_ms, run_with

FP32_FLOPS = 67e12   # H100 SXM, 700 W: the FP32 (SIMT) peak
TOL = 1e-5           # chip_smoke.py's TOL_ATTN
CASES = [  # name, B, H, Hkv, D, window, S (chip_smoke.py FLASH_CASES)
    ("llama-4k", 1, 24, 8, 128, None, 4_096),
    ("hymba-swa-32k", 1, 25, 5, 64, 1_024, 32_768),
    ("llama-32k", 1, 24, 8, 128, None, 32_768),
]
VARIANTS = {
    "as is": [],
    "no-qk": [("            s[i][j] = a;\n", "            (void)a;\n")],
    "no-pv": [("            acc[i][cc] = fmaf(p[i], vv[cc], acc[i][cc]);\n",
               "            ;\n")],
    "no-copy": [("    if (c >= nchunks) return;\n", "    return;\n")],
    "no-soft": [("    if (edge)\n      softmax_step<SR, true>",
                 "    for (int i = 0; i < SR; ++i) alpha[i] = 1.0f;\n"
                 "    if (false)\n      softmax_step<SR, true>"),
                ("    else\n      softmax_step<SR, false>",
                 "    else if (false)\n      softmax_step<SR, false>")],
}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import flash_attention as fmod

    torch.backends.cuda.matmul.allow_tf32 = False
    print(card())
    mods = build("flash_attention", "flash_attention", VARIANTS)

    order = list(mods) + list(reversed(mods))
    for case, b, h, hkv, d, w, s in CASES:
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn(shape, generator=g, device="cuda")
                   for shape in ((b, h, s, d), (b, hkv, s, d),
                                 (b, hkv, s, d)))
        pairs = b * h * (s * (s + 1) // 2 if w is None
                         else w * (w + 1) // 2 + (s - w) * w)
        flop = 4 * d * pairs

        def run():
            return fmod.flash_attention(q, k, v, window=w)
        want = fmod.flash_attention_plain(q, k, v, window=w,
                                          chunk=None if s <= 4_096 else 2_048)
        err = float((run_with(mods["as is"], run) - want).abs().max())
        if not err <= TOL:
            raise AssertionError(f"{case}: kernel disagrees with plain "
                                 f"({err:.3e})")
        del want
        times = {name: [] for name in mods}
        for name in order:
            times[name].append(run_with(mods[name], lambda: event_ms(
                run, 5 if s <= 4_096 else 2)))
        for name, ts in times.items():
            ms = statistics.mean(ts)
            print(f"{case} [{name}]: {ts[0]:.3f} / {ts[1]:.3f} ms, "
                  f"{flop / ms / 1e9:.1f} TFLOP/s, "
                  f"{100 * flop / FP32_FLOPS * 1e3 / ms:.1f} % of the FP32 "
                  f"bound" + (f"; max|kernel - plain| {err:.3e}"
                              if name == "as is" else ""))
        del q, k, v
    return 0


if __name__ == "__main__":
    sys.exit(main())
