"""Synthetic LM token pipeline: deterministic, resumable, shardable.

Copy of ``repro/data/synthetic.py`` (numpy only, so every batch is the
reference's, bit for bit, for the same (seed, step, host_slice)).
Batches are a pure function of (seed, step), so:
  * resume-after-failure regenerates the exact stream from the checkpoint's
    step cursor (no data-loader state to persist);
  * each data-parallel rank slices its own rows without coordination.

The token distribution is a Zipfian unigram mixed with short repeated
motifs, so cross-entropy has learnable structure for the loss-goes-down
tests (a pure-uniform stream would pin loss at log V).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenStreamSpec:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    motif_len: int = 8
    motif_prob: float = 0.5


def _zipf_probs(vocab: int, a: float) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-a)
    return p / p.sum()


def batch_at(spec: TokenStreamSpec, step: int,
             host_slice: Optional[slice] = None) -> dict:
    """Deterministic batch for a step.  Returns {'tokens', 'labels'}."""
    rng = np.random.default_rng((spec.seed, step))
    b, s = spec.global_batch, spec.seq_len
    probs = _zipf_probs(spec.vocab, spec.zipf_a)
    toks = rng.choice(spec.vocab, size=(b, s + 1), p=probs).astype(np.int32)
    # plant repeated motifs: predictable continuations
    n_motifs = int(spec.motif_prob * b)
    if n_motifs and s + 1 >= 2 * spec.motif_len:
        motif = rng.choice(spec.vocab, size=(n_motifs, spec.motif_len),
                           p=probs).astype(np.int32)
        for rep in range((s + 1) // spec.motif_len):
            lo = rep * spec.motif_len
            toks[:n_motifs, lo:lo + spec.motif_len] = motif
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if host_slice is not None:
        batch = {k: v[host_slice] for k, v in batch.items()}
    return batch


def stream(spec: TokenStreamSpec, start_step: int = 0) -> Iterator[dict]:
    step = start_step
    while True:
        yield batch_at(spec, step)
        step += 1


__all__ = ["TokenStreamSpec", "batch_at", "stream"]
