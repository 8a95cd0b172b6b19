"""Straggler detection & mitigation hooks.

Copy of ``repro/runtime/straggler.py`` (numpy only, no change of
semantics).  At pod scale the dominant non-failure slowdown is a slow host
(thermal throttling, ECC storms, a sick NIC).  Policy here:

1. every host contributes its last step wall-time (the train loop of one
   process feeds its own as a one-host report);
2. hosts slower than `threshold` x the rolling median for `patience`
   consecutive steps are flagged;
3. the mitigation callback decides: log, exclude-at-next-elastic-remesh
   (runtime/elastic.py), or abort-and-restore.

The detector is pure (state in/state out) so it is trivially testable and
checkpoint-able.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class StragglerState:
    ewma: Optional[np.ndarray] = None        # per-host smoothed step time
    strikes: Optional[np.ndarray] = None     # consecutive violations
    history: int = 0


@dataclasses.dataclass(frozen=True)
class StragglerConfig:
    threshold: float = 1.5      # x median
    patience: int = 3           # consecutive violating steps
    alpha: float = 0.3          # EWMA smoothing
    warmup_steps: int = 2       # ignore first steps (compile noise)


def update(cfg: StragglerConfig, state: StragglerState,
           step_times: Sequence[float]) -> Tuple[StragglerState, List[int]]:
    """Feed per-host step times; returns (new_state, flagged_host_ids)."""
    t = np.asarray(step_times, np.float64)
    if state.ewma is None:
        state = StragglerState(ewma=t.copy(),
                               strikes=np.zeros(len(t), np.int64), history=0)
    ewma = cfg.alpha * t + (1 - cfg.alpha) * state.ewma
    history = state.history + 1
    strikes = state.strikes.copy()
    flagged: List[int] = []
    if history > cfg.warmup_steps:
        med = float(np.median(ewma))
        viol = ewma > cfg.threshold * med
        strikes = np.where(viol, strikes + 1, 0)
        flagged = [int(i) for i in np.nonzero(strikes >= cfg.patience)[0]]
    return StragglerState(ewma=ewma, strikes=strikes, history=history), flagged


class StepTimer:
    """Wall-time tracker for the local host (feeds `update`)."""

    def __init__(self):
        self.times: List[float] = []

    def record(self, seconds: float) -> None:
        self.times.append(seconds)

    def last(self) -> float:
        return self.times[-1] if self.times else 0.0

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        t = np.asarray(self.times[1:] or self.times)  # drop compile step
        return {"mean_s": float(t.mean()), "p50_s": float(np.median(t)),
                "p95_s": float(np.percentile(t, 95)), "n": len(self.times)}


__all__ = ["StragglerConfig", "StragglerState", "update", "StepTimer"]
