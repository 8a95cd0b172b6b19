"""What the ablation scripts (flash_, merge_ and kendall_ablation.py) share.

Each builds one CUDA source of src/repro_torch/kernels/csrc as it is and in
variants, a variant being that source with some of its text replaced, in
a copy built beside the package's own libraries under
kernels/_build/ablation/; every build's nvcc runs at once.  It then times
the builds in turns on one NVIDIA GPU with CUDA events, each build's
library swapped in for the package's own.  A variant names the exact text
it replaces: when the source no longer holds that text exactly once,
building the variant raises, and the variant is rewritten with the source.
"""

from __future__ import annotations

import importlib.util
import shutil
import statistics
import subprocess
from pathlib import Path
from typing import Callable, Dict, List, Tuple

ROOT = Path(__file__).resolve().parent.parent
KERNELS = ROOT / "src" / "repro_torch" / "kernels"

Subs = List[Tuple[str, str]]


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def load_path(name: str, path: Path):
    """The module at `path`, imported under `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def builder(source: str, name: str, subs: Subs):
    """The _build module of a copy of the kernels' sources with `subs`
    applied to csrc/<source>.cu; it builds into its own directory."""
    d = KERNELS / "_build" / "ablation" / f"{source}_{name.replace(' ', '_')}"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(KERNELS / "csrc", d / "csrc")
    cu = d / "csrc" / f"{source}.cu"
    src = cu.read_text()
    for old, new in subs:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the text to replace is not in "
                               f"{source}.cu once: {old!r}")
        src = src.replace(old, new)
    cu.write_text(src)
    shutil.copy(KERNELS / "_build.py", d / "_build.py")
    return load_path(f"ablation_{d.name}", d / "_build.py")


def build(source: str, library: str, variants: Dict[str, Subs]) -> dict:
    """{variant: its _build module}, every variant's `library` built, all
    nvcc processes started together."""
    mods = {name: builder(source, name, subs)
            for name, subs in variants.items()}
    started = {name: m._start(library) for name, m in mods.items()}
    for name, (proc, so, log) in started.items():
        if proc is not None:
            mods[name]._finish(library, proc, so, log)
    return mods


def run_with(mod, fn: Callable):
    """fn() with the package's libraries loaded by the _build module
    `mod` (a variant's); the package's wrappers look _build.load up at each
    call."""
    from repro_torch.kernels import _build
    saved = _build.load
    _build.load = mod.load
    try:
        return fn()
    finally:
        _build.load = saved


def event_ms(fn: Callable, reps: int, warm: bool = True) -> float:
    """Median CUDA-event ms of `reps` calls of fn, after one untimed call
    when `warm`."""
    import torch
    if warm:
        fn()
        torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)
