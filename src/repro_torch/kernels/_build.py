"""Build the CUDA kernels with nvcc at first use and bind them with ctypes.

Each source under ``csrc/`` compiles to its own shared library with a plain
C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o <lib>.so csrc/<name>.cu

Libraries land in ``kernels/_build/`` (ignored by git), named by a hash of
the source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source rebuilds and an unchanged one loads from disk.  :func:`build_all` starts one nvcc per source, all at once.
Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE / "_build"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# the EpilogueSpec arguments: has_div, recip, has_clip, lo, hi
_EPI = [_I, _F, _I, _F, _F]
# operand dtype suffixes of the entry points (kernels/pcc_tile.py
# OPERAND_DTYPES): the SIMT tile kernel takes float32, the tensor-core one
# bfloat16, float16, float8_e4m3fn, float8_e5m2 and int8; the top-k select
# float32, bfloat16, float16 and int8
_SIMT_SUFFIXES = ("f32",)
_SM90_SUFFIXES = ("bf16", "f16", "e4m3", "e5m2", "i8")
_SELECT_SUFFIXES = ("f32", "bf16", "f16", "i8")
# (u, v, srow, scol, out, j_start, pass_tiles, m, grid_cols, t, l_pad,
#  replicas, v_rstride, s_rstride, *epilogue, stream) -> cudaError_t
_TILES = (_I, [_P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _I, _LL, _LL,
               *_EPI, _P])
# (u, v, prv, prc, pcv, pcc, j_start, dev_hi, pass_tiles, m, grid_cols, t,
#  l_pad, kk, n_cols_valid, symmetric, *epilogue, stream) -> cudaError_t
_SELECT = (_I, [_P, _P, _P, _P, _P, _P, _LL, _LL, _I, _I, _I, _I, _I, _I,
                _I, _I, *_EPI, _P])
# (q, k, v, out, B, H, Hkv, S, D, has_window, window, scale, stream)
#  -> cudaError_t
_FLASH = (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P])
# source name -> {C function: (restype, argtypes)}
SIGNATURES = {
    "pcc_tile": {
        **{f"pcc_tiles_{s}": _TILES for s in _SIMT_SUFFIXES},
        "pcc_tile_error_string": (ctypes.c_char_p, [_I]),
    },
    "pcc_tile_sm90": {
        **{f"pcc_tiles_sm90_{s}": _TILES for s in _SM90_SUFFIXES},
        "pcc_tile_sm90_error_string": (ctypes.c_char_p, [_I]),
    },
    "pcc_topk": {
        **{f"pcc_topk_select_{s}": _SELECT for s in _SELECT_SUFFIXES},
        # (prv, prc, pcv, pcc, rv, rc, cv, cc, j_start, hi_eff, m,
        #  grid_cols, t, kk, stream) -> cudaError_t
        "pcc_topk_merge": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _LL, _LL,
                                _I, _I, _I, _I, _P]),
        "pcc_topk_error_string": (ctypes.c_char_p, [_I]),
    },
    "flash_attention": {
        "flash_attention_f32": _FLASH,
        "flash_attention_error_string": (ctypes.c_char_p, [_I]),
    },
    "flash_attention_sm90": {
        **{f"flash_attention_sm90_{s}": _FLASH for s in ("bf16", "f16")},
        "flash_attention_sm90_error_string": (ctypes.c_char_p, [_I]),
    },
    "kendall_merge": {
        # (order, runs, longest, ties_r, scale_r, codes, ties_c, scale_c,
        #  out, j_start, pass_tiles, m, grid_cols, t, l, ld, tau_b, wide,
        #  symmetric, *epilogue, stream) -> cudaError_t
        "kendall_merge_tiles_launch": (_I, [_P] * 9 + [_LL] + [_I] * 9
                                       + [*_EPI, _P]),
        # (l, t, wide, int out[8]) -> cudaError_t
        "kendall_merge_occupancy": (_I, [_I, _I, _I, _P]),
        # (int out[3 * cap], cap) -> the number of instantiations
        "kendall_merge_instantiations": (_I, [_P, _I]),
        "kendall_merge_error_string": (ctypes.c_char_p, [_I]),
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or /usr/local/cuda/bin)")


def _paths(name: str):
    src = _HERE / "csrc" / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes() + " ".join(FLAGS).encode())
    for header in sorted((_HERE / "csrc").glob("*.cuh")):
        key.update(header.read_bytes())
    stem = BUILD_DIR / f"{name}_{key.hexdigest()[:16]}"
    return src, stem.with_suffix(".so"), stem.with_suffix(".log")


def _start(name: str):
    """Start nvcc for `name` unless its library is built; returns the
    process (or None) and the paths."""
    src, so, log = _paths(name)
    if so.exists():
        return None, so, log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp.so")
    proc = subprocess.Popen([_nvcc(), *FLAGS, "-o", str(tmp), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return (proc, tmp), so, log


def _finish(name: str, started, so: Path, log: Path) -> None:
    proc, tmp = started
    out, _ = proc.communicate()
    log.write_text(out)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name} "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, so)


def build_all(names: List[str] = None) -> Dict[str, str]:
    """Build every (or the named) kernel library, one nvcc per source, all
    started together.  Returns {name: nvcc output}."""
    names = list(SIGNATURES) if names is None else names
    started = {name: _start(name) for name in names}
    try:
        for name, (proc, so, log) in started.items():
            if proc is not None:
                _finish(name, proc, so, log)
    finally:
        for proc, _so, _log in started.values():
            if proc is not None and proc[0].poll() is None:
                proc[0].kill()
                proc[0].wait()
    return {name: log.read_text() if log.exists() else ""
            for name, (_p, _so, log) in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The bound library of kernel source `name`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            _src, so, _log = _paths(name)
            lib = ctypes.CDLL(str(so))
            for fn, (restype, argtypes) in SIGNATURES[name].items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _libs[name] = lib
        return lib


__all__ = ["BUILD_DIR", "FLAGS", "SIGNATURES", "build_all", "load"]
