"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface (no PyTorch headers, so
a build takes seconds, not minutes).  The library's file name carries a
content hash of its source, the shared header and the flags, so an edit
rebuilds and an unchanged tree reuses the ``.so`` already in
``build/kernels/`` (``$REPRO_TORCH_BUILD_DIR`` overrides the directory).
:func:`build_all` starts one ``nvcc`` per source, all at once.

Nothing here runs at import: the CPU tests import every module of the
port on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).parent / "csrc"
SOURCES: Tuple[str, ...] = ("flash_attention", "decode_attention")
HEADERS: Tuple[str, ...] = ("common.cuh",)
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
#: ``-Xptxas -v`` output of each build this process ran (registers,
#: shared memory, spills per kernel), by source name
PTXAS_LOG: Dict[str, str] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR", "")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's kernels build from "
            "source on the machine with the card")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for part in (f"{name}.cu", *HEADERS):
        h.update(part.encode())
        h.update((CSRC / part).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> Tuple[Path, Path, subprocess.Popen]:
    out = _lib_path(name)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd: List[str] = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                      str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish(name: str, out: Path, tmp: Path, proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    PTXAS_LOG[name] = log
    os.replace(tmp, out)


def build_all() -> None:
    """Compile every source whose library is missing, one ``nvcc`` per
    source, all started together; then load them."""
    running = []
    for name in SOURCES:
        if name not in _LIBS and not _lib_path(name).exists():
            running.append((name, *_start(name)))
    for name, out, tmp, proc in running:
        _finish(name, out, tmp, proc)
    for name in SOURCES:
        library(name)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    out = _lib_path(name)
    if not out.exists():
        _finish(name, *_start(name))
    lib = ctypes.CDLL(str(out))
    _bind(name, lib)
    _LIBS[name] = lib
    return lib


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "flash_attention": {
        # q, k, v, out, B, S, H, K, D, causal, window, rows, block_kv,
        # scale, stream
        "flash_attention_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                _I, _I, _F, _P],
    },
    "decode_attention": {
        # q, k_pool, v_pool, tbl, cache_len, out, B, H, K, D, bl, nb,
        # window, tile, scale, stream
        "paged_decode_attention": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                   _I, _I, _I, _I, _F, _P],
        # q, k, v, cache_len, out, B, S, H, K, D, window, tile, scale,
        # stream
        "decode_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _I, _F, _P],
    },
}


def _bind(name: str, lib: ctypes.CDLL) -> None:
    for fn, argtypes in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
