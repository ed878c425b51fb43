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
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).parent / "csrc"
SOURCES: Tuple[str, ...] = ("flash_attention", "flash_attention_bwd",
                            "decode_attention", "decode_split", "ssd_scan",
                            "ssd_scan_bwd", "tiled_matmul")
HEADERS: Tuple[str, ...] = ("common.cuh", "hopper.cuh", "ssd_common.cuh",
                            "positions.cuh")
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


def sass(name: str) -> str:
    """``cuobjdump --dump-sass`` of the library of ``csrc/<name>.cu``
    (built on first use): the instructions the card runs, where the
    wgmma kernels show ``HGMMA`` and their TMA loads ``UTMALDG``."""
    library(name)
    tool = Path(_nvcc()).parent / "cuobjdump"
    return subprocess.run([str(tool), "--dump-sass", str(_lib_path(name))],
                          capture_output=True, text=True, check=True).stdout


def _demangle(mangled: str) -> str:
    """``ns::kernel<1, 2, true>`` from an Itanium-mangled kernel name with
    integer and bool template arguments (enough for the port's
    kernels)."""
    rest = mangled[3:] if mangled.startswith("_ZN") else mangled[2:]
    names = []
    while rest[:1].isdigit():
        n = re.match(r"\d+", rest).group(0)
        names.append(rest[len(n):len(n) + int(n)])
        rest = rest[len(n) + int(n):]
    args = re.match(r"I((?:L[ib]-?\d+E)+)E", rest)
    name = names[-1] if names else mangled
    if args is None:
        return name
    vals = [v if t == "i" else ("false", "true")[int(v)]
            for t, v in re.findall(r"L([ib])(-?\d+)E", args.group(1))]
    return f"{name}<{', '.join(vals)}>"


def ptxas_entries(log: str) -> List[Tuple[str, int, int]]:
    """``(kernel, registers, spill bytes)`` for each entry function of one
    build's ``-Xptxas -v`` log, the kernel with its template arguments
    (``flash_fwd_kernel<128, 128, 2>``)."""
    out = []
    entry, spills = "", 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry, spills = _demangle(m.group(1)), 0
            continue
        spills += sum(int(x) for x in re.findall(r"(\d+) bytes spill", line))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out.append((entry, int(m.group(1)), spills))
            entry = ""
    return out


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "flash_attention": {
        # q, k, v, out, lse, pos, ranges, B, Sq, Skv, q_off, H, K, D,
        # causal, window, rows, block_kv, scale, pad_fault, stream
        "flash_attention_fwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
        # q, k, v, B, S, H, K, D, rows, block_kv, iters -> us (double)
        "flash_attention_map_encode_us": [_P, _P, _P, _I, _I, _I, _I, _I,
                                          _I, _I, _I],
    },
    "flash_attention_bwd": {
        # q, k, v, o, dout, lse, delta, table, dq, dk, dv, pos, ranges, B,
        # Sq, Skv, q_off, H, K, D, causal, window, scale, drop_tile,
        # group_fault, stream
        "flash_attention_bwd": [_P] * 13 + [_I] * 9 + [_F, _I, _I, _P],
    },
    "decode_attention": {
        # q, k_pool, v_pool, tbl, cache_len, out, ws, counters, B, H, K,
        # D, bl, nb, window, splits, split_rows, scale, drop_split, stream
        "paged_decode_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                   _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
        # q, k, v, cache_len, out, ws, counters, B, S, H, K, D, window,
        # splits, split_rows, scale, drop_split, stream
        "decode_attention": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _I, _I, _I, _F, _I, _P],
        # q, k, v, pos, pout, ws, counters, B, S, H, K, D, kv_start,
        # window, splits, split_rows, scale, drop_split, stream
        "decode_partial": [_P] * 7 + [_I] * 9 + [_F, _I, _P],
        # q, k_pool, v_pool, tbl, pos, pout, ws, counters, B, H, K, D, bl,
        # nb, n_local, block_start, window, splits, split_rows, scale,
        # drop_split, stream
        "paged_decode_partial": [_P] * 8 + [_I] * 11 + [_F, _I, _P],
    },
    "decode_split": {
        # q, k, tbl, cache_len, s, B, H, K, DS, seq, nb, Wc, window,
        # scale, drop_chunk, stream
        "decode_split_scores": [_P] * 5 + [_I] * 8 + [_F, _I, _P],
        # s, v, tbl, cache_len, out, B, H, K, DS, seq, nb, Wc, window,
        # splits, rows, swap_entry, stream
        "decode_split_context": [_P] * 5 + [_I] * 11 + [_P],
    },
    "ssd_scan": {
        # x, dt, A, Bm, Cm, init, y, fin, states, ws, B, S, H, P, G, N,
        # chunk, heads_block, no_carry, stream
        "ssd_scan": [_P] * 10 + [_I] * 9 + [_P],
    },
    "ssd_scan_bwd": {
        # x, dt, A, Bm, Cm, y, states, fin, dy, dfin, dx, ddt, dA, dB, dC,
        # dinit, ws, B, S, H, P, G, N, chunk, no_carry, skip_tile, stream
        "ssd_scan_bwd": [_P] * 17 + [_I] * 9 + [_P],
    },
    "tiled_matmul": {
        # a, b, out, ws, M, K, N, bm, bk, bn, fp32, splits, stream
        "tiled_matmul": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
        # a, b, M, K, N, bm, bk, iters -> us (double)
        "tiled_matmul_map_encode_us": [_P, _P, _I, _I, _I, _I, _I, _I],
    },
}


def describe_error(err: int) -> str:
    """A kernel entry point's nonzero return: a cudaError_t, or a
    negative CUresult of ``cuTensorMapEncodeTiled`` (-999: the driver
    has no encoder)."""
    if err < 0:
        return f"CUresult {-err} from the tensor-map encoder"
    return f"cudaError {err}"


def _bind(name: str, lib: ctypes.CDLL) -> None:
    for fn, argtypes in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = (ctypes.c_double if fn.endswith("_map_encode_us")
                     else ctypes.c_int)
