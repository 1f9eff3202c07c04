"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), under ``kernels/build/`` (listed in ``.gitignore``). The
library's file name carries a hash of its sources, so an edited kernel is
rebuilt and a stale one is never loaded. ``build_all`` starts one ``nvcc``
per source at once and waits for all of them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel, into the log
]
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# source -> its C functions: (return type, argument types)
SIGNATURES = {
    "packed_matmul": {
        "plora_packed_matmul_path": (_I, [_I] * 8),
        "plora_packed_matmul_workspace": (_LL, [_I] * 8),
        "plora_packed_matmul": (_I, [ctypes.c_char_p]),  # one block of 13 int64
        "plora_packed_lora_delta": (_I, [ctypes.c_char_p]),  # one block of 12 int64
    },
    "fused": {
        # the path; the workspace and the K ranges through the pointers
        "plora_fused_matmul_plan": (_I, [_I] * 10 + [ctypes.POINTER(_LL), ctypes.POINTER(_I)]),
        "plora_fused_matmul": (_I, [ctypes.c_char_p]),  # one block of 16 int64
    },
    "fused_q": {
        "plora_fused_matmul_q_plan": (_I, [_I] * 9 + [ctypes.POINTER(_LL), ctypes.POINTER(_I)]),
        "plora_fused_matmul_q": (_I, [ctypes.c_char_p]),  # one block of 18 int64
    },
}
SOURCES = tuple(SIGNATURES)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    h = hashlib.sha1()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str) -> "tuple[Path, subprocess.Popen | None, Path]":
    out = _lib_path(name)
    if out.exists():
        return out, None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out, proc, tmp


def build_all(names: Sequence[str] = SOURCES) -> List[Path]:
    """Compile every named source that is not built yet, all at once. The
    compiler's output is kept beside each library as ``<library>.log``."""
    started = [(_start(n), n) for n in names]
    paths = []
    for (out, proc, tmp), name in started:
        if proc is not None:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)  # atomic: a concurrent build sees the old file or the new
        paths.append(out)
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _libs:
            (path,) = build_all([name])
            lib = ctypes.CDLL(str(path))
            lib.plora_error_string.argtypes = [_I]
            lib.plora_error_string.restype = ctypes.c_char_p
            for fname, (restype, argtypes) in SIGNATURES[name].items():
                getattr(lib, fname).argtypes = argtypes
                getattr(lib, fname).restype = restype
            _libs[name] = lib
        return _libs[name]


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code (``cudaGetLastError``)."""
    if rc != 0:
        msg = lib.plora_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
