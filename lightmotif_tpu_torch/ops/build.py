"""Build and load the hand-written CUDA kernels.

At first use, every ``csrc/*.cu`` source is compiled with ``nvcc`` for
Hopper (``sm_90a``) into one shared library with a plain C interface,
which is loaded with :mod:`ctypes`.  The library's file name carries a
hash of the sources and flags, so a changed source is rebuilt and an
unchanged one is loaded as it is.  The build directory is ``_build/``
beside this file.

Nothing here runs at import time: the CPU tests import every module,
and there is no ``nvcc`` where they run.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["library", "build_info"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

#: ``name: (argtypes, restype)`` of every exported C function.
_SIGNATURES = {
    "lm_score_tile": ([], ctypes.c_int),
    "lm_score_f32": (
        [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p],
        ctypes.c_int),
    "lm_score_u8": (
        [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p],
        ctypes.c_int),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


@functools.cache
def build_info() -> dict:
    """Compile the kernels if needed; return ``path``, ``seconds`` (0.0
    when an up-to-date library was found) and the compiler's ``log``."""
    sources = _sources()
    lib_path = BUILD_DIR / f"liblmkernels-{_digest(sources)}.so"
    log_path = lib_path.with_suffix(".log")
    if lib_path.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return {"path": lib_path, "seconds": 0.0, "log": log}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: concurrent processes never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)
    log = proc.stdout + proc.stderr
    log_path.write_text(log)
    return {"path": lib_path, "seconds": seconds, "log": log}


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, with every function's signature set."""
    lib = ctypes.CDLL(str(build_info()["path"]))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib
