"""Build and load the hand-written CUDA kernels.

At first use, each ``csrc/*.cu`` source is compiled with ``nvcc`` for
Hopper (``sm_90a``) into a shared library of its own with a plain C
interface, which is loaded with :mod:`ctypes`.  The sources compile in
parallel, one ``nvcc`` each, so a build takes as long as its slowest
source as sources are added (one ``nvcc`` over several sources
compiles them one after another).  A library's file name carries a hash of
its source and the flags, so a changed source is rebuilt and an
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
from types import SimpleNamespace

__all__ = ["library", "build_info"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_I64 = ctypes.c_longlong
_P = ctypes.c_void_p
_INT = ctypes.c_int

#: ``name: (argtypes, restype)`` of every exported C function.
_SIGNATURES = {
    "lm_score_tile": ([], _INT),
    "lm_score_f32": ([_P, _I64, _P, _INT, _INT, _I64, _P, _P], _INT),
    "lm_score_u8": ([_P, _I64, _P, _INT, _INT, _I64, _P, _P], _INT),
    "lm_prefilter_lanes": ([], _INT),
    "lm_prefilter_tile": ([], _INT),
    "lm_prefilter_row_bytes": ([], _INT),
    "lm_prefilter_any8": (
        [_P, _I64, _P, _P, _P, _INT, _INT, _INT, _P, _P], _INT),
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


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(src.name.encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"liblm-{src.stem}-{h.hexdigest()[:16]}.so"


@functools.cache
def build_info() -> dict:
    """Compile the kernels that are not up to date, all at once; return
    ``paths`` (one library per source), ``seconds`` (wall time of the
    build, 0.0 when every library was found) and the compilers' ``log``
    (``ptxas -v`` lines included)."""
    libs = {src: _lib_path(src) for src in _sources()}
    logs = {}
    todo = []
    for src, lib in libs.items():
        log = lib.with_suffix(".log")
        if lib.exists():
            logs[lib] = log.read_text() if log.exists() else ""
        else:
            todo.append(src)
    t0 = time.perf_counter()
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        jobs = []
        for src in todo:
            # compile to a private name, then rename: concurrent
            # processes never load a half-written library
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.append((src, tmp, proc))
        failed = []
        for src, tmp, proc in jobs:
            log = proc.communicate()[0]
            if proc.returncode != 0:
                os.unlink(tmp)
                failed.append(f"nvcc failed on {src.name} ({proc.returncode}):\n{log}")
                continue
            os.replace(tmp, libs[src])
            libs[src].with_suffix(".log").write_text(log)
            logs[libs[src]] = log
        if failed:
            raise RuntimeError("\n".join(failed))
    paths = list(libs.values())
    return {"paths": paths,
            "seconds": time.perf_counter() - t0 if todo else 0.0,
            "log": "".join(logs[p] for p in paths)}


@functools.cache
def library() -> SimpleNamespace:
    """Every exported kernel function, with its signature set, from the
    loaded libraries."""
    fns = {}
    for path in build_info()["paths"]:
        lib = ctypes.CDLL(str(path))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name, None)
            if fn is None:
                continue
            fn.argtypes = argtypes
            fn.restype = restype
            fns[name] = fn
    missing = sorted(set(_SIGNATURES) - set(fns))
    if missing:
        raise RuntimeError(f"kernel functions missing from the build: {missing}")
    return SimpleNamespace(**fns)
