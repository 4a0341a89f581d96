"""Build and load the hand-written CUDA kernels.

At first use, each ``csrc/*.cu`` source is compiled with ``nvcc`` for
Hopper (``sm_90a``) into a shared library of its own with a plain C
interface, which is loaded with :mod:`ctypes`.  The sources compile in
parallel, one ``nvcc`` each, so a build takes as long as its slowest
source as sources are added (one ``nvcc`` over several sources
compiles them one after another).  A library's file name carries a hash of
its source, the ``csrc/*.cuh`` headers the sources share and the flags,
so a changed source is rebuilt and an unchanged one is loaded as it is.

Production and probes are built apart.  :func:`library` builds and loads
``score.cu``, ``scan.cu``, ``prefilter.cu``, ``phase_c.cu`` and ``pairs.cu`` and asks
only for the entry points the production wrappers call
(:data:`PRODUCTION_SYMBOLS`); :func:`probe_library` adds ``probes.cu``,
``probe_gmma.cu`` and the probes' entry points (:data:`PROBE_SYMBOLS`).
A scan never waits for, or depends on, the probe code.

The build directory is resolved once per process (:func:`build_dir`) from
``LIGHTMOTIF_TPU_COMPILE_CACHE``, the variable of the JAX package's
compilation cache:

* a path: that directory;
* ``0``, ``off``, ``false`` or empty: a fresh temporary directory for
  this process (uncached builds), removed at exit;
* unset: ``_build/`` beside this file if it can be written, else
  ``~/.cache/lightmotif-tpu/cuda``.

When no directory can be written the build raises with the paths it
tried: nothing falls back to the CPU or to the plain versions.

Nothing here runs at import time: the CPU tests import every module,
and there is no ``nvcc`` where they run.
"""

from __future__ import annotations

import atexit
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from types import SimpleNamespace

__all__ = [
    "library",
    "probe_library",
    "build_info",
    "build_dir",
    "resolve_build_dir",
    "use_compile_cache",
    "PRODUCTION_SYMBOLS",
    "PROBE_SYMBOLS",
]

CSRC = Path(__file__).resolve().parent / "csrc"

#: The build directory when ``LIGHTMOTIF_TPU_COMPILE_CACHE`` is unset and
#: the package can be written.
PACKAGE_BUILD_DIR = Path(__file__).resolve().parent / "_build"

#: The environment variable that chooses the build directory.
ENV = "LIGHTMOTIF_TPU_COMPILE_CACHE"

#: The sources of the production entry points, and those of the probes.
PRODUCTION_SOURCES = ("score.cu", "scan.cu", "prefilter.cu", "phase_c.cu", "pairs.cu")
PROBE_SOURCES = ("probes.cu", "probe_gmma.cu")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_I64 = ctypes.c_longlong
_P = ctypes.c_void_p
_INT = ctypes.c_int
_F32 = ctypes.c_float

#: ``name: (argtypes, restype)`` of the C functions the production
#: wrappers (``kernels.py``, ``multi_kernel.py``, ``multi_stages.py``) call.
PRODUCTION_SYMBOLS = {
    "lm_score_pick": ([_INT, _INT, _INT], _INT),
    "lm_score_smem": ([_INT, _INT, _INT], _I64),
    "lm_score_f32": ([_P, _I64, _P, _INT, _INT, _I64, _P, _P], _INT),
    "lm_score_u8": ([_P, _I64, _P, _INT, _INT, _I64, _P, _P], _INT),
    "lm_scan_scratch": ([_I64], _I64),
    "lm_scan_smem": ([_INT, _INT], _I64),
    "lm_scan_segment": (
        [_P, _I64, _P, _P, _INT, _INT, _I64, _INT, _F32, _I64, _P, _P], _INT),
    "lm_prefilter_lanes": ([], _INT),
    "lm_prefilter_production": ([], _INT),
    "lm_prefilter_smem": ([_INT, _INT, _INT, _INT], _I64),
    "lm_prefilter_any8": (
        [_P, _I64, _P, _INT, _INT, _INT, _INT, _P, _P, _P, _INT, _P, _P, _P], _INT),
    "lm_prefilter_any": (
        [_P, _I64, _P, _INT, _INT, _INT, _INT, _P, _P, _P, _INT, _P, _P, _P], _INT),
    "lm_prefilter_any16": (
        [_P, _I64, _P, _INT, _INT, _INT, _INT, _P, _P, _P, _INT, _P, _P, _P], _INT),
    "lm_prefilter_gmma_shape": ([_INT], _INT),
    "lm_prefilter_gmma_takes": ([_INT, _INT, _INT, _INT], _INT),
    "lm_prefilter_gmma_geom": ([_INT, _INT, _INT, _INT], _I64),
    "lm_phase_c_geom": ([_INT, _INT, _INT, _INT, _INT], _INT),
    "lm_phase_c_smem": ([_INT, _INT, _INT, _INT, _INT], _I64),
    "lm_phase_c_bits": (
        [_P, _I64, _P, _P, _I64, _P, _INT, _INT, _INT, _INT, _P, _P, _P, _P, _P, _INT, _P],
        _INT),
    "lm_pairs_scratch": ([_I64, _I64], _I64),
    "lm_pairs_rescore": (
        [_P, _INT, _P, _P, _P, _I64, _I64, _P, _I64, _P, _P, _INT, _INT, _INT, _P, _P, _P, _P],
        _INT),
}

#: ``name: (argtypes, restype)`` of the probes' C functions: the
#: instantiation tables and variant entry points of ``score.cu`` and
#: ``prefilter.cu``, and everything of ``probes.cu`` and ``probe_gmma.cu``.
PROBE_SYMBOLS = {
    "lm_score_variants": ([], _INT),
    "lm_score_production": ([_INT], _INT),
    "lm_score_variant_info": ([_INT, _INT], _INT),
    "lm_score_variant": (
        [_INT, _INT, _P, _I64, _P, _INT, _P, _INT, _INT, _I64, _P, _P], _INT),
    "lm_prefilter_variants": ([], _INT),
    "lm_prefilter_variant_info": ([_INT], _INT),
    "lm_prefilter_variant": (
        [_INT, _P, _I64, _P, _INT, _INT, _INT, _INT, _P, _P, _P, _P], _INT),
    "lm_prefilter_lookup_smem": ([_INT, _INT], _I64),
    "lm_prefilter_lookup": (
        [_P, _I64, _P, _P, _P, _INT, _INT, _INT, _P, _P], _INT),
    "lm_prefilter_bits": (
        [_P, _I64, _P, _INT, _INT, _INT, _INT, _P, _P, _P, _P, _P], _INT),
    "lm_probe_gmma_shape": ([_INT], _INT),
    "lm_probe_gmma": ([_INT, _P, _P, _INT, _INT, _P, _P], _INT),
    "lm_probe_diag_modes": ([], _INT),
    "lm_probe_diag_smem": ([_INT, _INT], _I64),
    "lm_probe_score_diag": ([_INT, _P, _I64, _P, _INT, _INT, _I64, _P, _P], _INT),
    "lm_probe_chains": ([], _INT),
    "lm_probe_chain_info": ([_INT, _INT], _INT),
    "lm_probe_op_chain": ([_INT, _P, _I64, _P, _P, _P], _INT),
}

# the CLI's reader thread and its main thread may reach the first build
# together; every cache below is filled under this lock
_LOCK = threading.RLock()
_DIR: Path | None = None
_INFO: dict = {}
_LIBS: dict = {}


def _off(value: str) -> bool:
    return value.strip().lower() in ("", "0", "off", "false")


def _writable(path: Path) -> bool:
    """Whether ``path`` exists as a directory (created if need be) in
    which a file can be written."""
    try:
        path.mkdir(parents=True, exist_ok=True)
        fd, probe = tempfile.mkstemp(dir=path, prefix=".probe-")
        os.close(fd)
        os.unlink(probe)
        return True
    except OSError:
        return False


def _temporary() -> Path:
    path = Path(tempfile.mkdtemp(prefix="lightmotif-tpu-cuda-"))
    atexit.register(shutil.rmtree, path, ignore_errors=True)
    return path


def resolve_build_dir() -> Path:
    """The build directory the environment asks for, by the rules of the
    module docstring (resolved anew on every call; :func:`build_dir`
    resolves once).  Raises ``RuntimeError`` with the paths tried when
    none can be written."""
    value = os.environ.get(ENV)
    if value is not None and _off(value):
        try:
            return _temporary()
        except OSError as e:
            raise RuntimeError(
                f"{ENV}={value!r}: no temporary build directory ({e})") from None
    if value is not None:
        tried = [Path(value).expanduser()]
    else:
        tried = [PACKAGE_BUILD_DIR,
                 Path.home() / ".cache" / "lightmotif-tpu" / "cuda"]
    for path in tried:
        if _writable(path):
            return path
    raise RuntimeError("no writable build directory for the CUDA kernels; tried "
                       + ", ".join(str(p) for p in tried)
                       + f" (set {ENV} to a writable directory)")


def build_dir() -> Path:
    """The build directory of this process, resolved at the first call."""
    global _DIR
    with _LOCK:
        if _DIR is None:
            _DIR = resolve_build_dir()
        return _DIR


def use_compile_cache(enabled: bool) -> None:
    """Choose the build directory before the first build: the cached one
    of :func:`build_dir` (``enabled``; resolved at the first build), or a
    fresh temporary directory for this process."""
    global _DIR
    if not enabled:
        with _LOCK:
            _DIR = _temporary()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(src: Path, directory: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(src.name.encode())
    h.update(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):  # what a source may include
        h.update(header.read_bytes())
    return directory / f"liblm-{src.stem}-{h.hexdigest()[:16]}.so"


def _build(names) -> dict:
    directory = build_dir()
    libs = {CSRC / name: _lib_path(CSRC / name, directory) for name in names}
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
        nvcc = _nvcc()
        jobs = []
        for src in todo:
            # compile to a private name, then rename: concurrent
            # processes never load a half-written library
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=directory)
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
            "compiled": [libs[src] for src in todo],
            "seconds": time.perf_counter() - t0 if todo else 0.0,
            "log": "".join(logs[p] for p in paths)}


def build_info(probes: bool = False) -> dict:
    """Compile the libraries that are not up to date, all at once:
    ``score.cu``, ``scan.cu``, ``prefilter.cu``, ``phase_c.cu`` and ``pairs.cu``, and
    ``probes.cu`` and ``probe_gmma.cu`` with ``probes``.  Returns ``paths``
    (one library per source), ``compiled`` (the ones
    this call built), ``seconds`` (wall time of the build, 0.0 when
    every library was found) and the compilers' ``log`` (``ptxas -v``
    lines included).  Each form is built once per process."""
    key = bool(probes)
    with _LOCK:
        if key not in _INFO:
            _INFO[key] = _build(PRODUCTION_SOURCES + (PROBE_SOURCES if key else ()))
        return _INFO[key]


def _load(probes: bool) -> SimpleNamespace:
    with _LOCK:
        if probes in _LIBS:
            return _LIBS[probes]
        signatures = {**PRODUCTION_SYMBOLS, **(PROBE_SYMBOLS if probes else {})}
        fns = {}
        for path in build_info(probes)["paths"]:
            lib = ctypes.CDLL(str(path))
            for name, (argtypes, restype) in signatures.items():
                fn = getattr(lib, name, None)
                if fn is None:
                    continue
                fn.argtypes = argtypes
                fn.restype = restype
                fns[name] = fn
        missing = sorted(set(signatures) - set(fns))
        if missing:
            raise RuntimeError(f"kernel functions missing from the build: {missing}")
        _LIBS[probes] = SimpleNamespace(**fns)
        return _LIBS[probes]


def library() -> SimpleNamespace:
    """The production entry points (:data:`PRODUCTION_SYMBOLS`), with their
    signatures set, from ``score.cu``, ``scan.cu``, ``prefilter.cu``,
    ``phase_c.cu`` and ``pairs.cu``."""
    lib = _LIBS.get(False)  # no lock once loaded: every launch asks
    return lib if lib is not None else _load(False)


def probe_library() -> SimpleNamespace:
    """The production and the probes' entry points (:data:`PROBE_SYMBOLS`),
    ``probes.cu`` and ``probe_gmma.cu`` included."""
    lib = _LIBS.get(True)
    return lib if lib is not None else _load(True)
