"""Loader for the native host runtime (C++ extension).

Counterpart of :mod:`lightmotif_tpu.native`.  Compiles
``_native/lightmotif_native.cpp`` on first use with the system compiler
(``$CXX``, else ``g++``) into the kernels' build directory
(:func:`.ops.build.build_dir`, never beside the source, so a read-only
installation still builds it) and exposes its functions.  The library's
file name carries a hash of the source, the flags and the interpreter's
extension suffix, so a changed source is rebuilt.  When no compiler or no
build directory is available the callers fall back to the NumPy paths,
which give the same bytes.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sysconfig
import tempfile
import threading

__all__ = ["get"]

_LOCK = threading.Lock()
_MODULE = None
_FAILED = False

_SRC = os.path.join(os.path.dirname(__file__), "_native", "lightmotif_native.cpp")

_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]


def _so_path(directory) -> str:
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(suffix.encode())
    with open(_SRC, "rb") as fh:
        h.update(fh.read())
    return os.path.join(directory, f"_lightmotif_native-{h.hexdigest()[:16]}{suffix}")


def _build(so_path: str) -> bool:
    include = sysconfig.get_path("include")
    # compile to a private name, then rename: concurrent processes never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(so_path))
    os.close(fd)
    cmd = [os.environ.get("CXX", "g++"), *_FLAGS, f"-I{include}", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=240)
        os.replace(tmp, so_path)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get() -> "object | None":
    """Return the native module, building it on demand; None if
    unavailable."""
    global _MODULE, _FAILED
    if _MODULE is not None or _FAILED:
        return _MODULE
    with _LOCK:
        if _MODULE is not None or _FAILED:
            return _MODULE
        from .ops import build

        try:
            so_path = _so_path(build.build_dir())
        except RuntimeError:  # no writable build directory
            _FAILED = True
            return None
        if not os.path.exists(so_path) and not _build(so_path):
            _FAILED = True
            return None
        try:
            spec = importlib.util.spec_from_file_location("_lightmotif_native", so_path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _MODULE = mod
        except Exception:
            _FAILED = True
            return None
    return _MODULE
