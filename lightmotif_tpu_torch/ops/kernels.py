"""Wrappers of the hand-written CUDA scoring kernels.

Counterpart of :mod:`lightmotif_tpu.ops.kernels`.  ``csrc/score.cu``
holds one templated kernel with two modes, the Hopper replacement of
the Pallas kernel ``_gather_kernel``:

* :func:`score_f32` -- exact f32 scores (``Pipeline.score`` and
  ``score_max``);
* :func:`score_u8` -- discrete scores, the Scanner's first pass.

A tensor on the CPU goes to the plain version in :mod:`.torch_ops`; a
tensor on a CUDA device launches the kernel, and anything the kernel
does not take raises.  Nothing falls back.  :data:`LAUNCHES` counts the
kernel launches of each wrapper (:func:`count_launch`, safe across the
threads of a sharded database scan).
"""

from __future__ import annotations

import contextlib
import functools
import threading

import torch

from . import torch_ops

__all__ = ["score_f32", "score_u8", "LAUNCHES", "count_launch", "recording", "count_replay",
           "reset_launches", "smem_bytes"]

#: Kernel launches per wrapper since the last :func:`reset_launches`.
LAUNCHES = {"score_f32": 0, "score_u8": 0}

#: Shared memory a block may use on Hopper (bytes).
_MAX_SMEM = 232_448

_SAME_DEVICE = contextlib.nullcontext()

_COUNT_LOCK = threading.Lock()

_RECORDING = threading.local()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def count_launch(counts: dict, name: str, n: int = 1) -> None:
    """Add ``n`` kernel launches to ``counts[name]`` under a lock: ``+=``
    on a dict entry is not atomic, and the re-runs of a sharded database
    scan launch from one thread per device.  While this thread records a
    CUDA graph (:func:`recording`) the kernel is recorded, not launched:
    the launches go to the recording's tally, which each replay of the
    graph adds here (:func:`count_replay`)."""
    tally = getattr(_RECORDING, "tally", None)
    if tally is not None:
        tally.append((counts, name, n))
        return
    with _COUNT_LOCK:
        counts[name] += n


@contextlib.contextmanager
def recording(tally: list):
    """Inside, this thread's :func:`count_launch` calls append ``(counts,
    name, n)`` to ``tally`` instead of counting: a graph capture."""
    _RECORDING.tally = tally
    try:
        yield tally
    finally:
        _RECORDING.tally = None


def count_replay(tally: list) -> None:
    """Count the launches of one replay of a graph recorded into
    ``tally``."""
    for counts, name, n in tally:
        count_launch(counts, name, n)


def _check(seq: torch.Tensor, table: torch.Tensor, table_dtype, n_scores: int):
    if seq.dtype != torch.uint8 or seq.dim() != 1:
        raise TypeError(f"seq must be a 1-D uint8 tensor, got {seq.dtype} {tuple(seq.shape)}")
    if table.dtype != table_dtype or table.dim() != 2:
        raise TypeError(
            f"table must be a 2-D {table_dtype} tensor, got {table.dtype} {tuple(table.shape)}")
    m, k = table.shape
    if m < 1 or not 2 <= k <= 256:
        raise ValueError(f"bad table shape {(m, k)}")
    if n_scores < 0:
        raise ValueError("n_scores must be non-negative")
    if table.device != seq.device:
        raise ValueError(f"seq on {seq.device} but table on {table.device}")
    if seq.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {seq.device}")


@functools.lru_cache(maxsize=None)
def smem_bytes(discrete: bool, m: int, k: int) -> int:
    """Dynamic shared memory of the instantiation an entry point launches
    for an ``m x k`` table (``csrc/score.cu``: ``lm_score_pick`` and
    ``lm_score_smem``).  Raises when it exceeds what a block may use."""
    from . import build

    lib = build.library()
    smem = lib.lm_score_smem(lib.lm_score_pick(int(discrete), m, k), m, k)
    if not 0 < smem <= _MAX_SMEM:
        raise ValueError(
            f"a {m}x{k} table needs {smem} bytes of shared memory (max {_MAX_SMEM})")
    return smem


def _launch(name: str, seq, table, n_scores: int, out_dtype) -> torch.Tensor:
    from . import build

    if not (seq.is_contiguous() and table.is_contiguous()):
        raise ValueError("seq and table must be contiguous")
    m, k = table.shape
    smem_bytes(name == "score_u8", m, k)
    lp = seq.shape[0]
    out = torch.empty(lp, dtype=out_dtype, device=seq.device)
    if lp == 0:
        return out
    index = seq.device.index
    # the kernel runs on the thread's current device: switch only when the
    # tensors are elsewhere.  The current stream's handle comes from the
    # accessor PyTorch's own generated code uses: building a
    # torch.cuda.Stream for it costs about as much as the launch
    with torch.cuda.device(index) if index != torch.cuda.current_device() else _SAME_DEVICE:
        err = getattr(build.library(), f"lm_{name}")(
            seq.data_ptr(), lp, table.data_ptr(), m, k, n_scores, out.data_ptr(),
            torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    count_launch(LAUNCHES, name)
    return out


def score_f32(seq: torch.Tensor, pssm: torch.Tensor, n_scores: int) -> torch.Tensor:
    """Exact f32 score of every window start (K1).

    ``seq``: uint8 ``[Lp]``; ``pssm``: float32 ``[m, K]``.  Returns
    float32 ``[Lp]``, ``-inf`` at positions ``>= n_scores``.
    """
    _check(seq, pssm, torch.float32, n_scores)
    if seq.device.type == "cpu":
        return torch_ops.score_f32(seq, pssm, n_scores)
    return _launch("score_f32", seq, pssm, n_scores, torch.float32)


def score_u8(seq: torch.Tensor, dm: torch.Tensor, n_scores: int) -> torch.Tensor:
    """Discrete scores ``min(sum, 255)`` as int32 (K2).

    ``seq``: uint8 ``[Lp]``; ``dm``: uint8 ``[m, K]``.  Returns int32
    ``[Lp]``, ``-1`` at positions ``>= n_scores``.
    """
    _check(seq, dm, torch.uint8, n_scores)
    if seq.device.type == "cpu":
        return torch_ops.score_u8(seq, dm, n_scores)
    return _launch("score_u8", seq, dm, n_scores, torch.int32)
