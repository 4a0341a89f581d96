"""Wrappers of the hand-written CUDA kernels of the one-PSSM paths.

Counterpart of :mod:`lightmotif_tpu.ops.kernels`.  ``csrc/score.cu``
holds one templated kernel with two modes, the Hopper replacement of
the Pallas kernel ``_gather_kernel``:

* :func:`score_f32` -- exact f32 scores (``Pipeline.score`` and
  ``score_max``);
* :func:`score_u8` -- discrete scores (``Pipeline.score_u8``).

``csrc/scan.cu`` holds :func:`scan_segment`, the Scanner's segment in one
launch: the discrete pass, the fixed-capacity compaction, exact rescore
and keep of the JAX ``scan_segment``, and the best kept hit.

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

import numpy as np
import torch

from . import torch_ops

__all__ = ["score_f32", "score_u8", "scan_segment", "LAUNCHES", "count_launch", "recording",
           "count_replay", "reset_launches", "smem_bytes", "scan_smem_bytes"]

#: Kernel launches per wrapper since the last :func:`reset_launches`
#: (a :func:`scan_segment` call's memset is not counted).
LAUNCHES = {"score_f32": 0, "score_u8": 0, "scan_segment": 0}

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
    return _fits(lib.lm_score_smem(lib.lm_score_pick(int(discrete), m, k), m, k), m, k)


@functools.lru_cache(maxsize=None)
def scan_smem_bytes(m: int, k: int) -> int:
    """Dynamic shared memory of :func:`scan_segment`'s kernel for an
    ``m x k`` table (``csrc/scan.cu``: ``lm_scan_smem``).  Raises, as
    :func:`smem_bytes`, when it exceeds what a block may use; a table K2
    takes always fits."""
    from . import build

    return _fits(build.library().lm_scan_smem(m, k), m, k)


def _fits(smem: int, m: int, k: int) -> int:
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


def scan_segment(chunk: torch.Tensor, n_here: int, dm: torch.Tensor, pssm: torch.Tensor,
                 t_scaled: int, threshold: float, cap: int):
    """One segment of the Scanner at a fixed capacity, with no read of the
    device: the window starts whose discrete score ``min(sum, 255)`` is at
    least ``t_scaled`` among the first ``n_here`` are the candidates; the
    first ``cap`` of them, in position order, are rescored exactly and kept
    where the f32 score is ``>= threshold``.  ``chunk``: uint8, the
    segment's ``n_here`` window starts plus the (m-1)-position halo;
    ``dm``: uint8 ``[m, K]``; ``pssm``: f32 ``[m, K]``.

    Returns ``(counts int32 [3], packed int32 [2, cap], best int32 [2])``:
    the exact candidate count, ``n_kept`` and 1; the kept hits
    front-compacted in position order (positions, f32 bits); the f32 bits
    and position of the best kept hit, ``-inf`` bits and -1 when none
    (:func:`.torch_ops.scan_segment`, its plain version).  On a card, one
    memset and one launch, the three views of one buffer.
    """
    _check(chunk, dm, torch.uint8, n_here)
    m, k = dm.shape
    if pssm.dtype != torch.float32 or tuple(pssm.shape) != (m, k):
        raise TypeError(f"pssm must be a float32 [{m}, {k}] tensor, got {pssm.dtype} "
                        f"{tuple(pssm.shape)}")
    if pssm.device != chunk.device:
        raise ValueError(f"chunk on {chunk.device} but pssm on {pssm.device}")
    if n_here and chunk.shape[0] < n_here + m - 1:
        raise ValueError(f"chunk holds {chunk.shape[0]} symbols, fewer than the {n_here} "
                         f"windows of {m} need")
    if n_here > 2**31 - 1:
        raise ValueError("a segment holds at most 2**31 - 1 window starts (int32 positions)")
    if cap < 1:
        raise ValueError("cap must be positive")
    if chunk.device.type == "cpu":
        return torch_ops.scan_segment(chunk, n_here, dm, pssm, t_scaled, threshold, cap)
    from . import build

    if not (chunk.is_contiguous() and dm.is_contiguous() and pssm.is_contiguous()):
        raise ValueError("scan_segment takes contiguous tensors")
    scan_smem_bytes(m, k)
    lib = build.library()
    head = 8 + lib.lm_scan_scratch(n_here) // 4
    out = torch.empty(head + 2 * cap, dtype=torch.int32, device=chunk.device)
    index = chunk.device.index
    # the scores cannot pass a threshold outside int32's range either way
    t_scaled = min(max(int(t_scaled), -2**31), 2**31 - 1)
    with torch.cuda.device(index) if index != torch.cuda.current_device() else _SAME_DEVICE:
        err = lib.lm_scan_segment(
            chunk.data_ptr(), chunk.shape[0], dm.data_ptr(), pssm.data_ptr(), m, k, n_here,
            t_scaled, float(np.float32(threshold)), cap, out.data_ptr(),
            torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"scan_segment kernel launch failed: CUDA error {err}")
    count_launch(LAUNCHES, "scan_segment")
    return out[:3], out[head:].view(2, cap), out[4:6]
