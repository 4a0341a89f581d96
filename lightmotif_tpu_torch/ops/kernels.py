"""Wrappers of the hand-written CUDA kernels of the one-PSSM paths.

Counterpart of :mod:`lightmotif_tpu.ops.kernels`.  ``csrc/score.cu``
holds one templated kernel with two modes, the Hopper replacement of
the Pallas kernel ``_gather_kernel``:

* :func:`score_f32` -- exact f32 scores (``Pipeline.score`` and
  ``score_max``);
* :func:`score_u8` -- discrete scores, the Scanner's first pass.

``csrc/scan.cu`` holds C3, :func:`scan_compact`: the Scanner's
fixed-capacity compaction, exact rescore and keep after K2 (the XLA code
of the JAX ``scan_segment``); :func:`scan_segment` is K2 then C3.

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

__all__ = ["score_f32", "score_u8", "scan_compact", "scan_segment", "LAUNCHES", "count_launch",
           "recording", "count_replay", "reset_launches", "smem_bytes"]

#: Kernel launches per wrapper since the last :func:`reset_launches`
#: (one :func:`scan_compact` call, C3's three kernels, counts one).
LAUNCHES = {"score_f32": 0, "score_u8": 0, "scan_compact": 0}

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


def scan_compact(scores: torch.Tensor, seq: torch.Tensor, pssm: torch.Tensor, n_here: int,
                 t_scaled: int, threshold: float, cap: int):
    """C3: the candidates ``scores >= t_scaled`` among the first
    ``n_here`` window starts, the first ``cap`` of them rescored exactly
    and kept where the f32 score is ``>= threshold``, with no read of the
    device.  Returns ``(counts int32 [3], packed int32 [2, cap])``: the
    exact candidate count, ``n_kept`` and 1, and the kept hits
    front-compacted in position order (positions, f32 bits); see
    :func:`.torch_ops.scan_compact`, its plain version.

    ``scores``: int32 ``[>= n_here]`` (:func:`score_u8`'s, 16-byte
    aligned on a card); ``seq``: uint8 ``[>= n_here + m - 1]``;
    ``pssm``: f32 ``[m, K]``.
    """
    _check(seq, pssm, torch.float32, n_here)
    m, k = pssm.shape
    if scores.dtype != torch.int32 or scores.dim() != 1 or scores.shape[0] < n_here:
        raise TypeError(f"scores must be a 1-D int32 tensor of at least {n_here} entries, "
                        f"got {scores.dtype} {tuple(scores.shape)}")
    if n_here and seq.shape[0] < n_here + m - 1:
        raise ValueError(f"seq holds {seq.shape[0]} symbols, fewer than the {n_here} windows "
                         f"of {m} need")
    if n_here > 2**31 - 1:
        raise ValueError("a segment holds at most 2**31 - 1 window starts (int32 positions)")
    if cap < 1:
        raise ValueError("cap must be positive")
    if scores.device != seq.device:
        raise ValueError(f"seq on {seq.device} but scores on {scores.device}")
    if seq.device.type == "cpu":
        return torch_ops.scan_compact(scores, seq, pssm, n_here, t_scaled, threshold, cap)
    from . import build

    if not (scores.is_contiguous() and seq.is_contiguous() and pssm.is_contiguous()):
        raise ValueError("scan_compact takes contiguous tensors")
    if scores.data_ptr() % 16:
        raise ValueError("scan_compact: scores must be 16-byte aligned")
    lib = build.library()
    device = seq.device
    counts = torch.empty(3, dtype=torch.int32, device=device)
    packed = torch.empty((2, cap), dtype=torch.int32, device=device)
    scratch = torch.empty(lib.lm_scan_scratch(n_here), dtype=torch.uint8, device=device)
    index = device.index
    with torch.cuda.device(index) if index != torch.cuda.current_device() else _SAME_DEVICE:
        err = lib.lm_scan_compact(
            scores.data_ptr(), seq.data_ptr(), pssm.data_ptr(), m, k, n_here, int(t_scaled),
            float(np.float32(threshold)), cap, scratch.data_ptr(), counts.data_ptr(),
            packed.data_ptr(), torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"scan_compact kernel launch failed: CUDA error {err}")
    count_launch(LAUNCHES, "scan_compact")
    return counts, packed


def scan_segment(chunk: torch.Tensor, n_here: int, dm: torch.Tensor, pssm: torch.Tensor,
                 t_scaled: int, threshold: float, cap: int):
    """Two-pass scan of one segment at a fixed capacity: K2
    (:func:`score_u8`), then C3 (:func:`scan_compact`), with no read of
    the device.  ``chunk`` holds the segment's ``n_here`` window starts
    plus the (m-1)-position halo.  Returns ``(counts int32 [3], packed
    int32 [2, cap])`` (:func:`.torch_ops.scan_segment` is the plain
    version of the whole)."""
    return scan_compact(score_u8(chunk, dm, n_here), chunk, pssm, n_here, t_scaled, threshold,
                        cap)
