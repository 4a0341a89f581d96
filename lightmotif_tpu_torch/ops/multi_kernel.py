"""The multi-motif prefilters K3, K4 and K5: geometry, filter layout and
their wrappers.

Counterpart of :mod:`lightmotif_tpu.ops.multi_kernel`.  Its three Pallas
kernels score every position against every motif lane of a group at
once and keep one int32 per position; ``out[p] >= 0`` marks a candidate.
They compute one integer function::

    out[p] = max over motif lanes mo of
             (sum_{j} cell[mo, j, s[p+j]] - t_eff[mo])

and differ only in the cells and in the thresholds of lanes that never
pass (padded lanes have zero cells and the never-pass threshold):

* K3, ``_any8_kernel`` (:func:`prefilter_any8`): the u16 cells ``d16``
  (:func:`.multi.fine_discretize`), ``t_eff = clip(t16, 0, 65535)``, or
  ``2**26`` for a lane that never passes;
* K5, ``_any16_kernel`` (:func:`prefilter_any16`): the same cells as
  hi/lo byte planes, ``256 * (sum hi - th_hi) + (sum lo - th_lo) = sum16
  - t_eff`` with ``t_eff = clip(t16, 0, 65535)``, or ``256 * 1024 =
  262144`` for never-pass lanes (the -1024 hi guard);
* K4, ``_any_kernel`` (:func:`prefilter_any`): u8 cells ``dm`` and the
  threshold folded into a constant-one slot: ``t_eff = t_scaled`` up to
  255, else 65536 (:data:`NEG_GUARD`); for hand-written filters,
  ``-bf16(filters_t[lanes - 1, mo])``.

On the TPU the sums ride the MXU through a one-hot window matrix; the
constant slot, the byte planes, their -128 shift and the ragged widths
are layout devices of the MXU.  Every sum is an integer below ``2**24``,
exact in the TPU's f32 or int32 accumulators.  Here one CUDA kernel
(``mma_kernel`` in ``csrc/prefilter.cu``) gives all three on the card's
int8 tensor cores: the one-hot windows times unsigned byte planes of
the cells, ``sum_q 256**q (X @ B_q) - t_eff`` (one plane for u8 cells,
two for u16), each from its own planes and thresholds
(:func:`.multi.pack_filters_k3`, :func:`.multi.pack_filters_k5`,
:func:`.multi.pack_filters_k4`), through its own C entry point.

The packed form is ``(planes, chunk_m, t_eff)``: ``planes`` uint8
``[P, chunks, K3_LANES, rows, K]`` (``rows * K`` a multiple of
:data:`ROW_BYTES`), the cells of every lane shifted per row by the
row's minimum and split into ``P <=`` :data:`MAX_PLANES` byte planes;
``chunk_m`` int32 ``[chunks]``, the rows each chunk needs; ``t_eff``
int32 ``[chunks * K3_LANES]``, the thresholds less the lanes' shifts.
The kernel's geometry comes from the shapes alone, so a launch reads
nothing back from the device.

A tensor on the CPU runs the plain version (:mod:`.torch_ops`); a tensor
on a CUDA device launches the kernel, and anything the kernel does not
take raises.  Nothing falls back.  :data:`LAUNCHES` counts the kernel
launches of each wrapper.

The constants, :func:`pack_slots`, :func:`pack_filters` and
:func:`pack_filters_any` keep the JAX package's slot layout: the routing
(:func:`supports_fused`) and the packers of :mod:`.multi` are defined by
it, so they stay byte-identical to the JAX ones.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels, torch_ops

__all__ = [
    "BITS_PER_WORD",
    "MAX_MK",
    "LANES_PER_ROW",
    "LANES_PER_ROW_WIDE",
    "ROWS_PER_BLOCK",
    "MAX_BLOCKS",
    "MAX_M_ROWS",
    "NEG_GUARD",
    "K3_LANES",
    "MAX_PLANES",
    "ROW_BYTES",
    "LAUNCHES",
    "reset_launches",
    "pack_slots",
    "pack_filters",
    "pack_filters_any",
    "supports_fused",
    "prefilter_any8",
    "prefilter_any",
    "prefilter_any16",
]

#: Motifs per packed word of the JAX layout; motif lanes pad to it.
BITS_PER_WORD = 16

#: Contraction size of one MXU pass (slots per contraction block).
MAX_MK = 128

#: Slots per motif row: 8 for nucleotide alphabets, 32 for protein.
LANES_PER_ROW = 8
LANES_PER_ROW_WIDE = 32

#: Motif rows per contraction block for nucleotide alphabets.
ROWS_PER_BLOCK = MAX_MK // LANES_PER_ROW

#: Contraction blocks of the fused path: DNA m <= 128, protein m <= 32.
MAX_BLOCKS = 8

#: Longest motif of the fused path for K <= 8.
MAX_M_ROWS = MAX_BLOCKS * ROWS_PER_BLOCK

#: Finite "+inf threshold" of the JAX threshold-folded filters.
NEG_GUARD = 65536.0

#: Motif lanes per chunk of the CUDA kernel's planes (``CH`` in
#: ``csrc/prefilter.cu``), for K3, K4 and K5 alike.  Lane counts pad to
#: :data:`BITS_PER_WORD`, a multiple of it, so every group splits into
#: whole chunks.
K3_LANES = 16

#: Byte planes the kernel takes at most: the JAX filters' sums stay below
#: ``2**24`` (:func:`.multi._exact_sums`), so shifted cells need at most 4.
MAX_PLANES = 4

#: A lane's bytes per plane (``rows * K``) are a multiple of this, the
#: size of the kernel's asynchronous copies.
ROW_BYTES = 16

#: Kernel launches per wrapper since the last :func:`reset_launches`.
LAUNCHES = {"prefilter_any8": 0, "prefilter_any": 0, "prefilter_any16": 0}

#: Shared memory a block may use on Hopper (bytes).
_MAX_SMEM = 232_448


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lanes_for(k: int) -> int:
    # strictly fewer symbols than lanes, as in the JAX layout
    return LANES_PER_ROW if k < LANES_PER_ROW else LANES_PER_ROW_WIDE


def pack_slots(stack: np.ndarray, k: int) -> np.ndarray:
    """The JAX ``[(j, s) slot, motif]`` filter layout: row
    ``(j // rpb) * MAX_MK + (j % rpb) * lanes + s``, motifs zero-padded
    to whole :data:`BITS_PER_WORD` words on the lane axis.

    ``stack``: ``[M, m_max, K]`` per-motif per-row cell values."""
    mcount, m_max, _ = stack.shape
    lanes = _lanes_for(k)
    rpb = MAX_MK // lanes
    m_pad = -(-mcount // BITS_PER_WORD) * BITS_PER_WORD
    n_blocks = -(-m_max // rpb)
    out = np.zeros((n_blocks * MAX_MK, m_pad), np.float32)
    for j in range(m_max):
        r = (j // rpb) * MAX_MK + (j % rpb) * lanes
        out[r:r + k, :mcount] = stack[:, j, :].T
    return out


def pack_filters(dm_stack: np.ndarray, t_scaled: np.ndarray, k: int):
    """The JAX base layout of :func:`pack_filters_any`: ``(filters
    [n_blocks*128, m_pad], t_eff [1, m_pad])`` with ``+inf`` thresholds
    for padded motif slots and for thresholds above the u8 range.

    ``dm_stack``: f32 ``[M, m_max, K]`` zero-padded discrete matrices;
    ``t_scaled``: int ``[M]`` scaled thresholds."""
    mcount = dm_stack.shape[0]
    filters = pack_slots(dm_stack, k)
    t_eff = np.full((1, filters.shape[1]), np.inf, np.float32)
    t_eff[0, :mcount] = np.where(
        np.asarray(t_scaled) > 255, np.inf, t_scaled).astype(np.float32)
    return filters, t_eff


def pack_filters_any(dm_stack: np.ndarray, t_scaled: np.ndarray, k: int):
    """The JAX threshold-folded u8 filters ``filters_t`` of K4: the
    :func:`pack_filters` layout with ``-t`` per motif in row ``lanes -
    1`` (group 0's top symbol slot, never a real symbol because ``k <
    lanes``); thresholds above 255 and padded motif slots fold to
    ``-NEG_GUARD``."""
    filters, t_eff = pack_filters(dm_stack, t_scaled, k)
    lanes = _lanes_for(k)
    t_fin = np.where(np.isfinite(t_eff[0]), t_eff[0], NEG_GUARD)
    filters[lanes - 1, :] = -t_fin
    return filters


def supports_fused(m_max: int, k: int, n_motifs: int) -> bool:
    """Whether a motif set of this geometry takes the prefilter path.

    The JAX package also asks for a TPU here; the port decides by
    geometry alone, because K3 runs on any CUDA device and its plain
    version on the CPU."""
    if k >= LANES_PER_ROW_WIDE or m_max < 2:
        return False
    rpb = MAX_MK // _lanes_for(k)
    return -(-m_max // rpb) <= MAX_BLOCKS


def _check(name, seq, planes, chunk_m, t_eff):
    if seq.dtype != torch.uint8 or seq.dim() != 1:
        raise TypeError(f"{name}: seq must be a 1-D uint8 tensor, got {seq.dtype} "
                        f"{tuple(seq.shape)}")
    if planes.dtype != torch.uint8 or planes.dim() != 5 or planes.shape[2] != K3_LANES:
        raise TypeError(
            f"{name}: planes must be a uint8 [P, chunks, {K3_LANES}, rows, K] tensor, "
            f"got {planes.dtype} {tuple(planes.shape)}")
    n_planes, n_chunks, _, rows, k = planes.shape
    if (not 1 <= n_planes <= MAX_PLANES or n_chunks < 1 or rows < 1
            or not 2 <= k <= 256 or rows * k % ROW_BYTES):
        raise ValueError(f"{name}: bad planes shape {tuple(planes.shape)}")
    if chunk_m.dtype != torch.int32 or tuple(chunk_m.shape) != (n_chunks,):
        raise TypeError(f"{name}: chunk_m must be int32 [{n_chunks}], got "
                        f"{chunk_m.dtype} {tuple(chunk_m.shape)}")
    if t_eff.dtype != torch.int32 or tuple(t_eff.shape) != (n_chunks * K3_LANES,):
        raise TypeError(f"{name}: t_eff must be int32 [{n_chunks * K3_LANES}], got "
                        f"{t_eff.dtype} {tuple(t_eff.shape)}")
    for what, t in (("planes", planes), ("chunk_m", chunk_m), ("t_eff", t_eff)):
        if t.device != seq.device:
            raise ValueError(f"{name}: seq on {seq.device} but {what} on {t.device}")
    if seq.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {seq.device}")


def launch(name, variant: int | None, seq, planes, chunk_m, t_eff,
           lib=None) -> torch.Tensor:
    """Launch instantiation ``variant`` of the kernel (``lm_prefilter_variant``,
    from ``lib``, the probe library the probes pass; ``None``: the
    production one through the entry point ``lm_{name}`` of
    :func:`.build.library`) on checked CUDA tensors.  Every argument comes
    from the tensors' shapes and pointers; nothing is read back from the
    device."""
    from . import build

    for t in (seq, planes, chunk_m, t_eff):
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")
    if variant is not None and lib is None:
        raise ValueError(f"{name}: instantiation {variant} needs the probe library")
    lib = build.library() if lib is None else lib
    if lib.lm_prefilter_lanes() != K3_LANES:
        raise RuntimeError("csrc/prefilter.cu and K3_LANES disagree")
    n_planes, n_chunks, _, rows, k = planes.shape
    v = lib.lm_prefilter_production() if variant is None else variant
    smem = lib.lm_prefilter_smem(v, rows, k, n_planes)
    if not 0 < smem <= _MAX_SMEM:
        raise ValueError(
            f"{name}: {rows} rows of K={k} need {smem} bytes of shared memory "
            f"(max {_MAX_SMEM}) in instantiation {v}")
    lp = seq.shape[0]
    out = torch.empty(lp, dtype=torch.int32, device=seq.device)
    if lp == 0:
        return out
    args = (seq.data_ptr(), lp, planes.data_ptr(), n_planes, n_chunks, rows, k,
            chunk_m.data_ptr(), t_eff.data_ptr(), out.data_ptr())
    with torch.cuda.device(seq.device):
        stream = torch.cuda.current_stream(seq.device).cuda_stream
        if variant is None:
            err = getattr(lib, f"lm_{name}")(*args, stream)
        else:
            err = lib.lm_prefilter_variant(variant, *args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return out


def _prefilter(name, seq, planes, chunk_m, t_eff) -> torch.Tensor:
    _check(name, seq, planes, chunk_m, t_eff)
    if seq.device.type == "cpu":
        return getattr(torch_ops, name)(seq, planes, chunk_m, t_eff)
    out = launch(name, None, seq, planes, chunk_m, t_eff)
    kernels.count_launch(LAUNCHES, name)
    return out


def prefilter_any8(seq: torch.Tensor, planes: torch.Tensor, chunk_m: torch.Tensor,
                   t_eff: torch.Tensor) -> torch.Tensor:
    """``max_mo (sum16 - t_eff)`` of every window start as int32 ``[Lp]`` (K3).

    ``seq``: uint8 ``[Lp]``; ``planes``, ``chunk_m``, ``t_eff``: the K3
    filters of :func:`.multi.pack_filters_k3`.  Windows that run past
    the end of ``seq`` read the wildcard, so the value is the JAX
    kernel's on every ``p < Lp - m + 1``.
    """
    return _prefilter("prefilter_any8", seq, planes, chunk_m, t_eff)


def prefilter_any(seq: torch.Tensor, planes: torch.Tensor, chunk_m: torch.Tensor,
                  t_eff: torch.Tensor) -> torch.Tensor:
    """``max_mo (sum_j dm - t_eff)`` of every window start as int32
    ``[Lp]`` (K4, the u8 prefilter).

    The inputs are those of :func:`prefilter_any8`, with the u8 cells
    and thresholds of :func:`.multi.pack_filters_k4` (one byte plane)."""
    return _prefilter("prefilter_any", seq, planes, chunk_m, t_eff)


def prefilter_any16(seq: torch.Tensor, planes: torch.Tensor, chunk_m: torch.Tensor,
                    t_eff: torch.Tensor) -> torch.Tensor:
    """``max_mo (sum16 - t_eff)`` of every window start as int32 ``[Lp]``
    (K5, the u16 byte-plane prefilter).

    The inputs are those of :func:`prefilter_any8`, with the thresholds
    of :func:`.multi.pack_filters_k5` (never-pass lanes at 262144)."""
    return _prefilter("prefilter_any16", seq, planes, chunk_m, t_eff)
