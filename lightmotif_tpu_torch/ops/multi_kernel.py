"""The multi-motif prefilter K3: geometry, filter layout and its wrapper.

Counterpart of :mod:`lightmotif_tpu.ops.multi_kernel`.  The Pallas
kernel ``_any8_kernel`` (``prefilter_any8``) scores every position
against every motif of a group at once and keeps one int32 per
position::

    out[p] = max over motif lanes mo of
             (sum_{j < m_max} d16[mo, j, s[p+j]] - t_eff[mo])

with ``d16`` the u16 discretization of the group
(:func:`.multi.fine_discretize`) and ``t_eff`` the u16 threshold, or
``2**26`` for a lane that never passes.  ``out[p] >= 0`` marks a
candidate position.  On the TPU the sums ride the int8 MXU through a
one-hot window matrix and -128-shifted byte planes; here
``csrc/prefilter.cu`` (``lm_prefilter_any8``) sums table lookups in
int32, which gives the same integers.

A tensor on the CPU runs the plain version
(:func:`.torch_ops.prefilter_any8`); a tensor on a CUDA device launches
the kernel, and anything the kernel does not take raises.  Nothing
falls back.  :data:`LAUNCHES` counts the kernel launches.

The constants and :func:`pack_slots` keep the JAX package's slot layout:
the routing (:func:`supports_fused`) and the packers of :mod:`.multi`
are defined by it, so they stay byte-identical to the JAX ones.
"""

from __future__ import annotations

import numpy as np
import torch

from . import torch_ops

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
    "LAUNCHES",
    "reset_launches",
    "pack_slots",
    "supports_fused",
    "prefilter_any8",
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

#: Motif lanes per chunk of the CUDA kernel's table (``CH`` in
#: ``csrc/prefilter.cu``).  Lane counts pad to :data:`BITS_PER_WORD`,
#: a multiple of it, so every group splits into whole chunks.
K3_LANES = 16

#: Kernel launches since the last :func:`reset_launches`.
LAUNCHES = {"prefilter_any8": 0}

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


def supports_fused(m_max: int, k: int, n_motifs: int) -> bool:
    """Whether a motif set of this geometry takes the prefilter path.

    The JAX package also asks for a TPU here; the port decides by
    geometry alone, because K3 runs on any CUDA device and its plain
    version on the CPU."""
    if k >= LANES_PER_ROW_WIDE or m_max < 2:
        return False
    rpb = MAX_MK // _lanes_for(k)
    return -(-m_max // rpb) <= MAX_BLOCKS


def _check(seq, table, chunk_m, t_eff):
    if seq.dtype != torch.uint8 or seq.dim() != 1:
        raise TypeError(f"seq must be a 1-D uint8 tensor, got {seq.dtype} {tuple(seq.shape)}")
    if table.dtype != torch.int32 or table.dim() != 4 or table.shape[3] != K3_LANES:
        raise TypeError(
            f"table must be an int32 [chunks, m, K, {K3_LANES}] tensor, "
            f"got {table.dtype} {tuple(table.shape)}")
    n_chunks, m, k, _ = table.shape
    if n_chunks < 1 or m < 1 or not 2 <= k <= 256:
        raise ValueError(f"bad table shape {tuple(table.shape)}")
    if chunk_m.dtype != torch.int32 or tuple(chunk_m.shape) != (n_chunks,):
        raise TypeError(f"chunk_m must be int32 [{n_chunks}], got {chunk_m.dtype} "
                        f"{tuple(chunk_m.shape)}")
    if t_eff.dtype != torch.int32 or tuple(t_eff.shape) != (n_chunks * K3_LANES,):
        raise TypeError(f"t_eff must be int32 [{n_chunks * K3_LANES}], got "
                        f"{t_eff.dtype} {tuple(t_eff.shape)}")
    for name, t in (("table", table), ("chunk_m", chunk_m), ("t_eff", t_eff)):
        if t.device != seq.device:
            raise ValueError(f"seq on {seq.device} but {name} on {t.device}")
    if seq.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {seq.device}")


def _launch(seq, table, chunk_m, t_eff) -> torch.Tensor:
    from . import build

    for t in (seq, table, chunk_m, t_eff):
        if not t.is_contiguous():
            raise ValueError("prefilter_any8 takes contiguous tensors")
    lib = build.library()
    if lib.lm_prefilter_lanes() != K3_LANES:
        raise RuntimeError("csrc/prefilter.cu and K3_LANES disagree")
    n_chunks, m, k, _ = table.shape
    smem = m * k * lib.lm_prefilter_row_bytes() + lib.lm_prefilter_tile() + m - 1
    if smem > _MAX_SMEM:
        raise ValueError(
            f"an m={m}, K={k} chunk needs {smem} bytes of shared memory "
            f"(max {_MAX_SMEM})")
    lp = seq.shape[0]
    out = torch.empty(lp, dtype=torch.int32, device=seq.device)
    if lp == 0:
        return out
    with torch.cuda.device(seq.device):
        stream = torch.cuda.current_stream(seq.device).cuda_stream
        err = lib.lm_prefilter_any8(
            seq.data_ptr(), lp, table.data_ptr(), chunk_m.data_ptr(),
            t_eff.data_ptr(), n_chunks, m, k, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"prefilter_any8 kernel launch failed: CUDA error {err}")
    LAUNCHES["prefilter_any8"] += 1
    return out


def prefilter_any8(seq: torch.Tensor, table: torch.Tensor, chunk_m: torch.Tensor,
                   t_eff: torch.Tensor) -> torch.Tensor:
    """``max_mo (sum16 - t_eff)`` of every window start as int32 ``[Lp]`` (K3).

    ``seq``: uint8 ``[Lp]``; ``table``, ``chunk_m``, ``t_eff``: the K3
    filters of :func:`.multi.pack_filters_k3`.  Windows that run past
    the end of ``seq`` read the wildcard, so the value is the JAX
    kernel's on every ``p < Lp - m + 1``.
    """
    _check(seq, table, chunk_m, t_eff)
    if seq.device.type == "cpu":
        return torch_ops.prefilter_any8(seq, table, chunk_m, t_eff)
    return _launch(seq, table, chunk_m, t_eff)
