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
gives all three on the card's int8 tensor cores: the one-hot windows
times unsigned byte planes of the cells, ``sum_q 256**q (X @ B_q) -
t_eff`` (one plane for u8 cells, two for u16), each from its own planes
and thresholds (:func:`.multi.pack_filters_k3`,
:func:`.multi.pack_filters_k5`, :func:`.multi.pack_filters_k4`), through
its own C entry point.  That kernel is ``gmma_prefilter`` in
``csrc/prefilter.cu``, on Hopper's warpgroup MMAs fed by bulk copies,
in tiles of 128 or 256 positions (:func:`gmma_tile_positions`) by
:data:`GMMA_LANES` lanes; each lane tile multiplies only the
:data:`GMMA_KSTEP`-byte k-steps of its deepest chunk
(:func:`tile_ksteps`, which the launch passes), from the planes packed
for it (:func:`gmma_blocks`; a device group holds both after the
planes).  It takes every shape with ``rows * K <=``
:data:`GMMA_MAX_KSTEPS` ``* GMMA_KSTEP`` bytes and at most
:data:`GMMA_MAX_LANE_TILES` lane tiles (:func:`gmma_takes`); the entry
points choose by the shape alone and give any other shape to
``mma_kernel``, the earlier ``mma.sync`` design.  A launch on the card
needs the blocks and their k-steps whatever the shape.

The packed form is ``(planes, chunk_m, t_eff)`` (on the device with
``blocks`` and ``ksteps`` after them): ``planes`` uint8
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
launches of each wrapper, and of each kernel: ``prefilter_gmma`` the
launches that went through the warpgroup kernel, ``prefilter_mma``
those of the shapes it does not take.

The constants, :func:`pack_slots`, :func:`pack_filters` and
:func:`pack_filters_any` keep the JAX package's slot layout: the routing
(:func:`supports_fused`) and the packers of :mod:`.multi` are defined by
it, so they stay byte-identical to the JAX ones.
"""

from __future__ import annotations

import ctypes
import functools

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
    "GMMA_HALF",
    "GMMA_LANES",
    "GMMA_KSTEP",
    "GMMA_MAX_KSTEPS",
    "GMMA_MAX_LANE_TILES",
    "GMMA_TWO_KSTEPS",
    "LAUNCHES",
    "reset_launches",
    "pack_slots",
    "pack_filters",
    "pack_filters_any",
    "supports_fused",
    "tile_ksteps",
    "gmma_schedule",
    "gmma_deep",
    "gmma_tile_positions",
    "gmma_blocks",
    "issued_ops",
    "gmma_takes",
    "issue_counts",
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

#: The warpgroup kernel's tiles (``G_HALF``, ``G_LANES``, ``G_KSTEP``,
#: ``G_MAX_KS``, ``G_MAX_LTILES`` and ``G_TWO_KS`` in
#: ``csrc/prefilter.cu``): positions of one MMA (a half of a warpgroup's
#: rows), lanes of a tile, bytes of depth of one MMA (a k-step), the most
#: k-steps of a lane and the most lane tiles it takes, and the deepest
#: shape (``rows * K`` in k-steps, of one or two planes) whose two consumer
#: warpgroups take two halves each, 256 positions a tile (128 otherwise).
GMMA_HALF = 64
GMMA_LANES = 128
GMMA_KSTEP = 32
GMMA_MAX_KSTEPS = 32
GMMA_MAX_LANE_TILES = 64
GMMA_TWO_KSTEPS = 8

#: Kernel launches per wrapper, and per kernel, since the last
#: :func:`reset_launches`.
LAUNCHES = {"prefilter_any8": 0, "prefilter_any": 0, "prefilter_any16": 0,
            "prefilter_gmma": 0, "prefilter_mma": 0}

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


def _check(name, seq, planes, chunk_m, t_eff, blocks=None, ksteps=None):
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
    if (blocks is None) != (ksteps is None):
        raise ValueError(f"{name}: blocks and ksteps come together")
    if blocks is not None:
        _check_blocks(name, planes, blocks, ksteps)
    for what, t in (("planes", planes), ("chunk_m", chunk_m), ("t_eff", t_eff),
                    ("blocks", blocks)):
        if t is not None and t.device != seq.device:
            raise ValueError(f"{name}: seq on {seq.device} but {what} on {t.device}")
    if seq.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {seq.device}")


def _check_blocks(name, planes, blocks, ksteps) -> None:
    """``blocks`` are :func:`gmma_blocks` of planes of this shape for the
    schedule ``ksteps`` (:func:`tile_ksteps`): one block for each k-step of
    each plane of each lane tile, each k-step within the planes' depth."""
    if (blocks.dtype != torch.uint8 or blocks.dim() != 3
            or tuple(blocks.shape[1:]) != (GMMA_LANES, GMMA_KSTEP)):
        raise TypeError(f"{name}: blocks must be a uint8 [n, {GMMA_LANES}, {GMMA_KSTEP}] "
                        f"tensor, got {blocks.dtype} {tuple(blocks.shape)}")
    n_planes, n_chunks, lanes, rows, k = planes.shape
    tiles = -(-n_chunks * lanes // GMMA_LANES)
    deepest = -(-rows * k // GMMA_KSTEP)
    if len(ksteps) != tiles or any(not 0 <= s <= deepest for s in ksteps):
        raise ValueError(f"{name}: ksteps must give 0 to {deepest} k-steps for each of "
                         f"{tiles} lane tiles, got {tuple(ksteps)}")
    if blocks.shape[0] != n_planes * sum(ksteps):
        raise ValueError(f"{name}: {blocks.shape[0]} blocks, but {n_planes} planes of the "
                         f"k-steps {tuple(ksteps)} take {n_planes * sum(ksteps)}")
    if blocks.data_ptr() % 16:
        raise ValueError(f"{name}: blocks must start at a 16-byte boundary")


def tile_ksteps(chunk_m, k: int) -> np.ndarray:
    """The k-steps of each tile of :data:`GMMA_LANES` lanes: those of its
    deepest chunk, ``ceil(max chunk_m * K / GMMA_KSTEP)``, from the host's
    ``chunk_m`` (int ``[chunks]``)."""
    cm = np.asarray(chunk_m, np.int64).reshape(-1)
    per = GMMA_LANES // K3_LANES
    tiles = -(-cm.size // per)
    deepest = np.zeros(tiles * per, np.int64)
    deepest[: cm.size] = cm
    return -(-deepest.reshape(tiles, per).max(axis=1) * k // GMMA_KSTEP)


def gmma_schedule(chunk_m, n_planes: int, k: int) -> np.ndarray:
    """The blocks the warpgroup kernel multiplies for each tile of
    positions, in the order it takes them: int ``[n_blocks, 3]`` rows of
    (lane tile, plane, k-step), lane tile by lane tile, each tile's planes
    from the top, each plane's k-steps (:func:`tile_ksteps` of them)."""
    ks = tile_ksteps(chunk_m, k)
    return np.asarray([(t, q, kk) for t in range(ks.size) for q in range(n_planes - 1, -1, -1)
                       for kk in range(int(ks[t]))], np.int64).reshape(-1, 3)


def gmma_deep(shape) -> bool:
    """Whether the warpgroup kernel takes planes of ``shape`` (``[P,
    chunks, K3_LANES, rows, K]``) by its loop of commit groups: ``rows *
    K`` past :data:`GMMA_TWO_KSTEPS` k-steps, or three or four planes."""
    n_planes, _, _, rows, k = shape
    return -(-rows * k // GMMA_KSTEP) > GMMA_TWO_KSTEPS or n_planes > 2


def gmma_tile_positions(shape) -> int:
    """The window starts of one tile of the warpgroup kernel on planes of
    ``shape``: 128 for a deep shape (:func:`gmma_deep`), else 256, two
    halves of 64 a consumer warpgroup (``ggeom`` in ``csrc/prefilter.cu``)."""
    return 2 * GMMA_HALF * (1 if gmma_deep(shape) else 2)


def gmma_blocks(planes, chunk_m) -> np.ndarray:
    """The byte planes as the warpgroup kernel reads them: uint8
    ``[n_blocks, GMMA_LANES, GMMA_KSTEP]``, block ``i`` the k-step of one
    plane of one lane tile that row ``i`` of :func:`gmma_schedule` names
    (zero past the group's lanes and past a lane's bytes), each lane's two
    16-byte halves swapped in rows ``r`` with ``(r >> 2) & 1`` (the 32-byte
    swizzle the kernel's MMAs read), so that one bulk copy of 4,096
    contiguous bytes fills a unit of its ring.  Host numpy, when a group is
    packed; the planes stay as they are for phase C."""
    planes = np.asarray(planes)
    n_planes, chunks, lanes, rows, k = planes.shape
    sched = gmma_schedule(chunk_m, n_planes, k)
    n_lanes, depth = chunks * lanes, rows * k
    tiles = -(-n_lanes // GMMA_LANES)
    ks = max(1, -(-depth // GMMA_KSTEP))
    flat = np.zeros((n_planes, tiles * GMMA_LANES, ks * GMMA_KSTEP), np.uint8)
    flat[:, :n_lanes, :depth] = planes.reshape(n_planes, n_lanes, depth)
    by = flat.reshape(n_planes, tiles, GMMA_LANES, ks, 2, GMMA_KSTEP // 2)
    out = by[sched[:, 1], sched[:, 0], :, sched[:, 2]]  # [n, lanes, 2, 16]
    swap = (np.arange(GMMA_LANES) >> 2) & 1 == 1
    out[:, swap] = out[:, swap, ::-1]
    return np.ascontiguousarray(out.reshape(-1, GMMA_LANES, GMMA_KSTEP))


def issued_ops(n_windows: int, planes, blocks) -> int:
    """The int8 operations the warpgroup kernel issues over ``n_windows``
    window starts: 2 x the starts padded to whole position tiles
    (:func:`gmma_tile_positions`) x the bytes of ``blocks``
    (``GMMA_LANES`` lanes x ``GMMA_KSTEP`` bytes each).  From shapes alone:
    no read of the device."""
    pos = gmma_tile_positions(planes.shape)
    return 2 * -(-int(n_windows) // pos) * pos * blocks.shape[0] * GMMA_LANES * GMMA_KSTEP


@functools.lru_cache(maxsize=None)
def _gmma_shape(n_planes: int, n_chunks: int, rows: int, k: int) -> bool:
    from . import build

    return bool(build.library().lm_prefilter_gmma_takes(n_planes, n_chunks, rows, k))


def gmma_takes(planes: torch.Tensor) -> bool:
    """Whether a launch on ``planes`` goes through the warpgroup kernel: CUDA
    planes of a shape it takes, the entry points' own test by shape
    (``lm_prefilter_gmma_takes``, asked once a shape).  False on the CPU,
    where the plain version runs."""
    if planes.device.type != "cuda":
        return False
    n_planes, n_chunks, _, rows, k = planes.shape
    return _gmma_shape(n_planes, n_chunks, rows, k)


def issue_counts(seq: torch.Tensor, planes: torch.Tensor, chunk_m: torch.Tensor,
                 t_eff: torch.Tensor, blocks: torch.Tensor | None = None,
                 ksteps=None) -> dict:
    """The ``prefilter`` span's counts of one launch on a prefilter's
    inputs: ``gmma``, 1 when it goes through the warpgroup kernel;
    ``issued_ops``, the int8 operations that kernel issues
    (:func:`issued_ops`; 0 for another kernel); and ``deep_ops``, those of
    a launch on a deep shape (:func:`gmma_deep`), else 0.  No read of the
    device."""
    gmma = gmma_takes(planes)
    ops = issued_ops(seq.shape[0], planes, blocks) if gmma else 0
    return {"gmma": int(gmma), "issued_ops": ops,
            "deep_ops": ops if gmma_deep(planes.shape) else 0}


def launch(name, variant: int | None, seq, planes, chunk_m, t_eff, lib=None,
           blocks=None, ksteps=None) -> torch.Tensor:
    """Launch the kernel on checked CUDA tensors: ``variant`` ``None``,
    what the entry point ``lm_{name}`` of :func:`.build.library` launches
    (the warpgroup kernel on ``blocks`` and their ``ksteps``, or
    ``mma_kernel``'s production instantiation for a shape the warpgroup
    kernel does not take); else instantiation ``variant`` of
    ``mma_kernel`` (``lm_prefilter_variant``, from ``lib``, the probe
    library that the probes and the comparisons with the earlier design
    pass).  Every argument comes from the tensors' shapes and pointers and
    the host's ``ksteps``; nothing is read back from the device."""
    from . import build

    for t in (seq, planes, chunk_m, t_eff, blocks):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")
    if variant is not None and lib is None:
        raise ValueError(f"{name}: instantiation {variant} needs the probe library")
    if variant is None and (blocks is None or ksteps is None):
        raise ValueError(f"{name}: the entry point needs the planes' blocks and ksteps")
    lib = build.library() if lib is None else lib
    if lib.lm_prefilter_lanes() != K3_LANES:
        raise RuntimeError("csrc/prefilter.cu and K3_LANES disagree")
    n_planes, n_chunks, _, rows, k = planes.shape
    if variant is not None or not gmma_takes(planes):
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
            chunk_m.data_ptr(), t_eff.data_ptr())
    with torch.cuda.device(seq.device):
        stream = torch.cuda.current_stream(seq.device).cuda_stream
        if variant is None:
            steps = (ctypes.c_int * len(ksteps))(*ksteps)
            err = getattr(lib, f"lm_{name}")(*args, blocks.data_ptr(), blocks.shape[0],
                                             steps, out.data_ptr(), stream)
        else:
            err = lib.lm_prefilter_variant(variant, *args, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return out


def _prefilter(name, seq, planes, chunk_m, t_eff, blocks, ksteps) -> torch.Tensor:
    _check(name, seq, planes, chunk_m, t_eff, blocks, ksteps)
    if seq.device.type == "cuda" and blocks is None:
        raise ValueError(f"{name}: a launch on the card needs the planes' blocks and their "
                         f"k-steps (gmma_blocks, tile_ksteps)")
    if seq.device.type == "cpu":
        return getattr(torch_ops, name)(seq, planes, chunk_m, t_eff)
    out = launch(name, None, seq, planes, chunk_m, t_eff, blocks=blocks, ksteps=ksteps)
    kernels.count_launch(LAUNCHES, name)
    kernels.count_launch(LAUNCHES, "prefilter_gmma" if gmma_takes(planes) else "prefilter_mma")
    return out


def prefilter_any8(seq: torch.Tensor, planes: torch.Tensor, chunk_m: torch.Tensor,
                   t_eff: torch.Tensor, blocks: torch.Tensor | None = None,
                   ksteps=None) -> torch.Tensor:
    """``max_mo (sum16 - t_eff)`` of every window start as int32 ``[Lp]`` (K3).

    ``seq``: uint8 ``[Lp]``; ``planes``, ``chunk_m``, ``t_eff``: the K3
    filters of :func:`.multi.pack_filters_k3`; ``blocks`` and ``ksteps``:
    the planes packed for the warpgroup kernel (:func:`gmma_blocks`, on the
    device) and their k-steps a lane tile (:func:`tile_ksteps`, host ints),
    a device group's fourth and fifth items.  A launch on the card needs
    them; the CPU's plain version checks them when given and reads only
    the planes.  Windows that run past the end of ``seq`` read the
    wildcard, so the value is the JAX kernel's on every ``p < Lp - m + 1``.
    """
    return _prefilter("prefilter_any8", seq, planes, chunk_m, t_eff, blocks, ksteps)


def prefilter_any(seq: torch.Tensor, planes: torch.Tensor, chunk_m: torch.Tensor,
                  t_eff: torch.Tensor, blocks: torch.Tensor | None = None,
                  ksteps=None) -> torch.Tensor:
    """``max_mo (sum_j dm - t_eff)`` of every window start as int32
    ``[Lp]`` (K4, the u8 prefilter).

    The inputs are those of :func:`prefilter_any8`, with the u8 cells
    and thresholds of :func:`.multi.pack_filters_k4` (one byte plane)."""
    return _prefilter("prefilter_any", seq, planes, chunk_m, t_eff, blocks, ksteps)


def prefilter_any16(seq: torch.Tensor, planes: torch.Tensor, chunk_m: torch.Tensor,
                    t_eff: torch.Tensor, blocks: torch.Tensor | None = None,
                    ksteps=None) -> torch.Tensor:
    """``max_mo (sum16 - t_eff)`` of every window start as int32 ``[Lp]``
    (K5, the u16 byte-plane prefilter).

    The inputs are those of :func:`prefilter_any8`, with the thresholds
    of :func:`.multi.pack_filters_k5` (never-pass lanes at 262144)."""
    return _prefilter("prefilter_any16", seq, planes, chunk_m, t_eff, blocks, ksteps)
