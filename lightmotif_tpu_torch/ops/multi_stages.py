"""The database scan's exact stages after the prefilter: phase C over the
compacted candidates and the pair rescore, with their wrappers.

Counterpart of the XLA code inside :func:`lightmotif_tpu.ops.multi.
scan_multi_core` that follows the prefilter (no Pallas kernel on the
TPU).  Two hand-written CUDA kernels carry it on the card:

* :func:`phase_c_bits` (``csrc/phase_c.cu::lm_phase_c_bits``): the exact
  test of every (candidate, lane) on the int8 tensor cores over the
  candidates ``cand[0 : min(count, cap)]``, with phase C's own planes and
  thresholds (the group's u16 cells as two byte planes, or its u8 cells as
  one), so bit ``l`` of word ``c`` of row ``i`` is set where lane ``16c +
  l`` has ``sum - t_eff >= 0`` at candidate ``i`` and ``cand[i] <
  n_valid[lane]``: the JAX phase C's test, exactly; and each row's set
  bits (:func:`row_popcounts`, the JAX core's ``pcnt``), which the pairs
  kernel takes;
* :func:`pairs_rescore` (``csrc/pairs.cu::lm_pairs_rescore``): the
  (candidate, lane) pairs of those bits in ascending (position, lane)
  order, each row's first ``slots`` of them and the first ``cap_hits`` in
  all (the JAX core's capacities), their exact f32 scores, the keep mask
  ``score >= th[lane]``, and the kept hits front-compacted into ``packed
  [3, cap_hits]`` int32 (positions, lanes, f32 bits) with ``counts =
  [candidates, hit_need, n_kept, valid]``, the JAX core's.

Nothing is read back from the device: the candidate count stays there,
each grid is sized by ``cap``, and rows past the count are skipped on the
card.  A tensor on the CPU runs the plain versions (:func:`phase_c_bits_plain`
and :func:`row_popcounts`, :func:`pairs_rescore_plain`); a tensor on a
CUDA device launches the kernel, and anything the kernel does not take
raises.  Nothing falls back.  :data:`LAUNCHES` counts each wrapper's
kernel launches (one call of :func:`pairs_rescore` launches
:data:`PAIRS_KERNELS`).
"""

from __future__ import annotations

import torch

from . import kernels, multi_kernel, torch_ops

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "slots_for",
    "window_ranks",
    "rescore_multi",
    "phase_c",
    "phase_c_bits",
    "phase_c_bits_plain",
    "phase_c_geometry",
    "row_popcounts",
    "pairs_rescore",
    "pairs_rescore_plain",
]

#: Kernel launches per wrapper since the last :func:`reset_launches`.
LAUNCHES = {"phase_c_bits": 0, "pairs_rescore": 0}

#: Kernels one :func:`pairs_rescore` call launches (``csrc/pairs.cu``):
#: the rows' pair offsets, then the pairs' rescore, keep and write.
PAIRS_KERNELS = 2

#: Bound on the ``[rows, lanes]`` blocks of the plain versions (elements).
_BLOCK_ELEMS = 1 << 24

#: f32 scores of the plain rescore per block of pairs.
RESCORE_BLOCK = 1 << 18

_INT32_MAX = (1 << 31) - 1


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def slots_for(cap_hits: int) -> int:
    """Pairs a candidate row lists at most: the JAX core's ``slots_r =
    max(64, min(256, cap_hits // 4096))``."""
    return max(64, min(256, int(cap_hits) // 4096))


def window_ranks(chunk: torch.Tensor, positions: torch.Tensor, m: int,
                 k: int) -> torch.Tensor:
    """int64 ``[n, m]`` ranks ``chunk[p + j]``; the wildcard past the end
    of the chunk and for ranks ``>= K``."""
    lp = chunk.shape[0]
    idx = positions[:, None] + torch.arange(m, device=chunk.device)
    sym = chunk[idx.clamp(max=lp - 1)].to(torch.int64).clamp(max=k - 1)
    return torch.where(idx < lp, sym, k - 1)


def rescore_multi(chunk: torch.Tensor, pssms: torch.Tensor, positions: torch.Tensor,
                  lanes: torch.Tensor) -> torch.Tensor:
    """Exact f32 scores of (position, motif lane) pairs.

    The sequential ascending-j sum over every row of the group's
    ``[M, m, K]`` stack, written as a loop of elementwise adds starting
    from row 0's value; zero-padded rows add +0.0, as in the JAX
    package.  (The JAX package may start from its ``pre4`` prefix
    table instead; that gives the same bits, so the port has one path.)
    Windows past the chunk read the wildcard."""
    _, m, k = pssms.shape
    flat = pssms.reshape(-1)
    jj = torch.arange(m, device=chunk.device) * k
    out = torch.empty(positions.shape, dtype=torch.float32, device=chunk.device)
    for b0 in range(0, positions.shape[0], RESCORE_BLOCK):
        pos = positions[b0 : b0 + RESCORE_BLOCK]
        lane = lanes[b0 : b0 + RESCORE_BLOCK]
        sym = window_ranks(chunk, pos, m, k)
        val = flat[(lane * (m * k))[:, None] + jj + sym]
        acc = val[:, 0]
        for j in range(1, m):
            acc = acc + val[:, j]
        out[b0 : b0 + RESCORE_BLOCK] = acc
    return out


def _rows(count: torch.Tensor, cap: int) -> int:
    return min(int(count.reshape(())), cap)


# -- phase C ------------------------------------------------------------------


def phase_c(chunk: torch.Tensor, positions: torch.Tensor, planes: torch.Tensor,
            t_eff: torch.Tensor) -> torch.Tensor:
    """``sum - t_eff`` of every (position, motif lane) as int32 ``[n,
    lanes]``: the cells of phase C's planes (:func:`.torch_ops.plane_cells`)
    summed over each position's window, every row (the padded rows are
    zero; windows past the chunk read the wildcard), less the thresholds.
    The planes hold each (lane, row) less its minimum and ``t_eff`` the
    sum of those shifts less, so every value is the one of the unshifted
    cells: the JAX phase C's ``sum16 - t`` of the u16 test, or ``sum8 -
    t`` of the u8 test.  Integer sums, exact in any order."""
    cells = torch_ops.plane_cells(planes)
    _, m, k = cells.shape
    d = cells.permute(1, 2, 0).contiguous()  # d[j, s, lane]
    sym = window_ranks(chunk, positions, m, k)
    acc = d[0][sym[:, 0]]
    for j in range(1, m):
        acc = acc + d[j][sym[:, j]]
    return acc - t_eff


def phase_c_bits_plain(chunk: torch.Tensor, cand: torch.Tensor, count: torch.Tensor,
                       planes: torch.Tensor, chunk_m: torch.Tensor, t_eff: torch.Tensor,
                       n_valid: torch.Tensor) -> torch.Tensor:
    """:func:`phase_c_bits`' plain version: :func:`phase_c` of the
    candidates (``chunk_m`` is the kernel's k-step bound and changes no
    sum), the pass bits ``>= 0`` inside the lanes' valid windows, 16
    lanes to an int32 word.  Rows at or past the count are zero."""
    cap = cand.shape[0]
    lanes = t_eff.shape[0]
    out = torch.zeros((cap, lanes // multi_kernel.K3_LANES), dtype=torch.int32,
                      device=chunk.device)
    weights = (1 << torch.arange(multi_kernel.K3_LANES, device=chunk.device)).repeat(
        lanes // multi_kernel.K3_LANES)
    n = _rows(count, cap)
    blk = max(1, _BLOCK_ELEMS // lanes)
    for r0 in range(0, n, blk):
        pos = cand[r0 : min(r0 + blk, n)]
        bit = (phase_c(chunk, pos, planes, t_eff) >= 0) & (pos[:, None] < n_valid)
        out[r0 : r0 + pos.shape[0]] = (bit.to(torch.int64) * weights).reshape(
            pos.shape[0], -1, multi_kernel.K3_LANES).sum(2).to(torch.int32)
    return out


def row_popcounts(bits: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """The set bits of each row of phase C's bits, int32 ``[cap]``: the
    JAX core's ``pcnt``.  Rows at or past the count are 0."""
    cap, n_chunks = bits.shape
    out = torch.zeros(cap, dtype=torch.int32, device=bits.device)
    n = _rows(count, cap)
    shifts = torch.arange(multi_kernel.K3_LANES, device=bits.device, dtype=torch.int32)
    blk = max(1, _BLOCK_ELEMS // (n_chunks * multi_kernel.K3_LANES))
    for r0 in range(0, n, blk):
        b = bits[r0 : min(r0 + blk, n)]
        out[r0 : r0 + b.shape[0]] = ((b[:, :, None] >> shifts) & 1).sum((1, 2))
    return out


def _check_candidates(name, chunk, cand, count):
    if chunk.dtype != torch.uint8 or chunk.dim() != 1:
        raise TypeError(f"{name}: chunk must be a 1-D uint8 tensor, got {chunk.dtype} "
                        f"{tuple(chunk.shape)}")
    if cand.dtype != torch.int64 or cand.dim() != 1 or cand.shape[0] < 1:
        raise TypeError(f"{name}: cand must be a non-empty 1-D int64 tensor, got "
                        f"{cand.dtype} {tuple(cand.shape)}")
    if count.dtype != torch.int64 or count.numel() != 1:
        raise TypeError(f"{name}: count must be one int64, got {count.dtype} "
                        f"{tuple(count.shape)}")
    for what, t in (("cand", cand), ("count", count)):
        if t.device != chunk.device:
            raise ValueError(f"{name}: chunk on {chunk.device} but {what} on {t.device}")


def phase_c_bits(chunk: torch.Tensor, cand: torch.Tensor, count: torch.Tensor,
                 planes: torch.Tensor, chunk_m: torch.Tensor, t_eff: torch.Tensor,
                 n_valid: torch.Tensor, slice_hint: int = 0):
    """Phase C's pass bits of the candidates, int32 ``[cap, chunks]``, and
    each row's set bits, int32 ``[cap]`` (:func:`row_popcounts`).

    ``chunk``: uint8 ``[Lp]``; ``cand``: int64 ``[cap]``, whose first
    ``min(count, cap)`` entries are ascending window starts in ``chunk``;
    ``count``: the candidate count, one int64 (it may exceed ``cap``);
    ``planes``, ``chunk_m``, ``t_eff``: phase C's cells in the prefilter's
    packed form (:func:`.multi._plane_table`); ``n_valid``: int32
    ``[chunks * 16]``, the window starts each lane owns.  Bit rows at or
    past the count are not written on the card (zero in the plain
    version); their popcounts are 0.  ``slice_hint`` (the card only; 0:
    the kernel's own choice) asks the kernel for slices of that many lane
    chunks, a power of two up to 32, to time its geometries."""
    multi_kernel._check("phase_c_bits", chunk, planes, chunk_m, t_eff)
    _check_candidates("phase_c_bits", chunk, cand, count)
    if n_valid.dtype != torch.int32 or tuple(n_valid.shape) != tuple(t_eff.shape):
        raise TypeError(f"phase_c_bits: n_valid must be int32 {tuple(t_eff.shape)}, got "
                        f"{n_valid.dtype} {tuple(n_valid.shape)}")
    if n_valid.device != chunk.device:
        raise ValueError(f"phase_c_bits: chunk on {chunk.device} but n_valid on "
                         f"{n_valid.device}")
    if chunk.device.type == "cpu":
        bits = phase_c_bits_plain(chunk, cand, count, planes, chunk_m, t_eff, n_valid)
        return bits, row_popcounts(bits, count)
    from . import build

    tensors = (chunk, cand, count, planes, chunk_m, t_eff, n_valid)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("phase_c_bits takes contiguous tensors")
    lib = build.library()
    n_planes, n_chunks, _, rows, k = planes.shape
    smem = lib.lm_phase_c_smem(rows, k, n_planes, n_chunks, slice_hint)
    if not 0 < smem <= multi_kernel._MAX_SMEM:
        raise ValueError(f"phase_c_bits: windows of {rows} rows of K={k} in {n_planes} "
                         f"planes need more shared memory than the card has "
                         f"(max {multi_kernel._MAX_SMEM}), or slice {slice_hint} is refused")
    cap = cand.shape[0]
    out = torch.empty((cap, n_chunks), dtype=torch.int32, device=chunk.device)
    pcnt = torch.empty(cap, dtype=torch.int32, device=chunk.device)
    with torch.cuda.device(chunk.device):
        stream = torch.cuda.current_stream(chunk.device).cuda_stream
        err = lib.lm_phase_c_bits(chunk.data_ptr(), chunk.shape[0], cand.data_ptr(),
                                  count.data_ptr(), cap, planes.data_ptr(), n_planes,
                                  n_chunks, rows, k, chunk_m.data_ptr(), t_eff.data_ptr(),
                                  n_valid.data_ptr(), out.data_ptr(), pcnt.data_ptr(),
                                  slice_hint, stream)
    if err != 0:
        raise RuntimeError(f"phase_c_bits kernel launch failed: CUDA error {err}")
    kernels.count_launch(LAUNCHES, "phase_c_bits")
    return out, pcnt


def phase_c_geometry(planes: torch.Tensor, slice_hint: int = 0) -> dict:
    """The geometry :func:`phase_c_bits` launches on the card for these
    planes: lane chunks a slice, warps a block, blocks an SM (as their
    shared memory allows) and the shared memory of a block."""
    from . import build

    lib = build.library()
    n_planes, n_chunks, _, rows, k = planes.shape
    info = lib.lm_phase_c_geom(rows, k, n_planes, n_chunks, slice_hint)
    if info < 0:
        raise ValueError(f"phase_c_bits: no geometry fits windows of {rows} rows of K={k} "
                         f"in {n_planes} planes (slice {slice_hint})")
    return {"slice": info & 0xFFFF, "warps": (info >> 16) & 0xFF, "per_sm": info >> 24,
            "smem": lib.lm_phase_c_smem(rows, k, n_planes, n_chunks, slice_hint)}


# -- pairs, rescore, keep -----------------------------------------------------


def pairs_rescore_plain(bits: torch.Tensor, cand: torch.Tensor, count: torch.Tensor,
                        chunk: torch.Tensor, pssm: torch.Tensor, th: torch.Tensor,
                        cap_hits: int):
    """:func:`pairs_rescore`' plain version: the pairs of each row's set
    bits (``nonzero`` lists them in ascending (row, lane) order), each
    row's first ``slots_for(cap_hits)``, the first ``cap_hits`` of all,
    lanes past the stack read as its last motif, the exact scores of
    :func:`rescore_multi`, the keep mask and its compaction.  Slots of
    ``packed`` past ``n_kept`` are zero."""
    cap, n_chunks = bits.shape
    device = bits.device
    slots = slots_for(cap_hits)
    n = _rows(count, cap)
    n_lanes = n_chunks * multi_kernel.K3_LANES
    shifts = torch.arange(multi_kernel.K3_LANES, device=device, dtype=torch.int32)
    rows, lanes = [], []
    total = rmax = listed_total = 0
    blk = max(1, _BLOCK_ELEMS // n_lanes)
    for r0 in range(0, n, blk):
        b = bits[r0 : min(r0 + blk, n)]
        mask = ((b[:, :, None] >> shifts) & 1).bool().reshape(b.shape[0], n_lanes)
        per_row = mask.sum(1)
        total += int(per_row.sum())
        rmax = max(rmax, int(per_row.max()))
        listed = mask & (mask.cumsum(1) <= slots)
        r, lane = torch.nonzero(listed, as_tuple=True)
        listed_total += r.numel()
        rows.append(r + r0)
        lanes.append(lane)
    empty = torch.zeros(0, dtype=torch.int64, device=device)
    rows = torch.cat(rows)[:cap_hits] if rows else empty
    lanes = torch.cat(lanes)[:cap_hits].clamp(max=pssm.shape[0] - 1) if lanes else empty
    positions = cand[rows]
    scores = rescore_multi(chunk, pssm, positions, lanes)
    keep = scores >= th[lanes]
    n_kept = int(keep.sum())
    packed = torch.zeros((3, cap_hits), dtype=torch.int32, device=device)
    packed[0, :n_kept] = positions[keep].to(torch.int32)
    packed[1, :n_kept] = lanes[keep].to(torch.int32)
    packed[2, :n_kept] = scores[keep].view(torch.int32)
    need = max(min(total, 1 << 30), listed_total, rmax * 4096 if rmax > slots else 0)
    counts = torch.tensor([min(int(count.reshape(())), _INT32_MAX), min(need, _INT32_MAX),
                           n_kept, 1], dtype=torch.int32, device=device)
    return counts, packed


def pairs_rescore(bits: torch.Tensor, pcnt: torch.Tensor, cand: torch.Tensor,
                  count: torch.Tensor, chunk: torch.Tensor, pssm: torch.Tensor,
                  th: torch.Tensor, cap_hits: int):
    """The kept hits of phase C's bits: ``(counts int32 [4], packed int32
    [3, cap_hits])``.

    ``bits``, ``pcnt``: int32 ``[cap, chunks]`` and ``[cap]``, the two
    outputs of :func:`phase_c_bits` (the kernel lists each row's pairs by
    ``pcnt``; the plain version counts them itself); ``cand``, ``count``:
    its candidates; ``chunk``: uint8 ``[Lp]``; ``pssm``: f32
    ``[M, m, K]`` and ``th`` f32 ``[M]``, the group's stack and thresholds.
    ``packed[:, :n_kept]`` holds the kept hits in ascending (position,
    lane) order: positions in the chunk, lanes, f32 bits; the rest of it
    is not written on the card.  ``counts = [candidates, hit_need, n_kept,
    1]``: re-run with a larger ``cap`` while ``candidates > cap``, a larger
    ``cap_hits`` while ``hit_need > cap_hits`` (the JAX core's rule)."""
    _check_candidates("pairs_rescore", chunk, cand, count)
    cap = cand.shape[0]
    if bits.dtype != torch.int32 or bits.dim() != 2 or bits.shape[0] != cap:
        raise TypeError(f"pairs_rescore: bits must be int32 [{cap}, chunks], got "
                        f"{bits.dtype} {tuple(bits.shape)}")
    if pcnt.dtype != torch.int32 or tuple(pcnt.shape) != (cap,):
        raise TypeError(f"pairs_rescore: pcnt must be int32 [{cap}], got {pcnt.dtype} "
                        f"{tuple(pcnt.shape)}")
    if pssm.dtype != torch.float32 or pssm.dim() != 3 or pssm.shape[0] < 1:
        raise TypeError(f"pairs_rescore: pssm must be f32 [M, m, K], got {pssm.dtype} "
                        f"{tuple(pssm.shape)}")
    if th.dtype != torch.float32 or tuple(th.shape) != (pssm.shape[0],):
        raise TypeError(f"pairs_rescore: th must be f32 [{pssm.shape[0]}], got {th.dtype} "
                        f"{tuple(th.shape)}")
    cap_hits = int(cap_hits)
    if cap_hits < 1:
        raise ValueError("pairs_rescore: cap_hits must be positive")
    for what, t in (("bits", bits), ("pcnt", pcnt), ("pssm", pssm), ("th", th)):
        if t.device != chunk.device:
            raise ValueError(f"pairs_rescore: chunk on {chunk.device} but {what} on "
                             f"{t.device}")
    if chunk.device.type == "cpu":
        return pairs_rescore_plain(bits, cand, count, chunk, pssm, th, cap_hits)
    if chunk.device.type != "cuda":
        raise ValueError(f"pairs_rescore: unsupported device {chunk.device}")
    from . import build

    tensors = (bits, pcnt, cand, count, chunk, pssm, th)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("pairs_rescore takes contiguous tensors")
    lib = build.library()
    n_motifs, m, k = pssm.shape
    scratch = torch.empty(lib.lm_pairs_scratch(cap, cap_hits), dtype=torch.uint8,
                          device=chunk.device)
    packed = torch.empty((3, cap_hits), dtype=torch.int32, device=chunk.device)
    counts = torch.empty(4, dtype=torch.int32, device=chunk.device)
    with torch.cuda.device(chunk.device):
        stream = torch.cuda.current_stream(chunk.device).cuda_stream
        err = lib.lm_pairs_rescore(bits.data_ptr(), bits.shape[1], pcnt.data_ptr(),
                                   cand.data_ptr(), count.data_ptr(), cap, cap_hits,
                                   chunk.data_ptr(), chunk.shape[0], pssm.data_ptr(),
                                   th.data_ptr(), n_motifs, m, k, scratch.data_ptr(),
                                   packed.data_ptr(), counts.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"pairs_rescore kernel launch failed: CUDA error {err}")
    kernels.count_launch(LAUNCHES, "pairs_rescore", PAIRS_KERNELS)
    return counts, packed
