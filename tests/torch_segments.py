"""Seeded inputs of the one-PSSM segment scan (``scan_segment``) at the
edges of its kernel's tiles and capacity, made with numpy alone: the
card tests, which import no JAX, and the CPU parity tests share them."""

import numpy as np

#: Window starts a tile of the segment kernel (``TILE`` in
#: ``lightmotif_tpu_torch/ops/csrc/scan.cu``).
TILE = 2048

#: (name, k, m, length, highest rank + 1, threshold kind, cap kind).
#: Threshold kinds: "dense" (the discrete median), "sparse" (its 0.999
#: quantile), "neginf" (the median, f32 threshold -inf), "zeros" (a
#: table of +x, -x and -0.0 cells: exact zero sums, threshold 0.0),
#: "none" (no candidate).  Cap kinds: below, at and above the candidate
#: count, 1, and, in the middle tile with candidates, on its first
#: candidate's rank (the tile keeps none), one past it (only its first
#: fits) and inside it.
CASES = [
    ("dna-below", 5, 15, 200_003, 4, "dense", "below"),
    ("dna-at", 5, 15, 200_003, 4, "dense", "at"),
    ("dna-above", 5, 15, 200_003, 4, "sparse", "above"),
    ("dna-neginf", 5, 12, 100_001, 5, "neginf", "above"),
    ("protein", 21, 10, 50_000, 21, "dense", "above"),
    ("protein-long", 21, 40, 50_000, 23, "sparse", "below"),
    ("k7-ragged", 7, 7, 4_097, 9, "dense", "below"),
    ("k256", 256, 5, 30_000, 256, "dense", "at"),
    ("zeros", 5, 6, 20_000, 5, "zeros", "above"),
    ("one-window", 5, 15, 15, 4, "neginf", "above"),
    ("m1", 5, 1, 10_000, 5, "dense", "above"),
    ("long-motif", 5, 300, 20_000, 4, "dense", "below"),
    ("no-candidate", 5, 15, 30_001, 4, "none", "above"),
    ("cap-1", 5, 15, 30_001, 4, "dense", "one"),
    ("tile-first", 5, 15, 30_001, 4, "dense", "tile_first"),
    ("tile-second", 5, 15, 30_001, 4, "dense", "tile_second"),
    ("tile-inside", 5, 15, 30_001, 4, "dense", "tile_inside"),
    ("sparse-tile-first", 5, 15, 60_001, 4, "sparse", "tile_first"),
]


def discrete_scores(seq: np.ndarray, dm: np.ndarray, n: int) -> np.ndarray:
    """``min(sum_j dm[j, s[p + j]], 255)`` of the first ``n`` window
    starts, ranks ``>= K`` read as the wildcard."""
    m, k = dm.shape
    s = np.minimum(seq.astype(np.int64), k - 1)
    acc = np.zeros(n, np.int64)
    for j in range(m):
        acc += dm[j][s[j : j + n]]
    return np.minimum(acc, 255)


def segment_inputs(k, m, length, ranks, kind, cap_kind, seed):
    """One case's ``(seq uint8, dm uint8 [m, k], table f32 [m, k], n,
    t_scaled, threshold, cap, candidates)``."""
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, ranks, size=length).astype(np.uint8)
    for start in rng.integers(0, length, size=5):  # wildcard runs
        seq[start : start + 30] = k - 1
    if kind == "zeros":
        table = np.zeros((m, k), np.float32)
        table[:, 0], table[:, 1], table[:, 2] = 1.5, -1.5, -0.0
    else:
        table = rng.normal(size=(m, k)).astype(np.float32)
    dm = rng.integers(0, max(256 // m, 2), size=(m, k)).astype(np.uint8)
    n = length - m + 1
    scores = discrete_scores(seq, dm, n)
    t_scaled = 256 if kind == "none" else int(np.quantile(scores, 0.999 if kind == "sparse"
                                                           else 0.5))
    threshold = {"neginf": -np.inf, "zeros": 0.0}.get(kind, -0.5)
    cand = np.nonzero(scores >= t_scaled)[0]
    count = len(cand)
    if cap_kind.startswith("tile"):
        tile = int(cand[count // 2]) // TILE
        before = int((cand < tile * TILE).sum())
        inside = int((cand < (tile + 1) * TILE).sum()) - before
        assert before and inside >= (3 if cap_kind == "tile_inside" else 1), \
            "the case needs candidates before the tile and in it"
        cap = {"tile_first": before, "tile_second": before + 1,
               "tile_inside": before + inside // 2}[cap_kind]
    else:
        cap = {"below": max(count // 3, 1), "at": max(count, 1), "above": 2 * count + 7,
               "one": 1}[cap_kind]
    return seq, dm, table, n, t_scaled, threshold, cap, count


def best_of_hits(positions: np.ndarray, score_bits: np.ndarray) -> tuple:
    """``(f32 bits, position)`` of the best of kept hits: the largest
    score, the larger position among equal ones; ``(-inf bits, -1)`` for
    none."""
    if positions.size == 0:
        return int(np.float32(-np.inf).view(np.int32)), -1
    scores = score_bits.astype(np.int32).view(np.float32)
    top = scores.max()
    return int(np.float32(top).view(np.int32)), int(positions[scores == top].max())
