"""The plain reference against hand-worked small cases: the matrix
chain, the thresholds (against every word of a short motif), and the
window sums (against a loop)."""

import itertools

import numpy as np
import torch

from motifbench import check, reference

BG = np.asarray([0.25, 0.25, 0.25, 0.25, 0.0])
PERM = reference.complement_permutation("ACTGN", "TGACN")


def test_matrix_chain_by_hand():
    counts = np.asarray([[3, 1, 0, 0, 0], [0, 0, 4, 0, 0]], np.uint32)
    (w,) = reference.scoring_matrices([counts], 0.1, BG)
    # row 0: (3.1, 1.1, 0.1, 0.1) / 4.4, over 0.25, log2
    want = np.log2(np.asarray([3.1, 1.1, 0.1, 0.1], np.float32) / np.float32(4.4)
                   / np.float32(0.25), dtype=np.float32)
    assert np.allclose(w[0, :4], want, rtol=0, atol=1e-6)
    assert np.isneginf(w[:, 4]).all()
    assert np.isclose(w[1, 2], np.log2(4.1 / 4.4 / 0.25), atol=1e-6)
    (rc,) = reference.reverse_complements([w], PERM)
    # the last row's T (rank 2) becomes the first row's A (rank 0)
    assert rc[0, 0] == w[1, 2] and rc[1, 2] == w[0, 0] and rc[1, 1] == w[0, 3]


def test_bfloat16_chain_is_coarser():
    counts = [np.asarray([[3, 1, 0, 0, 0], [0, 0, 4, 7, 0]], np.uint32)]
    (f32,) = reference.scoring_matrices(counts, 0.1, BG)
    (bf16,) = reference.scoring_matrices(counts, 0.1, BG, dtype=torch.bfloat16)
    gap = check.matrix_gap([bf16], [f32])
    assert 1e-4 < gap < 0.1


def enumerated_threshold(w: np.ndarray, p: float) -> np.float32:
    """The threshold from every word of the motif: the discretised
    matrix (MEME's 1000 steps a row), the exact distribution of a uniform
    word's integer score, the least integer score whose survival is under
    ``p``, scaled back in float32."""
    finite = w[np.isfinite(w)]
    offset = np.floor(finite.min())
    scale = np.floor(1000 / (finite.max() - offset))
    cells = np.round((w[:, :4].astype(np.float64) - offset) * scale).astype(np.int64)
    size = w.shape[0] * 1000 + 1
    pdf = np.zeros(size)
    for word in itertools.product(range(4), repeat=w.shape[0]):
        pdf[cells[np.arange(w.shape[0]), word].sum()] += 0.25 ** w.shape[0]
    sf = np.minimum(np.cumsum(pdf[::-1])[::-1], 1.0)
    idx = int((sf >= p).sum())
    return np.float32(np.float32(idx) / np.float32(scale) + np.float32(w.shape[0] * offset))


def test_thresholds_against_every_word():
    rng = np.random.default_rng(5)
    counts = [np.concatenate([rng.integers(0, 20, (m, 4)), np.zeros((m, 1), int)], axis=1)
              .astype(np.uint32) for m in (1, 3, 4, 6)]
    mats = reference.scoring_matrices(counts, 0.1, BG)
    for p in (0.5, 0.05, 1e-3):
        got = reference.thresholds(mats, BG, p, "cpu")
        want = [enumerated_threshold(w, p) for w in mats]
        assert np.array_equal(got, np.asarray(want, np.float32)), (p, got, want)


def test_window_sums_against_a_loop():
    rng = np.random.default_rng(6)
    counts = [np.concatenate([rng.integers(0, 20, (m, 4)), np.zeros((m, 1), int)], axis=1)
              .astype(np.uint32) for m in (5, 5, 7, 23, 30)]
    mats = reference.scoring_matrices(counts, 0.1, BG)
    seq = rng.integers(0, 4, 300).astype(np.uint8)
    seq[100:104] = 4
    win = reference.Windows(mats, 5, 4, "cpu", block=64)
    seen = 0
    for ids, start, sums in win.sums(torch.from_numpy(seq)):
        for c, i in enumerate(ids):
            m = mats[i].shape[0]
            for r in range(sums.shape[0]):
                x = start + r
                if x + m > len(seq) or (seq[x : x + m] == 4).any():
                    assert sums[r, c] < -1e29
                else:
                    want = sum(float(mats[i][j, seq[x + j]]) for j in range(m))
                    assert abs(float(sums[r, c]) - want) < 1e-9
                seen += 1
    assert seen == 5 * 300


def test_judge_hits_counts_what_is_wrong():
    rng = np.random.default_rng(8)
    counts = [np.concatenate([rng.integers(0, 20, (m, 4)), np.zeros((m, 1), int)], axis=1)
              .astype(np.uint32) for m in (5, 6, 8)]
    mats = reference.scoring_matrices(counts, 0.1, BG)
    t = reference.thresholds(mats, BG, 0.02, "cpu")
    seq = torch.from_numpy(rng.integers(0, 4, 2000).astype(np.uint8))
    win = reference.Windows(mats, 5, 4, "cpu")
    hits = reference.scan(reference.Windows(mats, 5, 4, "cpu", dtype=torch.float64), seq, t)
    hits = (hits[0], hits[1], hits[2].astype(np.float32))
    clean = check.judge_hits(win, seq, hits, t, t, 1e-3)
    assert clean["hits"] > 20
    assert (clean["missed_hits"], clean["extra_hits"]) == (0, 0) and clean["score_gap"] < 1e-5
    dropped = check.judge_hits(win, seq, tuple(a[1:] for a in hits), t, t, 1e-3)
    assert dropped["missed_hits"] == 1
    moved = (hits[0], hits[1] + 1, hits[2])
    assert check.judge_hits(win, seq, moved, t, t, 1e-3)["extra_hits"] > 0
    twice = tuple(np.concatenate([a, a[:1]]) for a in hits)
    assert check.judge_hits(win, seq, twice, t, t, 1e-3)["extra_hits"] == 1
