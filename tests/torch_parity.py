"""Shared helpers of the parity tests between ``lightmotif_tpu_torch``
and ``lightmotif_tpu``: the same numpy inputs, made from a seed, built
into each package's objects."""

import jax
import numpy as np
import pytest

import lightmotif_tpu as jlm
import lightmotif_tpu_torch as tlm
from lightmotif_tpu.ops import kernels as jax_kernels


def bits(values) -> np.ndarray:
    """f32 values as their bit patterns (``-inf`` and signed zeros
    compare exactly)."""
    return np.asarray(values, dtype=np.float32).view(np.uint32)


def random_counts(rng, m: int, k: int) -> np.ndarray:
    """``[m, k]`` counts with a zero wildcard column and no empty row."""
    counts = rng.integers(0, 12, size=(m, k))
    counts[:, k - 1] = 0
    counts[:, 0] += 1
    return counts


def pssms(counts, protein: bool = False, pseudo=0.1):
    """The same scoring matrix built by both packages: (jax, torch)."""
    out = []
    for lm in (jlm, tlm):
        alphabet = lm.PROTEIN if protein else lm.DNA
        cm = lm.CountMatrix(alphabet, counts)
        out.append(cm.to_freq(pseudo).to_weight(None).to_scoring())
    return tuple(out)


def sequences(data, protein: bool = False):
    """The same encoded sequence in both packages: (jax, torch)."""
    data = np.asarray(data, dtype=np.uint8)
    return tuple(
        lm.EncodedSequence(data, lm.PROTEIN if protein else lm.DNA)
        for lm in (jlm, tlm))


def random_ranks(rng, length: int, k: int, wildcard_runs: int = 0) -> np.ndarray:
    """Random ranks below the wildcard, with a few wildcard runs."""
    data = rng.integers(0, k - 1, size=length).astype(np.uint8)
    for start in rng.integers(0, max(length - 1, 1), size=wildcard_runs):
        data[start : start + int(rng.integers(1, 40))] = k - 1
    return data


def hit_keys(hits) -> list:
    """(position, score bits) of each hit, in the order given."""
    return [(h.position, int(bits(h.score))) for h in hits]


#: Pallas interpret-mode geometry: 8 chunks x 128 lanes x 2 blocks.
BL = 128
LP = jax_kernels.CHUNKS * BL * 2


@pytest.fixture(autouse=True)
def interpret_mode():
    jax_kernels.INTERPRET = True
    jax.clear_caches()  # the flag is baked into traced executables
    yield
    jax_kernels.INTERPRET = False
    jax.clear_caches()


#: (K, m, sequence length or None for a ragged near-full length)
KERNEL_CASES = [
    (5, 1, None),
    (5, 2, None),
    (5, 15, None),
    (5, 33, None),
    (5, 129, None),
    (21, 1, None),
    (21, 10, None),
    (21, 40, None),
    (5, 33, 20),  # sequence shorter than the motif
]


def kernel_inputs(k: int, m: int, length, seed: int):
    """A padded ``[LP]`` sequence with wildcard runs, an f32 table with
    ``-inf`` cells, a u8 table and a ragged ``n_scores``."""
    rng = np.random.default_rng(seed)
    if length is None:
        length = LP - int(rng.integers(0, 200))
    flat = np.full(LP, k - 1, np.uint8)
    flat[:length] = rng.integers(0, k, size=length)
    for start in rng.integers(0, max(length - 1, 1), size=6):  # wildcard runs
        flat[start : min(start + int(rng.integers(1, 60)), length)] = k - 1
    w = rng.normal(size=(m, k)).astype(np.float32)
    w[rng.random((m, k)) < 0.1] = -np.inf
    dm = rng.integers(0, 256, size=(m, k)).astype(np.uint8)
    # ragged: a few valid windows short of the last
    n_scores = max(length - m + 1 - int(rng.integers(0, 100)), 0)
    return flat, w, dm, n_scores
