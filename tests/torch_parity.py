"""Shared helpers of the parity tests between ``lightmotif_tpu_torch``
and ``lightmotif_tpu``: the same numpy inputs, made from a seed, built
into each package's objects."""

import jax
import numpy as np
import pytest

import lightmotif_tpu as jlm
import lightmotif_tpu_torch as tlm
from lightmotif_tpu.ops import kernels as jax_kernels
from lightmotif_tpu_torch.ops import pipeline as tpipeline


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


@pytest.fixture
def cpu_choice():
    """Run the port's device-less entry points (``ScoringMatrix.score``,
    ``pipeline.score``, a ``scan`` given no device) on the CPU, chosen
    explicitly for the test's duration."""
    tpipeline.use_device("cpu")
    yield
    tpipeline.use_device(None)


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


def random_motifs(rng, widths, protein: bool = False, pseudo=0.1):
    """JAX-package scoring matrices of random counts, one per width, in
    the order given."""
    k = 21 if protein else 5
    alphabet = jlm.PROTEIN if protein else jlm.DNA
    return [jlm.CountMatrix(alphabet, random_counts(rng, w, k))
            .to_freq(pseudo).to_weight(None).to_scoring() for w in widths]


def motif_stack(motifs):
    """``(stack [M, m_max, K] f32, lengths)`` of JAX-package matrices."""
    from lightmotif_tpu.ops import multi as jmulti

    k = motifs[0].alphabet.size
    return jmulti.stack_motifs([np.asarray(p.data, np.float32) for p in motifs], k)


def assert_same_arrays(got, want, what=""):
    """Same dtype, shape and bytes (tuples and None compare as values)."""
    if isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert got.dtype == want.dtype and got.shape == want.shape, (
            what, got.dtype, got.shape, want.dtype, want.shape)
        assert got.tobytes() == want.tobytes(), what
    else:
        assert got == want, what


def multi_triples(arrays) -> list:
    """(motif, position, score bits) of ``collect_arrays()`` output,
    after checking the dtypes both packages give."""
    motif_ids, positions, scores = arrays
    assert motif_ids.dtype == np.int32 and positions.dtype == np.int64
    assert scores.dtype == np.float32
    return list(zip(motif_ids.tolist(), positions.tolist(), bits(scores).tolist()))
