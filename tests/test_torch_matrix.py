"""The port's matrix chain and score distribution against the JAX package.

The same counts go through ``lightmotif_tpu`` and ``lightmotif_tpu_torch``;
every stage's data, the discrete scale, and the MEME p-value threshold
must be identical (f32 compared as bits, so ``-inf`` cells count).
"""

import numpy as np
import pytest

import lightmotif_tpu as jlm
import lightmotif_tpu_torch as tlm
from lightmotif_tpu_torch import convert

from .data import MA0045_COUNTS
from .torch_parity import bits, pssms, random_counts

#: (protein, m, pseudocount); pseudocount 0 gives -inf cells
CHAIN_CASES = [
    (False, 15, 0.1),
    (False, 15, 0.0),
    (False, 1, 0.1),
    (True, 12, 0.1),
    (True, 12, 0.0),
]


def _chain(lm, counts, protein, pseudo):
    cm = lm.CountMatrix(lm.PROTEIN if protein else lm.DNA, counts)
    freq = cm.to_freq(pseudo)
    weight = freq.to_weight(None)
    scoring = weight.to_scoring()
    return [cm, freq, weight, scoring, scoring.to_discrete()]


def _same_data(a, b):
    if a.data.dtype == np.float32:
        return np.array_equal(bits(a.data), bits(b.data))
    return a.data.dtype == b.data.dtype and np.array_equal(a.data, b.data)


@pytest.mark.parametrize("protein,m,pseudo", CHAIN_CASES)
def test_chain_is_identical(protein, m, pseudo):
    k = 21 if protein else 5
    counts = random_counts(np.random.default_rng(m * 7 + k), m, k)
    if pseudo == 0.0:
        counts[0, 1] = 0  # a zero count -> a -inf log-odds cell
    jax_chain = _chain(jlm, counts, protein, pseudo)
    torch_chain = _chain(tlm, counts, protein, pseudo)
    for j, t in zip(jax_chain, torch_chain):
        assert _same_data(j, t), type(t).__name__
    jdm, tdm = jax_chain[-1], torch_chain[-1]
    assert bits(jdm.factor) == bits(tdm.factor)
    assert np.array_equal(bits(jdm.offsets), bits(tdm.offsets))
    assert bits(jdm.offset) == bits(tdm.offset)
    if pseudo == 0.0:
        assert np.isneginf(torch_chain[3].data).any()


@pytest.mark.parametrize("protein,m,pseudo", CHAIN_CASES)
def test_score_distribution_is_identical(protein, m, pseudo):
    k = 21 if protein else 5
    counts = random_counts(np.random.default_rng(m * 11 + k), m, k)
    if pseudo == 0.0:
        counts[0, 1] = 0
    jp, tp = pssms(counts, protein=protein, pseudo=pseudo)
    jd, td = jp.score_distribution(), tp.score_distribution()
    for p in (1e-5, 1e-3, 0.5):
        assert bits(jd.score(p)) == bits(td.score(p)), p
        assert bits(jp.score_for_pvalue(p)) == bits(tp.score_for_pvalue(p))
    assert np.array_equal(jd.sf(), td.sf())
    s = float(td.score(1e-4))
    assert jp.pvalue(s) == tp.pvalue(s)


def test_ma0045_golden_chain():
    jp = jlm.CountMatrix(jlm.DNA, MA0045_COUNTS).to_freq(0.25).to_scoring(None)
    tp = tlm.CountMatrix(tlm.DNA, MA0045_COUNTS).to_freq(0.25).to_scoring(None)
    assert np.array_equal(bits(jp.data), bits(tp.data))
    assert bits(jp.min_score()) == bits(tp.min_score())
    assert bits(jp.max_score()) == bits(tp.max_score())


@pytest.mark.parametrize("protein", [False, True])
def test_convert_round_trips_a_jax_matrix(protein):
    k = 21 if protein else 5
    counts = random_counts(np.random.default_rng(5 + k), 9, k)
    jp, _ = pssms(counts, protein=protein, pseudo=0.0)
    jdm = jp.to_discrete()

    arrays = convert.arrays(jp)
    tp = convert.scoring_matrix(**arrays)
    assert isinstance(tp, tlm.ScoringMatrix)
    assert tp.alphabet.name == jp.alphabet.name
    assert np.array_equal(bits(tp.data), bits(jp.data))
    assert np.array_equal(tp.background.frequencies, jp.background.frequencies)
    back = convert.arrays(tp)
    assert back.keys() == arrays.keys()
    assert all(np.array_equal(back[key], arrays[key]) for key in arrays)

    tdm = convert.discrete_matrix(**convert.arrays(jdm))
    assert isinstance(tdm, tlm.DiscreteMatrix)
    assert np.array_equal(tdm.data, jdm.data)
    assert (tdm.factor, tdm.offset) == (jdm.factor, jdm.offset)
    assert np.array_equal(bits(tdm.offsets), bits(jdm.offsets))
    # the converted scoring matrix discretizes like the JAX one
    assert np.array_equal(tp.to_discrete().data, jdm.data)


def test_convert_rejects_an_unknown_alphabet():
    with pytest.raises(ValueError):
        convert.scoring_matrix("rna", np.zeros((2, 5), np.float32), np.zeros(5))
