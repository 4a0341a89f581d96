"""The port's ``Pipeline`` on the CPU against the JAX package's.

``Pipeline(device="cpu")`` runs the kernel wrappers' plain versions;
its f32 scores, discrete scores and ``score_max`` must be bit-identical
to ``lightmotif_tpu``'s, including the last-max tie rule.
"""

import numpy as np
import pytest
import torch

import lightmotif_tpu as jlm
import lightmotif_tpu_torch as tlm
from lightmotif_tpu.ops.pipeline import Pipeline as JaxPipeline
from lightmotif_tpu_torch import batch
from lightmotif_tpu_torch.ops import pipeline as tpipeline
from lightmotif_tpu_torch.ops.pipeline import Pipeline
from lightmotif_tpu_torch.scanner import MultiScanner

from .data import EXPECTED, PATTERNS, SEQUENCE
from .torch_parity import (  # noqa: F401  (cpu_choice is a fixture)
    bits, cpu_choice, pssms, random_counts, random_ranks, sequences)

#: (protein, m, sequence length, pseudocount)
CASES = [
    (False, 15, 3000, 0.1),
    (False, 15, 3000, 0.0),
    (False, 1, 500, 0.1),
    (False, 40, 2500, 0.1),
    (True, 10, 2000, 0.1),
    (False, 15, 9, 0.1),  # shorter than the motif
]


def _case(protein, m, length, pseudo, seed):
    k = 21 if protein else 5
    rng = np.random.default_rng(seed)
    jp, tp = pssms(random_counts(rng, m, k), protein=protein, pseudo=pseudo)
    js, ts = sequences(random_ranks(rng, length, k, wildcard_runs=5), protein)
    return jp, tp, js, ts


@pytest.mark.parametrize("protein,m,length,pseudo", CASES)
def test_score_and_score_discrete_match_jax(protein, m, length, pseudo):
    jp, tp, js, ts = _case(protein, m, length, pseudo, seed=m + length)
    jpipe, tpipe = JaxPipeline(), Pipeline(device="cpu")
    got, want = tpipe.score(tp, ts), jpipe.score(jp, js)
    assert len(got) == len(want) == max(length - m + 1, 0)
    assert np.array_equal(bits(got.unstripe().data), bits(want.unstripe().data))
    dgot = tpipe.score_discrete(tp.to_discrete(), ts)
    dwant = jpipe.score_discrete(jp.to_discrete(), js)
    assert np.array_equal(dgot.unstripe().data, dwant.unstripe().data)
    assert got.argmax() == want.argmax()


@pytest.mark.parametrize("protein,m,length,pseudo", CASES)
def test_max_argmax_threshold_match_jax(protein, m, length, pseudo):
    """``Pipeline.max``, ``argmax`` and ``threshold`` of the same scores
    as the JAX ``Pipeline``'s, the last maximum winning ties."""
    jp, tp, js, ts = _case(protein, m, length, pseudo, seed=m + 7 * length)
    jpipe, tpipe = JaxPipeline(), Pipeline(device="cpu")
    got, want = tpipe.score(tp, ts), jpipe.score(jp, js)
    if length < m:
        assert tpipe.max(got) is jpipe.max(want) is None
        assert tpipe.argmax(got) is jpipe.argmax(want) is None
        assert tpipe.threshold(got, 0.0) == jpipe.threshold(want, 0.0) == []
        return
    assert bits(tpipe.max(got)) == bits(jpipe.max(want))
    assert tpipe.argmax(got) == jpipe.argmax(want)
    host = got.unstripe().data
    for value in (float(np.median(host)), float(host.max()), float("-inf")):
        assert tpipe.threshold(got, value) == jpipe.threshold(want, value)
    assert tpipe.threshold(got, float(host.max())) == np.nonzero(host == host.max())[0].tolist()


@pytest.mark.parametrize("protein,m,length,pseudo", CASES)
def test_score_max_matches_jax(protein, m, length, pseudo):
    jp, tp, js, ts = _case(protein, m, length, pseudo, seed=m * length + 1)
    got = Pipeline(device="cpu").score_max(tp, ts)
    want = JaxPipeline().score_max(jp, js)
    if want == (None, None):
        assert got == want
        return
    assert bits(got[0]) == bits(want[0]) and got[1] == want[1]


def test_score_max_exact_tie_takes_the_last_maximum():
    rng = np.random.default_rng(21)
    data = random_ranks(rng, 600, 5)
    site = jlm.EncodedSequence.encode(PATTERNS[0]).data
    for pos in (100, 377):  # the same best window twice
        data[pos : pos + site.size] = site
    counts = jlm.CountMatrix.from_sequences(
        jlm.EncodedSequence.encode(p) for p in PATTERNS).data
    jp, tp = pssms(counts)
    js, ts = sequences(data)
    host = tp.score_host(ts)
    assert (host == host.max()).sum() >= 2
    last = int(np.nonzero(host == host.max())[0][-1])
    got = Pipeline(device="cpu").score_max(tp, ts)
    assert got == JaxPipeline().score_max(jp, js)
    assert got[1] == last == 377
    assert Pipeline(device="cpu").score(tp, ts).argmax() == last


def test_score_max_all_neginf_takes_the_last_window():
    data = np.full((4, 5), -np.inf, np.float32)
    jp = jlm.ScoringMatrix(jlm.DNA, data)
    tp = tlm.ScoringMatrix(tlm.DNA, data)
    js, ts = sequences(np.random.default_rng(2).integers(0, 4, size=300))
    got = Pipeline(device="cpu").score_max(tp, ts)
    assert got == JaxPipeline().score_max(jp, js)
    assert got == (-np.inf, 300 - 4)


@pytest.mark.usefixtures("cpu_choice")
def test_scoring_matrix_score_on_text_and_striped():
    jp, tp = pssms(jlm.CountMatrix.from_sequences(
        jlm.EncodedSequence.encode(p) for p in PATTERNS).data)
    for seq in (SEQUENCE, tlm.stripe(SEQUENCE)):
        jseq = SEQUENCE if isinstance(seq, str) else jlm.stripe(SEQUENCE)
        got = tp.score(seq)
        assert isinstance(got, tlm.StripedScores)
        assert np.array_equal(bits(got.unstripe().data),
                              bits(jp.score(jseq).unstripe().data))
        assert got.argmax() == 18
        np.testing.assert_allclose(got.unstripe().data, EXPECTED, atol=1e-5)


def test_device_is_explicit():
    _, tp, _, ts = _case(False, 4, 50, 0.1, seed=0)
    assert Pipeline(device="cpu").device.type == "cpu"
    assert tlm.Scanner(tp, ts, device="cpu").device.type == "cpu"


@pytest.fixture
def no_card(monkeypatch):
    """No CUDA device, and no device chosen for the process."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tpipeline.use_device(None)
    yield
    tpipeline.use_device(None)


#: Every entry point that takes a device, called without one.
ENTRY_POINTS = {
    "Pipeline": lambda tp, ts: Pipeline(),
    "Scanner": lambda tp, ts: tlm.Scanner(tp, ts),
    "scan": lambda tp, ts: tlm.scan(tp, ts),
    "MultiScanner": lambda tp, ts: MultiScanner([tp], ts, 0.0),
    "BatchScanner": lambda tp, ts: batch.BatchScanner(tp, [ts, ts]),
    "BatchReducer": lambda tp, ts: batch.BatchReducer(tp, [ts, ts]),
    "MultiBatchScanner": lambda tp, ts: batch.MultiBatchScanner([tp], [ts, ts]),
    "ScoringMatrix.score": lambda tp, ts: tp.score(ts),
    "pipeline.score": lambda tp, ts: tpipeline.score(tp, ts),
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_no_card_and_no_choice_raises(no_card, entry):
    _, tp, _, ts = _case(False, 4, 50, 0.1, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device.*device='cpu'"):
        ENTRY_POINTS[entry](tp, ts)


def test_use_device_is_the_explicit_process_wide_choice(no_card):
    jp, tp, js, ts = _case(False, 4, 50, 0.1, seed=0)
    tpipeline.use_device("cpu")
    assert Pipeline().device == torch.device("cpu")
    assert tlm.Scanner(tp, ts).device == torch.device("cpu")
    assert np.array_equal(bits(tp.score(ts).unstripe().data),
                          bits(jp.score(js).unstripe().data))
    tpipeline.use_device(None)  # cleared: no silent fallback again
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.score(ts)
