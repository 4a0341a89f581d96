"""The port's exact TFM-PVALUE (``lightmotif_tpu_torch.tfmpvalue``) against
the JAX package's on every case of ``tests/test_tfmpvalue.py``: the same
matrices give the same iterations, p-values and scores, compared with
``==`` (host float64 and Python integers in both)."""

import numpy as np
import pytest

import lightmotif_tpu as jlm
import lightmotif_tpu_torch as tlm
from lightmotif_tpu.tfmpvalue import TfmPvalue as JaxTfmPvalue
from lightmotif_tpu_torch.tfmpvalue import TfmPvalue

from .data import MA0045_COUNTS
from .torch_parity import bits


def both(counts, pseudo, background=None):
    """The same scoring matrix in both packages: (jax, torch)."""
    return tuple(lm.CountMatrix(lm.DNA, counts).to_freq(pseudo).to_scoring(background)
                 for lm in (jlm, tlm))


def random_matrix(rng, m: int, top: int):
    counts = rng.integers(0, top, size=(m, 4))
    return np.concatenate([counts, np.zeros((m, 1), int)], axis=1).tolist()


def iterations(tfmp, method: str, arg, stop=None) -> list:
    out = []
    for it in getattr(tfmp, method)(arg):
        out.append((it.score, it.range, it.granularity, it.converged))
        if stop is not None and stop(it):
            break
    return out


@pytest.fixture(scope="module")
def ma0045():
    jax_pssm, torch_pssm = both(MA0045_COUNTS, 0.25)
    assert np.array_equal(bits(jax_pssm.data), bits(torch_pssm.data))
    return jax_pssm, torch_pssm


def test_the_port_keeps_its_own_copy():
    assert TfmPvalue is not JaxTfmPvalue
    assert TfmPvalue.__module__ == "lightmotif_tpu_torch.tfmpvalue"


@pytest.mark.parametrize("method,arg", [("approximate_pvalue", 10.0),
                                        ("approximate_score", 1e-5),
                                        ("approximate_score", 3e-4)])
def test_iterations_are_identical(ma0045, method, arg):
    jax_pssm, torch_pssm = ma0045
    want = iterations(JaxTfmPvalue(jax_pssm), method, arg)
    got = iterations(TfmPvalue(torch_pssm), method, arg)
    assert got == want
    assert got[-1][3] and not got[0][3]
    if method == "approximate_pvalue":
        assert len(got) == 7 and got[-1][2] == pytest.approx(1e-7)


@pytest.mark.parametrize("score", [8.882756, 12.657785, 19.1])
def test_pvalue(ma0045, score):
    jax_pssm, torch_pssm = ma0045
    got = TfmPvalue(torch_pssm).pvalue(score)
    assert got == JaxTfmPvalue(jax_pssm).pvalue(score)
    assert got == torch_pssm.pvalue(score, method="tfmpvalue")


@pytest.mark.parametrize("pvalue", [1e-5, 3e-4, 1e-10])
def test_score(ma0045, pvalue):
    jax_pssm, torch_pssm = ma0045
    got = TfmPvalue(torch_pssm).score(pvalue)
    assert got == JaxTfmPvalue(jax_pssm).score(pvalue)
    assert got == torch_pssm.score_for_pvalue(pvalue, method="tfmpvalue")


def test_matrix_methods_match_and_cache(ma0045):
    jax_pssm, torch_pssm = ma0045
    for score in (8.882756, 12.657785):
        assert (torch_pssm.pvalue(score, method="tfmpvalue")
                == jax_pssm.pvalue(score, method="tfmpvalue"))
    assert (torch_pssm.score_for_pvalue(1e-5, method="tfmpvalue")
            == jax_pssm.score_for_pvalue(1e-5, method="tfmpvalue"))
    assert torch_pssm.score(1e-5, method="tfmpvalue") == jax_pssm.score(
        1e-5, method="tfmpvalue")
    assert torch_pssm._tfmp() is torch_pssm._pipeline_cache["tfmp"]
    # the MEME distribution stays the default
    assert torch_pssm.pvalue(12.657785) == jax_pssm.pvalue(12.657785)


@pytest.mark.parametrize("call", ["pvalue", "score_for_pvalue"])
def test_unknown_method_raises(ma0045, call):
    with pytest.raises(ValueError, match="unknown method"):
        getattr(ma0045[1], call)(1e-5, method="exact")


def test_wide_matrix_fine_granularity():
    counts = random_matrix(np.random.default_rng(7), 20, 40)
    jax_pssm, torch_pssm = both(counts, 0.1)
    score = 0.8 * float(np.asarray(torch_pssm.data)[:, :4].max(axis=1).sum())
    stop = lambda it: it.granularity <= 1e-5  # noqa: E731
    got = iterations(TfmPvalue(torch_pssm), "approximate_pvalue", score, stop)
    assert got == iterations(JaxTfmPvalue(jax_pssm), "approximate_pvalue", score, stop)
    lo, hi = got[-1][1]
    assert 0.0 < lo <= hi < 1.0 and got[-1][2] <= 1e-5


@pytest.mark.parametrize("trial", range(5))
def test_roundtrip(trial):
    rng = np.random.default_rng(42 + trial)
    counts = random_matrix(rng, int(rng.integers(4, 12)), 25)
    jax_pssm, torch_pssm = both(counts, 0.1)
    mine, theirs = TfmPvalue(torch_pssm), JaxTfmPvalue(jax_pssm)
    data = np.asarray(torch_pssm.data)[:, :4]
    smax, smin = float(data.max(axis=1).sum()), float(data.min(axis=1).sum())
    for f in (0.55, 0.7, 0.85):
        s = smin + f * (smax - smin)
        p = mine.pvalue(s)
        assert p == theirs.pvalue(s)
        if p > 0.0:
            s_back = mine.score(p)
            assert s_back == theirs.score(p)
            assert mine.pvalue(s_back) == theirs.pvalue(s_back) >= p * (1.0 - 1e-9)


def test_doctest_example():
    counts = [[1, 0, 1, 0, 0], [0, 1, 1, 0, 0], [0, 0, 0, 2, 0], [0, 0, 2, 0, 0]]
    jax_pssm, torch_pssm = both(counts, 0.1)
    stop = lambda it: it.converged or it.granularity <= 0.001  # noqa: E731
    got = iterations(TfmPvalue(torch_pssm), "approximate_pvalue", 10.0, stop)
    assert got == iterations(JaxTfmPvalue(jax_pssm), "approximate_pvalue", 10.0, stop)
    assert 0.0 <= got[-1][1][0] <= 1.0


def test_neg_inf_cells_saturate_like_the_reference():
    """A zero pseudocount gives -inf cells, which the DP's integer matrix
    saturates to i64::MIN (the dictionary path)."""
    counts = [[3, 0, 1, 0, 0], [0, 2, 2, 0, 0], [4, 0, 0, 0, 0]]
    jax_pssm, torch_pssm = both(counts, 0.0)
    assert np.isneginf(torch_pssm.data).any()
    mine, theirs = TfmPvalue(torch_pssm), JaxTfmPvalue(jax_pssm)
    for score in (-5.0, 0.0, 2.5):
        assert iterations(mine, "approximate_pvalue", score) == iterations(
            theirs, "approximate_pvalue", score)
    mine._recompute(0.1)
    # a row with a saturated cell is offset by about 2**63
    assert max(mine.offsets) > 2**62
