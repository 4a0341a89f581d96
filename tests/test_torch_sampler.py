"""The port's Gibbs samplers (``lightmotif_tpu_torch.sampler`` and
``sampler_batch``) against the JAX package's.

The host sampler draws from numpy's ``Generator`` in both packages and
scores hold-outs with bit-identical f32 sums, so for the same seed its
trajectories (hold-out, starts, active set, counts) must be identical,
step by step: with the default ``DEVICE_THRESHOLD``, and with it lowered
in both modules so that hold-outs go through each package's pipeline (the
port's on the CPU, chosen explicitly).

The batched sampler draws from a ``torch.Generator``, which cannot
reproduce JAX's threefry stream, so its parity is: the step functions
equal JAX's on the same inputs (counts exact, the PSSM within 2 ulp, its
information content within 4 ulp of the sum of its terms' magnitudes,
hold-out scores bit-identical given the same PSSM), the batched step math replays the host sampler under forced
draws, planted motifs are recovered, and a seeded run resumes
bit-identically.
"""

import numpy as np
import pytest
import torch

import lightmotif_tpu as jlm
import lightmotif_tpu_torch as tlm
from lightmotif_tpu import sampler as jsampler
from lightmotif_tpu import sampler_batch as jbatch
from lightmotif_tpu_torch import sampler as tsampler
from lightmotif_tpu_torch import sampler_batch as tbatch

from .test_sampler import PROTEIN_SEQS
from .torch_parity import bits

MOTIF = "GTTGACCTTATCAAC"


def planted(rng, count: int, lengths, motif: str = MOTIF):
    """Random DNA strings with ``motif`` planted once in each; returns
    (strings, planted positions)."""
    seqs, where = [], []
    for _ in range(count):
        n = int(rng.integers(*lengths)) if isinstance(lengths, tuple) else lengths
        s = list("".join("ACGT"[c] for c in rng.integers(0, 4, size=n)))
        pos = int(rng.integers(0, n - len(motif)))
        s[pos:pos + len(motif)] = list(motif)
        seqs.append("".join(s))
        where.append(pos)
    return seqs, where


def data_of(lm, strings, protein=False):
    alphabet = lm.PROTEIN if protein else lm.DNA
    return lm.sampler.SamplerData([lm.EncodedSequence.encode(s, alphabet) for s in strings])


def trajectory(lm, strings, steps, seed, protein=False, **kw):
    """(z, starts, active, motif counts, background counts) of every step."""
    sampler = lm.sampler.Sampler(data_of(lm, strings, protein),
                                 rng=np.random.default_rng(seed), **kw)
    out = []
    for _, it in zip(range(steps), sampler):
        out.append((it.z, tuple(sampler.starts), sampler.active.tobytes(),
                    sampler.motif.tobytes(), sampler.background_counts.tobytes(),
                    bits(it.pssm.data).tobytes()))
    return out, sampler


#: (name, strings, protein, Sampler keywords): OOPS and ZOOPS, with
#: seeds, inertia, patience and a temperature other than 1
HOST_CASES = [
    ("oops-protein", PROTEIN_SEQS, True, dict(width=17)),
    ("oops-dna-T", None, False, dict(width=15, temperature=1.7)),
    ("zoops-protein", PROTEIN_SEQS, True,
     dict(width=17, mode="zoops", seeds=5, inertia=10, patience=10)),
    ("zoops-dna-T", None, False,
     dict(width=12, mode="zoops", seeds=3, inertia=8, patience=25, temperature=0.8)),
]


def host_case(name):
    _, strings, protein, kw = next(c for c in HOST_CASES if c[0] == name)
    if strings is None:
        strings, _ = planted(np.random.default_rng(31), 14, (40, 200))
    return strings, protein, kw


@pytest.mark.parametrize("threshold", [None, 64], ids=["default", "pipeline"])
@pytest.mark.parametrize("name", [c[0] for c in HOST_CASES])
def test_host_trajectories_are_identical(name, threshold, monkeypatch):
    strings, protein, kw = host_case(name)
    if threshold is not None:
        monkeypatch.setattr(jsampler, "DEVICE_THRESHOLD", threshold)
        monkeypatch.setattr(tsampler, "DEVICE_THRESHOLD", threshold)
    want, _ = trajectory(jlm, strings, 60, seed=42, protein=protein, **kw)
    got, sampler = trajectory(tlm, strings, 60, seed=42, protein=protein,
                              device="cpu", **kw)
    assert len(got) == len(want) and got == want
    long = [i for i, s in enumerate(strings) if len(s) >= tsampler.DEVICE_THRESHOLD]
    # the pipeline path ran (and uploaded each long hold-out once)
    assert sorted(sampler._uploaded) == sorted({z for z, *_ in got} & set(long))
    if threshold is not None and not protein:
        assert sampler._uploaded and sampler._pipeline.device == torch.device("cpu")


def test_long_holdouts_need_a_device_choice(monkeypatch):
    """A hold-out past the threshold goes to the pipeline, which never
    falls back to the CPU by itself."""
    monkeypatch.setattr(tsampler, "DEVICE_THRESHOLD", 64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    strings, _ = planted(np.random.default_rng(2), 4, 100)
    sampler = tsampler.Sampler(data_of(tlm, strings), width=8, rng=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(sampler)


def test_sample_motifs_matches():
    strings, _ = planted(np.random.default_rng(8), 10, (30, 80))
    a = jsampler.sample_motifs(strings, width=10, steps=25, rng=5)
    b = tsampler.sample_motifs(strings, width=10, steps=25, rng=5, device="cpu")
    assert (a.z, a.step) == (b.z, b.step)
    assert np.array_equal(a.counts.data, b.counts.data)
    assert np.array_equal(bits(a.pssm.data), bits(b.pssm.data))
    assert a.pssm.information_content() == b.pssm.information_content()


def test_planted_motif_recovery():
    from collections import Counter

    strings, where = planted(np.random.default_rng(5), 20, 60)
    sampler = tsampler.Sampler(data_of(tlm, strings), width=15,
                               rng=np.random.default_rng(11), device="cpu")
    last = None
    for _, last in zip(range(300), sampler):
        pass
    shifts = Counter(s - p for s, p in zip(sampler.starts, where))
    shift, hits = shifts.most_common(1)[0]
    assert abs(shift) <= 3, shifts
    assert hits >= 15, (sampler.starts, where)
    assert last.pssm.information_content() > 10


def test_width_too_large():
    data = tsampler.SamplerData([tlm.EncodedSequence.encode("ACGT")])
    with pytest.raises(ValueError, match="shorter than motif width"):
        tsampler.Sampler(data, width=10)


# -- the batched sampler's step functions --------------------------------------


def batch_inputs(seqs, width, k=5):
    n = len(seqs)
    lp = max(len(s) for s in seqs)
    mat = np.full((n, lp), k - 1, np.uint8)
    totals = np.zeros((n, k), np.float32)
    valid = np.zeros(n, np.int32)
    for i, s in enumerate(seqs):
        mat[i, : len(s)] = s
        totals[i] = np.bincount(s, minlength=k).astype(np.float32)
        valid[i] = len(s) - width + 1
    return mat, totals, valid


def ulps(a, b) -> int:
    """The largest distance in f32 units in the last place between two
    arrays whose non-finite cells are identical."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    fin = np.isfinite(a)
    assert np.array_equal(fin, np.isfinite(b))
    assert np.array_equal(bits(a[~fin]), bits(b[~fin]))
    if not fin.any():
        return 0
    ia = a[fin].view(np.int32).astype(np.int64)
    ib = b[fin].view(np.int32).astype(np.int64)
    # a signed-magnitude float orders as an integer once its sign is folded
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int(np.abs(ia - ib).max())


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_step_functions_match_jax(seed):
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    width, k, n, chains = 8, 5, 9, 6
    seqs = [rng.integers(0, 4, size=int(rng.integers(30, 90))).astype(np.uint8)
            for _ in range(n)]
    if seed == 7:
        seqs[3][10:20] = 4  # wildcards in a sequence
        seqs = [s % 2 for s in seqs]  # two symbols only: zero backgrounds
    mat, totals, valid = batch_inputs(seqs, width, k)
    starts = np.stack([rng.integers(0, valid) for _ in range(chains)]).astype(np.int32)
    active = (rng.random((chains, n)) < 0.7).astype(np.float32)

    jc, jb = jbatch.counts_of(jnp.asarray(mat), jnp.asarray(totals),
                              jnp.asarray(starts), jnp.asarray(active), width, k)
    tc, tb = tbatch.counts_of(torch.from_numpy(mat), torch.from_numpy(totals),
                              torch.from_numpy(starts), torch.from_numpy(active), width, k)
    assert np.array_equal(np.asarray(jc), tc.numpy())
    assert np.array_equal(np.asarray(jb), tb.numpy())

    jp, jic = jbatch.pssm_of(jc, jb, k)
    tp, tic = tbatch.pssm_of(tc, tb, k)
    assert ulps(np.asarray(jp), tp.numpy()) <= 2
    # the information content sums w * K terms that may cancel, each
    # within 2 ulp: held to 4 ulp of the sum of their magnitudes
    fr = tc.numpy() + np.array([0.1, 0.1, 0.1, 0.1, 0.0], np.float32)
    fr = fr / fr.sum(-1, keepdims=True)
    with np.errstate(invalid="ignore"):
        mag = np.where(np.isfinite(tp.numpy()), np.abs(fr * tp.numpy()), 0.0)
    scale = np.spacing(mag.sum(axis=(1, 2)).astype(np.float32))
    assert (np.abs(np.asarray(jic, np.float64) - tic.numpy()) <= 4 * scale).all()
    if seed == 7:
        assert np.isneginf(tp.numpy()).any()

    # the hold-out scores, given the same PSSM, are bit-identical
    z = rng.integers(0, n, size=chains)
    js = jbatch.score_holdouts(jnp.asarray(mat)[z], jp, jnp.asarray(valid)[z], width, k)
    ts = tbatch.score_holdouts(torch.from_numpy(mat)[z], torch.from_numpy(np.array(jp)),
                               torch.from_numpy(valid)[z], width, k)
    assert np.array_equal(bits(np.asarray(js)), bits(ts.numpy()))


def test_holdout_scores_equal_the_host_oracle():
    rng = np.random.default_rng(5)
    seqs = [tlm.EncodedSequence(rng.integers(0, 4, size=60, dtype=np.uint8))
            for _ in range(6)]
    width, k = 8, 5
    host = tsampler.Sampler(tsampler.SamplerData(seqs), width=width,
                            rng=np.random.default_rng(3))
    host.starts = [3, 11, 0, 52, 20, 7]
    host.motif[:] = 0
    host.background_counts[:] = 0
    for i in range(6):
        host._add_counts(i, +1)
    z = 2
    host._exclude(z)
    counts_h, pssm_h = host._prepare_pssm()
    mat, totals, valid = batch_inputs([s.data for s in seqs], width)
    act = torch.from_numpy((np.arange(6) != z).astype(np.float32)[None])
    counts_b, bgc_b = tbatch.counts_of(torch.from_numpy(mat), torch.from_numpy(totals),
                                       torch.tensor([host.starts]), act, width, k)
    assert np.array_equal(counts_b[0].numpy(), counts_h.data.astype(np.float32))
    assert np.array_equal(bgc_b[0].numpy(), host.background_counts.astype(np.float32))
    scores = tbatch.score_holdouts(torch.from_numpy(mat[z][None]),
                                   torch.from_numpy(pssm_h.data)[None],
                                   torch.tensor([valid[z]]), width, k)
    assert np.array_equal(bits(scores[0].numpy()), bits(pssm_h.score_host(seqs[z])))


def test_categorical_never_draws_neg_inf():
    g = torch.Generator().manual_seed(0)
    logits = torch.full((64, 50), float("-inf"))
    logits[:, 7] = -3.0
    logits[:, 30] = 2.0
    draws = tbatch.categorical(logits, g)
    assert set(draws.tolist()) <= {7, 30}
    assert (draws == 30).sum() > (draws == 7).sum()


def test_batch_step_trajectory_matches_host_forced_draws():
    """5 OOPS steps with identical forced draws: the batched step math,
    driven step by step, lands on the host sampler's counts and starts."""
    rng = np.random.default_rng(11)
    seqs = [tlm.EncodedSequence(rng.integers(0, 4, size=40, dtype=np.uint8))
            for _ in range(5)]
    width, k = 6, 5
    forced_z = [1, 4, 0, 2, 3]
    forced_pick = [7, 0, 21, 13, 30]

    class ForcedRng:
        def __init__(self):
            self.z_it = iter(forced_z)
            self.pick_it = iter(forced_pick)

        def integers(self, lo, hi):
            return next(self.z_it)

        def choice(self, n, p=None):
            return next(self.pick_it)

    host = tsampler.Sampler(tsampler.SamplerData(seqs), width=width,
                            rng=np.random.default_rng(0))
    host.rng = ForcedRng()
    init_starts = list(host.starts)
    for _ in range(5):
        next(host)

    mat, totals, valid = (torch.from_numpy(a) for a in
                          batch_inputs([s.data for s in seqs], width))
    starts_b = torch.tensor([init_starts])
    for z, pick in zip(forced_z, forced_pick):
        act = torch.from_numpy((np.arange(5) != z).astype(np.float32)[None])
        counts_b, bgc_b = tbatch.counts_of(mat, totals, starts_b, act, width, k)
        pssm_b, _ = tbatch.pssm_of(counts_b, bgc_b, k)
        scores_b = tbatch.score_holdouts(mat[z][None], pssm_b, valid[z][None], width, k)
        assert torch.isfinite(scores_b[0, pick])
        starts_b = starts_b.clone()
        starts_b[0, z] = pick
    assert starts_b[0].tolist() == host.starts
    counts_b, _ = tbatch.counts_of(mat, totals, starts_b, torch.ones((1, 5)), width, k)
    assert np.array_equal(counts_b[0].numpy(), host.count_matrix().data.astype(np.float32))


# -- the batched sampler's runs --------------------------------------------------


def aligned(consensus: str, motif: str, max_shift: int = 2) -> int:
    """Most positions of ``consensus`` equal to ``motif`` shifted by at
    most ``max_shift`` (a Gibbs sampler without phase-shift moves may
    settle one or two positions off the planted alignment)."""
    return max(sum(consensus[i] == motif[i + d] for i in range(len(consensus))
                   if 0 <= i + d < len(motif))
               for d in range(-max_shift, max_shift + 1))


def test_batched_oops_recovers_planted_motif():
    motif = "GTTGACCTAT"
    seqs, _ = planted(np.random.default_rng(5), 20, 120, motif)
    res = tbatch.sample_oops_batch(seqs, width=10, steps=150, chains=32, seed=1,
                                   device="cpu")
    assert res.information_content.shape == (32,)
    consensus = res.count_matrix().consensus()
    assert sum(a == b for a, b in zip(consensus, motif)) >= 8, consensus
    res2 = tbatch.sample_oops_batch(seqs, width=10, steps=150, chains=32, seed=1,
                                    device="cpu")
    assert np.array_equal(res.starts, res2.starts)
    assert np.array_equal(res.information_content, res2.information_content)
    other = tbatch.sample_oops_batch(seqs, width=10, steps=150, chains=32, seed=2,
                                     device="cpu")
    assert not np.array_equal(res.starts, other.starts)
    assert len(res.pssm()) == 10
    assert ((res.starts >= 0) & (res.starts <= 110)).all()


def test_batched_zoops_includes_planted_sequences():
    motif = "GTTGACCTAT"
    seqs, _ = planted(np.random.default_rng(5), 16, 150, motif)
    res = tbatch.sample_zoops_batch(seqs, width=10, steps=300, chains=32, seed=2,
                                    seeds=4, device="cpu")
    assert int(res.active[res.best].sum()) >= 12
    consensus = res.count_matrix().consensus()
    assert aligned(consensus, motif) >= 8, consensus
    res2 = tbatch.sample_zoops_batch(seqs, width=10, steps=300, chains=32, seed=2,
                                     seeds=4, device="cpu")
    assert np.array_equal(res.starts, res2.starts)
    assert np.array_equal(res.active, res2.active)


def test_batched_needs_a_device_choice(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbatch.sample_oops_batch(["ACGTACGTACGT"] * 3, width=4, steps=2, chains=2)


def test_oops_resume_bitexact():
    rng = np.random.default_rng(21)
    seqs = ["".join("ACGT"[c] for c in rng.integers(0, 4, size=120)) for _ in range(8)]
    kw = dict(width=9, chains=6, seed=3, device="cpu")
    full = tbatch.sample_oops_batch(seqs, steps=40, **kw)
    part = tbatch.sample_oops_batch(seqs, steps=15, **kw)
    rest = tbatch.sample_oops_batch(seqs, steps=25, state=part.state, **kw)
    assert np.array_equal(rest.starts, full.starts)
    assert np.array_equal(bits(rest.information_content), bits(full.information_content))
    assert rest.state.step == 40
    assert torch.equal(rest.state.key, full.state.key)


def test_zoops_resume_bitexact():
    rng = np.random.default_rng(22)
    seqs = ["".join("ACGT"[c] for c in rng.integers(0, 4, size=100)) for _ in range(7)]
    kw = dict(width=8, chains=5, seed=9, seeds=2, inertia=10, patience=12, device="cpu")
    full = tbatch.sample_zoops_batch(seqs, steps=36, **kw)
    part = tbatch.sample_zoops_batch(seqs, steps=14, **kw)
    rest = tbatch.sample_zoops_batch(seqs, steps=22, state=part.state, **kw)
    assert np.array_equal(rest.starts, full.starts)
    assert np.array_equal(rest.active, full.active)
    assert np.array_equal(bits(rest.information_content), bits(full.information_content))
    assert torch.equal(rest.state.converged, full.state.converged)
    assert torch.equal(rest.state.last_inc, full.state.last_inc)


def test_zoops_takes_a_generator_of_sequences():
    """The default patience counts the sequences without consuming them."""
    rng = np.random.default_rng(23)
    seqs = ["".join("ACGT"[c] for c in rng.integers(0, 4, size=60)) for _ in range(5)]
    kw = dict(width=6, steps=12, chains=3, seed=4, device="cpu")
    from_list = tbatch.sample_zoops_batch(seqs, **kw)
    from_gen = tbatch.sample_zoops_batch((s for s in seqs), **kw)
    assert np.array_equal(from_gen.starts, from_list.starts)
    assert np.array_equal(from_gen.active, from_list.active)
