"""Motif discovery by Gibbs sampling.

Counterpart of :mod:`lightmotif_tpu.sampler`, a behavioral port of the
reference sampler (``lightmotif/src/sampler.rs``): OOPS (one occurrence
per sequence) and ZOOPS (zero-or-one) modes, with seed sequences,
inertia, and patience-based convergence.  Each iteration excludes a
random hold-out sequence, rebuilds the PSSM from the remaining active
sequences (0.1 pseudocount, current background counts), scores the
hold-out at every position, and samples a new motif start with weights
``2^(score / temperature)``.

The sampler's random numbers come from a seeded
``numpy.random.Generator``, as in the JAX package, and every draw sees
the same bits there and here: a hold-out of at least
:data:`DEVICE_THRESHOLD` symbols is scored on the sampler's device by the
pipeline (the scoring kernel K1 on a CUDA device), whose f32 scores are
bit-identical to :meth:`~.matrix.ScoringMatrix.score_host`, which scores
the shorter ones.  So for the same seed the trajectories (hold-outs,
starts, active set, counts) are identical to the JAX sampler's, on the
CPU and on the card.

The state (starts, active set, motif counts, background counts) is an
explicit carry, so a caller can checkpoint/resume the sampler at any
step.
"""

from __future__ import annotations

import numpy as np

from .alphabet import Background
from .matrix import CountMatrix, ScoringMatrix
from .sequence import EncodedSequence

__all__ = ["SamplerData", "Sampler", "SamplerIteration", "sample_motifs"]

#: Sequences at least this long are scored on the sampler's device.
DEVICE_THRESHOLD = 1 << 15


class SamplerData:
    """Pre-computed per-sequence symbol counts (``sampler.rs:122-159``)."""

    def __init__(self, sequences):
        seqs = []
        for s in sequences:
            if hasattr(s, "unstripe"):
                s = s.unstripe()
            if not isinstance(s, EncodedSequence):
                raise TypeError("expected EncodedSequence or StripedSequence")
            seqs.append(s)
        if not seqs:
            raise ValueError("no sequences given")
        self.sequences = seqs
        self.alphabet = seqs[0].alphabet
        self.counts = [s.count_symbols() for s in seqs]


class SamplerIteration:
    """One sampler step (``sampler.rs:608-620``)."""

    __slots__ = ("counts", "pssm", "z", "step")

    def __init__(self, counts, pssm, z, step):
        self.counts = counts
        self.pssm = pssm
        self.z = z
        self.step = step


class Sampler:
    """A Gibbs sampler over a set of sequences.

    Iterate it (it is its own iterator) until convergence or a step
    budget; each step yields a :class:`SamplerIteration`.  ``device`` is
    where long hold-outs are scored (see :data:`DEVICE_THRESHOLD`),
    resolved by :func:`~.ops.pipeline.resolve_device` at the first such
    hold-out: ``None`` is the current CUDA device (or the one chosen with
    ``use_device``), ``"cpu"`` runs the plain version.
    """

    def __init__(
        self,
        data: SamplerData,
        width: int = 10,
        rng=None,
        mode: str = "oops",
        seeds: int = 0,
        inertia: int | None = None,
        patience: int | None = None,
        temperature: float = 1.0,
        device=None,
    ):
        if mode not in ("oops", "zoops"):
            raise ValueError(f"unknown mode {mode!r}")
        if rng is None:
            rng = np.random.default_rng()
        if isinstance(rng, (int, np.integer)):
            rng = np.random.default_rng(int(rng))
        self.data = data
        self.width = int(width)
        self.rng = rng
        self.mode = mode
        self.temperature = float(temperature)
        self.inertia = inertia if inertia is not None else (seeds * 50 if seeds else 0)
        self.patience = (
            patience if patience is not None else len(data.sequences)
        )
        self.device = device
        self._pipeline = None  # built at the first long hold-out
        self._uploaded = {}  # sequence index -> DeviceSequence

        k = data.alphabet.size
        n = len(data.sequences)
        for s in data.sequences:
            if len(s) < self.width:
                raise ValueError("sequence shorter than motif width")

        # random initial starts (sampler.rs:386-395)
        self.starts = [
            int(rng.integers(0, len(s) - self.width + 1))
            for s in data.sequences
        ]

        # initial active set (sampler.rs:397-410)
        self.seed = []
        if mode == "oops":
            self.active = np.ones(n, dtype=bool)
        else:
            self.active = np.zeros(n, dtype=bool)
            chosen = rng.choice(n, size=min(seeds, n), replace=False)
            for i in chosen:
                self.active[int(i)] = True
                self.seed.append(int(i))

        # motif counts + background counts from active sequences
        self.motif = np.zeros((self.width, k), dtype=np.int64)
        self.background_counts = np.zeros(k, dtype=np.int64)
        for i, s in enumerate(data.sequences):
            if self.active[i]:
                self._add_counts(i, +1)

        self.step = 0
        self.last_inclusion = 0
        self.converged = False

    # -- bookkeeping (sampler.rs:472-510) --------------------------------------

    def _add_counts(self, i: int, sign: int) -> None:
        s = self.data.sequences[i]
        start = self.starts[i]
        window = s.data[start : start + self.width]
        np.add.at(self.motif, (np.arange(self.width), window), sign)
        self.background_counts += sign * self.data.counts[i]
        np.add.at(self.background_counts, window, -sign)

    def _include(self, z: int) -> None:
        if not self.active[z]:
            self._add_counts(z, +1)
            self.active[z] = True

    def _exclude(self, z: int) -> None:
        if self.active[z]:
            self._add_counts(z, -1)
            self.active[z] = False

    # -- accessors ---------------------------------------------------------------

    def active_sequences(self) -> list:
        return np.nonzero(self.active)[0].tolist()

    def active_starts(self) -> list:
        return [self.starts[i] for i in self.active_sequences()]

    def count_matrix(self) -> CountMatrix:
        return CountMatrix(
            self.data.alphabet,
            self.motif.astype(np.uint32),
            int(self.active.sum()),
        )

    def background(self) -> Background:
        return Background.from_counts(self.data.alphabet, self.background_counts)

    def _prepare_pssm(self):
        counts = self.count_matrix()
        pssm = counts.to_freq(0.1).to_scoring(self.background())
        return counts, pssm

    # -- the update step (sampler.rs:528-538) --------------------------------------

    def _score_holdout(self, pssm: ScoringMatrix, z: int) -> np.ndarray:
        seq = self.data.sequences[z]
        if len(seq) >= DEVICE_THRESHOLD:
            from .ops.pipeline import DeviceSequence, Pipeline

            if self._pipeline is None:
                self._pipeline = Pipeline(self.device)
            dseq = self._uploaded.get(z)
            if dseq is None:
                dseq = self._uploaded[z] = DeviceSequence(seq, self._pipeline.device)
            return np.asarray(self._pipeline.score(pssm, dseq).unstripe())
        return pssm.score_host(seq)

    def _update_holdout(self, z: int, pssm: ScoringMatrix) -> None:
        scores = self._score_holdout(pssm, z).astype(np.float64)
        with np.errstate(over="ignore"):
            weights = np.exp2(scores / self.temperature)
        total = weights.sum()
        if np.isfinite(total) and total > 0.0:
            probs = weights / total
            self.starts[z] = int(self.rng.choice(len(probs), p=probs))
        # else: keep the previous start (reference: WeightedIndex::new Err)

    # -- iteration (sampler.rs:550-595) ----------------------------------------------

    def __iter__(self):
        return self

    def __next__(self) -> SamplerIteration:
        if self.converged:
            raise StopIteration

        # step 1: choose and exclude the hold-out sequence
        if self.mode == "zoops" and self.step < self.inertia and self.seed:
            z = int(self.rng.choice(self.seed))
        else:
            z = int(self.rng.integers(0, len(self.starts)))
        was_active = bool(self.active[z])
        self._exclude(z)

        # step 2: rebuild motif, resample the hold-out start, re-include
        counts, pssm = self._prepare_pssm()
        self._update_holdout(z, pssm)
        self._include(z)

        # zoops: keep new sequences only if information content improves
        if self.mode == "zoops" and not was_active:
            _, new_pssm = self._prepare_pssm()
            if new_pssm.information_content() < pssm.information_content():
                self._exclude(z)
            else:
                self.last_inclusion = self.step
            if self.step - self.last_inclusion > self.patience:
                self.converged = True

        self.step += 1
        return SamplerIteration(counts, pssm, z, self.step - 1)


def sample_motifs(
    sequences,
    width: int = 10,
    steps: int = 100,
    rng=None,
    device=None,
    **kwargs,
) -> SamplerIteration:
    """Convenience: run ``steps`` sampler iterations and return the last."""
    from .alphabet import DNA

    alphabet = kwargs.pop("alphabet", DNA)
    if isinstance(sequences, SamplerData):
        data = sequences
    else:
        data = SamplerData(
            [
                s
                if isinstance(s, EncodedSequence) or hasattr(s, "unstripe")
                else EncodedSequence.encode(s, alphabet)
                for s in sequences
            ]
        )
    sampler = Sampler(data, width=width, rng=rng, device=device, **kwargs)
    result = None
    for result in sampler:
        if result.step + 1 >= steps:
            break
    return result
