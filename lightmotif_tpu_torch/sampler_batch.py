"""Batched motif discovery: many independent Gibbs chains on a device.

Counterpart of :mod:`lightmotif_tpu.sampler_batch`.  The reference
sampler (``lightmotif/src/sampler.rs``) runs one chain; restarts (the
standard remedy for Gibbs samplers stuck in local optima) multiply its
wall time.  Here ``chains`` independent samplers (OOPS or ZOOPS) run as
batched torch operations over the chain axis, one Python loop iteration
per step, on one device; the host then ranks chains by information
content and returns the best.

Each step mirrors the host sampler (:mod:`.sampler`): pick a hold-out
sequence, rebuild counts/background from the rest, form the
0.1-pseudocount log2-odds PSSM, score the hold-out at every valid start,
and resample its start with weights ``2^(score/T)``.  ZOOPS chains also
carry an active-set mask, seed-biased hold-outs during inertia, IC-gated
inclusion, and patience-based convergence (frozen chains keep their
state for the rest of the run).

The step math lives in module-level functions (:func:`counts_of`,
:func:`pssm_of`, :func:`score_holdouts`) shared by the step loop and the
parity tests.  Random numbers come from one ``torch.Generator`` on the
device, seeded by ``seed`` (torch cannot reproduce JAX's threefry
stream, so the chains differ from the JAX package's, and CPU and CUDA
generators draw different streams too).  Every step draws the same
sequence of tensors, so the generator's state is the whole of the
random state: ``result.state`` carries it, and passing ``state=``
resumes the chains bit-identically to one longer run.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .alphabet import DNA
from .matrix import CountMatrix
from .sequence import EncodedSequence

__all__ = [
    "sample_oops_batch",
    "sample_zoops_batch",
    "BatchSamplerResult",
    "BatchSamplerState",
]


class BatchSamplerState(NamedTuple):
    """The explicit carry of the batched sampler, on the run's device;
    resumable via ``sample_*_batch(..., state=...)``."""

    starts: object     # int64 [C, N] current motif start per sequence
    active: object     # bool  [C, N] active set (all True for OOPS)
    seed_mask: object  # bool  [C, N] ZOOPS seed subset (static per run)
    last_inc: object   # int64 [C]    step of the last ZOOPS inclusion
    converged: object  # bool  [C]    patience-frozen chains
    key: object        # the generator's state (``Generator.get_state()``)
    step: object       # int          global step counter


def counts_of(seqs, totals, starts, active_f, width: int, k: int):
    """Motif counts ``[C, w, K]`` + background counts ``[C, K]`` from
    per-chain starts and an active-set weighting (the batched analogue
    of ``Sampler._add_counts``, ``sampler.rs:472-510``).

    ``seqs``: uint8 ``[N, Lp]``; ``totals``: f32 ``[N, K]`` symbol
    counts; ``starts``: integer ``[C, N]``; ``active_f``: f32 ``[C, N]``.
    Every count is an integer below 2**24, so the f32 sums are exact."""
    n = seqs.shape[0]
    dev = seqs.device
    idx = starts[:, :, None].long() + torch.arange(width, device=dev)[None, None, :]
    sym = seqs[torch.arange(n, device=dev)[None, :, None], idx].long()  # [C, N, w]
    oh = (sym[..., None] == torch.arange(k, device=dev)).to(torch.float32)
    oh = oh * active_f[:, :, None, None]
    counts = oh.sum(dim=1)  # [C, w, K]
    bgc = (totals[None, :, :] * active_f[:, :, None]).sum(dim=1) \
        - counts.sum(dim=1)  # [C, K]
    return counts, bgc


def _pseudo(k: int, device) -> torch.Tensor:
    """Pseudocounts: 0.1, none for the wildcard."""
    pseudo = torch.full((k,), 0.1, dtype=torch.float32, device=device)
    pseudo[k - 1] = 0.0
    return pseudo


def pssm_of(counts, bgc, k: int):
    """0.1-pseudocount log2-odds PSSM ``[C, w, K]`` + information
    content ``[C]`` (the batched ``Sampler._prepare_pssm``).

    Wildcards get zero pseudocount; a zero-background symbol maps to
    ``-inf`` like ``FrequencyMatrix.to_scoring`` and contributes 0 to
    the information content (the reference skips non-finite terms)."""
    bg = bgc / bgc.sum(-1, keepdim=True).clamp(min=1.0)
    fr = counts + _pseudo(k, counts.device)[None, None, :]
    fr = fr / fr.sum(-1, keepdim=True)
    pssm = torch.where(
        bg[:, None, :] > 0,
        torch.log2(fr / bg[:, None, :].clamp(min=1e-30)),
        float("-inf"),
    )  # [C, w, K]
    ic = torch.where(torch.isfinite(pssm), fr * pssm, 0.0).sum(dim=(1, 2))
    return pssm, ic


def score_holdouts(seqz, pssm, valid_z, width: int, k: int):
    """Exact f32 scores of every window start of each chain's hold-out
    sequence; invalid starts get ``-inf``.

    ``seqz``: uint8 ``[C, Lp]``; ``pssm``: f32 ``[C, w, K]``;
    ``valid_z``: ``[C]`` valid starts.  Row ``j`` adds ``pssm[c, j,
    sym]`` (a gather; ranks ``>= K - 1`` read the wildcard column) to an
    accumulator that starts from zeros, in ascending ``j``: the same
    adds, in the same order, as the JAX package's select chain and
    ``ScoringMatrix.score_host``, so the bits are the same."""
    chains, lp = seqz.shape
    lv = lp - width + 1
    sym = seqz.long().clamp(max=k - 1)
    acc = torch.zeros((chains, lv), dtype=torch.float32, device=seqz.device)
    for j in range(width):
        acc = acc + torch.gather(pssm[:, j, :], 1, sym[:, j:j + lv])
    p_iota = torch.arange(lv, device=seqz.device)[None, :]
    return torch.where(p_iota < valid_z[:, None], acc, float("-inf"))


def categorical(logits, generator) -> torch.Tensor:
    """One draw per row of ``softmax(logits)`` by the Gumbel-max trick
    (what ``jax.random.categorical`` does): ``argmax(logits -
    log(-log(u)))``.  A ``-inf`` logit is never drawn unless every logit
    of its row is ``-inf``."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)  # keeps log(-log(u)) finite
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


class BatchSamplerResult:
    """Final state of every chain plus the information-content ranking."""

    __slots__ = ("starts", "counts", "information_content", "best",
                 "alphabet", "active", "state")

    def __init__(self, starts, counts, information_content, best, alphabet):
        self.starts = starts
        self.counts = counts
        self.information_content = information_content
        self.best = best
        self.alphabet = alphabet
        self.active = None
        self.state = None

    def count_matrix(self, chain: int | None = None) -> CountMatrix:
        c = self.best if chain is None else chain
        return CountMatrix(
            self.alphabet,
            self.counts[c].astype(np.uint32),
            int(self.starts.shape[1]),
        )

    def pssm(self, chain: int | None = None):
        return self.count_matrix(chain).to_freq(0.1).to_scoring(None)


def _init_chains(seqs, valid, generator, width: int, chains: int, k: int,
                 zoops: bool, seeds: int) -> BatchSamplerState:
    n = seqs.shape[0]
    dev = seqs.device
    u = torch.rand((chains, n), generator=generator, device=dev)
    starts0 = (u * valid[None, :].to(torch.float32)).to(torch.int64)
    # u * valid can round up to valid in f32: keep the start in range
    starts0 = torch.minimum(starts0, valid[None, :].to(torch.int64) - 1)

    if zoops:
        # random seed subset per chain (sampler.rs:397-410): the ranks of
        # uniforms, ties broken by index
        order = torch.argsort(torch.rand((chains, n), generator=generator, device=dev),
                              dim=-1, stable=True)
        rank = torch.argsort(order, dim=-1, stable=True)
        seed_mask = rank < max(seeds, 1)
        active0 = seed_mask.clone()
    else:
        seed_mask = torch.ones((chains, n), dtype=torch.bool, device=dev)
        active0 = torch.ones((chains, n), dtype=torch.bool, device=dev)

    return BatchSamplerState(
        starts0, active0, seed_mask,
        torch.zeros(chains, dtype=torch.int64, device=dev),
        torch.zeros(chains, dtype=torch.bool, device=dev),
        generator.get_state(), 0,
    )


def _run_chains(seqs, valid, totals, state: BatchSamplerState, generator,
                width: int, steps: int, chains: int, k: int,
                temperature: float, zoops: bool = False, inertia: int = 0,
                patience: int = 0):
    n = seqs.shape[0]
    dev = seqs.device
    c_iota = torch.arange(chains, device=dev)
    n_iota = torch.arange(n, device=dev)
    scale = np.float32(np.log(2.0)) / np.float32(temperature)
    seed_mask = state.seed_mask
    z_logits = torch.where(seed_mask, 0.0, float("-inf"))
    generator.set_state(state.key)
    starts, active = state.starts.clone(), state.active.clone()
    last_inc, converged = state.last_inc.clone(), state.converged.clone()

    for step_i in range(state.step, state.step + steps):
        if zoops:
            # seed-biased hold-out during inertia (sampler.rs:460-470);
            # both draws are made every step, so the generator advances
            # alike on either side of the inertia edge
            z_seed = categorical(z_logits, generator)
            z_any = torch.randint(0, n, (chains,), generator=generator, device=dev)
            z = z_seed if step_i < inertia else z_any
        else:
            z = torch.randint(0, n, (chains,), generator=generator, device=dev)

        was_active = active[c_iota, z]
        holdout = n_iota[None, :] == z[:, None]
        act_f = (active & ~holdout).to(torch.float32)
        counts, bgc = counts_of(seqs, totals, starts, act_f, width, k)
        pssm, ic_without = pssm_of(counts, bgc, k)

        logits = score_holdouts(seqs[z], pssm, valid[z], width, k) * scale
        new = categorical(logits, generator)
        # all--inf weights: keep the previous start, like the host
        # sampler (reference WeightedIndex::new Err, sampler.rs:528-538)
        degenerate = ~torch.isfinite(logits.amax(dim=-1))
        prev = starts[c_iota, z]
        new = torch.where(degenerate | converged, prev, new)
        starts[c_iota, z] = new

        if zoops:
            # accept a newly-included sequence only if the information
            # content improves (sampler.rs:550-595)
            act_with = active.clone()
            act_with[c_iota, z] = True
            counts2, bgc2 = counts_of(seqs, totals, starts,
                                      act_with.to(torch.float32), width, k)
            _, ic_with = pssm_of(counts2, bgc2, k)
            accept = (was_active | (ic_with >= ic_without)) & ~converged
            active[c_iota, z] = torch.where(converged, was_active, accept)
            inc_now = ~was_active & accept
            last_inc = torch.where(inc_now, step_i, last_inc)
            # convergence is only evaluated when an inactive sequence was
            # held out, like the host sampler (sampler.rs:586-593)
            converged = converged | (~was_active & (step_i - last_inc > patience))

    out_state = BatchSamplerState(
        starts, active, seed_mask, last_inc, converged,
        generator.get_state(), state.step + steps)

    # final counts over the active set + per-chain information content
    counts, bgc = counts_of(seqs, totals, starts, active.to(torch.float32), width, k)
    fr = counts + _pseudo(k, dev)[None, None, :]
    fr = fr / fr.sum(-1, keepdim=True)
    bg = bgc / bgc.sum(-1, keepdim=True).clamp(min=1.0)
    term = torch.where(
        (fr > 0) & (bg[:, None, :] > 0),
        fr * torch.log2(fr / bg[:, None, :].clamp(min=1e-30)),
        0.0,
    )
    return out_state, counts, term.sum(dim=(1, 2))


def _sample_batch(sequences, width, steps, chains, seed, temperature,
                  alphabet, zoops, seeds, inertia, patience, state=None,
                  device=None):
    from .ops.pipeline import resolve_device

    seqs = [
        s if isinstance(s, EncodedSequence)
        else EncodedSequence.encode(s, alphabet)
        for s in sequences
    ]
    if any(len(s) < width for s in seqs):
        raise ValueError("sequence shorter than motif width")
    dev = resolve_device(device)
    k = alphabet.size
    n = len(seqs)
    lp = max(len(s) for s in seqs)
    mat = np.full((n, lp), alphabet.default_index, np.uint8)
    totals = np.zeros((n, k), np.float32)
    valid = np.zeros(n, np.int64)
    for i, s in enumerate(seqs):
        mat[i, : len(s)] = s.data
        totals[i] = np.bincount(s.data, minlength=k).astype(np.float32)
        valid[i] = len(s) - width + 1

    seqs_d = torch.as_tensor(mat, device=dev)
    valid_d = torch.as_tensor(valid, device=dev)
    generator = torch.Generator(device=dev)
    if state is None:
        generator.manual_seed(int(seed))
        state = _init_chains(seqs_d, valid_d, generator, width, chains, k,
                             zoops, seeds)
    out_state, counts, ic = _run_chains(
        seqs_d, valid_d, torch.as_tensor(totals, device=dev), state, generator,
        width, steps, chains, k, float(temperature), zoops, inertia, patience)
    starts = out_state.starts.cpu().numpy()
    counts = counts.cpu().numpy()
    ic = ic.cpu().numpy()
    best = int(np.argmax(ic))
    res = BatchSamplerResult(starts, counts, ic, best, alphabet)
    res.active = out_state.active.cpu().numpy()
    res.state = out_state
    return res


def sample_oops_batch(
    sequences,
    width: int = 10,
    steps: int = 100,
    chains: int = 64,
    seed: int = 0,
    temperature: float = 1.0,
    alphabet=DNA,
    state: BatchSamplerState | None = None,
    device=None,
) -> BatchSamplerResult:
    """Run ``chains`` independent OOPS Gibbs chains on one device.

    Returns a :class:`BatchSamplerResult`; ``result.best`` is the chain
    with the highest information content, ``result.pssm()`` its motif,
    ``result.state`` the resumable carry: passing it back as ``state=``
    (on the same device) continues the same chains for ``steps`` more
    steps, bit-identically to one longer run.  Deterministic for a given
    ``seed`` and device.  ``device``: see
    :func:`~.ops.pipeline.resolve_device`.
    """
    return _sample_batch(sequences, width, steps, chains, seed,
                         temperature, alphabet, False, 0, 0, 0,
                         state=state, device=device)


def sample_zoops_batch(
    sequences,
    width: int = 10,
    steps: int = 100,
    chains: int = 64,
    seed: int = 0,
    temperature: float = 1.0,
    seeds: int = 2,
    inertia: int | None = None,
    patience: int | None = None,
    alphabet=DNA,
    state: BatchSamplerState | None = None,
    device=None,
) -> BatchSamplerResult:
    """Batched ZOOPS chains (zero-or-one occurrence per sequence).

    Mirrors the host sampler's zoops rules per chain: a random seed
    subset starts active, hold-outs are seed-biased for ``inertia``
    steps, a newly-included sequence is kept only if the information
    content improves, and a chain freezes after ``patience`` steps
    without an inclusion.  ``result.active`` marks each chain's final
    active set; ``result.state`` resumes (step counting, inertia and
    patience windows continue across the boundary).
    """
    sequences = list(sequences)
    if inertia is None:
        inertia = seeds * 50 if seeds else 0
    if patience is None:
        patience = len(sequences)
    return _sample_batch(sequences, width, steps, chains, seed,
                         temperature, alphabet, True, seeds, int(inertia),
                         int(patience), state=state, device=device)
