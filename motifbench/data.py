"""The inputs of a cell: a motif database's count matrices and the
sequences of its traffic.

The database is the seeded stand-in for JASPAR 2024 CORE that
``chip_smoke.py`` scans (``synthetic_counts`` / ``synthetic_database``),
frozen here: every profile has ``sites`` aligned sites whose columns draw
their symbol probabilities from Dirichlet(``alpha``) over the alphabet's
``k - 1`` symbols and their counts from those; the wildcard column is
zero.  The profile lengths are the configuration's mix
(``database.lengths``, the stand-in's own).  It is drawn from the
configuration's ``database.seed``, not the run's: a deployment scans one
database file, and every run asks the same work of it.  The run's seed
draws the sequences.

A sequence's symbols are uniform over the ``k - 1`` symbols that are not
the wildcard, or drawn from the database's background where
``sequence.composition`` is ``"background"``.  A configuration scans
either sequences of ``sequence.length``, with runs of the wildcard where
it places them (a chromosome's telomeres and centromere gap), or record
sets (``sequence.records``, a length mix ``{length: count}`` in the form
of ``database.lengths``): every set holds the same records' lengths, in
an order of its own.

Each is drawn by a ``torch.Generator`` on the given device, in a few
large calls; the same seed on the same kind of device gives the same
inputs.
"""

from __future__ import annotations

import numpy as np
import torch


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed))
    return g


def mix_lengths(mix: dict) -> np.ndarray:
    """The lengths of a mix ``{length: count}``, shortest first."""
    return np.sort(np.repeat([int(m) for m in mix], [int(c) for c in mix.values()]))


def profile_lengths(database: dict) -> np.ndarray:
    """The configuration's profile lengths, shortest first."""
    lengths = mix_lengths(database["lengths"])
    if lengths.size != int(database["profiles"]):
        raise ValueError(f"the length mix holds {lengths.size} profiles, "
                         f"not {database['profiles']}")
    return lengths


def database_counts(database: dict, k: int, g: torch.Generator) -> list:
    """The forward strands' count matrices, ``uint32 [m, k]`` each (the
    last column is the wildcard's, zero)."""
    device = g.device
    lengths = profile_lengths(database)
    order = torch.randperm(lengths.size, generator=g, device=device).cpu().numpy()
    lengths = lengths[order]
    rows = int(lengths.sum())
    # Dirichlet(alpha) as normalised Gamma(alpha, 1) draws; Gamma(1/2, 1)
    # is half a squared standard normal, which a generator can draw
    alpha = float(database["dirichlet_alpha"])
    if alpha != 0.5:
        raise ValueError("only Dirichlet(0.5) columns are drawn")
    z = torch.randn(rows, k - 1, generator=g, device=device, dtype=torch.float64)
    probs = z * z
    probs /= probs.sum(dim=1, keepdim=True)
    sites = int(database["sites"])
    draws = torch.multinomial(probs, sites, replacement=True, generator=g)
    counts = torch.zeros(rows, k, dtype=torch.int64, device=device)
    counts.scatter_add_(1, draws, torch.ones_like(draws))
    counts = counts.cpu().numpy().astype(np.uint32)
    return np.split(counts, np.cumsum(lengths)[:-1])


def symbols(spec: dict, shape: tuple, k: int, background, g: torch.Generator) -> torch.Tensor:
    """``uint8`` ranks of ``shape`` on the generator's device, over the
    ``k - 1`` symbols that are not the wildcard: uniform (one
    ``randint``), or by inverting the cumulative ``background`` (its
    first ``k - 1`` frequencies) at uniform draws where
    ``spec["composition"]`` is ``"background"``."""
    if spec.get("composition") != "background":
        return torch.randint(0, k - 1, shape, generator=g, device=g.device, dtype=torch.uint8)
    freqs = torch.as_tensor(np.asarray(background, np.float64)[: k - 1], device=g.device)
    edges = torch.cumsum(freqs, 0) / freqs.sum()
    u = torch.rand(shape, generator=g, device=g.device, dtype=torch.float64)
    return torch.searchsorted(edges, u, right=True).clamp_(max=k - 2).to(torch.uint8)


def sequences(spec: dict, count: int, k: int, background, g: torch.Generator) -> np.ndarray:
    """``count`` sequences of ``spec["length"]`` symbol ranks, ``uint8
    [count, length]`` on the host (:func:`symbols`), with the wildcard
    (rank ``k - 1``) over each ``[start, start + length)`` of
    ``spec["n_runs"]`` (a negative start counts from the end)."""
    n = int(spec["length"])
    seqs = symbols(spec, (count, n), k, background, g)
    for start, length in spec.get("n_runs", []):
        lo = start if start >= 0 else n + start
        seqs[:, lo : lo + length] = k - 1
    return seqs.cpu().numpy()


def record_sets(spec: dict, count: int, k: int, background, g: torch.Generator) -> list:
    """``count`` record sets of the mix ``spec["records"]``: each a list
    of ``uint8`` rank arrays on the host (:func:`symbols`), the mix's
    lengths in an order drawn for the set."""
    lengths = mix_lengths(spec["records"])
    codes = symbols(spec, (count, int(lengths.sum())), k, background, g)
    sets = []
    for row in codes.cpu().numpy():
        order = torch.randperm(lengths.size, generator=g, device=g.device).cpu().numpy()
        sets.append(np.split(row, np.cumsum(lengths[order])[:-1]))
    return sets
