"""The inputs of a cell: a motif database's count matrices and the
sequences of its traffic.

The database is the seeded stand-in for JASPAR 2024 CORE that
``chip_smoke.py`` scans (``synthetic_counts`` / ``synthetic_database``),
frozen here: every profile has ``sites`` aligned sites whose columns draw
their symbol probabilities from Dirichlet(``alpha``) and their counts from
those; the wildcard column is zero.  The profile lengths are the
configuration's mix (``database.lengths``, the stand-in's own).  It is
drawn from the configuration's ``database.seed``, not the run's: a
deployment scans one database file, and every run asks the same work of
it.  The run's seed draws the sequences.

Sequences are uniform over the four bases, with runs of the wildcard
where the configuration places them (a chromosome's telomeres and
centromere gap).

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


def profile_lengths(database: dict) -> np.ndarray:
    """The configuration's profile lengths, shortest first."""
    mix = database["lengths"]
    lengths = np.repeat([int(m) for m in mix], [int(c) for c in mix.values()])
    if lengths.size != int(database["profiles"]):
        raise ValueError(f"the length mix holds {lengths.size} profiles, "
                         f"not {database['profiles']}")
    return np.sort(lengths)


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


def sequences(spec: dict, count: int, wildcard: int, g: torch.Generator) -> np.ndarray:
    """``count`` sequences of ``spec["length"]`` symbol ranks, ``uint8
    [count, length]`` on the host: uniform over ranks ``0..3``, with the
    wildcard over each ``[start, start + length)`` of ``spec["n_runs"]``
    (a negative start counts from the end)."""
    n = int(spec["length"])
    seqs = torch.randint(0, 4, (count, n), generator=g, device=g.device, dtype=torch.uint8)
    for start, length in spec.get("n_runs", []):
        lo = start if start >= 0 else n + start
        seqs[:, lo : lo + length] = wildcard
    return seqs.cpu().numpy()
