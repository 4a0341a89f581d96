"""The port's multi-motif prefilter K3 against the JAX package's.

The plain version of K3 (``lightmotif_tpu_torch.ops.torch_ops.
prefilter_any8``, what the wrapper runs on the CPU) must give the values
of the Pallas kernel ``lightmotif_tpu.ops.multi_kernel.prefilter_any8``
(interpret mode) on every position ``p < Lp - m_max + 1`` -- the
positions whose windows do not reach the Pallas kernel's wrapped tail
-- for the same motif group: DNA with 1, 2, 3 (ragged) and 8
contraction blocks, protein, never-pass and padded lanes, sequences
with wildcard runs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightmotif_tpu.ops import multi as jmulti
from lightmotif_tpu.ops import multi_kernel as jmk
from lightmotif_tpu_torch.ops import multi, multi_kernel, torch_ops

from .torch_parity import (  # noqa: F401  (interpret_mode is an autouse fixture)
    interpret_mode, motif_stack, random_motifs, random_ranks)

#: (name, protein, motif widths, never-pass lanes, tile)
K3_CASES = [
    ("dna_1_block", False, [6, 8, 9, 11, 12, 14, 15, 15], 0, 8192),
    ("dna_2_blocks", False, [5, 9, 17, 20, 25, 31] * 3, 2, 8192),
    ("dna_3_blocks_ragged", False, None, 3, 8192),
    ("dna_8_blocks", False, [10, 40, 77, 100, 128], 1, 4096),
    ("protein_3_blocks", True, [5, 7, 8, 10, 10, 12] * 3, 2, 4096),
    ("protein_8_blocks", True, [5, 12, 20, 27, 32], 1, 4096),
]


def _group(name, protein, widths, never):
    rng = np.random.default_rng(sum(map(ord, name)))
    if widths is None:
        widths = sorted([int(w) for w in rng.integers(6, 15, size=246)]
                        + [int(w) for w in rng.integers(17, 25, size=8)] + [33] * 2)
    motifs = random_motifs(rng, widths, protein=protein)
    stack, lengths = motif_stack(motifs)
    # thresholds in the upper range of each motif's scores, so some
    # positions are candidates and most are not
    ths = np.asarray([p.score_distribution().score(0.02) for p in motifs], np.float32)
    ths[:never] = 1e6
    k = stack.shape[2]
    m_max = int(lengths.max())
    g = jmulti.pack_motif_group(np.arange(len(motifs)), len(motifs), m_max, stack, ths, k)
    return rng, g, k, m_max


@pytest.mark.parametrize("name,protein,widths,never,tile", K3_CASES,
                         ids=[c[0] for c in K3_CASES])
def test_prefilter_any8_plain_matches_jax(name, protein, widths, never, tile):
    rng, g, k, m_max = _group(name, protein, widths, never)
    seq = random_ranks(rng, tile, k, wildcard_runs=8)
    want = np.asarray(jmk.prefilter_any8(
        jnp.asarray(seq.astype(np.int8)), jnp.asarray(g["f_hi8"]),
        jnp.asarray(g["f_lo8"]), jnp.asarray(g["adj"]), m_max, k,
        tile=tile, widths=g["widths"])).reshape(-1)
    port = multi.pack_motif_group(
        np.arange(g["count"]), g["count"], m_max,
        g["pssm"], g["th"], k)["k3"]
    got = multi_kernel.prefilter_any8(
        torch.from_numpy(seq), *(torch.from_numpy(a) for a in port)).numpy()
    assert got.dtype == np.int32 and got.shape == (tile,)
    n = tile - m_max + 1
    assert np.array_equal(got[:n], want[:n])
    assert (got[:n] >= 0).any() and (got[:n] < 0).any()  # not vacuous
    if never:
        # a never-pass lane contributes sum16 - 2**26, the JAX value
        table, chunk_m, t_eff = port
        assert (t_eff[:never] == 1 << 26).all()


def _small_inputs(device="cpu"):
    rng = np.random.default_rng(3)
    motifs = random_motifs(rng, [5, 9, 12])
    stack, lengths = motif_stack(motifs)
    g = multi.pack_motif_group(np.arange(3), 3, int(lengths.max()), stack,
                               np.full(3, -5.0, np.float32), 5)
    seq = torch.from_numpy(random_ranks(rng, 3000, 5, wildcard_runs=3))
    return [t.to(device) for t in (seq, *(torch.from_numpy(a) for a in g["k3"]))]


def test_cpu_wrapper_runs_the_plain_version():
    seq, table, chunk_m, t_eff = _small_inputs()
    multi_kernel.reset_launches()
    got = multi_kernel.prefilter_any8(seq, table, chunk_m, t_eff)
    assert torch.equal(got, torch_ops.prefilter_any8(seq, table, chunk_m, t_eff))
    assert set(multi_kernel.LAUNCHES.values()) == {0}
    # the plain version sums every row, so the chunk bounds change nothing
    assert torch.equal(got, torch_ops.prefilter_any8(
        seq, table, torch.zeros_like(chunk_m), t_eff))


@pytest.mark.parametrize("bad", ["seq_dtype", "table_dtype", "table_lanes",
                                 "chunk_m", "t_eff", "device"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    seq, table, chunk_m, t_eff = _small_inputs()
    if bad == "seq_dtype":
        seq = seq.to(torch.int8)
    elif bad == "table_dtype":
        table = table.to(torch.int64)
    elif bad == "table_lanes":
        table = table[:, :, :8]  # 8 of the 16 lanes of a chunk
    elif bad == "chunk_m":
        chunk_m = torch.cat([chunk_m, chunk_m])
    elif bad == "t_eff":
        t_eff = t_eff.to(torch.int64)
    else:  # a device with no kernel and no plain version: no fallback
        seq, table, chunk_m, t_eff = (t.to("meta") for t in (seq, table, chunk_m, t_eff))
    with pytest.raises((TypeError, ValueError)):
        multi_kernel.prefilter_any8(seq, table, chunk_m, t_eff)

