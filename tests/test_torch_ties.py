"""The last-maximum tie rule, pinned in one place for both packages.

When several positions share the maximum score, the last one wins (the
reference's ``>=`` update, ``pli/mod.rs:144-151`` and ``scan.rs:235``).
Each case runs through ``lightmotif_tpu`` and ``lightmotif_tpu_torch``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightmotif_tpu as jlm
from lightmotif_tpu.ops import xla_ops
from lightmotif_tpu.ops.pipeline import Pipeline as JaxPipeline
from lightmotif_tpu_torch.ops import torch_ops
from lightmotif_tpu_torch.ops.pipeline import Pipeline

from .data import PATTERNS
from .torch_parity import pssms, random_ranks, sequences

NEG = -np.inf

#: name -> (scores, index of the last maximum)
ARGMAX_CASES = {
    "plateau": ([1.0, 3.0, 3.0, 2.0, 3.0, 0.0], 4),
    "both_ends": ([5.0, 1.0, 5.0], 2),
    "all_neginf": ([NEG] * 6, 5),
    "single": ([2.5], 0),
    "signed_zeros": ([0.0, -0.0], 1),
}

#: tie positions of the planted best window, and the port's segment size
SCAN_TIES = {
    "scanner_one_segment": ((100, 377), None),
    "scanner_across_segments": ((100, 9000), 1000),
}


def _argmax_last(package, scores):
    arr = np.asarray(scores, np.float32)
    if package == "jax":
        return int(xla_ops.argmax_last(jnp.asarray(arr)))
    return int(torch_ops.argmax_last(torch.from_numpy(arr)))


def _tied_inputs(positions, length=12_000):
    data = random_ranks(np.random.default_rng(17), length, 5)
    site = jlm.EncodedSequence.encode(PATTERNS[0]).data
    for pos in positions:
        data[pos : pos + site.size] = site
    counts = jlm.CountMatrix.from_sequences(
        jlm.EncodedSequence.encode(p) for p in PATTERNS).data
    return pssms(counts), sequences(data)


@pytest.mark.parametrize("package", ["jax", "torch"])
@pytest.mark.parametrize(
    "case", [*ARGMAX_CASES, *SCAN_TIES, "score_max"])
def test_last_maximum_wins(package, case):
    if case in ARGMAX_CASES:
        scores, want = ARGMAX_CASES[case]
        assert _argmax_last(package, scores) == want
        return
    positions, block = SCAN_TIES.get(case, ((250, 4000), None))
    (jp, tp), (js, ts) = _tied_inputs(positions)
    host = tp.score_host(ts)
    assert np.nonzero(host == host.max())[0].tolist() == list(positions)
    if case == "score_max":
        pipe = JaxPipeline() if package == "jax" else Pipeline(device="cpu")
        _, got = pipe.score_max(jp if package == "jax" else tp,
                                js if package == "jax" else ts)
    elif package == "jax":
        scanner = jlm.Scanner(jp, js, threshold=float(host.max()) - 1.0)
        if block is not None:
            scanner.block_size = 8192  # its segments on the CPU
        got = scanner.max().position
    else:
        import lightmotif_tpu_torch as tlm

        scanner = tlm.Scanner(tp, ts, threshold=float(host.max()) - 1.0,
                              device="cpu")
        if block is not None:
            scanner.block_size = block
        got = scanner.max().position
    assert got == positions[-1]
