"""The port's plain scoring versions against the JAX package's kernels.

``lightmotif_tpu_torch.ops.torch_ops.score_f32`` / ``score_u8`` -- the
reference versions of the CUDA kernels K1 / K2, and what the kernel
wrappers run on the CPU -- must be bit-identical to the Pallas kernel
``lightmotif_tpu.ops.kernels._gather_kernel`` (run in interpret mode at
``block_lanes=128``, as ``tests/test_kernels.py`` runs it) and to the
XLA versions in ``lightmotif_tpu.ops.xla_ops``, over the whole padded
output including the masked tail.
"""

import jax
import numpy as np
import pytest
import torch

from lightmotif_tpu.ops import kernels as jax_kernels
from lightmotif_tpu.ops import xla_ops
from lightmotif_tpu_torch.ops import kernels, torch_ops

from .torch_parity import (  # noqa: F401  (interpret_mode is an autouse fixture)
    BL, KERNEL_CASES, LP, bits, interpret_mode, kernel_inputs)


def _host_f32(flat, w, n):
    acc = w[0][flat[:n]]
    for j in range(1, w.shape[0]):
        acc = acc + w[j][flat[j : j + n]]
    return acc


@pytest.mark.parametrize("k,m,length", KERNEL_CASES)
def test_score_f32_matches_jax(k, m, length):
    flat, w, _, n = kernel_inputs(k, m, length, seed=k * 1000 + m)
    got = torch_ops.score_f32(torch.from_numpy(flat), torch.from_numpy(w), n).numpy()
    pallas = np.asarray(jax_kernels.score_f32(flat.astype(np.int8), w, n, block_lanes=BL))
    xla = np.asarray(jax.jit(xla_ops.score_f32, static_argnums=2)(flat.astype(np.int8), w, n))
    assert got.dtype == np.float32 and got.shape == (LP,)
    assert np.array_equal(bits(got), bits(pallas)), "port != pallas"
    assert np.array_equal(bits(got), bits(xla)), "port != xla"
    assert np.array_equal(bits(got[:n]), bits(_host_f32(flat, w, n)))
    assert np.all(np.isneginf(got[n:]))


def test_cpu_wrappers_run_the_plain_versions():
    flat, w, dm, n = kernel_inputs(5, 15, None, seed=3)
    seq = torch.from_numpy(flat)
    kernels.reset_launches()
    assert torch.equal(kernels.score_f32(seq, torch.from_numpy(w), n),
                       torch_ops.score_f32(seq, torch.from_numpy(w), n))
    assert torch.equal(kernels.score_u8(seq, torch.from_numpy(dm), n),
                       torch_ops.score_u8(seq, torch.from_numpy(dm), n))
    tables = (torch.from_numpy(dm), torch.from_numpy(w))
    for got, want in zip(kernels.scan_segment(seq, n, *tables, 40, -20.0, 64),
                         torch_ops.scan_segment(seq, n, *tables, 40, -20.0, 64)):
        assert torch.equal(got, want)
    assert kernels.LAUNCHES == {"score_f32": 0, "score_u8": 0, "scan_segment": 0}


@pytest.mark.parametrize("bad", ["seq_dtype", "table_dtype", "device"])
def test_wrappers_refuse_what_the_kernel_does_not_take(bad):
    seq = torch.zeros(64, dtype=torch.uint8)
    table = torch.zeros((3, 5), dtype=torch.float32)
    if bad == "seq_dtype":
        seq = seq.to(torch.int64)
    elif bad == "table_dtype":
        table = table.to(torch.float64)
    else:  # a device with no kernel and no plain version: no fallback
        seq, table = seq.to("meta"), table.to("meta")
    with pytest.raises((TypeError, ValueError)):
        kernels.score_f32(seq, table, 10)
    dm = torch.zeros((3, 5), dtype=torch.uint8, device=table.device)
    with pytest.raises((TypeError, ValueError)):
        kernels.scan_segment(seq, 10, dm, table, 0, 0.0, 16)
