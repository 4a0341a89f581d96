"""The port's plain discrete scoring against the JAX package's kernel.

``lightmotif_tpu_torch.ops.torch_ops.score_u8`` -- the reference
version of the CUDA kernel K2, and what its wrapper runs on the CPU --
must equal the Pallas kernel ``lightmotif_tpu.ops.kernels._gather_kernel``
in discrete mode (interpret mode, ``block_lanes=128``) and
``lightmotif_tpu.ops.xla_ops.score_u8``.  The f32 mode is in
``test_torch_kernels.py``; the two files are apart so that the slow interpret-mode compiles run on two
test workers.
"""

import jax
import numpy as np
import pytest
import torch

from lightmotif_tpu.ops import kernels as jax_kernels
from lightmotif_tpu.ops import xla_ops
from lightmotif_tpu_torch.ops import torch_ops

from .torch_parity import (  # noqa: F401  (interpret_mode is an autouse fixture)
    BL, KERNEL_CASES, LP, interpret_mode, kernel_inputs)


@pytest.mark.parametrize("k,m,length", KERNEL_CASES)
def test_score_u8_matches_jax(k, m, length):
    flat, _, dm, n = kernel_inputs(k, m, length, seed=k * 1000 + m + 1)
    got = torch_ops.score_u8(torch.from_numpy(flat), torch.from_numpy(dm), n).numpy()
    pallas = np.asarray(jax_kernels.score_u8(flat.astype(np.int8), dm, n, block_lanes=BL))
    xla = np.asarray(jax.jit(xla_ops.score_u8, static_argnums=2)(flat.astype(np.int8), dm, n))
    assert got.dtype == np.int32 and got.shape == (LP,)
    assert np.array_equal(got, pallas), "port != pallas"
    assert np.array_equal(got, xla), "port != xla"
    assert np.all(got[n:] == -1)
    if m >= 2 and n > 0:
        assert got.max() == 255, "the case must exercise the clamp"
