"""Utilities: profiling/throughput observability (counterpart of
:mod:`lightmotif_tpu.utils`).

The JAX package's ``utils.cache`` (JAX's persistent compile cache) has
its counterpart in :mod:`lightmotif_tpu_torch.ops.build`'s build
directory."""

from .profiling import ScanStats, profile_trace, throughput

__all__ = ["ScanStats", "profile_trace", "throughput"]
