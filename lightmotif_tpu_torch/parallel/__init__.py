"""Genome-scale scanning sharded over a list of devices, and across
processes with ``torch.distributed`` (counterpart of
:mod:`lightmotif_tpu.parallel`)."""

from .mesh import (
    ShardedMultiScanner,
    ShardedScanner,
    make_genome_mesh,
    shard_sequence,
    sharded_argmax,
    sharded_multi_scan,
    sharded_scan,
)

__all__ = [
    "ShardedMultiScanner",
    "ShardedScanner",
    "make_genome_mesh",
    "shard_sequence",
    "sharded_argmax",
    "sharded_scan",
    "sharded_multi_scan",
]
