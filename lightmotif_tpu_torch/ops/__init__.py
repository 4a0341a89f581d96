"""Device compute layer (plain PyTorch versions and hand-written CUDA kernels)."""

from .pipeline import Pipeline, default_pipeline, score

__all__ = ["Pipeline", "default_pipeline", "score"]
