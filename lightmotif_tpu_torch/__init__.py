"""lightmotif-tpu on PyTorch and CUDA.

The port of ``lightmotif_tpu`` (JAX on a TPU) to PyTorch, with its
kernels written by hand in CUDA C++ for NVIDIA Hopper.  This package
holds the count -> frequency -> weight -> scoring -> discrete matrix
chain, exact-f32 scoring with max / argmax reductions, the two-pass
thresholded ``Scanner``, the MEME score distribution, the motif-database
scan (``scanner.MultiScanner``) and batched records (``batch``).  It
imports ``torch`` and numpy, never JAX.

On a CUDA device the scans run the kernels of ``ops/csrc/``; on the CPU,
when a caller asks for it (``device="cpu"`` or
``ops.pipeline.use_device("cpu")``), their plain PyTorch versions.
"""

from __future__ import annotations

__version__ = "0.3.0"

from .alphabet import (
    DNA,
    PROTEIN,
    Alphabet,
    Background,
    InvalidDataError,
    InvalidSymbolError,
    Pseudocounts,
)
from .matrix import (
    CountMatrix,
    DiscreteMatrix,
    FrequencyMatrix,
    ScoringMatrix,
    WeightMatrix,
)
from .dist import ScoreDistribution
from .scores import MatrixCoordinates, Scores, StripedScores
from .sequence import EncodedSequence, StripedSequence
from .scanner import Hit, Scanner
from .motif import Motif

__all__ = [
    "DNA",
    "PROTEIN",
    "Alphabet",
    "Background",
    "Pseudocounts",
    "InvalidDataError",
    "InvalidSymbolError",
    "CountMatrix",
    "FrequencyMatrix",
    "WeightMatrix",
    "ScoringMatrix",
    "DiscreteMatrix",
    "ScoreDistribution",
    "MatrixCoordinates",
    "Scores",
    "StripedScores",
    "EncodedSequence",
    "StripedSequence",
    "Hit",
    "Scanner",
    "Motif",
    "create",
    "stripe",
    "scan",
]


def create(sequences, protein: bool = False, name: str | None = None) -> Motif:
    """Create a motif from aligned sequence strings.

    Parity note: like the reference's Python ``create()``
    (``lightmotif-py/lightmotif/lib.rs:1351-1400``), this uses a **zero**
    pseudocount and the uniform background.
    """
    alphabet = PROTEIN if protein else DNA
    encoded = [EncodedSequence.encode(s, alphabet) for s in sequences]
    counts = CountMatrix.from_sequences(encoded)
    pwm = counts.to_freq(0.0).to_weight(None)
    pssm = pwm.to_scoring()
    return Motif(counts=counts, pwm=pwm, pssm=pssm, name=name)


def stripe(sequence, protein: bool = False) -> StripedSequence:
    """Encode and stripe a text sequence."""
    alphabet = PROTEIN if protein else DNA
    return EncodedSequence.encode(sequence, alphabet).to_striped()


def scan(pssm, sequence, threshold: float = 0.0, block_size: int | None = None,
         device=None) -> Scanner:
    """Iterate hits of ``pssm`` on ``sequence`` at ``threshold``."""
    scanner = Scanner(pssm, sequence, threshold=threshold, device=device)
    if block_size is not None:
        scanner.block_size = block_size
    return scanner
