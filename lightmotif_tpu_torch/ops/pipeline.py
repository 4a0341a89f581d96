"""The compute pipeline: host objects in, scores and reductions out.

Counterpart of :mod:`lightmotif_tpu.ops.pipeline`.  A :class:`Pipeline`
runs on one explicit :class:`torch.device`.  On a CUDA device the
scoring goes through the hand-written kernels (:mod:`.kernels`); on the
CPU the same wrappers run their plain PyTorch versions.

The device is never chosen silently.  An entry point given no device
runs on the current CUDA device, or on the device set for the whole
process by :func:`use_device` (the counterpart of ``JAX_PLATFORMS=cpu``);
with neither, it raises.  The CPU runs only when a caller asks for it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..scores import StripedScores
from ..sequence import EncodedSequence, StripedSequence
from ..utils import profiling
from . import kernels, torch_ops

__all__ = [
    "DeviceSequence",
    "Pipeline",
    "default_device",
    "default_pipeline",
    "resolve_device",
    "score",
    "use_device",
]

#: Uploaded sequences are padded with the wildcard to a multiple of the
#: kernel's tile (positions per block), so every block scores a full
#: tile.  Padded windows score like the reference's wildcard wrap rows.
PAD_MULTIPLE = 1024


def pad_length(n: int, multiple: int = PAD_MULTIPLE) -> int:
    return max(multiple, -(-n // multiple) * multiple)


#: The device set by :func:`use_device`; ``None`` = the current CUDA device.
_CHOSEN: torch.device | None = None


def use_device(device) -> None:
    """Set the device of every entry point that is given none, for the
    whole process (``"cpu"`` to run the plain versions); ``None`` clears
    the choice."""
    global _CHOSEN, _DEFAULT
    _CHOSEN = None if device is None else torch.device(device)
    _DEFAULT = None


def default_device() -> torch.device:
    """The device of :func:`use_device`, else the current CUDA device.

    Raises ``RuntimeError`` when there is neither: the CPU is never a
    silent fallback."""
    if _CHOSEN is not None:
        return _CHOSEN
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' (or call "
            "lightmotif_tpu_torch.ops.pipeline.use_device('cpu')) to run "
            "the plain PyTorch versions on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


class DeviceSequence:
    """An encoded sequence uploaded once to a device as ``uint8``,
    padded with the wildcard to :data:`PAD_MULTIPLE`."""

    # a weak reference bounds the CUDA graphs of a scan of it (.graphs)
    __slots__ = ("alphabet", "length", "data", "__weakref__")

    def __init__(self, encoded: EncodedSequence, device: torch.device):
        self.alphabet = encoded.alphabet
        self.length = len(encoded)
        n = pad_length(self.length)
        with profiling.span("upload.pad", bytes=n):
            host = np.full(n, encoded.alphabet.default_index, dtype=np.uint8)
            host[: self.length] = encoded.data
        with profiling.span("upload.copy"):
            self.data = torch.from_numpy(host).to(device)

    @property
    def device(self) -> torch.device:
        return self.data.device


def as_device_seq(seq, device: torch.device) -> DeviceSequence:
    if isinstance(seq, DeviceSequence):
        if seq.device != device:
            raise ValueError(f"sequence lives on {seq.device}, not {device}")
        return seq
    if isinstance(seq, StripedSequence):
        seq = seq.unstripe()
    if isinstance(seq, EncodedSequence):
        return DeviceSequence(seq, device)
    raise TypeError(f"cannot score {type(seq).__name__}")


def resolve_device(device) -> torch.device:
    device = default_device() if device is None else torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class Pipeline:
    """Scoring on one device."""

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def _table(self, matrix, dtype) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(matrix.data, dtype=dtype),
                               device=self.device)

    def score(self, pssm, seq) -> StripedScores:
        """f32 scores of every position (reference ``Score`` trait)."""
        dseq = as_device_seq(seq, self.device)
        n = max(dseq.length - len(pssm) + 1, 0)
        if n == 0:
            return StripedScores(np.zeros(0, np.float32), 0)
        out = kernels.score_f32(dseq.data, self._table(pssm, np.float32), n)
        return StripedScores(out[:n].cpu().numpy(), n)

    def score_discrete(self, dm, seq) -> StripedScores:
        """int32 over-estimating discrete scores (reference u8 path)."""
        dseq = as_device_seq(seq, self.device)
        n = max(dseq.length - len(dm) + 1, 0)
        if n == 0:
            return StripedScores(np.zeros(0, np.int32), 0)
        out = kernels.score_u8(dseq.data, self._table(dm, np.uint8), n)
        return StripedScores(out[:n].cpu().numpy(), n)

    def max(self, scores: StripedScores):
        return scores.max()

    def argmax(self, scores: StripedScores):
        return scores.argmax()

    def threshold(self, scores: StripedScores, value) -> list:
        return scores.threshold(value)

    def score_max(self, pssm, seq):
        """(max score, argmax) of every window, reduced on the device;
        the last maximum wins ties."""
        dseq = as_device_seq(seq, self.device)
        n = max(dseq.length - len(pssm) + 1, 0)
        if n == 0:
            return None, None
        # slice off the -inf padding so an all--inf score vector still
        # argmaxes to the last valid window
        scores = kernels.score_f32(dseq.data, self._table(pssm, np.float32), n)[:n]
        return (float(torch_ops.max_last(scores)),
                int(torch_ops.argmax_last(scores)))


_DEFAULT: Pipeline | None = None


def default_pipeline() -> Pipeline:
    """The pipeline of :func:`default_device` (rebuilt by :func:`use_device`)."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = Pipeline()
    return _DEFAULT


def score(pssm, seq) -> StripedScores:
    return default_pipeline().score(pssm, seq)
