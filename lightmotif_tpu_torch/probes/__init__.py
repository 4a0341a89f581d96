"""Probes of the port's CUDA kernels on the card, each beside its plain
version: :mod:`.prefilter` (the multi-motif prefilter, P6, P7, P8 and
P10)."""
