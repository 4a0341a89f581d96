"""The host's part of the upload per traced scan, in ms (median): the
program's spans ``upload.pad`` (the padded host buffer) and
``upload.copy`` (the call that copies it to the card)."""

from motifbench import spans


def read(run):
    return spans.median_ms(spans.traced_scans(run), ("upload.pad", "upload.copy"))
