"""Frames of completed requests over the window's host seconds."""

from yardstick import records


def read(rec):
    return records.rate(rec)
