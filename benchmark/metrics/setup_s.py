"""Set-up seconds: process start to the window's start (imports, weights, inputs, warm-up, kernel builds)."""

from yardstick import records


def read(rec):
    return rec.setup_s if rec.setup_s > 0 else None
