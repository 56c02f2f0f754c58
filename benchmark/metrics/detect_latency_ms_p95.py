"""The 95th percentile of every request's ms from submission to results in host memory."""

from yardstick import records


def read(rec):
    return records.latency_ms(rec, 95)
