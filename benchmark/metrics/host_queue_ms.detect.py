"""The host's mean ms from a request's submission until the program's call returns, over the window's requests (untraced)."""

from yardstick import records


def read(rec):
    return records.host_ms(rec)
