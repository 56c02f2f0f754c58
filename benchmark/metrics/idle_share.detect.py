"""Share of the traced window in which no kernel, copy or memset ran on the card."""

from yardstick import records


def read(rec):
    return records.idle_share(rec)
