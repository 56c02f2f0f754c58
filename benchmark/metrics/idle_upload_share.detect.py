"""Share of the host-traced window in which the card is idle while the host is inside the program's upload span (``ssp.detect.upload``)."""

from yardstick import spans


def read(rec):
    return spans.idle_share_inside(rec.host_trace, "ssp.detect.upload")
