"""Mean host ms of the program's upload span (``ssp.detect.upload``: the request's frames to the card) over the device-traced requests."""

from yardstick import spans


def read(rec):
    return spans.mean_host_ms(spans.of_traced_requests(rec), "ssp.detect.upload")
