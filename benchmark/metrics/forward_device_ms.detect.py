"""Mean device ms of the program's forward span (``ssp.detect.forward``: the folded bf16 network) over the device-traced requests."""

from yardstick import spans


def read(rec):
    return spans.mean_device_ms(spans.of_traced_requests(rec), "ssp.detect.forward")
