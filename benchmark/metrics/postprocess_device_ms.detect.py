"""Mean device ms of the program's postprocess span (``ssp.detect.postprocess``: flatten, NMS, top-k, refinement, sampling) over the device-traced requests."""

from yardstick import spans


def read(rec):
    return spans.mean_device_ms(spans.of_traced_requests(rec), "ssp.detect.postprocess")
