"""Mean MB a request uploads from pageable (not page-locked) host memory, the upload span's ``pageable_bytes`` over the device-traced requests."""

from yardstick import spans


def read(rec):
    mean = spans.mean_count(spans.of_traced_requests(rec), "ssp.detect.upload", "pageable_bytes")
    return None if mean is None else mean / 1e6
