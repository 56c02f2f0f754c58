"""The NMS kernel's least time over its device time (csrc/nms.cu, one launch a request), traced window."""

from yardstick import records, work


def read(rec):
    m = rec.mix
    least = work.nms_least_s(m["batch"], m["height"], m["width"], m["nms_radius"])
    return records.roofline(rec, "nms_kernel", least)
