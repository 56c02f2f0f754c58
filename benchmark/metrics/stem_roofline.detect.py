"""The stem kernel's least time over its device time (csrc/stem.cu, one launch a request), traced window."""

from yardstick import records, work


def read(rec):
    m = rec.mix
    least = work.stem_least_s(m["batch"], m["height"], m["width"], rec.cfg["widths"]["c1"])
    return records.roofline(rec, "stem_kernel", least)
