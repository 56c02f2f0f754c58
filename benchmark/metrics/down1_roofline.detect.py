"""The down1 kernel's least time over its device time (csrc/down1.cu, two launches a request), traced window."""

from yardstick import records, work


def read(rec):
    m = rec.mix
    least = work.down1_least_s(m["batch"], m["height"], m["width"], rec.cfg["widths"]["c1"])
    return records.roofline(rec, "conv3x3_kernel", least, launches=2)
