"""Model FLOPs of the traced window's completed frames over its length, as a share of 989 TFLOP/s (bf16, dense)."""

from yardstick import records, work


def read(rec):
    m = rec.mix
    flops = work.forward_flops(rec.cfg["widths"], m["height"], m["width"],
                               rec.cfg.get("semantic_classes", 0))
    return records.mfu(rec, flops)
