"""The store reads' least possible time over their device time (%)."""
from bench.harness.readers import roofline

KERNEL = "memory_topk"


def read(rec):
    return roofline(rec, "memory_topk")
