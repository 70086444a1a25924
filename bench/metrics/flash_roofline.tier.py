"""The flash launches' least possible time over their device time (%)."""
from bench.harness.readers import roofline

KERNEL = "flash_attention"


def read(rec):
    return roofline(rec, "flash_attention")
