"""Device ms a step of the store read (``topk_scan_kernel``, profiler)."""
from bench.harness.readers import kernel_ms


def read(rec):
    return kernel_ms(rec, "memory_topk")
