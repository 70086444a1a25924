"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit)."""

FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12,
         "float16": 989e12, "fp8": 1979e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12
HBM_BYTES = 80e9


def bound_s(flops: float, bytes_moved: float, dtype: str) -> float:
    """The least time the card could take: the larger of the operations
    at the dtype's peak and the bytes at HBM bandwidth."""
    return max(flops / FLOPS[dtype], bytes_moved / HBM_BYTES_PER_S)
