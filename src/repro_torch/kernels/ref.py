"""The plain versions under the names of the JAX package's oracles
(``src/repro/kernels/ref.py``), so a test holds each twin to its
counterpart by name. The functions live beside their kernels."""
from repro_torch.kernels.decode_attention import NEG_INF  # noqa: F401
from repro_torch.kernels.decode_attention import \
    decode_attention_plain as decode_attention  # noqa: F401
from repro_torch.kernels.flash_attention import \
    flash_attention_plain as flash_attention  # noqa: F401
from repro_torch.kernels.memory_ivf import \
    ivf_route_batch_padded_plain as ivf_route_batch_padded  # noqa: F401
from repro_torch.kernels.memory_ivf import \
    ivf_route_padded_plain as ivf_route_padded  # noqa: F401
from repro_torch.kernels.memory_topk import _topk_select  # noqa: F401
from repro_torch.kernels.memory_topk import \
    memory_top1_batch_padded_plain as memory_top1_batch_padded  # noqa: F401
from repro_torch.kernels.memory_topk import \
    memory_top1_batch_plain as memory_top1_batch  # noqa: F401
from repro_torch.kernels.memory_topk import \
    memory_top1_padded_plain as memory_top1_padded  # noqa: F401
from repro_torch.kernels.memory_topk import \
    memory_top1_plain as memory_top1  # noqa: F401
from repro_torch.kernels.memory_topk import \
    memory_topk_batch_padded_plain as memory_topk_batch_padded  # noqa: F401
from repro_torch.kernels.memory_topk import \
    memory_topk_padded_plain as memory_topk_padded  # noqa: F401
