"""Sequence attention (``csrc/flash_attention.cu``, device names
``flash_kernel_bf16``/``flash_kernel_f32``): q (B, Sq, H, hd) over k, v
(B, Sk, KV, hd). Operations 4·B·H·hd per query-key pair a query reads
(scores and values; causal: Sq(Sq+1)/2 pairs at Sq = Sk); bytes: q, k, v
read once, the output written once."""

OPS = ("repro_torch.kernels.ops", "flash_attention")


def match(name: str) -> bool:
    return "flash_kernel" in name


def shape(q, k, v, *, causal=True, window=0, scale=None, kv_len=None) -> dict:
    B, Sq, H, hd = q.shape
    return {"B": int(B), "Sq": int(Sq), "Sk": int(k.shape[1]), "H": int(H),
            "KV": int(k.shape[2]), "hd": int(hd), "causal": bool(causal),
            "window": int(window), "kv_len": kv_len is not None,
            "itemsize": q.element_size(),
            "dtype": "bfloat16" if q.element_size() == 2 else "float32"}


def pairs(c: dict) -> int:
    Sq, Sk, w = c["Sq"], c["Sk"], c["window"]
    if not c["causal"]:
        return Sq * Sk
    total = 0
    for i in range(Sq):
        pos = i + Sk - Sq
        total += pos + 1 if w <= 0 else min(pos + 1, w)
    return total


def flops(c: dict) -> float:
    return 4.0 * c["B"] * c["H"] * c["hd"] * pairs(c)


def bytes_moved(c: dict) -> float:
    return c["itemsize"] * c["B"] * c["hd"] * (
        2 * c["Sq"] * c["H"] + 2 * c["Sk"] * c["KV"])
