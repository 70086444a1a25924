"""The store read (``csrc/memory_topk.cu``, device name
``topk_scan_kernel``): B queries against every row of the padded store.
Operations 2·B·C·E (f32, outside the tensor cores); bytes: the rows, the
mask word of each row and the queries read once, each query's k (sim,
row) written once."""

OPS = ("repro_torch.kernels.ops", "memory_topk_batch_padded")
DTYPE = "float32"


def match(name: str) -> bool:
    return "topk_scan_kernel" in name


def shape(mem, qs, mask, k, *args, **kw) -> dict:
    return {"C": int(mem.shape[0]), "E": int(qs.shape[1]),
            "B": int(qs.shape[0]), "k": int(k)}


def flops(c: dict) -> float:
    return 2.0 * c["B"] * c["C"] * c["E"]


def bytes_moved(c: dict) -> float:
    return 4.0 * (c["C"] * c["E"] + c["C"] + c["B"] * c["E"] +
                  2 * c["B"] * c["k"])
