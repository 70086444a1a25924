"""Random LM weights from the seed, made on the device by one generator
in a few large calls (one per stacked leaf), in the type they are served
in, in the parameter tree the measured package's models take: stacked
layers, attention projections with a head axis, zero-centred norm scales,
a float32 MoE router. Fan-in normal: std = fan_in ** -0.5; the embedding
unit normal."""
from __future__ import annotations

import torch


def lm_params(model: dict, seed: int, device) -> dict:
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        model["param_dtype"]]
    n, D, H, KV, hd, Fd, V = (model[k] for k in (
        "num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim",
        "d_ff", "vocab_size"))

    def rand(shape, fan_in, dtype=dt):
        t = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
        return t.mul_(fan_in ** -0.5)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    layers = {"ln1": {"scale": zeros(n, D)}, "ln2": {"scale": zeros(n, D)},
              "attn": {"wq": rand((n, D, H, hd), D),
                       "wk": rand((n, D, KV, hd), D),
                       "wv": rand((n, D, KV, hd), D),
                       "wo": rand((n, H, hd, D), hd)}}
    E = model.get("num_experts", 0)
    if E:
        layers["moe"] = {"router": rand((n, D, E), D, torch.float32),
                         "w_gate": rand((n, E, D, Fd), D),
                         "w_up": rand((n, E, D, Fd), D),
                         "w_down": rand((n, E, Fd, D), Fd)}
    else:
        layers["mlp"] = {"w_gate": rand((n, D, Fd), D),
                         "w_up": rand((n, D, Fd), D),
                         "w_down": rand((n, Fd, D), Fd)}
    params = {"embed": rand((V, D), 1), "final_norm": {"scale": zeros(D)},
              "layers": layers}
    if not model.get("tie_embeddings", True):
        params["unembed"] = rand((V, D), D)
    return params
