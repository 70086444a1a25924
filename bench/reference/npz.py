"""Read a parameter archive of ``/``-joined key paths (bf16 leaves stored
as int16 bit patterns under ``<path>@bfloat16``) into nested dicts of
float32 tensors, with NumPy and PyTorch alone."""
from __future__ import annotations

import hashlib

import numpy as np
import torch


def sha256(path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def load(path, device="cpu") -> dict:
    tree: dict = {}
    with np.load(path, allow_pickle=False) as data:
        for key in data.files:
            a = data[key]
            if key.endswith("@bfloat16"):
                key = key[:-len("@bfloat16")]
                t = torch.from_numpy(a.astype(np.int32) << 16).view(
                    torch.float32)
            else:
                t = torch.from_numpy(np.array(a, np.float32))
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = t.to(device)
    return tree
