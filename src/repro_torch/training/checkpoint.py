"""Checkpoints of nested dicts of tensors: the counterpart of
``src/repro/training/checkpoint.py``, without pickle.

One ``.npz`` whose keys are the leaves' ``/``-joined key paths, written to
a temporary file and renamed into place. A bf16 leaf is stored as its bit
pattern (int16) under its path plus ``@bfloat16``. Empty dicts are not
stored. Loading gives tensors on ``device``.
"""
from __future__ import annotations

import os
import tempfile
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device

_BF16 = "@bfloat16"


def _flatten(tree: Any, prefix: str, out: dict) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            if not isinstance(k, str) or "/" in k or _BF16 in k:
                raise ValueError(f"checkpoint key {k!r} at {prefix or '/'}: "
                                 f"keys are strings without '/'")
            _flatten(v, f"{prefix}/{k}" if prefix else k, out)
        return
    if torch.is_tensor(tree):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            out[prefix + _BF16] = t.view(torch.int16).numpy()
            return
        out[prefix] = t.numpy()
        return
    out[prefix] = np.asarray(tree)


def save_checkpoint(path: str, tree: Any) -> None:
    arrays: dict = {}
    _flatten(tree, "", arrays)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str, device="cuda") -> Any:
    dev = resolve_device(device)
    tree: dict = {}
    with np.load(path, allow_pickle=False) as data:
        for key in data.files:
            a = data[key]
            if key.endswith(_BF16):
                key = key[:-len(_BF16)]
                t = torch.from_numpy(a).view(torch.bfloat16)
            else:
                t = torch.from_numpy(a)
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = t.to(dev)
    return tree
