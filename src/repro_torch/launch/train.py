"""Training launcher of the port: the counterpart of
``src/repro/launch/train.py``.

* ``--arch <id> --smoke``: the per-arch reduced config (what
  ``examples/train_weak_fm_torch.py`` drives).
* ``--arch <id>``: the full config, on one card. Sharded training over a
  mesh of cards is not ported; ``python -m repro_torch.launch.dryrun``
  runs the distributed step without devices.

Training runs on ``--device`` (the card by default; ``--device cpu`` on a
machine without one). JAX's ``donate_argnums`` has no counterpart: the
step returns new parameter and optimizer trees and the old ones are
freed when the loop drops them.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --device cuda --steps 100 --batch 16 --seq 64
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.training import (AdamWConfig, init_opt_state,
                                  make_train_step, save_checkpoint)


def synthetic_lm_batch(rng: np.random.Generator, vocab: int, batch: int,
                       seq: int, cfg) -> dict:
    """Structured synthetic LM data (Zipf-ish marginals + copy structure so
    the loss actually falls during smoke training)."""
    base = rng.zipf(1.5, size=(batch, seq)).astype(np.int64)
    tokens = np.minimum(base, vocab - 1).astype(np.int32)
    # periodic copy structure: second half repeats the first half
    tokens[:, seq // 2:] = tokens[:, :seq - seq // 2]
    labels = np.concatenate([tokens[:, 1:], tokens[:, :1]], axis=1)
    out = {"tokens": tokens, "labels": labels.astype(np.int32)}
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.normal(
            size=(batch, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = rng.normal(
            size=(batch, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    return out


def name_tensor(name: str) -> torch.Tensor:
    """A config name as a checkpoint leaf (its UTF-8 bytes): the npz
    format holds tensors only."""
    return torch.tensor(list(name.encode()), dtype=torch.uint8)


def tensor_name(t: torch.Tensor) -> str:
    return bytes(t.tolist()).decode()


def train(arch: str, *, smoke: bool, steps: int, batch: int, seq: int,
          lr: float, ckpt: str | None, log_every: int = 10,
          device="cuda") -> dict:
    """Train ``arch`` from ``init_params(cfg, 0)`` on seeded synthetic
    batches; returns the last step's metrics. ``ckpt`` saves
    ``{"params", "cfg_name"}`` (:func:`tensor_name` reads the name)."""
    cfg = configs.get_smoke(arch) if smoke else configs.get(arch)
    dev = resolve_device(device)
    print(f"[train] {cfg.name}: {cfg.param_count():,} params "
          f"({cfg.active_param_count():,} active)")
    params = init_params(cfg, 0, device=dev)
    opt_cfg = AdamWConfig(learning_rate=lr, warmup_steps=min(20, steps // 5),
                          total_steps=steps)
    opt_state = init_opt_state(params)
    step_fn = make_train_step(cfg, opt_cfg)

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    metrics = {}
    for i in range(steps):
        b = synthetic_lm_batch(rng, cfg.vocab_size, batch, seq, cfg)
        b = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        params, opt_state, metrics = step_fn(params, opt_state, b)
        if (i + 1) % log_every == 0 or i == 0:
            print(f"  step {i + 1}/{steps} loss={float(metrics['loss']):.4f}"
                  f" acc={float(metrics['accuracy']):.3f}"
                  f" lr={float(metrics['lr']):.2e}"
                  f" ({(time.perf_counter() - t0) / (i + 1) * 1e3:.0f} ms/step)")
    if ckpt:
        save_checkpoint(ckpt, {"params": params,
                               "cfg_name": name_tensor(cfg.name)})
        print(f"[train] checkpoint → {ckpt}")
    return {k: float(v) for k, v in metrics.items()}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    return train(args.arch, smoke=args.smoke, steps=args.steps,
                 batch=args.batch, seq=args.seq, lr=args.lr, ckpt=args.ckpt,
                 device=args.device)


if __name__ == "__main__":
    main()
