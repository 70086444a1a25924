"""Train-step factory: the counterpart of
``src/repro/training/train_step.py``.

``torch.autograd`` over :func:`repro_torch.models.loss_fn` (the training
forward, with the model-level attention), then one AdamW update.
``grad_accum > 1`` splits the batch into that many microbatches along its
first axis and sums their f32 gradients in a Python loop, as the JAX
version's ``lax.scan`` does.

``batch_axes`` (a mesh axis name or a tuple of them) takes a batch of
DTensors, as the dry run (:mod:`repro_torch.launch.dryrun`) places it:
each microbatch, the same rows as without it, is redistributed to be
split by rows over those axes and replicated over the others, the
counterpart of JAX's ``with_sharding_constraint`` after the reshape. On
plain tensors it raises: sharded training on cards is not ported.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.models import loss_fn
from repro_torch.models.config import ModelConfig
from repro_torch.training.optimizer import AdamWConfig, adamw_update
from repro_torch.tree import leaves, tree_map, unflatten

METRIC_KEYS = ("ce", "aux", "accuracy")


def value_and_grad(fn: Callable, params: Any, *args) -> tuple:
    """((value, aux), grads) of ``fn(params, *args) -> (value, aux)``:
    ``jax.value_and_grad(fn, has_aux=True)``. The parameters are taken as
    fresh leaves, so the caller's tensors never require grad; value, aux
    and grads come back detached."""
    with torch.enable_grad():
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        value, aux = fn(p, *args)
        grads = torch.autograd.grad(value, leaves(p))
    return ((value.detach(), tree_map(torch.Tensor.detach, aux)),
            unflatten(p, grads))


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig | None = None,
                    *, grad_accum: int = 1,
                    batch_axes: Any = None) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics). ``batch`` holds ``tokens`` and ``labels`` (B, S), tensors or
    arrays; they are moved to the parameters' device."""
    opt_cfg = opt_cfg or AdamWConfig()
    axes = (batch_axes if isinstance(batch_axes, tuple) or batch_axes is None
            else (batch_axes,))

    def constrain(x):
        if axes is None:
            return x
        from torch.distributed.tensor import DTensor, Replicate, Shard
        if not isinstance(x, DTensor):
            raise NotImplementedError(
                "batch_axes takes a batch of DTensors; sharded training of "
                "plain tensors on several cards is not ported")
        mesh = x.device_mesh
        return x.redistribute(mesh, [Shard(0) if n in axes else Replicate()
                                     for n in mesh.mesh_dim_names])

    def loss(params, batch):
        return loss_fn(cfg, params, batch)

    def train_step(params: Any, opt_state: dict, batch: dict):
        dev = leaves(params)[0].device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if axes is not None and grad_accum == 1:
            batch = {k: constrain(v) for k, v in batch.items()}
        if grad_accum == 1:
            (total, metrics), grads = value_and_grad(loss, params, batch)
        else:
            n = next(iter(batch.values())).shape[0] // grad_accum
            gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), params)
            msum = {k: torch.zeros((), dtype=torch.float32, device=dev)
                    for k in METRIC_KEYS + ("loss",)}
            for i in range(grad_accum):
                mb = {k: constrain(v[i * n:(i + 1) * n])
                      for k, v in batch.items()}
                (l, m), g = value_and_grad(loss, params, mb)
                gsum = tree_map(lambda a, gg: a + gg.to(torch.float32),
                                gsum, g)
                msum = dict({k: msum[k] + m[k] for k in METRIC_KEYS},
                            loss=msum["loss"] + l)
            grads = tree_map(lambda g: g / grad_accum, gsum)
            metrics = {k: msum[k] / grad_accum for k in METRIC_KEYS}
            total = msum["loss"] / grad_accum
        params, opt_state, opt_metrics = adamw_update(opt_cfg, grads,
                                                      opt_state, like=params)
        return params, opt_state, dict(metrics, loss=total, **opt_metrics)

    return train_step
