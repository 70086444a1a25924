"""Logical sharding rules with divisibility fallback: the counterpart of
``src/repro/models/sharding.py``, as pure functions of a mesh description.

MaxText-style: every parameter / activation gets an ordered list of
``(dim, mesh_axis)`` preferences; an assignment is taken greedily when the
dim size divides the mesh axis size and neither the dim nor the axis is
already used. Anything that doesn't divide cleanly is replicated on that
axis — this is what keeps odd configs (granite's 40 experts / 24 heads,
49155-token vocab) placeable on a 16×16 mesh without padding.

Two modes:
* ``serve`` — tensor-parallel on "model", batch on ("pod","data"),
  weights replicated over "data".
* ``train`` — FSDP: same "model" assignments, plus the other major dim of
  every weight sharded on "data" so AdamW state fits.

A mesh is any object whose ``shape`` maps axis name to size (JAX's
``Mesh``, a :class:`MeshShape`, such as :func:`describe` gives of a
``DeviceMesh``). A rule gives a
:class:`PartitionSpec`, one entry per tensor dim: ``None``, an axis name
or a tuple of names; :func:`to_placements` turns it into the DTensor
placements of a ``DeviceMesh``. Trees are the port's nested dicts.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

from repro_torch.tree import tree_map

Prefs = list[tuple[int, Any]]

STACKED_GROUPS = ("layers", "attn_layers", "rglru_layers", "enc_layers")


class PartitionSpec(tuple):
    """Per tensor dim, the mesh axis (or tuple of axes) it is split over,
    or None: ``PartitionSpec(None, "model")``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's description: ``shape`` maps axis name to size, in the
    mesh's axis order."""
    shape: dict

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def describe(device_mesh) -> MeshShape:
    """The description of a torch ``DeviceMesh`` (whose ``shape`` is a
    tuple of sizes)."""
    return MeshShape(dict(zip(device_mesh.mesh_dim_names,
                              device_mesh.shape)))


def _axis_size(mesh, axis) -> int:
    if isinstance(axis, tuple):
        size = 1
        for a in axis:
            size *= mesh.shape[a]
        return size
    return mesh.shape[axis]


def spec_from_prefs(shape: tuple[int, ...], prefs: Prefs, mesh,
                    offset: int = 0) -> PartitionSpec:
    """Greedy assignment of mesh axes to dims with divisibility checks."""
    assigned: dict[int, Any] = {}
    used: set = set()          # individual mesh-axis names already taken
    for dim, axis in prefs:
        dim += offset
        parts = axis if isinstance(axis, tuple) else (axis,)
        if dim in assigned or any(a in used for a in parts) or \
                dim >= len(shape):
            continue
        if not all(a in mesh.shape for a in parts):
            continue
        if shape[dim] % _axis_size(mesh, axis) == 0 and shape[dim] > 0:
            assigned[dim] = axis
            used.update(parts)
    return P(*[assigned.get(i) for i in range(len(shape))])


def batch_axes(mesh):
    """('pod','data') on the multi-pod mesh, 'data' on the single-pod one."""
    return ("pod", "data") if "pod" in mesh.shape else "data"


# ---------------------------------------------------------------------------
# Parameter rules
# ---------------------------------------------------------------------------


def _param_prefs(leaf_name: str, ndim: int, mode: str, mesh) -> Prefs:
    """Preferences per parameter kind (dims are *after* stripping any
    stacked layer axis)."""
    fsdp = mode == "train"
    d = "data"
    if leaf_name in ("embed", "unembed"):            # (V, D)
        return [(0, "model")] + ([(1, d)] if fsdp else [])
    if leaf_name in ("wq", "wk", "wv"):              # (D, H, hd)
        return [(1, "model"), (0, "model")] + ([(0, d)] if fsdp else [])
    if leaf_name == "wo":                            # (H, hd, D)
        return [(0, "model"), (2, "model")] + ([(2, d)] if fsdp else [])
    if leaf_name in ("w_up", "w_gate") and ndim == 2:   # (D, F)
        return [(1, "model")] + ([(0, d)] if fsdp else [])
    if leaf_name == "w_down" and ndim == 2:          # (F, D)
        return [(0, "model")] + ([(1, d)] if fsdp else [])
    if leaf_name in ("w_up", "w_gate") and ndim == 3:   # MoE (E, D, F)
        return [(0, "model"), (2, "model")] + ([(2, d), (1, d)] if fsdp else [])
    if leaf_name == "w_down" and ndim == 3:          # MoE (E, F, D)
        return [(0, "model"), (1, "model")] + ([(1, d), (2, d)] if fsdp else [])
    if leaf_name == "router":                        # (D, E)
        return []
    if leaf_name == "in_proj":                       # (D, Din)
        return [(1, "model")] + ([(0, d)] if fsdp else [])
    if leaf_name == "out_proj":                      # (Din, D)
        return [(0, "model")] + ([(1, d)] if fsdp else [])
    if leaf_name in ("w_gate_branch", "w_rnn_branch"):  # (D, R)
        return [(1, "model")] + ([(0, d)] if fsdp else [])
    if leaf_name in ("w_a", "w_i"):                  # (R, R)
        return [(1, "model")] + ([(0, d)] if fsdp else [])
    if leaf_name == "w" and ndim == 2:               # conv (k, C)
        return [(1, "model")]
    # 1-D params (norm scales, biases, A_log, D, dt_bias, lambda) replicate.
    return []


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in
                tree.items()}
    return fn(path, tree)


def param_shardings(params_shape: Any, mesh, mode: str) -> Any:
    """Tree of :class:`PartitionSpec` matching a tree of leaves with a
    ``shape`` (tensors, fake tensors)."""

    def one(keys, leaf):
        leaf_name = keys[-1]
        stacked = any(k in STACKED_GROUPS for k in keys[:-1])
        offset = 1 if stacked else 0
        ndim = len(leaf.shape) - offset
        prefs = _param_prefs(leaf_name, ndim, mode, mesh)
        return spec_from_prefs(tuple(leaf.shape), prefs, mesh, offset=offset)

    return _map_with_path(one, params_shape)


# ---------------------------------------------------------------------------
# Activation / batch / cache rules
# ---------------------------------------------------------------------------


def batch_shardings(batch_shape: Any, mesh) -> Any:
    """tokens/labels (B, S), frames/patches (B, S, D): batch → data axes."""
    b = batch_axes(mesh)
    return tree_map(
        lambda leaf: spec_from_prefs(tuple(leaf.shape), [(0, b)], mesh),
        batch_shape)


def cache_shardings(cache_shape: Any, mesh) -> Any:
    """KV / state caches. Preference order: batch→data, heads→model, then
    (for batch=1 long-context) sequence→data: context-parallel decode."""
    b = batch_axes(mesh)

    def one(keys, leaf):
        name = keys[-1]
        if name in ("k", "v", "cross_k", "cross_v"):
            # (L, B, M, KV, hd)
            prefs = [(1, b), (3, "model"), (2, "model"), (2, "data")]
        elif name == "ssd":
            # (L, B, H, P, N)
            prefs = [(1, b), (2, "model")]
        elif name == "h":
            # (L, B, R)
            prefs = [(1, b), (2, "model")]
        elif name == "conv":
            # (L, B, k-1, C)
            prefs = [(1, b), (3, "model")]
        else:
            prefs = [(1, b)]
        return spec_from_prefs(tuple(leaf.shape), prefs, mesh)

    return _map_with_path(one, cache_shape)


def replicated(mesh) -> PartitionSpec:
    return P()


def to_placements(spec: PartitionSpec, device_mesh) -> list:
    """The DTensor placements of ``spec`` on ``device_mesh``, one per mesh
    dim: ``Shard(d)`` where tensor dim d is split over that mesh dim (a
    tuple entry such as ``("pod", "data")`` splits d over each of its
    axes, outermost first in the mesh's order), else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in device_mesh.mesh_dim_names:
        dims = [d for d, axis in enumerate(spec) if axis is not None and
                name in (axis if isinstance(axis, tuple) else (axis,))]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out
