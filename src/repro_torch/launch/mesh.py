"""Production mesh construction, the counterpart of
``src/repro/launch/mesh.py``, with an NVIDIA H100's constants.

Two objects stand for a mesh. Its description,
:class:`~repro_torch.models.sharding.MeshShape`, maps axis name to size
(what JAX's ``Mesh.shape`` is): the placement rules read only that.
:func:`device_mesh` builds a ``torch.distributed`` ``DeviceMesh`` of the
same shape over the process group that is current, which the dry run
(:mod:`repro_torch.launch.dryrun`) starts as a fake group of 256 or 512
ranks. These are functions: importing this module touches no device and
no process group.

The logical shapes are the JAX package's, so that the port's specs equal
the reference's: one pod is 16 x 16 (``data`` x ``model``), two pods
2 x 16 x 16.
"""
from __future__ import annotations

from repro_torch.models.sharding import MeshShape

# One H100 SXM, from NVIDIA's data sheet (dense, no sparsity, at 700 W).
PEAK_FLOPS = 989e12          # bf16 FLOP/s per card
HBM_BW = 3.35e12             # bytes/s per card
HBM_BYTES = 80e9             # device memory per card, for the fit check
# A 16-wide mesh axis over 8-GPU nodes spans two nodes, so a collective on
# it waits on its slowest link: one 400 Gb/s NDR InfiniBand port per GPU,
# 50e9 bytes/s (NVLink within a node is faster and not the bound).
LINK_BW = 50e9               # bytes/s per link


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape({"pod": 2, "data": 16, "model": 16})
    return MeshShape({"data": 16, "model": 16})


def make_debug_mesh(n_data: int = 2, n_model: int = 2) -> MeshShape:
    """A small mesh (tests)."""
    return MeshShape({"data": n_data, "model": n_model})


def device_mesh(mesh: MeshShape, device_type: str = "cpu"):
    """A ``DeviceMesh`` of ``mesh``'s shape and axis names over ranks
    0..size-1 of the default process group, which must be started and
    hold ``mesh.size`` ranks."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    ranks = torch.arange(mesh.size).reshape(tuple(mesh.shape.values()))
    return DeviceMesh(device_type, ranks, mesh_dim_names=mesh.axis_names)
