"""Roofline terms of one step as the dry run runs it: the counterpart of
``src/repro/launch/roofline.py``.

    compute term    = FLOPs per device / peak FLOP/s
    memory term     = bytes per device / HBM bytes/s
    collective term = collective bytes per device / link bytes/s

with an H100's constants (:mod:`repro_torch.launch.mesh`) as defaults.

The JAX package reads the first two from the compiled executable's
``cost_analysis()`` and parses the collectives out of XLA's optimized HLO
text (``collective_bytes(hlo_text)``). The port compiles no program and
produces no HLO, so it counts the step while it runs:
:class:`StepCounter` is a dispatch mode that sees every operation the
DTensors of the dry run run on their local shards, on one device, and
sums

* FLOPs, with ``torch.utils.flop_counter``'s formulas (the ones
  ``FlopCounterMode`` uses) on the local shapes, so per device as
  ``cost_analysis`` is;
* bytes, each operation's tensor operands and results (views,
  allocations and metadata queries move none);
* collective bytes per kind, the operand bytes of each functional
  collective (``_c10d_functional``) that DTensor issues to redistribute.

Operations DTensor runs on global shapes only to propagate shapes are not
the step's and are not counted.
"""
from __future__ import annotations

import dataclasses
import sys

import torch

from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# functional collective op name -> kind
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "permute_tensor": "collective-permute",
}

_NO_TRAFFIC = ("empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "size", "sym_size", "stride",
               "sym_stride", "numel", "sym_numel", "dim", "device",
               "layout", "is_contiguous", "storage_offset",
               "sym_storage_offset", "wait_tensor", "_local_scalar_dense")


def _tensors(tree) -> list:
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _in_shape_propagation() -> bool:
    """True inside DTensor's global-shape propagation (an operation run on
    fakes of the global shapes to learn the output's metadata)."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name.startswith("_propagate_tensor_meta"):
            return True
        f = f.f_back
    return False


class StepCounter:
    """Counts FLOPs, bytes and collectives of the local operations run
    under it (a ``TorchDispatchMode``, made by :meth:`mode`). Enter it
    inside the fake mode, so that it sees each operation before the fake
    mode does.

    ``place(func, args, kwargs, rollback)``, where given, runs each
    operation on DTensors in place of ``func(*args, **kwargs)`` (the dry
    run's placement fallbacks); what it runs is counted, and
    ``rollback()`` takes back what a failed attempt counted."""

    def __init__(self, place=None):
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives = {k: 0 for k in COLLECTIVES}
        self.collective_counts = {k: 0 for k in COLLECTIVES}
        self.place = place

    def mode(self):
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry
        counter = self

        class _Mode(TorchDispatchMode):
            inside = False

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if not any(issubclass(t, DTensor) for t in types):
                    out = func(*args, **kwargs)
                    counter._count(func, args, kwargs, out, flop_registry)
                    return out
                if self.inside:
                    return NotImplemented    # DTensor runs it on shards
                self.inside = True
                try:
                    with self:               # count what DTensor runs
                        if counter.place is None:
                            return func(*args, **kwargs)
                        return counter.place(func, args, kwargs,
                                             counter._rollback_to())
                finally:
                    self.inside = False

        return _Mode()

    def _rollback_to(self):
        """A callable that restores the counts to what they are now."""
        state = (self.flops, self.bytes, dict(self.collectives),
                 dict(self.collective_counts))

        def rollback():
            self.flops, self.bytes = state[0], state[1]
            self.collectives, self.collective_counts = (dict(state[2]),
                                                        dict(state[3]))
        return rollback

    def _count(self, func, args, kwargs, out, flop_registry) -> None:
        name = func._schema.name.split("::")[-1]
        if name in _NO_TRAFFIC or func.is_view:
            return
        if _in_shape_propagation():
            return
        kind = _COLLECTIVE_OPS.get(name)
        if kind is not None:
            self.collectives[kind] += sum(_nbytes(t) for t in
                                          _tensors((args, kwargs)))
            self.collective_counts[kind] += 1
            return
        fn = flop_registry.get(func._overloadpacket)
        if fn is not None:
            self.flops += fn(*args, **kwargs, out_val=out)
        self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs, out)))


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collectives: dict
    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    link_bw: float = LINK_BW

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / self.hbm_bw

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_device / self.link_bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    def to_dict(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "collectives": self.collectives,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
        }


def analyze(counter: StepCounter) -> Roofline:
    """The roofline of what ``counter`` counted (the counterpart of
    ``analyze(compiled)``)."""
    return Roofline(
        flops_per_device=float(counter.flops),
        bytes_per_device=float(counter.bytes),
        collective_bytes_per_device=float(sum(counter.collectives.values())),
        collectives=dict(counter.collectives),
    )
