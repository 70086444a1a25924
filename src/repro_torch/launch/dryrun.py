"""Multi-pod dry run without devices: the counterpart of
``src/repro/launch/dryrun.py``.

For an (architecture × input shape) pair this runs the real step
(``make_train_step``'s forward, backward and AdamW; ``prefill``; or
``decode_step``) once against the production mesh — 16×16 single-pod or
2×16×16 multi-pod — where the JAX package lowers and compiles it:

* a fake process group of 256 or 512 ranks
  (``torch.testing._internal.distributed.fake_pg``) carries a
  ``DeviceMesh`` of the mesh's shape; collectives on it move nothing;
* the parameters, optimizer state, batch and cache of
  :func:`repro_torch.launch.specs.input_specs` are placed on the mesh as
  DTensors by the rules of :mod:`repro_torch.models.sharding`, each
  rank's local shard a tensor of the shard's shape with no storage (a
  fake on the CPU for serving, whose attention dispatches by device to
  the plain versions; a meta tensor for training, which runs no kernel);
* the step runs on rank 0's shards under a
  :class:`~repro_torch.launch.roofline.StepCounter`, which counts its
  FLOPs, bytes and collective bytes per device, and under
  :func:`placement_rules`, which places what DTensor's per-operation
  rules place badly or not at all (:class:`Placer` replicates and
  retries where nothing else places an operation).

The step is the port's own code on the CPU path: its counted bytes
include that path's f32 upcasts of bf16 operands, the plain attention's
whole score matrices and buffers the model makes at their global size
(the MoE dispatch's), so they exceed what the card's kernels would move;
its FLOPs count the full score matrix, where the analytic terms count
the causal half.

Each record holds what JAX's holds: the memory (argument and output bytes
per device from the local shards; temp bytes null: torch's ``MemTracker``
follows ``nn.Module`` s, and the port's models are functions, so under
the dry run's modes it records nothing), the counted roofline, the
analytic terms divided by the H100's constants, ``model_flops_per_device``
and ``useful_flops_ratio``, plus whether the arguments fit one card, the
collectives' counts and the operations run replicated. A pair that
raises is recorded as ``FAILED`` with its error.

Nothing happens at import: the fake group is started per mesh when a pair
runs (a process holds one default group, so a mesh of another size
replaces it).

Usage:
    python -m repro_torch.launch.dryrun --arch llama3-8b --shape decode_32k
    python -m repro_torch.launch.dryrun --all --both-meshes [--out f.json]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch import configs
from repro_torch.launch import specs as SP
from repro_torch.launch.analytic import analytic_terms
from repro_torch.launch.mesh import (HBM_BW, HBM_BYTES, PEAK_FLOPS,
                                     device_mesh, make_production_mesh)
from repro_torch.launch.roofline import StepCounter, analyze
from repro_torch.models import decode_step, prefill
from repro_torch.models import sharding as shd
from repro_torch.training import make_train_step
from repro_torch.tree import tree_map

DEFAULT_OUT = "experiments/dryrun_results.json"


def _apply_overrides(cfg, overrides: dict | None):
    """--set key=value config overrides (perf variants)."""
    if not overrides:
        return cfg
    typed = {}
    for k, v in overrides.items():
        cur = getattr(cfg, k)
        if isinstance(cur, bool):
            typed[k] = v in ("1", "true", "True")
        elif isinstance(cur, int):
            typed[k] = int(v)
        elif isinstance(cur, float):
            typed[k] = float(v)
        else:
            typed[k] = v
    return dataclasses.replace(cfg, **typed)


def start_fake_group(world_size: int) -> None:
    """Make a fake process group of ``world_size`` ranks (this process is
    rank 0) the default group, replacing one of another size."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def distribute(tree, specs, dmesh, mode=None):
    """The fake tensors of ``tree`` as DTensors on ``dmesh`` with the
    placements of ``specs`` (a matching tree of PartitionSpecs): each
    local shard a fake of its shape made in ``mode``, or without a mode
    a tensor of the meta device."""
    from torch.distributed.tensor import DTensor, Shard

    def one(t, spec):
        placements = shd.to_placements(spec, dmesh)
        local = list(t.shape)
        for p, size in zip(placements, dmesh.shape):
            if isinstance(p, Shard):
                local[p.dim] //= size
        if mode is None:
            shard = torch.empty(local, dtype=t.dtype, device="meta")
        else:
            with mode:
                shard = torch.empty(local, dtype=t.dtype)
        return DTensor.from_local(shard, dmesh, placements, run_check=False,
                                  shape=t.shape, stride=t.stride())
    return tree_map(one, tree, specs)


# ---------------------------------------------------------------------------
# Placement: where DTensor's own rules do not reach
# ---------------------------------------------------------------------------


# What DTensor raises where it cannot place an operation or a
# redistribution (no rule, an uneven view, a planning fault of its own:
# torch 2.11's greedy redistribution planner indexes past a placement
# list on the olmoe-1b-7b prefill).
UNPLACED = (RuntimeError, IndexError)


def _dtensors(tree) -> list:
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, DTensor)]


def _replicated(n: int) -> tuple:
    from torch.distributed.tensor import Replicate
    return (Replicate(),) * n


def _as_dtensor(t, mesh):
    """A plain tensor (made by the model, global shape) as a replicated
    DTensor; DTensors as they are."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, _replicated(mesh.ndim),
                              run_check=False)


def redistribute(a, target):
    """DTensor ``a`` with ``target`` placements. Where DTensor cannot
    redistribute a fake (undoing a strided shard reorders by indices it
    computes from data), the mesh dims that change are first gathered
    (partial sums reduced) by hand: the order of a fake's elements is no
    data. The collectives are the same either way."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor
    target = tuple(target)
    if tuple(a.placements) == target:
        return a
    try:
        return a.redistribute(a.device_mesh, target)
    except UNPLACED:
        pass
    mesh = a.device_mesh
    local = a.to_local()
    mid = list(a.placements)
    for md in range(mesh.ndim):
        p = a.placements[md]
        if p == target[md] or p.is_replicate():
            continue
        if p.is_partial():
            local = funcol.all_reduce(local, p.reduce_op, (mesh, md))
        else:
            local = funcol.all_gather_tensor_autograd(local, p.dim,
                                                      (mesh, md))
        mid[md] = _replicated(1)[0]
    out = DTensor.from_local(local, mesh, mid, run_check=False,
                             shape=a.shape, stride=a.stride())
    return out.redistribute(mesh, target)


def _relaid(a):
    """DTensor ``a`` over a contiguous copy of its local shard, declared
    contiguous. DTensor can declare a contiguous global layout over a
    local shard that a transposed product left strided (seen in
    backward passes); a view of it then fails on the shard."""
    from torch.distributed.tensor import DTensor
    local = a.to_local()
    if local.is_contiguous():
        return a
    return DTensor.from_local(local.contiguous(), a.device_mesh,
                              a.placements, run_check=False, shape=a.shape,
                              stride=a.stride())


class Placer:
    """Runs an operation on DTensors (the dry run's ``StepCounter.place``).
    Where a view fails on a strided local shard, it runs again over
    contiguous shards (:func:`_relaid`). Where DTensor cannot place it as
    its inputs are sharded (no sharding rule, or a view that would split a
    sharded dim unevenly), again with its inputs replicated over the
    mesh's innermost dim, then over every dim. The copies and gathers are
    counted; what a failed attempt counted is rolled back. ``replicated``
    counts the operations so placed, by name."""

    def __init__(self):
        self.replicated: dict[str, int] = {}

    def __call__(self, func, args, kwargs, rollback=lambda: None):
        from torch.distributed.tensor import DTensor
        from torch.utils._pytree import tree_map_only
        try:
            return func(*args, **kwargs)
        except ValueError:                   # a view of a strided shard
            rollback()
            args, kwargs = tree_map_only(DTensor, _relaid, (args, kwargs))
            try:
                return func(*args, **kwargs)
            except UNPLACED as second:
                error = second
        except UNPLACED as first:
            error = first
        ndim = _dtensors((args, kwargs))[0].device_mesh.ndim
        for keep in range(ndim - 1, -1, -1):
            def rep(a, keep=keep):
                return redistribute(a, tuple(a.placements[:keep]) +
                                    _replicated(ndim - keep))
            if all(tuple(a.placements[keep:]) == _replicated(ndim - keep)
                   for a in _dtensors((args, kwargs))):
                continue                     # already so: same failure
            rollback()
            try:
                placed = tree_map_only(DTensor, rep, (args, kwargs))
                out = func(*placed[0], **placed[1])
            except UNPLACED as e:
                error = e
                continue
            name = str(func)
            self.replicated[name] = self.replicated.get(name, 0) + 1
            return out
        rollback()
        raise error


def _wrap(local, mesh, placements, shape):
    """DTensor of global ``shape`` over ``local``, with global strides in
    the order of the local tensor's (a permuted einsum result stays
    permuted)."""
    from torch.distributed.tensor import DTensor
    order = sorted(range(len(shape)), key=lambda d: -local.stride(d))
    stride, acc = [0] * len(shape), 1
    for d in reversed(order):
        stride[d] = acc
        acc *= shape[d]
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def _einsum(eq: str, *operands):
    """``torch.einsum`` on DTensors, placed as GSPMD places a dot: on
    each mesh dim the letter the largest operand is sharded on (a plain
    ``Shard``) stays sharded in every operand that has it, the other
    operands are replicated there, and the output is sharded on that
    letter, or a partial sum where it is contracted. Then one local
    einsum on the shards."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
        operands = tuple(operands[0])
    lhs, out = eq.replace(" ", "").split("->")
    ins = lhs.split(",")
    mesh = _dtensors(operands)[0].device_mesh
    ops = [_as_dtensor(o, mesh) for o in operands]
    sizes: dict[str, int] = {}
    for o, s in zip(ops, ins):
        for i, c in enumerate(s):
            sizes[c] = max(sizes.get(c, 1), o.shape[i])
    targets = [[Replicate()] * mesh.ndim for _ in ops]
    out_pl = []
    for md in range(mesh.ndim):
        letter = None
        for o, s in sorted(zip(ops, ins), key=lambda t: -t[0].numel()):
            p = o.placements[md]
            if type(p) is Shard and o.shape[p.dim] == sizes[s[p.dim]]:
                letter = s[p.dim]
                break
        for j, (o, s) in enumerate(zip(ops, ins)):
            if letter is not None and letter in s and \
                    o.shape[s.index(letter)] == sizes[letter]:
                targets[j][md] = Shard(s.index(letter))
        out_pl.append(Replicate() if letter is None else
                      Shard(out.index(letter)) if letter in out else
                      Partial())
    placed = [redistribute(o, t) for o, t in zip(ops, targets)]
    local = torch.einsum(eq, *[p.to_local() for p in placed]).contiguous()
    return _wrap(local, mesh, out_pl, tuple(sizes[c] for c in out))


def _row_parallel(self_, indices, others):
    """Placements for a gather or scatter along leading indices whose
    first index tensor runs over ``self_``'s rows (a batch of rows, each
    indexing its own row): the mesh dims on which an index or value
    tensor is split by rows keep everything split by rows (dim 0), all
    other mesh dims replicate. Returns (mesh, placements, placed self,
    placed indices, placed others)."""
    from torch.distributed.tensor import Replicate, Shard
    tensors = [t for t in (self_, *indices, *others)
               if isinstance(t, torch.Tensor)]
    mesh = _dtensors(tensors)[0].device_mesh
    rows = self_.shape[0]
    pl = []
    for md in range(mesh.ndim):
        split = any(
            type(t.placements[md]) is Shard and t.placements[md].dim == 0
            and t.shape[0] == rows
            for t in _dtensors([*indices, *others]))
        pl.append(Shard(0) if split else Replicate())

    def put(t):
        if not isinstance(t, torch.Tensor):
            return t
        t = _as_dtensor(t, mesh)
        want = [p if t.shape[0] == rows else Replicate() for p in pl]
        return redistribute(t, want)
    return (mesh, pl, put(self_), [put(i) for i in indices],
            [put(o) for o in others])


def _local(t):
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _gather_rows(self_, idx: tuple):
    """``self_[i0, i1, ...]`` with i0 over self_'s rows."""
    from torch.distributed.tensor import DTensor
    mesh, pl, s, ii, _ = _row_parallel(self_, list(idx), [])
    local = _local(s)[tuple(_local(i) for i in ii)]
    shape = torch.broadcast_shapes(*(i.shape for i in ii)) + \
        tuple(self_.shape[len(idx):])
    return _wrap(local, mesh, pl, tuple(shape))


def _gather_table(table, idx):
    """``table[idx]``, a lookup of ``idx`` (any shape) in a 2-D table
    (the embedding), placed as a vocabulary-parallel lookup: on a mesh
    dim where idx is split the table is gathered and the output split as
    idx; else a table split by rows gives a partial sum (each shard looks
    up the ids it holds), one split by columns an output split by
    columns."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = _dtensors([table, idx])[0].device_mesh
    idx = _as_dtensor(idx, mesh)
    t_pl, out_pl = [], []
    for md in range(mesh.ndim):
        pi, pt = idx.placements[md], table.placements[md]
        if type(pi) is Shard:
            t_pl.append(Replicate())
            out_pl.append(Shard(pi.dim))
        elif type(pt) is Shard:
            t_pl.append(pt)
            out_pl.append(Partial() if pt.dim == 0 else Shard(idx.ndim))
        else:
            t_pl.append(Replicate())
            out_pl.append(Replicate())
    i_pl = [p if type(p) is Shard else Replicate() for p in idx.placements]
    t, i = redistribute(table, t_pl), redistribute(idx, i_pl)
    local = t.to_local()[i.to_local()]
    return _wrap(local, mesh, out_pl, tuple(idx.shape) + (table.shape[1],))


def _index_put_rows(self_, indices, values, accumulate=False):
    """``self_.index_put(indices, values)`` with indices[0] over self_'s
    rows."""
    from torch.distributed.tensor import DTensor
    mesh, pl, s, ii, (vv,) = _row_parallel(self_, list(indices), [values])
    local = _local(s).index_put(tuple(_local(i) for i in ii), _local(vv),
                                accumulate=accumulate)
    return _wrap(local, mesh, s.placements, tuple(self_.shape))


def _row_indexed(self_, idx, *others) -> bool:
    """A tuple of two or more index tensors, the first over self's rows
    (the MoE dispatch's (row, expert, place) gather and scatter), with a
    DTensor among self, the indices and ``others``."""
    return (isinstance(idx, (tuple, list)) and len(idx) >= 2
            and all(isinstance(i, torch.Tensor) for i in idx)
            and idx[0].shape[0] == self_.shape[0]
            and bool(_dtensors([self_, *idx, *others])))


def reduce_partial(t):
    """A product's partial sums reduced at once (an all-reduce on each
    mesh dim where ``t`` is partial), as tensor parallelism does after a
    row-parallel product: the next layer then starts from a replicated
    activation, not from partial sums that DTensor would carry on and
    meet with a gather of the next weight."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(t, DTensor) or not any(p.is_partial()
                                              for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in t.placements])


_PRODUCTS = (torch.matmul, torch.Tensor.__matmul__, torch.Tensor.matmul,
             torch.mm, torch.Tensor.mm, torch.bmm, torch.Tensor.bmm)


def placement_rules():
    """A ``TorchFunctionMode`` that places what DTensor's per-op rules
    place badly or not at all: ``torch.einsum`` (whose decomposition into
    views and batched products would merge dims sharded on two mesh dims,
    which DTensor then cannot multiply), the row-indexed gather and
    scatter of the MoE dispatch, and the embedding lookup; and that
    reduces the partial sums of every product at once
    (:func:`reduce_partial`)."""
    from torch.overrides import TorchFunctionMode

    class _Rules(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func is torch.einsum and _dtensors(args):
                return reduce_partial(_einsum(*args, **kwargs))
            if func is torch.Tensor.__getitem__ and \
                    _row_indexed(args[0], args[1]):
                return _gather_rows(args[0], tuple(args[1]))
            if func is torch.Tensor.__getitem__ and \
                    _dtensors(args[:1]) and args[0].ndim == 2 and \
                    isinstance(args[1], torch.Tensor) and \
                    not args[1].dtype.is_floating_point and \
                    args[1].dtype != torch.bool:
                return reduce_partial(_gather_table(args[0], args[1]))
            if func is torch.Tensor.index_put and \
                    _row_indexed(*args[:3]):
                return _index_put_rows(*args, **kwargs)
            if func in _PRODUCTS:
                return reduce_partial(func(*args, **kwargs))
            return func(*args, **kwargs)

    return _Rules()


def local_bytes(tree) -> int:
    """Bytes of the local shards (per device) of a tree of DTensors."""
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_leaves
    return sum(t.to_local().numel() * t.element_size()
               for t in tree_leaves(tree) if isinstance(t, DTensor))


def _run_step(spec, mesh, dmesh):
    """Place the pair's inputs: (the step as a callable of no arguments,
    the placed arguments, the mode the step runs in)."""
    cfg, kind = spec["cfg"], spec["kind"]
    # Serving dispatches attention by device: its shards are fakes on the
    # CPU, where the plain versions run. Training runs no kernel, and
    # meta shards dispatch ~2.4x faster than fakes.
    mode = None if kind == "train" else spec["fake_mode"]
    pmode = "train" if kind == "train" else "serve"
    params = distribute(spec["params"], shd.param_shardings(
        spec["params"], mesh, pmode), dmesh, mode)
    if kind == "train":
        opt = distribute(spec["opt_state"], shd.param_shardings(
            spec["opt_state"], mesh, pmode), dmesh, mode)
        batch = distribute(spec["batch"], shd.batch_shardings(
            spec["batch"], mesh), dmesh, mode)
        step = make_train_step(cfg, grad_accum=spec["grad_accum"],
                               batch_axes=shd.batch_axes(mesh))
        return ((lambda: step(params, opt, batch)), (params, opt, batch),
                contextlib.nullcontext())
    if kind == "prefill":
        batch = distribute(spec["batch"], shd.batch_shardings(
            spec["batch"], mesh), dmesh, mode)
        return ((lambda: prefill(cfg, params, batch, spec["max_len"])),
                (params, batch), mode)
    tokens = distribute({"t": spec["tokens"]}, shd.batch_shardings(
        {"t": spec["tokens"]}, mesh), dmesh, mode)["t"]
    cache = distribute(spec["cache"], shd.cache_shardings(
        spec["cache"], mesh), dmesh, mode)
    pos = SP.INPUT_SHAPES[spec["shape"]][0] - 1     # the cache's last slot
    return ((lambda: decode_step(cfg, params, tokens, cache, pos)),
            (params, tokens, cache), mode)


def lower_pair(arch: str, shape_name: str, *, multi_pod: bool = False,
               overrides: dict | None = None) -> dict:
    """Run one (arch, shape, mesh) step on the fake group: {"spec",
    "mesh", "counter", "replicated", "memory"}."""
    from torch.distributed.tensor.experimental import implicit_replication
    cfg0 = _apply_overrides(configs.get(arch), overrides)
    spec = dict(SP.input_specs(cfg0, shape_name), shape=shape_name)
    mesh = make_production_mesh(multi_pod=multi_pod)
    start_fake_group(mesh.size)
    dmesh = device_mesh(mesh)
    placer = Placer()
    counter = StepCounter(place=placer)
    with implicit_replication():
        run, args, fake = _run_step(spec, mesh, dmesh)
        with fake, counter.mode(), placement_rules(), torch.no_grad():
            out = run()
    return {"spec": spec, "mesh": mesh, "counter": counter,
            "replicated": placer.replicated,
            "memory": {"argument_bytes": local_bytes(args),
                       "output_bytes": local_bytes(out),
                       "temp_bytes": None}}


def run_one(arch: str, shape_name: str, *, multi_pod: bool,
            verbose: bool = True, overrides: dict | None = None,
            variant: str = "baseline") -> dict:
    cfg = configs.get(arch)
    if not SP.supported(cfg, shape_name):
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "variant": variant, "status": "skipped",
                "reason": "architectural (whisper's 448-token decoder "
                          "context)"}
    t0 = time.perf_counter()
    try:
        low = lower_pair(arch, shape_name, multi_pod=multi_pod,
                         overrides=overrides)
    except Exception as e:  # a failure here is a bug in the system
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "variant": variant,
                "status": "FAILED", "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:]}
    run_s = time.perf_counter() - t0

    spec, mem = low["spec"], low["memory"]
    roof = analyze(low["counter"])
    n_chips = low["mesh"].size
    model_flops = (6.0 * spec["cfg"].active_param_count() *
                   _tokens_processed(spec)) / n_chips
    seq, gbatch, _ = SP.INPUT_SHAPES[shape_name]
    ana = analytic_terms(spec["cfg"], spec["kind"], gbatch, seq, n_chips,
                         spec.get("grad_accum", 1))

    rec = {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "variant": variant,
        "status": "ok", "compile_s": round(run_s, 1),
        "kind": spec["kind"],
        "memory": {**mem,
                   "fits": mem["argument_bytes"] <= HBM_BYTES},
        "roofline": roof.to_dict(),
        "collective_counts": dict(low["counter"].collective_counts),
        "replicated_ops": low["replicated"],
        "analytic": {
            **ana,
            "compute_s": ana["flops_per_device"] / PEAK_FLOPS,
            "memory_s": ana["hbm_bytes_per_device"] / HBM_BW,
        },
        "grad_accum": spec.get("grad_accum", 1),
        "model_flops_per_device": model_flops,
        "useful_flops_ratio": (model_flops / roof.flops_per_device
                               if roof.flops_per_device else None),
    }
    if verbose:
        print(f"[dryrun] {arch} × {shape_name} × "
              f"{'2x16x16' if multi_pod else '16x16'}: "
              f"run {run_s:.1f}s")
        print(f"  memory: {rec['memory']}")
        print(f"  counted: flops={roof.flops_per_device:.3e} "
              f"bytes={roof.bytes_per_device:.3e}")
        print(f"  roofline: compute={roof.compute_s * 1e3:.3f}ms "
              f"memory={roof.memory_s * 1e3:.3f}ms "
              f"collective={roof.collective_s * 1e3:.3f}ms "
              f"dominant={roof.dominant}")
    return rec


def _tokens_processed(spec) -> float:
    """Global token count of one step (for MODEL_FLOPS = 6·N·D)."""
    if spec["kind"] == "train":
        B, S = spec["batch"]["tokens"].shape
        return 3.0 * B * S       # fwd + bwd ≈ 3× forward FLOPs
    if spec["kind"] == "prefill":
        B, S = spec["batch"]["tokens"].shape
        return float(B * S)
    return float(spec["tokens"].shape[0])   # decode: one token per row


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(SP.INPUT_SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (perf variants)")
    ap.add_argument("--variant", default=None,
                    help="variant label recorded with the results")
    args = ap.parse_args(argv)
    overrides = dict(kv.split("=", 1) for kv in getattr(args, "set"))
    variant = args.variant or ("baseline" if not overrides else
                               ",".join(f"{k}={v}"
                                        for k, v in overrides.items()))

    archs = configs.all_archs() if (args.all or not args.arch) \
        else [args.arch]
    shapes = list(SP.INPUT_SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    records = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rec = run_one(arch, shape, multi_pod=mp,
                              overrides=overrides, variant=variant)
                records.append(rec)
                if rec["status"] == "FAILED":
                    print(f"[dryrun] FAILED {arch} × {shape} "
                          f"(multi_pod={mp}): {rec['error']}")
                # append incrementally so long sweeps are resumable
                _merge_out(args.out, records)
    ok = sum(r["status"] == "ok" for r in records)
    sk = sum(r["status"] == "skipped" for r in records)
    print(f"[dryrun] done: {ok} ok, {sk} skipped, "
          f"{len(records) - ok - sk} failed → {args.out}")


def _merge_out(path: str, records: list[dict]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    existing = []
    if os.path.exists(path):
        with open(path) as f:
            existing = json.load(f)
    keyed = {(r["arch"], r["shape"], r["multi_pod"],
              r.get("variant", "baseline")): r for r in existing}
    for r in records:
        keyed[(r["arch"], r["shape"], r["multi_pod"],
               r.get("variant", "baseline"))] = r
    with open(path, "w") as f:
        json.dump(list(keyed.values()), f, indent=1)


if __name__ == "__main__":
    main()
