"""The dropless MoE over the routed slots only (``layers.moe_grouped``):
routing without the places, the sort by expert and its offsets, the
gather, the grouped products and the combine, in their plain versions on
the CPU, against ``layers.moe``'s ``scatter`` path at a capacity of S
(E / k as capacity factor) and against the JAX package's ``layers.moe``:
f32 within 1e-5 (the products sum in other orders), bf16 within two bf16
roundings of the largest output. Cases: an expert with no slot, one
expert taking most slots, S = 1, B > 1, exact router ties.

Which path ``layers.moe`` takes: the grouped one only for a dropless
``scatter`` call in bf16 on the card with autograd off. The CPU, an
autograd-recorded call, a ``dense`` call and a capacity below S keep the
buffer paths, count no ``moe.grouped`` and give the parent's outputs bit
for bit (``_parent_moe``, the buffer paths as they were before the
grouped path). To reach the grouped path here, ``_grouped_engages`` is
replaced by its condition without the device (``_dropless_inference``).
"""
import _torch_threads  # noqa: F401  (a worker's share of the cores)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import layers as jlayers
from repro_torch import bridge, tracing
from repro_torch.kernels import moe_grouped as mg
from repro_torch.kernels import ops
from repro_torch.models import layers as tlayers

D, F_, E = 32, 48, 8


def _parent_moe(params, x, *, experts_per_token, capacity_factor=1.25,
                dispatch="scatter"):
    """``layers.moe`` before the grouped path: every call on the buffer
    paths (the reference for the calls that must not change)."""
    B, S, _ = x.shape
    E_ = params["w_gate"].shape[0]
    k = experts_per_token
    probs = torch.softmax(x.float() @ params["router"], dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = vals[..., :k], idx[..., :k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(expert_idx, E_).float().sum(2).mean(dim=(0, 1))
    aux = E_ * (me * ce).sum()
    capacity = max(1, int(capacity_factor * k * S / E_))
    flat = F.one_hot(expert_idx, E_).reshape(B, S * k, E_)
    pos = ((flat.cumsum(1) - flat) * flat).sum(-1).reshape(B, S, k)
    keep = pos < capacity
    gate_vals = gate_vals * keep.to(gate_vals.dtype)
    if dispatch == "dense":
        pos_oh = F.one_hot(torch.where(keep, pos, capacity), capacity + 1
                           )[..., :capacity].float()
        oh = F.one_hot(expert_idx, E_).float()
        disp = torch.einsum("bske,bskc->bsec", oh, pos_oh)
        comb = torch.einsum("bske,bskc,bsk->bsec", oh, pos_oh, gate_vals)
        expert_in = torch.einsum("bsec,bsd->becd", disp,
                                 x.float()).to(x.dtype)
    else:
        safe_pos = torch.where(keep, pos, capacity)
        bidx = torch.arange(B)[:, None, None].expand(B, S, k)
        buf = torch.zeros((B, E_, capacity + 1, x.shape[2]), dtype=x.dtype)
        buf = buf.index_put((bidx, expert_idx, safe_pos),
                            x[:, :, None, :].expand(B, S, k, x.shape[2]),
                            accumulate=True)
        expert_in = buf[:, :, :capacity]
    xe = expert_in.transpose(0, 1).reshape(E_, B * capacity, -1)
    gate = tlayers._bmm_f32(xe, params["w_gate"])
    up = tlayers._bmm_f32(xe, params["w_up"])
    h = (F.silu(gate) * up).to(x.dtype)
    expert_out = tlayers._bmm_f32(h, params["w_down"]).to(x.dtype).reshape(
        E_, B, capacity, -1).transpose(0, 1)
    if dispatch == "dense":
        out = torch.einsum("bsec,becd->bsd", comb, expert_out.float())
    else:
        gathered = expert_out[bidx, expert_idx,
                              safe_pos.clamp(max=capacity - 1)]
        out = (gathered.float() * gate_vals[..., None]).sum(2)
    return out.to(x.dtype), aux


def _params(case, k, dtype=jnp.float32):
    """JAX's ``moe_init`` weights, bent per case: ``empty`` sends expert 6
    no slot, ``skewed`` puts expert 0 first for every token, ``ties``
    makes router columns 2 and 5 equal."""
    jp = jlayers.moe_init(jax.random.PRNGKey(7), D, F_, E, dtype=dtype)
    r = jp["router"]
    if case == "empty":
        r = r.at[:, 6].set(-10.0 * jnp.abs(r).max())
    elif case == "skewed":
        r = r.at[:, 0].add(1.0)
    elif case == "ties":
        r = r.at[:, 5].set(r[:, 2])
    jp = dict(jp, router=r)
    return jp, bridge._convert(jax.tree.map(np.asarray, jp), "cpu")


def _x(case, B, S, seed=3):
    x = np.random.default_rng(seed).normal(size=(B, S, D)).astype(np.float32)
    if case in ("empty", "skewed"):
        x += 1.0          # a shared direction that the bent column follows
    return x


CASES = [("plain", 2, 24, 3), ("empty", 2, 24, 3), ("skewed", 3, 16, 2),
         ("skewed", 2, 20, 1), ("s1", 3, 1, 3), ("ties", 2, 24, 3)]


@pytest.mark.parametrize("case,B,S,k", CASES)
def test_grouped_matches_scatter_and_jax_f32(case, B, S, k):
    jp, tp = _params(case, k)
    x = _x(case, B, S)
    cf = E / k
    got, aux = tlayers.moe_grouped(tp, torch.from_numpy(x),
                                   experts_per_token=k)
    want, w_aux = tlayers.moe(tp, torch.from_numpy(x), experts_per_token=k,
                              capacity_factor=cf)
    jwant, j_aux = jlayers.moe(jp, jnp.asarray(x), experts_per_token=k,
                               capacity_factor=cf)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), rtol=0,
                               atol=1e-5)
    assert aux.item() == w_aux.item()
    np.testing.assert_allclose(aux.item(), float(j_aux), rtol=1e-6)
    _, idx, _ = tlayers.moe_gates(tp, torch.from_numpy(x), k)
    counts = torch.bincount(idx.reshape(-1), minlength=E)
    if case == "empty":
        assert counts[6] == 0
    if case == "skewed":      # in every token: at k = 1 every slot
        assert counts[0] == B * S
    if case == "ties":
        both = (idx == 2).any(-1) & (idx == 5).any(-1)
        assert both.any()


@pytest.mark.parametrize("case,B,S,k", CASES)
def test_grouped_bf16_within_two_roundings(case, B, S, k):
    """bf16 experts: the grouped path against the buffer path's f32 run on
    the same bf16 values, within two bf16 roundings of the largest output
    (the products of bf16 values are exact in f32; both round the expert
    input, h and the expert output where JAX rounds them)."""
    _, tp = _params(case, k, dtype=jnp.bfloat16)
    f32 = {n: v.float() for n, v in tp.items()}
    x = torch.from_numpy(_x(case, B, S)).bfloat16()
    got, aux = tlayers.moe_grouped(tp, x, experts_per_token=k)
    want, w_aux = tlayers.moe(f32, x.float(), experts_per_token=k,
                              capacity_factor=E / k)
    assert got.dtype == torch.bfloat16 and aux.item() == w_aux.item()
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), rtol=0,
                               atol=2 ** -7 * want.abs().max().item())


@pytest.mark.parametrize("case,B,S,k", CASES)
def test_sort_offsets_are_a_bincount_prefix(case, B, S, k):
    _, tp = _params(case, k)
    _, idx, _ = tlayers.moe_gates(tp, torch.from_numpy(_x(case, B, S)), k)
    order, offsets = tlayers.moe_sort(idx, E)
    flat = idx.reshape(-1)
    want = torch.cat([torch.zeros(1, dtype=torch.long),
                      torch.bincount(flat, minlength=E).cumsum(0)])
    assert offsets.dtype == torch.int32
    assert torch.equal(offsets.long(), want)
    # a stable grouping: each expert's slots in flat (token, slot) order
    assert torch.equal(flat[order], torch.sort(flat).values)
    for e in range(E):
        seg = order[offsets[e]:offsets[e + 1]]
        assert torch.equal(seg, torch.sort(seg).values)
        assert (flat[seg] == e).all()


def test_route_keeps_places_and_kept_mask():
    """``moe_route`` is ``moe_gates`` plus the places and the kept mask."""
    _, tp = _params("plain", 3)
    x = torch.from_numpy(_x("plain", 2, 24))
    g, idx, aux = tlayers.moe_gates(tp, x, 3)
    rg, ridx, pos, keep, cap, raux = tlayers.moe_route(tp, x, 3, 0.5)
    assert torch.equal(idx, ridx) and aux.item() == raux.item()
    assert cap == tlayers.moe_capacity(0.5, 3, 24, E) and not keep.all()
    assert torch.equal(rg, g * keep) and pos.shape == idx.shape


def test_plain_products_and_combine_by_hand():
    """The plain grouped products per expert segment (one empty) and the
    combine's slot-order f32 sum, against the formulas written out."""
    rng = np.random.default_rng(5)
    counts = [3, 0, 5, 1]
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                           dtype=torch.int32)
    a = torch.from_numpy(rng.normal(size=(9, 16)).astype(np.float32))
    wg, wu = (torch.from_numpy(rng.normal(size=(4, 16, 8)).astype(
        np.float32)) for _ in range(2))
    wd = torch.from_numpy(rng.normal(size=(4, 8, 16)).astype(np.float32))
    h = ops.moe_gate_up(a, wg, wu, offsets)
    y = ops.moe_down(h, wd, offsets)
    for e, (lo, hi) in enumerate(zip(offsets[:-1], offsets[1:])):
        np.testing.assert_allclose(
            h[lo:hi], F.silu(a[lo:hi] @ wg[e]) * (a[lo:hi] @ wu[e]),
            rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(y[lo:hi], h[lo:hi] @ wd[e], rtol=1e-6,
                                   atol=1e-5)
    inv = torch.from_numpy(rng.permutation(9))
    gates = torch.from_numpy(rng.random((3, 3)).astype(np.float32))
    got = ops.moe_combine(y, inv, gates)
    for t in range(3):
        acc = torch.zeros(16)
        for j in range(3):
            acc = acc + y[inv[3 * t + j]] * gates[t, j]
        assert torch.equal(got[t], acc)


def _count_grouped(fn):
    tracing.enable()
    try:
        out = fn()
        counts = tracing.collect().counts
    finally:
        tracing.disable()
    return out, sum(n for (name, _), n in counts.items()
                    if name == "moe.grouped")


@pytest.mark.parametrize("call", ["cpu", "recorded", "dense",
                                  "capacity_below_s", "f32"])
def test_calls_off_the_grouped_path_are_the_parents(call, monkeypatch):
    """Every call but a dropless bf16 scatter one on a grouped device,
    with autograd off, runs the buffer paths: no ``moe.grouped`` and the
    parent's outputs and aux bit for bit."""
    if call != "cpu":
        monkeypatch.setattr(tlayers, "_grouped_engages",
                            tlayers._dropless_inference)
    _, tp = _params("plain", 2, dtype=jnp.bfloat16)
    x = torch.from_numpy(_x("plain", 2, 24)).bfloat16()
    kw = dict(experts_per_token=2, capacity_factor=E / 2)
    if call == "dense":
        kw["dispatch"] = "dense"
    elif call == "capacity_below_s":
        kw["capacity_factor"] = 1.25
    elif call == "f32":
        tp = {n: v.float() for n, v in tp.items()}
        x = x.float()
    elif call == "recorded":
        x = x.requires_grad_()
    (got, aux), n = _count_grouped(lambda: tlayers.moe(tp, x, **kw))
    want, w_aux = _parent_moe(tp, x, **kw)
    assert n == 0
    assert torch.equal(got, want) and torch.equal(aux, w_aux)
    if call == "recorded":
        got.float().sum().backward()
        assert x.grad is not None


def test_dropless_bf16_call_takes_the_grouped_path(monkeypatch):
    """With the device left out of the condition, a dropless bf16 scatter
    call runs the grouped path: one ``moe.grouped`` a call, its four spans
    in order, the parent's output within two bf16 roundings and its aux."""
    monkeypatch.setattr(tlayers, "_grouped_engages",
                        tlayers._dropless_inference)
    _, tp = _params("skewed", 2, dtype=jnp.bfloat16)
    x = torch.from_numpy(_x("skewed", 2, 24)).bfloat16()
    tracing.enable()
    try:
        got, aux = tlayers.moe(tp, x, experts_per_token=2,
                               capacity_factor=E / 2)
        trace = tracing.collect()
    finally:
        tracing.disable()
    assert [s.name for s in trace.spans] == [
        "moe.route", "moe.dispatch", "moe.experts", "moe.combine"]
    assert sum(n for (name, _), n in trace.counts.items()
               if name == "moe.grouped") == 1
    want, w_aux = _parent_moe(tp, x, experts_per_token=2,
                              capacity_factor=E / 2)
    assert torch.equal(aux, w_aux)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=0,
                               atol=2 ** -7 * want.float().abs().max().item())


def test_engagement_reads_only_what_the_call_shows():
    """The grouped path's condition: device, dispatch, dtype, autograd and
    capacity, nothing else (no knob)."""
    _, tp = _params("plain", 2, dtype=jnp.bfloat16)
    x = torch.zeros((2, 8, D), dtype=torch.bfloat16)
    assert not tlayers._grouped_engages(tp, x, 2, E / 2, "scatter")
    assert tlayers._dropless_inference(tp, x, 2, E / 2, "scatter")
    meta = {n: v.to("meta") for n, v in tp.items()}
    assert not tlayers._grouped_engages(meta, x.to("meta"), 2, E / 2,
                                        "scatter")
    # capacity: max(1, int(cf k S / E)) >= S, so a decode step (S = 1) at
    # the default factor is dropless too
    assert tlayers.moe_capacity(1.25, 2, 1, E) >= 1
    assert tlayers.moe_capacity(1.25, 2, 8, E) < 8
    assert mg.MAX_EXPERTS >= 64
