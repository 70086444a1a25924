"""The model zoo in the port, against the JAX package: the twins of
``tests/test_models.py`` for every arch of the registry, of its
config-level tests, and of ``layers.moe``.

Every arch runs at its smoke config (f32) on JAX's weights through the
bridge, its batch carrying the family's frontend input as JAX's
``test_models.make_batch`` builds it (``patch_embeds`` for the vlm
family, ``frames`` for the audio family): forward logits within 1e-4 and
its aux loss within 1e-5 relative, prefill and decode-step logits within
1e-4 (the two frameworks sum their products in other orders: ~1e-5 on
logits of magnitude ~5); greedy tokens identical. The port's own checks
of ``test_models.py``: shapes and finiteness, one AdamW step that moves
the parameters, prefill == forward and decode == forward at 1e-4 (f32,
where JAX's bf16-minded test allows 0.1); the vlm cache holds the
patches' positions too. ``moe`` alone is held to JAX's ``layers.moe`` in
both dispatches at a capacity factor that drops tokens: expert indices,
places and kept masks exactly, gates and aux within 1e-6, outputs within
1e-5.
"""
import _torch_threads  # noqa: F401  (a worker's share of the cores)
import dataclasses
import types
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import decode_step as jdecode
from repro.models import forward as jforward
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit
from repro.models import layers as jlayers
from repro.models import prefill as jprefill
from repro_torch import bridge, configs
from repro_torch.models import (decode_step, forward, init_cache, init_params,
                                loss_fn, prefill)
from repro_torch.models import layers as tlayers
from repro_torch.training import AdamWConfig, init_opt_state, make_train_step
from repro_torch.tree import leaves

ARCHS = configs.all_archs()
B, S = 2, 16


def _extra(cfg) -> int:
    """Cache positions a prompt takes beyond its tokens."""
    return cfg.num_patches if cfg.family == "vlm" else 0


def _batch(cfg, seed):
    """Tokens, labels, the next tokens, and the family's frontend input
    (as ``tests/test_models.py::make_batch``: standard normal f32)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1).astype(np.int32)
    labels[:, -1] = -1
    nxt = rng.integers(1, cfg.vocab_size, B).astype(np.int32)
    front = {}
    if cfg.family == "vlm":
        front["patch_embeds"] = rng.normal(
            size=(B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        front["frames"] = rng.normal(
            size=(B, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    return tokens, labels, nxt, front


@partial(jax.jit, static_argnums=(0,))
def _jax_run(cfg, params, batch, nxt):
    """Forward (logits, aux), prefill's last logits, one decode step."""
    logits, aux = jforward(cfg, params, batch)
    last, cache, pos = jprefill(cfg, params, batch, S + _extra(cfg) + 4)
    step, _ = jdecode(cfg, params, nxt, cache, pos)
    return logits, aux, last, step


@pytest.fixture(scope="module", params=ARCHS)
def zoo(request):
    """Per arch: the smoke configs, JAX's weights and outputs, and the
    port's weights bridged from them."""
    arch = request.param
    jc, tc = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    jp = jax.jit(jinit, static_argnums=0)(jc, jax.random.PRNGKey(0))
    tp = bridge.lm_params(tc, jax.tree.map(np.asarray, jp), device="cpu")
    tokens, labels, nxt, front = _batch(tc, len(arch))
    jbatch = {"tokens": jnp.asarray(tokens),
              **{k: jnp.asarray(v) for k, v in front.items()}}
    want = [np.asarray(x, np.float32) for x in
            _jax_run(jc, jp, jbatch, jnp.asarray(nxt))]
    return dict(arch=arch, cfg=tc, params=tp, tokens=tokens, labels=labels,
                nxt=nxt, front=front, want=want)


def _inputs(zoo, tokens=None):
    """The port's batch: ``tokens`` (default the fixture's) and the
    frontend input."""
    t = torch.from_numpy(zoo["tokens"]).long() if tokens is None else tokens
    return {"tokens": t,
            **{k: torch.from_numpy(v) for k, v in zoo["front"].items()}}


def test_zoo_matches_jax_on_bridged_weights(zoo):
    cfg, p = zoo["cfg"], zoo["params"]
    w_logits, w_aux, w_last, w_step = zoo["want"]
    logits, aux = forward(cfg, p, _inputs(zoo))
    np.testing.assert_allclose(logits.numpy(), w_logits, rtol=0, atol=1e-4)
    np.testing.assert_allclose(aux.item(), w_aux, rtol=1e-5, atol=1e-7)
    max_len = S + _extra(cfg) + 4
    last, cache, pos = prefill(cfg, p, _inputs(zoo), max_len)
    assert pos == S + _extra(cfg)
    if "k" in cache:
        assert cache["k"].shape[2] == max_len
    np.testing.assert_allclose(last.numpy(), w_last, rtol=0, atol=1e-4)
    step, _ = decode_step(cfg, p, torch.from_numpy(zoo["nxt"]), cache, pos)
    np.testing.assert_allclose(step.numpy(), w_step, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(step.numpy().argmax(-1),
                                  w_step.argmax(-1))


def test_zoo_forward_shapes_and_finite(zoo):
    cfg = zoo["cfg"]
    logits, aux = forward(cfg, zoo["params"], _inputs(zoo))
    assert logits.shape == (B, S, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(aux))
    assert (aux.item() > 0) == (cfg.family == "moe")


def test_zoo_one_train_step_moves_params(zoo):
    cfg, p = zoo["cfg"], zoo["params"]
    step = make_train_step(cfg, AdamWConfig(learning_rate=1e-3,
                                            warmup_steps=1, total_steps=10))
    new, _, metrics = step(p, init_opt_state(p),
                           {"tokens": zoo["tokens"], "labels": zoo["labels"],
                            **zoo["front"]})
    assert bool(torch.isfinite(metrics["loss"])) and metrics["loss"] > 0
    assert all(bool(torch.isfinite(x.float()).all()) for x in leaves(new))
    assert any(bool((a != b).any()) for a, b in zip(leaves(p), leaves(new)))
    if cfg.family == "moe":     # the router learns too (through the gates)
        assert bool((new["layers"]["moe"]["router"] !=
                     p["layers"]["moe"]["router"]).any())
    total, m = loss_fn(cfg, p, {**_inputs(zoo),
                                "labels": torch.from_numpy(zoo["labels"])})
    np.testing.assert_allclose(total.item(), (m["ce"] + 0.01 * m["aux"]
                                              ).item(), rtol=1e-6)


def test_zoo_prefill_and_decode_match_forward(zoo):
    cfg, p = zoo["cfg"], zoo["params"]
    t = torch.from_numpy(zoo["tokens"]).long()
    full, _ = forward(cfg, p, _inputs(zoo))
    last, cache, pos = prefill(cfg, p, _inputs(zoo), S + _extra(cfg) + 4)
    np.testing.assert_allclose(last.numpy(), full[:, -1].numpy(), rtol=0,
                               atol=1e-4)
    nxt = torch.from_numpy(zoo["nxt"])
    step, _ = decode_step(cfg, p, nxt, cache, pos)
    ext, _ = forward(cfg, p, _inputs(zoo, torch.cat([t, nxt[:, None].long()],
                                                    1)))
    np.testing.assert_allclose(step.numpy(), ext[:, -1].numpy(), rtol=0,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# the MoE layer alone
# ---------------------------------------------------------------------------


def _jax_route(params, x, k, cf):
    """The routing lines of JAX's ``layers.moe``: expert indices, places,
    kept mask, gates (zeroed where dropped) and aux."""
    E = params["w_gate"].shape[0]
    Bx, Sx, _ = x.shape
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", x.astype(jnp.float32),
                                      params["router"]), axis=-1)
    gate_vals, expert_idx = jax.lax.top_k(probs, k)
    gate_vals = gate_vals / jnp.maximum(
        jnp.sum(gate_vals, axis=-1, keepdims=True), 1e-9)
    capacity = max(1, int(cf * k * Sx / E))
    onehot = jax.nn.one_hot(expert_idx, E, dtype=jnp.int32)
    flat = onehot.reshape(Bx, Sx * k, E)
    pos = jnp.sum((jnp.cumsum(flat, axis=1) - flat) * flat,
                  axis=-1).reshape(Bx, Sx, k)
    keep = pos < capacity
    return (np.asarray(expert_idx), np.asarray(pos), np.asarray(keep),
            np.asarray(gate_vals * keep), capacity)


@pytest.mark.parametrize("dispatch", ["scatter", "dense"])
@pytest.mark.parametrize("cf", [0.5, 1.25, 8.0])
def test_moe_matches_jax_both_dispatches(dispatch, cf):
    """E = 8 experts, top 3, S = 24: at cf 0.5 and 1.25 a row's busiest
    experts overflow and drop tokens; at 8.0 none drop. A pair of equal
    router columns puts exact ties in the probabilities: the lower expert
    wins, as jax.lax.top_k."""
    D, F_, E, k = 32, 48, 8, 3
    rng = np.random.default_rng(int(cf * 10))
    jp = jlayers.moe_init(jax.random.PRNGKey(3), D, F_, E,
                          dtype=jnp.float32)
    jp = dict(jp, router=jp["router"].at[:, 5].set(jp["router"][:, 2]))
    tp = {n: torch.from_numpy(np.array(v)) for n, v in jp.items()}
    x = rng.normal(size=(B, 24, D)).astype(np.float32)
    want, w_aux = jlayers.moe(jp, jnp.asarray(x), experts_per_token=k,
                              capacity_factor=cf, dispatch=dispatch)
    got, aux = tlayers.moe(tp, torch.from_numpy(x), experts_per_token=k,
                           capacity_factor=cf, dispatch=dispatch)
    idx, pos, keep, gates, cap = _jax_route(jp, jnp.asarray(x), k, cf)
    t_gates, t_idx, t_pos, t_keep, t_cap, _ = tlayers.moe_route(
        tp, torch.from_numpy(x), k, cf)
    assert t_cap == cap
    np.testing.assert_array_equal(t_idx.numpy(), idx)
    np.testing.assert_array_equal(t_pos.numpy(), pos)
    np.testing.assert_array_equal(t_keep.numpy(), keep)
    assert keep.all() == (cf == 8.0)
    np.testing.assert_allclose(t_gates.numpy(), gates, rtol=0, atol=1e-6)
    np.testing.assert_allclose(aux.item(), float(w_aux), rtol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_moe_ties_go_to_the_lower_expert():
    """Equal router columns 2 and 5: wherever both are among a token's top
    k, 2 comes first, as jax.lax.top_k orders them."""
    D, E, k = 16, 8, 4
    router = np.random.default_rng(0).normal(size=(D, E)).astype(np.float32)
    router[:, 5] = router[:, 2]
    x = np.random.default_rng(1).normal(size=(B, 32, D)).astype(np.float32)
    p = {"router": torch.from_numpy(router),
         "w_gate": torch.zeros((E, D, 4))}
    _, idx, _, _, _, _ = tlayers.moe_route(p, torch.from_numpy(x), k, 8.0)
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1)
    np.testing.assert_array_equal(idx.numpy(),
                                  np.asarray(jax.lax.top_k(probs, k)[1]))
    both = (idx == 2).any(-1) & (idx == 5).any(-1)
    assert both.any()
    first = idx.numpy().tolist()
    for b, s in zip(*np.nonzero(both.numpy())):
        row = first[b][s]
        assert row.index(2) < row.index(5)


def test_moe_bf16_keeps_f32_accumulation():
    """bf16 experts (JAX's CPU backend cannot run its bf16 expert products
    with an f32 result, so the reference here is the port's own f32 MoE
    on the same bf16 values): the same aux loss, and the bf16 output
    within two bf16 roundings of the output's largest magnitude of the
    f32 one (the products of bf16 values are exact in f32; the bf16 run
    rounds the expert input, h and the expert output where JAX rounds
    them)."""
    D, F_, E, k = 32, 48, 8, 2
    jp = jlayers.moe_init(jax.random.PRNGKey(5), D, F_, E,
                          dtype=jnp.bfloat16)
    tp = bridge._convert(jax.tree.map(np.asarray, jp), "cpu")
    f32 = {n: v.float() for n, v in tp.items()}
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(B, 12, D)).astype(np.float32)).bfloat16()
    for dispatch in ("scatter", "dense"):
        got, aux = tlayers.moe(tp, x, experts_per_token=k,
                               capacity_factor=1.25, dispatch=dispatch)
        want, w_aux = tlayers.moe(f32, x.float(), experts_per_token=k,
                                  capacity_factor=1.25, dispatch=dispatch)
        assert got.dtype == torch.bfloat16 and aux.dtype == torch.float32
        assert aux.item() == w_aux.item()
        np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                                   rtol=0,
                                   atol=2 ** -7 * want.abs().max().item())


def _widened_einsum(spec, *operands, preferred_element_type=None, **kw):
    """``jnp.einsum`` with bf16 operands widened to f32 (exact: a product
    of bf16 values is exact in f32) and the result cast to the type the
    call asked for, since JAX's CPU backend has no batched
    bf16 x bf16 -> f32 dot."""
    if not any(o.dtype == jnp.bfloat16 for o in operands):
        return jnp.einsum(spec, *operands,
                          preferred_element_type=preferred_element_type,
                          **kw)
    out = jnp.einsum(spec, *(o.astype(jnp.float32) for o in operands), **kw)
    return out.astype(preferred_element_type or jnp.result_type(*operands))


@pytest.mark.parametrize("dispatch", ["scatter", "dense"])
def test_moe_bf16_cast_points_match_jax(dispatch, monkeypatch):
    """bf16 experts against JAX's own ``layers.moe`` in bf16, its einsums
    widened to f32 (``_widened_einsum``) and every other line as JAX has
    it, so each of its casts to bf16 stays where JAX puts it: the port's
    output is bit-identical and its aux loss equal. A cast placed
    elsewhere rounds an intermediate JAX keeps, or keeps one JAX rounds."""
    shim = types.SimpleNamespace(**{n: v for n, v in vars(jnp).items()
                                    if not n.startswith("__")})
    shim.einsum = _widened_einsum
    monkeypatch.setattr(jlayers, "jnp", shim)
    D, F_, E, k = 32, 48, 8, 2
    jp = jlayers.moe_init(jax.random.PRNGKey(5), D, F_, E,
                          dtype=jnp.bfloat16)
    tp = bridge._convert(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(2).normal(size=(B, 12, D)).astype(np.float32)
    want, w_aux = jlayers.moe(jp, jnp.asarray(x).astype(jnp.bfloat16),
                              experts_per_token=k, capacity_factor=1.25,
                              dispatch=dispatch)
    got, aux = tlayers.moe(tp, torch.from_numpy(x).bfloat16(),
                           experts_per_token=k, capacity_factor=1.25,
                           dispatch=dispatch)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    assert aux.item() == float(w_aux)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# the registry and the config-level twins of test_models.py
# ---------------------------------------------------------------------------


def test_registry_matches_jax():
    assert configs.all_archs() == jconfigs.all_archs()
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert configs.ALIASES == jconfigs.ALIASES
    for arch in configs.all_archs() + list(configs.ARCH_IDS):
        for get in ("get", "get_smoke"):
            assert dataclasses.asdict(getattr(configs, get)(arch)) == \
                dataclasses.asdict(getattr(jconfigs, get)(arch)), (arch, get)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_formula(arch):
    """param_count() against the port's init (within embed rounding), as
    test_models.py's twin, and the same number of parameters as JAX's."""
    cfg = configs.get_smoke(arch)
    actual = sum(x.numel() for x in leaves(init_params(cfg, 0, "cpu")))
    assert abs(actual - cfg.param_count()) / actual < 0.15
    jc = jconfigs.get_smoke(arch)
    jp = jax.eval_shape(lambda key: jinit(jc, key), jax.random.PRNGKey(0))
    assert actual == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jp))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("ring", [False, True])
def test_init_cache_matches_jax_layout(arch, ring):
    """Every family's cache has JAX's keys, shapes and dtypes (the ssm and
    RG-LRU states f32), and a ring of decode_window slots."""
    cfg, jc = configs.get_smoke(arch), jconfigs.get_smoke(arch)
    if ring:
        cfg = dataclasses.replace(cfg, decode_window=8, ring_cache=True)
        jc = dataclasses.replace(jc, decode_window=8, ring_cache=True)
    want = jax.eval_shape(lambda: jinit_cache(jc, 2, 24, jnp.float32))
    got = init_cache(cfg, 2, 24, device="cpu")
    assert set(got) == set(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert str(got[k].dtype).split(".")[1] == str(w.dtype), k
        assert not bool(got[k].any())


def test_moe_active_params_less_than_total():
    for arch in ("granite-moe-3b-a800m", "olmoe-1b-7b"):
        cfg = configs.get(arch)
        assert 0 < cfg.active_param_count() < cfg.param_count()
        assert cfg.active_param_count() == \
            jconfigs.get(arch).active_param_count()


def test_window_pattern_cycles():
    cfg = configs.get("gemma3-27b")
    w = cfg.layer_windows()
    assert len(w) == 62
    assert w[:6] == (1024, 1024, 1024, 1024, 1024, 0)
    assert w.count(0) == 10  # global layers


def test_hybrid_pattern():
    cfg = configs.get("recurrentgemma-2b")
    b = cfg.layer_blocks()
    assert len(b) == 26
    assert b[:3] == ("r", "r", "a")
    assert b.count("a") == 8 and b.count("r") == 18


def test_zoo_engine_serves_like_forward(zoo):
    """The engine gives the greedy tokens of the training forward re-run
    on each grown sequence: ``generate_bucketed`` on prompts of two
    lengths, or, for a family with a frontend input, ``generate`` on one
    row's prompt with its patches or frames."""
    from repro_torch.serving.engine import ServingEngine
    cfg, p = zoo["cfg"], zoo["params"]
    engine = ServingEngine(cfg, p)
    if zoo["front"]:
        prompts = [zoo["tokens"][0, :9]]
        front = {k: v[:1] for k, v in zoo["front"].items()}
        got = engine.generate({"tokens": prompts[0][None], **front},
                              3).numpy()
        assert engine.stats()["calls"] == 1
    else:
        prompts = [zoo["tokens"][0, :5], zoo["tokens"][1, :9],
                   zoo["tokens"][0, :9]]
        front = {}
        got = engine.generate_bucketed(prompts, 3)
    for prompt, row in zip(prompts, got):
        seq = torch.from_numpy(prompt).long()[None]
        for tok in row:
            logits, _ = forward(cfg, p, {
                "tokens": seq, **{k: torch.from_numpy(v)
                                  for k, v in front.items()}})
            assert int(logits[0, -1].argmax()) == int(tok)
            seq = torch.cat([seq, torch.tensor([[int(tok)]])], 1)
