"""The model zoo's dense and moe families in the port, against the JAX
package: the twins of ``tests/test_models.py`` for the dense and moe
archs, of its config-level tests, and of ``layers.moe``.

Every dense and moe arch of the registry runs at its smoke config (f32)
on JAX's weights through the bridge: forward logits within 1e-4 and its
aux loss within 1e-5 relative, prefill and decode-step logits within 1e-4
(the two frameworks sum their products in other orders: ~1e-5 on logits
of magnitude ~5); greedy tokens identical. The port's own checks of
``test_models.py``: shapes and finiteness, one AdamW step that moves the
parameters, prefill == forward and decode == forward at 1e-4 (f32, where
JAX's bf16-minded test allows 0.1). ``moe`` alone is held to JAX's
``layers.moe`` in both dispatches at a capacity factor that drops tokens:
expert indices, places and kept masks exactly, gates and aux within 1e-6,
outputs within 1e-5. The ssm, hybrid, vlm and audio archs resolve in the
registry and are refused by the model, naming their ROADMAP item.
"""
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
from repro.models import init_params as jinit
from repro.models import layers as jlayers
from repro.models import prefill as jprefill
from repro_torch import bridge, configs
from repro_torch.models import (decode_step, forward, init_cache, init_params,
                                loss_fn, prefill)
from repro_torch.models import layers as tlayers
from repro_torch.training import AdamWConfig, init_opt_state, make_train_step
from repro_torch.tree import leaves

ARCHS = [a for a in configs.all_archs()
         if configs.get(a).family in ("dense", "moe")]
OTHERS = [a for a in configs.all_archs() if a not in ARCHS]
B, S = 2, 16


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1).astype(np.int32)
    labels[:, -1] = -1
    return tokens, labels, rng.integers(1, cfg.vocab_size, B).astype(np.int32)


@partial(jax.jit, static_argnums=(0,))
def _jax_run(cfg, params, tokens, nxt):
    """Forward (logits, aux), prefill's last logits, one decode step."""
    logits, aux = jforward(cfg, params, {"tokens": tokens})
    last, cache, pos = jprefill(cfg, params, {"tokens": tokens}, S + 4)
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
    tokens, labels, nxt = _batch(tc, len(arch))
    want = [np.asarray(x, np.float32) for x in
            _jax_run(jc, jp, jnp.asarray(tokens), jnp.asarray(nxt))]
    return dict(arch=arch, cfg=tc, params=tp, tokens=tokens, labels=labels,
                nxt=nxt, want=want)


def test_zoo_matches_jax_on_bridged_weights(zoo):
    cfg, p = zoo["cfg"], zoo["params"]
    w_logits, w_aux, w_last, w_step = zoo["want"]
    t = torch.from_numpy(zoo["tokens"]).long()
    logits, aux = forward(cfg, p, {"tokens": t})
    np.testing.assert_allclose(logits.numpy(), w_logits, rtol=0, atol=1e-4)
    np.testing.assert_allclose(aux.item(), w_aux, rtol=1e-5, atol=1e-7)
    last, cache, pos = prefill(cfg, p, {"tokens": t}, S + 4)
    assert pos == S and cache["k"].shape[2] == S + 4
    np.testing.assert_allclose(last.numpy(), w_last, rtol=0, atol=1e-4)
    step, _ = decode_step(cfg, p, torch.from_numpy(zoo["nxt"]), cache, pos)
    np.testing.assert_allclose(step.numpy(), w_step, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(step.numpy().argmax(-1),
                                  w_step.argmax(-1))


def test_zoo_forward_shapes_and_finite(zoo):
    cfg = zoo["cfg"]
    logits, aux = forward(cfg, zoo["params"],
                          {"tokens": torch.from_numpy(zoo["tokens"]).long()})
    assert logits.shape == (B, S, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(aux))
    assert (aux.item() > 0) == (cfg.family == "moe")


def test_zoo_one_train_step_moves_params(zoo):
    cfg, p = zoo["cfg"], zoo["params"]
    step = make_train_step(cfg, AdamWConfig(learning_rate=1e-3,
                                            warmup_steps=1, total_steps=10))
    new, _, metrics = step(p, init_opt_state(p),
                           {"tokens": zoo["tokens"], "labels": zoo["labels"]})
    assert bool(torch.isfinite(metrics["loss"])) and metrics["loss"] > 0
    assert all(bool(torch.isfinite(x.float()).all()) for x in leaves(new))
    assert any(bool((a != b).any()) for a, b in zip(leaves(p), leaves(new)))
    if cfg.family == "moe":     # the router learns too (through the gates)
        assert bool((new["layers"]["moe"]["router"] !=
                     p["layers"]["moe"]["router"]).any())
    total, m = loss_fn(cfg, p, {"tokens": torch.from_numpy(zoo["tokens"]),
                                "labels": torch.from_numpy(zoo["labels"])})
    np.testing.assert_allclose(total.item(), (m["ce"] + 0.01 * m["aux"]
                                              ).item(), rtol=1e-6)


def test_zoo_prefill_and_decode_match_forward(zoo):
    cfg, p = zoo["cfg"], zoo["params"]
    t = torch.from_numpy(zoo["tokens"]).long()
    full, _ = forward(cfg, p, {"tokens": t})
    last, cache, pos = prefill(cfg, p, {"tokens": t}, S + 4)
    np.testing.assert_allclose(last.numpy(), full[:, -1].numpy(), rtol=0,
                               atol=1e-4)
    nxt = torch.from_numpy(zoo["nxt"])
    step, _ = decode_step(cfg, p, nxt, cache, pos)
    ext, _ = forward(cfg, p, {"tokens": torch.cat([t, nxt[:, None].long()],
                                                  1)})
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
    test_models.py's twin for the archs the port runs."""
    cfg = configs.get_smoke(arch)
    actual = sum(x.numel() for x in leaves(init_params(cfg, 0, "cpu")))
    assert abs(actual - cfg.param_count()) / actual < 0.15
    jc = jconfigs.get_smoke(arch)
    jp = jax.eval_shape(lambda key: jinit(jc, key), jax.random.PRNGKey(0))
    assert actual == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jp))


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


@pytest.mark.parametrize("arch", OTHERS)
def test_unported_families_are_refused(arch):
    cfg = configs.get_smoke(arch)
    item = {"ssm": 3, "hybrid": 3, "vlm": 4, "audio": 4}[cfg.family]
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP.md queue 1 item {item}"):
        init_params(cfg, 0, "cpu")
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP.md queue 1 item {item}"):
        init_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError):
        bridge.lm_params(cfg, {}, device="cpu")


def test_zoo_engine_serves_like_forward(zoo):
    """ServingEngine.generate_bucketed on prompts of two lengths gives the
    greedy tokens of the training forward re-run on each grown sequence."""
    from repro_torch.serving.engine import ServingEngine
    cfg, p = zoo["cfg"], zoo["params"]
    prompts = [zoo["tokens"][0, :5], zoo["tokens"][1, :9],
               zoo["tokens"][0, :9]]
    got = ServingEngine(cfg, p).generate_bucketed(prompts, 3)
    for prompt, row in zip(prompts, got):
        seq = torch.from_numpy(prompt).long()[None]
        for tok in row:
            logits, _ = forward(cfg, p, {"tokens": seq})
            assert int(logits[0, -1].argmax()) == int(tok)
            seq = torch.cat([seq, torch.tensor([[int(tok)]])], 1)
