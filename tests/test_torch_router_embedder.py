"""The port's static router and contrastive embedder against the JAX
package's (the twin of ``tests/test_router_embedder.py``): the logistic
router after 500 full-batch GD steps, the NT-Xent loss and its gradients,
the embedder's Adam step, and the twin's behaviour cases.

Tolerances: f32. Router weights within rtol 1e-4, atol 1e-5 after 500
steps (XLA fuses the BCE gradient in another summation order); the
NT-Xent loss within 1e-6 relative, its gradients within atol 1e-6 of
gradients of order 0.1; embedder parameters after 5 Adam steps (lr 3e-4
from the first step) within 1e-4 of the distance each leaf trained, in
L2, and no weight beyond Adam's own bound of 2 lr a step (a gradient
within rounding of zero takes a normalized step of any size up to lr).
"""
import _torch_threads  # noqa: F401  (a worker's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import embedder as jemb
from repro.core.router import train_router as jtrain_router
from repro_torch import bridge
from repro_torch.core import embedder as temb
from repro_torch.core.router import (LearnedRouter, OracleRouter,
                                     train_router)
from repro_torch.training.train_step import value_and_grad
from repro_torch.tree import leaves

SMALL = dict(vocab_size=32, d_model=32, num_layers=2, num_heads=2, d_ff=64,
             embed_dim=48)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's CPU training and serving: the
    suite runs in parallel workers, where more threads only contend, and a
    fixed count keeps the CPU reductions in one order on any host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def rng():
    """A fresh generator per test: the inputs do not depend on which tests
    ran before in the process."""
    return np.random.default_rng(7)


@pytest.fixture(scope="module")
def ecfg():
    return jemb.EmbedderConfig(**SMALL), temb.EmbedderConfig(**SMALL)


@pytest.fixture(scope="module")
def bridged(ecfg):
    jp = jemb.init_params(ecfg[0], jax.random.PRNGKey(1))
    return jp, bridge.embedder_params(ecfg[1], jax.tree.map(np.asarray, jp),
                                      device="cpu")


def _skill_batch(rng, n_skills=4, pairs=12, seq=10):
    """The twin's batch: per sample a skill template, operand noise in the
    last 4 tokens, right-padded rows of ragged length."""
    toks, sids = [], []
    for _ in range(pairs):
        s = int(rng.integers(0, n_skills))
        base = np.full(seq, s * 7 + 1, np.int32)
        for _ in range(2):
            t = base.copy()
            t[6:] = rng.integers(1, 32, 4)
            toks.append(t)
            sids.append(s)
    toks = np.stack(toks)
    toks[::3, 8:] = 0                     # PAD tails on every third row
    return toks, np.asarray(sids, np.int32)


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------


def test_train_router_matches_jax(rng):
    X = rng.normal(size=(600, 384)).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    y = (X @ rng.normal(size=384) + 0.3 * rng.normal(size=600) > 0.1
         ).astype(np.float32)
    j = jtrain_router(X, y)
    t = train_router(X, y, device="cpu")
    np.testing.assert_allclose(t.w.numpy(), np.asarray(j.w), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(float(t.b), float(j.b), rtol=1e-4, atol=1e-5)
    jp = np.asarray(jax.vmap(j.prob_weak_ok)(jnp.asarray(X)))
    tp = np.asarray([float(t.prob_weak_ok(x)) for x in X])
    np.testing.assert_allclose(tp, jp, atol=1e-5)
    assert [t.route_weak(x) for x in X] == [j.route_weak(jnp.asarray(x))
                                            for x in X]


def test_learned_router_separable(rng):
    """Logistic router must fit linearly separable profiling data."""
    n, d = 400, 16
    w_true = rng.normal(size=d)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (X @ w_true > 0).astype(np.float32)
    router = train_router(X, y, steps=300, device="cpu")
    pred = router.prob_weak_ok(X).numpy() > 0.5
    assert (pred == y.astype(bool)).mean() > 0.95


def test_router_threshold_controls_routing(rng):
    X = rng.normal(size=(100, 8)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    r = train_router(X, y, steps=200, device="cpu")
    strict = LearnedRouter(w=r.w, b=r.b, threshold=0.99)
    loose = LearnedRouter(w=r.w, b=r.b, threshold=0.01)
    n_strict = sum(strict.route_weak(x) for x in X)
    n_loose = sum(loose.route_weak(x) for x in X)
    assert n_strict <= n_loose


def test_oracle_router_routes_profiled_keys():
    r = OracleRouter(weak_ok_keys={3, 7})
    assert [r.route_weak_key(k) for k in (3, 4, 7)] == [True, False, True]


# ---------------------------------------------------------------------------
# embedder: loss, gradients, Adam step
# ---------------------------------------------------------------------------


def test_nt_xent_loss_and_grads_match_jax(rng, ecfg, bridged):
    jp, tp = bridged
    toks, sids = _skill_batch(rng)
    jl, jg = jax.value_and_grad(
        lambda p: jemb.nt_xent_loss(ecfg[0], p, jnp.asarray(toks),
                                    jnp.asarray(sids)))(jp)
    (tl, _), tg = value_and_grad(
        lambda p: (temb.nt_xent_loss(ecfg[1], p, toks, sids), {}), tp)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    for a, b in zip(jax.tree.leaves(jg), leaves(tg)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)


def test_embedder_adam_steps_match_jax(rng, ecfg, bridged):
    jp, tp = bridged
    jstep = jemb.make_train_step(ecfg[0])
    tstep = temb.make_train_step(ecfg[1])
    jo, to = jemb.init_opt(jp), temb.init_opt(tp)
    for _ in range(5):
        toks, sids = _skill_batch(rng)
        jp, jo, jl = jstep(jp, jo, jnp.asarray(toks), jnp.asarray(sids))
        tp, to, tl = tstep(tp, to, toks, sids)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    assert int(to["t"]) == int(jo["t"]) == 5
    for a, b, p0 in zip(jax.tree.leaves(jp), leaves(tp), leaves(bridged[1])):
        a, b, p0 = np.asarray(a), b.numpy(), p0.numpy()
        # Adam's step is g / (|g| + eps) scaled: a gradient within rounding
        # of zero may step differently (by at most 2 lr a step), so the
        # leaf is held as a whole, against the distance it trained
        assert np.linalg.norm(b - a) <= 1e-4 * np.linalg.norm(a - p0)
        assert np.abs(b - a).max() <= 2 * 3e-4 * 5
    assert not any(x.requires_grad for x in leaves(tp))


def test_training_attention_equals_inference_attention(rng, ecfg, bridged):
    """On right-padded rows the training attention (PAD keys at a negative
    position) and the inference one (``kv_len``) embed alike."""
    toks, _ = _skill_batch(rng)
    a = temb.embed(ecfg[1], bridged[1], toks)
    b = temb.embed(ecfg[1], bridged[1], toks,
                   attention=temb.model_attention)
    np.testing.assert_allclose(a.numpy(), b.detach().numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# the twin's behaviour cases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("attention", ["kernel", "model"])
def test_embedding_unit_norm(ecfg, rng, attention):
    params = temb.init_params(ecfg[1], seed=0, device="cpu")
    toks = rng.integers(1, 32, (4, 10)).astype(np.int32)
    z = temb.embed(ecfg[1], params, toks,
                   attention=getattr(temb, f"{attention}_attention"))
    assert z.shape == (4, 48)
    np.testing.assert_allclose(z.norm(dim=1).detach().numpy(), 1.0,
                               atol=1e-5)


@pytest.mark.parametrize("attention", ["kernel", "model"])
def test_embedding_pad_invariance(ecfg, rng, attention):
    """PAD tokens must not affect the embedding (mean-pool masking)."""
    params = temb.init_params(ecfg[1], seed=0, device="cpu")
    toks = rng.integers(1, 32, (2, 6)).astype(np.int32)
    padded = np.concatenate([toks, np.zeros((2, 4), np.int32)], axis=1)
    fn = getattr(temb, f"{attention}_attention")
    z1 = temb.embed(ecfg[1], params, toks, attention=fn)
    z2 = temb.embed(ecfg[1], params, padded, attention=fn)
    np.testing.assert_allclose(z1.detach().numpy(), z2.detach().numpy(),
                               atol=1e-4)


def test_contrastive_training_pulls_positives(ecfg, rng):
    """100 NT-Xent steps on 4 'skills' with deterministic token templates
    from a port init → same-skill cosine must clearly exceed
    different-skill cosine."""
    cfg = ecfg[1]
    params = temb.init_params(cfg, seed=1, device="cpu")
    opt = temb.init_opt(params)
    step = temb.make_train_step(cfg, lr=1e-3)
    for _ in range(100):
        toks, sids = _skill_batch(rng)
        params, opt, _ = step(params, opt, toks, sids)
    toks, sids = _skill_batch(rng)
    z = temb.embed(cfg, params, toks).numpy()
    sims = z @ z.T
    same = sims[(sids[:, None] == sids[None]) &
                ~np.eye(len(sids), dtype=bool)]
    diff = sims[sids[:, None] != sids[None]]
    assert same.mean() > diff.mean() + 0.3
