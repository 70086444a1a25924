"""The port's training half against the JAX package's (the twin of
``tests/test_training.py``): the model-level attention, the training
forward and loss, the LR schedule, AdamW, the train step (with gradient
accumulation) on bridged JAX weights, and the checkpoint format.

Tolerances: f32 throughout. The LR schedule within 3e-7 relative (a few
ulps: XLA fuses the warmup product in another order); forward logits and
losses within 1e-5 relative; parameters after AdamW within rtol 1e-4,
atol 2e-6 (weights of order 0.1-1; Adam's normalized step turns a 1e-7
difference in a gradient near zero into at most a few ulps of the step).
"""
import _torch_threads  # noqa: F401  (a worker's share of the cores)
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import rar_system as jrar
from repro.data.tasks import TaskSuite as JSuite
from repro.models import init_params as jinit
from repro.models import layers as JL
from repro.models import loss_fn as jloss
from repro.models.model import forward as jforward
from repro.training import AdamWConfig as JAdamW
from repro.training import adamw_update as jadamw
from repro.training import init_opt_state as jinit_opt
from repro.training import lr_schedule as jlr
from repro.training import make_train_step as jmake
from repro_torch import bridge
from repro_torch.configs import rar_system as trar
from repro_torch.models import forward, init_params, loss_fn
from repro_torch.models import layers as TL
from repro_torch.training import (AdamWConfig, adamw_update, init_opt_state,
                                  load_checkpoint, lr_schedule,
                                  make_train_step, save_checkpoint)
from repro_torch.tree import leaves

PARAM_TOL = dict(rtol=1e-4, atol=2e-6)
OPT = dict(learning_rate=1e-3, warmup_steps=50, total_steps=900,
           weight_decay=0.01, beta2=0.98)       # setup._train_lm's


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's CPU training and serving: the
    suite runs in parallel workers, where more threads only contend, and a
    fixed count keeps the CPU reductions in one order on any host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _same_tree(jtree, ttree, **tol):
    a, b = _np(jtree), [x.detach().cpu().numpy() for x in leaves(ttree)]
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y, x, **tol)


@pytest.fixture(scope="module")
def weak():
    """rar-weak from the JAX init, bridged to the port (CPU)."""
    jp = jinit(jrar.WEAK, jax.random.PRNGKey(0))
    return jp, bridge.lm_params(trar.WEAK, jax.tree.map(np.asarray, jp),
                                device="cpu")


@pytest.fixture
def rng():
    """A fresh generator per test: the inputs do not depend on which tests
    ran before in the process."""
    return np.random.default_rng(7)


@pytest.fixture(scope="module")
def suite():
    return JSuite()


def _copy_batch(rng, vocab, B=8, S=16):
    tokens = rng.integers(1, vocab, (B, S)).astype(np.int32)
    tokens[:, S // 2:] = tokens[:, :S // 2]
    labels = np.roll(tokens, -1, 1).astype(np.int32)
    labels[:, -1] = -1
    return {"tokens": tokens, "labels": labels}


# ---------------------------------------------------------------------------
# model-level attention and the training forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("H,KV,causal,window,dtype", [
    (4, 4, True, 0, "float32"),
    (8, 2, True, 5, "float32"),
    (4, 1, False, 0, "float32"),
    (4, 2, True, 3, "bfloat16"),
])
def test_attention_matches_jax(rng, H, KV, causal, window, dtype):
    B, Sq, Sk, hd = 2, 11, 11, 16
    q = rng.normal(size=(B, Sq, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, Sk, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, Sk, KV, hd)).astype(np.float32)
    qpos = np.broadcast_to(np.arange(Sq, dtype=np.int32), (B, Sq)).copy()
    kpos = np.broadcast_to(np.arange(Sk, dtype=np.int32), (B, Sk)).copy()
    kpos[1, 7:] = -10_000_000                     # masked keys (PAD)
    jdt = jnp.dtype(dtype)
    want = JL.attention(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                        q_positions=jnp.asarray(qpos),
                        k_positions=jnp.asarray(kpos), causal=causal,
                        window=window)
    tdt = getattr(torch, dtype)
    got = TL.attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                       q_positions=torch.from_numpy(qpos),
                       k_positions=torch.from_numpy(kpos), causal=causal,
                       window=window)
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" else \
        dict(rtol=1e-2, atol=1e-2)        # one bf16 ulp of the output
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)


def test_forward_and_loss_match_jax(weak, suite):
    jp, tp = weak
    batch = suite.weak_train_batch(np.random.default_rng(3), 16)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jlogits = np.asarray(jforward(jrar.WEAK, jp, jb)[0])
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits, aux = forward(trar.WEAK, tp, tb)
    np.testing.assert_allclose(logits.detach().numpy(), jlogits, rtol=1e-5,
                               atol=1e-5)
    assert float(aux) == 0.0
    jl, jm = jloss(jrar.WEAK, jp, jb)
    tl, tm = loss_fn(trar.WEAK, tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for k in ("ce", "aux", "accuracy"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)


def test_other_families_refused():
    """A family outside the zoo's six is refused by the training forward
    (every one of the six runs since the zoo was ported:
    tests/test_torch_zoo.py)."""
    for family in ("rnn", "diffusion"):
        cfg = dataclasses.replace(trar.WEAK, family=family)
        with pytest.raises(ValueError, match=family):
            forward(cfg, {}, {"tokens": torch.zeros((1, 4),
                                                    dtype=torch.long)})


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def test_lr_schedule_matches_jax_every_step():
    cfg = dict(learning_rate=1e-3, warmup_steps=10, total_steps=100,
               min_lr_ratio=0.1)
    got = [float(lr_schedule(AdamWConfig(**cfg), s)) for s in range(103)]
    want = [float(jlr(JAdamW(**cfg), jnp.asarray(s))) for s in range(103)]
    np.testing.assert_allclose(got, want, rtol=3e-7, atol=0)
    assert got[0] == 0.0 and got[10] == pytest.approx(1e-3, rel=1e-6)
    assert got[100] == pytest.approx(1e-4, rel=1e-3)
    assert all(a >= b - 1e-12 for a, b in zip(got[10:], got[11:]))


@pytest.mark.parametrize("clip", [1.0, 1e6])       # clipped / not clipped
def test_adamw_update_matches_jax(rng, clip):
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "nest": {"b": rng.normal(size=(5,)).astype(np.float32),
                       "c": rng.normal(size=(2, 2)).astype(np.float32)}}
    grads = jax.tree.map(lambda p: 3 * rng.normal(size=p.shape)
                         .astype(np.float32), params)
    cfg = dict(learning_rate=0.1, warmup_steps=2, total_steps=10,
               grad_clip_norm=clip)
    jp, js = params, jinit_opt(jax.tree.map(jnp.asarray, params))
    tp = jax.tree.map(torch.from_numpy, params)
    ts = init_opt_state(tp)
    for _ in range(3):                     # warmup, peak, decay steps
        jp, js, jm = jadamw(JAdamW(**cfg), jax.tree.map(jnp.asarray, grads),
                            js, like=jax.tree.map(jnp.asarray, jp))
        tp, ts, tm = adamw_update(AdamWConfig(**cfg),
                                  jax.tree.map(torch.from_numpy, grads), ts,
                                  like=tp)
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=3e-7)
    assert int(ts["step"]) == int(js["step"]) == 3
    for part in ("master", "mu", "nu"):
        _same_tree(js[part], ts[part], rtol=1e-6, atol=1e-7)
    _same_tree(jp, tp, rtol=1e-6, atol=1e-7)
    if clip == 1.0:
        assert float(tm["grad_norm"]) > clip        # the clip was taken


def test_adamw_moves_toward_minimum():
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = init_opt_state(params)
    cfg = AdamWConfig(learning_rate=0.1, warmup_steps=0, total_steps=200,
                      weight_decay=0.0)
    for _ in range(200):
        params, opt, _ = adamw_update(cfg, {"w": 2 * params["w"]}, opt)
    assert float(params["w"].abs().max()) < 0.05


def test_grad_clipping_caps_update():
    opt = init_opt_state({"w": torch.zeros(4)})
    cfg = AdamWConfig(learning_rate=1.0, warmup_steps=0, total_steps=10,
                      grad_clip_norm=1.0, weight_decay=0.0)
    _, _, metrics = adamw_update(cfg, {"w": torch.full((4,), 1e6)}, opt)
    assert float(metrics["grad_norm"]) > 1e5    # raw norm reported


def test_bf16_params_keep_f32_master():
    params = {"w": torch.tensor([1.0, -2.0], dtype=torch.bfloat16)}
    opt = init_opt_state(params)
    assert opt["master"]["w"].dtype == torch.float32
    new, opt, _ = adamw_update(AdamWConfig(warmup_steps=0),
                               {"w": torch.tensor([0.5, 0.5])}, opt,
                               like=params)
    assert new["w"].dtype == torch.bfloat16
    assert opt["master"]["w"].dtype == torch.float32


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_steps", [1, 10])
def test_train_step_matches_jax(weak, suite, n_steps):
    """rar-weak from the bridged JAX init, ``setup._train_lm``'s optimizer,
    ``weak_train_batch`` batches: loss, metrics and parameters."""
    jp, tp = weak
    jstep = jax.jit(jmake(jrar.WEAK, JAdamW(**OPT)))
    tstep = make_train_step(trar.WEAK, AdamWConfig(**OPT))
    js, ts = jinit_opt(jp), init_opt_state(tp)
    rng = np.random.default_rng(0)
    for _ in range(n_steps):
        batch = suite.weak_train_batch(rng, 96)
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tp, ts, tm = tstep(tp, ts, batch)
        assert set(tm) == set(jm)
        for k in ("loss", "ce", "aux", "accuracy", "lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, atol=1e-7)
    _same_tree(jp, tp, **PARAM_TOL)
    assert not any(x.requires_grad for x in leaves(tp))


def test_grad_accum_matches_jax(weak):
    """grad_accum=2 against JAX's grad_accum=2, with the system's
    optimizer (``OPT``: its 50-step warmup keeps the first Adam steps
    small, so a gradient within rounding of zero, whose normalized step
    may take any size up to the learning rate, stays within PARAM_TOL)."""
    jp, tp = weak
    batch = _copy_batch(np.random.default_rng(5), trar.WEAK.vocab_size)
    j2 = jax.jit(jmake(jrar.WEAK, JAdamW(**OPT), grad_accum=2))
    jp2, _, jm2 = j2(jp, jinit_opt(jp),
                     {k: jnp.asarray(v) for k, v in batch.items()})
    tp2, _, tm2 = make_train_step(trar.WEAK, AdamWConfig(**OPT),
                                  grad_accum=2)(tp, init_opt_state(tp), batch)
    for k in ("loss", "ce", "aux", "accuracy", "lr", "grad_norm"):
        np.testing.assert_allclose(float(tm2[k]), float(jm2[k]), rtol=1e-5,
                                   atol=1e-7)
    _same_tree(jp2, tp2, **PARAM_TOL)


def test_grad_accum_matches_full_batch(weak):
    """The twin's check in the port: grad_accum=2 against the single-shot
    step, identical valid-label counts per microbatch, with its tolerances
    (loss 1e-4; parameters rtol 2e-3, atol 2e-4 after a full-size first
    Adam step)."""
    _, tp = weak
    opt = AdamWConfig(learning_rate=1e-3, warmup_steps=0, total_steps=10)
    batch = _copy_batch(np.random.default_rng(5), trar.WEAK.vocab_size)
    tp1, _, tm1 = make_train_step(trar.WEAK, opt)(tp, init_opt_state(tp),
                                                  batch)
    tp2, _, tm2 = make_train_step(trar.WEAK, opt, grad_accum=2)(
        tp, init_opt_state(tp), batch)
    np.testing.assert_allclose(float(tm1["loss"]), float(tm2["loss"]),
                               rtol=1e-4)
    for a, b in zip(leaves(tp1), leaves(tp2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3,
                                   atol=2e-4)


def test_train_loop_reduces_loss(suite):
    """40 steps on ``weak_train_batch`` batches from a fresh port init of
    rar-weak: the loss must drop substantially (model + loss + AdamW
    integrated)."""
    params = init_params(trar.WEAK, seed=0, device="cpu")
    step = make_train_step(trar.WEAK, AdamWConfig(
        learning_rate=3e-3, warmup_steps=5, total_steps=60))
    opt = init_opt_state(params)
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(40):
        params, opt, m = step(params, opt, suite.weak_train_batch(rng, 32))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.7, (losses[0], losses[-1])


def test_sharded_batch_axes_refused():
    """``batch_axes`` takes a batch of DTensors, as the dry run places it
    (``tests/test_torch_dryrun.py`` holds that step to the plain one); a
    batch of plain tensors is refused: sharded training on several cards
    is not ported."""
    params = init_params(trar.WEAK, seed=0, device="cpu")
    step = make_train_step(trar.WEAK, grad_accum=2, batch_axes="data")
    batch = {"tokens": torch.zeros((4, 8), dtype=torch.int32),
             "labels": torch.zeros((4, 8), dtype=torch.int32)}
    with pytest.raises(NotImplementedError, match="sharded"):
        step(params, init_opt_state(params), batch)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nest": {"b": torch.tensor([1, 2, 3], dtype=torch.int32),
                     "deep": {"h": torch.tensor([1.5, -2.25],
                                                dtype=torch.bfloat16)}},
            "step": torch.tensor(7, dtype=torch.int32),
            "name": np.asarray(3.5)}
    path = os.path.join(tmp_path, "sub", "ckpt.npz")
    save_checkpoint(path, tree)
    # a plain npz of '/'-joined key paths: no pickle in the file
    with np.load(path, allow_pickle=False) as data:
        assert sorted(data.files) == ["a", "name", "nest/b",
                                      "nest/deep/h@bfloat16", "step"]
    back = load_checkpoint(path, device="cpu")
    assert set(back) == {"a", "nest", "step", "name"}
    for x, y in ((back["a"], tree["a"]), (back["nest"]["b"],
                                          tree["nest"]["b"]),
                 (back["nest"]["deep"]["h"], tree["nest"]["deep"]["h"]),
                 (back["step"], tree["step"])):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)
    assert float(back["name"]) == 3.5
    assert os.listdir(os.path.dirname(path)) == ["ckpt.npz"]   # no temp


def test_checkpoint_refuses_slash_keys(tmp_path):
    with pytest.raises(ValueError, match="'/'"):
        save_checkpoint(os.path.join(tmp_path, "x.npz"),
                        {"a/b": torch.zeros(1)})
