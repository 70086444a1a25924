"""The port's guide store and serving engine against the JAX package's:
after the same op sequences every store field is equal and reads return
the same rows and metadata; the bucketed engine serves the same tokens
with the same counters."""
import _torch_threads  # noqa: F401  (a worker's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import rar_system as jrar
from repro.core import memory as jmem
from repro.models import init_params as jinit
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import rar_system as trar
from repro_torch.core import memory as tmem
from repro_torch.serving.engine import ServingEngine as TEngine

MEM_FIELDS = ("emb", "guide", "has_guide", "hard", "valid", "added_at",
              "ptr")
CFG = dict(capacity=24, embed_dim=16, guide_len=4)


def _host(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _assert_same_store(js, ts):
    for f in MEM_FIELDS:
        np.testing.assert_array_equal(_host(getattr(js, f)),
                                      _host(getattr(ts, f)), f)


def _unit(rng, n, e):
    x = rng.normal(size=(n, e)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_store_ops_match_jax(seed):
    """add / add_batch (past the ring's end) / mark_soft / touch, then a
    CommitBuffer epoch with stale flag ops, then grow."""
    rng = np.random.default_rng(seed)
    js = jmem.init_memory(jmem.MemoryConfig(**CFG))
    ts = tmem.init_memory(tmem.MemoryConfig(**CFG), device="cpu")
    now = 0
    for _ in range(6):
        K = int(rng.integers(1, 9))
        embs = _unit(rng, K, 16)
        guides = rng.integers(0, 50, (K, 4)).astype(np.int32)
        hg = rng.random(K) < 0.5
        hard = rng.random(K) < 0.3
        nows = np.arange(now + 1, now + K + 1, dtype=np.int32)
        now += K
        js = jmem.add_batch(js, jnp.asarray(embs), jnp.asarray(guides),
                            jnp.asarray(hg), jnp.asarray(hard),
                            jnp.asarray(nows))
        tmem.add_batch(ts, embs, guides, hg, hard, nows)
        idx = rng.integers(0, 24, 3).astype(np.int32)
        js = jmem.mark_soft(js, jnp.asarray(idx[:1]))
        tmem.mark_soft(ts, idx[:1])
        js = jmem.touch(js, jnp.asarray(idx[1:]), jnp.asarray([now, now]))
        tmem.touch(ts, idx[1:], np.asarray([now, now], np.int32))
        _assert_same_store(js, ts)
    e = _unit(rng, 1, 16)[0]
    js = jmem.add(js, jnp.asarray(e), jnp.zeros(4, jnp.int32),
                  jnp.asarray(True), jnp.asarray(False), jnp.int32(now + 1))
    tmem.add(ts, e, np.zeros(4, np.int32), True, False, now + 1)
    _assert_same_store(js, ts)

    jb, tb = jmem.CommitBuffer(), tmem.CommitBuffer()
    snap = int(js.ptr) - 20                    # a stale pointer snapshot
    for j, b in ((jb, js), (tb, ts)):
        for i in range(5):
            j.stage_add(_unit(np.random.default_rng(i), 1, 16)[0],
                        np.full(4, i, np.int32), i % 2 == 0, i == 3,
                        now + 10 - i)
        j.stage_soft_clear(3, now + 11, snap)
        j.stage_soft_clear(int(js.ptr) % 24, now + 12)
        j.stage_touch(5, now + 13, None)
        j.stage_touch(5, now + 14, snap)
    js, n1 = jb.apply(js)
    ts, n2 = tb.apply(ts)
    assert n1 == n2 and jb.epoch == tb.epoch
    _assert_same_store(js, ts)

    jg, jremap = jmem.grow_memory(js, 40)
    tg, tremap = tmem.grow_memory(ts, 40)
    _assert_same_store(jg, tg)
    np.testing.assert_array_equal(np.asarray(jremap), tremap.numpy())



@pytest.mark.parametrize("n", [0, 7, 24, 31])
def test_debug_size_matches_jax(n):
    """``debug_size`` (the syncing count of ``valid``) equals JAX's and
    ``size_fast`` on an empty store, part full, full and past the ring's
    end."""
    rng = np.random.default_rng(n)
    js = jmem.init_memory(jmem.MemoryConfig(**CFG))
    ts = tmem.init_memory(tmem.MemoryConfig(**CFG), device="cpu")
    for i in range(0, n, 8):
        K = min(8, n - i)
        embs = _unit(rng, K, 16)
        guides = rng.integers(0, 50, (K, 4)).astype(np.int32)
        hg, hard = rng.random(K) < 0.5, rng.random(K) < 0.3
        nows = np.arange(i + 1, i + K + 1, dtype=np.int32)
        js = jmem.add_batch(js, jnp.asarray(embs), jnp.asarray(guides),
                            jnp.asarray(hg), jnp.asarray(hard),
                            jnp.asarray(nows))
        tmem.add_batch(ts, embs, guides, hg, hard, nows)
    assert ts.debug_size() == js.debug_size() == ts.size_fast == min(n, 24)


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("guides_only", [False, True])
def test_query_topk_batch_matches_jax(k, guides_only):
    rng = np.random.default_rng(k)
    js = jmem.init_memory(jmem.MemoryConfig(**CFG))
    ts = tmem.init_memory(tmem.MemoryConfig(**CFG), device="cpu")
    embs = _unit(rng, 18, 16)
    embs[7] = embs[3]                          # exact tie
    guides = rng.integers(0, 50, (18, 4)).astype(np.int32)
    hg = rng.random(18) < 0.5
    hard = rng.random(18) < 0.3
    nows = np.arange(1, 19, dtype=np.int32)
    js = jmem.add_batch(js, jnp.asarray(embs), jnp.asarray(guides),
                        jnp.asarray(hg), jnp.asarray(hard), jnp.asarray(nows))
    tmem.add_batch(ts, embs, guides, hg, hard, nows)
    qs = np.concatenate([embs[[3, 0]], _unit(rng, 3, 16)])
    jq = jmem.query_topk_batch(js, jnp.asarray(qs), k,
                               guides_only=guides_only).device_get()
    tq = tmem.query_topk_batch(ts, qs, k,
                               guides_only=guides_only).device_get()
    np.testing.assert_array_equal(np.asarray(jq.meta), tq.meta)
    np.testing.assert_allclose(np.asarray(jq.sim), tq.sim, atol=1e-6,
                               rtol=0)
    jq1 = jmem.query_topk(js, jnp.asarray(qs[0]), k,
                          guides_only=guides_only).device_get()
    tq1 = tmem.query_topk(ts, qs[0], k, guides_only=guides_only).device_get()
    np.testing.assert_array_equal(np.asarray(jq1.meta), tq1.meta)
    assert tq.index.shape == (5, k) and tq.guide.shape == (5, k, 4)


def test_generate_bucketed_matches_jax_engine():
    jp = jinit(jrar.WEAK, jax.random.PRNGKey(0))
    tp = bridge.lm_params(trar.WEAK, jax.tree.map(np.asarray, jp),
                          device="cpu")
    je, te = JEngine(jrar.WEAK, jp), TEngine(trar.WEAK, tp)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, trar.WEAK.vocab_size, n).astype(np.int32)
               for n in (9, 12, 9, 9, 12, 5, 9)]
    for max_new in (1, 2, 1):
        np.testing.assert_array_equal(
            te.generate_bucketed(prompts, max_new),
            je.generate_bucketed(prompts, max_new))
    assert te.stats() == je.stats()
    assert te.export_counters() == je.export_counters()
    te.restore_counters({"calls": 3, "tokens_processed": 4})
    assert te.calls == 3 and te.tokens_processed == 4
