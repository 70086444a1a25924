"""The port's IVF two-level retrieval plane against the JAX package's: the
twins of ``tests/test_memory_ivf.py``. The same op sequences
on stores built from the same numpy inputs give identical cluster
assignments and member buckets, centroids within 2 ulp, and reads with
identical indices and metadata and sims within 2 ulp at 1.0 (the rows are
unit cosines; the batch read's einsum sums 32 products in another order).

The hypothesis sweeps of the JAX file become fixed parametrised cases
here. Its two sharded-store tests are twinned against the single-device
store, since JAX's ``ShardedMemory`` raises under JAX 0.9: the port's plane
over a sharded backing must equal the port's and JAX's over a
``MemoryState`` after the same commits.
"""
import _torch_threads  # noqa: F401  (a worker's share of the cores)
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import memory as jmem
from repro.core.memory_ivf import IVFMemory as JIVF
from repro.core.rar import RAR as JRAR
from repro.core.rar import RARConfig as JConfig
from repro.kernels import ref as jref
from repro.kernels.memory_topk import to_padded_layout as jlayout
from repro_torch.core import memory as tmem
from repro_torch.core.memory_ivf import (IVFMemory, _route_merged,
                                         _route_merged_batch, wrap_store)
from repro_torch.core.memory_sharded import ShardedMemory
from repro_torch.core.rar import RAR, RARConfig
from repro_torch.kernels import ops
from repro_torch.kernels.memory_topk import MASK_VALID

E, G = 32, 8
ULP2 = 2 * float(np.finfo(np.float32).eps)


def _protos(rng, n, e=E):
    p = rng.normal(size=(n, e)).astype(np.float32)
    return p / np.linalg.norm(p, axis=1, keepdims=True)


def _clustered(rng, protos, n, noise=0.05):
    x = protos[rng.integers(0, len(protos), n)] \
        + noise * rng.normal(size=(n, protos.shape[1])).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _cfg(C):
    return dict(capacity=C, embed_dim=E, guide_len=G)


def _pair(C, **kw):
    """A JAX IVF store and the port's (on the CPU), both empty."""
    j = JIVF(jmem.init_memory(jmem.MemoryConfig(**_cfg(C))), **kw)
    t = IVFMemory(tmem.init_memory(tmem.MemoryConfig(**_cfg(C)),
                                   device="cpu"), **kw)
    return j, t


def _fill(stores, rng, X, guide_frac=0.7, chunk=32):
    """``tests/test_memory_ivf.py::_fill`` on every store of ``stores``
    with the same draws."""
    for i in range(0, len(X), chunk):
        xb = X[i:i + chunk]
        k = len(xb)
        g = rng.integers(0, 100, size=(k, G)).astype(np.int32)
        hg = rng.random(k) < guide_frac
        hard = rng.random(k) < 0.5
        now = np.full(k, i, np.int32)
        for s in stores:
            if isinstance(s, JIVF):
                s.add_batch(jnp.asarray(xb), jnp.asarray(g), jnp.asarray(hg),
                            jnp.asarray(hard), jnp.asarray(now))
            else:
                s.add_batch(xb, g, hg, hard, now)


def _same_index(j, t):
    np.testing.assert_array_equal(j._assign, t._assign)
    np.testing.assert_array_equal(j._members, t._members)
    np.testing.assert_array_equal(j._ccount, t._ccount)
    np.testing.assert_allclose(j._cent, t._cent, atol=ULP2, rtol=0)
    assert j._seeded == t._seeded and j.stats() == t.stats()


def _same_result(a, b):
    b = b.device_get()
    np.testing.assert_array_equal(np.asarray(a.meta), b.meta)
    np.testing.assert_allclose(np.asarray(a.sim), b.sim, atol=ULP2, rtol=0)


def _assert_matches_exact(ivf, qs, k, guides_only=False, batch=False):
    """The port's IVF read equals its exact scan on every valid entry
    (``tests/test_memory_ivf.py::_assert_matches_exact``)."""
    if batch:
        got = ivf.query_topk_batch(qs, k, guides_only=guides_only)
        want = ivf.exact_query_topk_batch(qs, k, guides_only=guides_only)
    else:
        got = ivf.query_topk(qs, k, guides_only=guides_only)
        want = ivf.exact_query_topk(qs, k, guides_only=guides_only)
    got, want = got.device_get(), want.device_get()
    np.testing.assert_allclose(got.sim, want.sim, atol=1e-5)
    valid = want.sim > -2.0
    np.testing.assert_array_equal(got.meta[valid], want.meta[valid])


def _reads_match_jax(j, t, qs, k, guides_only=False):
    """Single and batch reads of the two packages on the same store."""
    _same_result(j.query_topk(jnp.asarray(qs[0]), k,
                              guides_only=guides_only),
                 t.query_topk(qs[0], k, guides_only=guides_only))
    _same_result(j.query_topk_batch(jnp.asarray(qs), k,
                                    guides_only=guides_only),
                 t.query_topk_batch(qs, k, guides_only=guides_only))


# ---------------------------------------------------------------------------
# Route: the port's plain version against the JAX oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,P,n_probe,B,density", [
    (0, 9, 1, 1, 0.0), (1, 16, 2, 3, 0.5), (2, 33, 4, 16, 1.0),
    (3, 100, 8, 3, 0.5), (4, 100, 8, 16, 0.0), (5, 9, 8, 1, 1.0)])
def test_route_kernel_matches_oracle(seed, P, n_probe, B, density):
    rng = np.random.default_rng(seed)
    cent = _protos(rng, P)
    bits = (rng.random(P) < density).astype(np.int32) * MASK_VALID
    centp, cmaskp = jlayout(jnp.asarray(cent), jnp.asarray(bits),
                            block_c=64)
    qs = _protos(rng, B)
    tc, tm = torch.from_numpy(np.array(centp)), torch.from_numpy(
        np.array(cmaskp))
    s_o, i_o = jref.ivf_route_batch_padded(centp, jnp.asarray(qs), cmaskp,
                                           n_probe)
    s_t, i_t = ops.ivf_route_batch_padded(tc, torch.from_numpy(qs), tm,
                                          n_probe)
    np.testing.assert_array_equal(np.asarray(i_o), i_t.numpy())
    np.testing.assert_allclose(np.asarray(s_o), s_t.numpy(), atol=ULP2)
    s1_o, i1_o = jref.ivf_route_padded(centp, jnp.asarray(qs[0]), cmaskp,
                                       n_probe)
    s1_t, i1_t = ops.ivf_route_padded(tc, torch.from_numpy(qs[0]), tm,
                                      n_probe)
    np.testing.assert_array_equal(np.asarray(i1_o), i1_t.numpy())
    np.testing.assert_allclose(np.asarray(s1_o), s1_t.numpy(), atol=ULP2)


# ---------------------------------------------------------------------------
# Exactness anchor and recall, each against the JAX plane
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,C,k,clusters,fill,guides_only", [
    (0, 64, 1, 4, 0.3, False), (1, 100, 4, 8, 0.8, True),
    (2, 100, 2, 16, 1.2, False), (3, 256, 4, 8, 1.2, True),
    (4, 64, 2, 16, 0.0, False), (5, 256, 1, 4, 0.8, False)])
def test_property_all_probes_equals_exact(seed, C, k, clusters, fill,
                                          guides_only):
    """probes == clusters reproduces the exhaustive scan on every valid
    entry (partial fills, duplicate rows, guides-only views, wrapped
    rings), and the port's plane equals the JAX plane throughout."""
    rng = np.random.default_rng(seed)
    j, t = _pair(C, clusters=clusters, probes=clusters)
    protos = _protos(rng, clusters)
    n = int(C * fill)
    if n:
        X = _clustered(rng, protos, n)
        if n >= 3:
            X[n // 2] = X[0]               # duplicate row -> tied sims
        _fill((j, t), rng, X)
    _same_index(j, t)
    qs = _clustered(rng, protos, 5)
    _assert_matches_exact(t, qs[0], k, guides_only=guides_only)
    _assert_matches_exact(t, qs, k, guides_only=guides_only, batch=True)
    _reads_match_jax(j, t, qs, k, guides_only)


@pytest.mark.parametrize("seed,probes,k", [(0, 4, 1), (1, 8, 4)])
def test_property_recall_on_clustered_data(seed, probes, k):
    """At probes >= 4 of 16 clusters on skill-structured data, recall@k
    against the exact scan stays >= 0.9, with the JAX plane's rows."""
    rng = np.random.default_rng(seed)
    C, clusters = 512, 16
    j, t = _pair(C, clusters=clusters, probes=probes)
    protos = _protos(rng, clusters)
    _fill((j, t), rng, _clustered(rng, protos, C), guide_frac=1.0)
    _same_index(j, t)
    qr = _clustered(rng, protos, 32)
    got = t.query_topk_batch(qr, k).device_get().index
    want = t.exact_query_topk_batch(qr, k).device_get().index
    recall = np.mean([len(set(got[b]) & set(want[b])) / k
                      for b in range(len(qr))])
    assert recall >= 0.9, recall
    np.testing.assert_array_equal(
        np.asarray(j.query_topk_batch(jnp.asarray(qr), k).index), got)


# ---------------------------------------------------------------------------
# IVF off: the default constructs no wrapper
# ---------------------------------------------------------------------------


def test_default_config_wraps_nothing():
    cfg = RARConfig()
    assert cfg.retrieval_clusters == 0
    store = tmem.init_memory(cfg.memory, device="cpu")
    assert wrap_store(store, cfg) is store


def test_ivf_off_query_path_bit_identical(rng):
    store = tmem.init_memory(tmem.MemoryConfig(**_cfg(64)), device="cpu")
    X = _clustered(rng, _protos(rng, 4), 40)
    tmem.add_batch(store, X, np.zeros((40, G), np.int32), np.ones(40, bool),
                   np.zeros(40, bool), np.zeros(40, np.int32))
    wrapped = wrap_store(store, RARConfig())
    assert wrapped is store
    for read, q in ((tmem.query_topk, X[3]), (tmem.query_topk_batch, X[:8])):
        a, b = read(store, q, 4), read(wrapped, q, 4)
        assert torch.equal(a.sim, b.sim) and torch.equal(a.meta, b.meta)


def test_controller_default_keeps_raw_store():
    cfg = RARConfig(memory=tmem.MemoryConfig(**_cfg(32)))
    rar = RAR(None, None, lambda p: None, lambda e, k: False, cfg,
              device="cpu")
    assert isinstance(rar.memory, tmem.MemoryState)
    on = dataclasses.replace(cfg, retrieval_clusters=4, retrieval_probes=2)
    rar2 = RAR(None, None, lambda p: None, lambda e, k: False, on,
               device="cpu")
    assert isinstance(rar2.memory, IVFMemory)
    rar3 = RAR(None, None, lambda p: None, lambda e, k: False, on,
               memory=rar2.memory, device="cpu")
    assert rar3.memory is rar2.memory


def test_sharded_backing_refused():
    """A backing store that is neither a ``MemoryState`` nor a
    ``ShardedMemory`` is refused with the reason, never wrapped."""
    with pytest.raises(TypeError, match="MemoryState or a ShardedMemory"):
        IVFMemory(object(), clusters=4)


# ---------------------------------------------------------------------------
# Sharded composition: cluster c lives with shard c % S
# ---------------------------------------------------------------------------


def test_per_shard_route_merge_bit_identical():
    """test_memory_ivf.py::test_per_shard_route_merge_bit_identical: the S
    per-shard centroid subsets' routes, merged, equal the global plane's
    route, in the port and in JAX, single and batched."""
    rng = np.random.default_rng(20)
    from repro.core.memory_ivf import _route_merged as jroute
    P, S, n_probe = 16, 4, 4
    cent = _protos(rng, P)
    bits = np.full(P, MASK_VALID, np.int32)

    def planes(groups):
        out, jout = [], []
        for ids in groups:
            cp, mp = jlayout(jnp.asarray(cent[ids]), jnp.asarray(bits[ids]),
                             block_c=64)
            jout.append((cp, mp, jnp.asarray(ids.astype(np.int32))))
            out.append((torch.from_numpy(np.array(cp)),
                        torch.from_numpy(np.array(mp)),
                        torch.from_numpy(ids.astype(np.int32))))
        return out, jout

    glob, jglob = planes([np.arange(P)])
    shard, jshard = planes([np.arange(s, P, S) for s in range(S)])
    qs = _protos(rng, 4)
    gs, gi = _route_merged_batch(glob, torch.from_numpy(qs), n_probe)
    ss, si = _route_merged_batch(shard, torch.from_numpy(qs), n_probe)
    assert torch.equal(gi, si) and torch.equal(gs, ss)
    for b in range(len(qs)):
        q = torch.from_numpy(qs[b])
        s1, i1 = _route_merged(shard, q, n_probe)
        assert torch.equal(i1, si[b]) and torch.equal(s1, ss[b])
        js, ji = jroute(jshard, jnp.asarray(qs[b]), n_probe)
        np.testing.assert_array_equal(np.asarray(ji), i1.numpy())
        np.testing.assert_allclose(np.asarray(js), s1.numpy(), atol=ULP2,
                                   rtol=0)
        jgs, jgi = jroute(jglob, jnp.asarray(qs[b]), n_probe)
        np.testing.assert_array_equal(np.asarray(jgi), np.asarray(ji))


@pytest.mark.parametrize("S", [1, 2, 4])
def test_sharded_backing_matches_exact(S):
    """test_memory_ivf.py::test_sharded_backing_matches_exact at S shards:
    with every probe the geometry allows (probes = clusters / S; all of
    them at S = 1) the reads equal the exact oracle on clustered rows, and
    every read equals JAX's plane over a single-device ``MemoryState``
    after the same commits (a wrapped ring), rows, meta and sims."""
    rng = np.random.default_rng(21 + S)
    C, P = 128, 8
    probes = P // S
    kw = dict(clusters=P, probes=probes)
    j = JIVF(jmem.init_memory(jmem.MemoryConfig(**_cfg(C))), **kw)
    sh = IVFMemory(ShardedMemory(tmem.MemoryConfig(**_cfg(C)), shards=S,
                                 device="cpu"), **kw)
    protos = _protos(rng, P)
    _fill((j, sh), rng, _clustered(rng, protos, C + 40))
    _same_index(j, sh)
    qs = _clustered(rng, protos, 6)
    for k, guides_only in ((1, False), (4, True)):
        _assert_matches_exact(sh, qs[0], k, guides_only)
        _assert_matches_exact(sh, qs, k, guides_only, batch=True)
        _reads_match_jax(j, sh, qs, k, guides_only)


def test_sharded_offload_matches_jax_single_device():
    """The offload read over a sharded backing gathers its hot rows at
    their physical rows: it equals JAX's offload plane over a
    ``MemoryState`` query for query, and the traffic split too."""
    rng = np.random.default_rng(26)
    C, P, S = 128, 8, 2
    kw = dict(clusters=P, probes=2, offload=True, cold_after=4)
    j = JIVF(jmem.init_memory(jmem.MemoryConfig(**_cfg(C))), **kw)
    sh = IVFMemory(ShardedMemory(tmem.MemoryConfig(**_cfg(C)), shards=S,
                                 device="cpu"), **kw)
    protos = _protos(rng, P)
    _fill((j, sh), rng, _clustered(rng, protos, C))
    for q in _clustered(rng, protos, 8):
        _same_result(j.query_topk(jnp.asarray(q), 3), sh.query_topk(q, 3))
    assert sh.stats() == j.stats()
    assert sh.stats()["host_fetch_rows"] > 0


def test_sharded_backing_refusals():
    """Cluster c lives with shard c % S: clusters must divide by S, and a
    read probes at most clusters / S of them; grow is not supported over
    a sharded store (JAX's messages)."""
    store = ShardedMemory(tmem.MemoryConfig(**_cfg(64)), shards=4,
                          device="cpu")
    with pytest.raises(ValueError, match="not divisible by 4 shards"):
        IVFMemory(store, clusters=6, probes=1)
    with pytest.raises(ValueError, match="exceeds the 2 clusters per shard"):
        IVFMemory(store, clusters=8, probes=3)
    ivf = IVFMemory(store, clusters=8, probes=2)
    with pytest.raises(NotImplementedError, match="sharded backing"):
        ivf.grow(128)


@pytest.mark.parametrize("n", [0, 40, 100])
def test_debug_size_matches_jax(n):
    """The plane's ``debug_size`` is its backing store's: JAX's and the
    port's agree with ``size_fast`` below and past the ring's end."""
    rng = np.random.default_rng(n)
    j, t = _pair(64, clusters=4, probes=2)
    if n:
        _fill((j, t), rng, _clustered(rng, _protos(rng, 4), n))
    assert t.debug_size() == j.debug_size() == t.size_fast == min(n, 64)
    assert t.debug_size() == t.store.debug_size()


# ---------------------------------------------------------------------------
# Grow-in-place
# ---------------------------------------------------------------------------


def _stores_with(rng, C, n):
    """``tests/test_memory_ivf.py::_store_with`` for both packages."""
    js = jmem.init_memory(jmem.MemoryConfig(**_cfg(C)))
    ts = tmem.init_memory(tmem.MemoryConfig(**_cfg(C)), device="cpu")
    X = _clustered(rng, _protos(rng, 4), n)
    for i in range(0, n, 16):
        xb = X[i:i + 16]
        g = rng.integers(0, 50, size=(len(xb), G)).astype(np.int32)
        now = np.arange(i, i + len(xb), dtype=np.int32)
        js = jmem.add_batch(js, jnp.asarray(xb), jnp.asarray(g),
                            jnp.ones(len(xb), bool), jnp.zeros(len(xb), bool),
                            jnp.asarray(now))
        tmem.add_batch(ts, xb, g, np.ones(len(xb), bool),
                       np.zeros(len(xb), bool), now)
    return js, ts


def _same_store(js, ts):
    for f in ("emb", "mask", "guide", "hard", "added_at"):
        np.testing.assert_array_equal(np.asarray(getattr(js, f)),
                                      getattr(ts, f).numpy(), f)
    assert int(js.ptr) == ts.ptr


def test_grow_unwrapped_preserves_slots_and_ptr(rng):
    js, ts = _stores_with(rng, 64, 40)
    grown, remap = tmem.grow_memory(ts, 128)
    assert grown.capacity == 128 and grown.ptr == 40
    np.testing.assert_array_equal(remap.numpy(), np.arange(64))
    np.testing.assert_array_equal(ts.emb.numpy()[:40], grown.emb.numpy()[:40])
    assert not grown.valid.numpy()[40:].any()
    jg, jremap = jmem.grow_memory(js, 128)
    _same_store(jg, grown)


def test_grow_wrapped_linearizes_oldest_first(rng):
    C = 64
    js, ts = _stores_with(rng, C, 100)
    grown, remap = tmem.grow_memory(ts, 128)
    assert grown.ptr == C
    r = remap.numpy()
    for s in range(C):
        np.testing.assert_array_equal(ts.emb.numpy()[s],
                                      grown.emb.numpy()[r[s]])
    assert (np.diff(grown.added_at.numpy()[:C]) >= 0).all()
    jg, jremap = jmem.grow_memory(js, 128)
    _same_store(jg, grown)
    np.testing.assert_array_equal(np.asarray(jremap), r)
    again, remap2 = tmem.grow_memory(grown, 256)
    np.testing.assert_array_equal(remap2.numpy(), np.arange(128))


def test_grow_smaller_rejected(rng):
    _, ts = _stores_with(rng, 64, 10)
    with pytest.raises(ValueError):
        tmem.grow_memory(ts, 32)


def test_commit_stream_grow_rebases_and_refuses_pending(rng):
    class View:
        pass

    _, store = _stores_with(rng, 64, 40)
    stream = tmem.CommitStream()
    v = View()
    v.memory = store
    v._ptr_base = 40
    stream.subscribe(v)
    stream.buffer.stage_add(np.zeros(E, np.float32), np.zeros(G, np.int32),
                            True, False, 0)
    with pytest.raises(RuntimeError):
        stream.grow(store, 128)
    stream.buffer.take_ops()
    grown, remap = stream.grow(store, 128)
    assert v.memory is grown
    assert v._ptr_base == 40 - stream.commits
    buf = tmem.CommitBuffer()
    snap = grown.ptr
    for j in range(3):
        buf.stage_add(np.zeros(E, np.float32), np.zeros(G, np.int32), True,
                      False, j)
    buf.stage_soft_clear(5, 9, ptr_snapshot=snap)    # slot 5 < 40: safe
    buf.stage_soft_clear(41, 9, ptr_snapshot=snap)   # slot 41: evicted
    grown.hard[5] = True
    grown, n = buf.apply(grown)
    assert n == 3
    assert not grown.hard[5]


def test_ivf_grow_requeries_exact(rng):
    """Grow a wrapped-ring IVF store through the commit stream (its own
    ``grow``), keep writing, and read: exact on every valid entry and equal
    to the JAX plane after the same ops."""
    C = 64
    j, t = _pair(C, clusters=8, probes=8)
    protos = _protos(rng, 8)
    _fill((j, t), rng, _clustered(rng, protos, C + 24))   # wrapped ring
    j2, jremap = j.grow(2 * C)
    t2, tremap = tmem.CommitStream().grow(t, 2 * C)
    assert t2 is t and t.capacity == 2 * C
    np.testing.assert_array_equal(np.asarray(jremap), tremap.numpy())
    _fill((j, t), rng, _clustered(rng, protos, 32))
    _same_index(j, t)
    qs = _clustered(rng, protos, 4)
    _assert_matches_exact(t, qs[0], 4)
    _assert_matches_exact(t, qs, 4, batch=True)
    _reads_match_jax(j, t, qs, 4)


# ---------------------------------------------------------------------------
# Host-offload tiering
# ---------------------------------------------------------------------------


def test_offload_parity_and_traffic_split(rng):
    C, P = 128, 8
    kw = dict(clusters=P, probes=1)
    j_hot, hot = _pair(C, **kw)
    j_cold, cold = _pair(C, offload=True, cold_after=4, **kw)
    protos = _protos(rng, P)
    X = _clustered(rng, protos, C)
    _fill((j_hot, hot), np.random.default_rng(7), X)
    _fill((j_cold, cold), np.random.default_rng(7), X)
    qa = _clustered(rng, protos[:1], 1)[0]
    for _ in range(10):                 # cluster 0 stays hot, rest cool
        a, b = hot.query_topk(qa, 3), cold.query_topk(qa, 3)
        assert torch.equal(a.sim, b.sim)
        _same_result(j_cold.query_topk(jnp.asarray(qa), 3), b)
    qb = _clustered(rng, protos[5:6], 1)[0]
    a, b = hot.query_topk(qb, 3), cold.query_topk(qb, 3)
    assert torch.equal(a.sim, b.sim)
    valid = a.sim > -2.0
    assert torch.equal(a.meta[valid], b.meta[valid])
    _same_result(j_cold.query_topk(jnp.asarray(qb), 3), b)
    s = cold.stats()
    assert s["host_fetch_rows"] > 0 and s["device_fetch_rows"] > 0
    assert s["cold_clusters"] > 0
    assert s == j_cold.stats()


# ---------------------------------------------------------------------------
# Guard rails
# ---------------------------------------------------------------------------


def test_k_beyond_probe_budget_rejected(rng):
    store = tmem.init_memory(tmem.MemoryConfig(**_cfg(64)), device="cpu")
    ivf = IVFMemory(store, clusters=8, probes=1, bucket_cap=8)
    with pytest.raises(ValueError, match="candidate budget"):
        ivf.query_topk(_protos(rng, 1)[0], 9)


def test_config_validation():
    cfg = tmem.MemoryConfig(**_cfg(64))
    jcfg = jmem.MemoryConfig(**_cfg(64))
    bad = [dict(retrieval_clusters=-1), dict(retrieval_clusters=128),
           dict(retrieval_clusters=8, retrieval_probes=0),
           dict(retrieval_clusters=8, retrieval_probes=9),
           dict(retrieval_clusters=8, journal_path="/nonexistent/wal")]
    for kw in bad:
        with pytest.raises(ValueError):
            RARConfig(memory=cfg, **kw)
        with pytest.raises(ValueError):
            JConfig(memory=jcfg, **kw)
    with pytest.raises(TypeError):
        store = tmem.init_memory(cfg, device="cpu")
        IVFMemory(IVFMemory(store, clusters=4), clusters=4)


def test_double_wrap_is_identity():
    cfg = RARConfig(memory=tmem.MemoryConfig(**_cfg(64)),
                    retrieval_clusters=8, retrieval_probes=4)
    w1 = wrap_store(tmem.init_memory(cfg.memory, device="cpu"), cfg)
    assert isinstance(w1, IVFMemory)
    assert wrap_store(w1, cfg) is w1
    j = JRAR(None, None, lambda p: None, lambda e, k: False,
             JConfig(memory=jmem.MemoryConfig(**_cfg(64)),
                     retrieval_clusters=8, retrieval_probes=4))
    assert j.memory.bucket_cap == w1.bucket_cap


# ---------------------------------------------------------------------------
# The batch read: route + candidate read, chunked on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,guides_only", [(1, False), (4, True), (12, False)])
def test_batch_read_is_chunk_free_and_matches_jax(rng, k, guides_only):
    """The batch read gives the same sims and meta whatever the CPU chunk
    (the card takes the batch in one launch), the single reads' rows on
    every valid entry, and the JAX plane's result."""
    C, P = 128, 8
    j, t = _pair(C, clusters=P, probes=3)
    protos = _protos(rng, P)
    _fill((j, t), rng, _clustered(rng, protos, C + 40))     # wrapped ring
    qs = _clustered(rng, protos, 11)
    whole = t.query_topk_batch(qs, k, guides_only=guides_only, _chunk=11)
    for chunk in (1, 4, 8):
        got = t.query_topk_batch(qs, k, guides_only=guides_only,
                                 _chunk=chunk)
        assert torch.equal(got.sim, whole.sim)
        assert torch.equal(got.meta, whole.meta)
    for b in (0, 5):
        one = t.query_topk(qs[b], k, guides_only=guides_only)
        valid = one.sim > -2.0
        assert torch.equal(one.sim[valid], whole.sim[b][valid])
        assert torch.equal(one.meta[valid], whole.meta[b][valid])
    _same_result(j.query_topk_batch(jnp.asarray(qs), k,
                                    guides_only=guides_only), whole)
