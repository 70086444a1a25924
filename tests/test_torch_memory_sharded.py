"""The port's sharded guide store against the single-device store: the
twin of ``tests/test_memory_sharded.py``, on the CPU.

JAX's ``ShardedMemory`` is no oracle here: under JAX 0.9 its
``to_single_device`` raises and its multi-device self-test is 1 ulp off
(a reference fault). So the port's ``ShardedMemory`` at S shards is held
to the port's own ``MemoryState`` after the same commits, bit for bit on
every read (ties included), and through it to JAX's ``MemoryState``
(indices and meta exact, sims within 2 ulp); JAX's 1-shard store is
compared where it works, its top-k reads.
"""
import jax.numpy as jnp
import numpy as np
import pytest
from test_rar_controller import greq, make_cfg, prompt, skill_emb
from test_torch_pipeline import _fake_tiers, _plain, _port_cfg, _same_store

from repro.core import memory as jmem
from repro.core.memory_sharded import ShardedMemory as JSharded
from repro.core.pipeline import MicrobatchRAR as JMicro
from repro_torch.core import ShardedMemory
from repro_torch.core import memory as tmem
from repro_torch.core.memory_sharded import parity_selftest
from repro_torch.core.pipeline import MicrobatchRAR as TMicro

C, E, G = 64, 16, 4
CFG = dict(capacity=C, embed_dim=E, guide_len=G)
ULP2 = 2 * float(np.finfo(np.float32).eps)


def _units(rng, n):
    v = rng.normal(size=(n, E)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _stream(rng, S):
    """Commits that straddle shard boundaries and wrap the ring, with a
    row repeated in two shards and inside one: (embs, guides, has_guide,
    hard, now) a commit."""
    cs = C // S
    out = []
    for i, K in enumerate((min(cs + 3, C), 5, C // 2 + 1, 1, C - 7, 9)):
        embs = _units(rng, K)
        if K > cs:
            embs[cs] = embs[0]         # the same row in the next shard
        if K > 3:
            embs[2] = embs[0]          # ... and again in this one
        out.append((embs, rng.integers(0, 50, size=(K, G)).astype(np.int32),
                    rng.random(K) < 0.5, rng.random(K) < 0.3,
                    np.arange(i * C, i * C + K, dtype=np.int32)))
    return out


def _queries(rng, embs):
    qs = _units(rng, 8)
    qs[0] = embs[0]                    # an exact stored row, duplicated
    return qs


def _reads(store, qs, k, g):
    """Every read of a store: query, query_batch, query_topk,
    query_topk_batch, as host results."""
    return [tmem.query(store, qs[0], guides_only=g).device_get(),
            tmem.query_batch(store, qs, guides_only=g).device_get(),
            tmem.query_topk(store, qs[0], k, guides_only=g).device_get(),
            tmem.query_topk_batch(store, qs, k, guides_only=g).device_get()]


def _bits_equal(a, b):
    assert np.array_equal(np.atleast_1d(a.sim).view(np.int32),
                          np.atleast_1d(b.sim).view(np.int32))
    np.testing.assert_array_equal(a.meta, b.meta)


@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_sharded_reads_bit_identical_to_memory_state(S):
    """For S in (1, 2, 4, 8) the same commits into ShardedMemory and into
    MemoryState give bit-identical reads after the commit that straddles
    a shard boundary, the one that wraps the ring and the last: all four
    read paths, k in (1, 4, Cs), both mask views; then equal stores
    (``to_single_device``), flag updates included."""
    rng = np.random.default_rng(S)
    single = tmem.init_memory(tmem.MemoryConfig(**CFG), device="cpu")
    sharded = ShardedMemory(tmem.MemoryConfig(**CFG), shards=S,
                            device="cpu")
    for i, (embs, *rest) in enumerate(_stream(rng, S)):
        tmem.add_batch(single, embs, *rest)
        tmem.add_batch(sharded, embs, *rest)
        qs = _queries(rng, embs)
        if i not in (0, 4, 5):
            continue
        for k in sorted({1, 4, sharded.cs}):
            for g in (False, True):
                for a, b in zip(_reads(single, qs, k, g),
                                _reads(sharded, qs, k, g)):
                    _bits_equal(a, b)
    assert sharded.ptr > C and sharded.size_fast == single.size_fast == C
    for st in (single, sharded):
        tmem.mark_soft(st, np.asarray([0, 5]))
        tmem.touch(st, np.asarray([2, 40]), np.asarray([99, 7]))
    _same_store(single, sharded)
    assert sharded.debug_size() == int(single.valid.sum())
    assert np.array_equal(sharded.valid.numpy(), single.valid.numpy())
    assert np.array_equal(sharded.has_guide.numpy(),
                          single.has_guide.numpy())


@pytest.mark.parametrize("S", [2, 4])
def test_sharded_reads_match_jax_memory_state(S):
    """The port's sharded reads against JAX's single-device store after
    the same commits: indices and meta exact, sims within 2 ulp (the
    reference's own read paths differ by an ulp); and against JAX's
    1-shard ShardedMemory's top-k reads, which work under JAX 0.9."""
    rng = np.random.default_rng(10 + S)
    js = jmem.init_memory(jmem.MemoryConfig(**CFG))
    j1 = JSharded(jmem.MemoryConfig(**CFG))
    sharded = ShardedMemory(tmem.MemoryConfig(**CFG), shards=S,
                            device="cpu")
    for embs, guides, hg, hd, now in _stream(rng, S)[:4]:
        args = tuple(jnp.asarray(x) for x in (embs, guides, hg, hd, now))
        js = jmem.add_batch(js, *args)
        j1.add_batch(*args)
        tmem.add_batch(sharded, embs, guides, hg, hd, now)
    qs = _queries(rng, embs)
    for g in (False, True):
        want = [jmem.query(js, jnp.asarray(qs[0]), guides_only=g),
                jmem.query_batch(js, jnp.asarray(qs), guides_only=g),
                jmem.query_topk(js, jnp.asarray(qs[0]), 4, guides_only=g),
                jmem.query_topk_batch(js, jnp.asarray(qs), 4,
                                      guides_only=g)]
        for a, b in zip(want, _reads(sharded, qs, 4, g)):
            np.testing.assert_array_equal(np.asarray(a.meta), b.meta)
            np.testing.assert_allclose(np.asarray(a.sim), b.sim, atol=ULP2,
                                       rtol=0)
        a = j1.query_topk_batch(jnp.asarray(qs), 4, guides_only=g)
        b = sharded.query_topk_batch(qs, 4, guides_only=g).device_get()
        np.testing.assert_array_equal(np.asarray(a.meta), b.meta)
        np.testing.assert_allclose(np.asarray(a.sim), b.sim, atol=ULP2,
                                   rtol=0)


def test_sharded_wraparound_and_overflow():
    """test_memory_sharded.py::test_sharded_wraparound_and_overflow at 4
    shards."""
    rng = np.random.default_rng(0)
    cfg = tmem.MemoryConfig(capacity=32, embed_dim=16, guide_len=4)
    sharded = ShardedMemory(cfg, shards=4, device="cpu")
    for i in range(cfg.capacity + 5):
        sharded.add(_units(rng, 1)[0], np.zeros(4, np.int32), False, False,
                    np.int32(i))
    assert sharded.size_fast == cfg.capacity
    assert sharded.ptr == cfg.capacity + 5
    K = cfg.capacity + 1
    with pytest.raises(ValueError, match="exceeds memory capacity 32"):
        sharded.add_batch(np.zeros((K, 16), np.float32),
                          np.zeros((K, 4), np.int32), np.zeros(K, bool),
                          np.zeros(K, bool), np.zeros(K, np.int32))


def test_capacity_must_divide_shards():
    """test_memory_sharded.py::test_capacity_must_divide_shards: the
    multi-shard branch (logical shards need no second device)."""
    cfg = tmem.MemoryConfig(capacity=31, embed_dim=16, guide_len=4)
    assert ShardedMemory(cfg, device="cpu").shards == 1
    with pytest.raises(ValueError, match="not divisible by 4 shards"):
        ShardedMemory(cfg, shards=4, device="cpu")


def test_sharded_topk_rejects_k_past_shard_rows():
    """test_memory_sharded.py::test_sharded_topk_rejects_k_past_shard_rows
    at 4 shards (and the capacity bound at 1)."""
    cfg = tmem.MemoryConfig(capacity=32, embed_dim=16, guide_len=4)
    q = np.zeros(16, np.float32)
    with pytest.raises(ValueError, match="exceeds the 8 logical rows"):
        ShardedMemory(cfg, shards=4, device="cpu").query_topk(q, 9)
    with pytest.raises(ValueError):
        ShardedMemory(cfg, device="cpu").query_topk(q, 33)


def test_parity_selftest_in_process():
    """The module's self-test at 4 logical shards, in this process (JAX's
    subprocess test with forced host devices is a reference fault)."""
    report = parity_selftest(shards=4, n_commits=4, device="cpu")
    assert report["shards"] == 4 and report["bit_identical"] is True
    assert report["checks"] > 0
    assert report["topk_checked"] == [1, 2, 4, 8]
    assert report["deferred_commit_epochs"] > 0


@pytest.mark.parametrize("S", [2, 4])
def test_controller_serves_against_sharded_store(S):
    """test_memory_sharded.py::test_controller_serves_against_sharded_store
    (a reference fault under JAX 0.9): the port's MicrobatchRAR on an
    injected ShardedMemory gives the Outcomes, FM calls and store of the
    port on its MemoryState, and of JAX's MicrobatchRAR on its own."""
    stream = [(s, x) for x in range(3) for s in range(5)]
    jcfg = make_cfg()
    tcfg = _port_cfg(jcfg)
    ctrls = [JMicro(*_fake_tiers(), lambda p: None, lambda e, k: False,
                    jcfg),
             TMicro(*_fake_tiers(), lambda p: None, lambda e, k: False,
                    tcfg, device="cpu"),
             TMicro(*_fake_tiers(), lambda p: None, lambda e, k: False,
                    tcfg, memory=ShardedMemory(tcfg.memory, shards=S,
                                               device="cpu"),
                    device="cpu")]
    outs = []
    for ctrl in ctrls:
        got = []
        for start in range(0, len(stream), 4):
            chunk = stream[start:start + 4]
            got += ctrl.process_batch(
                [prompt(s, x) for s, x in chunk],
                [greq(s) for s, _ in chunk], keys=chunk,
                embs=np.stack([skill_emb(s) for s, _ in chunk]))
        outs.append(_plain(got))
    jc, plain, shard = ctrls
    assert isinstance(shard.memory, ShardedMemory)
    assert outs[2] == outs[1] == outs[0]
    for tier in ("weak", "strong"):
        calls = [getattr(c, tier).engine.calls for c in ctrls]
        assert calls[2] == calls[1] == calls[0]
    _same_store(plain.memory, shard.memory)
    _same_store(jc.memory, shard.memory)
    assert shard.memory_occupancy == jc.memory_occupancy
