"""The port's RAR controllers against the JAX package's: the same Outcome
stream, FM-call counts and store on every ``SCENARIOS`` case (rule-based
FakeTier tiers), with the exact store scan and with the IVF two-level
read, and on the ``rar_throughput`` workload with the JAX tiers' weights
bridged into the port: 192 strong calls per 128 requests, as
``BENCH_rar_throughput.json`` records. The top-1 reads ``query``/
``query_batch`` against JAX's on the same stores: indices and metadata
exact, sims within 2 ulp at 1.0."""
import _torch_threads  # noqa: F401  (a worker's share of the cores)
import dataclasses

import jax
import numpy as np
import pytest
import torch
from _torch_fabric_parts import rar_workload
from test_pipeline import MEM_FIELDS, SCENARIOS, make_stream
from test_rar_controller import FakeTier, greq, make_cfg, prompt, skill_emb

import jax.numpy as jnp

from repro.configs import rar_system as jrar
from repro.core import memory as jmem
from repro.core.fm import FMTier as JTier
from repro.core.pipeline import MicrobatchRAR as JMicro
from repro.core.rar import RAR as JRAR
from repro.data.tasks import TaskSuite as JSuite
from repro.data.tokenizer import Vocab as JVocab
from repro.models import init_params as jinit
from repro_torch import bridge
from repro_torch.configs import rar_system as trar
from repro_torch.core import memory as tmem
from repro_torch.core.memory_ivf import IVFMemory
from repro_torch.core.fm import FMTier as TTier
from repro_torch.core.pipeline import MicrobatchRAR as TMicro
from repro_torch.core.rar import RAR as TRAR
from repro_torch.core.rar import RARConfig as TConfig
from repro_torch.data.tasks import TaskSuite as TSuite
from repro_torch.data.tokenizer import Vocab as TVocab


def _port_cfg(jcfg) -> TConfig:
    """The port's RARConfig with every field of a JAX one."""
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    kw["memory"] = tmem.MemoryConfig(**dataclasses.asdict(jcfg.memory))
    return TConfig(**kw)


def _plain(outs):
    """Outcome streams as tuples (the two packages' Outcome classes)."""
    return [dataclasses.astuple(o) for o in outs]


def _host(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _same_store(a, b):
    """Every store field equal; a sharded store is compared as the
    single-device store it gathers into."""
    a, b = (getattr(x, "to_single_device", lambda x=x: x)() for x in (a, b))
    for f in MEM_FIELDS:
        np.testing.assert_array_equal(_host(getattr(a, f)),
                                      _host(getattr(b, f)), f)


def _fake_tiers(weak_known=(), weak_follows_guides=True):
    weak = FakeTier(known=weak_known, name="weak")
    strong = FakeTier(known=range(10_000), can_guide=True, name="strong")
    if not weak_follows_guides:
        calls = weak.engine

        def stubborn(prompts):
            calls.calls += len(prompts)
            return np.asarray([-1] * len(prompts))
        weak.answer_batch = stubborn
    return weak, strong


def _serve(cls, cfg, stream, batch, fakes, **kw):
    holder = {}
    ctrl = cls(*fakes, lambda p: holder["emb"], lambda e, k: False, cfg,
               **kw)
    outs = []
    if batch == 0:                              # sequential RAR.process
        for s, x in stream:
            holder["emb"] = skill_emb(s)
            outs.append(ctrl.process(prompt(s, x), greq(s), key=(s, x)))
        return ctrl, outs
    for start in range(0, len(stream), batch):
        chunk = stream[start:start + batch]
        outs += ctrl.process_batch(
            [prompt(s, x) for s, x in chunk], [greq(s) for s, _ in chunk],
            keys=chunk, embs=np.stack([skill_emb(s) for s, _ in chunk]))
    return ctrl, outs


@pytest.mark.parametrize("kw", SCENARIOS)
@pytest.mark.parametrize("batch", [0, 1, 4])
def test_scenarios_match_jax_controller(kw, batch):
    kw = dict(kw)
    tiers = {k: kw.pop(k) for k in ("weak_known", "weak_follows_guides")
             if k in kw}
    jcfg = make_cfg(**kw)
    stream = make_stream()
    jcls, tcls = (JRAR, TRAR) if batch == 0 else (JMicro, TMicro)
    j, jouts = _serve(jcls, jcfg, stream, batch, _fake_tiers(**tiers))
    t, touts = _serve(tcls, _port_cfg(jcfg), stream, batch,
                      _fake_tiers(**tiers), device="cpu")
    assert _plain(touts) == _plain(jouts)
    _same_store(j.memory, t.memory)
    assert (t.now, t.guides_from_memory, t.guides_generated) == \
        (j.now, j.guides_from_memory, j.guides_generated)
    assert t.weak.engine.calls == j.weak.engine.calls
    assert t.strong.engine.calls == j.strong.engine.calls
    assert t.memory_occupancy == j.memory_occupancy


@pytest.mark.parametrize("kw", SCENARIOS)
@pytest.mark.parametrize("batch", [0, 4])
def test_ivf_scenarios_match_jax_controller(kw, batch):
    """``retrieval_clusters`` 4 with 2 probes: an approximate read whose
    misses must be the JAX plane's misses too."""
    kw = dict(kw, retrieval_clusters=4, retrieval_probes=2)
    tiers = {k: kw.pop(k) for k in ("weak_known", "weak_follows_guides")
             if k in kw}
    jcfg = make_cfg(**kw)
    stream = make_stream()
    jcls, tcls = (JRAR, TRAR) if batch == 0 else (JMicro, TMicro)
    j, jouts = _serve(jcls, jcfg, stream, batch, _fake_tiers(**tiers))
    t, touts = _serve(tcls, _port_cfg(jcfg), stream, batch,
                      _fake_tiers(**tiers), device="cpu")
    assert isinstance(t.memory, IVFMemory)
    assert _plain(touts) == _plain(jouts)
    _same_store(j.memory.store, t.memory.store)
    assert t.memory.stats() == j.memory.stats()
    np.testing.assert_array_equal(t.memory._assign, j.memory._assign)
    np.testing.assert_array_equal(t.memory._members, j.memory._members)
    assert (t.now, t.guides_from_memory, t.guides_generated) == \
        (j.now, j.guides_from_memory, j.guides_generated)
    assert t.weak.engine.calls == j.weak.engine.calls
    assert t.strong.engine.calls == j.strong.engine.calls


def _top1_store(rng, C=64, E=16, G=8):
    """The same store in both packages: duplicate rows (exact ties), half
    of the entries with guides."""
    embs = rng.normal(size=(40, E)).astype(np.float32)
    embs /= np.linalg.norm(embs, axis=1, keepdims=True)
    embs[9] = embs[2]
    guides = rng.integers(0, 50, (40, G)).astype(np.int32)
    hg = rng.random(40) < 0.5
    hg[[2, 9]] = True
    hard = rng.random(40) < 0.3
    nows = np.arange(1, 41, dtype=np.int32)
    js = jmem.init_memory(jmem.MemoryConfig(capacity=C, embed_dim=E,
                                            guide_len=G))
    ts = tmem.init_memory(tmem.MemoryConfig(capacity=C, embed_dim=E,
                                            guide_len=G), device="cpu")
    js = jmem.add_batch(js, jnp.asarray(embs), jnp.asarray(guides),
                        jnp.asarray(hg), jnp.asarray(hard), jnp.asarray(nows))
    tmem.add_batch(ts, embs, guides, hg, hard, nows)
    return js, ts, embs


@pytest.mark.parametrize("guides_only", [False, True])
def test_query_and_query_batch_match_jax(guides_only):
    ulp2 = 2 * float(np.finfo(np.float32).eps)
    rng = np.random.default_rng(3)
    js, ts, embs = _top1_store(rng)
    qs = np.concatenate([embs[[2, 0, 9]], rng.normal(size=(4, 16)).astype(
        np.float32)])
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    jq = jmem.query_batch(js, jnp.asarray(qs),
                          guides_only=guides_only).device_get()
    tq = tmem.query_batch(ts, qs, guides_only=guides_only).device_get()
    np.testing.assert_array_equal(np.asarray(jq.meta), tq.meta)
    np.testing.assert_allclose(np.asarray(jq.sim), tq.sim, atol=ulp2,
                               rtol=0)
    assert tq.index[0] == 2                   # tie: the lower row
    for q in qs[:3]:
        jq1 = jmem.query(js, jnp.asarray(q),
                         guides_only=guides_only).device_get()
        tq1 = tmem.query(ts, q, guides_only=guides_only).device_get()
        np.testing.assert_array_equal(np.asarray(jq1.meta), tq1.meta)
        np.testing.assert_allclose(float(jq1.sim), float(tq1.sim),
                                   atol=ulp2, rtol=0)
    # an empty view: (-2.0, row 0) and row 0's metadata, on both sides
    je = jmem.init_memory(jmem.MemoryConfig(capacity=64, embed_dim=16,
                                            guide_len=8))
    te = tmem.init_memory(tmem.MemoryConfig(capacity=64, embed_dim=16,
                                            guide_len=8), device="cpu")
    jq = jmem.query_batch(je, jnp.asarray(qs[:2])).device_get()
    tq = tmem.query_batch(te, qs[:2]).device_get()
    np.testing.assert_array_equal(np.asarray(jq.meta), tq.meta)
    assert tq.sim.tolist() == [-2.0, -2.0] and tq.index.tolist() == [0, 0]


class _Top1RAR(TRAR):
    """The port's sequential controller reading through ``query``."""

    def _lookup(self, emb, guides_only=False):
        q = tmem.query(self.memory, emb, guides_only=guides_only)
        q = q.device_get()
        return tmem.TopKResult(sim=np.asarray(q.sim)[None],
                               meta=np.asarray(q.meta)[None])


class _Top1Micro(TMicro):
    """The port's batched controller reading through ``query_batch``."""

    def _lookup_batch(self, embs, guides_only=False):
        q = tmem.query_batch(self.memory, embs,
                             guides_only=guides_only).device_get()
        return tmem.TopKResult(sim=q.sim[:, None], meta=q.meta[:, None])


@pytest.mark.parametrize("kw", SCENARIOS[:4])
@pytest.mark.parametrize("batch", [0, 4])
def test_top1_path_controllers_match_jax(kw, batch):
    """The port's controllers on the top-1 reads serve the JAX
    controllers' Outcome streams (retrieval_k = 1, where top-1 and top-k
    are the same decision), with the exact scan and with the IVF plane
    (whose ``query``/``query_batch`` are its k = 1 reads)."""
    kw = dict(kw)
    tiers = {k: kw.pop(k) for k in ("weak_known", "weak_follows_guides")
             if k in kw}
    for ivf in ({}, dict(retrieval_clusters=4, retrieval_probes=2)):
        jcfg = make_cfg(**kw, **ivf)
        stream = make_stream()
        j, jouts = _serve(JRAR if batch == 0 else JMicro, jcfg, stream,
                          batch, _fake_tiers(**tiers))
        t, touts = _serve(_Top1RAR if batch == 0 else _Top1Micro,
                          _port_cfg(jcfg), stream, batch,
                          _fake_tiers(**tiers), device="cpu")
        assert _plain(touts) == _plain(jouts)
        _same_store(getattr(j.memory, "store", j.memory),
                    getattr(t.memory, "store", t.memory))


def test_task_suite_and_vocab_match_jax():
    """The port's copies of ``repro.data``: same skills, tokens, encodings
    and training/evaluation draws from the same seeds."""
    js, ts = JSuite(), TSuite()
    for f in ("alpha", "beta", "weak_known", "guide_train_skills"):
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f))
    assert ts.vocab.size == js.vocab.size
    for s, x in ((0, 3), (17, 39), (js.cfg.total_skills - 1, 0)):
        d = js.domain_of(s)
        assert ts.vocab.guide_request(d, s) == js.vocab.guide_request(d, s)
        for g in (None, js.guide(s)):
            np.testing.assert_array_equal(ts.encode(d, s, x, guide=g),
                                          js.encode(d, s, x, guide=g))
        np.testing.assert_array_equal(ts.encode_guide_gen(d, s),
                                      js.encode_guide_gen(d, s))
    for name in ("weak_train_batch", "strong_train_batch"):
        a = getattr(ts, name)(np.random.default_rng(1), 6)
        b = getattr(js, name)(np.random.default_rng(1), 6)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    for a, b in zip(ts.embedder_batch(np.random.default_rng(2), 5),
                    js.embedder_batch(np.random.default_rng(2), 5)):
        np.testing.assert_array_equal(a, b)
    assert ts.question_pool(1, 20, 3) == js.question_pool(1, 20, 3)


def test_deferred_flush_every_batch_equals_inline():
    stream = make_stream()
    jcfg = make_cfg()
    base, base_outs = _serve(TMicro, _port_cfg(jcfg), stream, 4,
                             _fake_tiers(weak_known={0, 1}), device="cpu")
    dcfg = dataclasses.replace(_port_cfg(jcfg), shadow_mode="deferred",
                               shadow_flush_every=1)
    d, d_outs = _serve(TMicro, dcfg, stream, 4,
                       _fake_tiers(weak_known={0, 1}), device="cpu")
    assert _plain(d_outs) == _plain(base_outs)
    _same_store(base.memory, d.memory)
    # async, held to the inline schedule by a barrier after every batch
    a = TMicro(*_fake_tiers(weak_known={0, 1}), lambda p: None,
               lambda e, k: False,
               dataclasses.replace(dcfg, shadow_mode="async"), device="cpu")
    a_outs = []
    for start in range(0, len(stream), 4):
        chunk = stream[start:start + 4]
        a_outs += a.process_batch(
            [prompt(s, x) for s, x in chunk], [greq(s) for s, _ in chunk],
            keys=chunk, embs=np.stack([skill_emb(s) for s, _ in chunk]))
        a.flush_shadow(timeout=60)
    a.close_shadow(timeout=60)
    assert _plain(a_outs) == _plain(base_outs)
    _same_store(base.memory, a.memory)


# ---------------------------------------------------------------------------
# the rar_throughput workload on bridged random-weight tiers
# ---------------------------------------------------------------------------


def _workload(n: int):
    """``benchmarks/rar_throughput.py::_workload``: n distinct questions
    and deterministic hash embeddings."""
    return rar_workload(n)


def _throughput_run(ctrl, prompts, greqs, embs, mb):
    outs = []
    for _ in range(2):                                 # N_PASSES
        for start in range(0, len(prompts), mb):
            sl = slice(start, start + mb)
            outs += ctrl.process_batch(
                prompts[sl], greqs[sl],
                keys=list(range(start, start + len(prompts[sl]))),
                embs=embs[sl])
    return outs


@pytest.fixture(scope="module")
def tiers():
    jw = jinit(jrar.WEAK, jax.random.PRNGKey(0))
    js = jinit(jrar.STRONG, jax.random.PRNGKey(1))
    tw = bridge.lm_params(trar.WEAK, jax.tree.map(np.asarray, jw), "cpu")
    ts = bridge.lm_params(trar.STRONG, jax.tree.map(np.asarray, js), "cpu")
    return (jw, js), (tw, ts)


@pytest.mark.parametrize("mb", [8, 32])
def test_rar_throughput_workload_matches_jax(tiers, mb):
    (jw, js), (tw, ts) = tiers
    prompts, greqs, embs = _workload(64)
    jv, tv = JVocab(n_domains=3), TVocab(n_domains=3)
    j = JMicro(JTier.create("weak", jrar.WEAK, jw, jv),
               JTier.create("strong", jrar.STRONG, js, jv),
               lambda p: None, lambda e, k: False, jrar.make_rar_config())
    t = TMicro(TTier.create("weak", trar.WEAK, tw, tv),
               TTier.create("strong", trar.STRONG, ts, tv),
               lambda p: None, lambda e, k: False, trar.make_rar_config(),
               device="cpu")
    jouts = _throughput_run(j, prompts, greqs, embs, mb)
    touts = _throughput_run(t, prompts, greqs, embs, mb)
    assert _plain(touts) == _plain(jouts)
    assert sum(o.strong_calls for o in touts) == 192
    _same_store(j.memory, t.memory)
    assert t.weak.engine.stats() == j.weak.engine.stats()
    assert t.strong.engine.stats() == j.strong.engine.stats()
