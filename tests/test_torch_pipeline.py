"""The port's RAR controllers against the JAX package's: the same Outcome
stream, FM-call counts and store on every ``SCENARIOS`` case (rule-based
FakeTier tiers), and on the ``rar_throughput`` workload with the JAX
tiers' weights bridged into the port: 192 strong calls per 128 requests,
as ``BENCH_rar_throughput.json`` records."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from test_pipeline import MEM_FIELDS, SCENARIOS, make_stream
from test_rar_controller import FakeTier, greq, make_cfg, prompt, skill_emb

from repro.configs import rar_system as jrar
from repro.core.fm import FMTier as JTier
from repro.core.pipeline import MicrobatchRAR as JMicro
from repro.core.rar import RAR as JRAR
from repro.data.tasks import TaskSuite as JSuite
from repro.data.tokenizer import Vocab as JVocab
from repro.models import init_params as jinit
from repro_torch import bridge
from repro_torch.configs import rar_system as trar
from repro_torch.core import memory as tmem
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
    with pytest.raises(NotImplementedError):
        _serve(TMicro, dataclasses.replace(dcfg, shadow_mode="async"),
               stream, 4, _fake_tiers(), device="cpu")


# ---------------------------------------------------------------------------
# the rar_throughput workload on bridged random-weight tiers
# ---------------------------------------------------------------------------


def _workload(n: int):
    """``benchmarks/rar_throughput.py::_workload``: n distinct questions
    and deterministic hash embeddings."""
    vocab = TVocab(n_domains=3)
    prompts, greqs, embs = [], [], []
    i = 0
    while len(prompts) < n:
        d, s, x = i % 3, (i // 3) % 16, (i // 48) % 10
        i += 1
        prompts.append(np.asarray(vocab.question(d, s, x), np.int32))
        greqs.append(np.asarray(vocab.guide_request(d, s), np.int32))
        rng = np.random.default_rng(abs(hash((d, s, x))) % (2 ** 31))
        e = rng.normal(size=384).astype(np.float32)
        embs.append(e / np.linalg.norm(e))
    return prompts, greqs, np.stack(embs)


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
