"""The port's write-ahead journal across packages and devices.

* The port recovers a WAL that the JAX package wrote to JAX's recovered
  store and manifest, and serves on from it to JAX's own resumed
  Outcomes. The runs are brownout-free and ``snapshot_every`` exceeds
  their epochs, so the directory holds only WAL frames of numpy and
  Python values (a JAX snapshot holds a pickled JAX treedef).
* A port journal holds host values only, so it recovers the same on
  ``device="cpu"`` whatever device wrote it: its frames name no tensor
  and no device, even when the staged ops carried tensors.
* An unbarriered async run, journaled, recovers to its final store.
"""
import _torch_threads  # noqa: F401  (a worker's share of the cores)
import copy
import os
import shutil

import numpy as np
import pytest
import torch
from test_pipeline import make_stream
from test_rar_controller import FakeTier, greq, make_cfg, prompt, skill_emb
from test_torch_pipeline import _plain, _port_cfg, _same_store
from test_torch_shadow import WAIT, build, serve_stream

from repro.core import memory as jmem
from repro.core.pipeline import MicrobatchRAR as JMicro
from repro.core.rar import RAR as JRAR
from repro_torch.core import memory as mem
from repro_torch.core.pipeline import MicrobatchRAR as TMicro
from repro_torch.core.rar import RAR as TRAR


def _tiers():
    return (FakeTier(known={0, 1}, name="weak"),
            FakeTier(known=range(10_000), can_guide=True, name="strong"))


def _serve(ctrl, holder, stream, batch):
    if batch == 0:
        outs = []
        for s, x in stream:
            holder["emb"] = skill_emb(s)
            outs.append(ctrl.process(prompt(s, x), greq(s), key=(s, x)))
        return outs
    return serve_stream(ctrl, stream, batch)


def _man(m):
    """A manifest without its deferred probes (objects of either package,
    empty in these brownout-free runs)."""
    return {k: v for k, v in m.items() if k != "deferred_probes"}


@pytest.mark.parametrize("batch,mode", [(0, "inline"), (4, "inline"),
                                        (4, "deferred")])
def test_port_recovers_a_jax_written_wal(tmp_path, batch, mode):
    """JAX journals a run; the port recovers that directory to JAX's
    store, epoch, entries and manifest; then both reopen it and serve the
    same second stream to the same Outcomes and stores."""
    path = str(tmp_path / "journal")
    kw = dict(journal_path=path, snapshot_every=1000)
    if batch:
        kw.update(shadow_mode=mode, shadow_flush_every=1)
    holder = {}
    jcls, tcls = (JRAR, TRAR) if batch == 0 else (JMicro, TMicro)
    j = jcls(*_tiers(), lambda p: holder["emb"], lambda e, k: False,
             make_cfg(**kw))
    _serve(j, holder, make_stream(), batch)
    j.close_shadow()
    assert not os.path.exists(os.path.join(path, "snapshot.npz"))
    jstate, jepoch, japplied, jman = jmem.MemoryJournal.recover(
        path, j.cfg.memory)
    tstate, tepoch, tapplied, tman = mem.MemoryJournal.recover(
        path, _port_cfg(j.cfg).memory, device="cpu")
    _same_store(jstate, tstate)
    assert (tepoch, tapplied) == (jepoch, japplied) and tepoch > 0
    assert _man(tman) == _man(jman) and tman["deferred_probes"] == []

    # both packages reopen the JAX directory and serve on alike (the JAX
    # reopen appends to the directory, so the port reopens a copy)
    tpath = str(tmp_path / "copy")
    shutil.copytree(path, tpath)
    stream2 = make_stream(seed=5)
    jh, th = {}, {}
    j2 = jcls(*_tiers(), lambda p: jh["emb"], lambda e, k: False,
              make_cfg(**kw))
    t2 = tcls(*_tiers(), lambda p: th["emb"], lambda e, k: False,
              _port_cfg(make_cfg(**dict(kw, journal_path=tpath))),
              device="cpu")
    assert (t2.now, t2.guides_generated) == (j2.now, j2.guides_generated)
    jouts = _serve(j2, jh, stream2, batch)
    touts = _serve(t2, th, stream2, batch)
    assert _plain(touts) == _plain(jouts)
    _same_store(j2.memory, t2.memory)
    assert t2.commit_stream.buffer.epoch == j2.commit_stream.buffer.epoch
    j2.close_shadow()
    t2.close_shadow()


@pytest.mark.parametrize("batch,mode", [(0, "inline"), (4, "inline"),
                                        (4, "deferred")])
def test_journal_ends_as_jax_does(tmp_path, batch, mode):
    """The port and JAX journal the same stream, each into its own
    directory, and close: the WAL's records match in kind and epoch to the
    last one (the sequential controller ends on a manifest-only
    checkpoint, the batched one on its last commit epoch), and each
    directory recovers to the same epoch, entries and manifest."""
    kw = dict(snapshot_every=1000)
    if batch:
        kw.update(shadow_mode=mode, shadow_flush_every=1)
    jcls, tcls = (JRAR, TRAR) if batch == 0 else (JMicro, TMicro)
    stream = make_stream()
    ends = []
    for name, cls in (("jax", jcls), ("torch", tcls)):
        path = str(tmp_path / name)
        cfg = make_cfg(journal_path=path, **kw)
        holder = {}
        if name == "jax":
            ctrl = cls(*_tiers(), lambda p: holder["emb"], lambda e, k: False,
                       cfg)
        else:
            ctrl = cls(*_tiers(), lambda p: holder["emb"], lambda e, k: False,
                       _port_cfg(cfg), device="cpu")
        _serve(ctrl, holder, stream, batch)
        ctrl.close_shadow()
        recs = list(mem.MemoryJournal._read_records(
            os.path.join(path, "wal.log")))
        got = (jmem.MemoryJournal.recover(path, cfg.memory) if name == "jax"
               else mem.MemoryJournal.recover(path, _port_cfg(cfg).memory,
                                              device="cpu"))
        ends.append(([(r["epoch"], bool(r.get("checkpoint"))) for r in recs],
                     got[1], got[2], _man(got[3])))
    assert ends[0] == ends[1]
    assert ends[0][0][-1][1] == (batch == 0)


def test_journal_frames_hold_host_values_only(tmp_path):
    """Ops staged with tensors (as a card run's drainer stages them) are
    journaled as numpy: the WAL pickles name no torch class, the snapshot
    loads without pickle, and recovery on the CPU gives the store."""
    cfg = mem.MemoryConfig(capacity=8, embed_dim=16, guide_len=4)
    path = str(tmp_path / "j")
    stream, state, _ = mem.open_journaled_stream(path, cfg,
                                                 snapshot_every=3,
                                                 device="cpu")
    assert state is None
    state = mem.init_memory(cfg, device="cpu")
    rng = np.random.default_rng(0)
    for epoch in range(1, 6):
        for k in range(3):
            e = torch.from_numpy(rng.normal(size=16).astype(np.float32))
            stream.buffer.stage_add(e / e.norm(),
                                    torch.arange(4, dtype=torch.int32),
                                    bool(k % 2), False, 3 * epoch + k)
        stream.buffer.stage_touch(epoch % 8, 3 * epoch, None)
        state = stream.apply(state)
    wal = open(os.path.join(path, "wal.log"), "rb").read()
    assert wal and b"torch" not in wal
    with np.load(os.path.join(path, "snapshot.npz"),
                 allow_pickle=False) as snap:
        assert "state/ptr" in snap.files
    rec, epoch, applied, _ = mem.MemoryJournal.recover(path, cfg,
                                                       device="cpu")
    _same_store(state, rec)
    assert (epoch, applied) == (5, 15)
    for recs in mem.MemoryJournal._read_records(os.path.join(path,
                                                             "wal.log")):
        assert all(isinstance(r[1], np.ndarray) for r in recs["records"])


def test_unbarriered_async_run_recovers_to_its_final_store(tmp_path):
    """Phase A2's invariant on the CPU: an async run at flush-every 3,
    journaled with snapshots, drains every item once; its final store is
    what the journal recovers, field for field, and its manifest the last
    one an epoch journaled."""
    path = str(tmp_path / "journal")
    ctrl, _ = build("torch", weak_known={0, 1}, shadow_mode="async",
                    shadow_flush_every=3, journal_path=path,
                    snapshot_every=3)
    ctrl.shadow.drain_delay = 0.002
    journaled, provider = [], ctrl.commit_stream.state_provider

    def journal_manifest():
        journaled.append(copy.deepcopy(provider()))
        return journaled[-1]
    ctrl.commit_stream.state_provider = journal_manifest
    outs = serve_stream(ctrl, make_stream(n_skills=12, reps=4), 3)
    ctrl.close_shadow(timeout=WAIT)
    q = ctrl.shadow
    assert q.items_enqueued == q.items_drained
    assert all(o.case != "shadow_pending" for o in outs)
    assert q.buffer.entries_applied == ctrl.memory.ptr
    assert ctrl.memory_occupancy == ctrl.memory.size_fast
    state, epoch, applied, man = mem.MemoryJournal.recover(
        path, ctrl.cfg.memory, device="cpu")
    _same_store(ctrl.memory, state)
    assert (epoch, applied) == (q.buffer.epoch, q.buffer.entries_applied)
    # the batched controller journals no closing checkpoint (as JAX's):
    # the manifest recovered is the one its last epoch journaled
    assert journaled and man == journaled[-1]
    assert man["now"] <= ctrl.now
