"""The port's abstract inputs (``repro_torch.launch.specs``) and analytic
terms (``repro_torch.launch.analytic``) against the JAX package's: the
twin of ``tests/test_specs.py``.

For every (arch × input shape) pair of the registry the port's
``input_specs`` (fakes under a ``FakeTensorMode``) and JAX's
(``eval_shape``) agree in kind, ``grad_accum``, ``max_len`` and
``decode_window``, and leaf for leaf, by key path, in shape and dtype:
parameters, optimizer state, batch, tokens, position and cache.
``analytic_terms`` are equal bit for bit on both meshes' chip counts. The
reference's two properties hold on the port: long_500k runs
sub-quadratic attention, and the ring cache shrinks the analytic memory.
"""
import _torch_threads  # noqa: F401  (a worker's share of the cores)
import dataclasses

import jax
import pytest

from repro import configs as jconfigs
from repro.launch import specs as JS
from repro.launch.analytic import analytic_terms as janalytic
from repro_torch import configs
from repro_torch.launch import specs as TS
from repro_torch.launch.analytic import analytic_terms as tanalytic

ARCHS = configs.all_archs()
TREES = ("params", "opt_state", "batch", "cache", "tokens", "pos")


def _jax_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(getattr(k, "key", getattr(k, "name", None)) for k in p):
            (tuple(x.shape), str(x.dtype)) for p, x in flat}


def _port_leaves(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_leaves(v, path + (k,)))
        return out
    return {path: (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


def test_constants_are_the_reference_s():
    assert TS.INPUT_SHAPES == JS.INPUT_SHAPES
    assert TS.LONG_SKIP == JS.LONG_SKIP
    assert TS.LONG_DECODE_WINDOW == JS.LONG_DECODE_WINDOW
    assert TS.ACT_BUDGET_BYTES == JS.ACT_BUDGET_BYTES
    assert TS.DATA_SHARDS == JS.DATA_SHARDS
    assert all(TS.shape_kind(s) == JS.shape_kind(s) for s in JS.INPUT_SHAPES)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_jax_leaf_for_leaf(arch):
    tcfg, jcfg = configs.get(arch), jconfigs.get(arch)
    for shape, (seq, batch, kind) in JS.INPUT_SHAPES.items():
        assert TS.supported(tcfg, shape) == JS.supported(jcfg, shape)
        if not JS.supported(jcfg, shape):
            assert shape == "long_500k" and arch == "whisper-medium"
            continue
        j, t = JS.input_specs(jcfg, shape), TS.input_specs(tcfg, shape)
        assert t["kind"] == j["kind"] == kind
        for k in ("grad_accum", "max_len"):
            assert t.get(k) == j.get(k), (shape, k)
        assert t["cfg"].decode_window == j["cfg"].decode_window
        assert sorted(k for k in t if k in TREES) == \
            sorted(k for k in j if k in TREES)
        for k in TREES:
            if k in j:
                assert _port_leaves(t[k]) == _jax_leaves(j[k]), (shape, k)
        for n_chips in (256, 512):
            args = (kind, batch, seq, n_chips, j.get("grad_accum", 1))
            assert tanalytic(t["cfg"], *args) == janalytic(j["cfg"], *args)


def test_long_500k_forces_subquadratic():
    for arch in ARCHS:
        cfg = configs.get(arch)
        if not TS.supported(cfg, "long_500k"):
            continue
        c = TS.config_for_shape(cfg, "long_500k")
        if c.family in ("dense", "moe", "vlm", "hybrid"):
            assert c.decode_window > 0, arch


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_terms_positive(arch):
    cfg = configs.get(arch)
    for shape, (seq, batch, kind) in TS.INPUT_SHAPES.items():
        if not TS.supported(cfg, shape):
            continue
        t = tanalytic(TS.config_for_shape(cfg, shape), kind, batch, seq, 256)
        assert t["flops_per_device"] > 0
        assert t["hbm_bytes_per_device"] > 0


def test_ring_cache_shrinks_analytic_memory():
    cfg = configs.get("llama3-8b")
    base = dataclasses.replace(cfg, decode_window=4096)
    ring = dataclasses.replace(cfg, decode_window=4096, ring_cache=True)
    tb = tanalytic(base, "decode", 1, 524_288, 256)
    tr = tanalytic(ring, "decode", 1, 524_288, 256)
    assert tr["hbm_bytes_per_device"] < 0.7 * tb["hbm_bytes_per_device"]
