"""The port's placement rules (``repro_torch.models.sharding``) against the
JAX package's (``repro.models.sharding``): the twin of
``tests/test_sharding.py``.

Every case of the reference test runs through both packages' rules; a
seeded sweep of random shapes and preference lists follows. Then every
parameter leaf of every arch of the registry, in ``serve`` and ``train``
modes on the single-pod and multi-pod meshes, every optimizer-state leaf,
and every cache leaf of the decode shapes: the port's spec (over its
``FakeTensorMode`` trees) equals JAX's (over its ``eval_shape`` trees,
through JAX's own ``param_shardings`` / ``cache_shardings`` /
``batch_shardings`` with ``NamedSharding`` giving back the bare spec), key
path for key path. ``to_placements`` gives DTensor's placements of a spec.
"""
import _torch_threads  # noqa: F401  (a worker's share of the cores)
import dataclasses

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro.launch import specs as JS
from repro.models import sharding as jshd
from repro_torch import configs
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs as TS
from repro_torch.models import sharding as tshd


@dataclasses.dataclass
class FakeMesh:
    shape: dict


MESH = FakeMesh({"data": 16, "model": 16})
POD = FakeMesh({"pod": 2, "data": 16, "model": 16})
MESHES = {"16x16": MESH, "2x16x16": POD}


def both(shape, prefs, mesh=MESH, offset=0):
    """The JAX and the port spec, as tuples (the port's spec is one)."""
    j = jshd.spec_from_prefs(shape, prefs, mesh, offset=offset)
    t = tshd.spec_from_prefs(shape, prefs, mesh, offset=offset)
    assert isinstance(t, tuple)
    return tuple(j), t


# (shape, prefs, mesh, offset, the reference test's expected spec)
CASES = {
    "divisible": ((4096, 32, 128), [(1, "model")], MESH, 0,
                  (None, "model", None)),
    "nondivisible_falls_back": ((1536, 24, 64), [(1, "model"),
                                                 (0, "model")], MESH, 0,
                                ("model", None, None)),
    "nothing_divides": ((7, 3), [(0, "model"), (1, "model"), (0, "data")],
                        MESH, 0, (None, None)),
    "axis_used_once": ((64, 64), [(0, "model"), (1, "model")], MESH, 0,
                       ("model", None)),
    "dim_assigned_once": ((64, 32), [(0, "model"), (0, "data"),
                                     (1, "data")], MESH, 0,
                          ("model", "data")),
    "tuple_axis_multipod": ((256, 4096), [(0, ("pod", "data"))], POD, 0,
                            (("pod", "data"), None)),
    "tuple_axis_batch_1": ((1, 4096), [(0, ("pod", "data"))], POD, 0,
                           (None, None)),
    "stacked_offset": ((32, 4096, 32, 128), [(1, "model")], MESH, 1,
                       (None, None, "model", None)),
}

# (leaf, ndim, mode, shape, the reference test's expected spec)
PREF_CASES = {
    "train_fsdp": ("w_up", 2, "train", (4096, 14336), ("data", "model")),
    "serve_replicated_on_data": ("w_up", 2, "serve", (4096, 14336),
                                 (None, "model")),
    "moe_expert_parallel": ("w_gate", 3, "serve", (64, 2048, 1024),
                            ("model", None, None)),
    "moe_40_experts": ("w_gate", 3, "serve", (40, 1536, 512),
                       (None, None, "model")),
    "norm_scale": ("scale", 1, "train", (4096,), (None,)),
    "embed_vocab": ("embed", 2, "serve", (128256, 4096), ("model", None)),
    "embed_granite_vocab": ("embed", 2, "serve", (49155, 1536),
                            (None, None)),
}

LEAF_NAMES = ("embed", "unembed", "wq", "wk", "wv", "wo", "w_up", "w_gate",
              "w_down", "router", "in_proj", "out_proj", "w_gate_branch",
              "w_rnn_branch", "w_a", "w_i", "w", "scale", "b", "A_log",
              "D", "dt_bias", "lambda", "step")


@pytest.mark.parametrize("case", list(CASES))
def test_reference_cases(case):
    shape, prefs, mesh, offset, expected = CASES[case]
    j, t = both(shape, prefs, mesh, offset)
    assert t == j == expected


@pytest.mark.parametrize("case", list(PREF_CASES))
def test_reference_preference_cases(case):
    leaf, ndim, mode, shape, expected = PREF_CASES[case]
    jp = jshd._param_prefs(leaf, ndim, mode, MESH)
    tp = tshd._param_prefs(leaf, ndim, mode, MESH)
    assert tp == jp
    j, t = both(shape, tp)
    assert t == j == expected


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("mode", ["serve", "train"])
def test_param_prefs_equal_for_every_leaf_kind(mesh, mode):
    for name in LEAF_NAMES:
        for ndim in (1, 2, 3):
            assert tshd._param_prefs(name, ndim, mode, MESHES[mesh]) == \
                jshd._param_prefs(name, ndim, mode, MESHES[mesh]), name
    assert tshd.batch_axes(MESHES[mesh]) == jshd.batch_axes(MESHES[mesh])


@pytest.mark.parametrize("seed", range(4))
def test_random_shapes_and_preferences(seed):
    rng = np.random.default_rng(seed)
    sizes = (1, 2, 3, 7, 8, 16, 24, 32, 40, 48, 64, 256, 4096, 49155)
    axes = ("data", "model", "pod", ("pod", "data"), ("data", "model"))
    for _ in range(250):
        nd = int(rng.integers(1, 5))
        shape = tuple(int(rng.choice(sizes)) for _ in range(nd))
        prefs = [(int(rng.integers(0, nd + 1)),
                  axes[int(rng.integers(len(axes)))])
                 for _ in range(int(rng.integers(0, 6)))]
        offset = int(rng.integers(0, 2))
        for mesh in MESHES.values():
            j, t = both(shape, prefs, mesh, offset)
            assert t == j, (shape, prefs, offset, mesh)


def _jax_specs(tree):
    """{key path: spec as a tuple} of a JAX tree of PartitionSpecs."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return {tuple(getattr(k, "key", getattr(k, "name", None)) for k in p):
            tuple(s) for p, s in flat}


def _port_specs(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_specs(v, path + (k,)))
        return out
    return {path: tuple(tree)}


@pytest.fixture
def bare_named_sharding(monkeypatch):
    """JAX's tree rules with ``NamedSharding`` giving back the bare spec,
    so they run on a mesh description."""
    monkeypatch.setattr(jshd, "NamedSharding", lambda mesh, spec: spec)


@pytest.mark.parametrize("arch", configs.all_archs())
def test_every_param_and_cache_leaf_matches_jax(arch, bare_named_sharding):
    tcfg, jcfg = configs.get(arch), jconfigs.get(arch)
    jparams = JS.param_specs(jcfg)
    tparams = TS.param_specs(tcfg)
    jopt = JS.opt_specs(jparams)
    topt = TS.opt_specs(tparams)
    for mesh in MESHES.values():
        for mode in ("serve", "train"):
            want = _jax_specs(jshd.param_shardings(jparams, mesh, mode))
            got = _port_specs(tshd.param_shardings(tparams, mesh, mode))
            assert got == want, (arch, mesh, mode)
        want = _jax_specs(jshd.param_shardings(jopt, mesh, "train"))
        got = _port_specs(tshd.param_shardings(topt, mesh, "train"))
        assert got == want, (arch, mesh, "opt")
        for shape in ("decode_32k", "long_500k"):
            if not JS.supported(jcfg, shape):
                continue
            seq, batch, _ = JS.INPUT_SHAPES[shape]
            jc = JS.cache_specs(JS.config_for_shape(jcfg, shape), batch, seq)
            tc = TS.cache_specs(TS.config_for_shape(tcfg, shape), batch, seq)
            want = _jax_specs(jshd.cache_shardings(jc, mesh))
            got = _port_specs(tshd.cache_shardings(tc, mesh))
            assert got == want, (arch, mesh, shape)
            toks = {"tokens": np.zeros((batch, seq), np.int32)}
            assert _port_specs(tshd.batch_shardings(toks, mesh)) == \
                _jax_specs(jshd.batch_shardings(toks, mesh))


def test_mesh_descriptions():
    single, multi = (tmesh.make_production_mesh(),
                     tmesh.make_production_mesh(multi_pod=True))
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.size == 512
    assert tmesh.make_debug_mesh().shape == {"data": 2, "model": 2}
    assert tshd.replicated(single) == () == tuple(JP())


def test_to_placements_and_device_mesh_description():
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch import dryrun
    dryrun.start_fake_group(512)
    try:
        dm = tmesh.device_mesh(tmesh.make_production_mesh(multi_pod=True))
        assert tshd.describe(dm).shape == POD.shape
        assert tshd.to_placements(tshd.P(("pod", "data"), None, "model"),
                                  dm) == [Shard(0), Shard(0), Shard(2)]
        assert tshd.to_placements(tshd.P(None, "data"), dm) == \
            [Replicate(), Shard(1), Replicate()]
        spec = tshd.spec_from_prefs((256, 64), [(0, ("pod", "data")),
                                                (1, "model")],
                                    tshd.describe(dm))
        assert spec == (("pod", "data"), "model")
    finally:
        dist.destroy_process_group()
