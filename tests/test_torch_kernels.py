"""The port's kernel modules against the JAX package's: layout contract,
the plain PyTorch versions against the JAX oracles (and the Pallas top-k
body in interpret mode) and dispatch by device. The CUDA kernels against
their plain versions are ``tests/test_torch_cuda.py``.

Tolerances: store-read indices exact, and sims within 1e-6 where rows are
store-wide (E = 100 or 384: XLA's and PyTorch's CPU products sum the same
f32 products in another order, up to 6 ulp apart at 1.0) and within 2 ulp
at 1.0 on the 64-lane centroid planes; attention f32 max |diff| 2e-5, as
``tests/test_kernels.py`` holds the Pallas kernels.
"""
import _torch_threads  # noqa: F401  (a worker's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels import memory_ivf as jivf
from repro.kernels import memory_topk as jmt
from repro.models import layers as jlayers
from repro_torch.kernels import memory_ivf as tivf
from repro_torch.kernels import memory_topk as tmt
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

ATTN_TOL = 2e-5
ULP2 = 2 * float(np.finfo(np.float32).eps)     # 2 ulp at 1.0

# the JAX oracles, jitted: one compile per shape instead of one per op
topk_batch_ref = jax.jit(jref.memory_topk_batch_padded, static_argnums=(3, 4))
topk_ref = jax.jit(jref.memory_topk_padded, static_argnums=(3, 4))
top1_batch_ref = jax.jit(jref.memory_top1_batch_padded, static_argnums=(3,))
top1_ref = jax.jit(jref.memory_top1_padded, static_argnums=(3,))
route_batch_ref = jax.jit(jref.ivf_route_batch_padded, static_argnums=(3, 4))
route_ref = jax.jit(jref.ivf_route_padded, static_argnums=(3, 4))
flash_ref = jax.jit(jref.flash_attention,
                    static_argnames=("causal", "window"))
decode_ref = jax.jit(jref.decode_attention, static_argnames=("window",))


def _store(rng, C, E, density=0.6, dup=True, zeros=True):
    """Unit rows with duplicate rows (exact ties) and, optionally, rows
    orthogonal to every query (sims of +0.0 and -0.0)."""
    mem = rng.normal(size=(C, E)).astype(np.float32)
    mem /= np.linalg.norm(mem, axis=1, keepdims=True)
    if dup:
        mem[C // 2] = mem[C // 3]
        mem[C - 1] = mem[C // 3]
    if zeros:
        mem[1] = 0.0
        mem[2] = -0.0
    bits = ((rng.random(C) < density) * tmt.MASK_VALID
            + (rng.random(C) < 0.5) * tmt.MASK_GUIDE).astype(np.int32)
    return mem, bits


def _queries(rng, B, E):
    qs = rng.normal(size=(B, E)).astype(np.float32)
    return qs / np.linalg.norm(qs, axis=1, keepdims=True)


# ---------------------------------------------------------------------------
# layout contract
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c", [1, 7, 8, 64, 300, 1000, 1024, 4096, 5000])
def test_layout_contract_matches_jax(c):
    assert tmt.padded_rows(c) == jmt.padded_rows(c)
    assert tmt.padded_rows(c, 128) == jmt.padded_rows(c, 128)
    assert tmt.padded_lanes(c) == jmt.padded_lanes(c)
    cp = jmt.padded_rows(c)
    assert tmt._pick_block(cp, 1024) == jmt._pick_block(cp, 1024)
    assert tmt._pick_block(cp, 64) == jmt._pick_block(cp, 64)


def test_to_padded_layout_matches_jax(rng):
    mem = rng.normal(size=(300, 100)).astype(np.float32)
    bits = rng.integers(0, 4, 300).astype(np.int32)
    for mask in (bits, bits > 1):
        jm, jk = jmt.to_padded_layout(jnp.asarray(mem), jnp.asarray(mask),
                                      block_c=128)
        tm, tk = tmt.to_padded_layout(torch.from_numpy(mem),
                                      torch.from_numpy(mask), block_c=128)
        np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
        np.testing.assert_array_equal(np.asarray(jk), tk.numpy())


# ---------------------------------------------------------------------------
# top-k store read
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("C,E,B,k", [(64, 16, 1, 1), (300, 384, 8, 4),
                                     (1000, 384, 32, 8), (4096, 384, 8, 1),
                                     (136, 128, 5, 16)])
@pytest.mark.parametrize("guides_only", [False, True])
def test_topk_plain_matches_jax_oracle(rng, C, E, B, k, guides_only):
    mem, bits = _store(rng, C, E)
    memp, maskp = jmt.to_padded_layout(jnp.asarray(mem), jnp.asarray(bits))
    qs = _queries(rng, B, E)
    qs[0] = mem[C // 3]                      # hits the duplicated rows
    req = tmt.MASK_VALID | (tmt.MASK_GUIDE if guides_only else 0)
    js, ji = topk_batch_ref(memp, jnp.asarray(qs), maskp, k, req)
    ts, ti = ops.memory_topk_batch_padded(
        torch.from_numpy(np.array(memp)), torch.from_numpy(qs),
        torch.from_numpy(np.array(maskp)), k, req)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_allclose(np.asarray(js), ts.numpy(), atol=1e-6,
                               rtol=0)
    # single-query path
    js1, ji1 = topk_ref(memp, jnp.asarray(qs[0]), maskp, k, req)
    ts1, ti1 = ops.memory_topk_padded(
        torch.from_numpy(np.array(memp)), torch.from_numpy(qs[0]),
        torch.from_numpy(np.array(maskp)), k, req)
    np.testing.assert_array_equal(np.asarray(ji1), ti1.numpy())
    np.testing.assert_allclose(np.asarray(js1), ts1.numpy(), atol=1e-6,
                               rtol=0)


def test_topk_plain_matches_pallas_interpret(rng):
    """The Pallas kernel body itself (interpret mode) agrees too."""
    mem, bits = _store(rng, 256, 128)
    memp, maskp = jmt.to_padded_layout(jnp.asarray(mem), jnp.asarray(bits))
    qs = _queries(rng, 4, 128)
    js, ji = jmt.memory_topk_batch_padded_pallas(
        memp, jnp.asarray(qs), maskp, k=4, block_c=64, interpret=True)
    ts, ti = tmt.memory_topk_batch_padded_plain(
        torch.from_numpy(np.array(memp)), torch.from_numpy(qs),
        torch.from_numpy(np.array(maskp)), 4)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_allclose(np.asarray(js), ts.numpy(), atol=1e-6,
                               rtol=0)


def test_topk_select_tie_and_signed_zero_order():
    """±0.0 compare equal, so the lower row wins; exact ties go lowest row
    first; -2.0 masked rows fill after the view is exhausted."""
    sims = np.asarray([[0.5], [-0.0], [0.0], [0.5], [-2.0], [0.9]],
                      np.float32)
    rows = np.arange(6, dtype=np.int32)[:, None]
    js, jr = jref._topk_select(jnp.asarray(sims), jnp.asarray(rows), 6)
    ts, tr = tref._topk_select(torch.from_numpy(sims),
                               torch.from_numpy(rows), 6)
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    assert tr[:, 0].tolist() == [5, 0, 3, 1, 2, 4]


def test_topk_rejects_bad_k():
    memp = torch.zeros((64, 128))
    maskp = torch.zeros((64, 1), dtype=torch.int32)
    q = torch.zeros((1, 16))
    with pytest.raises(ValueError):
        ops.memory_topk_batch_padded(memp, q, maskp, 0)
    with pytest.raises(ValueError):
        ops.memory_topk_batch_padded(memp, q, maskp, 65)


# ---------------------------------------------------------------------------
# top-1 store read (memory.query / query_batch) and its compact wrappers
# ---------------------------------------------------------------------------


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_same(jpair, tpair, atol=1e-6):
    np.testing.assert_array_equal(np.asarray(jpair[1]), tpair[1].numpy())
    np.testing.assert_allclose(np.asarray(jpair[0]), tpair[0].numpy(),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("C,E,B", [(64, 16, 1), (300, 384, 8),
                                   (1000, 100, 32), (4096, 384, 5)])
@pytest.mark.parametrize("guides_only", [False, True])
def test_top1_plain_matches_jax_oracle(rng, C, E, B, guides_only):
    """Duplicate rows (exact ties: lowest row), rows of sim +0.0 and -0.0
    (the lower row), and a query orthogonal to every valid row."""
    mem, bits = _store(rng, C, E)
    memp, maskp = jmt.to_padded_layout(jnp.asarray(mem), jnp.asarray(bits))
    qs = _queries(rng, B, E)
    qs[0] = mem[C // 3]                      # hits the duplicated rows
    req = tmt.MASK_VALID | (tmt.MASK_GUIDE if guides_only else 0)
    _assert_same(top1_batch_ref(memp, jnp.asarray(qs), maskp, req),
                 ops.memory_top1_batch_padded(_t(memp), _t(qs), _t(maskp),
                                              req))
    for b in range(min(B, 3)):
        _assert_same(top1_ref(memp, jnp.asarray(qs[b]), maskp, req),
                     ops.memory_top1_padded(_t(memp), _t(qs[b]), _t(maskp),
                                            req))
    valid = (bits & req) == req
    _assert_same(jref.memory_top1_batch(jnp.asarray(mem), jnp.asarray(qs),
                                        jnp.asarray(valid)),
                 ops.memory_top1_batch(_t(mem), _t(qs), _t(valid)))
    _assert_same(jref.memory_top1(jnp.asarray(mem), jnp.asarray(qs[0]),
                                  jnp.asarray(valid)),
                 tref.memory_top1(_t(mem), _t(qs[0]), _t(valid)))


@pytest.mark.parametrize("C,E", [(1000, 100), (3000, 384), (64, 16)])
def test_plain_reads_break_ties_by_row(C, E):
    """Rows equal to the query's best row, the last row of the store among
    them, give bitwise-equal sims, so every plain read picks the lowest
    row first. (A CPU matrix-vector product sums a matrix's last rows in
    another order and put row C-1 ahead of its equal rows.)"""
    r = C // 3
    ties = [r, C // 2, C - 1]
    for seed in range(4):
        rng = np.random.default_rng(seed)
        mem = _queries(rng, C, E)
        mem[C // 2] = mem[C - 1] = mem[r]
        memp, maskp = tmt.to_padded_layout(torch.from_numpy(mem),
                                           torch.ones(C, dtype=torch.bool))
        qs = torch.from_numpy(_queries(rng, 8, E))
        qs[0] = torch.from_numpy(mem[r])
        for B in (1, 2, 8):
            s, i = tmt.memory_top1_batch_padded_plain(memp, qs[:B], maskp)
            assert int(i[0]) == r
            s, i = tmt.memory_topk_batch_padded_plain(memp, qs[:B], maskp, 3)
            assert i[0].tolist() == ties and len(set(s[0].tolist())) == 1
        assert int(tmt.memory_top1_padded_plain(memp, qs[0], maskp)[1]) == r
        s, i = tmt.memory_topk_padded_plain(memp, qs[0], maskp, 3)
        assert i.tolist() == ties and len(set(s.tolist())) == 1
        s, i = tivf.ivf_route_padded_plain(memp, qs[0], maskp, 3)
        assert i.tolist() == ties


def test_top1_signed_zero_tie_and_empty_view():
    """Sims of -0.0 then +0.0 tie: the lower row wins; an empty view gives
    (-2.0, 0), as the Pallas kernel's seeded running best does."""
    mem = np.zeros((16, 128), np.float32)
    mem[3, 0], mem[5, 0] = -1e-30, 1e-30     # q . row = -0.0 and +0.0
    mem[9, 1] = -1.0
    q = np.zeros((2, 128), np.float32)
    q[:, 0] = 1e-30
    mask = np.zeros((16, 1), np.int32)
    mask[[3, 5, 9], 0] = tmt.MASK_VALID
    for m in (mask, np.zeros_like(mask)):
        want = top1_batch_ref(jnp.asarray(mem), jnp.asarray(q),
                              jnp.asarray(m), 1)
        pallas = jmt.memory_top1_batch_padded_pallas(
            jnp.asarray(mem), jnp.asarray(q), jnp.asarray(m), block_c=8,
            interpret=True)
        got = ops.memory_top1_batch_padded(_t(mem), _t(q), _t(m))
        _assert_same(want, got)
        _assert_same(pallas, got)
    assert got[0].tolist() == [-2.0, -2.0] and got[1].tolist() == [0, 0]
    got = ops.memory_top1_padded(_t(mem), _t(q[0]), _t(mask))
    assert int(got[1]) == 3


def test_top1_plain_matches_pallas_interpret(rng):
    """The Pallas kernel bodies themselves (interpret mode), guide view."""
    mem, bits = _store(rng, 256, 128)
    memp, maskp = jmt.to_padded_layout(jnp.asarray(mem), jnp.asarray(bits))
    qs = _queries(rng, 3, 128)
    qs[0] = mem[256 // 3]
    req = tmt.MASK_VALID | tmt.MASK_GUIDE
    got = ops.memory_top1_batch_padded(_t(memp), _t(qs), _t(maskp), req)
    _assert_same(jmt.memory_top1_batch_padded_pallas(
        memp, jnp.asarray(qs), maskp, required=req, block_c=64,
        interpret=True), got)
    _assert_same(jmt.memory_top1_padded_pallas(
        memp, jnp.asarray(qs[0]), maskp, required=req, block_c=64,
        interpret=True),
        ops.memory_top1_padded(_t(memp), _t(qs[0]), _t(maskp), req))


# ---------------------------------------------------------------------------
# IVF centroid route
# ---------------------------------------------------------------------------


def _plane(rng, P, E, density):
    cent = _queries(rng, P, E)
    cent[P // 2] = cent[0]                   # tied centroids
    bits = (rng.random(P) < density).astype(np.int32) * tmt.MASK_VALID
    return jmt.to_padded_layout(jnp.asarray(cent), jnp.asarray(bits))


@pytest.mark.parametrize("P,n_probe,B", [(9, 1, 1), (16, 4, 3),
                                         (33, 8, 16), (100, 64, 8),
                                         (1024, 4, 32)])
@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
def test_route_plain_matches_jax_oracle(rng, P, n_probe, B, density):
    """Unseeded centroids score -2.0 and fill after the seeded ones in row
    order (all of them at density 0)."""
    centp, cmaskp = _plane(rng, P, 64, density)
    qs = _queries(rng, B, 64)
    qs[0] = np.asarray(centp)[0, :64]
    _assert_same(route_batch_ref(centp, jnp.asarray(qs), cmaskp, n_probe, 1),
                 ops.ivf_route_batch_padded(_t(centp), _t(qs), _t(cmaskp),
                                            n_probe), ULP2)
    _assert_same(route_ref(centp, jnp.asarray(qs[0]), cmaskp, n_probe, 1),
                 ops.ivf_route_padded(_t(centp), _t(qs[0]), _t(cmaskp),
                                      n_probe), ULP2)
    _assert_same(route_batch_ref(centp, jnp.asarray(qs), cmaskp, n_probe, 1),
                 tref.ivf_route_batch_padded(_t(centp), _t(qs), _t(cmaskp),
                                             n_probe), ULP2)


def test_route_plain_matches_pallas_interpret(rng):
    centp, cmaskp = _plane(rng, 100, 64, 0.7)
    qs = _queries(rng, 3, 64)
    _assert_same(jivf.ivf_route_batch_padded_pallas(
        centp, jnp.asarray(qs), cmaskp, n_probe=8, block_p=64,
        interpret=True),
        tivf.ivf_route_batch_padded_plain(_t(centp), _t(qs), _t(cmaskp), 8),
        ULP2)
    _assert_same(jivf.ivf_route_padded_pallas(
        centp, jnp.asarray(qs[0]), cmaskp, n_probe=8, block_p=64,
        interpret=True),
        tivf.ivf_route_padded_plain(_t(centp), _t(qs[0]), _t(cmaskp), 8),
        ULP2)


@pytest.mark.parametrize("P", [9, 100, 1024, 3000])
def test_route_rejects_n_probe_where_pallas_does(P):
    """``n_probe`` must be in [1, kernel block]: the block is the largest
    row-tile multiple <= 1024 dividing the padded plane. The Pallas wrapper
    raises before its kernel runs, so only the rejected counts call it."""
    Pp = jmt.padded_rows(P)
    cent = jnp.zeros((Pp, 128), jnp.float32)
    cmask = jnp.zeros((Pp, 1), jnp.int32)
    q = jnp.zeros((1, 16), jnp.float32)
    block = jmt._pick_block(Pp, jmt.DEFAULT_BLOCK_C)
    for n_probe in (0, block + 1):
        with pytest.raises(ValueError):
            jivf.ivf_route_batch_padded_pallas(cent, q, cmask,
                                               n_probe=n_probe,
                                               interpret=True)
        with pytest.raises(ValueError):
            ops.ivf_route_batch_padded(_t(cent), _t(q), _t(cmask), n_probe)
        with pytest.raises(ValueError):
            ops.ivf_route_padded(_t(cent), _t(q[0]), _t(cmask), n_probe)
    s, c = ops.ivf_route_batch_padded(_t(cent), _t(q), _t(cmask), block)
    assert c.shape == (1, block) and c[0].tolist() == list(range(block))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("Sq,Sk", [(1, 1), (7, 7), (17, 17), (26, 26),
                                   (130, 130), (5, 40)])
@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("H,KV", [(4, 4), (8, 2)])
def test_flash_plain_matches_jax_oracle(rng, Sq, Sk, window, H, KV):
    q = rng.normal(size=(2, Sq, H, 32)).astype(np.float32)
    k = rng.normal(size=(2, Sk, KV, 32)).astype(np.float32)
    v = rng.normal(size=(2, Sk, KV, 32)).astype(np.float32)
    for causal in (True, False):
        want = flash_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal, window=window)
        got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=causal,
                                  window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATTN_TOL, rtol=0)


def test_flash_kv_len_matches_layers_attention(rng):
    """kv_len masks keys as the embedder's ``kpos = -1e7`` does in
    ``layers.attention`` (bidirectional, PAD keys out)."""
    B, S, H, hd = 3, 16, 4, 32
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    lens = np.asarray([16, 9, 1], np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    kpos = np.where(pos < lens[:, None], pos, -10_000_000)
    want = jlayers.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             q_positions=jnp.asarray(pos),
                             k_positions=jnp.asarray(kpos), causal=False,
                             window=0)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=False,
                              kv_len=torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL,
                               rtol=0)


@pytest.mark.parametrize("M,window", [(1, 0), (33, 0), (300, 0),
                                      (300, 64)])
@pytest.mark.parametrize("H,KV", [(6, 6), (32, 8)])
def test_decode_plain_matches_jax_oracle(rng, M, window, H, KV):
    B, hd = 3, 32
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, M, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, M, KV, hd)).astype(np.float32)
    lens = np.asarray([M, max(1, M // 2), 1], np.int32)
    for cl in (np.int32(max(1, M - 1)), lens):
        want = decode_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(cl), window=window)
        got = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), torch.tensor(cl),
                                   window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATTN_TOL, rtol=0)


def test_decode_plain_cache_len_zero_matches_jax_oracle(rng):
    """With an empty cache every key is masked: the plain version follows
    the JAX oracle and averages all M rows (softmax of equal NEG_INF
    scores). The card kernel follows ``decode_attention_pallas`` there
    (no block loaded: zeros), a disagreement inside the reference."""
    q = rng.normal(size=(2, 8, 32)).astype(np.float32)
    k = rng.normal(size=(2, 5, 2, 32)).astype(np.float32)
    v = rng.normal(size=(2, 5, 2, 32)).astype(np.float32)
    for cl in (np.int32(0), np.asarray([0, 3], np.int32)):
        want = decode_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(cl))
        got = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), torch.tensor(cl))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATTN_TOL, rtol=0)
    np.testing.assert_allclose(got[0].numpy(), np.broadcast_to(
        v[0].mean(0).repeat(4, axis=0), (8, 32)), atol=ATTN_TOL, rtol=0)


def test_cpu_dispatch_never_launches_a_kernel(rng):
    ops.reset_launches()
    x = torch.from_numpy(rng.normal(size=(1, 4, 2, 32)).astype(np.float32))
    ops.flash_attention(x, x, x)
    ops.decode_attention(x[:, 0], x, x, 4)
    memp = torch.zeros((8, 128))
    maskp = torch.ones((8, 1), dtype=torch.int32)
    q = torch.ones((2, 16))
    ops.memory_topk_batch_padded(memp, q, maskp, 2)
    ops.memory_top1_batch_padded(memp, q, maskp)
    ops.memory_top1_padded(memp, q[0], maskp)
    s, c = ops.ivf_route_batch_padded(memp, q, maskp, 2)
    ops.ivf_route_padded(memp, q[0], maskp, 2)
    ids = torch.arange(8, dtype=torch.int32)
    ops.ivf_scan_batch(s, c, ids, ids.view(8, 1), ids, memp, maskp,
                       torch.zeros(8, dtype=torch.bool), ids, ids.view(8, 1),
                       q, 2, 1)
    offsets = torch.tensor([0, 3, 8], dtype=torch.int32)
    a = torch.ones((8, 16))
    w = torch.ones((2, 16, 16))
    ops.moe_down(ops.moe_gate_up(a, w, w, offsets), w, offsets)
    ops.moe_combine(a, torch.arange(8), torch.ones((4, 2)))
    assert ops.launch_counts() == {"memory_topk": 0, "memory_top1": 0,
                                   "ivf_route": 0, "ivf_scan": 0,
                                   "flash_attention": 0,
                                   "decode_attention": 0, "moe_grouped": 0,
                                   "moe_combine": 0}
    with pytest.raises(ValueError):
        ops.flash_attention(x.to("meta"), x.to("meta"), x.to("meta"))
