"""The port's kernel modules against the JAX package's: layout contract,
the plain PyTorch versions against the JAX oracles (and the Pallas top-k
body in interpret mode) and dispatch by device. The CUDA kernels against
their plain versions are ``tests/test_torch_cuda.py``.

Tolerances: top-k indices exact and sims within 1e-6 (both sides sum the
same f32 products in another order); attention f32 max |diff| 2e-5, as
``tests/test_kernels.py`` holds the Pallas kernels.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels import memory_topk as jmt
from repro.models import layers as jlayers
from repro_torch.kernels import ops
from repro_torch.kernels import memory_topk as tmt
from repro_torch.kernels import ref as tref

ATTN_TOL = 2e-5

# the JAX oracles, jitted: one compile per shape instead of one per op
topk_batch_ref = jax.jit(jref.memory_topk_batch_padded, static_argnums=(3, 4))
topk_ref = jax.jit(jref.memory_topk_padded, static_argnums=(3, 4))
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


def test_cpu_dispatch_never_launches_a_kernel(rng):
    ops.reset_launches()
    x = torch.from_numpy(rng.normal(size=(1, 4, 2, 32)).astype(np.float32))
    ops.flash_attention(x, x, x)
    ops.decode_attention(x[:, 0], x, x, 4)
    assert ops.launch_counts() == {"memory_topk": 0, "flash_attention": 0,
                                   "decode_attention": 0}
    with pytest.raises(ValueError):
        ops.flash_attention(x.to("meta"), x.to("meta"), x.to("meta"))
