"""The arithmetic of the two attention kernels' designs, emulated in plain
torch on the CPU (the kernels themselves run only on the card,
``tests/test_torch_cuda.py``):

* split-KV decode (``csrc/decode_attention.cu``): each chunk of a row's
  valid cache range gives a partial (m, l, acc) by the tile-wise online
  softmax; the last CTA merges them, each weighted by exp(m - m_max). Held
  against ``decode_attention_plain`` and the JAX oracle
  ``repro.kernels.ref.decode_attention`` at f32 within 1e-6, for the chunks
  the wrapper picks (``split``) and for chunks laid on absolute positions,
  where the window masks some chunks entirely;
* the bf16 tensor-core flash path (``csrc/flash_attention.cu``): 64-key
  tiles, f32 online softmax, and P rounded to bf16 as the A operand of P V
  (one bf16 term, and the hi + lo pair the kernel uses), at llama3-8b's,
  recurrentgemma-2b's (hd 256) and phi-3-vision's (hd 96) head shapes,
  against ``flash_attention_plain``: the error budget of the rounding
  against the 2e-2 bf16 tolerance. The decode cases include those widths
  and whisper's 1500-frame cross read.
"""
import jax
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels.flash_attention import NEG_INF, flash_attention_plain

DECODE_TOL = 1e-6
BF16_TOL = 2e-2
H100_SMS = 132

decode_ref = jax.jit(jref.decode_attention, static_argnames=("window",))


def _normal(rng, shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


# ---------------------------------------------------------------------------
# split-KV decode
# ---------------------------------------------------------------------------


def _partial(qg, k, v, valid, tk):
    """One chunk's (m, l, acc) as the kernel builds it: tiles of ``tk``
    keys, online softmax from m = -inf. qg (KV, G, hd) scaled; k, v (n, KV,
    hd); valid (n,) bool (masked keys score NEG_INF)."""
    KV, G, hd = qg.shape
    m = torch.full((KV, G), -float("inf"))
    l = torch.zeros((KV, G))
    acc = torch.zeros((KV, G, hd))
    for t0 in range(0, k.shape[0], tk):
        s = torch.einsum("kgh,nkh->kgn", qg, k[t0:t0 + tk])
        s = torch.where(valid[None, None, t0:t0 + tk], s,
                        torch.tensor(NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("kgn,nkh->kgh", p,
                                                   v[t0:t0 + tk])
        m = m_new
    return m, l, acc


def split_kv_decode(q, k, v, cache_len, *, window=0, chunk, absolute=False,
                    tk=32):
    """Split-KV decode: q (B, H, hd), k/v (B, M, KV, hd) f32. Chunks tile
    the valid range [lo, hi) from lo (the kernel's layout) or, with
    ``absolute``, all M positions from 0, masking keys outside [lo, hi)
    (so the window can mask a whole chunk). Returns (out, chunks used)."""
    B, H, hd = q.shape
    M, KV = k.shape[1], k.shape[2]
    G = H // KV
    out = torch.zeros((B, KV, G, hd))
    used = []
    for b in range(B):
        cl = int(cache_len[b])
        hi = min(M, cl)
        lo = max(0, cl - window) if window > 0 else 0
        starts = (range(0, M, chunk) if absolute else
                  range(lo, hi, chunk))
        qg = q[b].reshape(KV, G, hd) * hd ** -0.5
        parts = []
        for c0 in starts:
            c1 = min(M if absolute else hi, c0 + chunk)
            pos = torch.arange(c0, c1)
            valid = (pos >= lo) & (pos < hi)
            parts.append(_partial(qg, k[b, c0:c1], v[b, c0:c1], valid, tk))
        used.append(len(parts))
        if not parts:
            continue          # an empty cache: zeros, as the kernel
        m = torch.stack([p[0] for p in parts])
        m_max = m.amax(0)
        w = torch.exp(m - m_max)
        lsum = (w * torch.stack([p[1] for p in parts])).sum(0)
        acc = (w[..., None] * torch.stack([p[2] for p in parts])).sum(0)
        out[b] = acc / torch.clamp(lsum, min=1e-37)[..., None]
    return out.reshape(B, H, hd), used


DECODE_CASES = [
    # B, M, KV, G, hd, window, cache_len (per row), chunk
    (1, 308, 8, 4, 128, 0, [301], None),          # llama3-8b, cache 301
    (1, 1032, 8, 4, 128, 0, [1024], None),
    (1, 308, 8, 4, 128, 64, [301], None),
    (8, 132, 6, 1, 32, 0, [131] * 8, None),        # rar-strong
    (8, 132, 4, 1, 32, 0, [1, 5, 17, 33, 64, 100, 131, 132], None),
    (3, 200, 2, 6, 64, 0, [200, 77, 3], None),
    (2, 512, 1, 6, 32, 100, [512, 260], 16),       # 7 chunks, window
    (2, 64, 4, 4, 32, 0, [64, 40], 64),            # one chunk
    (2, 90, 2, 4, 32, 0, [90, 45], 45),            # two chunks
    (1, 512, 2, 4, 64, 0, [512], 16),              # 32 chunks
    (4, 300, 2, 1, 32, 37, [300, 37, 36, 250], 16),
    (1, 139, 1, 10, 256, 2048, [131], None),       # recurrentgemma-2b
    (1, 2109, 1, 10, 256, 2048, [2101], None),     # past its window
    (1, 282, 32, 1, 96, 0, [274], None),           # phi-3-vision
    (2, 1500, 16, 1, 64, 0, [1500, 1500], None),   # whisper's cross read
]


@pytest.mark.parametrize("B,M,KV,G,hd,window,cls,chunk", DECODE_CASES)
def test_split_kv_decode_matches_plain_and_oracle(B, M, KV, G, hd, window,
                                                  cls, chunk):
    rng = np.random.default_rng(M * 7 + G)
    q = _normal(rng, (B, KV * G, hd))
    k = _normal(rng, (B, M, KV, hd))
    v = _normal(rng, (B, M, KV, hd))
    cl = torch.tensor(cls, dtype=torch.int32)
    if chunk is None:
        chunk, n = da.split(M, window, B * KV, H100_SMS)
        assert n * chunk >= (min(M, window) if window else M)
    got, used = split_kv_decode(q, k, v, cl, window=window, chunk=chunk)
    assert max(used) == -(-(min(M, window) if window else max(cls)) // chunk)
    want = da.decode_attention_plain(q, k, v, cl, window=window)
    oracle = np.asarray(decode_ref(q.numpy(), k.numpy(), v.numpy(),
                                   cl.numpy(), window=window))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=DECODE_TOL,
                               rtol=0)
    np.testing.assert_allclose(got.numpy(), oracle, atol=DECODE_TOL, rtol=0)


@pytest.mark.parametrize("n_chunks", [1, 2, 3, 5, 8, 17, 32])
@pytest.mark.parametrize("G", [1, 4, 6])
def test_split_kv_chunk_counts(n_chunks, G):
    """The combine at 1 to 32 chunks a row, with cache_len per row: the
    first row fills all n_chunks, the others fewer."""
    B, KV, hd, chunk = 3, 2, 32, 16
    M = n_chunks * chunk
    rng = np.random.default_rng(n_chunks * 10 + G)
    q = _normal(rng, (B, KV * G, hd))
    k = _normal(rng, (B, M, KV, hd))
    v = _normal(rng, (B, M, KV, hd))
    cl = torch.tensor([M, max(1, M - chunk - 3), 1], dtype=torch.int32)
    got, used = split_kv_decode(q, k, v, cl, chunk=chunk)
    assert used == [n_chunks, max(1, -(-(M - chunk - 3) // chunk)), 1]
    want = da.decode_attention_plain(q, k, v, cl)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=DECODE_TOL,
                               rtol=0)
    oracle = np.asarray(decode_ref(q.numpy(), k.numpy(), v.numpy(),
                                   cl.numpy()))
    np.testing.assert_allclose(got.numpy(), oracle, atol=DECODE_TOL, rtol=0)


@pytest.mark.parametrize("window,cls", [(20, [200, 97]), (64, [128, 65]),
                                        (1, [50, 1])])
@pytest.mark.parametrize("G", [1, 4, 6])
def test_split_kv_masked_chunk_weighs_zero(window, cls, G):
    """Chunks on absolute positions: the window masks whole chunks (their
    m is NEG_INF, l counts their keys), and exp(m - m_max) weighs them
    exactly 0; a window across a chunk boundary splits its keys over two
    partials."""
    B, M, KV, hd, chunk = 2, 200, 2, 32, 32
    rng = np.random.default_rng(window * 10 + G)
    q = _normal(rng, (B, KV * G, hd))
    k = _normal(rng, (B, M, KV, hd))
    v = _normal(rng, (B, M, KV, hd))
    cl = torch.tensor(cls, dtype=torch.int32)
    got, used = split_kv_decode(q, k, v, cl, window=window, chunk=chunk,
                                absolute=True)
    assert used == [-(-M // chunk)] * B        # masked chunks included
    want = da.decode_attention_plain(q, k, v, cl, window=window)
    oracle = np.asarray(decode_ref(q.numpy(), k.numpy(), v.numpy(),
                                   cl.numpy(), window=window))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=DECODE_TOL,
                               rtol=0)
    np.testing.assert_allclose(got.numpy(), oracle, atol=DECODE_TOL, rtol=0)


def test_split_kv_empty_cache_gives_zeros():
    """cache_len = 0: no chunk holds a key and the output is 0 (the
    kernel's documented choice, after decode_attention_pallas)."""
    rng = np.random.default_rng(0)
    q = _normal(rng, (2, 8, 32))
    k = _normal(rng, (2, 40, 2, 32))
    got, used = split_kv_decode(q, k, k, torch.tensor([0, 40]), chunk=16)
    assert used == [0, 3]
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    np.testing.assert_allclose(
        got[1].numpy(), da.decode_attention_plain(q, k, k, 40)[1].numpy(),
        atol=DECODE_TOL, rtol=0)


@pytest.mark.parametrize("M,window,B,KV", [
    (308, 0, 1, 8), (1032, 0, 1, 8), (4104, 0, 1, 8), (308, 64, 1, 8),
    (132, 0, 8, 6), (3, 0, 8, 4), (308, 0, 8, 8), (100000, 0, 1, 8),
    (8200, 0, 1, 8)])
def test_split_fills_the_card_and_covers_the_range(M, window, B, KV):
    chunk, n = da.split(M, window, B * KV, H100_SMS)
    span = min(M, window) if window else M
    assert da.MIN_CHUNK <= chunk and chunk % da.MIN_CHUNK == 0
    assert chunk <= da.MAX_CHUNK or (chunk - da.MIN_CHUNK) * da.MAX_CHUNKS < span
    assert (n - 1) * chunk < span <= n * chunk and n <= da.MAX_CHUNKS
    # as many CTAs as the card has SMs, unless the chunks would go under
    # the minimum or the range is too short for them
    if span >= da.MIN_CHUNK * -(-H100_SMS // (B * KV)):
        assert B * KV * n >= H100_SMS
    if (M, window, B) == (308, 0, 1):
        assert (chunk, n) == (32, 10)   # llama3-8b B=1, cache 301: 80 CTAs


# ---------------------------------------------------------------------------
# bf16 tensor-core flash: tiles, f32 softmax, P rounded for P V
# ---------------------------------------------------------------------------


def flash_tiles_bf16(q, k, v, *, causal=True, window=0, kv_len=None,
                     split_p=True, bk=64):
    """The bf16 flash path's arithmetic in f32: S = (q . k) * scale from
    bf16 operands, 64-key tiles with the online softmax from m = NEG_INF,
    P rounded to bf16 (and, with ``split_p``, its remainder as a second
    bf16 term) for P V. Skipped tiles are not emulated: they add exactly 0
    to every row with a valid key. Returns f32 (B, Sq, H, hd)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    s_all = torch.einsum("bqkgh,bskh->bkgqs",
                         q.float().reshape(B, Sq, KV, G, hd),
                         k.float()) * hd ** -0.5
    qpos = torch.arange(Sq)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk)[None, :]
    diff = qpos - kpos
    mask = torch.ones((1, Sq, Sk), dtype=torch.bool)
    if causal:
        mask = mask & (diff >= 0)
    if window > 0:
        mask = mask & (diff < window)
    if kv_len is not None:
        mask = mask & (kpos[None] < kv_len.view(B, 1, 1))
    m = torch.full((B, KV, G, Sq), NEG_INF)
    l = torch.zeros((B, KV, G, Sq))
    acc = torch.zeros((B, KV, G, Sq, hd))
    vf = v.float()
    for k0 in range(0, Sk, bk):
        s = torch.where(mask[:, None, None, :, k0:k0 + bk],
                        s_all[..., k0:k0 + bk], torch.tensor(NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        hi = p.to(torch.bfloat16).float()
        pv = hi + ((p - hi).to(torch.bfloat16).float() if split_p else 0.0)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqs,bskh->bkgqh", pv, vf[:, k0:k0 + bk])
        m = m_new
    out = acc / torch.clamp(l, min=1e-37)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)


@pytest.mark.parametrize("split_p,f32_budget", [(True, 1e-4), (False, 1e-2)])
@pytest.mark.parametrize("Sq,window,kv_len,H,KV,hd", [
    (300, 0, None, 32, 8, 128), (300, 64, None, 32, 8, 128),
    (130, 0, None, 32, 8, 128), (17, 0, None, 32, 8, 128),
    (300, 0, 250, 32, 8, 128),
    (130, 0, None, 10, 1, 256), (300, 100, None, 10, 1, 256),
    (273, 0, None, 32, 32, 96)])
def test_flash_bf16_p_error_budget(Sq, window, kv_len, H, KV, hd, split_p,
                                   f32_budget):
    """llama3-8b heads (H=32, KV=8, hd=128, bf16 inputs), recurrentgemma-
    2b's (10 over 1 kv head of 256) and phi-3-vision's (32 of 96): the
    tile-wise f32 softmax with P rounded for P V stays within the bf16
    tolerance of the plain version. Before the output's own bf16 rounding
    the kernel's f32 result is within ~1e-5 of the plain f32 math with P
    as hi + lo (the kernel's choice), and within ~4e-3 with one bf16
    term."""
    rng = np.random.default_rng(Sq + window + hd)
    q = _normal(rng, (1, Sq, H, hd)).to(torch.bfloat16)
    k = _normal(rng, (1, Sq, KV, hd)).to(torch.bfloat16)
    v = _normal(rng, (1, Sq, KV, hd)).to(torch.bfloat16)
    kl = None if kv_len is None else torch.tensor([kv_len], dtype=torch.int32)
    got = flash_tiles_bf16(q, k, v, window=window, kv_len=kl,
                           split_p=split_p)
    want = flash_attention_plain(q, k, v, window=window, kv_len=kl)
    err = (got.to(torch.bfloat16).float() - want.float()).abs().max().item()
    assert err <= BF16_TOL
    want32 = flash_attention_plain(q.float(), k.float(), v.float(),
                                   window=window, kv_len=kl)
    assert (got - want32).abs().max().item() <= f32_budget
