"""Each CUDA kernel against its plain PyTorch version on the card, at the
shapes of the RAR tiers, the embedder and llama3-8b. Needs a CUDA card
and no JAX; skips without a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: top-k, top-1, route and IVF candidate-read rows exact and
sims within 1e-6 (the store-scan edge, route and candidate-read cases:
sims exact, since the plain versions sum in the card's order); attention
2e-5 in f32 and 2e-2 (about one bf16 ulp at |x| < 4) in bf16.

The store cases cover the scan's tiling edges (C of 136, 1000, 4096 and
65536 rows, B of 1 to 64, k up to 128), ties across tiles, CTAs and a
persistent CTA's tiles, empty views, the workspaces kept between calls,
and the compact top-1 store read as it is. The route cases cover planes
of 64, 1000 and 1024 centroids at B of 1 to 33 and n_probe of 1, 4 and
64; the IVF candidate-read cases stale members, empty bucket slots, dead
probes, k beyond the kept candidates and the guides-only view.

The attention cases cover the split-KV decode (several chunks, a window
across a chunk boundary, cache_len per row, cache_len = 0, repeated calls
on one workspace) and the flash paths (ragged Sq, kv_len, Sq < Sk), at
hd 32/64/128 in f32 and bf16.
"""
import functools

import numpy as np
import pytest
import torch

import _ivf_cases as ivf_cases
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import memory_ivf as tivf
from repro_torch.kernels import memory_topk as tmt
from repro_torch.kernels import ops


def _store(rng, C, E):
    mem = rng.normal(size=(C, E)).astype(np.float32)
    mem /= np.linalg.norm(mem, axis=1, keepdims=True)
    mem[C // 2] = mem[C - 1] = mem[C // 3]
    mem[1], mem[2] = 0.0, -0.0
    bits = ((rng.random(C) < 0.6) * tmt.MASK_VALID
            + (rng.random(C) < 0.5) * tmt.MASK_GUIDE).astype(np.int32)
    return mem, bits


def _queries(rng, B, E):
    qs = rng.normal(size=(B, E)).astype(np.float32)
    return qs / np.linalg.norm(qs, axis=1, keepdims=True)


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("C,B,k", [(4096, 32, 1), (4096, 8, 8),
                                   (136, 5, 16)])
def test_cuda_topk_matches_plain(rng, cuda, C, B, k):
    mem, bits = _store(rng, C, 384)
    memp, maskp = tmt.to_padded_layout(torch.from_numpy(mem),
                                       torch.from_numpy(bits))
    qs = torch.from_numpy(_queries(rng, B, 384))
    ps, pi = tmt.memory_topk_batch_padded_plain(memp, qs, maskp, k)
    cs, ci = tmt.memory_topk_batch_padded_cuda(memp.to(cuda), qs.to(cuda),
                                               maskp.to(cuda), k)
    np.testing.assert_array_equal(ci.cpu().numpy(), pi.numpy())
    np.testing.assert_allclose(cs.cpu().numpy(), ps.numpy(), atol=1e-6,
                               rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("C,B", [(4096, 32), (65536, 8), (136, 1),
                                 (1000, 33)])
@pytest.mark.parametrize("required", [tmt.MASK_VALID,
                                      tmt.MASK_VALID | tmt.MASK_GUIDE])
def test_cuda_top1_matches_plain(rng, cuda, C, B, required):
    mem, bits = _store(rng, C, 384)
    memp, maskp = tmt.to_padded_layout(torch.from_numpy(mem),
                                       torch.from_numpy(bits))
    qs = _queries(rng, B, 384)
    qs[0] = mem[C // 3]                      # ties across row blocks
    qs = torch.from_numpy(qs)
    ps, pi = tmt.memory_top1_batch_padded_plain(memp, qs, maskp, required)
    cs, ci = tmt.memory_top1_batch_padded_cuda(memp.to(cuda), qs.to(cuda),
                                               maskp.to(cuda), required)
    np.testing.assert_array_equal(ci.cpu().numpy(), pi.numpy())
    np.testing.assert_allclose(cs.cpu().numpy(), ps.numpy(), atol=1e-6,
                               rtol=0)
    # an empty view: (-2.0, 0), as the Pallas kernel's seeded best
    zero = torch.zeros_like(maskp).to(cuda)
    cs, ci = tmt.memory_top1_batch_padded_cuda(memp.to(cuda), qs.to(cuda),
                                               zero, required)
    assert (cs == -2.0).all() and (ci == 0).all()


# -- the store scan's tiling edges (csrc/store_scan.cuh) ---------------------


@functools.lru_cache(maxsize=None)
def _scan_store(C):
    """A padded store whose ties cross tiles and CTAs: rows C//3, C//2 and
    C-1 are equal, and past the 132 CTAs' first tiles (rows 33792 on) row
    33799 repeats row 7, a tie inside one persistent CTA's two tiles. Rows
    1 and 2 are +0.0 and -0.0."""
    rng = np.random.default_rng(C)
    mem, bits = _store(rng, C, 384)
    if C > 132 * 256 + 7:
        mem[132 * 256 + 7] = mem[7]
        bits[132 * 256 + 7] = bits[7] = tmt.MASK_VALID
    return tmt.to_padded_layout(torch.from_numpy(mem), torch.from_numpy(bits))


def _scan_queries(C, B):
    memp = _scan_store(C)[0]
    qs = _queries(np.random.default_rng(C + B), B, 384)
    qs[0] = memp[C // 3, :384].numpy()
    if B > 1:
        qs[1] = memp[7, :384].numpy()
    return torch.from_numpy(qs)


def _same(got, want):
    """Rows and sims exactly the plain version's: both sum every dot in the
    scan core's order, so even rows 1 ulp apart come in the same order."""
    np.testing.assert_array_equal(got[1].cpu().numpy(), want[1].cpu().numpy())
    np.testing.assert_array_equal(got[0].cpu().numpy(), want[0].cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 4, 16, 128])
@pytest.mark.parametrize("B", [1, 8, 32, 33, 64])
@pytest.mark.parametrize("C", [136, 1000, 4096, 65536])
def test_cuda_topk_scan_edges(cuda, C, B, k):
    memp, maskp = (t.to(cuda) for t in _scan_store(C))
    qs = _scan_queries(C, B).to(cuda)
    _same(tmt.memory_topk_batch_padded_cuda(memp, qs, maskp, k),
          tmt.memory_topk_batch_padded_plain(memp, qs, maskp, k))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8, 32, 33, 64])
@pytest.mark.parametrize("C", [136, 1000, 4096, 65536])
def test_cuda_top1_scan_edges(cuda, C, B):
    memp, maskp = (t.to(cuda) for t in _scan_store(C))
    qs = _scan_queries(C, B).to(cuda)
    for req in (tmt.MASK_VALID, tmt.MASK_VALID | tmt.MASK_GUIDE):
        _same(tmt.memory_top1_batch_padded_cuda(memp, qs, maskp, req),
              tmt.memory_top1_batch_padded_plain(memp, qs, maskp, req))


@pytest.mark.cuda
@pytest.mark.parametrize("C", [136, 4096, 65536])
def test_cuda_scan_empty_view(cuda, C):
    """No row carries the required bits: every row scores -2.0, so top-k
    gives rows 0..k-1 and top-1 (-2.0, 0)."""
    memp = _scan_store(C)[0].to(cuda)
    maskp = torch.zeros((memp.shape[0], 1), dtype=torch.int32, device=cuda)
    qs = _scan_queries(C, 8).to(cuda)
    for k in (1, 4, 16):
        s, r = tmt.memory_topk_batch_padded_cuda(memp, qs, maskp, k)
        assert (s == -2.0).all()
        assert torch.equal(r.cpu(), torch.arange(k, dtype=torch.int32)
                           .expand(8, k))
    s, r = tmt.memory_top1_batch_padded_cuda(memp, qs, maskp)
    assert (s == -2.0).all() and (r == 0).all()


@pytest.mark.cuda
def test_cuda_scan_workspaces_between_calls(cuda):
    """The wrappers keep one state (keys + ticket) per kernel, stream and B,
    and top-k's tile lists per shape; each launch must leave them ready for
    the next: repeated calls of one shape, shapes changing between calls,
    and top-1 and top-k reads interleaved on one stream."""
    calls = [(4096, 32, 1), (4096, 32, 1), (4096, 32, 4), (65536, 32, 1),
             (4096, 8, 8), (4096, 32, 1), (136, 32, 16), (65536, 32, 4),
             (4096, 32, 4), (65536, 1, 1), (65536, 1, 4)]
    for C, B, k in calls * 2:
        memp, maskp = (t.to(cuda) for t in _scan_store(C))
        qs = _scan_queries(C, B).to(cuda)
        _same(tmt.memory_top1_batch_padded_cuda(memp, qs, maskp),
              tmt.memory_top1_batch_padded_plain(memp, qs, maskp))
        _same(tmt.memory_topk_batch_padded_cuda(memp, qs, maskp, k),
              tmt.memory_topk_batch_padded_plain(memp, qs, maskp, k))
        _same(tmt.memory_top1_batch_padded_cuda(memp, qs[:1], maskp,
                                                tmt.MASK_GUIDE),
              tmt.memory_top1_batch_padded_plain(memp, qs[:1], maskp,
                                                 tmt.MASK_GUIDE))


@pytest.mark.cuda
@pytest.mark.parametrize("C,E", [(4096, 384), (1000, 384), (77, 128),
                                 (300, 100)])
def test_cuda_compact_top1_reads_the_store_as_is(cuda, C, E):
    """ops.memory_top1*: a contiguous f32 (C, E) store with E % 4 == 0 goes
    to the kernel uncopied, any C; rows and sims as the plain version."""
    rng = np.random.default_rng(C)
    mem = torch.from_numpy(_queries(rng, C, E)).to(cuda)
    valid = torch.from_numpy(rng.random(C) < 0.7).to(cuda)
    qs = mem[C // 2:C // 2 + 8].clone()
    _same(ops.memory_top1_batch(mem, qs, valid),
          tmt.memory_top1_batch_plain(mem, qs, valid))
    s, r = ops.memory_top1(mem, qs[3], valid)
    ps, pr = tmt.memory_top1_plain(mem, qs[3], valid)
    _same((s[None], r[None]), (ps[None], pr[None]))


@pytest.mark.cuda
@pytest.mark.parametrize("P,B,n_probe", [(64, 1, 4), (1024, 32, 64),
                                         (1024, 8, 1024), (3000, 3, 300),
                                         (9, 5, 9)])
def test_cuda_route_matches_plain(rng, cuda, P, B, n_probe):
    cent = _queries(rng, P, 384)
    cent[P // 2] = cent[0]
    bits = (rng.random(P) < 0.8).astype(np.int32) * tmt.MASK_VALID
    centp, cmaskp = tmt.to_padded_layout(torch.from_numpy(cent),
                                         torch.from_numpy(bits))
    qs = _queries(rng, B, 384)
    qs[0] = cent[0]
    qs = torch.from_numpy(qs)
    ps, pi = tivf.ivf_route_batch_padded_plain(centp, qs, cmaskp, n_probe)
    cs, ci = tivf.ivf_route_batch_padded_cuda(centp.to(cuda), qs.to(cuda),
                                              cmaskp.to(cuda), n_probe)
    np.testing.assert_array_equal(ci.cpu().numpy(), pi.numpy())
    np.testing.assert_allclose(cs.cpu().numpy(), ps.numpy(), atol=1e-6,
                               rtol=0)
    with pytest.raises(ValueError):
        tivf.ivf_route_batch_padded_cuda(centp.to(cuda), qs.to(cuda),
                                         cmaskp.to(cuda),
                                         tmt._pick_block(centp.shape[0],
                                                         1024) + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("n_probe", [1, 4, 64])
@pytest.mark.parametrize("B", [1, 8, 32, 33])
@pytest.mark.parametrize("P", [64, 1000, 1024])
def test_cuda_route_edges(cuda, P, B, n_probe):
    """The route on the scan core: key mode at n_probe = 1, list mode above
    it; a quarter of the clusters unseeded, tied centroids, queries equal
    to a centroid; scores and rows exactly the plain version's."""
    rng = np.random.default_rng(P + 7 * B + n_probe)
    cent = _queries(rng, P, 384)
    cent[P // 2] = cent[P - 1] = cent[0]
    bits = (rng.random(P) < 0.75).astype(np.int32) * tmt.MASK_VALID
    bits[[0, P // 2, P - 1]] = tmt.MASK_VALID
    centp, cmaskp = (t.to(cuda) for t in tmt.to_padded_layout(
        torch.from_numpy(cent), torch.from_numpy(bits)))
    qs = _queries(rng, B, 384)
    qs[0] = cent[0]
    qs = torch.from_numpy(qs).to(cuda)
    for _ in range(2):                   # the workspaces kept between calls
        _same(ops.ivf_route_batch_padded(centp, qs, cmaskp, n_probe),
              tivf.ivf_route_batch_padded_plain(centp, qs, cmaskp, n_probe))
    s, r = ops.ivf_route_padded(centp, qs[0], cmaskp, n_probe)
    ps, pr = tivf.ivf_route_padded_plain(centp, qs[0], cmaskp, n_probe)
    _same((s[None], r[None]), (ps[None], pr[None]))


@pytest.mark.cuda
@pytest.mark.parametrize("guides_only", [False, True])
@pytest.mark.parametrize("k", [1, 4, 32])
@pytest.mark.parametrize("n_probe", [1, 3])
@pytest.mark.parametrize("B", [1, 8, 33])
def test_cuda_ivf_scan_matches_plain(cuda, B, n_probe, k, guides_only):
    """The candidate read over stale members, empty bucket slots, dead
    probes (and one at a plane padding row), k beyond a query's kept
    candidates and the guides-only view: sims and packed meta exactly the
    plain version's, twice on the kept workspaces."""
    ix = ivf_cases.index(B + 10 * n_probe)
    qs = ivf_cases.queries(ix, B, B)
    scores, cids = ivf_cases.route(ix, qs, n_probe, B)
    req = tmt.MASK_VALID | (tmt.MASK_GUIDE if guides_only else 0)
    args = ivf_cases.scan_args(ix, scores, cids, qs, k, req)
    want = tivf.ivf_scan_batch_plain(*args)
    for _ in range(2):
        got = ops.ivf_scan_batch(*(a.to(cuda) if torch.is_tensor(a) else a
                                   for a in args))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


@pytest.mark.cuda
def test_cuda_ivf_read_on_the_card_equals_the_cpu(cuda):
    """IVFMemory.query_topk_batch (one route and one candidate-read launch
    for the batch) gives the CPU's chunked read: sims and meta exactly; and
    with every cluster probed the exact scan's sims."""
    from repro_torch.core import memory as tmem
    from repro_torch.core.memory_ivf import IVFMemory
    rng = np.random.default_rng(5)
    X = _queries(rng, 500, 384)
    guide = rng.integers(0, 9, (500, 4)).astype(np.int32)
    has_guide, hard = rng.random(500) < 0.5, rng.random(500) < 0.5
    reads = []
    for dev in ("cpu", cuda):
        store = tmem.init_memory(tmem.MemoryConfig(capacity=512,
                                                   embed_dim=384,
                                                   guide_len=4), device=dev)
        tmem.add_batch(store, X, guide, has_guide, hard,
                       np.arange(500, dtype=np.int32))
        ivf = IVFMemory(store, clusters=16, probes=16)
        qs = torch.from_numpy(X[:40]).to(dev)
        got = ivf.query_topk_batch(qs, 4).device_get()
        exact = ivf.exact_query_topk_batch(qs, 4).device_get()
        np.testing.assert_array_equal(got.sim, exact.sim)
        reads.append(got)
    np.testing.assert_array_equal(reads[0].sim, reads[1].sim)
    np.testing.assert_array_equal(reads[0].meta, reads[1].meta)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_attention_matches_plain(rng, cuda, dtype, tol):
    q = torch.from_numpy(rng.normal(size=(2, 45, 8, 128)).astype(
        np.float32)).to(cuda, dtype)
    k = torch.from_numpy(rng.normal(size=(2, 45, 2, 128)).astype(
        np.float32)).to(cuda, dtype)
    for window in (0, 16):
        want = fa.flash_attention_plain(q, k, k, window=window).float()
        got = fa.flash_attention_cuda(q, k, k, window=window).float()
        assert (got - want).abs().max().item() <= tol
        q0 = q[:, 0].contiguous()
        want = da.decode_attention_plain(q0, k, k, 30,
                                         window=window).float()
        got = da.decode_attention_cuda(q0, k, k, 30,
                                       window=window).float()
        assert (got - want).abs().max().item() <= tol


ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _attn_inputs(rng, cuda, dtype, *shapes):
    return [torch.from_numpy(rng.normal(size=sh).astype(np.float32)).to(
        cuda, dtype) for sh in shapes]


@pytest.mark.cuda
@pytest.mark.parametrize("B,M,cls,H,KV,hd,window", [
    (1, 308, [301], 32, 8, 128, 0),            # llama3-8b main shape
    (1, 1032, [1024], 32, 8, 128, 0),          # several chunks
    (1, 4104, [4096], 32, 8, 128, 0),
    (1, 1032, [1024], 32, 8, 128, 100),        # window across a chunk
    (8, 308, [1, 5, 17, 64, 100, 200, 299, 300], 32, 8, 128, 0),
    (8, 132, [131, 3, 64, 132, 1, 77, 100, 16], 6, 6, 32, 0),
    (8, 132, [131, 3, 64, 132, 1, 77, 100, 16], 4, 4, 32, 40),
    (2, 500, [500, 250], 16, 1, 64, 0),        # G = 16
    (3, 200, [200, 33, 129], 24, 4, 64, 50),   # G = 6
    (2, 20, [20, 7], 8, 2, 32, 0),             # one chunk
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_split_kv_matches_plain(rng, cuda, B, M, cls, H, KV, hd,
                                            window, dtype):
    q, k, v = _attn_inputs(rng, cuda, dtype, (B, H, hd), (B, M, KV, hd),
                           (B, M, KV, hd))
    cl = torch.tensor(cls, dtype=torch.int32, device=cuda)
    want = da.decode_attention_plain(q, k, v, cl, window=window).float()
    got = da.decode_attention_cuda(q, k, v, cl, window=window).float()
    assert (got - want).abs().max().item() <= ATTN_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_empty_cache_and_reused_workspace(rng, cuda, dtype):
    """cache_len = 0 gives zeros; calls of one shape share a workspace and
    ticket buffer, so a second call with other lengths must be right too
    (the tickets are back at zero)."""
    q, k, v = _attn_inputs(rng, cuda, dtype, (2, 32, 128), (2, 1032, 8, 128),
                           (2, 1032, 8, 128))
    for cls in ([0, 1024], [1000, 0], [517, 1030], [1032, 1]):
        cl = torch.tensor(cls, dtype=torch.int32, device=cuda)
        got = da.decode_attention_cuda(q, k, v, cl).float()
        want = da.decode_attention_plain(q, k, v, cl).float()
        for b, n in enumerate(cls):
            if n == 0:
                assert torch.equal(got[b], torch.zeros_like(got[b]))
            else:
                assert (got[b] - want[b]).abs().max().item() <= \
                    ATTN_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,window,kv_len", [
    (1, 17, 17, 32, 8, 128, True, 0, None),    # llama3-8b, ragged Sq
    (1, 130, 130, 32, 8, 128, True, 0, None),
    (1, 300, 300, 32, 8, 128, True, 0, None),
    (1, 300, 300, 32, 8, 128, True, 64, None),
    (2, 300, 300, 32, 8, 128, True, 0, [250, 300]),
    (32, 16, 16, 4, 4, 32, False, 0, [10, 16] * 16),   # the embedder
    (4, 40, 40, 4, 4, 32, False, 0, [0, 5, 40, 1]),    # kv_len 0: average
    (8, 130, 130, 6, 6, 32, True, 0, None),            # rar-strong
    (2, 10, 75, 8, 2, 64, True, 0, None),              # Sq < Sk
    (2, 100, 100, 16, 1, 64, True, 30, None),          # G = 16
    (1, 65, 65, 8, 8, 32, True, 0, None),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_matches_plain(rng, cuda, B, Sq, Sk, H, KV, hd, causal,
                                  window, kv_len, dtype):
    q, k, v = _attn_inputs(rng, cuda, dtype, (B, Sq, H, hd), (B, Sk, KV, hd),
                           (B, Sk, KV, hd))
    kl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32,
                                                  device=cuda)
    kw = dict(causal=causal, window=window, kv_len=kl)
    want = fa.flash_attention_plain(q, k, v, **kw).float()
    got = fa.flash_attention_cuda(q, k, v, **kw).float()
    assert (got - want).abs().max().item() <= ATTN_TOL[dtype]
