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
probes, k beyond the kept candidates, the guides-only view and a sharded
store's row geometry. The sharded store at 65536 rows is held to the
single-device store on the card, bit for bit.

The attention cases cover the split-KV decode (several chunks, a window
across a chunk boundary, cache_len per row, cache_len = 0, repeated calls
on one workspace) and the flash paths (ragged Sq, kv_len, Sq < Sk), at
hd 32/64/128 in f32 and bf16; the zoo's wider and odd heads (hd 96 of
phi-3-vision, hd 256 with G = 10 of recurrentgemma-2b) and whisper's
non-causal encoder (Sq = Sk = 1500) and cross reads (Sq != Sk, the decode
read over 1500 frames); and a head width no kernel instantiates, refused.
"""
import _torch_threads  # noqa: F401  (a worker's share of the cores)
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


def _card_store(cuda, C, seed):
    """A padded C x 384 store made on the card from a seed: unit rows, 70%
    valid; rows C // 3 and C - 1 repeat row 7, ties across tiles, CTAs and
    the merge's two rounds."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    Cp, Ep = tmt.padded_rows(C), tmt.padded_lanes(384)
    memp = torch.zeros((Cp, Ep), dtype=torch.float32, device=cuda)
    for i in range(0, C, 1 << 18):
        n = min(1 << 18, C - i)
        x = torch.randn((n, 384), generator=gen, device=cuda)
        memp[i:i + n, :384] = x / x.norm(dim=1, keepdim=True)
    memp[C // 3] = memp[C - 1] = memp[7]
    maskp = torch.zeros((Cp, 1), dtype=torch.int32, device=cuda)
    maskp[:C, 0] = (torch.rand(C, generator=gen, device=cuda) < 0.7).to(
        torch.int32) * tmt.MASK_VALID
    maskp[7] = maskp[C // 3] = maskp[C - 1] = tmt.MASK_VALID
    qs = torch.randn((32, 384), generator=gen, device=cuda)
    qs /= qs.norm(dim=1, keepdim=True)
    qs[0] = memp[7, :384]
    return memp, maskp, qs


@pytest.mark.cuda
@pytest.mark.parametrize("C", [400_000, 4_194_304])
def test_cuda_topk_large_single_store_matches_plain(cuda, C):
    """Top-k (k = 4) over one store past the ~385K rows where the list
    mode's single merge refused (a CTA walks many tiles, so the merge takes
    two rounds), at B = 1 and 32, bit for bit the plain version's; k = 1
    and 16 beside it."""
    memp, maskp, qs = _card_store(cuda, C, C)
    for B, k in ((32, 4), (1, 4), (8, 16), (32, 1)):
        got = tmt.memory_topk_batch_padded_cuda(memp, qs[:B], maskp, k)
        _same(got, tmt.memory_topk_batch_padded_plain(memp, qs[:B], maskp,
                                                      k))
        if k == 4:
            assert got[1][0, :3].tolist() == [7, C // 3, C - 1]
    del memp, maskp
    torch.cuda.empty_cache()


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
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("S,pad", [(2, 0), (3, 8), (4, 0), (5, 3)])
def test_cuda_ivf_scan_sharded_layout_matches_plain(cuda, S, pad, k):
    """The candidate read over a sharded store (slot g at row
    (g // cs) * csp + g % cs; 300 slots as 2 x 150 in 152-row shards, 3 x
    100 in 112, 4 x 75 in 80, 5 x 60 in 67): sims and packed meta exactly
    the plain version's, which equal the flat store's read."""
    ix = ivf_cases.index(40 + S)
    qs = ivf_cases.queries(ix, S, 8)
    scores, cids = ivf_cases.route(ix, qs, 3, S)
    flat = ivf_cases.scan_args(ix, scores, cids, qs, k, tmt.MASK_VALID)
    emb, mask, cs, csp = ivf_cases.sharded(ix, S, pad)
    args = flat[:5] + (emb, mask) + flat[7:]
    want = tivf.ivf_scan_batch_plain(*args, cs=cs, csp=csp)
    flat_want = tivf.ivf_scan_batch_plain(*flat)
    got = ops.ivf_scan_batch(*(a.to(cuda) if torch.is_tensor(a) else a
                               for a in args), cs=cs, csp=csp)
    for g, w, f in zip(got, want, flat_want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())
        np.testing.assert_array_equal(w.numpy(), f.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 4, 8])
def test_cuda_sharded_reads_equal_single_device(cuda, S):
    """ShardedMemory on the card at C = 65536 x 384 (S launches of the
    store kernels and the merge) is bit-identical to MemoryState on the
    card after the same commits: query, query_batch, query_topk and
    query_topk_batch at k in (1, 4), both views; and its IVF plane (1024
    clusters, 4 probes) equals the single-device plane's reads."""
    from repro_torch.core import memory as tmem
    from repro_torch.core.memory_ivf import IVFMemory
    from repro_torch.core.memory_sharded import ShardedMemory
    C = 65536
    cfg = tmem.MemoryConfig(capacity=C, embed_dim=384, guide_len=4)
    rng = np.random.default_rng(S)
    single = tmem.init_memory(cfg, device=cuda)
    sharded = ShardedMemory(cfg, shards=S, device=cuda)
    stores = (single, sharded)
    if S == 4:
        stores = tuple(IVFMemory(st, clusters=1024, probes=4)
                       for st in stores)
    X = _queries(rng, C + 1000, 384)
    X[C // S + 5] = X[3]                       # a tie across shards
    for i in range(0, len(X), 8192):
        xb = X[i:i + 8192]
        n = len(xb)
        args = (xb, rng.integers(0, 50, (n, 4)).astype(np.int32),
                rng.random(n) < 0.5, rng.random(n) < 0.5,
                np.arange(i, i + n, dtype=np.int32))
        for st in stores:
            tmem.add_batch(st, *args)
    qs = torch.from_numpy(X[:32]).to(cuda)
    for g in (False, True):
        reads = [(tmem.query(st, qs[3], guides_only=g),
                  tmem.query_batch(st, qs, guides_only=g))
                 + tuple(r for k in (1, 4) for r in (
                     tmem.query_topk(st, qs[3], k, guides_only=g),
                     tmem.query_topk_batch(st, qs, k, guides_only=g)))
                 for st in stores]
        for a, b in zip(*reads):
            a, b = a.device_get(), b.device_get()
            np.testing.assert_array_equal(np.atleast_1d(a.sim).view(np.int32),
                                          np.atleast_1d(b.sim).view(np.int32))
            np.testing.assert_array_equal(a.meta, b.meta)


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


def _ring_lengths(M):
    """Cache lengths before, at and after the ring's first wrap, and
    several wraps on."""
    return [1, M // 2, M - 1, M, M + 1, M + 37, 2 * M - 1, 5 * M + 3]


@pytest.mark.cuda
@pytest.mark.parametrize("M", [64, 256, 4096])
@pytest.mark.parametrize("window_of", ["none", "inside", "beyond"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("G", [1, 3, 7])
def test_cuda_decode_ring_matches_plain(rng, cuda, M, window_of, dtype, hd,
                                        G):
    """The ring read (slot p % M holds position p) against the plain ring
    version, one cache length for both rows and one per row, windows of 0,
    under M and over M; and equal to the prefix read of the same keys laid
    out by position, where those fit a prefix cache."""
    KV = 2
    window = {"none": 0, "inside": M // 4 + 3, "beyond": M + 50}[window_of]
    q, k, v = _attn_inputs(rng, cuda, dtype, (2, KV * G, hd),
                           (2, M, KV, hd), (2, M, KV, hd))
    lens = _ring_lengths(M)
    for cls in [[n, n] for n in lens] + [[lens[1], lens[5]],
                                         [lens[-1], lens[0]]]:
        cl = torch.tensor(cls, dtype=torch.int32, device=cuda)
        want = da.decode_attention_plain(q, k, v, cl, window=window,
                                         ring=True).float()
        got = da.decode_attention_cuda(q, k, v, cl, window=window,
                                       ring=True).float()
        assert (got - want).abs().max().item() <= ATTN_TOL[dtype], cls
        n = max(cls)
        if n <= 2 * M:      # the same keys in a prefix cache of n slots
            pos = torch.arange(n, device=cuda)
            kp, vp = k[:, pos % M].contiguous(), v[:, pos % M].contiguous()
            flat = da.decode_attention_cuda(q, kp, vp, cl,
                                            window=min(window or M, M)
                                            ).float()
            assert (got - flat).abs().max().item() <= ATTN_TOL[dtype], cls


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


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,window", [
    (1, 130, 130, 10, 1, 256, True, 0),        # recurrentgemma-2b
    (1, 2100, 2100, 10, 1, 256, True, 2048),   # past its window
    (2, 77, 77, 10, 1, 256, True, 16),
    (1, 273, 273, 32, 32, 96, True, 0),        # phi-3-vision: patches + text
    (2, 386, 386, 32, 32, 96, True, 0),
    (2, 45, 45, 8, 2, 96, True, 20),
    (1, 1500, 1500, 16, 16, 64, False, 0),     # whisper's encoder
    (2, 17, 1500, 16, 16, 64, False, 0),       # its cross-attention
    (1, 130, 1500, 16, 16, 64, False, 0),
    (2, 33, 70, 4, 4, 96, False, 0),
    (2, 9, 300, 10, 1, 256, False, 0),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_wide_heads_and_cross_match_plain(rng, cuda, B, Sq, Sk, H,
                                                     KV, hd, causal, window,
                                                     dtype):
    q, k, v = _attn_inputs(rng, cuda, dtype, (B, Sq, H, hd), (B, Sk, KV, hd),
                           (B, Sk, KV, hd))
    kw = dict(causal=causal, window=window)
    want = fa.flash_attention_plain(q, k, v, **kw).float()
    got = fa.flash_attention_cuda(q, k, v, **kw).float()
    assert (got - want).abs().max().item() <= ATTN_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("B,M,cls,H,KV,hd,window", [
    (1, 139, [131], 10, 1, 256, 2048),         # recurrentgemma-2b
    (1, 2109, [2101], 10, 1, 256, 2048),       # past its window
    (3, 300, [300, 1, 170], 10, 1, 256, 0),
    (1, 282, [274], 32, 32, 96, 0),            # phi-3-vision
    (2, 395, [387, 200], 32, 32, 96, 0),
    (2, 100, [100, 37], 12, 4, 96, 30),
    (2, 1500, [1500, 1500], 16, 16, 64, 0),    # whisper's cross read
    (1, 139, [18], 16, 16, 64, 0),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_wide_heads_match_plain(rng, cuda, B, M, cls, H, KV, hd,
                                            window, dtype):
    q, k, v = _attn_inputs(rng, cuda, dtype, (B, H, hd), (B, M, KV, hd),
                           (B, M, KV, hd))
    cl = torch.tensor(cls, dtype=torch.int32, device=cuda)
    want = da.decode_attention_plain(q, k, v, cl, window=window).float()
    got = da.decode_attention_cuda(q, k, v, cl, window=window).float()
    assert (got - want).abs().max().item() <= ATTN_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 48, 80, 160, 512])
def test_cuda_attention_refuses_head_widths_it_lacks(rng, cuda, hd):
    """A width no kernel instantiates raises on the card, in both dispatch
    routes; nothing falls back to the plain version."""
    q, k = _attn_inputs(rng, cuda, torch.bfloat16, (1, 8, 4, hd),
                        (1, 8, 4, hd))
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="head_dim"):
        ops.decode_attention(q[:, 0].contiguous(), k, k, 8)


# ---------------------------------------------------------------------------
# the kernels are forward-only: a CUDA input that requires grad is refused
# ---------------------------------------------------------------------------


def _grad_cases(dev):
    """One call of each dispatch route, on ``dev``, whose first tensor
    requires grad."""
    g = torch.Generator(device="cpu").manual_seed(0)

    def t(*shape):
        return torch.randn(shape, generator=g).to(dev)
    memp, maskp = tmt.to_padded_layout(
        torch.nn.functional.normalize(torch.randn((256, 384), generator=g)),
        torch.full((256,), tmt.MASK_VALID, dtype=torch.int32))
    memp, maskp = memp.to(dev), maskp.to(dev)
    qs = torch.nn.functional.normalize(t(4, 384), dim=1)
    cl = torch.full((2,), 9, dtype=torch.int32, device=dev)
    return {
        "flash": lambda w: ops.flash_attention(t(2, 9, 4, 32) * w,
                                               t(2, 9, 4, 32), t(2, 9, 4, 32)),
        "decode": lambda w: ops.decode_attention(t(2, 4, 32) * w,
                                                 t(2, 12, 4, 32),
                                                 t(2, 12, 4, 32), cl),
        "topk": lambda w: ops.memory_topk_batch_padded(memp, qs * w, maskp,
                                                       4),
        "top1": lambda w: ops.memory_top1_batch_padded(memp, qs * w, maskp),
        "route": lambda w: ops.ivf_route_batch_padded(memp, qs * w, maskp,
                                                      4),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["flash", "decode", "topk", "top1",
                                   "route"])
def test_cuda_kernels_refuse_inputs_that_require_grad(cuda, route):
    call = _grad_cases(cuda)[route]
    w = torch.ones((), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        call(w)
    with torch.no_grad():                  # no graph: the kernel runs
        call(w)
    call(w.detach())


def test_plain_attention_route_backpropagates():
    """On the CPU ``ops.flash_attention`` is the plain version, which
    autograd differentiates like the model-level attention."""
    from repro_torch.models import layers as L
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 9, 4, 32), generator=g).requires_grad_(True)
               for _ in range(3))
    out = ops.flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(out.square().sum(), (q, k, v))
    pos = torch.arange(9)[None].expand(2, 9)
    ref = L.attention(q, k, v, q_positions=pos, k_positions=pos, causal=True)
    want = torch.autograd.grad(ref.square().sum(), (q, k, v))
    for a, b in zip(grads, want):
        assert a.abs().max().item() > 0
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the store across CUDA streams (the async shadow drainer's own stream)
# ---------------------------------------------------------------------------

_DELAY = 20_000_000            # cycles of torch.cuda._sleep, ~10 ms


def _slow_uploads(monkeypatch):
    """Make every host upload of a store write asynchronous, behind a
    delay kernel: the whole write then waits on the device while the host
    runs on, so a reader that is not ordered after the writer's stream
    sees a partial epoch."""
    from repro_torch.core import memory as mem
    upload = mem._on

    def slow(state, x, dtype):
        if torch.is_tensor(x):
            return upload(state, x, dtype)
        torch.cuda._sleep(_DELAY // 4)
        host = torch.as_tensor(np.asarray(x)).pin_memory()
        return host.to(state.device, non_blocking=True).to(dtype)
    monkeypatch.setattr(mem, "_on", slow)


def _unit_rows(rng, n, E):
    x = rng.normal(size=(n, E)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.cuda
@pytest.mark.parametrize("wrapped", [False, True])
def test_cuda_apply_on_a_side_stream_is_whole_for_a_reader(rng, cuda,
                                                           wrapped,
                                                           monkeypatch):
    """An epoch applied on a side stream, its scatters queued behind
    delay kernels (:func:`_slow_uploads`), then read on the default stream
    (the serve thread's) after the store lock: every read sees the whole
    epoch. 40 epochs of 8 inserts; each read must find each new row as its
    own top-1 (sim 1, its row). ``wrapped``: the same through the IVF
    plane (its index refresh runs on the side stream)."""
    from repro_torch.core import memory as mem
    from repro_torch.core.memory_ivf import IVFMemory
    _slow_uploads(monkeypatch)
    cfg = mem.MemoryConfig(capacity=512, embed_dim=384, guide_len=4)
    state = mem.init_memory(cfg, device=cuda)
    if wrapped:
        state = IVFMemory(state, clusters=8, probes=8)
    stream = mem.CommitStream()
    side = torch.cuda.Stream(cuda)
    for epoch in range(40):
        rows = _unit_rows(rng, 8, 384)
        with stream.lock, torch.cuda.stream(side):
            torch.cuda._sleep(_DELAY)
            for i, r in enumerate(rows):
                stream.buffer.stage_add(r, np.zeros(4, np.int32), False,
                                        False, 8 * epoch + i + 1)
            state = stream.apply(state)
            if wrapped:
                state.query_topk_batch(torch.from_numpy(rows).to(cuda), 1)
        with stream.lock:
            got = mem.query_topk_batch(
                state, torch.from_numpy(rows).to(cuda), 1).device_get()
        want = (8 * epoch + np.arange(8)) % cfg.capacity
        np.testing.assert_array_equal(got.index[:, 0], want)
        np.testing.assert_array_equal(got.added_at[:, 0],
                                      8 * epoch + np.arange(8) + 1)
        assert np.all(got.sim[:, 0] > 0.9999)


@pytest.mark.cuda
@pytest.mark.parametrize("wrapped", [False, True])
def test_cuda_default_stream_apply_is_whole_for_a_side_reader(rng, cuda,
                                                              wrapped,
                                                              monkeypatch):
    """The reverse of the case above: an epoch applied on the default
    stream (the serve thread's, which the apply leaves unsynced), its
    scatters queued behind delay kernels, then read on a side stream (the
    async drainer's) after the store lock, which orders the side stream
    after the default one: every read sees the whole epoch. ``wrapped``:
    through the IVF plane
    (its index refresh then runs on the default stream)."""
    from repro_torch.core import memory as mem
    from repro_torch.core.memory_ivf import IVFMemory
    _slow_uploads(monkeypatch)
    cfg = mem.MemoryConfig(capacity=512, embed_dim=384, guide_len=4)
    state = mem.init_memory(cfg, device=cuda)
    if wrapped:
        state = IVFMemory(state, clusters=8, probes=8)
    stream = mem.CommitStream()
    side = torch.cuda.Stream(cuda)
    for epoch in range(40):
        rows = _unit_rows(rng, 8, 384)
        q = torch.from_numpy(rows).to(cuda)
        torch.cuda.synchronize()
        with stream.lock:
            torch.cuda._sleep(_DELAY)
            for i, r in enumerate(rows):
                stream.buffer.stage_add(r, np.zeros(4, np.int32), False,
                                        False, 8 * epoch + i + 1)
            state = stream.apply(state)
            if wrapped:
                state.query_topk_batch(q, 1)
        with torch.cuda.stream(side), stream.lock:
            got = mem.query_topk_batch(state, q, 1).device_get()
        want = (8 * epoch + np.arange(8)) % cfg.capacity
        np.testing.assert_array_equal(got.index[:, 0], want)
        np.testing.assert_array_equal(got.added_at[:, 0],
                                      8 * epoch + np.arange(8) + 1)
        assert np.all(got.sim[:, 0] > 0.9999)


@pytest.mark.cuda
def test_cuda_grow_on_a_side_stream_keeps_blocks_for_the_reader(rng, cuda):
    """A store grown on a side stream and read on the default stream:
    dropping it while the read is still queued (behind a delay kernel)
    must not let the side stream's next allocations take its blocks
    (``record_stream`` in ``grow_memory``), so the read returns the
    grown store's rows."""
    from repro_torch.core import memory as mem
    cfg = mem.MemoryConfig(capacity=256, embed_dim=384, guide_len=4)
    state = mem.init_memory(cfg, device=cuda)
    rows = _unit_rows(rng, 64, 384)
    state = mem.add_batch(state, rows, np.zeros((64, 4), np.int32),
                          np.zeros(64, bool), np.zeros(64, bool),
                          np.arange(64, dtype=np.int32))
    stream = mem.CommitStream()
    side = torch.cuda.Stream(cuda)
    q = torch.from_numpy(rows[:16]).to(cuda)
    for _ in range(5):
        with torch.cuda.stream(side):
            grown, _ = stream.grow(state, 1024)
        torch.cuda._sleep(_DELAY)
        sims, idx = ops.memory_topk_batch_padded(grown.emb, q, grown.mask, 1)
        del grown
        with torch.cuda.stream(side):
            junk = [torch.full((1024 + 8, 384), -1.0, device=cuda)
                    for _ in range(8)]
            junk += [torch.zeros((1024 + 8, 1), dtype=torch.int32,
                                 device=cuda) for _ in range(8)]
        torch.cuda.synchronize()
        np.testing.assert_array_equal(idx[:, 0].cpu().numpy(),
                                      np.arange(16))
        assert torch.all(sims[:, 0] > 0.9999)
        del junk


# ---------------------------------------------------------------------------
# the serving fabrics on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_two_drainer_streams_write_one_store_in_order(rng, cuda,
                                                           monkeypatch):
    """``ServingFabric._drain`` run in turn on the default stream and on
    two drainer streams (the async drainers of two replicas), every epoch
    refilling the whole ring of 8. Each upload of a write reaches the card
    on an upload stream of its own, synced at once, and is taken into the
    writer's stream by a kernel behind a delay kernel, ~10 ms on the
    default stream and ~1 ms on a side one: a default-stream epoch is left
    with its writes queued (unread), and the side-stream epoch after it
    must land after it (``memory.StoreLock`` orders the side stream after
    the default one), so a read sees the side epoch's rows and stamps. A
    copy queued behind a delay, or a pinned or device allocation in a
    side epoch, would order the streams by itself and hide a missing wait:
    hence the upload stream, and 4 unchecked epochs to warm the
    allocators. 20 default and 20 side epochs, the sides alternating."""
    from _torch_fabric_parts import make_parts

    from repro_torch.core import memory as mem
    from repro_torch.core.rar import Outcome, RARConfig
    from repro_torch.core.shadow import PENDING, ShadowItem
    from repro_torch.data import tokenizer as tk
    from repro_torch.serving.fabric import ServingFabric
    upload, pinned = mem._on, {}
    copier = torch.cuda.Stream(cuda)
    yes = torch.ones((), dtype=torch.bool, device=cuda)

    def slow(state, x, dtype):
        if torch.is_tensor(x):
            return upload(state, x, dtype)
        src = torch.as_tensor(np.asarray(x))
        buf = pinned.get((src.shape, src.dtype))
        if buf is None:
            buf = pinned[(src.shape, src.dtype)] = \
                torch.empty_like(src).pin_memory()
        buf.copy_(src)
        with torch.cuda.stream(copier):
            dev = buf.to(cuda, non_blocking=True)
        copier.synchronize()
        stream = torch.cuda.current_stream()
        dev.record_stream(stream)
        torch.cuda._sleep(_DELAY if stream == torch.cuda.default_stream()
                          else _DELAY // 8)
        return torch.where(yes, dev, dev).to(dtype)
    monkeypatch.setattr(mem, "_on", slow)
    C, E, warm = 8, 384, 4
    parts = make_parts(weak_known=tuple(range(C)))
    fab = ServingFabric(parts["weak"], parts["strong"], None,
                        parts["route_weak_fn"],
                        RARConfig(memory=mem.MemoryConfig(
                            capacity=C, embed_dim=E, guide_len=4)),
                        replicas=2, device=cuda)
    sides = [torch.cuda.Stream(cuda) for _ in range(2)]
    for epoch in range(warm + 40):
        rows = _unit_rows(rng, C, E)
        items = [ShadowItem(
            seq=fab.learn.shadow.next_seq(), now=C * epoch + i + 1,
            prompt=np.asarray([tk.BOS, i, epoch], np.int32),
            guide_request=np.asarray([tk.GUIDE_REQ, i], np.int32),
            emb=rows[i], strong_ans=(i + epoch) % 4,
            outcome=Outcome(-1, "strong", 1, PENDING)) for i in range(C)]
        if epoch % 2 == 0:
            fab._drain(items)                    # left queued, unread
            continue
        with torch.cuda.stream(sides[(epoch // 2) % 2]):
            fab._drain(items)
        assert all(it.outcome.case == "case1" for it in items)
        with fab.commit_stream.lock:
            got = mem.query_topk_batch(
                fab.memory, torch.from_numpy(rows).to(cuda), 1).device_get()
        if epoch < warm:
            continue
        np.testing.assert_array_equal(got.index[:, 0], np.arange(C))
        np.testing.assert_array_equal(got.added_at[:, 0],
                                      C * epoch + np.arange(C) + 1)
        assert np.all(got.sim[:, 0] > 0.9999)
    assert fab.commit_stream.buffer.entries_applied == fab.memory.ptr == \
        (warm + 40) * C
    fab.close_shadow()


@pytest.mark.cuda
def test_cuda_process_fabric_matches_thread_fabric_on_r1(cuda):
    """R1's workload (rar-weak/rar-strong from seeds 0/1, the 4096 x 384
    store, pool 64 over 2 passes, microbatch 8) through a 2-worker process
    fabric on the card, serialized, equals the 1-replica thread fabric on
    the card: Outcome streams, store, FM calls; the workers launched the
    store-read and flash kernels in their own processes, and the parent's
    drains (guide generation) the decode kernel."""
    from _torch_fabric_parts import rar_parts, rar_workload

    from repro_torch.configs import rar_system
    from repro_torch.serving.fabric import ServingFabric
    from repro_torch.serving.procfabric import ProcessServingFabric
    prompts, greqs, embs = rar_workload()
    cfg = rar_system.make_rar_config()
    mb = 8

    def batches():
        for pos in range(0, 2 * len(prompts), mb):
            first = pos % len(prompts)
            sl = slice(first, first + mb)
            yield (prompts[sl], greqs[sl],
                   list(range(first, first + mb)), embs[sl])

    parts = rar_parts(cuda)
    ref = ServingFabric(parts["weak"], parts["strong"], None,
                        parts["route_weak_fn"], cfg, device=cuda)
    ref_outs = []
    for p, g, k, e in batches():
        ref_outs += ref.process_batch(p, g, keys=k, embs=e)
    ref.close_shadow()
    fab = ProcessServingFabric(functools.partial(rar_parts, "cuda"), cfg,
                               workers=2, device=cuda)
    ops.reset_launches()
    try:
        outs = []
        for p, g, k, e in batches():
            outs += fab.submit(p, g, keys=k, embs=e).wait(timeout=300)
        fab.flush_shadow(timeout=300)
        assert [tuple(vars(o).values()) for o in outs] == \
            [tuple(vars(o).values()) for o in ref_outs]
        assert sum(o.strong_calls for o in outs) == 192
        for f in ("emb", "mask", "guide", "hard", "added_at"):
            assert torch.equal(getattr(fab.memory, f),
                               getattr(ref.memory, f)), f
        assert fab.memory.ptr == ref.memory.ptr
        for tier in ("weak", "strong"):
            assert fab.engine_calls(tier) == \
                getattr(ref.learn, tier).engine.calls
        launched = fab.worker_launches()
        for k in ("memory_topk", "flash_attention"):
            assert launched.get(k, 0) > 0, launched
        assert launched.get("decode_attention", 0) == 0, launched
        assert ops.launch_counts()["decode_attention"] > 0
    finally:
        fab.close_shadow()


@pytest.mark.cuda
def test_cuda_process_fabric_refuses_fork(cuda):
    from _torch_fabric_parts import factory

    from repro_torch.core.rar import RARConfig
    from repro_torch.serving.procfabric import ProcessServingFabric
    with pytest.raises(ValueError, match="fork"):
        ProcessServingFabric(factory(), RARConfig(), start_method="fork",
                             device=cuda)
