"""The IVF candidate read (``csrc/ivf_scan.cu``) and the card-order sums of
the plain store reads, on the CPU; the kernels themselves run only on the
card (``tests/test_torch_cuda.py``):

* the plain candidate read against the JAX package's
  ``_ivf_topk_batch_jit`` on the same index arrays (stale members, empty
  bucket slots, dead probes and centroid-plane padding rows, k beyond a
  query's kept candidates, the guides-only view, B of 1, 8 and 33): rows,
  keys and meta exact, sims within 2 ulp at 1.0 (JAX sums a dot in
  another order);
* an emulation of the kernels' decomposition in torch (tiles of 32
  candidates or plane rows, a warp each; the key mode's atomic max in any
  order of the tiles; the tile lists sorted by a warp, absent entries past
  the candidates, and the last CTA's merge over the lists' heads; the
  winners' mask bits) held to the plain versions exactly;
* ``memory_topk._dots``, the plain store reads' dots, against an exact
  emulation of the card's 32-lane FMA chains (Python fractions) bit for
  bit, on unit rows with exact ties and on rows built to make the f64 sum
  fall on an f32 rounding tie;
* the all-probes IVF read equal to the exact scan bit for bit.
"""
import _torch_threads  # noqa: F401  (a worker's share of the cores)
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _ivf_cases as ivf_cases
from repro.core import memory as jmem
from repro.core.memory_ivf import _ivf_topk_batch_jit
from repro_torch.core import memory as tmem
from repro_torch.core import memory_ivf as tcore
from repro_torch.core.memory_ivf import IVFMemory
from repro_torch.kernels import memory_ivf as tivf
from repro_torch.kernels import memory_topk as tmt
from test_torch_store_scan_design import ZERO_KEY, _pack, _unpack

ULP2 = 2 * float(np.finfo(np.float32).eps)
G = 4
SENTINEL = 2 ** 30
ABSENT = 0x7FFFFFFF
TILE = 32


def _stores(ix, seed):
    """The index's store in both packages, with random hard bits, times
    and guides."""
    rng = np.random.default_rng(seed)
    C = ix["rows"].shape[0]
    hard = rng.random(C) < 0.5
    added = rng.integers(0, 1000, C).astype(np.int32)
    guide = rng.integers(0, 50, (C, G)).astype(np.int32)
    j = jmem.MemoryState(emb=jnp.asarray(ix["emb"].numpy()),
                         mask=jnp.asarray(ix["mask"].numpy()),
                         guide=jnp.asarray(guide), hard=jnp.asarray(hard),
                         added_at=jnp.asarray(added),
                         ptr=jnp.asarray(C, jnp.int32))
    t = tmem.MemoryState(emb=ix["emb"], mask=ix["mask"],
                         guide=torch.from_numpy(guide),
                         hard=torch.from_numpy(hard),
                         added_at=torch.from_numpy(added), ptr=C)
    return j, t


# ---------------------------------------------------------------------------
# the plain candidate read against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,n_probe,k,guides_only", [
    (1, 1, 1, False), (8, 1, 32, True), (33, 3, 4, False), (8, 14, 4, True),
    (33, 14, 64, False), (1, 14, 64, True)])
def test_ivf_scan_plain_matches_jax(B, n_probe, k, guides_only):
    """Route, candidate read and epilogue of the port against
    ``_ivf_topk_batch_jit``. 14 probes of 12 clusters (a quarter of them
    unseeded) on a plane padded to 16 rows include dead probes and padding
    rows; one probe of buckets of 40 leaves k = 32 beyond some queries'
    kept candidates."""
    ix = ivf_cases.index(B + n_probe)
    qs = ivf_cases.queries(ix, B, B)
    js, ts = _stores(ix, B)
    req = tmt.MASK_VALID | (tmt.MASK_GUIDE if guides_only else 0)
    plane = (ix["cent"], ix["cmask"], ix["cidmap"])
    want = _ivf_topk_batch_jit(
        (tuple(jnp.asarray(t.numpy()) for t in plane),),
        jnp.asarray(ix["members"].numpy()), jnp.asarray(ix["assign"].numpy()),
        js.emb, js.mask, js.hard, js.added_at, js.guide,
        jnp.asarray(qs.numpy()), k=k, n_probe=n_probe, required=req, cs=0,
        csp=0)
    got = tcore._ivf_topk_batch(plane, ix["members"], ix["assign"], ts, qs, k,
                                n_probe, req)
    np.testing.assert_array_equal(np.asarray(want.meta), got.meta.numpy())
    np.testing.assert_allclose(np.asarray(want.sim), got.sim.numpy(),
                               atol=ULP2, rtol=0)
    # the keys behind the meta: a slot, or 2**30 for a dropped candidate
    # (index C - 1 in the meta, as the JAX package clamps it)
    scores, cids = tivf.ivf_route_batch_padded_plain(ix["cent"], qs,
                                                     ix["cmask"], n_probe)
    s, keys, bits = tivf.ivf_select_plain(*ivf_cases.select_args(
        ix, scores, cids, qs, k, req))
    assert torch.equal(keys.clamp(0, ts.capacity - 1), got.meta[..., 0])
    assert torch.equal(s, got.sim)
    assert (keys[keys >= SENTINEL] == SENTINEL).all()
    assert (s[keys >= SENTINEL] == -2.0).all()
    assert (bits[keys >= SENTINEL] == 0).all()


@pytest.mark.parametrize("S,pad,k,guides_only", [
    (2, 0, 4, False), (3, 8, 1, True), (4, 0, 32, False), (5, 3, 4, True)])
def test_ivf_scan_plain_sharded_layout(S, pad, k, guides_only):
    """The candidate read over a sharded store (slot g at row
    (g // cs) * csp + g % cs, ``csp`` padded past ``cs``) equals the read
    over the flat store of the same slots, and JAX's
    ``_ivf_topk_batch_jit`` at the same geometry."""
    B, n_probe = 8, 3
    ix = ivf_cases.index(40 + S)
    qs = ivf_cases.queries(ix, S, B)
    scores, cids = ivf_cases.route(ix, qs, n_probe, S)
    req = tmt.MASK_VALID | (tmt.MASK_GUIDE if guides_only else 0)
    flat = ivf_cases.scan_args(ix, scores, cids, qs, k, req)
    emb, mask, cs, csp = ivf_cases.sharded(ix, S, pad)
    args = flat[:5] + (emb, mask) + flat[7:]
    want = tivf.ivf_scan_batch_plain(*flat)
    got = tivf.ivf_scan_batch_plain(*args, cs=cs, csp=csp)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    plane = (ix["cent"], ix["cmask"], ix["cidmap"])
    jx = _ivf_topk_batch_jit(
        (tuple(jnp.asarray(t.numpy()) for t in plane),),
        jnp.asarray(ix["members"].numpy()), jnp.asarray(ix["assign"].numpy()),
        jnp.asarray(emb.numpy()), jnp.asarray(mask.numpy()),
        jnp.asarray(ix["hard"].numpy()), jnp.asarray(ix["added_at"].numpy()),
        jnp.asarray(ix["guide"].numpy()), jnp.asarray(qs.numpy()), k=k,
        n_probe=n_probe, required=req, cs=cs, csp=csp)
    # JAX routes for itself: compare where the route made no probe dead
    live = (scores > -2.0).all(dim=1).numpy()
    np.testing.assert_array_equal(np.asarray(jx.meta)[live],
                                  got[1].numpy()[live])
    np.testing.assert_allclose(np.asarray(jx.sim)[live], got[0].numpy()[live],
                               atol=ULP2, rtol=0)


# ---------------------------------------------------------------------------
# the kernel's decomposition, emulated
# ---------------------------------------------------------------------------


def _candidates(args):
    """Every candidate's (sim, key, bits) as the kernel's warp 0 and its
    dot threads form them: (B, L) each."""
    scores, cids, cidmap, members, assign, emb, mask, qs, k, req = args
    C = assign.shape[0]
    slots, ok = tivf.gather_candidates(members, assign, scores,
                                       tivf.global_cids(cids, cidmap))
    L = slots.shape[1]
    phys = slots.long().clamp(0, C - 1)
    rows = torch.where(ok[..., None], emb[phys], 0.0)
    bits = torch.where(ok, mask[phys, 0], 0)
    qp = tmt._pad_queries(qs, emb.shape[1])
    sims = tmt._lane_dots(rows, qp[:, None, :])
    sims = torch.where(ok & ((bits & req) == req), sims, -2.0)
    keys = torch.where(ok, slots.long(), SENTINEL + torch.arange(L)[None])
    return sims, keys, bits


def _tile_lists(keys, length):
    """Each tile of 32 entries' keys sorted descending, its first
    ``length`` kept (the warp's shuffle sort): keys (B, N) -> (B, tiles,
    length), absent entries ZERO_KEY."""
    B, N = keys.shape
    tiles = -(-N // TILE)
    padded = torch.full((B, tiles * TILE), ZERO_KEY, dtype=torch.int64)
    padded[:, :N] = keys
    srt = padded.view(B, tiles, TILE).sort(dim=-1, descending=True).values
    return srt[..., :length]


def _merge_heads(lists, n):
    """A warp's merge: n rounds, each taking the largest head of the
    descending lists and advancing that list. lists (B, tiles, len) ->
    (B, n) keys."""
    B, tiles, length = lists.shape
    out = torch.full((B, n), ZERO_KEY, dtype=torch.int64)
    for b in range(B):
        head = [0] * tiles
        for r in range(n):
            cur = [int(lists[b, t, head[t]]) if head[t] < length else ZERO_KEY
                   for t in range(tiles)]
            t = max(range(tiles), key=lambda t: cur[t])
            out[b, r] = cur[t]
            head[t] += 1
    return out


def emulate_ivf_scan(args, order):
    """The kernel's result: tiles of 32 candidates (a warp each, 4 a CTA);
    key mode (k = 1) merges each tile's best key by an atomic max in
    ``order``; list mode
    writes each tile's sorted top min(k, 32) and the query's last CTA
    merges its lists over their heads; then the winners' mask bits (a
    dropped winner's key back as 2**30)."""
    k, mask, C = args[8], args[6], args[4].shape[0]
    sims, keys, _ = _candidates(args)
    B, L = sims.shape
    tiles = -(-L // TILE)
    packed = _pack(sims, keys)
    if k == 1:
        state = torch.full((B,), ZERO_KEY, dtype=torch.int64)
        for c in order(B * tiles):
            b, t = divmod(int(c), tiles)
            state[b] = max(state[b], packed[b, t * TILE:(t + 1) * TILE].max())
        won = state[:, None]
    else:
        won = _merge_heads(_tile_lists(packed, min(k, TILE)), k)
    out_s, out_r = _unpack(won)
    out_r = out_r.long()
    dropped = out_r >= SENTINEL      # comes back as the 2**30 sentinel
    bits = torch.where(dropped, 0, mask[out_r.clamp(0, C - 1), 0])
    out_r = torch.where(dropped, SENTINEL, out_r)
    return out_s, out_r.to(torch.int32), bits


def emulate_route(cent, qs, cmask, n_probe):
    """ivf_route.cu: 32-row tiles, each query's tile keys sorted and their
    first min(n_probe, 32) kept, the lists merged over their heads."""
    sims = tmt._masked_dots(cent, qs, cmask, tmt.MASK_VALID,
                            cent.shape[0]).T                     # (B, Pp)
    rows = torch.arange(cent.shape[0])[None].expand_as(sims)
    won = _merge_heads(_tile_lists(_pack(sims, rows), min(n_probe, TILE)),
                       n_probe)
    return _unpack(won)


def _shuffled(n):
    return np.random.default_rng(n).permutation(n)


@pytest.mark.parametrize("B,n_probe,k,guides_only", [
    (1, 1, 1, False), (8, 3, 1, True), (33, 1, 32, False), (8, 1, 32, True),
    (33, 3, 4, True), (1, 3, 4, False)])
def test_ivf_scan_decomposition_matches_plain(B, n_probe, k, guides_only):
    """Cases of the card tests (tests/test_torch_cuda.py::
    test_cuda_ivf_scan_matches_plain), emulated: sims, keys and bits
    exactly the plain version's, whatever order the CTAs finish in."""
    ix = ivf_cases.index(B + 10 * n_probe)
    qs = ivf_cases.queries(ix, B, B)
    scores, cids = ivf_cases.route(ix, qs, n_probe, B)
    req = tmt.MASK_VALID | (tmt.MASK_GUIDE if guides_only else 0)
    args = ivf_cases.select_args(ix, scores, cids, qs, k, req)
    want = tivf.ivf_select_plain(*args)
    for order in (range, _shuffled):
        got = emulate_ivf_scan(args, order)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    if k == 32 and n_probe == 1:     # k beyond some queries' kept candidates
        assert (want[1] >= SENTINEL).any()


@pytest.mark.parametrize("P,B,n_probe", [(64, 5, 64), (1024, 3, 4),
                                         (1000, 2, 40), (9, 4, 9)])
def test_route_decomposition_matches_plain(P, B, n_probe):
    """The route's tiles of 32 plane rows, sorted tile lists of min(n_probe,
    32) keys and their merge over the heads give the plain route's scores
    and rows, with a quarter of the clusters unseeded and tied centroids."""
    rng = np.random.default_rng(P + B)
    cent = ivf_cases.unit(rng, P, 384)
    cent[P // 2] = cent[0]
    bits = (rng.random(P) < 0.75).astype(np.int32) * tmt.MASK_VALID
    bits[[0, P // 2]] = tmt.MASK_VALID
    centp, cmaskp = tmt.to_padded_layout(torch.from_numpy(cent),
                                         torch.from_numpy(bits))
    qs = torch.from_numpy(ivf_cases.unit(rng, B, 384))
    qs[0] = centp[0, :384]
    got = emulate_route(centp, qs, cmaskp, n_probe)
    want = tivf.ivf_route_batch_padded_plain(centp, qs, cmaskp, n_probe)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# the summation order of the plain reads: the card's, bit for bit
# ---------------------------------------------------------------------------


def _f32(x: Fraction) -> np.float32:
    """x rounded once to f32, ties to even."""
    f = np.float32(float(x))
    best = None
    for c in (np.nextafter(f, np.float32(-np.inf)), f,
              np.nextafter(f, np.float32(np.inf))):
        d = abs(Fraction(float(c)) - x)
        even = int(np.array(c, np.float32).view(np.int32)) % 2 == 0
        if best is None or d < best[0] or (d == best[0] and even):
            best = (d, c)
    return best[1]


def card_dot(m, q):
    """The card's dot of two f32 vectors, exactly: an FMA chain from +0.0
    over each block of 32 lanes (each step the exact m[e] q[e] + acc,
    rounded once to f32), the blocks added in order from +0.0."""
    total = np.float32(0.0)
    for b0 in range(0, len(m), 32):
        acc = np.float32(0.0)
        for e in range(b0, min(b0 + 32, len(m))):
            acc = _f32(Fraction(float(m[e])) * Fraction(float(q[e]))
                       + Fraction(float(acc)))
        total = np.float32(total + acc)
    return total


def test_dots_are_the_card_fma_chains_bit_for_bit():
    """Unit rows with exact ties, a row whose second step's f64 sum lies
    exactly on an f32 tie (rounding that sum to f32 would give 1 + 2**-22;
    the FMA gives 1 + 2**-23), and rows of magnitudes below 2**-60 (the
    exact FMA throughout)."""
    rng = np.random.default_rng(3)
    m = ivf_cases.unit(rng, 14, 384)
    m[5] = m[2]
    m[9] = m[2]
    m[10] = 0.0
    m[11, :] = 0.0
    m[11, :2] = 1 + 2.0 ** -23
    m[12] = m[3] * 1e-25
    m[13, ::7] = 2.0 ** -70
    q = ivf_cases.unit(rng, 3, 384)
    q[0] = m[2]
    q[1, :2] = (1.0, 2.0 ** -24 * (1 - 2.0 ** -23))
    got = tmt._dots(torch.from_numpy(m), torch.from_numpy(q)).numpy()
    want = np.array([[card_dot(m[i], q[j]) for j in range(3)]
                     for i in range(len(m))], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert got[11, 1] == np.float32(1 + 2.0 ** -23)
    assert got[2, 0] == got[5, 0] == got[9, 0]


def test_all_probes_ivf_read_equals_exact_scan_bitwise():
    """With every cluster probed, the IVF batch read (its plain candidate
    read) gives the exact scan's sims bit for bit, and its rows and meta
    on every valid entry."""
    rng = np.random.default_rng(11)
    X = ivf_cases.unit(rng, 200, 96)
    X[150] = X[20]
    store = tmem.init_memory(tmem.MemoryConfig(capacity=256, embed_dim=96,
                                               guide_len=G), device="cpu")
    tmem.add_batch(store, X, rng.integers(0, 9, (200, G)).astype(np.int32),
                   rng.random(200) < 0.5, rng.random(200) < 0.5,
                   np.arange(200, dtype=np.int32))
    ivf = IVFMemory(store, clusters=8, probes=8)
    qs = X[[20, 3, 77, 199]] + 0.1 * ivf_cases.unit(rng, 4, 96)
    for guides_only in (False, True):
        got = ivf.query_topk_batch(qs, 6, guides_only=guides_only)
        want = ivf.exact_query_topk_batch(qs, 6, guides_only=guides_only)
        assert torch.equal(got.sim, want.sim)
        valid = want.sim > -2.0
        assert torch.equal(got.meta[valid], want.meta[valid])
