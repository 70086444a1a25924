"""The decomposition of the two guide-store read kernels (the scan core
``csrc/store_scan.cuh`` behind ``csrc/memory_top1.cu`` and
``csrc/memory_topk.cu``), emulated in plain torch on the CPU; the kernels
themselves run only on the card (``tests/test_torch_cuda.py``):

* row tiles of 32 rows (256 from 16384 rows on), CTA ``c`` of a
  grid of ``g`` walking tiles c, c + g, ... (a persistent CTA holds several
  when the grid is smaller than the tile count);
* key mode (top-1, and top-k at k = 1): the largest 64-bit key (the sim's
  order-preserving bits over 0xFFFFFFFF - row) per query and CTA, merged by
  an atomic max in any order of the CTAs, top-1 raised to the seed
  (-2.0, row 0), unpacked by the last CTA;
* list mode (top-k, k >= 2): each tile's sorted top-k by selection rounds
  that consume to -inf, absent (-inf, 2**30) entries past a tile's real
  rows, and the last CTA's merge by k rounds over the tile lists' heads;
* the summation order: per (row, query), FMA chains over blocks of 32
  lanes, their partial sums added in lane order (the plain versions' own
  order since the plain reads sum as the card does).

Each emulation is held against ``memory_topk.py``'s plain functions and
the JAX oracle ``repro.kernels.ref`` on numpy inputs: rows exact, sims
within 1e-6 (the summation order's error is pinned below that).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import memory_topk as tmt

TOL = 1e-6
H100_SMS = 132
SENTINEL = 2 ** 30
NEG_INF = float("-inf")

top1_ref = jax.jit(jref.memory_top1_batch_padded, static_argnums=(3,))
topk_ref = jax.jit(jref.memory_topk_batch_padded, static_argnums=(3, 4))


def _tile_rows(cp):
    """csrc/store_scan.cuh: 256-row tiles from 16384 rows on (the wide
    configurations), else 32."""
    return 256 if cp >= 16384 else 32


def _store(C, B, seed=0):
    """Unit rows, a fifth of them masked out, half with a guide; exact ties
    inside one tile (rows 3, 17), across tiles and CTAs (C//3, C//2, C-1)
    and across a persistent CTA's tiles (row 7 again 3 tiles on, for a grid
    of 3); rows 1 and 2 are +0.0 and -0.0. Query 0 hits the cross-tile
    ties, query 1 the in-tile ones, query 2 row 7."""
    rng = np.random.default_rng(seed + C + 1000 * B)
    E = 384
    mem = rng.normal(size=(C, E)).astype(np.float32)
    mem /= np.linalg.norm(mem, axis=1, keepdims=True)
    mem[C // 2] = mem[C - 1] = mem[C // 3]
    mem[17] = mem[3]
    R = _tile_rows(C)
    if 3 * R + 7 < C:
        mem[3 * R + 7] = mem[7]
    mem[1], mem[2] = 0.0, -0.0
    bits = ((rng.random(C) < 0.8) * tmt.MASK_VALID
            + (rng.random(C) < 0.5) * tmt.MASK_GUIDE).astype(np.int32)
    bits[[3, 7, 17, C // 3, C // 2, C - 1]] = tmt.MASK_VALID | tmt.MASK_GUIDE
    if 3 * R + 7 < C:
        bits[3 * R + 7] = bits[7]
    qs = rng.normal(size=(B, E)).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    qs[0] = mem[C // 3]
    if B > 1:
        qs[1] = mem[3]
    if B > 2:
        qs[2] = mem[7]
    memp, maskp = tmt.to_padded_layout(torch.from_numpy(mem),
                                       torch.from_numpy(bits))
    return memp, torch.from_numpy(qs), maskp


def _masked_sims(memp, qs, maskp, required):
    """(Cp, B) sims as the plain version computes them, masked to -2.0."""
    return tmt._masked(tmt._dots(memp, qs), maskp, required)


# ---------------------------------------------------------------------------
# the 64-bit key: order-preserving sim bits over 0xFFFFFFFF - row
# ---------------------------------------------------------------------------


def _order_bits(s):
    """The sim's order-preserving 32 bits (int64), -0.0 packed as +0.0."""
    s = torch.where(s == 0, torch.zeros_like(s), s)
    u = s.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 2 ** 31, u ^ 0xFFFFFFFF, u | 2 ** 31)


def _pack(s, rows):
    """The kernel's unsigned 64-bit key, less 2**63 so that it is an int64
    of the same order."""
    return ((_order_bits(s) - 2 ** 31) << 32) | (0xFFFFFFFF - rows)


def _unpack(key):
    bits = (key >> 32) + 2 ** 31
    raw = torch.where(bits >= 2 ** 31, bits & 0x7FFFFFFF, bits ^ 0xFFFFFFFF)
    sims = raw.to(torch.int32).view(torch.float32)
    rows = (0xFFFFFFFF - (key & 0xFFFFFFFF)).to(torch.int32)
    return sims, rows


ZERO_KEY = -2 ** 63          # the unsigned key 0 that the state words hold


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_key_order_is_the_reference_order(seed):
    """Sorting by key is sorting by (sim desc as IEEE compares, row asc):
    +0.0 and -0.0 tie and the row decides; -2.0, -inf and subnormals keep
    their place; unpacking returns the sim (+0.0 for -0.0) and the row."""
    rng = np.random.default_rng(seed)
    sims = np.concatenate([rng.normal(size=40), [0.0, -0.0, -2.0, 1.0, -1.0,
                                                 np.inf, -np.inf, 1e-40,
                                                 -1e-40, 0.0, -0.0, -2.0]])
    sims = torch.from_numpy(rng.permutation(sims).astype(np.float32))
    rows = torch.from_numpy(rng.permutation(len(sims)).astype(np.int64))
    order = np.argsort(-_pack(sims, rows).numpy(), kind="stable")
    want = sorted(range(len(sims)),
                  key=lambda i: (-float(sims[i]), int(rows[i])))
    assert order.tolist() == want
    back_s, back_r = _unpack(_pack(sims, rows))
    assert torch.equal(back_r.long(), rows)
    assert torch.equal(back_s, torch.where(sims == 0, 0.0, sims))
    assert not torch.signbit(back_s[sims == 0]).any()
    assert _pack(torch.tensor([-2.0]), torch.tensor([0])).item() > ZERO_KEY
    assert _unpack(_pack(torch.tensor([-2.0]), torch.tensor([0]))) == \
        (torch.tensor([-2.0]), torch.tensor([0], dtype=torch.int32))


# ---------------------------------------------------------------------------
# the emulated kernels
# ---------------------------------------------------------------------------


def _cta_tiles(tiles, grid):
    return [list(range(c, tiles, grid)) for c in range(min(grid, tiles))]


def key_scan(sims, grid, seeded, finish_order):
    """Key mode: every CTA's largest key per query over its tiles (each
    thread's running max over its rows, then the warp's; max is
    associative), raised to the seed for top-1, merged by atomic max in
    ``finish_order``; the last CTA unpacks."""
    Cp, B = sims.shape
    R = _tile_rows(Cp)
    rows = torch.arange(Cp, dtype=torch.int64)[:, None].expand(Cp, B)
    keys = _pack(sims, rows)
    seed = _pack(torch.tensor([-2.0]), torch.tensor([0]))
    ctas = _cta_tiles(-(-Cp // R), grid)
    best = []
    for tiles in ctas:
        run = torch.full((B,), ZERO_KEY, dtype=torch.int64)
        for t in tiles:                      # a persistent CTA's tiles
            run = torch.maximum(run, keys[t * R:(t + 1) * R].max(0).values)
        best.append(torch.maximum(run, seed) if seeded else run)
    state = torch.full((B,), ZERO_KEY, dtype=torch.int64)
    for c in finish_order(len(ctas)):
        state = torch.maximum(state, best[c])          # atomicMax
    return _unpack(state)


def _select_rounds(v, k, nreal):
    """A tile's top-k: k rounds of max, lowest row, consume to -inf; rounds
    past the tile's real rows give absent (-inf, 2**30) entries. v (n, B)
    with rows past the store at -inf; returns (k, B) sims and local rows."""
    n, B = v.shape
    v = v.clone()
    idx = torch.arange(n)[:, None].expand(n, B)
    out_s = torch.full((k, B), NEG_INF)
    out_r = torch.full((k, B), SENTINEL, dtype=torch.int64)
    for j in range(min(k, nreal)):
        best = v.max(0).values
        row = torch.where(v == best[None], idx, SENTINEL).min(0).values
        out_s[j], out_r[j] = best, row
        v[row, torch.arange(B)] = NEG_INF
    return out_s, out_r


def list_scan(sims, k):
    """List mode: every tile's sorted top-k, then the last CTA's merge by k
    rounds over the heads of the tiles' lists."""
    Cp, B = sims.shape
    R = _tile_rows(Cp)
    tiles = -(-Cp // R)
    ls = torch.full((tiles, k, B), NEG_INF)
    lr = torch.full((tiles, k, B), SENTINEL, dtype=torch.int64)
    for t in range(tiles):
        v = torch.full((R, B), NEG_INF)
        nreal = min(R, Cp - t * R)
        v[:nreal] = sims[t * R:t * R + nreal]
        s, r = _select_rounds(v, k, nreal)
        ls[t], lr[t] = s, torch.where(r < SENTINEL, r + t * R, r)
    head = torch.zeros((tiles, B), dtype=torch.int64)
    cols = torch.arange(B)
    out_s = torch.empty((B, k))
    out_r = torch.empty((B, k), dtype=torch.int64)
    for j in range(k):
        live = head < k
        hs = torch.where(live, ls.gather(1, head.clamp(max=k - 1)[:, None])
                         [:, 0], NEG_INF)
        hr = torch.where(live, lr.gather(1, head.clamp(max=k - 1)[:, None])
                         [:, 0], SENTINEL)
        best = hs.max(0).values
        row = torch.where(hs == best[None], hr, 2 ** 40).min(0).values
        t = torch.where((hs == best[None]) & (hr == row[None]),
                        torch.arange(tiles)[:, None], tiles).min(0).values
        out_s[:, j], out_r[:, j] = best, row
        head[t, cols] += 1
    return out_s, out_r.to(torch.int32)


def _in_order(n):
    return range(n)


def _shuffled(n):
    return np.random.default_rng(n).permutation(n)


def _same(got, want, oracle):
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(oracle[1]))
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(oracle[0]),
                               atol=TOL, rtol=0)


SHAPES = [(136, 1), (136, 8), (1000, 32), (1000, 33), (4096, 8), (4096, 32),
          (4096, 33), (20000, 8)]


@pytest.mark.parametrize("grid", [H100_SMS, 3])
@pytest.mark.parametrize("C,B", SHAPES)
@pytest.mark.parametrize("required", [tmt.MASK_VALID,
                                      tmt.MASK_VALID | tmt.MASK_GUIDE])
def test_top1_key_scan_matches_plain_and_oracle(C, B, grid, required):
    memp, qs, maskp = _store(C, B)
    order = _shuffled if grid == 3 else _in_order
    got = key_scan(_masked_sims(memp, qs, maskp, required), grid, True,
                   order)
    want = tmt.memory_top1_batch_padded_plain(memp, qs, maskp, required)
    oracle = top1_ref(jnp.asarray(memp.numpy()), jnp.asarray(qs.numpy()),
                      jnp.asarray(maskp.numpy()), required)
    _same(got, want, oracle)
    if B > 2:       # the ties resolve to the lowest row
        assert got[1][:3].tolist() == [C // 3, 3, 7]


@pytest.mark.parametrize("k", [1, 4, 16])
@pytest.mark.parametrize("C,B", SHAPES)
def test_topk_scan_matches_plain_and_oracle(C, B, k):
    memp, qs, maskp = _store(C, B, seed=1)
    sims = _masked_sims(memp, qs, maskp, tmt.MASK_VALID)
    if k == 1:
        s, r = key_scan(sims, 3, False, _shuffled)
        got = (s[:, None], r[:, None])
    else:
        got = list_scan(sims, k)
    want = tmt.memory_topk_batch_padded_plain(memp, qs, maskp, k)
    oracle = topk_ref(jnp.asarray(memp.numpy()), jnp.asarray(qs.numpy()),
                      jnp.asarray(maskp.numpy()), k, tmt.MASK_VALID)
    _same(got, want, oracle)
    if k >= 4 and B > 2:     # equal rows come out lowest first
        assert got[1][0, :3].tolist() == [C // 3, C // 2, C - 1]
        assert got[1][1, :2].tolist() == [3, 17]


@pytest.mark.parametrize("k", [1, 4, 16])
def test_empty_view(k):
    """No row carries the required bits: top-1 gives the seed (-2.0, 0),
    top-k the -2.0 rows 0..k-1."""
    memp, qs, maskp = _store(1000, 8)
    zero = torch.zeros_like(maskp)
    sims = _masked_sims(memp, qs, zero, tmt.MASK_VALID)
    s, r = key_scan(sims, H100_SMS, True, _shuffled)
    assert (s == -2.0).all() and (r == 0).all()
    got = (key_scan(sims, 3, False, _shuffled) if k == 1
           else list_scan(sims, k))
    want = tmt.memory_topk_batch_padded_plain(memp, qs, zero, k)
    np.testing.assert_array_equal(np.asarray(got[1]).reshape(8, k),
                                  want[1].numpy())
    assert (np.asarray(got[0]) == -2.0).all()


@pytest.mark.parametrize("C", [136, 1000, 16383, 16384, 65536])
def test_tile_lists_workspace_covers_the_tiling(C):
    """The wrapper's tile-list workspace holds B x k entries for every tile
    the kernel cuts the store into, and the 3 spare entries its 16-byte
    reads may touch."""
    try:
        s, r = tmt._tile_lists(torch.device("cpu"), 0, 8, C, 16)
        need = 8 * -(-C // _tile_rows(C)) * 16 + 3
        assert s.numel() >= need and r.numel() >= need
        assert s.dtype == torch.float32 and r.dtype == torch.int32
    finally:
        tmt._lists.clear()


# ---------------------------------------------------------------------------
# the summation order: 32-lane FMA chains, then their sum in order
# ---------------------------------------------------------------------------


def fma_chain(memp, qs, block=32):
    """(Cp, B) dots as the kernel sums them: within each block of 32 lanes
    one FMA chain from +0.0 (acc = fma(m[e], q[e], acc), e ascending), and
    the blocks' partial sums added in order to a total from +0.0. Each FMA
    is emulated as the exact f64 product and sum, rounded once to f32 (an
    FMA up to double rounding). ``block`` = Ep is one chain over the row."""
    m = memp.double()
    q = tmt._pad_queries(qs, memp.shape[1]).double()
    total = torch.zeros((memp.shape[0], q.shape[0]), dtype=torch.float32)
    for b0 in range(0, memp.shape[1], block):
        acc = torch.zeros_like(total)
        for e in range(b0, min(b0 + block, memp.shape[1])):
            acc = (m[:, e, None] * q[None, :, e] + acc.double()).float()
        total = total + acc
    return total


def test_summation_order_error_and_ties():
    """At B=32, E=384 over 8192 unit rows, with queries equal to rows (sims
    of 1.0), the kernel's order (32-lane FMA chains, then their sum), which
    the plain version now computes bit for bit (tests/
    test_torch_ivf_design.py), is within 3e-7 of the f64 dot, where one
    chain over all 384 lanes strays about twice as far (on 20,000
    self-dots one chain reached 1.03e-6, over the 1e-6 card tolerance; the
    blocks 2.4e-7); equal rows wherever they sit give bit-equal sims."""
    memp, qs, _ = _store(8192, 32, seed=2)
    exact = (memp.double() @ tmt._pad_queries(qs, memp.shape[1]).double().T)
    chain = tmt._dots(memp, qs)
    err = (chain.double() - exact).abs().max().item()
    one = (fma_chain(memp, qs, block=memp.shape[1]).double() - exact).abs()
    assert err < 3e-7 and one.max().item() > 1.5 * err, (err, one.max())
    for a, b in ((8192 // 3, 8192 // 2), (8192 // 3, 8191), (3, 17),
                 (7, 3 * 32 + 7)):
        assert torch.equal(chain[a], chain[b])
