"""IVF index states with the candidate read's edge cases, from numpy alone
(the card's test file imports no JAX): a store of clustered unit rows with
duplicates, rows without the valid or guide bit, random hard bits, times
and guides, a padded centroid plane with unseeded clusters, member buckets
with empty slots and stale members (slots whose ``assign`` names another
cluster, or none), and routes with dead probes (score -2.0) and
centroid-plane padding rows."""
import numpy as np
import torch

from repro_torch.kernels import memory_ivf as tivf
from repro_torch.kernels import memory_topk as tmt


def unit(rng, n, e):
    x = rng.normal(size=(n, e)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def index(seed, C=300, P=12, M=40, E=384):
    """A store and its index, as torch tensors on the CPU: emb (Cp, Ep),
    mask (Cp, 1), the padded plane (cent, cmask, cidmap), members (P, M)
    and assign (C,)."""
    rng = np.random.default_rng(seed)
    protos = unit(rng, P, E)
    owner = rng.integers(0, P, C)
    rows = protos[owner] + 0.3 * rng.normal(size=(C, E)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    rows[C // 2] = rows[C // 3]                        # a tie across slots
    rows[C - 1] = rows[C // 3]
    owner[[C // 2, C - 1]] = owner[C // 3]
    bits = ((rng.random(C) < 0.9) * tmt.MASK_VALID
            + (rng.random(C) < 0.5) * tmt.MASK_GUIDE).astype(np.int32)
    bits[[C // 3, C // 2, C - 1]] = tmt.MASK_VALID | tmt.MASK_GUIDE
    members = np.full((P, M), -1, np.int32)
    for c in range(P):
        slots = rng.permutation(np.flatnonzero(owner == c))[:M - 3]
        at = np.sort(rng.choice(M, len(slots), replace=False))
        members[c, at] = slots                         # empty slots between
    assign = np.where(np.isin(np.arange(C), members), owner, -1).astype(
        np.int32)
    listed = np.flatnonzero(assign >= 0)
    stale = rng.choice(listed, len(listed) // 10, replace=False)
    assign[stale[::2]] = (assign[stale[::2]] + 1) % P  # moved elsewhere
    assign[stale[1::2]] = -1                           # evicted
    seeded = (rng.random(P) < 0.75).astype(np.int32) * tmt.MASK_VALID
    seeded[0] = tmt.MASK_VALID
    emb, mask = tmt.to_padded_layout(torch.from_numpy(rows),
                                     torch.from_numpy(bits))
    cent, cmask = tmt.to_padded_layout(torch.from_numpy(protos),
                                       torch.from_numpy(seeded))
    return dict(emb=emb, mask=mask, cent=cent, cmask=cmask,
                cidmap=torch.arange(P, dtype=torch.int32),
                members=torch.from_numpy(members),
                assign=torch.from_numpy(assign),
                hard=torch.from_numpy(rng.random(C) < 0.5),
                added_at=torch.from_numpy(rng.integers(0, 1000, C).astype(
                    np.int32)),
                guide=torch.from_numpy(rng.integers(0, 50, (C, 4)).astype(
                    np.int32)), protos=protos, rows=rows)


def queries(ix, seed, B):
    """Unit queries near the prototypes; query 0 is the tied row, query 1
    (B > 1) a prototype."""
    rng = np.random.default_rng(seed)
    P, E = ix["protos"].shape
    qs = ix["protos"][rng.integers(0, P, B)] + \
        0.3 * rng.normal(size=(B, E)).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    C = ix["rows"].shape[0]
    qs[0] = ix["rows"][C // 3]
    if B > 1:
        qs[1] = ix["protos"][0]
    return torch.from_numpy(qs)


def route(ix, qs, n_probe, seed):
    """The plain route, then a few probes made dead (score -2.0) or pointed
    at a plane padding row, as a route over unseeded clusters and padding
    gives them."""
    scores, cids = tivf.ivf_route_batch_padded_plain(ix["cent"], qs,
                                                     ix["cmask"], n_probe)
    rng = np.random.default_rng(seed)
    B = qs.shape[0]
    scores, cids = scores.clone(), cids.clone()
    if n_probe > 1:
        for b in rng.choice(B, max(1, B // 3), replace=False):
            scores[b, -1] = -2.0
            if b % 2:
                cids[b, -1] = ix["cent"].shape[0] - 1
    return scores, cids


def select_args(ix, scores, cids, qs, k, required):
    """The arguments of ``memory_ivf.ivf_select_plain``."""
    return (scores, cids, ix["cidmap"], ix["members"], ix["assign"],
            ix["emb"], ix["mask"], qs, k, required)


def scan_args(ix, scores, cids, qs, k, required):
    """The arguments of ``ops.ivf_scan_batch`` and its two versions."""
    return (scores, cids, ix["cidmap"], ix["members"], ix["assign"],
            ix["emb"], ix["mask"], ix["hard"], ix["added_at"], ix["guide"],
            qs, k, required)
