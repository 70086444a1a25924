"""A plain RAR controller (the paper's section III, microbatched, shadow
passes inline), the reference the RAR cells are judged by.

:class:`PlainRAR` serves a stream of microbatches from the configuration
alone: its own embedder, store, router and FM forwards
(:mod:`bench.reference.plain_lm`). Each step leaves a :class:`StepLog` of
what a controller produces: the request embeddings, every store read,
every FM call with the tokens it returned, the Outcomes; the store's
learned rows at the end.

Given the measured system's log of the same step (``forced``), it judges
instead of deciding: it works out each quantity again and compares, and
where its own margin is a near tie (a similarity within ``TIE`` of a
threshold or of the next row, a router probability within ``TIE`` of
one half) it follows the system's choice, as it follows the system's
served tokens, whose gap below its own best token it measures. So one
rounding at a tie does not part the two runs. A call the system made
that the reference would not have made ends the judging.

The store: ``F`` filler rows at slots [0, F) (valid, no guide, not hard,
made by the benchmark from the seed; their best rows per question of the
universe come in as ``filler_top``), then the ring of learned rows from
slot F. The reference refuses a run whose ring wraps onto the filler.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bench.reference import plain_lm
from bench.reference.numerics import f32, mm

TIE = 1e-5
GROUP_OF_CASE = {"memory_hard": "hard", "memory_guide": "guide",
                 "memory_skill": "skill", "router_weak": "router"}


@dataclasses.dataclass
class StepLog:
    embs: np.ndarray                  # (B, E) float32
    reads: list                       # (guides_only, sims (n, k), index (n, k))
    calls: list                       # (tier, max_new, prompts, tokens (n, max_new))
    outcomes: list                    # (response, served_by, strong_calls, case, guide_source)


def answer_of(token: int, option_a: int) -> int:
    a = int(token) - option_a
    return a if 0 <= a <= 3 else -1


def splice(prompt: np.ndarray, guides, pad: int) -> np.ndarray:
    parts = [prompt[:1]] + [g[g != pad] for g in guides] + [prompt[1:]]
    return np.concatenate(parts).astype(np.int32)


def select_guides(sims, has_guide, guides, threshold, max_guides, pad):
    out, seen = [], set()
    for j in range(len(sims)):
        if len(out) >= max_guides:
            break
        if sims[j] >= threshold and has_guide[j]:
            g = np.asarray(guides[j])
            key = tuple(int(t) for t in g[g != pad])
            if key in seen:
                continue
            seen.add(key)
            out.append(g)
    return out


class Checks:
    """The judge's running numbers: the largest gaps and the counts of
    disagreements, with the first few disagreements named."""

    def __init__(self):
        self.embed_err = 0.0
        self.read_sim_err = 0.0
        self.read_index_miss = 0
        self.route_miss = 0
        self.call_miss = 0
        self.token_gap = 0.0
        self.outcome_miss = 0
        self.strong_calls_diff = 0
        self.store_emb_err = 0.0
        self.store_meta_miss = 0
        self.ties_followed = 0
        self.notes: list[str] = []

    def note(self, msg: str) -> None:
        if len(self.notes) < 8:
            self.notes.append(msg)

    def numbers(self) -> dict:
        return {k: v for k, v in vars(self).items() if k != "notes"}


class Diverged(Exception):
    pass


class PlainRAR:
    def __init__(self, config: dict, params: dict, universe, u_embs,
                 filler_top, device, cast=f32):
        self.cfg = config
        self.v = config["vocab"]
        self.r = config["rar"]
        self.params = params
        self.u = universe
        self.cast = cast
        self.dev = torch.device(device)
        self.k = self.r["retrieval_k"]
        # the filler's best k + 1 rows for every question of the universe
        self.f_sim, self.f_idx = filler_top
        self.F = config["filler"]["rows"]
        self.C = config["memory"]["capacity"]
        self.G = config["memory"]["guide_len"]
        self.now = 0
        self.ptr = self.F
        self.rows: dict[int, dict] = {}         # slot -> learned row
        self.strong_calls = 0
        self.checks = Checks()
        self.forced = None
        # a request's embedding is its question's (the embedder sees the
        # prompt alone); each prompt's logits are worked out once
        self.u_embs = u_embs
        self._cache: dict = {}

    # -- models ----------------------------------------------------------
    def embed(self, qids) -> torch.Tensor:
        return self.u_embs[torch.as_tensor(np.asarray(qids, np.int64),
                                           device=self.u_embs.device)]

    def _logits(self, tier: str, prompts: list) -> torch.Tensor:
        """Last-position logits (n, V) of each prompt, on the host; the
        prompts not seen before go through the forward grouped by
        length."""
        keys = [(tier, np.asarray(p, np.int32).tobytes()) for p in prompts]
        by_len: dict[int, list[int]] = {}
        for i, (p, key) in enumerate(zip(prompts, keys)):
            if key not in self._cache:
                by_len.setdefault(len(p), []).append(i)
        for _, idx in sorted(by_len.items()):
            idx = list({keys[i]: i for i in idx}.values())
            toks = torch.as_tensor(np.stack([prompts[i] for i in idx]),
                                   device=self.dev)
            lg = plain_lm.lm_last_logits(self.cfg[tier], self.params[tier],
                                         toks, cast=self.cast).cpu()
            for j, i in enumerate(idx):
                self._cache[keys[i]] = lg[j]
        return torch.stack([self._cache[k] for k in keys])

    def _served(self, tier: str, prompts: list, max_new: int) -> np.ndarray:
        """Greedy tokens of one FM call; judging, the system's tokens,
        each held to this forward's best."""
        forced = self._next_call(tier, max_new, prompts)
        toks = np.zeros((len(prompts), max_new), np.int32)
        seqs = [np.asarray(p, np.int32) for p in prompts]
        for step in range(max_new):
            lg = self._logits(tier, seqs)
            best = torch.argmax(lg, dim=1)
            if forced is None:
                toks[:, step] = best.numpy()
            else:
                t = torch.as_tensor(forced[:, step].astype(np.int64))
                gap = (lg.gather(1, best[:, None]) - lg.gather(1, t[:, None])
                       )[:, 0] / lg.abs().amax(dim=1).clamp(min=1e-30)
                self.checks.token_gap = max(self.checks.token_gap,
                                            float(gap.max()))
                toks[:, step] = forced[:, step]
            seqs = [np.append(s, toks[i, step]).astype(np.int32)
                    for i, s in enumerate(seqs)]
        if tier == "strong":
            self.strong_calls += len(prompts)
        self.log.calls.append((tier, max_new, [np.asarray(p) for p in prompts],
                               toks))
        return toks

    def _next_call(self, tier, max_new, prompts):
        if self.forced is None:
            return None
        calls = self.forced.calls
        if self._call_i >= len(calls):
            self.checks.call_miss += 1
            raise Diverged(f"the system made no {tier} call here")
        t, m, ps, toks = calls[self._call_i]
        self._call_i += 1
        same = (t == tier and m == max_new and len(ps) == len(prompts) and
                all(np.array_equal(a, b) for a, b in zip(ps, prompts)))
        if not same:
            self.checks.call_miss += 1
            raise Diverged(f"call {self._call_i - 1}: the system's {t} call "
                           f"of {len(ps)} prompts is not the reference's "
                           f"{tier} call of {len(prompts)}")
        return np.asarray(toks)

    def answers(self, tier: str, prompts: list) -> list[int]:
        toks = self._served(tier, prompts, 1)
        return [answer_of(t, self.v["OPTION_A"]) for t in toks[:, 0]]

    # -- store -----------------------------------------------------------
    def _learned(self, guides_only: bool):
        slots = sorted(s for s, r in self.rows.items()
                       if not guides_only or r["has_guide"])
        if not slots:
            return slots, None
        return slots, torch.stack([self.rows[s]["emb"] for s in slots])

    def read(self, embs: torch.Tensor, qids, guides_only: bool):
        """Top-k (sim, slot) of each query, (sim desc, slot asc), over the
        valid rows (guide rows only if ``guides_only``); -2.0 past the
        view's population. Returns k + 1 columns (the last for ties)."""
        k1 = self.k + 1
        n = embs.shape[0]
        slots, L = self._learned(guides_only)
        sims = torch.full((n, k1), -2.0)
        idx = torch.zeros((n, k1), dtype=torch.int64)
        parts_s, parts_i = [sims], [idx]
        if not guides_only:
            q = torch.as_tensor(np.asarray(qids, np.int64))
            parts_s.append(self.f_sim[q])
            parts_i.append(self.f_idx[q])
        if slots:
            parts_s.append(mm(embs, L.T, self.cast).cpu())
            parts_i.append(torch.as_tensor(slots)[None].expand(n, -1))
        s_all, i_all = torch.cat(parts_s, 1), torch.cat(parts_i, 1)
        # sentinels last among equals: give them the largest slot
        i_key = torch.where(s_all <= -2.0, torch.iinfo(torch.int64).max, i_all)
        o = torch.argsort(i_key, dim=1, stable=True)
        s_all, i_all = s_all.gather(1, o), i_all.gather(1, o)
        o = torch.argsort(-s_all, dim=1, stable=True)[:, :k1]
        return s_all.gather(1, o).numpy(), i_all.gather(1, o).numpy()

    def _compare_read(self, guides_only, sims, idx):
        """Hold a read to the system's, in order; returns the indices to
        serve by (the system's at a tie of two rows)."""
        k = self.k
        self.log.reads.append((guides_only, sims[:, :k].copy(),
                               idx[:, :k].astype(np.int32)))
        if self.forced is None:
            return idx
        g, ps, pi = self.forced.reads[self._read_i]
        self._read_i += 1
        if g != guides_only or ps.shape != sims[:, :k].shape:
            self.checks.call_miss += 1
            raise Diverged("the system's store read is not the reference's")
        out = idx.copy()
        for i in range(sims.shape[0]):
            for j in range(k):
                if sims[i, j] <= -2.0:
                    continue
                self.checks.read_sim_err = max(self.checks.read_sim_err,
                                               abs(float(ps[i, j]) -
                                                   float(sims[i, j])))
                if int(pi[i, j]) != int(idx[i, j]):
                    tied = (abs(sims[i, j] - sims[i, j + 1]) < TIE or
                            (j and abs(sims[i, j] - sims[i, j - 1]) < TIE))
                    if tied:
                        self.checks.ties_followed += 1
                        out[i, j] = int(pi[i, j])
                    else:
                        self.checks.read_index_miss += 1
                        self.checks.note(f"read row {i}: slot {pi[i, j]} "
                                         f"against {idx[i, j]}")
        return out

    def _row(self, slot: int) -> dict:
        if slot in self.rows:
            return self.rows[slot]
        return {"has_guide": False, "hard": False, "added_at": 0,
                "guide": np.zeros(self.G, np.int32)}

    # -- one step --------------------------------------------------------
    def process_batch(self, qids, forced: StepLog | None = None) -> StepLog:
        self.forced, self._call_i, self._read_i = forced, 0, 0
        B = len(qids)
        self.log = StepLog(None, [], [], [None] * B)
        pad, thr = self.v["PAD"], self.r["sim_threshold"]
        prompts = [self.u.prompts[int(q)] for q in qids]
        greqs = [self.u.guide_requests[int(q)] for q in qids]
        nows = list(range(self.now + 1, self.now + B + 1))
        self.now += B
        e = self.embed(qids)
        self.log.embs = e.cpu().numpy()
        if forced is not None:
            if np.shape(forced.embs) != self.log.embs.shape or \
                    len(forced.outcomes) != B:
                self.checks.call_miss += 1
                raise Diverged("the system's step is not the reference's "
                               "batch")
            self.checks.embed_err = max(self.checks.embed_err, float(
                np.abs(forced.embs - self.log.embs).max()))
        sims, idx = self.read(e, qids, False)
        idx = self._compare_read(False, sims, idx)
        ptr_snap = self.ptr

        groups, reprobe = [], {}
        w, b = self.params["router_w"], self.params["router_b"]
        p_weak = torch.sigmoid(mm(e, w[:, None], self.cast)[:, 0] + b).cpu()
        for i in range(B):
            s = float(sims[i, 0])
            hit = s >= thr
            if forced is not None and abs(s - thr) < TIE:
                hit = float(forced.reads[0][1][i, 0]) >= thr
                self.checks.ties_followed += 1
            if hit:
                row = self._row(int(idx[i, 0]))
                if row["hard"]:
                    if nows[i] - row["added_at"] < self.r["reprobe_period"]:
                        grp = "hard"
                    else:
                        grp, reprobe[i] = "shadow", int(idx[i, 0])
                else:
                    grp = "guide" if row["has_guide"] else "skill"
            else:
                p = float(p_weak[i])
                weak = p >= 0.5
                if forced is not None and abs(p - 0.5) < TIE:
                    weak = forced.outcomes[i][3] == "router_weak"
                    self.checks.ties_followed += 1
                grp = "router" if weak else "shadow"
            if forced is not None:
                theirs = GROUP_OF_CASE.get(forced.outcomes[i][3], "shadow")
                if theirs != grp:
                    self.checks.route_miss += 1
                    self.checks.note(f"request {i}: group {theirs} against "
                                     f"{grp} (sim {s:.7f})")
            groups.append(grp)

        outs = self.log.outcomes
        hard = [i for i in range(B) if groups[i] == "hard"]
        shadow = [i for i in range(B) if groups[i] == "shadow"]
        items = []
        if hard or shadow:
            ans = self.answers("strong", [prompts[i] for i in hard + shadow])
            for i, a in zip(hard, ans):
                outs[i] = (a, "strong", 1, "memory_hard", None)
            for i, a in zip(shadow, ans[len(hard):]):
                items.append({"i": i, "now": nows[i], "prompt": prompts[i],
                              "greq": greqs[i], "emb": e[i],
                              "strong_ans": a, "reprobe": reprobe.get(i),
                              "strong_calls": 1})
        serve, tags = [], []
        for i in range(B):
            if groups[i] == "guide":
                row = [self._row(int(x)) for x in idx[i, :self.k]]
                gs = select_guides(sims[i, :self.k], [r["has_guide"] for r in row],
                                   [r["guide"] for r in row], thr,
                                   self.r["max_guides"], pad)
                serve.append(splice(prompts[i], gs, pad))
                tags.append(i)
        for grp in ("skill", "router"):
            for i in range(B):
                if groups[i] == grp:
                    serve.append(prompts[i])
                    tags.append(i)
        if serve:
            for i, a in zip(tags, self.answers("weak", serve)):
                case = {"guide": "memory_guide", "skill": "memory_skill",
                        "router": "router_weak"}[groups[i]]
                outs[i] = (a, "weak", 0, case,
                           "memory" if groups[i] == "guide" else None)
        if items:
            self._drain(items, ptr_snap)
        if forced is not None:
            for i in range(B):
                if tuple(forced.outcomes[i]) != tuple(outs[i]):
                    self.checks.outcome_miss += 1
                    self.checks.note(f"outcome {i}: {forced.outcomes[i]} "
                                     f"against {outs[i]}")
            if self._call_i != len(forced.calls) or \
                    self._read_i != len(forced.reads):
                self.checks.call_miss += 1
                raise Diverged("the system made calls the reference did not")
        return self.log

    # -- the shadow pass, one epoch ---------------------------------------
    def _drain(self, items, ptr_snap):
        pad = self.v["PAD"]
        gthr = self.r["guide_sim_threshold"]
        empty = np.zeros(self.G, np.int32)
        staged, softs, touches = [], [], []

        def aligned(a, it):
            return a == it["strong_ans"] and a >= 0

        def settle(it, stage, guide):
            rp = it["reprobe"] is not None
            case, src = {"case1": ("case1_reprobe" if rp else "case1", None),
                         "case2a": ("case2", "memory"),
                         "case2b": ("case2", "fresh"),
                         "case3": ("case3", None)}[stage]
            if stage != "case3" or not rp:
                staged.append((it["now"], it["emb"], np.asarray(guide, np.int32),
                               stage in ("case2a", "case2b"), stage == "case3"))
            if rp and stage != "case3":
                softs.append((it["reprobe"], ptr_snap))
            if rp and stage == "case3":
                touches.append((it["now"], it["reprobe"], ptr_snap))
            self.log.outcomes[it["i"]] = (it["strong_ans"], "strong",
                                          it["strong_calls"], case, src)

        pending = []
        for it, a in zip(items, self.answers("weak", [it["prompt"]
                                                      for it in items])):
            if aligned(a, it):
                settle(it, "case1", empty)
            else:
                pending.append(it)
        still = []
        if pending:
            embs = torch.stack([it["emb"] for it in pending])
            gs_, gi = self.read(embs, None, True)
            gi = self._compare_read(True, gs_, gi)
            probes, probe_items, probe_guides = [], [], []
            for j, it in enumerate(pending):
                if gs_[j, 0] >= gthr:
                    row = [self._row(int(x)) for x in gi[j, :self.k]]
                    guides = select_guides(gs_[j, :self.k],
                                           [r["has_guide"] for r in row],
                                           [r["guide"] for r in row], gthr,
                                           self.r["max_guides"], pad)
                    probes.append(splice(it["prompt"], guides, pad))
                    probe_items.append(it)
                    probe_guides.append(guides[0])
                else:
                    still.append(it)
            if probes:
                for it, g, a in zip(probe_items, probe_guides,
                                    self.answers("weak", probes)):
                    if aligned(a, it):
                        settle(it, "case2a", g)
                    else:
                        still.append(it)
            still.sort(key=lambda it: it["now"])
        failed = []
        if still:
            hints = self._served("strong", [it["greq"] for it in still], 2)
            fresh = []
            for it, h in zip(still, hints):
                it["strong_calls"] += 1
                g = np.full(self.G, pad, np.int32)
                g[0], g[1:3], g[3] = self.v["GUIDE_START"], h, self.v["GUIDE_END"]
                fresh.append(g)
            for it, g, a in zip(still, fresh, self.answers(
                    "weak", [splice(it["prompt"], [g], pad)
                             for it, g in zip(still, fresh)])):
                if aligned(a, it):
                    settle(it, "case2b", g)
                else:
                    failed.append(it)
        for it in failed:
            settle(it, "case3", empty)
        self._apply(staged, softs, touches)

    def _apply(self, staged, softs, touches):
        staged.sort(key=lambda r: r[0])
        base, end = self.ptr, self.ptr + len(staged)

        def evicted(slot, snap):
            snap = min(snap, base)
            covered = end - snap
            return covered >= self.C or (slot - snap) % self.C < covered

        for now, emb, guide, has_guide, hard in staged:
            slot = self.ptr % self.C
            if self.ptr >= self.C:
                raise Diverged("the ring wrapped onto the filler rows, "
                               "which the reference does not evict")
            self.rows[slot] = {"emb": emb, "guide": guide,
                               "has_guide": has_guide, "hard": hard,
                               "added_at": now}
            self.ptr += 1
        for slot in sorted({s for s, snap in softs if not evicted(s, snap)}):
            if slot in self.rows:
                self.rows[slot]["hard"] = False
        last = {}
        for now, slot, snap in sorted(touches, key=lambda t: t[:2]):
            if not evicted(slot, snap):
                last[slot] = now
        for slot, now in last.items():
            if slot in self.rows:
                self.rows[slot]["added_at"] = now

    # -- the end of a run ----------------------------------------------------
    def compare_store(self, theirs: dict) -> None:
        """Hold the system's learned rows (slot -> emb, guide, has_guide,
        hard, added_at) to the reference's."""
        c = self.checks
        if set(theirs) != set(self.rows):
            c.store_meta_miss += len(set(theirs) ^ set(self.rows))
            c.note(f"store: {len(theirs)} learned rows against "
                   f"{len(self.rows)}")
        for slot in sorted(set(theirs) & set(self.rows)):
            a, b = theirs[slot], self.rows[slot]
            c.store_emb_err = max(c.store_emb_err, float(np.abs(
                np.asarray(a["emb"]) - b["emb"].cpu().numpy()).max()))
            if not (np.array_equal(a["guide"], b["guide"]) and
                    bool(a["has_guide"]) == bool(b["has_guide"]) and
                    bool(a["hard"]) == bool(b["hard"]) and
                    int(a["added_at"]) == int(b["added_at"])):
                c.store_meta_miss += 1
                c.note(f"store slot {slot}: flags or guide differ")

    def learned_rows(self) -> dict:
        return {s: {"emb": r["emb"].cpu().numpy(), "guide": r["guide"],
                    "has_guide": r["has_guide"], "hard": r["hard"],
                    "added_at": r["added_at"]} for s, r in self.rows.items()}


def filler_top(u_embs: torch.Tensor, chunks, k1: int, cast=f32):
    """The best ``k1`` filler rows (sim desc, row asc) of each universe
    question: ``chunks`` yields (first row, rows (R, E)) in row order.
    Returns host tensors (U, k1) of sims and rows."""
    best_s = torch.full((u_embs.shape[0], k1), -2.0, device=u_embs.device)
    best_i = torch.zeros((u_embs.shape[0], k1), dtype=torch.int64,
                         device=u_embs.device)
    for first, rows in chunks:
        s = mm(u_embs, rows.T, cast)
        v, j = torch.topk(s, min(k1, s.shape[1]), dim=1)
        s_all = torch.cat([best_s, v], 1)
        i_all = torch.cat([best_i, j + first], 1)
        o = torch.argsort(i_all, dim=1, stable=True)
        s_all, i_all = s_all.gather(1, o), i_all.gather(1, o)
        o = torch.argsort(-s_all, dim=1, stable=True)[:, :k1]
        best_s, best_i = s_all.gather(1, o), i_all.gather(1, o)
    return best_s.cpu(), best_i.cpu()
