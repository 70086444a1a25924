"""Synthetic MCQ task suite — the MMLU analog driving the RAR evaluation.

Causal structure (matches what the paper's method exploits):

* A universe of **skills**; skill ``s`` is a latent affine rule
  ``answer = (α_s · (x mod 4) + β_s) mod 4`` over a visible operand ``x``.
* Questions are (domain, skill, x) rendered to tokens. Many questions share
  one skill → a *guide* that reveals (α_s, β_s) helps **every** question of
  that skill (the paper's intra-domain generalization), and only questions
  of that skill (guides are domain/skill-specific, §III-E).
* Domains own disjoint skill blocks except for a small **shared** fraction
  → weak inter-domain transfer, as in Table I.
* The **weak FM** is trained to solve a subset of skills unaided and to
  exploit guide hints in-context for any skill; the **strong FM** solves
  all skills and can emit a skill's guide on request. Both are real
  transformers trained with the framework's own train loop — the in-context
  uplift is learned, not simulated.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data import tokenizer as tk
from repro_torch.data.tokenizer import Vocab


@dataclasses.dataclass(frozen=True)
class TaskSuiteConfig:
    n_domains: int = 3
    skills_per_domain: int = 48
    shared_skills: int = 5        # per domain, drawn from a common pool
    weak_known_frac: float = 0.25  # skills the weak FM solves unaided
    guide_train_frac: float = 0.8  # skills used to teach guide-following
    max_operand: int = 40
    seq_len: int = 16              # padded question length (answer at ANS+1)
    seed: int = 0

    @property
    def total_skills(self) -> int:
        return self.n_domains * self.skills_per_domain + self.shared_skills


class TaskSuite:
    def __init__(self, cfg: TaskSuiteConfig = TaskSuiteConfig()):
        self.cfg = cfg
        self.vocab = Vocab(cfg.n_domains)
        rng = np.random.default_rng(cfg.seed)
        n = cfg.total_skills
        self.alpha = rng.integers(1, 4, n)   # α ∈ {1,2,3}: answer depends on x
        self.beta = rng.integers(0, 4, n)
        # domain → skill ids. The last `shared_skills` ids are in every domain.
        shared = np.arange(n - cfg.shared_skills, n)
        self.domain_skills = [
            np.concatenate([np.arange(d * cfg.skills_per_domain,
                                      (d + 1) * cfg.skills_per_domain),
                            shared])
            for d in range(cfg.n_domains)
        ]
        # weak FM's unaided skills: a per-domain prefix slice
        known = []
        for d in range(cfg.n_domains):
            ds = self.domain_skills[d]
            k = int(len(ds) * cfg.weak_known_frac)
            known.extend(ds[:k].tolist())
        self.weak_known = np.asarray(sorted(set(known)))
        # skills used to *teach* guide-following (weak FM sees guided
        # examples only for these; eval skills outside this set test the
        # learned in-context ability, not memorization)
        rest = np.setdiff1d(np.arange(n), self.weak_known)
        rng.shuffle(rest)
        k = int(len(rest) * cfg.guide_train_frac)
        self.guide_train_skills = np.asarray(sorted(rest[:k]))

    # ------------------------------------------------------------------
    def answer(self, skill_id: int, x: int) -> int:
        # the rule consumes the mod-4 feature of the operand (matches the
        # operand rendering — one token carries x % 4)
        return int((self.alpha[skill_id] * (x % 4) + self.beta[skill_id]) % 4)

    def guide(self, skill_id: int) -> list[int]:
        return self.vocab.guide_tokens(int(self.alpha[skill_id]),
                                       int(self.beta[skill_id]))

    def domain_of(self, skill_id: int) -> int:
        for d in range(self.cfg.n_domains):
            if skill_id in self.domain_skills[d]:
                return d
        raise KeyError(skill_id)

    # ------------------------------------------------------------------
    # Example encoders (fixed length, LM-style: labels = -1 off the answer)
    # ------------------------------------------------------------------
    def encode(self, domain: int, skill_id: int, x: int, *,
               guide: list[int] | None = None
               ) -> tuple[np.ndarray, np.ndarray]:
        toks = self.vocab.question(domain, skill_id, x, guide)
        ans = self.vocab.answer_token(self.answer(skill_id, x))
        seq = toks + [ans, tk.EOS]
        L = self.cfg.seq_len
        assert len(seq) <= L, (len(seq), L)
        tokens = np.full(L, tk.PAD, np.int32)
        labels = np.full(L, -1, np.int32)
        tokens[:len(seq)] = seq
        # next-token labels at every real position; answer is what matters
        labels[:len(seq) - 1] = seq[1:]
        labels[:len(toks) - 1] = -1            # only answer + EOS supervised
        return tokens, labels

    def encode_guide_gen(self, domain: int, skill_id: int
                         ) -> tuple[np.ndarray, np.ndarray]:
        """Strong-FM guide generation: prompt → hint tokens."""
        prompt = self.vocab.guide_request(domain, skill_id)
        target = [self.vocab.h_alpha_0 + int(self.alpha[skill_id]),
                  self.vocab.h_beta_0 + int(self.beta[skill_id]), tk.EOS]
        seq = prompt + target
        L = self.cfg.seq_len
        tokens = np.full(L, tk.PAD, np.int32)
        labels = np.full(L, -1, np.int32)
        tokens[:len(seq)] = seq
        labels[len(prompt) - 1:len(seq) - 1] = seq[len(prompt):]
        return tokens, labels

    # ------------------------------------------------------------------
    # Training corpora
    # ------------------------------------------------------------------
    def weak_train_batch(self, rng: np.random.Generator, batch: int
                         ) -> dict[str, np.ndarray]:
        """Mix: unaided examples of known skills + guided examples of
        guide-train skills (teaches hint-following that generalizes)."""
        toks, labs = [], []
        for _ in range(batch):
            if rng.random() < 0.5:
                s = int(rng.choice(self.weak_known))
                g = None
            else:
                s = int(rng.choice(self.guide_train_skills))
                g = self.guide(s)
            d = self.domain_of(s)
            x = int(rng.integers(0, self.cfg.max_operand))
            t, l = self.encode(d, s, x, guide=g)
            toks.append(t)
            labs.append(l)
        return {"tokens": np.stack(toks), "labels": np.stack(labs)}

    def strong_train_batch(self, rng: np.random.Generator, batch: int
                           ) -> dict[str, np.ndarray]:
        """Unaided examples of ALL skills + guide-generation examples."""
        toks, labs = [], []
        for _ in range(batch):
            s = int(rng.integers(0, self.cfg.total_skills))
            d = self.domain_of(s)
            if rng.random() < 0.25:
                t, l = self.encode_guide_gen(d, s)
            else:
                x = int(rng.integers(0, self.cfg.max_operand))
                t, l = self.encode(d, s, x)
            toks.append(t)
            labs.append(l)
        return {"tokens": np.stack(toks), "labels": np.stack(labs)}

    def _neighbor_skill(self, s: int, rng: np.random.Generator) -> int:
        """A skill whose surface render differs in one base-16 digit —
        the hardest negatives for the contrastive objective."""
        from repro_torch.data.tokenizer import SKILL_ALPHABET
        for _ in range(8):
            digit = int(rng.integers(0, 2))
            delta = int(rng.integers(1, SKILL_ALPHABET)) * \
                (SKILL_ALPHABET ** digit)
            cand = (s + delta) % self.cfg.total_skills
            if cand != s:
                return cand
        return (s + 1) % self.cfg.total_skills

    def embedder_batch(self, rng: np.random.Generator, batch: int
                       ) -> tuple[np.ndarray, np.ndarray]:
        """(tokens (2B, L), skill ids (2B,)): consecutive pairs share a
        skill — positives for the contrastive objective. Half the anchors
        bring a near-id *hard negative* skill into the same batch so that
        surface-similar skills are pushed apart."""
        toks, sids = [], []

        def add_pair(s: int):
            d = self.domain_of(s)
            for _ in range(2):
                x = int(rng.integers(0, self.cfg.max_operand))
                t, _ = self.encode(d, s, x)
                toks.append(t)
                sids.append(s)

        while len(sids) < 2 * batch:
            s = int(rng.integers(0, self.cfg.total_skills))
            add_pair(s)
            if rng.random() < 0.5 and len(sids) < 2 * batch:
                add_pair(self._neighbor_skill(s, rng))
        return np.stack(toks), np.asarray(sids, np.int32)

    # ------------------------------------------------------------------
    # Evaluation pools (the paper's "failing samples" subsets)
    # ------------------------------------------------------------------
    def question_pool(self, domain: int, n: int, seed: int
                      ) -> list[tuple[int, int, int]]:
        """n distinct (domain, skill, x) questions from one domain."""
        rng = np.random.default_rng(seed)
        out = []
        seen = set()
        ds = self.domain_skills[domain]
        while len(out) < n:
            s = int(rng.choice(ds))
            x = int(rng.integers(0, self.cfg.max_operand))
            if (s, x) in seen:
                continue
            seen.add((s, x))
            out.append((domain, s, x))
        return out
