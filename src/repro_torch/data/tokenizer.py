"""Token vocabulary for the synthetic MCQ task suite (the MMLU analog).

Layout (contiguous blocks, all ids static given a config):

    0  PAD        5  GUIDE_START
    1  BOS        6  GUIDE_END
    2  EOS        7  GUIDE_REQ     (guide-request marker for the strong FM)
    3  SEP        8..11  A B C D   (answer options)
    4  ANS        12..21 digits 0-9
    22..22+D-1             domain tokens
    next 16                skill-surface alphabet (skills render as 3 tokens)
    next 4                 hint tokens H_ALPHA_0..3
    next 4                 hint tokens H_BETA_0..3

Guides encode a skill's latent rule (α, β) as hint tokens — instructions
that help answer *any* question of that skill but never contain the answer
itself, mirroring §III-E of the paper.
"""
from __future__ import annotations

import dataclasses

PAD, BOS, EOS, SEP, ANS, GUIDE_START, GUIDE_END, GUIDE_REQ = range(8)
OPTION_A = 8          # .. 11
DIGIT_0 = 12          # .. 21

SKILL_ALPHABET = 16
SKILL_RENDER_LEN = 3


@dataclasses.dataclass(frozen=True)
class Vocab:
    n_domains: int = 3

    @property
    def domain_0(self) -> int:
        return 22

    @property
    def skill_0(self) -> int:
        return self.domain_0 + self.n_domains

    @property
    def h_alpha_0(self) -> int:
        return self.skill_0 + SKILL_ALPHABET

    @property
    def h_beta_0(self) -> int:
        return self.h_alpha_0 + 4

    @property
    def size(self) -> int:
        # round up to a multiple of 64 for MXU-friendly unembed shapes
        raw = self.h_beta_0 + 4
        return ((raw + 63) // 64) * 64

    # ------------------------------------------------------------------
    def render_skill(self, skill_id: int) -> list[int]:
        toks = []
        for _ in range(SKILL_RENDER_LEN):
            toks.append(self.skill_0 + skill_id % SKILL_ALPHABET)
            skill_id //= SKILL_ALPHABET
        return toks

    def render_operand(self, x: int) -> list[int]:
        # base-split rendering: second token IS x mod 4 (the rule-relevant
        # feature); first token x // 4 varies questions within a skill.
        return [DIGIT_0 + (x // 4) % 10, DIGIT_0 + x % 4]

    def question(self, domain: int, skill_id: int, x: int,
                 guide: list[int] | None = None) -> list[int]:
        """Token sequence ending in ANS; the answer token follows it."""
        toks = [BOS]
        if guide:
            toks += guide
        toks += [self.domain_0 + domain]
        toks += self.render_skill(skill_id)
        toks += [SEP] + self.render_operand(x) + [SEP, ANS]
        return toks

    def guide_tokens(self, alpha: int, beta: int) -> list[int]:
        return [GUIDE_START, self.h_alpha_0 + alpha, self.h_beta_0 + beta,
                GUIDE_END]

    def guide_request(self, domain: int, skill_id: int) -> list[int]:
        """Prompt for the strong FM's guide-generation mode."""
        return ([BOS, GUIDE_REQ, self.domain_0 + domain]
                + self.render_skill(skill_id) + [SEP])

    def answer_token(self, answer_idx: int) -> int:
        return OPTION_A + answer_idx
