"""The RAR traffic's question universe, rendered from the configuration's
``suite`` and ``vocab`` (the synthetic MMLU analog the paper's system is
trained on): question ids, their prompts and guide requests as token
arrays. Shared by the traffic generator and the reference."""
from __future__ import annotations

import numpy as np


def domain_skills(suite: dict) -> list[np.ndarray]:
    """Skill ids of each domain: its own block, then the shared ones."""
    n, per, shared = (suite["n_domains"], suite["skills_per_domain"],
                      suite["shared_skills"])
    total = n * per + shared
    common = np.arange(total - shared, total)
    return [np.concatenate([np.arange(d * per, (d + 1) * per), common])
            for d in range(n)]


def _skill(vocab: dict, suite: dict, s: int) -> list[int]:
    skill_0 = vocab["domain_0"] + suite["n_domains"]
    out = []
    for _ in range(vocab["skill_render_len"]):
        out.append(skill_0 + s % vocab["skill_alphabet"])
        s //= vocab["skill_alphabet"]
    return out


def question(vocab: dict, suite: dict, d: int, s: int, x: int) -> np.ndarray:
    v = vocab
    return np.asarray([v["BOS"], v["domain_0"] + d, *_skill(v, suite, s),
                       v["SEP"], v["DIGIT_0"] + (x // 4) % 10,
                       v["DIGIT_0"] + x % 4, v["SEP"], v["ANS"]], np.int32)


def guide_request(vocab: dict, suite: dict, d: int, s: int) -> np.ndarray:
    v = vocab
    return np.asarray([v["BOS"], v["GUIDE_REQ"], v["domain_0"] + d,
                       *_skill(v, suite, s), v["SEP"]], np.int32)


class Universe:
    """Every (domain, skill, operand) question, numbered
    ``(d * skills_in_domain + j) * max_operand + x`` for the j-th skill of
    domain d."""

    def __init__(self, config: dict):
        self.vocab, self.suite = config["vocab"], config["suite"]
        self.skills = domain_skills(self.suite)
        self.per_domain = len(self.skills[0])
        self.n_operands = self.suite["max_operand"]
        self.prompts, self.guide_requests, self.triples = [], [], []
        for d, sk in enumerate(self.skills):
            for s in sk:
                greq = guide_request(self.vocab, self.suite, d, int(s))
                for x in range(self.n_operands):
                    self.prompts.append(question(self.vocab, self.suite, d,
                                                 int(s), x))
                    self.guide_requests.append(greq)
                    self.triples.append((d, int(s), x))

    def __len__(self) -> int:
        return len(self.prompts)

    def qid(self, d: np.ndarray, j: np.ndarray, x: np.ndarray) -> np.ndarray:
        return (d * self.per_domain + j) * self.n_operands + x

    def padded(self, qids=None) -> np.ndarray:
        """Prompts right-padded with PAD to the suite's ``seq_len``."""
        qids = range(len(self)) if qids is None else qids
        out = np.full((len(qids), self.suite["seq_len"]), self.vocab["PAD"],
                      np.int32)
        for r, q in enumerate(qids):
            p = self.prompts[int(q)]
            out[r, :len(p)] = p
        return out
