"""Synthetic task-structured prompt streams (Spec-Bench-like suite).

Six categories mirroring Spec-Bench (MT-Bench, Translation, Summarization,
QA, Math, RAG).  Each category is a seeded sparse Markov chain over a
category-specific token subrange, so categories have distinct local lexical
structure — drafters trained on one category's stream transfer imperfectly
to others, reproducing the paper's distribution-sensitivity discussion.

Port of ``repro.data.synthetic``, numpy only, copied line for line so that
both packages draw the same batches.  That includes ``sample``'s seed,
``hash((cat, seed))``: Python randomises string hashes per process, so the
streams repeat only within one process or under a fixed ``PYTHONHASHSEED``
(ROADMAP §3).
"""
from __future__ import annotations

import numpy as np

TASK_CATEGORIES = ("mt_bench", "translation", "summarization", "qa", "math", "rag")


class SyntheticTasks:
    def __init__(self, vocab_size: int, seed: int = 0, branching: int = 4):
        self.vocab = vocab_size
        self.rng = np.random.default_rng(seed)
        self.branching = branching
        # reserve 0 = pad, 1 = eos
        lo, hi = 2, vocab_size
        span = (hi - lo) // len(TASK_CATEGORIES)
        self.ranges = {}
        self.next_tokens = {}
        self.next_probs = {}
        for ci, cat in enumerate(TASK_CATEGORIES):
            r0 = lo + ci * span
            r1 = r0 + span
            self.ranges[cat] = (r0, r1)
            n = r1 - r0
            # sparse transition structure: each token has `branching` successors
            succ = self.rng.integers(0, n, size=(n, branching))
            probs = self.rng.dirichlet(np.ones(branching) * 0.5, size=n)
            self.next_tokens[cat] = succ
            self.next_probs[cat] = probs

    def sample(self, cat: str, batch: int, length: int, seed: int = 0) -> np.ndarray:
        r0, r1 = self.ranges[cat]
        n = r1 - r0
        rng = np.random.default_rng(hash((cat, seed)) % (1 << 31))
        out = np.zeros((batch, length), np.int64)
        cur = rng.integers(0, n, size=batch)
        succ, probs = self.next_tokens[cat], self.next_probs[cat]
        for t in range(length):
            out[:, t] = r0 + cur
            choice = np.array([rng.choice(self.branching, p=probs[c]) for c in cur])
            cur = succ[cur, choice]
        return out.astype(np.int32)

    def stream(self, cats, n_batches: int, batch: int, length: int, seed: int = 0):
        """Round-robin over categories; yields (B, length) int32 arrays."""
        for i in range(n_batches):
            cat = cats[i % len(cats)]
            yield self.sample(cat, batch, length, seed=seed * 100003 + i)
