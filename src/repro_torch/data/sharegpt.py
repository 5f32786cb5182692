"""ShareGPT-style prompt loading with an offline byte-level tokenizer.

The paper trains DVI on 2,000 ShareGPT prompts.  This container has no
network access and no HF tokenizers, so we provide: (a) a JSONL loader for
a local ShareGPT dump if one exists, and (b) a deterministic byte-level
tokenizer that hashes UTF-8 bytes into the model vocabulary — enough to
drive the online-learning pipeline with real-text-shaped streams.

Port of ``repro.data.sharegpt``, numpy only, copied line for line.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np


class ByteTokenizer:
    """Bytes -> vocab ids (2..vocab).  0 = pad, 1 = eos."""

    def __init__(self, vocab_size: int):
        self.vocab = vocab_size

    def encode(self, text: str, max_len: Optional[int] = None) -> np.ndarray:
        b = np.frombuffer(text.encode("utf-8"), np.uint8).astype(np.int64)
        ids = 2 + (b * 2654435761 % (self.vocab - 2))
        if max_len is not None:
            ids = ids[:max_len]
        return ids.astype(np.int32)


def load_sharegpt_prompts(path: str, n: int, tokenizer: ByteTokenizer,
                          prompt_len: int = 64) -> Optional[np.ndarray]:
    """Load n prompts from a ShareGPT JSONL/JSON dump; None if absent."""
    if not os.path.exists(path):
        return None
    prompts: List[np.ndarray] = []
    with open(path) as f:
        if path.endswith(".jsonl"):
            records = (json.loads(line) for line in f)
        else:
            records = json.load(f)
        for rec in records:
            convs = rec.get("conversations", [])
            text = " ".join(c.get("value", "") for c in convs
                            if c.get("from") in ("human", "user"))
            if not text:
                continue
            ids = tokenizer.encode(text, prompt_len)
            if len(ids) < prompt_len:
                continue
            prompts.append(ids)
            if len(prompts) >= n:
                break
    if not prompts:
        return None
    return np.stack(prompts)
