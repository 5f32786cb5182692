"""The port's copies of the data modules against the reference's, in one
process (``SyntheticTasks.sample`` seeds its generator with Python's
``hash``, which differs between processes): every synthetic batch and
stream array for array, the byte tokenizer, and the ShareGPT loader on a
small JSONL and a JSON file, and on a missing path.  Integer outputs, so
equality is exact."""
import json

import numpy as np
import pytest

from repro.data import ByteTokenizer as JByteTokenizer  # noqa: E402
from repro.data import SyntheticTasks as JSyntheticTasks  # noqa: E402
from repro.data import TASK_CATEGORIES as J_CATEGORIES  # noqa: E402
from repro.data import load_sharegpt_prompts as j_load  # noqa: E402
from repro_torch.data import ByteTokenizer, SyntheticTasks, TASK_CATEGORIES  # noqa: E402
from repro_torch.data import load_sharegpt_prompts  # noqa: E402


def test_categories_match():
    assert TASK_CATEGORIES == J_CATEGORIES


@pytest.mark.parametrize("vocab,seed", [(512, 0), (32000, 3), (50280, 0)])
def test_tables_match(vocab, seed):
    t, j = SyntheticTasks(vocab, seed=seed), JSyntheticTasks(vocab, seed=seed)
    assert t.ranges == j.ranges
    for cat in TASK_CATEGORIES:
        np.testing.assert_array_equal(t.next_tokens[cat], j.next_tokens[cat])
        np.testing.assert_array_equal(t.next_probs[cat], j.next_probs[cat])


@pytest.mark.parametrize("cat", TASK_CATEGORIES)
def test_sample_matches(cat):
    t, j = SyntheticTasks(512, seed=0), JSyntheticTasks(512, seed=0)
    for seed in (0, 5, 123):
        a, b = t.sample(cat, 3, 17, seed=seed), j.sample(cat, 3, 17, seed=seed)
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_stream_matches():
    t, j = SyntheticTasks(1000, seed=2), JSyntheticTasks(1000, seed=2)
    got = list(t.stream(TASK_CATEGORIES, 8, 4, 24, seed=9))
    want = list(j.stream(J_CATEGORIES, 8, 4, 24, seed=9))
    assert len(got) == len(want) == 8
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("text,max_len", [("hello, world", None), ("héllo ünïcode ✓", 5),
                                          ("", None)])
def test_tokenizer_matches(text, max_len):
    a = ByteTokenizer(32000).encode(text, max_len)
    b = JByteTokenizer(32000).encode(text, max_len)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


def _records():
    return [{"conversations": [{"from": "human", "value": "tell me about the sea " * 4},
                               {"from": "gpt", "value": "it is wet"}]},
            {"conversations": [{"from": "gpt", "value": "no human turn"}]},
            {"conversations": [{"from": "user", "value": "short"}]},
            {"conversations": [{"from": "user", "value": "a second long enough prompt " * 3}]}]


@pytest.mark.parametrize("suffix", [".jsonl", ".json"])
def test_sharegpt_loader_matches(tmp_path, suffix):
    path = tmp_path / f"sharegpt{suffix}"
    if suffix == ".jsonl":
        path.write_text("\n".join(json.dumps(r) for r in _records()))
    else:
        path.write_text(json.dumps(_records()))
    a = load_sharegpt_prompts(str(path), 5, ByteTokenizer(512), prompt_len=16)
    b = j_load(str(path), 5, JByteTokenizer(512), prompt_len=16)
    assert a.shape == b.shape == (2, 16)
    np.testing.assert_array_equal(a, b)


def test_sharegpt_loader_missing_path(tmp_path):
    assert load_sharegpt_prompts(str(tmp_path / "none.jsonl"), 4, ByteTokenizer(512)) is None
    assert j_load(str(tmp_path / "none.jsonl"), 4, JByteTokenizer(512)) is None
