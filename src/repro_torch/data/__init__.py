"""Prompt and token streams: the synthetic task suite and the ShareGPT
loader, numpy-only copies of ``repro.data``."""
from repro_torch.data.synthetic import SyntheticTasks, TASK_CATEGORIES
from repro_torch.data.sharegpt import load_sharegpt_prompts, ByteTokenizer

__all__ = ["SyntheticTasks", "TASK_CATEGORIES", "load_sharegpt_prompts",
           "ByteTokenizer"]
