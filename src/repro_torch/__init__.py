"""PyTorch/CUDA port of the DVI reproduction, for one NVIDIA H100.

This package grows beside the JAX package ``repro`` until it does what that
package does.  It serves greedy DVI (prefill, speculative blocks of K+1
shallow draft feeds plus one deep verify pass, tuple logging) through two
schedulers, the batch-synchronous one and the continuous-batching one over
a paged KV pool (or a contiguous per-lane cache), on dense decoders
(vicuna-7b, qwen3-0.6b) and on the attention-free Mamba-2 stack
(mamba2-370m).  Its five hot functions run on hand-written CUDA kernels
for ``sm_90a``:

* ``lora_logits``            — the LoRA draft head, once per draft feed;
* ``verify_argmax``          — the verifier's greedy tokens, once per block;
* ``decode_attention``       — every attention layer of the feeds and the
  verify over a contiguous cache;
* ``paged_decode_attention`` — the same over the paged pool;
* ``ssd_scan``               — the Mamba-2 chunked scan of every prefill.

Ground rules
------------
* The JAX package is the reference and is never edited; the port is held
  against it by ``tests/test_torch_*.py`` on the same configs and weights.
* The port imports ``torch`` and never ``jax``, and nothing of ``repro``
  (not even modules that do not import JAX): it keeps its own copy of the
  config dataclasses in ``repro_torch.configs``.
* Entry points run on the card unless the caller asks for the CPU
  (``device="cpu"``); with no GPU and no explicit ``"cpu"`` they raise.
  Nothing falls back to the CPU on its own.  On a CPU tensor a kernel
  wrapper in ``repro_torch.kernels.ops`` runs the kernel's plain PyTorch
  version; on a CUDA tensor it launches the kernel or raises.
* Weights keep the JAX layout ``x @ W`` with W stored ``(d_in, d_out)``, so
  the weight bridge (``repro_torch.weights``) is a straight copy and the
  kernels see ``w (d, V)`` exactly as the Pallas kernels do.
* KV caches are updated in place: speculative rollback is length
  truncation, and no caller reuses an old cache after a step.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Raises when no GPU is present and the caller did not ask for
    the CPU explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "port's plain PyTorch path on the CPU")
    return dev
