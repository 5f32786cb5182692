from repro_torch.checkpoint.ckpt import (save_checkpoint, load_checkpoint,
                                         save_lora, load_lora)

__all__ = ["save_checkpoint", "load_checkpoint", "save_lora", "load_lora"]
