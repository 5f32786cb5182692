from repro_torch.training.pretrain import (init_pretrain_state, lm_loss, loss_and_grads,
                                           make_dvi_train_step, make_pretrain_step, pretrain)

__all__ = ["init_pretrain_state", "lm_loss", "loss_and_grads", "make_dvi_train_step",
           "make_pretrain_step", "pretrain"]
