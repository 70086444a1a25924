from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            init_opt_state, lr_schedule)
from repro_torch.training.train_step import make_train_step
from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint

__all__ = ["AdamWConfig", "adamw_update", "init_opt_state", "lr_schedule",
           "make_train_step", "load_checkpoint", "save_checkpoint"]
