"""LM training: AdamW with optional int8 moments, the train step with
microbatches, the int8 error-feedback gradient reduction. Counterpart of
``repro.train``."""
from repro_torch.train.optim import (OptConfig, OptState, adamw_update,
                                     init_opt_state)
from repro_torch.train.train_loop import make_train_step, train_many

__all__ = ["OptConfig", "OptState", "adamw_update", "init_opt_state",
           "make_train_step", "train_many"]
