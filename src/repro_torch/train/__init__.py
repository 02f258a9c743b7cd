"""Training of the port's LM families: loss, AdamW, the train step.  Port
of ``src/repro/train``."""
from .loss import lm_loss
from .optim import AdamWConfig, OptState, init, lr_schedule, update
from .step import make_decode_step, make_prefill_step, make_train_step

__all__ = ["lm_loss", "AdamWConfig", "OptState", "init", "lr_schedule",
           "update", "make_train_step", "make_prefill_step",
           "make_decode_step"]
