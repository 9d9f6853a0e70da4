"""The port's training step: AdamW steps of a model under autograd."""
from repro_torch.training.step import (init_train_state,  # noqa: F401
                                       make_decode_step, make_prefill_step,
                                       make_train_step, trainable)
