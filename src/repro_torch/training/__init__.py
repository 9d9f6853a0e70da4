"""The port's training: AdamW steps of a model under autograd
(`step.py`) and the fault-tolerant loop around them (`loop.py`)."""
from repro_torch.training.step import (abstract_train_state,  # noqa: F401
                                       init_train_state, make_decode_step,
                                       make_prefill_step, make_train_step,
                                       trainable)
