"""The port's model stack (dense and MoE families): parameter specs,
layers, the decoder assembly, the losses and the `Model` API."""
from repro_torch.models.model import Model, build_model  # noqa: F401
