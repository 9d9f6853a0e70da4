"""The port's model stack (dense family): parameter specs, layers, the
decoder assembly and the `Model` API."""
from repro_torch.models.model import Model, build_model  # noqa: F401
