"""The port's fault tolerance (`fault_tolerance.py`): failure injection,
straggler detection and the checkpoint-restart supervisor."""
from repro_torch.distributed.fault_tolerance import (  # noqa: F401
    ElasticPlan, FailureInjector, StragglerDetector, StragglerEvent,
    Supervisor, WorkerFailure)
