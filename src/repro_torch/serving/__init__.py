"""Serving substrate of the port: the batched KV-cache decode engine and the
hardened front end (continuous batching, fault injection, numeric watchdog
with graceful degradation to the unpaired exact path)."""

from repro_torch.serving.engine import INACTIVE_TOKEN, CapacityError, ServeEngine  # noqa: F401
from repro_torch.serving.faults import (  # noqa: F401
    FAULT_KINDS,
    SLOT_FAULTS,
    FaultEvent,
    FaultInjector,
    KernelFault,
)
from repro_torch.serving.frontend import (  # noqa: F401
    FrontendConfig,
    Request,
    ServeFrontend,
    ServeReport,
    faulted_request_ids,
    poisson_workload,
)
from repro_torch.serving.guards import (  # noqa: F401
    GuardConfig,
    Incident,
    IncidentLog,
    NumericWatchdog,
    check_logits,
)
