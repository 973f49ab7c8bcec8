"""Serving substrate of the port: the batched KV-cache decode engine."""

from repro_torch.serving.engine import INACTIVE_TOKEN, CapacityError, ServeEngine  # noqa: F401
