"""Continuous-batching serving over the port's decode API."""
from repro_torch.serving.server import Request, ServingEngine

__all__ = ["Request", "ServingEngine"]
