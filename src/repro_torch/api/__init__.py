"""Decode API of the port: Engine → DecodeSession → StepResult."""
from repro_torch.api.session import DecodeSession, Engine
from repro_torch.api.strategies import (DecodeStrategy, DenseStrategy,
                                        SpecEEStrategy, get_strategy)
from repro_torch.api.types import StepResult

__all__ = ["DecodeSession", "DecodeStrategy", "DenseStrategy", "Engine",
           "SpecEEStrategy", "StepResult", "get_strategy"]
