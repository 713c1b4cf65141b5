"""Continuous-batching serving over the port's decode API, with its fault
tolerance (``resilience``). The replica pool is not ported yet (ROADMAP:
multi-GPU)."""
from repro_torch.serving.resilience import (Backoff, FaultEvent, FaultLog,
                                            LoadShedPolicy, PoolHealth,
                                            Preempted, ServingFault,
                                            VictimInfo, VictimPolicy)
from repro_torch.serving.server import Request, ServingEngine

__all__ = ["Backoff", "FaultEvent", "FaultLog", "LoadShedPolicy",
           "PoolHealth", "Preempted", "Request", "ServingEngine",
           "ServingFault", "VictimInfo", "VictimPolicy"]
