"""Continuous-batching serving over the port's decode API, with its fault
tolerance (``resilience``) and the data-parallel replica pool
(``replica``)."""
from repro_torch.serving.resilience import (Backoff, FaultEvent, FaultLog,
                                            LoadShedPolicy, PoolHealth,
                                            Preempted, ServingFault,
                                            VictimInfo, VictimPolicy)
from repro_torch.serving.replica import PoolRequest, ReplicaPool
from repro_torch.serving.server import Request, ServingEngine

__all__ = ["Backoff", "FaultEvent", "FaultLog", "LoadShedPolicy",
           "PoolHealth", "PoolRequest", "Preempted", "ReplicaPool",
           "Request", "ServingEngine",
           "ServingFault", "VictimInfo", "VictimPolicy"]
