"""Fault handling for serving and training (counterpart of
``repro/runtime/fault.py``); pure logic, no device:

  * ``StragglerMonitor`` — per-host step-time EWMA; hosts beyond
    ``sigma`` robust deviations of the fleet are flagged. ``TrainLoop``
    records its own steps; with one process the fleet has one host, so
    nothing is ever flagged.
  * ``plan_remesh`` / ``plan_replica_remesh`` — the largest mesh that
    survives a loss of devices. The port runs on one device, so the serving
    engine's ``device_lost`` site always finds no factorization (0
    surviving devices) and gives up; the plans themselves are what a
    multi-GPU engine will consult.
  * ``PreemptionGuard`` — SIGTERM sets ``requested``; the serving engine
    then checkpoints and raises ``Preempted``, the train loop saves.
"""
from __future__ import annotations

import dataclasses
import signal
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class HostStats:
    ewma: float = 0.0
    n: int = 0


class StragglerMonitor:
    """Flags hosts whose step time drifts above the fleet's."""

    def __init__(self, alpha: float = 0.2, sigma: float = 3.0,
                 min_samples: int = 8):
        self.alpha = alpha
        self.sigma = sigma
        self.min_samples = min_samples
        self.hosts: Dict[int, HostStats] = {}

    def record(self, host: int, step_time: float) -> None:
        st = self.hosts.setdefault(host, HostStats())
        st.ewma = (step_time if st.n == 0
                   else (1 - self.alpha) * st.ewma + self.alpha * step_time)
        st.n += 1

    def fleet_stats(self) -> Tuple[float, float]:
        """Robust (median, MAD) over the hosts with ``min_samples`` steps:
        a straggler must not inflate its own threshold. An even fleet takes
        the upper median, ``sorted[n // 2]``."""
        vals = sorted(s.ewma for s in self.hosts.values()
                      if s.n >= self.min_samples)
        if len(vals) < 2:
            return 0.0, 0.0
        med = vals[len(vals) // 2]
        mad = sorted(abs(v - med) for v in vals)[len(vals) // 2]
        return med, mad

    def stragglers(self) -> List[int]:
        med, mad = self.fleet_stats()
        if med == 0.0:
            return []
        floor = max(1.4826 * mad, 0.05 * med)   # MAD -> sigma, noise floor
        return [h for h, s in self.hosts.items()
                if s.n >= self.min_samples and
                s.ewma > med + self.sigma * floor]


def plan_remesh(alive_devices: int, model_parallel: int, pods: int = 1,
                pod_alive: Optional[Tuple[int, ...]] = None
                ) -> Optional[Tuple[int, ...]]:
    """Largest usable mesh after failures.

    Keeps the TP degree fixed and shrinks data parallelism. A TP group
    cannot straddle pods, so each pod contributes ``pod_alive //
    model_parallel`` groups; a multi-pod mesh keeps the pods that still hold
    a group, at the least group count among them. ``pod_alive`` gives each
    pod's survivors; without it they are spread evenly (the remainder on
    the leading pods). One usable pod gives a (data, model) mesh; none
    gives None.
    """
    if pod_alive is None:
        base, extra = divmod(alive_devices, pods)
        pod_alive = tuple(base + (1 if p < extra else 0)
                          for p in range(pods))
    groups = [a // model_parallel for a in pod_alive]
    usable = [g for g in groups if g >= 1]
    if not usable:
        return None
    if len(pod_alive) > 1 and len(usable) > 1:
        return (len(usable), min(usable), model_parallel)
    return (max(groups), model_parallel)


def plan_replica_remesh(alive_devices: int,
                        model_parallel: int) -> Optional[int]:
    """Largest TP degree one serving replica can rebuild to after losing
    devices: the divisors of its degree, from the largest that fits the
    survivors down, each accepted when ``plan_remesh`` finds a mesh. 1 is
    unsharded; None means no device survives."""
    if alive_devices < 1:
        return None
    for tp in range(min(alive_devices, model_parallel), 0, -1):
        if model_parallel % tp:
            continue
        if plan_remesh(alive_devices, tp) is not None:
            return tp
    return None


class PreemptionGuard:
    """SIGTERM -> ``requested``, so a final checkpoint is taken before the
    scheduler kills the process.

    One process can hold several guards (a serving engine's, a train
    loop's): ``install`` is idempotent per guard, the handler chains to the
    one it replaced, and ``uninstall`` restores that one, so guards nest.
    ``signal.signal`` works only in the main thread.
    """

    def __init__(self):
        self.requested = False
        self._prev = None
        self._installed = False

    def install(self) -> None:
        if self._installed:
            return

        def handler(signum, frame):
            self.requested = True
            if callable(self._prev):
                self._prev(signum, frame)
        self._prev = signal.signal(signal.SIGTERM, handler)
        self._installed = True

    def uninstall(self) -> None:
        """Restore the SIGTERM handler from before ``install``; a no-op if
        not installed."""
        if not self._installed:
            return
        prev = self._prev if self._prev is not None else signal.SIG_DFL
        signal.signal(signal.SIGTERM, prev)
        self._prev = None
        self._installed = False

    def should_save(self) -> bool:
        return self.requested
