"""Deterministic fault injection for the serving stack (counterpart of
``repro/runtime/faultinject.py``).

A ``FaultSchedule`` names *sites*, places in the serving path that consult
the injector, and the visit indices at which each site fails. A site is
consulted with ``fire(site)`` (count the visit, return whether to inject)
or ``check(site)`` (raise ``InjectedFault``); with no injector installed
every site is a no-op, so the serving path pays one global read per
consultation.

Sites:

  * ``dispatch``        — a megatick dispatch raises before the step runs
                          (before any write to the decode state, so the
                          engine's backoff retry re-issues it against
                          unchanged state);
  * ``finish_timeout``  — the watchdog declares an async megatick handle
                          wedged before its results are read (the results
                          are lost; the engine evicts and replays);
  * ``nan_logits``      — a megatick's emitted tokens are poisoned (the
                          engine's vocabulary-range check catches it);
  * ``pool_exhausted``  — ``KVCacheManager.can_admit`` reports a dry pool,
                          driving the victim-eviction path;
  * ``sigterm``         — a preemption lands between serving ticks (what
                          the real SIGTERM handler of ``PreemptionGuard``
                          does);
  * ``device_lost``     — a device drops out between serving ticks. The
                          port's engine runs on one device, so nothing
                          survives: it drains and raises
                          ``ServingFault(site="device_lost")``.

Schedules are deterministic: explicit visit sets (``FaultSchedule.at``,
``FaultSchedule.once``) or a seeded Bernoulli plan made up front
(``FaultSchedule.seeded``). The same schedule against the same workload
injects at the same points, which is what makes a token-parity test of the
recovery meaningful.

Standard library and numpy only: the cache manager and the session consult
it on host paths.
"""
from __future__ import annotations

from collections import Counter
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterable, List, Optional, Tuple

import numpy as np

SITES = ("dispatch", "finish_timeout", "nan_logits", "pool_exhausted",
         "sigterm", "device_lost")


class InjectedFault(RuntimeError):
    """Raised by ``check`` at a firing site, with the site and the visit."""

    def __init__(self, site: str, visit: int):
        super().__init__(f"injected fault at site {site!r} (visit {visit})")
        self.site = site
        self.visit = visit


@dataclass(frozen=True)
class FaultSchedule:
    """site -> visit indices (0-based, per-site counters) that inject."""

    plan: Dict[str, FrozenSet[int]] = field(default_factory=dict)

    def __post_init__(self) -> None:
        for site in self.plan:
            if site not in SITES:
                raise ValueError(
                    f"unknown fault site {site!r}; expected one of {SITES}")

    @classmethod
    def once(cls, site: str, visit: int = 0) -> "FaultSchedule":
        """Inject at one site, one visit."""
        return cls({site: frozenset({visit})})

    @classmethod
    def at(cls, **site_visits: Iterable[int]) -> "FaultSchedule":
        """Explicit plan: ``FaultSchedule.at(pool_exhausted=range(8))``."""
        return cls({s: frozenset(int(v) for v in vs)
                    for s, vs in site_visits.items()})

    @classmethod
    def seeded(cls, seed: int, rate: float = 0.05,
               sites: Tuple[str, ...] = SITES,
               horizon: int = 256) -> "FaultSchedule":
        """Bernoulli(rate) per (site, visit) over ``horizon`` visits, drawn
        from ``np.random.default_rng(seed)`` (JAX's plan for the seed)."""
        rng = np.random.default_rng(seed)
        plan = {}
        for site in sites:
            hits = np.nonzero(rng.random(horizon) < rate)[0]
            if hits.size:
                plan[site] = frozenset(int(v) for v in hits)
        return cls(plan)


class FaultInjector:
    """Counts visits per site against a schedule; records what fired."""

    def __init__(self, schedule: FaultSchedule):
        self.schedule = schedule
        self.visits: Counter = Counter()
        self.fired: List[Tuple[str, int]] = []

    def fire(self, site: str) -> bool:
        v = self.visits[site]
        self.visits[site] = v + 1
        hit = v in self.schedule.plan.get(site, ())
        if hit:
            self.fired.append((site, v))
        return hit

    def check(self, site: str) -> None:
        if self.fire(site):
            raise InjectedFault(site, self.fired[-1][1])

    def fired_sites(self) -> FrozenSet[str]:
        return frozenset(s for s, _ in self.fired)


_ACTIVE: Optional[FaultInjector] = None


def active() -> Optional[FaultInjector]:
    return _ACTIVE


def install(schedule: FaultSchedule) -> FaultInjector:
    """Install a fresh injector for ``schedule`` (replacing any current
    one) and return it."""
    global _ACTIVE
    _ACTIVE = FaultInjector(schedule)
    return _ACTIVE


def uninstall() -> None:
    global _ACTIVE
    _ACTIVE = None


def fire(site: str) -> bool:
    """Site entry point: False (and no visit counted) when no injector is
    installed."""
    inj = _ACTIVE
    return inj.fire(site) if inj is not None else False


def check(site: str) -> None:
    """Site entry point: raise ``InjectedFault`` if the site fires."""
    inj = _ACTIVE
    if inj is not None:
        inj.check(site)


@contextmanager
def injected(schedule: FaultSchedule):
    """``with faultinject.injected(FaultSchedule.once("dispatch")) as inj:``"""
    inj = install(schedule)
    try:
        yield inj
    finally:
        uninstall()
