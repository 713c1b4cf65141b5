"""The port's ``runtime.fault`` and ``runtime.faultinject`` against the JAX
package's, case for case with ``tests/test_runtime_fault.py``: each case
runs on both packages and must give JAX's answer (pure logic, exact)."""
import os
import signal

import pytest

pytest.importorskip("torch")

from repro.runtime import fault as jfault  # noqa: E402
from repro.runtime import faultinject as jfi  # noqa: E402
from repro_torch.runtime import fault as tfault  # noqa: E402
from repro_torch.runtime import faultinject as tfi  # noqa: E402

BOTH = pytest.mark.parametrize("fault", [jfault, tfault],
                               ids=["jax", "torch"])


# ---------------- StragglerMonitor ----------------
def _feed(mon, host, value, n=None):
    for _ in range(n if n is not None else mon.min_samples):
        mon.record(host, value)


def _needs_two_hosts(fault):
    mon = fault.StragglerMonitor()
    seen = [mon.fleet_stats()]
    _feed(mon, 0, 1.0)
    seen += [mon.fleet_stats(), mon.stragglers()]   # one host: no fleet
    return seen


def _even_fleet_median(fault):
    mon = fault.StragglerMonitor()
    for host, v in enumerate([1.0, 2.0, 3.0, 4.0]):
        _feed(mon, host, v)
    return mon.fleet_stats()                    # sorted[4 // 2], |v - 3|


def _straggler_does_not_inflate(fault):
    mon = fault.StragglerMonitor(sigma=3.0)
    for host in range(6):
        _feed(mon, host, 1.0)
    _feed(mon, 6, 50.0)
    return mon.stragglers(), mon.fleet_stats()[0]


def _min_samples_filter(fault):
    mon = fault.StragglerMonitor(min_samples=8)
    for host in range(4):
        _feed(mon, host, 1.0)
    mon.record(9, 100.0)                        # one sample: not trusted
    before = mon.stragglers()
    _feed(mon, 9, 100.0)
    return before, mon.stragglers()


@pytest.mark.parametrize("case,want", [
    (_needs_two_hosts, [(0.0, 0.0), (0.0, 0.0), []]),
    (_even_fleet_median, pytest.approx((3.0, 1.0))),
    (_straggler_does_not_inflate, ([6], 1.0)),
    (_min_samples_filter, ([], [9]))], ids=lambda x: getattr(
        x, "__name__", "want").lstrip("_"))
def test_straggler_monitor_matches_jax(case, want):
    assert case(tfault) == case(jfault) == want


# ---------------- plan_remesh / plan_replica_remesh ----------------
@pytest.mark.parametrize("args,kw,want", [
    ((64, 8), {}, (8, 8)), ((63, 8), {}, (7, 8)), ((8, 8), {}, (1, 8)),
    ((64, 8), dict(pods=4), (4, 2, 8)),
    ((64, 8), dict(pods=4, pod_alive=(16, 16, 16, 9)), (4, 1, 8)),
    ((48, 8), dict(pods=4, pod_alive=(16, 16, 16, 0)), (3, 2, 8)),
    ((12, 8), dict(pods=2, pod_alive=(9, 3)), (1, 8)),
    ((12, 8), dict(pods=2), None), ((4, 8), dict(pods=2), None),
    ((7, 8), {}, None), ((14, 8), dict(pods=2), None),
    ((15, 8), dict(pods=2), (1, 8))])
def test_plan_remesh_matches_jax(args, kw, want):
    assert (tfault.plan_remesh(*args, **kw)
            == jfault.plan_remesh(*args, **kw) == want)


@pytest.mark.parametrize("alive,tp,want", [
    (3, 4, 2), (2, 4, 2), (1, 4, 1), (1, 2, 1), (4, 4, 4), (5, 6, 3),
    (0, 2, None), (0, 1, None)])
def test_plan_replica_remesh_matches_jax(alive, tp, want):
    assert (tfault.plan_replica_remesh(alive, tp)
            == jfault.plan_replica_remesh(alive, tp) == want)


# ---------------- PreemptionGuard (real signals) ----------------
@BOTH
def test_guard_install_idempotent_and_uninstall_restores(fault):
    before = signal.getsignal(signal.SIGTERM)
    g = fault.PreemptionGuard()
    g.install()
    installed = signal.getsignal(signal.SIGTERM)
    assert installed is not before
    g.install()                                 # idempotent: same handler
    assert signal.getsignal(signal.SIGTERM) is installed
    g.uninstall()
    assert signal.getsignal(signal.SIGTERM) is before
    g.uninstall()                               # no-op when not installed
    assert signal.getsignal(signal.SIGTERM) is before


@pytest.mark.parametrize("outer_pkg,inner_pkg", [
    (tfault, tfault), (jfault, tfault), (tfault, jfault)],
    ids=["torch-torch", "jax-torch", "torch-jax"])
def test_guard_catches_sigterm_and_nests(outer_pkg, inner_pkg):
    """A real SIGTERM to this process reaches the inner guard and, through
    the chain, the outer one, across packages too."""
    outer, inner = outer_pkg.PreemptionGuard(), inner_pkg.PreemptionGuard()
    outer.install()
    inner.install()
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        assert inner.should_save()
        assert outer.should_save()              # handlers chain outward
    finally:
        inner.uninstall()
        outer.uninstall()


# ---------------- faultinject ----------------
def test_sites_and_unknown_site_match_jax():
    assert tfi.SITES == jfi.SITES
    for fi in (tfi, jfi):
        with pytest.raises(ValueError, match="unknown fault site"):
            fi.FaultSchedule.once("warp_core_breach")


def _visits(fi):
    inj = fi.FaultInjector(fi.FaultSchedule.at(dispatch=[1], nan_logits=[0]))
    seen = [inj.fire("dispatch"), inj.fire("nan_logits"),
            inj.fire("dispatch"), inj.fire("dispatch")]
    return seen, inj.fired, inj.fired_sites()


def _check_raises(fi):
    inj = fi.FaultInjector(fi.FaultSchedule.once("dispatch"))
    with pytest.raises(fi.InjectedFault) as ei:
        inj.check("dispatch")
    return ei.value.site, ei.value.visit, str(ei.value)


def _seeded(fi):
    a = fi.FaultSchedule.seeded(seed=42, rate=0.2, horizon=64)
    b = fi.FaultSchedule.seeded(seed=42, rate=0.2, horizon=64)
    c = fi.FaultSchedule.seeded(seed=43, rate=0.2, horizon=64)
    assert a.plan == b.plan and a.plan != c.plan
    assert any(a.plan.values())                 # rate 0.2 over 64
    return a.plan, c.plan


def _module_noop(fi):
    fi.uninstall()
    off = fi.fire("dispatch")
    fi.check("dispatch")                        # no raise
    with fi.injected(fi.FaultSchedule.once("dispatch")) as inj:
        assert fi.active() is inj
        with pytest.raises(fi.InjectedFault):
            fi.check("dispatch")
    return off, fi.active()


@pytest.mark.parametrize("case,want", [
    (_visits, ([False, True, True, False],
               [("nan_logits", 0), ("dispatch", 1)],
               frozenset({"dispatch", "nan_logits"}))),
    (_check_raises, ("dispatch", 0,
                     "injected fault at site 'dispatch' (visit 0)")),
    (_seeded, None), (_module_noop, (False, None))],
    ids=["counts_visits_per_site", "check_raises_with_site_and_visit",
         "seeded_schedule_deterministic", "module_level_noop"])
def test_faultinject_matches_jax(case, want):
    got = case(tfi)
    assert got == case(jfi)
    if want is not None:
        assert got == want
