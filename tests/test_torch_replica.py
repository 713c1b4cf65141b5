"""The port's ``ReplicaPool`` and in-process remesh against the JAX
package's, under the same schedules (CPU, fp32; JAX's setup: the llama2-7b
smoke config with ``max_batch=3``, weights bridged from JAX).

Every pool test of JAX's ``tests/test_fault_serving.py`` (token parity,
kill mid-flight at ticks 1-3, straggler eviction, the last replica's
death) and every in-process test of ``tests/test_remesh.py`` (remesh
rebuild and replay, the device-loss ladder, deadlines, load shedding, pool
health, the fault log's ring and JSONL, engine cancel) runs once on each
package: outputs, stats, migrations and the fault log's (site, tick,
action) sequence must be JAX's. Sampled serving, whose draws differ by
design between the packages, is held to the port's own fault-free run.

JAX's engines share one ``Engine`` per (model, strategy), as in
``tests/test_torch_fault_serving.py``, so each jitted step compiles once.
Tolerance: exact."""
import dataclasses
import json
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.serving.server as jserver  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.api import DenseStrategy as JDenseStrategy  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.runtime import fault as jfault  # noqa: E402
from repro.runtime import faultinject as jfi  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.api import DenseStrategy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime import fault as tfault  # noqa: E402
from repro_torch.runtime import faultinject as tfi  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small ops: one intra-op thread, so parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _SharedEngines:
    """``Engine.create`` for the JAX references: one per (model, params,
    strategy, quant, mesh)."""

    def __init__(self, real):
        self.real, self.made = real, {}

    def create(self, model, params, sw=None, strategy=None, quant=None,
               mesh=None, policy="tp_dp"):
        key = (model.run, model.flags, id(params), strategy.name,
               getattr(strategy, "temperature", None), quant, mesh)
        if key not in self.made:
            self.made[key] = self.real.create(model, params, sw,
                                              strategy=strategy, quant=quant,
                                              mesh=mesh, policy=policy)
        return self.made[key]


@pytest.fixture(scope="module")
def pkgs():
    def three_slots(run):
        return dataclasses.replace(
            run, serve=dataclasses.replace(run.serve, max_batch=3))
    m_j = jbuild(three_slots(jax_get_config("llama2-7b").smoke()))
    m_t = build_model(three_slots(get_config("llama2-7b").smoke()))
    params_j = m_j.init(jax.random.PRNGKey(0))
    sw_j = jeng.init_specee(m_j, jax.random.PRNGKey(1))
    params_t = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params_j), "cpu", torch.float32)
    sw_np = jax.tree_util.tree_map(np.asarray, sw_j)
    sw_t = bridge.specee_from_numpy(sw_np.draft, sw_np.predictors,
                                    sw_np.offline_mask, "cpu", torch.float32)
    J = SimpleNamespace(name="jax", serving=jserving, fi=jfi, fault=jfault,
                        Dense=JDenseStrategy, m=m_j, params=params_j,
                        sw=sw_j)
    T = SimpleNamespace(name="torch", serving=tserving, fi=tfi, fault=tfault,
                        Dense=DenseStrategy, m=m_t, params=params_t,
                        sw=sw_t)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jserver, "Engine", _SharedEngines(jserver.Engine))
        yield J, T


def _prompts(n=4, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, int(rng.integers(4, 12))) for _ in range(n)]


def _engine(pk, **kw):
    kw.setdefault("strategy", "specee")
    kw.setdefault("megatick", 2)
    return pk.serving.ServingEngine(pk.m, pk.params, pk.sw, **kw)


def _log(log):
    return [(e.site, e.tick, e.action) for e in log]


def _pool_rec(pool, prs):
    return {"outputs": [list(pr.output) for pr in prs],
            "stats": [(list(pr.exit_points), list(pr.accept_lens))
                      for pr in prs],
            "migrations": [pr.migrations for pr in prs],
            "failed": [pr.failed for pr in prs],
            "alive": list(pool.alive), "log": _log(pool.fault_log),
            "health": dataclasses.asdict(pool.health)}


def _single_ref(pk, prompts, max_new=8):
    se = _engine(pk)
    for p in prompts:
        se.submit(p, max_new_tokens=max_new)
    se.run_to_completion()
    se.close()
    return [list(r.output) for r in sorted(se.completed,
                                           key=lambda r: r.uid)]


def _on_both(pkgs, fn):
    """``fn(pk)`` on the port, then on JAX: (port's, JAX's)."""
    J, T = pkgs
    return fn(T), fn(J)


def _no_leak(se):
    mgr = se.session.cache_mgr
    if mgr.kind == "paged":
        assert mgr.free_pages == mgr.num_pages, \
            f"page leak: {mgr.free_pages}/{mgr.num_pages} free"


# ---------------- the pool (tests/test_fault_serving.py) ----------------
def test_replica_pool_token_parity(pkgs):
    """Two replicas behind one queue emit what one engine emits."""
    prompts = _prompts(seed=21)

    def run(pk):
        pool = pk.serving.ReplicaPool([_engine(pk) for _ in range(2)])
        prs = [pool.submit(p, max_new_tokens=8) for p in prompts]
        pool.run_to_completion()
        pool.close()
        return _pool_rec(pool, prs), _single_ref(pk, prompts)

    (got, ref), (want, _) = _on_both(pkgs, run)
    assert got == want
    assert got["outputs"] == ref and got["migrations"] == [0] * 4


@pytest.mark.parametrize("kill_tick", [1, 2, 3])
def test_replica_pool_kill_mid_flight_parity(pkgs, kill_tick):
    """Killing a replica mid-decode requeues its requests onto the
    survivor, which replay-verifies every recorded token and completes
    them as one uninterrupted engine would."""
    prompts = _prompts(seed=22)

    def run(pk):
        pool = pk.serving.ReplicaPool([_engine(pk) for _ in range(2)])
        prs = [pool.submit(p, max_new_tokens=8) for p in prompts]
        for _ in range(kill_tick):
            pool.step()
        victims = [i for i in pool.live_replicas()
                   if any(pr.replica == i and not pr.done
                          for pr in pool.requests.values())]
        progress = {}
        if victims:
            for pr in pool.requests.values():
                if (pr.replica == victims[0] and not pr.done
                        and pr.handle is not None):
                    progress[pr.uid] = len(pr.handle.output)
            pool.kill_replica(victims[0], reason="test_kill")
        pool.run_to_completion()
        pool.close()
        replays = [(pr.handle.replay_total, pr.handle.replayed)
                   for pr in prs if pr.migrations]
        return _pool_rec(pool, prs), progress, replays, \
            _single_ref(pk, prompts)

    got, want = _on_both(pkgs, run)
    assert got == want
    rec, progress, replays, ref = got
    assert rec["outputs"] == ref
    assert replays and all(done == total for total, done in replays)
    assert all(total >= min(progress.values(), default=0)
               for total, _ in replays)


def test_replica_pool_straggler_eviction(pkgs):
    """A replica whose step-time EWMA drifts above the fleet's is evicted
    (never the last live one); its requests migrate."""
    prompts = _prompts(seed=23)

    def run(pk):
        monitor = pk.fault.StragglerMonitor(min_samples=2)
        for _ in range(2):
            monitor.record(0, 0.01)
            monitor.record(1, 0.01)
            monitor.record(2, 50.0)
        pool = pk.serving.ReplicaPool([_engine(pk) for _ in range(3)],
                                      monitor=monitor)
        prs = [pool.submit(p, max_new_tokens=8) for p in prompts]
        pool.run_to_completion()
        pool.close()
        return _pool_rec(pool, prs), _single_ref(pk, prompts)

    (got, ref), (want, _) = _on_both(pkgs, run)
    assert got == want and got["outputs"] == ref
    kills = [e for e in got["log"] if e[2] == "kill_replica"]
    assert kills and kills[0][0] == "straggler"
    assert got["alive"] == [True, True, False]


def test_replica_pool_last_replica_death_raises(pkgs):
    def run(pk):
        pool = pk.serving.ReplicaPool([_engine(pk)])
        pool.submit(_prompts(n=1)[0], max_new_tokens=4)
        pool.step()
        with pytest.raises(pk.serving.ServingFault) as ei:
            pool.kill_replica(0, reason="test_kill")
        return ei.value.site, str(ei.value), _log(pool.fault_log)

    got, want = _on_both(pkgs, run)
    assert got == want and got[0] == "replica_pool"


# ---------------- remesh in process (tests/test_remesh.py) ----------------
@pytest.mark.parametrize("cache", ["dense", "paged"])
@pytest.mark.parametrize("strategy", ["dense", "specee", "tree"])
def test_remesh_rebuild_replay_parity(pkgs, strategy, cache):
    """``remesh(None)`` mid-flight at ticks 1-3 (the TP=1 -> TP=1 rebuild)
    gives the fault-free run's outputs and stats, one remesh event, no
    page left behind, every recorded token replay-verified."""
    prompts = _prompts()

    def run(pk):
        def serve(remesh_at=None):
            se = _engine(pk, strategy=strategy, cache=cache)
            for p in prompts:
                se.submit(p, max_new_tokens=8)
            if remesh_at is not None:
                for _ in range(remesh_at):
                    se.step()
                se.remesh(None, site="test", detail=f"tick{remesh_at}")
            se.run_to_completion()
            se.close()
            _no_leak(se)
            assert all(r.replayed == r.replay_total for r in se.completed)
            return ({r.uid: (list(r.output), list(r.exit_points),
                             list(r.accept_lens)) for r in se.completed},
                    _log(se.fault_log),
                    [e.detail for e in se.fault_log if e.action == "remesh"])
        return [serve()] + [serve(t) for t in (1, 2, 3)]

    got, want = _on_both(pkgs, run)
    assert got == want
    ref = got[0]
    assert not ref[1]
    for rec, _, details in got[1:]:
        assert rec == ref[0]
        assert len(details) == 1 and "readmitted=" in details[0]


def test_remesh_sampled_run_parity(pkgs):
    """Sampled decode remeshes reproducibly: the rebuilt session re-seeds
    from the engine's ``prng_seed`` and sample keys are position-keyed."""
    _, T = pkgs
    prompts = _prompts(n=3, seed=23)

    def serve(remesh_at=None):
        se = _engine(T, strategy=DenseStrategy(temperature=1.0),
                     prng_seed=7)
        for p in prompts:
            se.submit(p, max_new_tokens=8)
        if remesh_at is not None:
            for _ in range(remesh_at):
                se.step()
            se.remesh(None, site="test")
        se.run_to_completion()
        se.close()
        _no_leak(se)
        return {r.uid: list(r.output) for r in se.completed}

    assert serve(remesh_at=2) == serve()


def test_device_lost_unsharded_engine_raises(pkgs):
    """An unsharded engine has no survivor to remesh onto: the loss drains
    and raises site="device_lost" with a give_up, no remesh."""
    def run(pk):
        se = _engine(pk)
        for p in _prompts(n=2):
            se.submit(p, max_new_tokens=6)
        with pk.fi.injected(pk.fi.FaultSchedule.once("device_lost",
                                                     visit=1)):
            with pytest.raises(pk.serving.ServingFault) as ei:
                se.run_to_completion()
        se.close()
        return ei.value.site, str(ei.value), _log(se.fault_log)

    got, want = _on_both(pkgs, run)
    assert got == want
    assert got[0] == "device_lost" and [a for *_, a in got[2]] == ["give_up"]


def test_device_lost_pool_fallback_kill_and_requeue(pkgs):
    """Under a pool, an engine that cannot remesh is killed and its
    requests requeue; the outputs match a fault-free single engine's."""
    prompts = _prompts()

    def run(pk):
        pool = pk.serving.ReplicaPool([_engine(pk) for _ in range(2)])
        prs = [pool.submit(p, max_new_tokens=8) for p in prompts]
        with pk.fi.injected(
                pk.fi.FaultSchedule.once("device_lost", visit=1)) as inj:
            pool.run_to_completion()
        pool.close()
        return _pool_rec(pool, prs), inj.fired_sites(), \
            _single_ref(pk, prompts)

    (got, fired, ref), (want, jfired, _) = _on_both(pkgs, run)
    assert got == want and fired == jfired == frozenset({"device_lost"})
    assert sorted(got["alive"]) == [False, True]
    kills = [e for e in got["log"] if e[2] == "kill_replica"]
    assert kills and kills[0][0] == "device_lost"
    assert not any(e[2] == "remesh" for e in got["log"])
    assert sum(got["migrations"]) >= 1 and got["outputs"] == ref
    assert got["health"]["degraded"] and got["health"]["replicas_live"] == 1


def test_device_lost_last_replica_raises_replica_pool(pkgs):
    def run(pk):
        pool = pk.serving.ReplicaPool([_engine(pk)])
        for p in _prompts(n=2):
            pool.submit(p, max_new_tokens=6)
        with pk.fi.injected(pk.fi.FaultSchedule.once("device_lost",
                                                     visit=1)):
            with pytest.raises(pk.serving.ServingFault) as ei:
                pool.run_to_completion()
        return ei.value.site, _log(pool.fault_log)

    got, want = _on_both(pkgs, run)
    assert got == want and got[0] == "replica_pool"


def test_deadline_shed(pkgs):
    """Requests past their deadline are shed with a structured fault,
    queued or slotted, keeping their partial output; the others
    complete; the cancelled rows leak no page."""
    prompts = _prompts()

    def run(pk):
        engine = _engine(pk, megatick=1, prefill_chunk=0)
        pool = pk.serving.ReplicaPool([engine])
        shed = [pool.submit(prompts[i], max_new_tokens=48, deadline_ticks=3)
                for i in range(2)]
        kept = [pool.submit(prompts[i], max_new_tokens=6) for i in (2, 3)]
        pool.run_to_completion()
        _no_leak(engine)
        pool.close()
        return (_pool_rec(pool, shed + kept),
                [pr.fault.site for pr in shed],
                [pr.uid for pr in pool.failed],
                [pr.uid for pr in pool.completed])

    got, want = _on_both(pkgs, run)
    assert got == want
    rec, sites, failed, completed = got
    assert sites == ["deadline"] * 2 and failed == [0, 1]
    assert completed == [2, 3] and rec["failed"] == [True, True, False, False]
    assert all(0 < len(o) < 48 for o in rec["outputs"][:2])
    assert [len(o) for o in rec["outputs"][2:]] == [6, 6]
    assert [a for s, _, a in rec["log"] if s == "deadline"] == ["shed"] * 2


def test_deadline_generous_completes(pkgs):
    def run(pk):
        pool = pk.serving.ReplicaPool([_engine(pk)])
        prs = [pool.submit(p, max_new_tokens=4, deadline_ticks=500)
               for p in _prompts(n=2)]
        pool.run_to_completion()
        pool.close()
        return _pool_rec(pool, prs), len(pool.failed)

    got, want = _on_both(pkgs, run)
    assert got == want
    assert got[1] == 0 and not got[0]["log"] and not any(got[0]["failed"])


def test_load_shed_bounded_queue(pkgs):
    """``only_degraded=False`` bounds intake: beyond ``max_queue`` a
    submit is rejected with site="load_shed" until a tick drains the
    queue."""
    prompts = _prompts(n=3)

    def run(pk):
        pool = pk.serving.ReplicaPool(
            [_engine(pk)],
            shed=pk.serving.LoadShedPolicy(max_queue=1, only_degraded=False))
        pool.submit(prompts[0], max_new_tokens=4)
        with pytest.raises(pk.serving.ServingFault) as ei:
            pool.submit(prompts[1], max_new_tokens=4)
        pool.step()
        pool.submit(prompts[2], max_new_tokens=4)
        done = pool.run_to_completion()
        pool.close()
        return ei.value.site, len(done), _log(pool.fault_log), \
            [list(pr.output) for pr in pool.completed]

    got, want = _on_both(pkgs, run)
    assert got == want and got[0] == "load_shed" and got[1] == 2


def test_load_shed_only_when_degraded(pkgs):
    prompts = _prompts(n=3)

    def run(pk):
        pool = pk.serving.ReplicaPool(
            [_engine(pk) for _ in range(2)],
            shed=pk.serving.LoadShedPolicy(max_queue=0, only_degraded=True))
        assert not pool.degraded
        pool.submit(prompts[0], max_new_tokens=4)
        pool.step()
        pool.kill_replica(1, reason="test")
        assert pool.degraded
        with pytest.raises(pk.serving.ServingFault) as ei:
            pool.submit(prompts[1], max_new_tokens=4)
        pool.run_to_completion()
        pool.close()
        return ei.value.site, _log(pool.fault_log), \
            [list(pr.output) for pr in pool.completed]

    got, want = _on_both(pkgs, run)
    assert got == want and got[0] == "load_shed"


def test_pool_health_snapshot(pkgs):
    def run(pk):
        pool = pk.serving.ReplicaPool([_engine(pk, megatick=1)])
        h = dataclasses.asdict(pool.health)
        pool.close()
        return h

    got, want = _on_both(pkgs, run)
    assert got == want == {"replicas_total": 1, "replicas_live": 1,
                           "tp_degrees": (1,), "built_tp_degrees": (1,),
                           "queued": 0, "degraded": False}


def test_fault_log_ring_and_jsonl(pkgs, tmp_path):
    """The bounded ring (cap, total, dropped, indexing, slices) and its
    JSONL export equal JAX's, line for line."""
    def run(pk):
        S = pk.serving
        log = S.FaultLog(cap=4)
        assert not log and len(log) == 0 and log.dropped == 0
        for i in range(7):
            log.append(S.FaultEvent(site="health", tick=i, action="x"))
        ring = (len(log), log.total, log.dropped, [e.tick for e in log],
                log[0].tick, log[-1].tick, [e.tick for e in log[1:3]])
        with pytest.raises(ValueError):
            S.FaultLog(cap=0)
        path = str(tmp_path / f"{pk.name}.jsonl")
        log = S.FaultLog(cap=3)
        log.extend(S.FaultEvent(site="evict", tick=i, action="evict",
                                detail=f"row={i}") for i in range(5))
        n = log.dump_jsonl(path, source="engine")
        other = S.FaultLog()
        other.append(S.FaultEvent(site="deadline", tick=9, action="shed"))
        n2 = other.dump_jsonl(path, source="pool", append=True)
        return ring, n, n2, [json.loads(line) for line in open(path)]

    got, want = _on_both(pkgs, run)
    assert got == want
    ring, n, n2, rows = got
    assert ring == (4, 7, 3, [3, 4, 5, 6], 3, 6, [4, 5]) and (n, n2) == (3, 1)
    assert [r["seq"] for r in rows[:3]] == [2, 3, 4]
    assert rows[-1]["source"] == "pool"


def test_engine_cancel_queued_and_slotted(pkgs):
    prompts = _prompts()

    def run(pk):
        se = _engine(pk, megatick=1, prefill_chunk=0)
        reqs = [se.submit(p, max_new_tokens=6) for p in prompts]
        flags = [se.cancel(reqs[3].uid), se.cancel(999)]
        se.step()
        flags.append(se.cancel(reqs[0].uid))
        se.run_to_completion()
        se.close()
        _no_leak(se)
        return flags, [(r.uid, list(r.output)) for r in se.completed]

    got, want = _on_both(pkgs, run)
    assert got == want
    assert got[0] == [True, False, True]
    assert [u for u, _ in got[1]] == [1, 2]
