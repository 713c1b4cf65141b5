"""Elastic remesh of the port on device loss: the counterparts of JAX's
``_TP2_REMESH`` and ``_POOL_REMESH`` scripts (``tests/test_remesh.py``), in
this process, with the shards on repeated CPU devices (CPU, fp32; the
llama2-7b smoke config with ``max_batch=3``, weights bridged from JAX).

A TP=2 engine loses a device at tick 1, 2 or 3 (dense and paged caches)
and remeshes to TP=1; a pool of two TP=2 replicas loses one device and
remeshes that replica in place. JAX's assertions hold, and the outputs
(and, for the engine, the stats) equal JAX's unsharded fault-free run.
Tolerance: exact."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import (make_host_mesh,  # noqa: E402
                                     make_replica_meshes)
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime import faultinject  # noqa: E402
from repro_torch.runtime.faultinject import FaultSchedule  # noqa: E402
from repro_torch.serving import ReplicaPool, ServingEngine  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small ops: one intra-op thread, so parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
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
    return (m_j, params_j, sw_j), (m_t, params_t, sw_t)


def _prompts(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, int(rng.integers(4, 12)))
            for _ in range(4)]


def _serve(S, pkg, prompts, cache="paged", **kw):
    se = S(*pkg, strategy="specee", megatick=2, cache=cache, **kw)
    for p in prompts:
        se.submit(p, max_new_tokens=8)
    se.run_to_completion()
    se.close()
    return se


def _outputs(se):
    return {r.uid: list(r.output) for r in se.completed}


def _stats(se):
    return {r.uid: (list(r.exit_points), list(r.accept_lens))
            for r in se.completed}


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_device_lost_tp2_remeshes_to_tp1(setup, cache):
    """A TP=2 engine loses a device at tick 1, 2 or 3 and remeshes to
    TP=1: tokens and stats equal JAX's fault-free unsharded run, no page
    left behind, exactly one remesh event ("tp 2->1"), no give_up."""
    jax_pkg, port = setup
    prompts = _prompts(5)
    ref = _serve(JServingEngine, jax_pkg, prompts, cache)
    for kill_tick in (1, 2, 3):
        with faultinject.injected(
                FaultSchedule.once("device_lost", visit=kill_tick)) as inj:
            se = _serve(ServingEngine, port, prompts, cache,
                        mesh=make_host_mesh(1, 2, "cpu"))
        assert inj.fired_sites() == frozenset({"device_lost"})
        assert se.tp_degree == 1
        ev = [e for e in se.fault_log if e.action == "remesh"]
        assert len(ev) == 1 and ev[0].site == "device_lost"
        assert "tp 2->1" in ev[0].detail, ev[0].detail
        assert not any(e.action == "give_up" for e in se.fault_log)
        assert _outputs(se) == _outputs(ref), (cache, kill_tick)
        assert _stats(se) == _stats(ref), (cache, kill_tick)
        mgr = se.session.cache_mgr
        if mgr.kind == "paged":
            assert mgr.free_pages == mgr.num_pages


def test_device_lost_tp4_remeshes_to_tp2(setup):
    """Three survivors of four: ``plan_replica_remesh`` gives TP=2."""
    jax_pkg, port = setup
    prompts = _prompts(6)
    ref = _serve(JServingEngine, jax_pkg, prompts)
    with faultinject.injected(FaultSchedule.once("device_lost", visit=2)):
        se = _serve(ServingEngine, port, prompts,
                    mesh=make_host_mesh(1, 4, "cpu"))
    assert se.tp_degree == 2
    assert [e.detail.split(" readmitted")[0] for e in se.fault_log
            if e.action == "remesh"] == ["tp 4->2"]
    assert _outputs(se) == _outputs(ref) and _stats(se) == _stats(ref)


def test_device_lost_under_pool_remeshes_in_place(setup):
    """A pool of two TP=2 replicas absorbs a device loss as an in-place
    remesh of one replica: both stay alive, no request migrates, the pool
    turns degraded once, and the outputs equal JAX's fault-free unsharded
    single engine's."""
    jax_pkg, port = setup
    prompts = _prompts(7)
    ref = _serve(JServingEngine, jax_pkg, prompts)
    ref_out = [list(r.output) for r in sorted(ref.completed,
                                              key=lambda r: r.uid)]
    meshes = make_replica_meshes(2, 2, device="cpu")
    pool = ReplicaPool([ServingEngine(*port, strategy="specee", megatick=2,
                                      mesh=ms) for ms in meshes])
    assert pool.health.degraded is False
    assert pool.health.tp_degrees == (2, 2)
    prs = [pool.submit(p, max_new_tokens=8) for p in prompts]
    with faultinject.injected(
            FaultSchedule.once("device_lost", visit=2)) as inj:
        pool.run_to_completion()
    assert inj.fired_sites() == frozenset({"device_lost"})
    assert pool.alive == [True, True]
    assert sorted(pool.health.tp_degrees) == [1, 2]
    assert pool.health.degraded is True
    assert all(pr.migrations == 0 for pr in prs)
    assert any(e.action == "remesh" and e.site == "device_lost"
               for e in pool.fault_log)
    assert any(e.action == "degraded" and e.site == "health"
               for e in pool.fault_log)
    assert not any(e.action == "kill_replica" for e in pool.fault_log)
    assert [list(pr.output) for pr in prs] == ref_out
    for rep in pool.replicas:
        mgr = rep.session.cache_mgr
        if mgr.kind == "paged":
            assert mgr.free_pages == mgr.num_pages
    pool.close()


def test_remesh_up_from_unsharded(setup):
    """``remesh`` onto a bigger mesh (TP=1 -> TP=4) mid-flight, tree
    strategy: the outputs equal the fault-free run's, every recorded token
    replay-verified across the degrees."""
    _, port = setup
    prompts = _prompts(8)

    def serve(remesh_at=None):
        se = ServingEngine(*port, strategy="tree", megatick=2)
        for p in prompts:
            se.submit(p, max_new_tokens=8)
        if remesh_at is not None:
            for _ in range(remesh_at):
                se.step()
            se.remesh(make_host_mesh(1, 4, "cpu"), site="test")
            assert se.tp_degree == 4
        se.run_to_completion()
        se.close()
        assert all(r.replayed == r.replay_total for r in se.completed)
        return _outputs(se), _stats(se)

    assert serve(remesh_at=2) == serve()
