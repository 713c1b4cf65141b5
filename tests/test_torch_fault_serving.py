"""The port's fault-tolerant serving against the JAX package's, under the
same fault schedules (CPU, fp32; JAX's ``tests/test_fault_serving.py``
setup: the llama2-7b smoke config with ``max_batch=3`` and ``TIGHT_POOL``,
16 pages of 16 tokens, two whole-row reservations for three slots, so a
slot sits free while the pool is dry; weights bridged from JAX).

Each engine test runs once on each package and must give JAX's result
exactly: every request's tokens, exit points and accept lengths, the
finish order, evictions, the fired sites, the fault log's (site, tick,
action) sequence, and no page left behind. Sampled serving (whose draws
differ by design between the packages) is held to the port's own
fault-free run. Then the launcher's fault flags, in this process.

JAX's ``ServingEngine`` builds an ``Engine`` per instance, whose jitted
steps compile anew; here the JAX engines share one ``Engine`` per (model,
strategy), which holds no per-session state, so each compiles once."""
import dataclasses
import json
import os
import signal
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.serving.server as jserver  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.api import CacheSpec as JCacheSpec  # noqa: E402
from repro.api import DenseStrategy as JDenseStrategy  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.runtime import faultinject as jfi  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.api import CacheSpec, DenseStrategy  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime import faultinject as tfi  # noqa: E402



@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The smoke config's ops are tiny: one intra-op thread, so that the
    test run's parallel workers do not oversubscribe the cores (spinning
    thread pools made these tests 20-50x slower under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

class _SharedEngines:
    """``Engine.create`` for the JAX references: one per (model, params,
    strategy, quant)."""

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
    J = SimpleNamespace(name="jax", serving=jserving, fi=jfi,
                        CacheSpec=JCacheSpec, Dense=JDenseStrategy, m=m_j,
                        params=params_j, sw=sw_j)
    T = SimpleNamespace(name="torch", serving=tserving, fi=tfi,
                        CacheSpec=CacheSpec, Dense=DenseStrategy, m=m_t,
                        params=params_t, sw=sw_t)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jserver, "Engine", _SharedEngines(jserver.Engine))
        yield J, T


def _prompts(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, int(rng.integers(4, 12))) for _ in range(n)]


def _kw(pk, tight=False, backoff=False, **kw):
    """Engine arguments in ``pk``'s own types."""
    if tight:
        kw["cache"] = pk.CacheSpec(kind="paged", page_size=16, num_pages=16)
    if backoff:
        kw["backoff"] = pk.serving.Backoff(base_s=0.0)
    return kw


def _serve(pk, prompts, max_new, schedule=None, ckpt=None,
           preempt_after=None, **kw):
    """Serve ``prompts`` under ``schedule`` (a function of the package's
    faultinject), restarting from the checkpoint on each ``Preempted`` as
    JAX's tests do; ``preempt_after`` ticks, then what a real SIGTERM's
    handler sets. Returns the engine and the run's record."""
    if ckpt is not None:
        kw["checkpoint_dir"] = str(ckpt / pk.name)
    inj = pk.fi.install(schedule(pk.fi)) if schedule else None
    log = []
    try:
        se = pk.serving.ServingEngine(pk.m, pk.params, pk.sw, **kw)
        for p in prompts:
            se.submit(p, max_new_tokens=max_new)
        if preempt_after is not None:
            for _ in range(preempt_after):
                se.step()
            se.guard.requested = True
        for _ in range(8):              # preemption / restart cycles
            try:
                se.run_to_completion()
                break
            except pk.serving.Preempted:
                log.extend(se.fault_log)
                se.close()
                se = pk.serving.ServingEngine(pk.m, pk.params, pk.sw, **kw)
                assert se.restore_checkpoint()
        else:
            pytest.fail("engine never ran to completion")
        log.extend(se.fault_log)
        se.close()
    finally:
        fired = inj.fired_sites() if inj is not None else frozenset()
        pk.fi.uninstall()
    mgr = se.session.cache_mgr
    return se, {
        "outputs": {r.uid: list(r.output) for r in se.completed},
        "stats": {r.uid: (list(r.exit_points), list(r.accept_lens))
                  for r in se.completed},
        "order": [r.uid for r in se.completed],
        "evictions": {r.uid: r.evictions for r in se.completed},
        "all_done": all(r.done for r in se.completed),
        "pages": ((mgr.free_pages, mgr.num_pages) if mgr.kind == "paged"
                  else None),
        "fired": fired,
        "log": [(e.site, e.tick, e.action) for e in log]}


def _both(pkgs, *args, kw, **kws):
    """The same run on both packages: (port record, JAX record)."""
    return tuple(_serve(pk, *args, **kws, **kw(pk))[1] for pk in pkgs[::-1])


def _no_leak(rec):
    assert rec["pages"] is None or rec["pages"][0] == rec["pages"][1], \
        f"page leak: {rec['pages']}"


# ---------------- the acceptance property ----------------
def test_every_site_matches_jax_and_fault_free(pkgs, tmp_path):
    """JAX's every-site schedule (plus real pool pressure): the port's run
    equals JAX's in every field, and its tokens equal its own fault-free
    run's."""
    J, T = pkgs
    schedule = lambda fi: fi.FaultSchedule.at(  # noqa: E731
        dispatch=[1], finish_timeout=[3], nan_logits=[5],
        pool_exhausted=range(2, 8), sigterm=[6])
    got, want = _both(
        pkgs, _prompts(), 12, schedule=schedule, ckpt=tmp_path,
        kw=lambda pk: _kw(pk, tight=True, backoff=True, strategy="specee",
                          megatick=4, evict_patience=2, cooldown_ticks=2))
    assert got == want
    assert got["fired"] == frozenset(tfi.SITES) - {"device_lost"}
    _, ref = _serve(T, _prompts(), 12, strategy="specee", megatick=4)
    assert got["outputs"] == ref["outputs"] and got["stats"] == ref["stats"]
    assert got["all_done"] and len(got["outputs"]) == 4
    _no_leak(got)
    actions = {a for _, _, a in got["log"]}
    assert {"retry", "recover", "evict", "checkpoint", "restore"} <= actions


# ---------------- eviction / recompute parity ----------------
@pytest.mark.parametrize("strategy", ["dense", "specee", "tree"])
def test_eviction_parity_greedy_matches_jax(pkgs, strategy):
    got, want = _both(pkgs, _prompts(), 16, kw=lambda pk: _kw(
        pk, tight=True, strategy=strategy, megatick=4, evict_patience=2))
    assert got == want
    assert any(a == "evict" for _, _, a in got["log"]), \
        "tight pool never drove an eviction"
    assert max(got["evictions"].values()) >= 1
    _no_leak(got)


def test_eviction_parity_sampled_against_fault_free(pkgs):
    """Fixed-seed sampling: per-row keys (seed, position, token fed) make
    an evicted row redraw its tokens on replay."""
    _, T = pkgs
    kw = dict(strategy=DenseStrategy(temperature=1.0), megatick=4,
              prng_seed=7)
    _, ref = _serve(T, _prompts(seed=3), 16, **kw)
    _, got = _serve(T, _prompts(seed=3), 16, **_kw(T, tight=True),
                    evict_patience=2, **kw)
    assert any(a == "evict" for _, _, a in got["log"])
    assert got["outputs"] == ref["outputs"]
    _no_leak(got)


def test_eviction_protection_matches_jax(pkgs):
    """A pool of one row reservation: requests stop being evicted after
    ``max_evictions`` and every request still finishes."""
    got, want = _both(pkgs, _prompts(), 10, kw=lambda pk: dict(
        strategy="specee", megatick=2, evict_patience=1,
        cache=pk.CacheSpec(kind="paged", page_size=16, num_pages=8),
        victim=pk.serving.VictimPolicy(max_evictions=2)))
    assert got == want
    assert max(got["evictions"].values()) <= 2
    _no_leak(got)


# ---------------- checkpoint / restore ----------------
def test_checkpoint_restore_matches_jax(pkgs, tmp_path):
    """A SIGTERM (what the guard's handler sets) after 3 ticks: drain,
    checkpoint, ``Preempted``; a fresh engine restores and finishes."""
    got, want = _both(pkgs, _prompts(), 8, ckpt=tmp_path, preempt_after=3,
                      kw=lambda pk: dict(strategy="specee", megatick=4))
    assert got == want
    assert [a for _, _, a in got["log"]] == ["checkpoint", "restore"]
    assert len(got["outputs"]) == 4
    _no_leak(got)


def test_restore_on_empty_dir_and_guard_lifetime(pkgs, tmp_path):
    """An empty directory is a fresh boot; the engine's own guard holds
    SIGTERM from construction to ``close``."""
    _, T = pkgs
    before = signal.getsignal(signal.SIGTERM)
    se = tserving.ServingEngine(T.m, T.params, T.sw, strategy="specee",
                                checkpoint_dir=str(tmp_path / "empty"))
    assert signal.getsignal(signal.SIGTERM) is not before
    assert se.restore_checkpoint() is False
    se.close()
    assert signal.getsignal(signal.SIGTERM) is before


def test_abort_active_requeues_at_front_matches_jax(pkgs):
    """The checkpoint's drain aborts the in-flight chunked admission back
    to the queue's front: it keeps its turn and holds no pages."""
    outs = []
    for pk in pkgs:
        se = pk.serving.ServingEngine(pk.m, pk.params, pk.sw,
                                      strategy="specee", prefill_chunk=4)
        rng = np.random.default_rng(9)
        se.submit(rng.integers(0, 512, 4), max_new_tokens=8)
        se.step()
        req = se.submit(rng.integers(0, 512, 20), max_new_tokens=4)
        se.step()                   # one 4-token chunk of 20
        assert se.scheduler.admitting == [req.uid]
        free_before = se.session.cache_mgr.free_pages
        assert se.scheduler.abort_active() == req.uid
        assert se.scheduler.admitting == []
        assert se.scheduler.queued[0] == req.uid
        assert se.session.cache_mgr.free_pages == free_before
        se.run_to_completion()
        assert req.done and len(req.output) == 4
        outs.append({r.uid: r.output for r in se.completed})
        se.close()
    assert outs[0] == outs[1]


# ---------------- one site at a time ----------------
@pytest.mark.parametrize(
    "site", [s for s in tfi.SITES if s != "device_lost"])
def test_single_site_injection_matches_jax(pkgs, tmp_path, site):
    def schedule(fi):
        return (fi.FaultSchedule.at(pool_exhausted=range(8))
                if site == "pool_exhausted"
                else fi.FaultSchedule.once(site, visit=1))
    got, want = _both(
        pkgs, _prompts(), 8, schedule=schedule,
        ckpt=tmp_path if site == "sigterm" else None,
        kw=lambda pk: _kw(pk, backoff=True, strategy="specee", megatick=4,
                          cooldown_ticks=2))
    assert got == want
    assert site in got["fired"] and len(got["outputs"]) == 4
    _no_leak(got)
    if site in ("finish_timeout", "nan_logits"):
        assert (site, "recover") in {(s, a) for s, _, a in got["log"]}
        assert any(a == "evict" for _, _, a in got["log"])
    if site == "dispatch":
        assert ("dispatch", "retry") in {(s, a) for s, _, a in got["log"]}


def _fault_of(pk, fn):
    with pytest.raises(pk.serving.ServingFault) as ei:
        fn()
    return ei.value


def test_dispatch_retries_stall_and_device_lost_match_jax(pkgs):
    """Every dispatch failing burns the backoff into
    ``ServingFault("dispatch")`` (3 attempts, the InjectedFault as cause);
    a pool that never admits is a ``"stall"``; a lost device on the
    unsharded engine drains, logs ``give_up`` and raises
    ``"device_lost"``. Site, attempts, message and log equal JAX's."""
    recs = []
    for pk in pkgs:
        rec = []
        with pk.fi.injected(pk.fi.FaultSchedule.at(dispatch=range(100))):
            se = pk.serving.ServingEngine(
                pk.m, pk.params, pk.sw, strategy="specee", megatick=2,
                backoff=pk.serving.Backoff(base_s=0.0, max_attempts=3))
            se.submit(_prompts(n=1)[0], max_new_tokens=4)
            f = _fault_of(pk, se.run_to_completion)
            assert isinstance(f.cause, pk.fi.InjectedFault)
            rec.append((f.site, f.attempts, str(f),
                        [(e.site, e.action) for e in se.fault_log]))
        with pk.fi.injected(pk.fi.FaultSchedule.at(
                pool_exhausted=range(10_000))):
            se = pk.serving.ServingEngine(pk.m, pk.params, pk.sw,
                                          strategy="specee")
            se.submit(_prompts(n=1)[0], max_new_tokens=4)
            f = _fault_of(pk, lambda: se.run_to_completion(max_ticks=20))
            rec.append((f.site, str(f)))
        se = pk.serving.ServingEngine(pk.m, pk.params, pk.sw,
                                      strategy="specee", megatick=2)
        for p in _prompts(n=2):
            se.submit(p, max_new_tokens=6)
        with pk.fi.injected(pk.fi.FaultSchedule.once("device_lost",
                                                     visit=1)):
            f = _fault_of(pk, se.run_to_completion)
        rec.append((f.site, str(f), [(e.site, e.tick, e.action)
                                     for e in se.fault_log],
                    {r.uid: r.output for r in se.completed}))
        recs.append(rec)
    assert recs[0] == recs[1]
    (site, attempts, _, log), (stall, msg), (lost, _, lost_log, _) = recs[1]
    assert (site, attempts) == ("dispatch", 3)
    assert [a for _, a in log] == ["retry", "retry", "give_up"]
    assert stall == "stall" and "queued=1" in msg
    assert lost == "device_lost"
    assert [a for _, _, a in lost_log] == ["give_up"]


def test_watchdog_slow_finish_matches_jax(pkgs):
    """A finish slower than ``watchdog_s`` keeps its results and parks the
    engine on synchronous ticks for ``cooldown_ticks``."""
    got, want = _both(pkgs, _prompts(), 8, kw=lambda pk: dict(
        strategy="specee", megatick=4, watchdog_s=1e-9, cooldown_ticks=3))
    assert got == want
    assert got["log"][0][::2] == ("watchdog", "sync_fallback")
    _no_leak(got)


def test_adopt_replays_recorded_tokens_matches_jax(pkgs):
    """``adopt`` (a replica's failover): a request that already emitted 3
    tokens elsewhere prefills here, verifies them and appends the rest,
    with the recorded stats: it ends as the uninterrupted run does."""
    recs = []
    for pk in pkgs:
        prompts = _prompts(n=2, seed=5)
        ref, _ = _serve(pk, prompts, 8, strategy="specee", megatick=2)
        se = pk.serving.ServingEngine(pk.m, pk.params, pk.sw,
                                      strategy="specee", megatick=2)
        adopted = []
        for r in sorted(ref.completed, key=lambda r: r.uid):
            adopted.append(se.adopt(
                prompts[r.uid], max_new_tokens=8, recorded=r.output[:3],
                stats=(r.exit_points[:2], r.accept_lens[:2])))
        assert adopted[0].replaying and adopted[0].replay_total == 3
        se.run_to_completion()
        for a, r in zip(adopted, sorted(ref.completed, key=lambda r: r.uid)):
            assert (a.output, a.exit_points, a.accept_lens) == (
                r.output, r.exit_points, r.accept_lens)
            assert a.replayed == a.replay_total == 3
        recs.append([a.output for a in adopted])
    assert recs[0] == recs[1]


def test_one_device_only(pkgs):
    """Unsharded, ``tp_degree`` is 1 on both packages; ``remesh`` onto a
    (1, 2) mesh of repeated CPU devices and back to one device is taken
    (the remesh tests are ``tests/test_torch_replica.py`` and
    ``tests/test_torch_remesh.py``), each logging its degrees."""
    from repro_torch.launch.mesh import make_host_mesh
    J, T = pkgs
    se = tserving.ServingEngine(T.m, T.params, T.sw)
    jse = jserving.ServingEngine(J.m, J.params, J.sw)
    assert se.tp_degree == jse.tp_degree == 1
    se.remesh(make_host_mesh(1, 2, "cpu"), site="test")
    assert se.tp_degree == 2
    se.remesh(None, site="test")
    assert se.tp_degree == 1
    assert [e.detail for e in se.fault_log] == [
        "tp 1->2 readmitted=0", "tp 2->1 readmitted=0"]


# ---------------- the launcher's fault flags, on the CPU ----------------
LAUNCH = ["--smoke", "--device", "cpu", "--ci", "--megatick", "2"]


@pytest.mark.parametrize(
    "site", [s for s in tfi.SITES if s != "device_lost"])
def test_launcher_inject_recovers(site, capsys):
    """``--inject SITE --ci`` (``sigterm`` recovers in this process): the
    site fired, every request done, every page freed, tokens equal to the
    plain per-tick reference."""
    launch_serve.main(LAUNCH + ["--inject", site])
    out = capsys.readouterr().out
    assert f"[serve] injected {site} at visits" in out
    assert "CI smoke OK" in out
    assert tfi.active() is None


def test_launcher_sigterm_exits_17_then_restores(tmp_path, capsys,
                                                 monkeypatch):
    """A real SIGTERM after the first tick: the launcher's guard turns it
    into a checkpoint and exit code 17 with a committed step; ``--restore
    --ci`` then finishes equal to the reference. The guard is gone after
    each run."""
    before = signal.getsignal(signal.SIGTERM)
    real_step = tserving.ServingEngine.step

    def step_then_signal(self):
        out = real_step(self)
        if self._tick == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return out
    monkeypatch.setattr(tserving.ServingEngine, "step", step_then_signal)
    ck = str(tmp_path / "ck")
    with pytest.raises(SystemExit) as ei:
        launch_serve.main(LAUNCH + ["--checkpoint-dir", ck])
    assert ei.value.code == launch_serve.PREEMPTED_EXIT_CODE
    assert CheckpointManager(ck).latest_step() == 1
    assert signal.getsignal(signal.SIGTERM) is before
    monkeypatch.setattr(tserving.ServingEngine, "step", real_step)
    capsys.readouterr()
    launch_serve.main(LAUNCH + ["--checkpoint-dir", ck, "--restore"])
    out = capsys.readouterr().out
    assert "[serve] restored tick 1" in out and "CI smoke OK" in out
    assert signal.getsignal(signal.SIGTERM) is before


def test_launcher_oversubscribed_pool_and_fault_log(tmp_path, capsys):
    """``--num-pages 8`` holds one of the two rows' reservations: the
    engine evicts under pool pressure and still matches the reference on a
    full pool; ``--fault-log`` writes the trail as JSONL."""
    path = tmp_path / "faults.jsonl"
    launch_serve.main(["--smoke", "--device", "cpu", "--ci", "--num-pages",
                       "8", "--fault-log", str(path)])
    out = capsys.readouterr().out
    assert "CI smoke OK" in out and "evictions=" in out
    events = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert events and events[0]["seq"] == 0
    assert {e["source"] for e in events} == {"engine"}
    assert {(e["site"], e["action"]) for e in events} == {
        ("pool_pressure", "evict")}
    assert set(events[0]) == {"seq", "source", "site", "tick", "action",
                              "detail"}
