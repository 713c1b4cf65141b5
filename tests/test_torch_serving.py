"""The port's slot-based sessions, chunked-prefill scheduler and
``ServingEngine`` against the JAX package (CPU, fp32, llama2-7b smoke
config: 4 layers, 2 slots, 128-token rows of 16-token pages).

Tolerance: tokens, exit points, spans and page counts exact. The random
predictor bank makes rows exit early at threshold 0.5, so the exit path
(verify, KV propagation) is exercised too."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.api import Engine as JEngine  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.serving.server import ServingEngine as JServingEngine  # noqa
from repro_torch import bridge  # noqa: E402
from repro_torch.api import CacheSpec, DenseStrategy, Engine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.model import ModelFlags, build_model  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The smoke config's ops are tiny: one intra-op thread, so that the
    test run's parallel workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    run_j = jax_get_config("llama2-7b").smoke()
    run_t = get_config("llama2-7b").smoke()
    m_j, m_t = jbuild(run_j), build_model(run_t)
    params_j = m_j.init(jax.random.PRNGKey(0))
    sw_j = jeng.init_specee(m_j, jax.random.PRNGKey(1))
    params_t = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params_j), "cpu", torch.float32)
    sw_np = jax.tree_util.tree_map(np.asarray, sw_j)
    sw_t = bridge.specee_from_numpy(sw_np.draft, sw_np.predictors,
                                    sw_np.offline_mask, "cpu", torch.float32)
    return run_t, m_j, m_t, params_j, params_t, sw_j, sw_t


def _prompts(n, seed, lo=3, hi=14):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, int(rng.integers(lo, hi))).astype(np.int32)
            for _ in range(n)]


def _summary(results):
    return [(np.asarray(r.tokens).tolist(), np.asarray(r.counts).tolist(),
             np.asarray(r.exit_layer).tolist()) for r in results]


@pytest.mark.parametrize("strategy", ["dense", "specee"])
def test_whole_batch_sessions_paged_equal_dense_and_jax(setup, strategy):
    _, m_j, m_t, params_j, params_t, sw_j, sw_t = setup
    prompts = np.random.default_rng(2).integers(0, 512, (2, 9))
    outs = []
    for cache in ("dense", "paged"):
        for E, m, p, sw in ((JEngine, m_j, params_j, sw_j),
                            (Engine, m_t, params_t, sw_t)):
            s = E.create(m, p, sw, strategy=strategy).new_session(
                cache=cache)
            res = [s.prefill(prompts, max_new_tokens=6)]
            while not s.all_done():
                res.append(s.step())
            assert s.cache_mgr.kind == cache
            outs.append(_summary(res))
    assert all(o == outs[0] for o in outs[1:])


@pytest.mark.parametrize("cache", ["paged", "dense"])
def test_slot_session_matches_jax(setup, cache):
    """prefill_row -> step -> retire_row -> re-admit on both packages:
    tokens, spans and free pages agree after every call."""
    _, m_j, m_t, params_j, params_t, sw_j, sw_t = setup
    a, b, c = _prompts(3, seed=3)
    sessions = [JEngine.create(m_j, params_j, sw_j).new_session(
                    2, cache=cache),
                Engine.create(m_t, params_t, sw_t).new_session(
                    2, cache=cache)]
    log = [[], []]

    def record(i, s, what):
        log[i].append((what, [s.row_span(r) for r in range(2)],
                       s.cache_mgr.free_pages, s.live_rows().tolist()))

    for i, s in enumerate(sessions):
        log[i].append(s.prefill_row(0, a, max_new_tokens=4))
        record(i, s, "admit a")
        for _ in range(2):
            log[i].append(_summary([s.step()]))
        log[i].append(s.prefill_row(1, b, max_new_tokens=3))
        record(i, s, "admit b")
        log[i].append(_summary([s.step()]))
        s.retire_row(0)
        record(i, s, "retire 0")
        log[i].append(_summary([s.step()]))
        record(i, s, "tick after retire")
        log[i].append(s.prefill_row(0, c, max_new_tokens=3))
        while not s.all_done():
            log[i].append(_summary([s.step()]))
        record(i, s, "drained")
    assert log[0] == log[1]


@pytest.mark.parametrize("cache", ["paged", "dense"])
@pytest.mark.parametrize("chunk", [0, 4])
def test_serving_engine_matches_jax(setup, cache, chunk):
    """Five requests through two slots (slots are reused), blocking or
    4-token chunked admission: per-request output and exit points equal
    the JAX ServingEngine's, and every page returns to the pool."""
    _, m_j, m_t, params_j, params_t, sw_j, sw_t = setup
    prompts = _prompts(5, seed=9)       # these prompts exit early twice
    outs = []
    for E, m, p, sw in ((JServingEngine, m_j, params_j, sw_j),
                        (ServingEngine, m_t, params_t, sw_t)):
        se = E(m, p, sw, cache=cache, prefill_chunk=chunk)
        reqs = [se.submit(pr, max_new_tokens=n)
                for pr, n in zip(prompts, (5, 2, 6, 1, 4))]
        se.run_to_completion()
        assert all(r.done for r in reqs) and not se.busy
        mgr = se.session.cache_mgr
        assert mgr.free_pages == getattr(mgr, "num_pages", 0)
        outs.append([(r.output, r.exit_points) for r in reqs])
    assert outs[0] == outs[1]
    assert any(ep < m_t.num_exit_points for _, eps in outs[1] for ep in eps)


def test_retirement_compacts_row_span(setup):
    """Mirror of the JAX package's test: a finished slot's span collapses
    at retirement and its pages return; the slot readmits cleanly."""
    run, _, m, _, params, _, sw = setup
    se = ServingEngine(m, params, sw, strategy="specee", cache="paged")
    mgr = se.session.cache_mgr
    short, lng = _prompts(2, seed=3)
    r_short = se.submit(short, max_new_tokens=2)
    r_long = se.submit(lng, max_new_tokens=12)
    while not r_short.done:
        se.step()
    spans = [se.session.row_span(r) for r in range(se.B)]
    assert 0 in spans and max(spans) > 0
    assert mgr.free_pages >= mgr.num_pages - mgr.pages_per_row, \
        "retired row's pages did not return to the free list"
    se.run_to_completion()
    assert r_long.done and len(r_long.output) == 12
    assert mgr.free_pages == mgr.num_pages          # full reclamation
    assert all(se.session.row_span(r) == 0 for r in range(se.B))
    r2 = se.submit(short, max_new_tokens=3)
    se.run_to_completion()
    assert r2.done and len(r2.output) == 3


def test_chunked_prefill_interleaves_with_decode(setup):
    """While a row is live, a tick runs at most one chunk of prefill, and
    the live row keeps emitting during a long admission."""
    _, _, m, _, params, _, sw = setup
    se = ServingEngine(m, params, sw, cache="paged", prefill_chunk=4)
    first = se.submit(_prompts(1, seed=7)[0], max_new_tokens=20)
    se.step()
    assert se.slots[0] is first
    lng = se.submit(np.arange(30, dtype=np.int32), max_new_tokens=2)
    admission_ticks = 0
    while lng in se.pending:
        before = len(first.output)
        se.step()
        assert se.scheduler.last_tick_tokens <= 4
        assert len(first.output) == before + 1
        admission_ticks += 1
    assert admission_ticks >= 30 // 4
    se.run_to_completion()
    assert first.done and lng.done


def test_flash_flag_gives_same_tokens(setup):
    """``flash_attention=True`` (the flash wrapper, its plain version on
    the CPU) and the plain ``attend_full`` prefill emit the same tokens."""
    run, _, m, _, params, _, sw = setup
    prompts = _prompts(3, seed=8)
    outs = []
    for flash in (False, True):
        mf = build_model(run, ModelFlags(flash_attention=flash))
        se = ServingEngine(mf, params, sw, cache="paged", prefill_chunk=0)
        reqs = [se.submit(p, max_new_tokens=4) for p in prompts]
        se.run_to_completion()
        outs.append([(r.output, r.exit_points) for r in reqs])
    assert outs[0] == outs[1]


def test_serving_raises_on_what_is_not_ported(setup, tmp_path):
    """No silent degradation: a mesh the port does not shard (a degree
    that does not divide a MoE model's query heads) raises ValueError
    naming its ROADMAP item ("multi-GPU"); DATA > 1 and the training
    policy serve two requests as JAX's unsharded engine does; a (1, 2)
    mesh serves at tensor-parallel degree 2, and ``policy`` without a
    mesh is ignored, as JAX ignores it. The
    fault-tolerance arguments and an oversubscribed
    pool (JAX evicts) are taken as JAX takes them. Megaticks and async
    ticks are taken, with JAX's default (``async_ticks`` on when
    ``megatick > 1``) and its refusal of ``megatick < 1``; sampling (JAX's
    default strategy when ``specee=False`` and ``serve.greedy`` is off)
    builds JAX's ``DenseStrategy(temperature=serve.temperature)``."""
    from repro import serving as jserving
    from repro.api import CacheSpec as JCacheSpec
    from repro.runtime.fault import PreemptionGuard as JGuard
    from repro_torch import serving as tserving
    from repro_torch.runtime.fault import PreemptionGuard
    run, m_j, m, params_j, params, sw_j, sw = setup
    one_row = dict(kind="paged", page_size=16,
                   num_pages=run.serve.max_seq_len // 16)
    se = ServingEngine(m, params, sw, cache=CacheSpec(**one_row))
    jse = JServingEngine(m_j, params_j, sw_j, cache=JCacheSpec(**one_row))
    assert (se.session.cache_mgr.num_pages, se.B) == (
        jse.session.cache_mgr.num_pages, jse.B)
    for kw in (dict(megatick=4), dict(async_ticks=True),
               dict(megatick=2, async_ticks=False), dict()):
        se = ServingEngine(m, params, sw, **kw)
        jse = JServingEngine(m_j, params_j, sw_j, **kw)
        assert (se.megatick, se.async_ticks) == (jse.megatick,
                                                 jse.async_ticks)
        assert not se.in_flight and se.drain() == []
    with pytest.raises(ValueError, match="megatick must be >= 1"):
        ServingEngine(m, params, sw, megatick=0)

    def fault_args(pkg, guard):
        return (dict(checkpoint_dir=str(tmp_path / pkg.__name__)),
                dict(guard=guard), dict(victim=pkg.VictimPolicy(1)),
                dict(evict_patience=3), dict(watchdog_s=1.0),
                dict(backoff=pkg.Backoff(base_s=0.0)),
                dict(cooldown_ticks=2), dict(fault_log_cap=8))

    def seen(se):
        return (se.checkpoint_dir is not None, se.ckpt is not None,
                se.guard is not None, se._own_guard, se.victim.max_evictions,
                se.evict_patience, se.watchdog_s, se.backoff.base_s,
                se.backoff.max_attempts, se.cooldown_ticks, se.fault_log.cap,
                se.tp_degree)

    for kw, jkw in zip(fault_args(tserving, PreemptionGuard()),
                       fault_args(jserving, JGuard())):
        se = ServingEngine(m, params, sw, **kw)
        jse = JServingEngine(m_j, params_j, sw_j, **jkw)
        assert seen(se) == seen(jse), kw
        se.close()
        jse.close()
    from repro_torch.launch.mesh import make_host_mesh
    prompts = _prompts(2, 11, lo=6, hi=7)
    jse = JServingEngine(m_j, params_j, sw_j)
    want = [jse.submit(x, max_new_tokens=4) for x in prompts]
    jse.run_to_completion()
    jse.close()
    for kw in (dict(mesh=make_host_mesh(2, 1, "cpu")),
               dict(mesh=make_host_mesh(1, 2, "cpu"), policy="fsdp_tp")):
        se = ServingEngine(m, params, sw, **kw)
        got = [se.submit(x, max_new_tokens=4) for x in prompts]
        se.run_to_completion()
        se.close()
        assert [(r.output, r.exit_points) for r in got] == \
            [(r.output, r.exit_points) for r in want], kw
    moe = build_model(get_config("dbrx-132b").smoke())
    with pytest.raises(ValueError, match="ROADMAP: multi-GPU"):
        ServingEngine(moe, {}, None, specee=False,
                      mesh=make_host_mesh(1, 3, "cpu"))
    se = ServingEngine(m, params, sw, mesh=make_host_mesh(1, 2, "cpu"))
    assert se.tp_degree == 2
    assert (ServingEngine(m, params, sw, policy="fsdp").tp_degree
            == JServingEngine(m_j, params_j, sw_j, policy="fsdp").tp_degree
            == 1)
    sampled = build_model(dataclasses.replace(
        run, serve=dataclasses.replace(run.serve, greedy=False)))
    run_j = jax_get_config("llama2-7b").smoke()
    m_js = jbuild(dataclasses.replace(
        run_j, serve=dataclasses.replace(run_j.serve, greedy=False)))
    got = ServingEngine(sampled, params, sw, specee=False).strategy
    want = JServingEngine(m_js, params_j, sw_j, specee=False).strategy
    assert isinstance(got, DenseStrategy)
    assert (got.name, got.temperature, got.top_k) == (
        want.name, want.temperature, want.top_k) == (
        "dense", run.serve.temperature, None)
    # with SpecEE on, JAX serves the (greedy) SpecEE strategy here too
    assert ServingEngine(sampled, params, sw).strategy.name == "specee"
    with pytest.raises(ValueError, match="divide"):
        ServingEngine(m, params, sw, page_size=48)


def test_constructor_takes_jax_order_and_default_strategy(setup):
    """The cross-mode check of JAX's ``test_continuous_batching_matches_
    dense`` through both packages: ``ServingEngine(m, p, sw)`` serves SpecEE,
    ``specee=False`` (by name or as the fourth positional argument, JAX's
    order) picks JAX's default "dense", and ``prng_seed=`` is taken. The
    untrained predictor never exits unverified, so all equal JAX's dense
    serving."""
    run, m_j, m_t, params_j, params_t, sw_j, sw_t = setup
    prompts = [np.arange(5) % 512, np.arange(9) % 512,
               (np.arange(3) + 7) % 512]
    outs = {}
    for label, E, m, p, sw, args, kw in (
            ("jax dense", JServingEngine, m_j, params_j, sw_j, (),
             dict(specee=False)),
            ("specee", ServingEngine, m_t, params_t, sw_t, (),
             dict(prng_seed=3)),
            ("specee=False", ServingEngine, m_t, params_t, sw_t, (),
             dict(specee=False)),
            ("positional", ServingEngine, m_t, params_t, sw_t, (False,),
             dict(prng_seed=3))):
        se = E(m, p, sw, *args, **kw)
        assert se.strategy.name == ("specee" if label == "specee"
                                    else "dense"), label
        reqs = [se.submit(pr, max_new_tokens=n)
                for pr, n in zip(prompts, (6, 4, 5))]
        se.run_to_completion()
        assert [len(r.output) for r in reqs] == [6, 4, 5]
        outs[label] = [r.output for r in reqs]
    assert all(o == outs["jax dense"] for o in outs.values())
