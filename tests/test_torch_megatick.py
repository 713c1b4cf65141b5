"""The port's megaticks and async tick pipeline against the JAX package
(CPU, fp32, llama2-7b smoke config, weights bridged from JAX):
``engine.megatick_decode`` through ``DecodeSession.step(num_ticks=K)``,
``step_async`` / ``finish_step`` / ``abort_async`` and
``ServingEngine(megatick=K)``. Each case of ``tests/test_megatick.py``
has its counterpart here, on the port; JAX's donation case becomes a
check that a handle's tensors survive the next megatick and the carry
mirrors, since the port updates its cache in place. The port's megatick
results are also held against JAX's ``step(num_ticks=4)`` directly, and
a quantized engine and mamba2-130m against their single steps.

Tolerance: tokens and every integer field (counts, the per-tick planes,
ticks, units_run, done) exact."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import Engine as JEngine  # noqa: E402
from repro.api import SpecEEStrategy as JSpecEE  # noqa: E402
from repro.api import TreeStrategy as JTree  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core.tree import TreeSpec as JTreeSpec  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.api import (DenseStrategy, Engine, SpecEEStrategy,  # noqa
                             TreeStrategy)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import engine as eng  # noqa: E402
from repro_torch.core.tree import TreeSpec  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402


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


def _prompts(B=2, T=8, seed=4):
    return np.random.default_rng(seed).integers(0, 512, (B, T))


def _strategy(name):
    return {"dense": DenseStrategy(),
            "specee": SpecEEStrategy(),
            "tree": TreeStrategy(tree=TreeSpec(depth=2, branch=3))}[name]


def _drain(session, first, K=None):
    """Step until every row is done: tokens, exit points and accept
    lengths per row, and units_run summed."""
    toks = [first.row_tokens(b) for b in range(first.batch)]
    stats = [[] for _ in range(first.batch)]
    units = 0
    while not session.all_done():
        res = session.step(num_ticks=K)
        if K is not None and K > 1:
            assert res.is_megatick and 1 <= int(res.ticks) <= K
        units += int(res.units_run)
        for b in range(res.batch):
            toks[b].extend(res.row_tokens(b))
            stats[b].extend(zip(res.row_exit_points(b),
                                res.row_accept_lens(b)))
    return toks, stats, units


# ---------------- token parity: one megatick == K single steps ----------
@pytest.mark.parametrize("cache", ["dense", "paged"])
@pytest.mark.parametrize("strategy", ["dense", "specee", "tree"])
def test_megatick_token_parity(setup, strategy, cache):
    """``step(num_ticks=3)`` with a budget of 8 (exhausted mid-megatick)
    equals single steps: tokens, per-tick exit points and accept lengths,
    and units_run."""
    _, _, m, _, params, _, sw = setup
    prompts = _prompts(seed=11)
    e = Engine.create(m, params, sw, strategy=_strategy(strategy))
    s1 = e.new_session(cache=cache)
    ref = _drain(s1, s1.prefill(prompts, max_new_tokens=8))
    s2 = e.new_session(cache=cache)
    got = _drain(s2, s2.prefill(prompts, max_new_tokens=8), 3)
    assert got == ref
    assert all(len(t) == 8 for t in got[0])


@pytest.mark.parametrize("strategy", ["specee", "tree"])
def test_megatick_eos_mid_flight(setup, strategy):
    """A row hitting EOS inside a megatick is cut exactly where the host
    accounting cuts it, and emits nothing for the rest of the megatick."""
    _, _, m, _, params, _, sw = setup
    prompts = _prompts(seed=12)
    e = Engine.create(m, params, sw, strategy=_strategy(strategy))
    s = e.new_session()
    ref = _drain(s, s.prefill(prompts, max_new_tokens=10))[0]
    eos = ref[0][4]                     # fires for row 0 at position 4
    s1 = e.new_session()
    want = _drain(s1, s1.prefill(prompts, max_new_tokens=10, eos_token=eos))
    s2 = e.new_session()
    got = _drain(s2, s2.prefill(prompts, max_new_tokens=10, eos_token=eos),
                 4)
    # a single-tick result reports every row's exit point, a megatick's
    # only the live ticks': compare tokens and units_run
    assert (got[0], got[2]) == (want[0], want[2])
    assert got[0][0] == ref[0][:ref[0].index(eos) + 1]


def test_megatick_result_contract(setup):
    """The widened StepResult: (B, K·W) tokens, (B, K) planes, tick_counts
    summing to counts, no live row beyond the ticks run."""
    _, _, m, _, params, _, sw = setup
    K = 4
    e = Engine.create(m, params, sw, strategy=_strategy("tree"))
    s = e.new_session()
    s.prefill(_prompts(seed=13), max_new_tokens=16)
    res = s.step(num_ticks=K)
    B, W = 2, e.emit_width
    assert res.tokens.shape == (B, K * W)
    assert res.counts.shape == (B,)
    for plane in (res.exit_layer, res.accept_len, res.exited,
                  res.tick_counts, res.tick_live):
        assert plane.shape == (B, K)
    assert isinstance(res.ticks, int) and 1 <= res.ticks <= K
    assert isinstance(res.units_run, int)
    np.testing.assert_array_equal(res.tick_counts.sum(axis=1), res.counts)
    for t in range(res.ticks, K):
        assert not res.tick_live[:, t].any()


# ---------------- handles own their tensors ----------------
def test_handle_tensors_survive_next_megatick_and_mirrors(setup):
    """The port's counterpart of JAX's donation check: the cache is
    updated in place, so what matters is that handle N's ``out`` and
    ``carry`` keep their values after megatick N+1 is dispatched (it
    consumes N's carry) and after ``retire_row`` / ``prefill_row`` mirror
    onto the carry, and that the mirror reaches the next megatick's
    input."""
    _, _, m, _, params, _, sw = setup
    e = Engine.create(m, params, sw, strategy="specee")
    s = e.new_session(batch=2, cache="paged")
    p = _prompts(seed=14)
    s.prefill_row(0, p[0], max_new_tokens=3)
    s.prefill_row(1, p[1], max_new_tokens=9)

    def values(h):
        return {(name, k): (v.clone() if isinstance(v, torch.Tensor)
                            else v)
                for name, part in (("out", h.out), ("carry", h.carry))
                for k, v in part.items()}

    def same(h, want):
        got = values(h)
        assert got.keys() == want.keys()
        for k in want:
            assert (torch.equal(got[k], want[k])
                    if isinstance(want[k], torch.Tensor)
                    else got[k] == want[k]), k

    h1 = s.step_async(2)
    v1 = values(h1)
    h2 = s.step_async(2)            # consumes h1's carry
    same(h1, v1)
    assert s.in_flight == 2
    r1 = s.finish_step(h1)
    assert r1.done[0]
    v2 = values(h2)
    s.retire_row(0)
    same(h2, v2)
    assert h2.dirty == {0}
    assert bool(s._dev_carry["retired"][0]) and bool(s._dev_carry["done"][0])
    s.prefill_row(0, p[0], max_new_tokens=5)
    same(h2, v2)
    carry = s._dev_carry
    assert not bool(carry["done"][0]) and not bool(carry["retired"][0])
    assert int(carry["budget"][0]) == 5 and int(carry["emitted"][0]) == 1
    s.finish_step(h2)
    assert s.in_flight == 0 and not s.row_done(0)
    while not s.all_done():
        s.step(num_ticks=2)
    assert s._emitted[0] == 5 and s._emitted[1] == 9


def test_retained_cache_unaffected_by_megatick_manager(setup):
    """The paged manager's host bookkeeping (free pages, row pages) stays
    coherent through megaticks with retirement between them, and a
    retired row's span stays pinned at 0."""
    _, _, m, _, params, _, sw = setup
    e = Engine.create(m, params, sw, strategy="specee")
    s = e.new_session(batch=2, cache="paged")
    mgr = s.cache_mgr
    free0 = mgr.free_pages
    s.prefill_row(0, _prompts(seed=15)[0], max_new_tokens=4)
    assert mgr.free_pages < free0
    while not s.all_done():
        s.step(num_ticks=2)
    s.retire_row(0)
    assert mgr.free_pages == free0
    s.prefill_row(1, _prompts(seed=16)[1], max_new_tokens=3)
    while not s.all_done():
        s.step(num_ticks=2)
    assert s.row_span(0) == 0


# ---------------- async pipeline ----------------
def test_finish_step_preserves_readmitted_row(setup):
    """Host bookkeeping edited between a megatick's dispatch and its finish
    (retire + re-admit of a slot) survives the finish: the new occupant is
    neither marked done nor given the old one's emitted count."""
    _, _, m, _, params, _, sw = setup
    e = Engine.create(m, params, sw, strategy="specee")
    s = e.new_session(batch=2, cache="paged")
    p = _prompts(seed=19)
    s.prefill_row(0, p[0], max_new_tokens=2)
    s.prefill_row(1, p[1], max_new_tokens=8)
    h1 = s.step_async(4)            # row 0 exhausts its budget mid-megatick
    h2 = s.step_async(4)            # dispatched before h1 is read
    r1 = s.finish_step(h1)
    assert r1.done[0]
    s.retire_row(0)
    s.prefill_row(0, p[0], max_new_tokens=8)   # re-admit: h2 in flight
    assert not s._done[0]
    s.finish_step(h2)
    assert not s._done[0], "finish rolled a re-admitted row back to done"
    assert s._emitted[0] <= 1, "re-admitted row inherited old emitted count"
    assert not s.all_done()
    while not s.all_done():
        s.step(num_ticks=4)
    assert s._emitted[0] == 8


def test_step_async_pipeline_parity(setup):
    """Two megaticks dispatched back to back (N+1 before N is read) emit
    what two synchronous megaticks emit; an out-of-order finish raises and
    ``abort_async`` forgets what is in flight."""
    _, _, m, _, params, _, sw = setup
    prompts = _prompts(seed=17)
    e = Engine.create(m, params, sw, strategy="specee")
    s1 = e.new_session()
    s1.prefill(prompts, max_new_tokens=9)
    sync = []
    while not s1.all_done():
        res = s1.step(num_ticks=2)
        sync.append([res.row_tokens(b) for b in range(2)])
    s2 = e.new_session()
    s2.prefill(prompts, max_new_tokens=9)
    h1 = s2.step_async(2)
    h2 = s2.step_async(2)
    r1, r2 = s2.finish_step(h1), s2.finish_step(h2)
    assert [r1.row_tokens(b) for b in range(2)] == sync[0]
    assert [r2.row_tokens(b) for b in range(2)] == sync[1]
    h3 = s2.step_async(2)
    h4 = s2.step_async(2)
    with pytest.raises(AssertionError):
        s2.finish_step(h4)
    s2.finish_step(h3)
    s2.finish_step(h4)
    s2.step_async(2)
    with pytest.raises(AssertionError, match="in flight"):
        s2.step()
    s2.abort_async()
    assert s2.in_flight == 0 and s2._dev_carry is None
    s2.step()                       # the host mirrors rebuild the carry


@pytest.mark.parametrize("strategy", ["specee", "tree"])
def test_serving_megatick_matches_blocking(setup, strategy):
    """``ServingEngine(megatick=4)`` (async by default) serves the same
    per-request tokens, exit points and accept lengths as the per-tick
    engine, across retire + re-admit waves, with every page returned."""
    _, _, m, _, params, _, sw = setup
    rng = np.random.default_rng(18)
    prompts = [rng.integers(0, 512, int(rng.integers(4, 10)))
               for _ in range(4)]
    outs = {}
    for megatick in (1, 4):
        se = ServingEngine(m, params, sw, strategy=_strategy(strategy),
                           megatick=megatick)
        assert se.async_ticks == (megatick > 1)
        reqs = [se.submit(p, max_new_tokens=6) for p in prompts]
        se.run_to_completion()
        assert not se.in_flight and se.drain() == []
        assert all(r.done and len(r.output) == 6 for r in reqs)
        outs[megatick] = [(r.output, r.exit_points, r.accept_lens)
                          for r in reqs]
        mgr = se.session.cache_mgr
        assert mgr.free_pages == mgr.num_pages, "page leak under megatick"
    assert outs[4] == outs[1]


# ---------------- against JAX ----------------
def _megaticks(E, model, params, sw, strategy, prompts, cache):
    s = E.create(model, params, sw, strategy=strategy).new_session(
        cache=cache)
    s.prefill(prompts, max_new_tokens=7)
    out = []
    while not s.all_done():
        r = s.step(num_ticks=4)
        out.append([np.asarray(x).tolist() for x in
                    (r.tokens, r.counts, r.exit_layer, r.accept_len,
                     r.exited, r.tick_counts, r.tick_live, r.done)]
                   + [int(r.ticks), int(r.units_run)])
    return out


@pytest.mark.parametrize("strategy,cache", [("specee", "paged"),
                                            ("tree", "dense")])
def test_megatick_matches_jax(setup, strategy, cache):
    """For the same prompts and weights, every megatick's tokens, counts,
    five planes, ticks, units_run and done equal JAX's
    ``step(num_ticks=4)``; the budget of 7 runs out inside a megatick."""
    _, m_j, m_t, params_j, params_t, sw_j, sw_t = setup
    prompts = _prompts(seed=20)
    s_j, s_t = ((JSpecEE(), SpecEEStrategy()) if strategy == "specee" else
                (JTree(tree=JTreeSpec(2, 3)), TreeStrategy(tree=TreeSpec(2, 3))))
    want = _megaticks(JEngine, m_j, params_j, sw_j, s_j,
                      jnp.asarray(prompts), cache)
    got = _megaticks(Engine, m_t, params_t, sw_t, s_t, prompts, cache)
    assert got == want
    assert any(t < 4 for *_, t, _ in got)


# ---------------- quant and mamba2 ----------------
def test_quant_megatick_matches_single_steps(setup):
    """``Engine.create(quant="int8")``: megaticks read
    ``decode_weights()`` as single steps do (threshold -0.1 sends every
    active exit point through the quantized gate and verify)."""
    _, _, m, _, params, _, sw = setup
    e = Engine.create(m, params, sw, strategy=SpecEEStrategy(threshold=-0.1),
                      quant="int8")
    prompts = _prompts(seed=21)
    s1 = e.new_session(cache="paged")
    ref = _drain(s1, s1.prefill(prompts, max_new_tokens=8))
    s2 = e.new_session(cache="paged")
    assert _drain(s2, s2.prefill(prompts, max_new_tokens=8), 4) == ref


def test_mamba2_megatick_matches_single_steps():
    """mamba2-130m (smoke): SSD state entries carry the same ``len`` as
    attention caches, so megaticks equal single steps unchanged, on both
    cache layouts."""
    m = build_model(get_config("mamba2-130m").smoke())
    gen = torch.Generator().manual_seed(0)
    params = m.init(gen, "cpu")
    sw = eng.init_specee(m, gen, "cpu")
    e = Engine.create(m, params, sw, strategy=SpecEEStrategy(threshold=-0.1))
    prompts = _prompts(seed=22)
    for cache in ("dense", "paged"):
        s1 = e.new_session(cache=cache)
        ref = _drain(s1, s1.prefill(prompts, max_new_tokens=7))
        s2 = e.new_session(cache=cache)
        assert _drain(s2, s2.prefill(prompts, max_new_tokens=7), 4) == ref
