"""The port's paged KV cache against the JAX package (CPU, fp32, llama2-7b
smoke config): ``core/paged`` indirection, ``PagedKVCache`` page ids, free
list and allocator state across ``from_prefill`` / ``insert_row`` /
``retire_row``, ``CacheSpec`` / ``ServeConfig`` validation, and the
``Engine.new_session`` argument order.

Tolerance: page ids, slots and gathered values exact (they are copies);
K/V written by the two prefills atol = rtol = 1e-4 (fp32 through the layer
stack, different summation order)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import Engine as JEngine  # noqa: E402
from repro.api.cache import CacheSpec as JCacheSpec  # noqa: E402
from repro.api.cache import PagedKVCache as JPagedKVCache  # noqa: E402
from repro.config import ServeConfig as JServeConfig  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import paged as jpaged  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.api import CacheSpec, Engine, PagedKVCache  # noqa: E402
from repro_torch.config import ServeConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import paged as tpaged  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small ops: one intra-op thread, so parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HTOL = dict(atol=1e-4, rtol=1e-4)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def setup():
    run_j = jax_get_config("llama2-7b").smoke()
    run_t = get_config("llama2-7b").smoke()
    m_j, m_t = jbuild(run_j), build_model(run_t)
    params_j = m_j.init(jax.random.PRNGKey(0))
    params_t = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params_j), "cpu", torch.float32)
    return m_j, m_t, params_j, params_t


def test_paged_indirection_matches_jax_property():
    """Property (hypothesis), modelled on the JAX package's round-trip
    test: for a page table assigning distinct pages per row, the port's
    slots, slab/token scatters, gathered view and position gathers equal
    ``repro.core.paged`` on the same numpy inputs, and the view equals the
    dense layout."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=25, deadline=None)
    @given(st.data())
    def run(data):
        B = data.draw(st.integers(1, 3))
        P = data.draw(st.integers(1, 4))
        ps = data.draw(st.sampled_from([2, 4, 8]))
        NP = B * P + data.draw(st.integers(0, 3)) + 1
        rng = np.random.default_rng(data.draw(st.integers(0, 2**31 - 1)))
        table = rng.permutation(NP - 1)[:B * P].reshape(B, P).astype(np.int32)
        dense = rng.standard_normal((B, P * ps, 3)).astype(np.float32)
        pos = np.broadcast_to(np.arange(P * ps)[None], (B, P * ps))
        np.testing.assert_array_equal(
            tpaged.view_slots(_t(table), ps).numpy(),
            np.asarray(jpaged.view_slots(jnp.asarray(table), ps)))
        np.testing.assert_array_equal(
            tpaged.flat_slots(_t(table), ps, _t(pos)).numpy(),
            np.asarray(jpaged.flat_slots(jnp.asarray(table), ps, pos)))
        pool_j = jpaged.scatter_slab(jnp.zeros((NP, ps, 3)), table, pos,
                                     jnp.asarray(dense))
        pool_t = tpaged.scatter_slab(torch.zeros(NP, ps, 3), _t(table),
                                     _t(pos), _t(dense))
        np.testing.assert_array_equal(pool_t.numpy(), np.asarray(pool_j))
        view = tpaged.gather_view(pool_t, _t(table)).numpy()
        np.testing.assert_array_equal(view, dense)
        np.testing.assert_array_equal(
            view, np.asarray(jpaged.gather_view(pool_j, table)))
        wpos = rng.integers(0, P * ps, B).astype(np.int32)
        vals = rng.standard_normal((B, 3)).astype(np.float32)
        pool_j = jpaged.scatter_token(pool_j, table, wpos, jnp.asarray(vals))
        out = tpaged.scatter_token(pool_t, _t(table), _t(wpos), _t(vals))
        assert out is pool_t                    # written in place
        np.testing.assert_array_equal(pool_t.numpy(), np.asarray(pool_j))
        np.testing.assert_array_equal(
            tpaged.gather_positions(pool_t, _t(table), _t(wpos)).numpy(),
            vals)
        assert tpaged.logical_capacity(_t(table), ps) == \
            jpaged.logical_capacity(table, ps)
        assert tpaged.paged_shape((B, 9, 4, 2), NP, ps) == \
            jpaged.paged_shape((B, 9, 4, 2), NP, ps)

    run()


def _prefill(m_j, m_t, params_j, params_t, tokens, max_seq):
    _, cj, _ = m_j.prefill(params_j, {"tokens": jnp.asarray(tokens)},
                           max_seq=max_seq)
    _, ct, _ = m_t.prefill(params_t, {"tokens": _t(tokens)}, max_seq=max_seq)
    return cj, ct


def _assert_same_pools(cache_t, cache_j):
    np.testing.assert_array_equal(cache_t["page_table"].numpy(),
                                  np.asarray(cache_j["page_table"]))
    np.testing.assert_array_equal(cache_t["len"].numpy(),
                                  np.asarray(cache_j["len"]))
    for seg_t, seg_j in zip(cache_t["segments"], cache_j["segments"]):
        for name in ("k", "v"):
            np.testing.assert_allclose(seg_t["u0"][name].numpy(),
                                       np.asarray(seg_j["u0"][name]), **HTOL)


@pytest.mark.parametrize("num_pages", [None, 11])
def test_paged_manager_matches_jax(setup, num_pages):
    """Same call sequence on both managers: page table, lengths, pools,
    free list and exported allocator state stay equal after every call."""
    m_j, m_t, params_j, params_t = setup
    B, S, ps = 3, 40, 16
    mgr_j = JPagedKVCache(m_j, B, S, JCacheSpec("paged", ps, num_pages))
    mgr_t = PagedKVCache(m_t, B, S, CacheSpec("paged", ps, num_pages), "cpu")
    assert (mgr_t.pages_per_row, mgr_t.num_pages, mgr_t.capacity) == \
        (mgr_j.pages_per_row, mgr_j.num_pages, mgr_j.capacity)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 512, (B, 7)).astype(np.int32)
    cj, ct = _prefill(m_j, m_t, params_j, params_t, tokens, S)
    cache_j, cache_t = mgr_j.from_prefill(cj), mgr_t.from_prefill(ct)

    def check():
        _assert_same_pools(cache_t, cache_j)
        assert mgr_t.export_state() == mgr_j.export_state()
        assert mgr_t.free_pages == mgr_j.free_pages
        assert mgr_t.can_admit() == mgr_j.can_admit()
        for r in range(B):
            assert mgr_t.row_span(cache_t, r) == mgr_j.row_span(cache_j, r)

    check()
    for op, row, n in (("retire", 1, 0), ("retire", 0, 0), ("insert", 1, 5),
                       ("retire", 2, 0), ("insert", 0, 9), ("insert", 2, 3)):
        if op == "retire":
            cache_j = mgr_j.retire_row(cache_j, row)
            cache_t = mgr_t.retire_row(cache_t, row)
        else:
            one = rng.integers(0, 512, (1, n)).astype(np.int32)
            rj, rt = _prefill(m_j, m_t, params_j, params_t, one, S)
            cache_j = mgr_j.insert_row(cache_j, row, rj)
            cache_t = mgr_t.insert_row(cache_t, row, rt)
        check()
    # the gathered view of a re-admitted row is its own prefill's K/V
    view = tpaged.gather_view(cache_t["segments"][0]["u0"]["k"][0],
                              cache_t["page_table"])
    assert torch.equal(view[2, :3], rt["segments"][0]["u0"]["k"][0, 0, :3])
    # allocator state round-trips
    fresh = PagedKVCache(m_t, B, S, CacheSpec("paged", ps, num_pages), "cpu")
    fresh.import_state(mgr_t.export_state())
    assert fresh.export_state() == mgr_t.export_state()


def test_paged_manager_exhaustion_matches_jax(setup):
    m_j, m_t, _, _ = setup
    with pytest.raises(ValueError, match="cannot hold even one row"):
        JPagedKVCache(m_j, 2, 40, JCacheSpec("paged", 16, 2))
    with pytest.raises(ValueError, match="cannot hold even one row"):
        PagedKVCache(m_t, 2, 40, CacheSpec("paged", 16, 2), "cpu")
    mgr = PagedKVCache(m_t, 2, 40, CacheSpec("paged", 16, 4), "cpu")
    mgr._alloc_row(0)
    assert not mgr.can_admit()
    with pytest.raises(RuntimeError, match="pool exhausted"):
        mgr._alloc_row(1)
    with pytest.raises(ValueError, match="same cache layout"):
        mgr.import_state({"kind": "dense"})


@pytest.mark.parametrize("kw", [dict(page_size=0), dict(page_size=100),
                                dict(prefill_chunk=-1), dict(max_seq_len=48,
                                                             page_size=16)])
def test_serve_config_validation_matches_jax(kw):
    raised = []
    for cls in (JServeConfig, ServeConfig):
        try:
            cls(**kw)
            raised.append(None)
        except ValueError as err:
            raised.append(str(err))
    assert raised[0] == raised[1]
    j, t = jax_get_config("llama2-7b").smoke(), get_config("llama2-7b").smoke()
    for f in dataclasses.fields(ServeConfig):
        assert getattr(t.serve, f.name) == getattr(j.serve, f.name), f.name


@pytest.mark.parametrize("spec", ["dense", "paged", None,
                                  dict(kind="tiled"), dict(page_size=0)])
def test_cache_spec_matches_jax(spec):
    serve = get_config("llama2-7b").smoke().serve
    if isinstance(spec, dict):
        for cls in (JCacheSpec, CacheSpec):
            with pytest.raises(ValueError, match="CacheSpec"):
                cls(**spec)
        return
    a = CacheSpec.resolve(spec, serve)
    b = JCacheSpec.resolve(spec, serve)
    assert (a.kind, a.page_size, a.num_pages) == \
        (b.kind, b.page_size, b.num_pages)
    assert CacheSpec.resolve(a) is a


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_new_session_takes_batch_first(setup, cache):
    """``new_session(2)`` means two slots in both packages (the JAX order
    ``(batch, max_seq, ..., cache)``)."""
    m_j, m_t, params_j, params_t = setup
    s_j = JEngine.create(m_j, params_j, strategy="dense").new_session(
        2, cache=cache)
    s_t = Engine.create(m_t, params_t, strategy="dense").new_session(
        2, cache=cache)
    assert s_t.batch == s_j.batch == 2
    assert s_t._max_seq == s_j._max_seq == m_t.run.serve.max_seq_len
    assert s_t.cache_mgr.kind == s_j.cache_mgr.kind == cache
    assert s_t.all_done() and not s_t.live_rows().any()
    assert s_t._retired == s_j._retired == {0, 1}    # retired from birth
    assert Engine.create(m_t, params_t, strategy="dense").new_session(
        ).batch is None


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_new_session_positional_args_match_jax(setup, cache):
    """``new_session(batch, max_seq, prng_seed, cache)`` positionally means
    the same in both packages (JAX ``session.py:210-214``): the third
    argument is the seed (ignored by the greedy paths), not the cache."""
    m_j, m_t, params_j, params_t = setup
    s_j = JEngine.create(m_j, params_j, strategy="dense").new_session(
        2, 64, 0, cache)
    s_t = Engine.create(m_t, params_t, strategy="dense").new_session(
        2, 64, 0, cache)
    assert s_t.batch == s_j.batch == 2
    assert s_t._max_seq == s_j._max_seq == 64
    assert s_t.cache_mgr.kind == s_j.cache_mgr.kind == cache
    s_t = Engine.create(m_t, params_t, strategy="dense").new_session(
        2, 64, 7)
    assert s_t.cache_mgr.kind == "dense"


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_single_tick_step_result_matches_jax(setup, cache):
    """The single-tick ``StepResult`` surface of JAX's ``api/types.py``:
    ``width``, ``ticks == 1``, ``is_megatick`` False, ``row_exit_points`` and
    ``row_accept_lens`` equal JAX's on every tick; ``step(num_ticks=1)`` is
    one tick, and ``step(num_ticks=2)`` is a megatick result
    (``is_megatick``, ``ticks`` <= 2) equal to JAX's."""
    m_j, m_t, params_j, params_t = setup
    prompts = np.random.default_rng(6).integers(0, 512, (2, 7))
    logs = []
    for E, m, p, arr in ((JEngine, m_j, params_j, jnp.asarray),
                         (Engine, m_t, params_t, _t)):
        s = E.create(m, p, strategy="dense").new_session(cache=cache)
        res = [s.prefill(arr(prompts), max_new_tokens=4)]
        res += [s.step(num_ticks=1), s.step(), s.step(num_ticks=None)]
        assert s.all_done()
        logs.append([(r.width, int(r.ticks), r.is_megatick, r.tick_counts,
                      r.tick_live, [r.row_exit_points(i) for i in range(2)],
                      [r.row_accept_lens(i) for i in range(2)],
                      [r.row_tokens(i) for i in range(2)]) for r in res])
    assert logs[0] == logs[1]
    assert logs[1][0][:3] == (1, 1, False)
    logs = []
    for E, m, p, arr in ((JEngine, m_j, params_j, jnp.asarray),
                         (Engine, m_t, params_t, _t)):
        s = E.create(m, p, strategy="dense").new_session(cache=cache)
        s.prefill(arr(prompts), max_new_tokens=4)
        res = []
        while not s.all_done():
            res.append(s.step(num_ticks=2))
        logs.append([(r.width, int(r.ticks), r.is_megatick,
                      [np.asarray(x).tolist() for x in
                       (r.tokens, r.counts, r.done, r.exit_layer,
                        r.tick_counts, r.tick_live)],
                      [r.row_exit_points(i) for i in range(2)],
                      [r.row_tokens(i) for i in range(2)]) for r in res])
    assert logs[0] == logs[1]
    assert [r[1:3] for r in logs[1]] == [(2, True), (1, True)]


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_row_pages_matches_jax(setup, cache):
    """``row_pages`` on both managers after admission, retirement and
    re-admission equals JAX's (0 throughout in the dense layout)."""
    m_j, m_t, params_j, params_t = setup
    rng = np.random.default_rng(7)
    a, b = (rng.integers(0, 512, n).astype(np.int32) for n in (5, 9))
    sessions = [JEngine.create(m_j, params_j, strategy="dense").new_session(
                    2, 40, 0, cache),
                Engine.create(m_t, params_t, strategy="dense").new_session(
                    2, 40, 0, cache)]
    logs = [[], []]
    for i, s in enumerate(sessions):
        mgr = s.cache_mgr
        logs[i].append([mgr.row_pages(r) for r in range(2)])
        s.prefill_row(0, a, max_new_tokens=3)
        logs[i].append([mgr.row_pages(r) for r in range(2)])
        s.prefill_row(1, b, max_new_tokens=3)
        s.retire_row(0)
        logs[i].append([mgr.row_pages(r) for r in range(2)])
        s.prefill_row(0, b, max_new_tokens=3)
        logs[i].append([mgr.row_pages(r) for r in range(2)])
    assert logs[0] == logs[1]
    if cache == "paged":
        assert logs[1][1] == [sessions[1].cache_mgr.pages_per_row, 0]
