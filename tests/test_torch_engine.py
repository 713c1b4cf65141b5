"""The port's SpecEE slice against the JAX package on the llama2-7b smoke
config (fp32, CPU): scheduler, draft, ``ar_decode_step`` /
``dense_decode_step`` and the Engine/DecodeSession surface.

The JAX side runs with ``exit_gate_kernel=True, exit_gate_impl="kernel",
decode_kernel=True`` — its four Pallas kernels in interpret mode — and the
port with the same flags, where every wrapper runs its plain version on the
CPU. Tolerance: tokens and StepInfo (exit_point, exited, units_run,
spec_hit) exact; hidden states atol = rtol = 1e-4 (fp32 through the layer
stack, different summation order)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import Engine as JEngine  # noqa: E402
from repro.api import SpecEEStrategy as JSpecEE  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import draft as jdraft  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core import scheduler as jsched  # noqa: E402
from repro.models.model import ModelFlags as JFlags  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.api import (DenseStrategy, Engine, SpecEEStrategy,  # noqa
                             TreeStrategy, get_strategy)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import draft as tdraft  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import scheduler as tsched  # noqa: E402
from repro_torch.models.model import ModelFlags, build_model  # noqa: E402

HTOL = dict(atol=1e-4, rtol=1e-4)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def setup():
    run_j = jax_get_config("llama2-7b").smoke()
    run_t = get_config("llama2-7b").smoke()
    m_j = jbuild(run_j, JFlags(exit_gate_kernel=True, exit_gate_impl="kernel",
                               decode_kernel=True))
    m_t = build_model(run_t, ModelFlags(exit_gate_kernel=True,
                                        exit_gate_impl="kernel",
                                        decode_kernel=True))
    params_j = m_j.init(jax.random.PRNGKey(0))
    sw_j = jeng.init_specee(m_j, jax.random.PRNGKey(1))
    params_t = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params_j), "cpu", torch.float32)
    sw_np = jax.tree_util.tree_map(np.asarray, sw_j)
    sw_t = bridge.specee_from_numpy(sw_np.draft, sw_np.predictors,
                                    sw_np.offline_mask, "cpu", torch.float32)
    prompts = np.random.default_rng(4).integers(
        0, run_t.model.vocab_size, (2, 8)).astype(np.int32)
    return run_j, run_t, m_j, m_t, params_j, params_t, sw_j, sw_t, prompts


def test_scheduler_matches_jax():
    spec = get_config("llama2-7b").specee
    spec_j = jax_get_config("llama2-7b").specee
    E = 16
    st_j = jsched.init_state(3, spec_j)
    st_t = tsched.init_state(3, spec, "cpu")
    offline = np.zeros(E, bool)
    offline[[0, 7]] = True
    for pts in ([3, 15, 9], [4, 0, 9], [12, 12, 1]):
        np.testing.assert_array_equal(
            _np(tsched.active_mask(st_t, _t(offline), spec, E)),
            _np(jsched.active_mask(st_j, jnp.asarray(offline), spec_j, E)))
        st_j = jsched.update(st_j, jnp.asarray(pts, jnp.int32))
        st_t = tsched.update(st_t, torch.tensor(pts, dtype=torch.int32))
        np.testing.assert_array_equal(_np(st_t["queue"]), _np(st_j["queue"]))
        np.testing.assert_array_equal(_np(st_t["qpos"]), _np(st_j["qpos"]))


def test_draft_matches_jax(setup):
    run_j, run_t, m_j, m_t, params_j, params_t, sw_j, sw_t, prompts = setup
    cfg_j, cfg_t = run_j.model, run_t.model
    rng = np.random.default_rng(5)
    B, S, D = 2, 6, cfg_t.d_model
    emb = rng.standard_normal((B, S, D)).astype(np.float32)
    hs = rng.standard_normal((B, S, D)).astype(np.float32)
    dc_j = jdraft.draft_prefill(cfg_j, sw_j.draft, emb, hs, 10)
    dc_t = tdraft.draft_prefill(cfg_t, sw_t.draft, _t(emb), _t(hs), 10)
    np.testing.assert_allclose(_np(dc_t["k"]), _np(dc_j["k"]), **HTOL)
    e1 = rng.standard_normal((B, D)).astype(np.float32)
    h1 = rng.standard_normal((B, D)).astype(np.float32)
    pos = np.array([6, 6], np.int32)
    hd_j, dc_j = jdraft.draft_step(cfg_j, sw_j.draft, e1, h1, dc_j, pos)
    hd_t, dc_t = tdraft.draft_step(cfg_t, sw_t.draft, _t(e1), _t(h1), dc_t,
                                   _t(pos))
    np.testing.assert_allclose(_np(hd_t), _np(hd_j), **HTOL)
    np.testing.assert_allclose(_np(dc_t["v"]), _np(dc_j["v"]), **HTOL)
    ids_j, _ = jdraft.propose_topk(m_j, params_j, hd_j, 4)
    ids_t, _ = tdraft.propose_topk(m_t, params_t, hd_t, 4)
    np.testing.assert_array_equal(_np(ids_t), _np(ids_j))


def _run_jax(m, params, sw, prompts, thresh, steps, override=None):
    first, st = jeng.init_decode_state(m, params, sw,
                                       {"tokens": jnp.asarray(prompts)},
                                       prompts.shape[1] + steps + 1)
    out = [(_np(first), None)]
    for _ in range(steps):
        tok, st, info = jeng.ar_decode_step(m, params, sw, st,
                                            threshold=thresh,
                                            spec_ids_override=override)
        out.append((_np(tok), jax.tree_util.tree_map(_np, info)))
    return out, st


def _run_torch(m, params, sw, prompts, thresh, steps, override=None):
    first, st = teng.init_decode_state(m, params, sw,
                                       {"tokens": _t(prompts)},
                                       prompts.shape[1] + steps + 1)
    out = [(_np(first), None)]
    for _ in range(steps):
        tok, st, info = teng.ar_decode_step(
            m, params, sw, st, threshold=thresh,
            spec_ids_override=None if override is None else _t(override))
        out.append((_np(tok), info))
    return out, st


def _assert_same(out_t, out_j):
    for (tok_t, info_t), (tok_j, info_j) in zip(out_t, out_j):
        np.testing.assert_array_equal(tok_t, tok_j)
        if info_j is None:
            continue
        np.testing.assert_array_equal(_np(info_t.exit_point),
                                      info_j.exit_point)
        np.testing.assert_array_equal(_np(info_t.exited), info_j.exited)
        np.testing.assert_array_equal(_np(info_t.spec_hit), info_j.spec_hit)
        assert info_t.units_run == int(info_j.units_run)


@pytest.mark.parametrize("thresh", [1.5, 0.4, -0.1])
def test_ar_decode_step_matches_jax(setup, thresh):
    run_j, run_t, m_j, m_t, params_j, params_t, sw_j, sw_t, prompts = setup
    out_j, st_j = _run_jax(m_j, params_j, sw_j, prompts, thresh, 2)
    out_t, st_t = _run_torch(m_t, params_t, sw_t, prompts, thresh, 2)
    _assert_same(out_t, out_j)
    np.testing.assert_allclose(_np(st_t.h_last), _np(st_j.h_last), **HTOL)
    np.testing.assert_array_equal(_np(st_t.cache["len"]),
                                  _np(st_j.cache["len"]))
    np.testing.assert_allclose(_np(st_t.cache["segments"][0]["u0"]["k"]),
                               _np(st_j.cache["segments"][0]["u0"]["k"]),
                               **HTOL)
    np.testing.assert_array_equal(_np(st_t.sched["queue"]),
                                  _np(st_j.sched["queue"]))


def test_ar_oracle_override_exits_like_jax(setup):
    """An oracle speculative set holding the layer-1 argmax forces an exit
    at exit point 1 (threshold < 0): exits, early stop of the layer loop
    (units_run) and KV propagation of the skipped units all match."""
    run_j, run_t, m_j, m_t, params_j, params_t, sw_j, sw_t, prompts = setup
    first, st = jeng.init_decode_state(m_j, params_j, sw_j,
                                       {"tokens": jnp.asarray(prompts)}, 10)
    h = m_j.embed(params_j, first[:, None])[:, 0, :]
    seg = st.cache["segments"][0]
    for u in range(2):
        h, seg = m_j.run_unit(params_j, 0, jnp.int32(u), h, seg,
                              st.cache["len"])
    tgt = jnp.argmax(m_j.logits(params_j, h), -1).astype(jnp.int32)
    override = np.stack([_np(tgt)] * 4, axis=1)
    out_j, st_j = _run_jax(m_j, params_j, sw_j, prompts, -0.1, 1, override)
    out_t, st_t = _run_torch(m_t, params_t, sw_t, prompts, -0.1, 1, override)
    _assert_same(out_t, out_j)
    info = out_t[1][1]
    assert bool(info.exited.all()) and info.exit_point.tolist() == [1, 1]
    assert info.units_run == 2
    np.testing.assert_allclose(_np(st_t.cache["segments"][0]["u0"]["v"]),
                               _np(st_j.cache["segments"][0]["u0"]["v"]),
                               **HTOL)


def test_dense_decode_step_matches_jax(setup):
    run_j, run_t, m_j, m_t, params_j, params_t, sw_j, sw_t, prompts = setup
    _, st_j = jeng.init_decode_state(m_j, params_j, None,
                                     {"tokens": jnp.asarray(prompts)}, 12)
    _, st_t = teng.init_decode_state(m_t, params_t, None,
                                     {"tokens": _t(prompts)}, 12)
    for _ in range(2):
        tok_j, st_j, info_j = jeng.dense_decode_step(m_j, params_j, None,
                                                     st_j)
        tok_t, st_t, info_t = teng.dense_decode_step(m_t, params_t, None,
                                                     st_t)
        np.testing.assert_array_equal(_np(tok_t), _np(tok_j))
        assert info_t.units_run == int(info_j.units_run)
    from repro.api.cache import CacheSpec, DenseKVCache as JDense
    from repro_torch.api.cache import CacheSpec as TCacheSpec, DenseKVCache
    kc_t = DenseKVCache(m_t, 3, 9, TCacheSpec(), "cpu").empty_cache()
    kc_j = JDense(m_j, 3, 9, CacheSpec()).empty_cache()
    assert kc_t["segments"][0]["u0"]["k"].shape == \
        kc_j["segments"][0]["u0"]["k"].shape
    empty = teng.empty_decode_state(m_t, sw_t, 3, 9, "cpu")
    ref = jeng.empty_decode_state(m_j, sw_j, 3, 9)
    assert empty.draft_cache["k"].shape == ref.draft_cache["k"].shape
    assert empty.h_last.shape == ref.h_last.shape


def _drain(session, first):
    toks = [first.row_tokens(b) for b in range(first.batch)]
    units = []
    while not session.all_done():
        res = session.step()
        units.append(res.units_run)
        for b in range(res.batch):
            toks[b].extend(res.row_tokens(b))
    return toks, units


def test_session_matches_jax_and_dense(setup):
    """Through Engine → new_session → prefill → step: SpecEE at threshold
    1.5 equals dense greedy in the port, and the port's SpecEE session
    emits the JAX session's tokens and units_run (JAX on its reference
    path, jitted)."""
    run_j, run_t, m_j, m_t, params_j, params_t, sw_j, sw_t, prompts = setup
    outs = {}
    for name, strat in [("dense", DenseStrategy()),
                        ("specee", SpecEEStrategy(threshold=1.5)),
                        ("exits", SpecEEStrategy(threshold=0.4))]:
        s = Engine.create(m_t, params_t, sw_t, strategy=strat).new_session()
        outs[name] = _drain(s, s.prefill(prompts, max_new_tokens=4))
    assert outs["dense"][0] == outs["specee"][0]
    assert all(len(t) == 4 for t in outs["dense"][0])
    m_ref = jbuild(run_j)
    s = JEngine.create(m_ref, params_j, sw_j,
                       strategy=JSpecEE(threshold=0.4)).new_session()
    toks_j, units_j = _drain(s, s.prefill(jnp.asarray(prompts),
                                          max_new_tokens=4))
    assert outs["exits"][0] == toks_j
    assert outs["exits"][1] == [int(u) for u in units_j]


def test_strategy_resolution(setup):
    run_j, run_t, m_j, m_t, params_j, params_t, sw_j, sw_t, prompts = setup
    assert isinstance(get_strategy("dense"), DenseStrategy)
    assert isinstance(get_strategy("ar"), SpecEEStrategy)
    assert isinstance(get_strategy("tree"), TreeStrategy)
    with pytest.raises(ValueError):
        get_strategy("beam")
    with pytest.raises(ValueError):
        Engine.create(m_t, params_t, None, strategy="specee")
