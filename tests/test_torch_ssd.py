"""The port's Mamba2 slice against the JAX package on the mamba2-130m
smoke config (4 SSD layers, D=128, 4 heads of 32, d_state 16, chunk 32,
fp32, CPU): the SSD intra-chunk kernel's plain version against JAX's
Pallas ``ssd_chunk_fwd`` in interpret mode, every function of
``models/ssd.py``, prefill/decode consistency, the frozen state of exited
rows, AR SpecEE sessions on dense and paged caches, ``ServingEngine``
(blocking, and ``prefill_chunk`` falling back to whole-prompt admission),
weight-only quant and kv_quant, the tree's refusal and the weight bridge
in bf16.

Tolerance: single SSD functions atol = rtol = 1e-5 in fp32 (sums in
another order), the intra-chunk term atol 1e-4 (the JAX kernel test's),
a layer stack or a state carried across chunks atol = rtol = 1e-4;
tokens, exit points, exits and units_run exact; bridged bf16 leaves
bit-equal."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import Engine as JEngine  # noqa: E402
from repro.api import SpecEEStrategy as JSpecEE  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.kernels.ssd_chunk.ref import ssd_chunk_ref as j_chunk_ref  # noqa
from repro.kernels.ssd_chunk.ssd_chunk import ssd_chunk_fwd as j_chunk  # noqa
from repro.models import common as jcommon  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import ssd as jssd  # noqa: E402
from repro.serving.server import ServingEngine as JServingEngine  # noqa
from repro_torch import bridge  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.api import Engine, SpecEEStrategy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.kernels.ssd_chunk import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import ssd as tssd  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small ops: one intra-op thread, so parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(atol=1e-5, rtol=1e-5)
STACK_TOL = dict(atol=1e-4, rtol=1e-4)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a).astype(np.float32),
                               np.asarray(b, np.float32), **tol)


@pytest.fixture(scope="module")
def setup():
    run_j = jax_get_config("mamba2-130m").smoke()
    run_t = get_config("mamba2-130m").smoke()
    m_j, m_t = jmodel.build_model(run_j), tmodel.build_model(run_t)
    params_j = m_j.init(jax.random.PRNGKey(0))
    sw_j = jeng.init_specee(m_j, jax.random.PRNGKey(1))
    params_t = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params_j), "cpu", torch.float32)
    sw_np = jax.tree_util.tree_map(np.asarray, sw_j)
    sw_t = bridge.specee_from_numpy(sw_np.draft, sw_np.predictors,
                                    sw_np.offline_mask, "cpu", torch.float32)
    return run_j, run_t, m_j, m_t, params_j, params_t, sw_j, sw_t


def _chunk_inputs(rng, B, c, nh, hd, ds, decay=1.0):
    xdt = rng.standard_normal((B, c, nh, hd)).astype(np.float32)
    cum = -np.cumsum(rng.uniform(0, decay, (B, c, nh)), axis=1
                     ).astype(np.float32)
    Bc = rng.standard_normal((B, c, ds)).astype(np.float32)
    Cc = rng.standard_normal((B, c, ds)).astype(np.float32)
    return xdt, cum, Bc, Cc


# ---------------- the intra-chunk kernel's plain version ----------------
@pytest.mark.parametrize("B,c,nh,hd,ds", [(2, 32, 4, 32, 16),
                                          (1, 64, 24, 64, 128)])
@pytest.mark.parametrize("decay", [1.0, 40.0])
def test_ssd_chunk_plain_matches_jax_kernel(B, c, nh, hd, ds, decay):
    """``ssd_chunk`` (plain on the CPU, no launch) and ``ssd_chunk_ref``
    against JAX's Pallas ``ssd_chunk_fwd`` (interpret mode) and its
    ``ssd_chunk_ref``, at the JAX kernel test's shapes, atol 1e-4; with
    steep decay (cum down to about -1300) exp(cum_t - cum_s) for s > t
    overflows, and the masked entries must still be exact zeros, not
    NaN."""
    rng = np.random.default_rng(c + ds)
    xdt, cum, Bc, Cc = _chunk_inputs(rng, B, c, nh, hd, ds, decay)
    want = np.asarray(j_chunk(*map(jnp.asarray, (xdt, cum, Bc, Cc))))
    np.testing.assert_allclose(
        want, np.asarray(j_chunk_ref(*map(jnp.asarray, (xdt, cum, Bc, Cc)))),
        atol=1e-4)
    K.reset_launches()
    got = ssd_ops.ssd_chunk(*map(_t, (xdt, cum, Bc, Cc)))
    assert K.LAUNCHES["ssd_chunk"] == 0
    assert got.dtype == torch.float32 and got.shape == (B, c, nh, hd)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(_np(got), want, atol=1e-4)
    np.testing.assert_allclose(_np(ssd_chunk_ref(*map(_t, (xdt, cum, Bc,
                                                            Cc)))),
                               want, atol=1e-4)


def test_ssd_chunk_bf16_inputs_match_jax():
    """bf16 B/C (the card's prefill dtype) upcast inside: the plain
    version equals JAX's kernel on the same bf16 values, atol 1e-4."""
    rng = np.random.default_rng(5)
    xdt, cum, Bc, Cc = _chunk_inputs(rng, 3, 32, 4, 32, 16)
    Bj = jnp.asarray(Bc).astype(jnp.bfloat16)
    Cj = jnp.asarray(Cc).astype(jnp.bfloat16)
    want = np.asarray(j_chunk(jnp.asarray(xdt), jnp.asarray(cum), Bj, Cj))
    got = ssd_ops.ssd_chunk(_t(xdt), _t(cum),
                            _t(Bj.astype(jnp.float32)).to(torch.bfloat16),
                            _t(Cj.astype(jnp.float32)).to(torch.bfloat16))
    np.testing.assert_allclose(_np(got), want, atol=1e-4)


# ---------------- models/ssd.py ----------------
@pytest.mark.parametrize("S", [32, 45, 70])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_ssd_chunked_matches_jax(S, with_state, use_kernel):
    """``ssd_chunked`` on whole and ragged chunk counts, from zeros and from
    an initial state, with the intra-chunk term through the kernel wrapper
    (its plain version on the CPU) or the plain version: y and the final
    state against JAX's (atol = rtol = 1e-4: the state is carried across
    chunks)."""
    rng = np.random.default_rng(S)
    B, nh, hd, ds, chunk = 2, 4, 32, 16, 32
    x = rng.standard_normal((B, S, nh, hd)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, (B, S, nh)).astype(np.float32)
    A = -np.linspace(1.0, 16.0, nh).astype(np.float32)
    Bm = rng.standard_normal((B, S, ds)).astype(np.float32)
    Cm = rng.standard_normal((B, S, ds)).astype(np.float32)
    h0 = (rng.standard_normal((B, nh, hd, ds)).astype(np.float32)
          if with_state else None)
    yj, hj = jssd.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk,
                              None if h0 is None else jnp.asarray(h0))
    yt, ht = tssd.ssd_chunked(*map(_t, (x, dt, A, Bm, Cm)), chunk,
                              None if h0 is None else _t(h0),
                              use_kernel=use_kernel)
    assert yt.shape == (B, S, nh, hd) and ht.shape == (B, nh, hd, ds)
    _close(yt, yj, STACK_TOL)
    _close(ht, hj, STACK_TOL)


def test_recurrent_step_and_convs_match_jax():
    """``ssd_recurrent_step``, ``conv1d_seq``, ``conv1d_step`` and
    ``_gated_rmsnorm`` against JAX's on the same numpy inputs; the chunked
    scan over one token from a state equals the recurrent step."""
    rng = np.random.default_rng(1)
    B, nh, hd, ds, C, Kc = 3, 4, 32, 16, 40, 4
    x = rng.standard_normal((B, nh, hd)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, (B, nh)).astype(np.float32)
    A = -np.linspace(1.0, 16.0, nh).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, ds)).astype(np.float32)
              for _ in range(2))
    st = rng.standard_normal((B, nh, hd, ds)).astype(np.float32)
    yj, sj = jssd.ssd_recurrent_step(*map(jnp.asarray, (x, dt, A, Bm, Cm,
                                                          st)))
    yt, s_t = tssd.ssd_recurrent_step(*map(_t, (x, dt, A, Bm, Cm, st)))
    _close(yt, yj)
    _close(s_t, sj)
    yc, sc = tssd.ssd_chunked(_t(x)[:, None], _t(dt)[:, None], _t(A),
                              _t(Bm)[:, None], _t(Cm)[:, None], 32, _t(st))
    _close(yc[:, 0], yt)
    _close(sc, s_t)
    w = rng.standard_normal((Kc, C)).astype(np.float32)
    b = rng.standard_normal((C,)).astype(np.float32)
    seq = rng.standard_normal((B, 7, C)).astype(np.float32)
    _close(tssd.conv1d_seq(_t(w), _t(b), _t(seq)),
           jssd.conv1d_seq(jnp.asarray(w), jnp.asarray(b), jnp.asarray(seq)))
    win = rng.standard_normal((B, Kc - 1, C)).astype(np.float32)
    oj, nj = jssd.conv1d_step(*map(jnp.asarray, (w, b, seq[:, 0], win)))
    ot, nt = tssd.conv1d_step(*map(_t, (w, b, seq[:, 0], win)))
    _close(ot, oj)
    np.testing.assert_array_equal(_np(nt), np.asarray(nj))
    # the step over the window of the last K-1 inputs is the sequence conv
    _close(tssd.conv1d_step(_t(w), _t(b), _t(seq[:, -1]),
                            _t(seq[:, -Kc:-1]))[0],
           tssd.conv1d_seq(_t(w), _t(b), _t(seq))[:, -1])
    p = {"norm": {"scale": rng.uniform(0.5, 1.5, C).astype(np.float32)}}
    y, z = (rng.standard_normal((B, C)).astype(np.float32) for _ in range(2))
    _close(tssd._gated_rmsnorm({"norm": {"scale": _t(p["norm"]["scale"])}},
                               _t(y), _t(z)),
           jssd._gated_rmsnorm(jax.tree_util.tree_map(jnp.asarray, p),
                               jnp.asarray(y), jnp.asarray(z)))


@pytest.mark.parametrize("S", [2, 3, 40])
def test_block_seq_and_step_match_jax(setup, S):
    """``ssd_block_seq`` (flags off and kernel wrapper on) and
    ``ssd_block_step`` of layer 0 against JAX's: output, final state and
    the conv tail, which is None for a prompt shorter than K-1 = 3 in both
    packages; then one step from the prefill's state and tail."""
    run_j, run_t, _, _, params_j, params_t, _, _ = setup
    pj = jax.tree_util.tree_map(lambda a: a[0], params_j["segments"][0])
    pt = {k: v for k, v in params_t["segments"][0]["u0"].items()}
    pt = jax.tree_util.tree_map(lambda a: a[0], pt)
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, 128)).astype(np.float32)
    oj, sj, tj = jssd.ssd_block_seq(run_j.model, pj["u0"]["ssd"],
                                    jnp.asarray(x))
    for use_kernel in (False, True):
        ot, s_t, tt = tssd.ssd_block_seq(run_t.model, pt["ssd"], _t(x),
                                         use_kernel=use_kernel)
        _close(ot, oj, STACK_TOL)
        _close(s_t, sj, STACK_TOL)
        assert (tt is None) == (tj is None) == (S < 3)
        if tt is not None:
            _close(tt, tj)
    if S < 3:
        return
    x1 = rng.standard_normal((2, 128)).astype(np.float32)
    oj, sj2, cj2 = jssd.ssd_block_step(run_j.model, pj["u0"]["ssd"],
                                       jnp.asarray(x1), sj, tj)
    ot, st2, ct2 = tssd.ssd_block_step(run_t.model, pt["ssd"], _t(x1),
                                       _t(sj), _t(tj))
    _close(ot, oj, STACK_TOL)
    _close(st2, sj2, STACK_TOL)
    _close(ct2, cj2)


def test_prefill_then_step_equals_longer_prefill(setup):
    """In both packages: a prefill of S tokens followed by one decode
    step (full depth) gives the logits, SSD states and conv windows of a
    prefill of S + 1 tokens; the port's equal JAX's."""
    run_j, run_t, m_j, m_t, params_j, params_t, _, _ = setup
    toks = np.random.default_rng(2).integers(0, 512, (2, 21))
    outs = []
    for m, p, arr in ((m_j, params_j, jnp.asarray), (m_t, params_t, _t)):
        _, c, _ = m.prefill(p, {"tokens": arr(toks[:, :20])}, max_seq=24)
        h, c = m.decode_step_hidden(p, arr(toks[:, 20]), c) if m is m_t \
            else _jax_step(m, p, arr(toks[:, 20]), c)
        full_logits, full, _ = m.prefill(p, {"tokens": arr(toks)},
                                         max_seq=24)
        step_logits = m.logits(p, h)
        _close(step_logits, full_logits, STACK_TOL)
        for name in ("state", "conv"):
            _close(c["segments"][0]["u0"][name],
                   full["segments"][0]["u0"][name], STACK_TOL)
        outs.append(np.asarray(step_logits))
    _close(outs[1], outs[0], STACK_TOL)


def _jax_step(m, params, token, cache):
    """JAX's full-depth decode returning the pre-final-norm hidden (its
    ``run_unit`` loop, as the port's ``decode_step_hidden``)."""
    h = m.embed(params, token[:, None])[:, 0, :]
    segs = []
    for seg, (_, reps) in enumerate(m.segments):
        sc = cache["segments"][seg]
        for u in range(reps):
            h, sc = m.run_unit(params, seg, jnp.int32(u), h, sc,
                               cache["len"])
        segs.append(sc)
    return h, dict(cache, segments=segs, len=cache["len"] + 1)


def test_exit_freezes_recurrent_state(setup):
    """The counterpart of ``tests/test_specee.py::
    test_exit_freezes_recurrent_state``: with ``live_mask=[True, False]``
    the live row's SSD state advances and the exited row's stays, while
    both rows' conv windows take the new input; values equal JAX's."""
    run_j, run_t, m_j, m_t, params_j, params_t, _, _ = setup
    B = 2
    h = np.random.default_rng(1).standard_normal((B, 128)).astype(np.float32)
    cj = m_j.empty_cache(B, 8)
    ct = m_t.empty_cache(B, 8, "cpu")
    start = np.random.default_rng(2).standard_normal(
        ct["segments"][0]["u0"]["state"].shape).astype(np.float32)
    ct["segments"][0]["u0"]["state"].copy_(_t(start))
    seg_j = dict(cj["segments"][0])
    seg_j["u0"] = dict(seg_j["u0"], state=jnp.asarray(start))
    live = np.array([True, False])
    hj, seg_j2 = m_j.run_unit(params_j, 0, jnp.int32(0), jnp.asarray(h),
                              seg_j, cj["len"], live_mask=jnp.asarray(live))
    ht, seg_t = m_t.run_unit(params_t, 0, 0, _t(h), ct["segments"][0],
                             ct["len"], live_mask=_t(live))
    s_new = _np(seg_t["u0"]["state"][0])
    assert not np.allclose(s_new[0], start[0, 0])      # live row advanced
    np.testing.assert_array_equal(s_new[1], start[0, 1])  # exited: stale
    assert _np(seg_t["u0"]["conv"][0, 1]).any()        # window advanced
    _close(ht, hj, STACK_TOL)
    for name in ("state", "conv"):
        _close(seg_t["u0"][name], seg_j2["u0"][name], STACK_TOL)


# ---------------- decode and serving ----------------
def _ar(E, model, params, sw, prompts, cache, thresh, new=6):
    strat = (JSpecEE if E is JEngine else SpecEEStrategy)(threshold=thresh)
    s = E.create(model, params, sw, strategy=strat).new_session(cache=cache)
    out = [s.prefill(prompts, max_new_tokens=new)]
    while not s.all_done():
        out.append(s.step())
    return [(np.asarray(r.tokens).tolist(), np.asarray(r.exit_layer).tolist(),
             np.asarray(r.exited).tolist(), int(r.units_run)) for r in out]


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_ar_session_matches_jax(setup, cache):
    """SpecEE sessions at thresholds 1.5 (equal to dense greedy), 0.4 and
    -0.1: tokens, exit points, exits and units_run equal JAX's, with every
    kernel flag of the port on (plain versions on the CPU, no launch) and
    off."""
    run_j, run_t, m_j, m_t, params_j, params_t, sw_j, sw_t = setup
    m_k = tmodel.build_model(run_t, tmodel.ModelFlags(
        ssd_kernel=True, exit_gate_kernel=True, exit_gate_impl="kernel",
        decode_kernel=True, flash_attention=True))
    prompts = np.random.default_rng(4).integers(0, 512, (2, 9))
    for thresh in (1.5, 0.4, -0.1):
        want = _ar(JEngine, m_j, params_j, sw_j, jnp.asarray(prompts), cache,
                   thresh)
        K.reset_launches()
        for m in (m_t, m_k):
            assert _ar(Engine, m, params_t, sw_t, prompts, cache,
                       thresh) == want, thresh
        assert all(c == 0 for c in K.LAUNCHES.values())
        if thresh == 1.5:
            s = Engine.create(m_t, params_t, strategy="dense").new_session(
                cache=cache)
            dense = [s.prefill(prompts, max_new_tokens=6)]
            while not s.all_done():
                dense.append(s.step())
            assert [np.asarray(r.tokens).tolist() for r in dense] == \
                [r[0] for r in want]


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_oracle_exits_match_jax(setup, cache):
    """Raw ``ar_decode_step`` with an oracle speculative set (the argmax
    after units 0 and 1) at threshold -0.1: every row exits, the skipped
    units' SSD states stay stale while their conv windows shift, and later
    steps read them. Tokens, exit points and units_run equal JAX's, and so
    do every layer's states and conv windows (atol = rtol = 1e-4)."""
    run_j, run_t, m_j, m_t, params_j, params_t, sw_j, sw_t = setup
    prompts = np.random.default_rng(5).integers(0, 512, (2, 8))
    _, st_j = jeng.init_decode_state(m_j, params_j, sw_j,
                                     {"tokens": jnp.asarray(prompts)}, 16)
    _, st_t = teng.init_decode_state(m_t, params_t, sw_t,
                                     {"tokens": _t(prompts)}, 16)
    if cache == "paged":
        from repro.api.cache import make_cache_manager as jmake
        from repro_torch.api.cache import make_cache_manager as tmake
        st_j = st_j._replace(cache=jmake(m_j, 2, 16, "paged").from_prefill(
            st_j.cache))
        st_t = st_t._replace(cache=tmake(m_t, 2, 16, "paged", "cpu")
                             .from_prefill(st_t.cache))
        assert "page_table" in st_t.cache
    step_j = jax.jit(lambda st, ov: jeng.ar_decode_step(
        m_j, params_j, sw_j, st, threshold=-0.1, spec_ids_override=ov))
    exits = 0
    for _ in range(3):
        h = m_t.embed(params_t, st_t.last_token[:, None])[:, 0, :]
        seg = {k: {n: x.clone() for n, x in e.items()}
               for k, e in st_t.cache["segments"][0].items()}
        sets = []
        for u in range(2):
            h, seg = m_t.run_unit(params_t, 0, u, h, seg, st_t.cache["len"])
            sets.append(_np(torch.argmax(m_t.logits(params_t, h), -1)))
        ov = np.stack(sets * 2, axis=1).astype(np.int32)
        tok_j, st_j, info_j = step_j(st_j, jnp.asarray(ov))
        tok_t, st_t, info_t = teng.ar_decode_step(
            m_t, params_t, sw_t, st_t, threshold=-0.1,
            spec_ids_override=_t(ov))
        np.testing.assert_array_equal(_np(tok_t), np.asarray(tok_j))
        np.testing.assert_array_equal(_np(info_t.exit_point),
                                      np.asarray(info_j.exit_point))
        assert info_t.units_run == int(info_j.units_run)
        exits += int(info_t.exited.sum())
    assert exits == 6
    for name in ("state", "conv"):
        _close(st_t.cache["segments"][0]["u0"][name],
               st_j.cache["segments"][0]["u0"][name], STACK_TOL)


def _serve(SE, model, params, sw, prompts, **kw):
    se = SE(model, params, sw, **kw)
    reqs = [se.submit(p, max_new_tokens=n)
            for p, n in zip(prompts, (5, 2, 6, 4))]
    se.run_to_completion()
    assert all(r.done for r in reqs) and not se.busy
    mgr = se.session.cache_mgr
    assert mgr.free_pages == getattr(mgr, "num_pages", 0)
    return [(r.output, r.exit_points) for r in reqs]


@pytest.mark.parametrize("cache,chunk", [("paged", 0), ("paged", 4),
                                         ("dense", 0)])
def test_serving_engine_matches_jax(setup, cache, chunk):
    """Four requests through two slots at threshold -0.1: per-request
    tokens and exit points equal JAX's ServingEngine; ``prefill_chunk=4``
    falls back to whole-prompt admission on an SSD stack in both packages
    (the counterpart of ``tests/test_paged_cache.py::
    test_chunked_fallback_non_attention_arch``), so its cell equals the
    blocking one; every page returns."""
    run_j, run_t, m_j, m_t, params_j, params_t, sw_j, sw_t = setup
    assert not m_t.supports_chunked_prefill()
    assert not m_j.supports_chunked_prefill()
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 512, int(n)).astype(np.int32)
               for n in rng.integers(3, 14, 4)]
    got = _serve(ServingEngine, m_t, params_t, sw_t, prompts, cache=cache,
                 prefill_chunk=chunk, strategy=SpecEEStrategy(-0.1))
    want = _serve(JServingEngine, m_j, params_j, sw_j, prompts, cache=cache,
                  prefill_chunk=chunk, strategy=JSpecEE(-0.1))
    assert got == want
    if chunk:
        assert got == _serve(ServingEngine, m_t, params_t, sw_t, prompts,
                             cache=cache, prefill_chunk=0,
                             strategy=SpecEEStrategy(-0.1))


@pytest.mark.parametrize("quant,kv_quant", [("int8", False), ("int4", True)])
def test_quantized_serving_matches_jax(setup, quant, kv_quant):
    """Weight-only int8/int4 (``ServingEngine(quant=)``: the tied head and
    the predictor bank quantized; an SSD stack has no attention or MLP
    projection to quantize) and ``kv_quant`` (a no-op without attention
    entries) on mamba2: per-request tokens and exit points equal JAX's
    same cell at threshold -0.1 on the paged cache."""
    run_j, run_t, _, _, params_j, params_t, sw_j, sw_t = setup
    m_j = jmodel.build_model(run_j, jmodel.ModelFlags(kv_quant=kv_quant))
    m_t = tmodel.build_model(run_t, tmodel.ModelFlags(kv_quant=kv_quant))
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, 512, int(n)).astype(np.int32)
               for n in rng.integers(3, 14, 4)]
    got = _serve(ServingEngine, m_t, params_t, sw_t, prompts, cache="paged",
                 quant=quant, strategy=SpecEEStrategy(-0.1))
    want = _serve(JServingEngine, m_j, params_j, sw_j, prompts,
                  cache="paged", quant=quant, strategy=JSpecEE(-0.1))
    assert got == want


def test_paged_manager_pages_only_attention(setup):
    """On an SSD stack the paged manager allocates no pool: its entries
    keep the per-row layout of the dense manager (JAX's
    ``_attention_units`` rule), pages are still reserved and returned per
    row, and ``row_pages`` agrees with JAX's."""
    from repro.api.cache import CacheSpec as JCacheSpec
    from repro.api.cache import PagedKVCache as JPaged
    from repro_torch.api.cache import CacheSpec, PagedKVCache
    _, _, m_j, m_t, _, _, _, _ = setup
    mj = JPaged(m_j, 2, 32, JCacheSpec("paged", 16))
    mt = PagedKVCache(m_t, 2, 32, CacheSpec("paged", 16), "cpu")
    cj, ct = mj.empty_cache(), mt.empty_cache()
    for name in ("state", "conv"):
        assert tuple(ct["segments"][0]["u0"][name].shape) == \
            cj["segments"][0]["u0"][name].shape
    assert ct["segments"][0]["u0"]["state"].dtype == torch.float32
    assert [mt.row_pages(r) for r in range(2)] == \
        [mj.row_pages(r) for r in range(2)] == [0, 0]


def test_tree_strategy_refused(setup):
    """``strategy="tree"`` on mamba2 raises ValueError with JAX's message
    (``tests/test_api.py::test_strategy_validation``)."""
    _, _, m_j, m_t, params_j, params_t, sw_j, sw_t = setup
    assert not m_t.supports_tree()
    msgs = []
    for E, m, p, sw in ((JEngine, m_j, params_j, sw_j),
                        (Engine, m_t, params_t, sw_t)):
        with pytest.raises(ValueError) as ei:
            E.create(m, p, sw, strategy="tree")
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1] and "pure-attention" in msgs[1]


def test_tied_head_and_bf16_bridge(setup):
    """Tied embeddings: no ``lm_head`` in either package's params; the
    engine holds one contiguous (D, V) copy of ``embed.T`` and leaves the
    caller's params alone. The bridge in bf16 rounds every floating leaf
    (A_log, dt_bias and D too) as ``common.cast_tree`` does, bit for bit,
    and the draft of an attention-free target has JAX's shapes (4 heads of
    D // 4, d_ff 4 D)."""
    _, run_t, m_j, m_t, params_j, params_t, sw_j, sw_t = setup
    assert "lm_head" not in params_j and "lm_head" not in params_t
    assert "lm_head" not in m_t.init(0, "cpu")
    e = Engine.create(m_t, params_t, sw_t)
    head = e.params["lm_head"]["w"]
    assert head.is_contiguous() and torch.equal(head,
                                                params_t["embed"]["tok"].T)
    assert "lm_head" not in params_t
    cast = jax.tree_util.tree_map(np.asarray,
                                  jcommon.cast_tree(params_j, jnp.bfloat16))
    bf = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params_j), "cpu", torch.bfloat16)
    ssd_j, ssd_t = cast["segments"][0]["u0"]["ssd"], \
        bf["segments"][0]["u0"]["ssd"]
    for name in ("A_log", "dt_bias", "D", "conv_w"):
        assert ssd_t[name].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            ssd_t[name].float().numpy(), ssd_j[name].astype(np.float32))
    shapes_j = jax.tree_util.tree_map(lambda a: a.shape, sw_j.draft)
    shapes_t = jax.tree_util.tree_map(lambda a: tuple(a.shape), sw_t.draft)
    assert shapes_t == shapes_j
    init = teng.init_specee(m_t, torch.Generator().manual_seed(0), "cpu")
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                  init.draft) == shapes_j
    p_t = m_t.init(0, "cpu")
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), p_t) == \
        jax.tree_util.tree_map(lambda a: a.shape, params_j)
