"""The port's int8 KV cache (``ModelFlags(kv_quant=True)``) against the JAX
package on the llama2-7b smoke config (fp32, CPU): the quantizer, the
paged helpers on scale pools, the int8 paged decode attention's plain
version against JAX's Pallas kernel (``_paged_kernel_q``, interpret mode),
prefill's cache leaves, AR sessions, ``ServingEngine`` in every (cache,
admission) cell, composed with ``quant="int8"``, and the tree's refusal.

Tolerance: codes byte-equal and scales bit-equal where both sides quantize
the same values; tokens, exit points, exits and units_run exact; kernel
values atol = rtol = 1e-5 in fp32 (sums in another order) and one bf16
spacing (rtol 2**-7) for bf16 queries. Chunked and blocking kv_quant
admission differ by design in both packages (blocking prefill attends
full-precision K/V, chunked prefill the dequantized cache), so each cell
is held against JAX's same cell."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import Engine as JEngine  # noqa: E402
from repro.api import SpecEEStrategy as JSpecEE  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core import paged as jpaged  # noqa: E402
from repro.kernels.decode_attention.decode_attention import (  # noqa: E402
    paged_decode_attention_fwd as j_paged_fwd)
from repro.models import model as jmodel  # noqa: E402
from repro.serving.server import ServingEngine as JServingEngine  # noqa
from repro_torch import bridge  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.api import Engine, SpecEEStrategy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import paged as tpaged  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The smoke config's ops are tiny: one intra-op thread, so that the
    test run's parallel workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


VTOL = dict(atol=1e-5, rtol=1e-5)
TREE_MESSAGE = (
    "tree strategy does not support kv_quant: tree scratch writes are "
    "full-precision (the node K/V is re-read within the same step, where "
    "int8 round-tripping would corrupt verification); decode with the AR "
    "engine instead (DESIGN.md §4)")


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def setup():
    run_j = jax_get_config("llama2-7b").smoke()
    run_t = get_config("llama2-7b").smoke()
    m_j = jmodel.build_model(run_j)
    params_j = m_j.init(jax.random.PRNGKey(0))
    sw_j = jeng.init_specee(m_j, jax.random.PRNGKey(1))
    params_t = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params_j), "cpu", torch.float32)
    sw_np = jax.tree_util.tree_map(np.asarray, sw_j)
    sw_t = bridge.specee_from_numpy(sw_np.draft, sw_np.predictors,
                                    sw_np.offline_mask, "cpu", torch.float32)
    return run_j, run_t, params_j, params_t, sw_j, sw_t


def _models(run_j, run_t, **flags):
    return (jmodel.build_model(run_j, jmodel.ModelFlags(kv_quant=True,
                                                        **flags)),
            tmodel.build_model(run_t, tmodel.ModelFlags(kv_quant=True,
                                                        **flags)))


def _prompts(n=3, seed=11, lo=6, hi=12):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, int(rng.integers(lo, hi))).astype(np.int32)
            for _ in range(n)]


# ---------------- the quantizer ----------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quantize_matches_jax(dtype):
    """Codes byte-equal and scales bit-equal to ``repro.models.model.
    _kv_quantize`` as written (op by op), for an all-zero vector, values
    on the half-way points (round half to even), extreme magnitudes whose
    largest entry lands on the ±127 clip bound, and random rows; the
    dequantization bit-equal. Under ``jax.jit`` XLA rewrites the division
    by the constant 127 as a product with its reciprocal, which moves some
    scales by one fp32 spacing: codes still equal there."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((5, 3, 2, 32)) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0                                   # all-zero vector
    x[0, 0, 1, :6] = [127.0, 0.5, 1.5, 2.5, -2.5, -127.0]
    x[0, 0, 1, 6:] = 0.0                               # scale exactly 1
    x[0, 1, 0] = np.float32(3e37) * np.sign(x[0, 1, 0])
    x[0, 1, 1] *= np.float32(1e-30)
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        getattr(torch, dtype))
    qj, sj = jmodel._kv_quantize(xj)
    qt, st = tmodel._kv_quantize(xt)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(_np(qt), np.asarray(qj))
    np.testing.assert_array_equal(_np(st).view(np.int32),
                                  np.asarray(sj).view(np.int32))
    assert _np(qt)[0, 0, 0].tolist() == [0] * 32
    assert _np(qt)[0, 0, 1, :6].tolist() == [127, 0, 2, 2, -2, -127]
    assert np.abs(_np(qt)[0, 1, 0]).max() == 127
    np.testing.assert_array_equal(
        _np(tmodel._kv_dequantize(qt, st, torch.float32)),
        np.asarray(jmodel._kv_dequantize(qj, sj, jnp.float32)))
    qjj, sjj = jax.jit(jmodel._kv_quantize)(xj)
    np.testing.assert_array_equal(_np(qt), np.asarray(qjj))
    np.testing.assert_allclose(_np(st), np.asarray(sjj), rtol=2.0 ** -23,
                               atol=0)


@pytest.mark.parametrize("trailing", [(3,), (3, 4)])
def test_paged_helpers_on_scale_and_value_pools(trailing):
    """``flat_slots``, ``scatter_token``, ``scatter_slab`` and
    ``gather_view`` on 3-d scale pools (NP, ps, KVH) and 4-d value pools
    (NP, ps, KVH, hd), fp32 and int8, against ``repro.core.paged``."""
    rng = np.random.default_rng(1)
    B, P, ps = 3, 2, 4
    NP = B * P + 2
    table = rng.permutation(NP - 1)[:B * P].reshape(B, P).astype(np.int32)
    pos = np.broadcast_to(np.arange(P * ps)[None], (B, P * ps))
    np.testing.assert_array_equal(
        _np(tpaged.flat_slots(_t(table), ps, _t(pos))),
        np.asarray(jpaged.flat_slots(jnp.asarray(table), ps, pos)))
    for dt, jdt in ((torch.float32, jnp.float32), (torch.int8, jnp.int8)):
        slab = rng.integers(-127, 128, (B, P * ps) + trailing)
        pool_t = tpaged.scatter_slab(torch.zeros((NP, ps) + trailing,
                                                 dtype=dt),
                                     _t(table), _t(pos), _t(slab))
        pool_j = jpaged.scatter_slab(jnp.zeros((NP, ps) + trailing, jdt),
                                     jnp.asarray(table), pos,
                                     jnp.asarray(slab))
        assert pool_t.dtype == dt
        np.testing.assert_array_equal(_np(pool_t), np.asarray(pool_j))
        wpos = rng.integers(0, P * ps, B).astype(np.int32)
        tok = rng.integers(-127, 128, (B,) + trailing)
        tpaged.scatter_token(pool_t, _t(table), _t(wpos), _t(tok))
        pool_j = jpaged.scatter_token(pool_j, jnp.asarray(table),
                                      jnp.asarray(wpos), jnp.asarray(tok))
        np.testing.assert_array_equal(_np(pool_t), np.asarray(pool_j))
        np.testing.assert_array_equal(
            _np(tpaged.gather_view(pool_t, _t(table))),
            np.asarray(jpaged.gather_view(pool_j, jnp.asarray(table))))


# ---------------- the int8 paged decode attention ----------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_rep", [1, 2])
@pytest.mark.parametrize("window", [None, 6])
def test_paged_q_plain_matches_jax_kernel(dtype, n_rep, window):
    """``paged_decode_attention_fwd(..., k_scale=, v_scale=)`` (plain on
    the CPU) against JAX's Pallas ``_paged_kernel_q`` in interpret mode:
    a shuffled page table over a pool with spare pages, ragged lengths
    across page boundaries, and a retired row (every entry the zeroed trash
    page, length 1). No kernel launches on the CPU."""
    rng = np.random.default_rng(2 + n_rep)
    B, P, ps, KVH, hd = 4, 3, 8, 4 // n_rep, 32
    NP = B * P + 3
    k, ks = jmodel._kv_quantize(jnp.asarray(
        rng.standard_normal((NP + 1, ps, KVH, hd)).astype(np.float32)))
    v, vs = jmodel._kv_quantize(jnp.asarray(
        rng.standard_normal((NP + 1, ps, KVH, hd)).astype(np.float32)))
    trash = NP
    k, v = k.at[trash].set(0), v.at[trash].set(0)
    ks, vs = ks.at[trash].set(0.0), vs.at[trash].set(0.0)
    table = rng.permutation(NP)[:B * P].reshape(B, P).astype(np.int32)
    table[-1] = trash
    lens = np.array([17, 8, 24, 1], np.int32)
    q = jnp.asarray(rng.standard_normal((B, 1, 4, hd)).astype(np.float32)
                    ).astype(dtype)
    want = j_paged_fwd(q, k, v, jnp.asarray(table), jnp.asarray(lens),
                       window=window, k_scale=ks, v_scale=vs)
    K.reset_launches()
    got = da_ops.paged_decode_attention(
        None, _t(q.astype(jnp.float32)).to(getattr(torch, dtype)), _t(k),
        _t(v), _t(table), _t(lens), window=window, k_scale=_t(ks),
        v_scale=_t(vs))
    assert all(c == 0 for c in K.LAUNCHES.values())
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, 1, 4, hd)
    tol = VTOL if dtype == "float32" else dict(atol=1e-5, rtol=2.0 ** -7)
    np.testing.assert_allclose(_np(got.float()),
                               np.asarray(want.astype(jnp.float32)), **tol)
    with pytest.raises(ValueError, match="both"):
        da_ops.paged_decode_attention(None, _t(q.astype(jnp.float32)),
                                      _t(k), _t(v), _t(table), _t(lens),
                                      k_scale=_t(ks))


def test_prefill_cache_leaves_match_jax(setup):
    """``Model.prefill`` stores the prompt's codes and scales as JAX's
    ``_materialize_cache`` does: int8 ``k``/``v`` and fp32 ``ks``/``vs``
    of JAX's shapes, zero past the prompt. The two packages' K/V
    projections sum in another order, so a code may sit one step apart
    where a value lies on a rounding boundary (at most 1, in at most 0.1 %
    of codes) and scales agree to rtol 1e-5."""
    run_j, run_t, params_j, params_t, _, _ = setup
    m_j, m_t = _models(run_j, run_t)
    toks = np.random.default_rng(3).integers(0, 512, (2, 9))
    _, cj, _ = m_j.prefill(params_j, {"tokens": jnp.asarray(toks)},
                           max_seq=16)
    _, ct, _ = m_t.prefill(params_t, {"tokens": _t(toks)}, max_seq=16)
    np.testing.assert_array_equal(_np(ct["len"]), np.asarray(cj["len"]))
    for seg_t, seg_j in zip(ct["segments"], cj["segments"]):
        for name in ("k", "v", "ks", "vs"):
            a, b = _np(seg_t["u0"][name]), np.asarray(seg_j["u0"][name])
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert not a[:, :, 9:].any(), f"{name} past the prompt"
            if name in ("k", "v"):
                diff = np.abs(a.astype(np.int32) - b)
                assert diff.max() <= 1 and diff.mean() <= 1e-3, name
            else:
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=0)


# ---------------- AR decode ----------------
def _ar(E, model, params, sw, prompts, cache, thresh, new=6):
    strat = (JSpecEE if E is JEngine else SpecEEStrategy)(threshold=thresh)
    s = E.create(model, params, sw, strategy=strat).new_session(cache=cache)
    out = [s.prefill(prompts, max_new_tokens=new)]
    while not s.all_done():
        out.append(s.step())
    return [(np.asarray(r.tokens).tolist(), np.asarray(r.exit_layer).tolist(),
             np.asarray(r.exited).tolist(), int(r.units_run)) for r in out]


@pytest.mark.parametrize("cache", ["dense", "paged"])
@pytest.mark.parametrize("decode_kernel", [False, True])
def test_ar_session_matches_jax(setup, cache, decode_kernel):
    """SpecEE sessions with kv_quant at thresholds 0.5 and -0.1: tokens,
    exit points, exits and units_run equal JAX's, with the decode kernel
    flag off and on (JAX: its Pallas kernels in interpret mode; the port:
    the plain versions on the CPU, no launch)."""
    run_j, run_t, params_j, params_t, sw_j, sw_t = setup
    m_j, m_t = _models(run_j, run_t, decode_kernel=decode_kernel)
    prompts = np.random.default_rng(4).integers(0, 512, (2, 9))
    for thresh in (0.5, -0.1):
        K.reset_launches()
        got = _ar(Engine, m_t, params_t, sw_t, prompts, cache, thresh)
        assert all(c == 0 for c in K.LAUNCHES.values())
        want = _ar(JEngine, m_j, params_j, sw_j, jnp.asarray(prompts), cache,
                   thresh)
        assert got == want, thresh


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_oracle_exits_write_codes_like_jax(setup, cache):
    """Raw ``ar_decode_step`` with an oracle speculative set (the argmax
    after units 0 and 1) at threshold -0.1: every row exits, the skipped
    units' K/V is propagated as codes and scales, and later steps read it
    back. Tokens, exit points and units_run equal JAX's, and the cache
    leaves at the propagated positions agree (codes within one step,
    scales to rtol 1e-5, as in the prefill test)."""
    run_j, run_t, params_j, params_t, sw_j, sw_t = setup
    m_j, m_t = _models(run_j, run_t)
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
    step_j = jax.jit(lambda st, ov: jeng.ar_decode_step(
        m_j, params_j, sw_j, st, threshold=-0.1, spec_ids_override=ov))
    exits = 0
    for _ in range(3):
        h = m_t.embed(params_t, st_t.last_token[:, None])[:, 0, :]
        pages = st_t.cache.get("page_table")
        seg = {k: {n: x.clone() for n, x in e.items()}
               for k, e in st_t.cache["segments"][0].items()}
        sets = []
        for u in range(2):
            h, seg = m_t.run_unit(params_t, 0, u, h, seg,
                                  st_t.cache["len"], pages=pages)
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
    for seg_t, seg_j in zip(st_t.cache["segments"], st_j.cache["segments"]):
        for name in ("k", "v", "ks", "vs"):
            a, b = _np(seg_t["u0"][name]), np.asarray(seg_j["u0"][name])
            assert a.dtype == b.dtype and a.shape == b.shape
            if name in ("k", "v"):
                assert np.abs(a.astype(np.int32) - b).max() <= 1
            else:
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=0)


# ---------------- serving ----------------
def _serve(SE, model, params, sw, prompts, **kw):
    se = SE(model, params, sw, strategy="specee", **kw)
    reqs = [se.submit(p, max_new_tokens=5) for p in prompts]
    se.run_to_completion()
    mgr = se.session.cache_mgr
    assert mgr.free_pages == getattr(mgr, "num_pages", 0)
    return [(r.output, r.exit_points) for r in reqs]


@pytest.mark.parametrize("cache", ["dense", "paged"])
@pytest.mark.parametrize("chunk", [0, 4])
def test_serving_engine_matches_jax_cell(setup, cache, chunk):
    """kv_quant ``ServingEngine``: per-request tokens and exit points equal
    JAX's same (cache, prefill_chunk) cell, on the prompts of JAX's
    ``test_chunked_matches_blocking_admission_kv_quant``; every page
    returns to the pool."""
    run_j, run_t, params_j, params_t, sw_j, sw_t = setup
    m_j, m_t = _models(run_j, run_t)
    prompts = _prompts()
    got = _serve(ServingEngine, m_t, params_t, sw_t, prompts, cache=cache,
                 prefill_chunk=chunk)
    want = _serve(JServingEngine, m_j, params_j, sw_j, prompts, cache=cache,
                  prefill_chunk=chunk)
    assert got == want


@pytest.mark.parametrize("chunk", [0, 4])
def test_serving_paged_equals_dense(setup, chunk):
    """The port's paged cell equals its dense cell at each admission mode
    (the int8 pools are read and written through the page table)."""
    _, run_t, _, params_t, _, sw_t = setup
    m_t = tmodel.build_model(run_t, tmodel.ModelFlags(kv_quant=True))
    prompts = _prompts(n=4, seed=12)
    outs = [_serve(ServingEngine, m_t, params_t, sw_t, prompts, cache=cache,
                   prefill_chunk=chunk) for cache in ("dense", "paged")]
    assert outs[0] == outs[1]


def test_chunked_kv_quant_admission_diverges_where_jax_does(setup):
    """Where the reference's chunked and blocking kv_quant cells disagree,
    the chunked side is the one that leaves full precision: blocking
    kv_quant admission emits the fp cache's tokens on these prompts, and
    chunked admission (attending the dequantized cache) flips request 1's
    third token, 35 -> 353, a near-tie of the fp model (top-2 margin
    0.0021)."""
    _, run_t, _, params_t, _, sw_t = setup
    prompts = _prompts()
    fp = tmodel.build_model(run_t)
    q8 = tmodel.build_model(run_t, tmodel.ModelFlags(kv_quant=True))
    want = _serve(ServingEngine, fp, params_t, sw_t, prompts, cache="dense")
    blocking = _serve(ServingEngine, q8, params_t, sw_t, prompts,
                      cache="dense", prefill_chunk=0)
    chunked = _serve(ServingEngine, q8, params_t, sw_t, prompts,
                     cache="dense", prefill_chunk=4)
    assert blocking == want
    assert [o for o, _ in chunked] != [o for o, _ in want]
    assert want[1][0][:3] == [502, 500, 35] and chunked[1][0][2] == 353
    logits, _, _ = fp.prefill(params_t, {"tokens": _t(
        [list(prompts[1]) + [502, 500]])})
    top = torch.topk(logits[0], 2)
    assert top.indices.tolist() == [35, 353]
    assert float(top.values[0] - top.values[1]) < 0.005


@pytest.mark.parametrize("cache,chunk", [("paged", 4), ("dense", 0)])
def test_quant_int8_serving_matches_jax(setup, cache, chunk):
    """``ServingEngine(quant="int8")`` with kv_quant: prefill through the
    dequantized weight view and the int8 KV through the same cache, token-
    and exit-equal to JAX's same cell."""
    run_j, run_t, params_j, params_t, sw_j, sw_t = setup
    m_j, m_t = _models(run_j, run_t)
    prompts = _prompts(seed=13)
    got = _serve(ServingEngine, m_t, params_t, sw_t, prompts, cache=cache,
                 prefill_chunk=chunk, quant="int8")
    want = _serve(JServingEngine, m_j, params_j, sw_j, prompts, cache=cache,
                  prefill_chunk=chunk, quant="int8")
    assert got == want


def test_tree_rejects_kv_quant_like_jax(setup):
    """The tree strategy refuses kv_quant with JAX's exact message."""
    run_j, run_t, params_j, params_t, sw_j, sw_t = setup
    m_j, m_t = _models(run_j, run_t)
    msgs = []
    for E, m, p, sw in ((JEngine, m_j, params_j, sw_j),
                        (Engine, m_t, params_t, sw_t)):
        with pytest.raises(ValueError) as ei:
            E.create(m, p, sw, strategy="tree")
        msgs.append(str(ei.value))
    assert msgs == [TREE_MESSAGE, TREE_MESSAGE]
