"""The port's weight-only quantization (``repro_torch.quant``, the ``_q``
kernels' plain versions, ``Engine.create(quant=...)``,
``ServingEngine(quant=...)``) against the JAX package's ``repro.quant``
on the llama2-7b smoke config (fp32, CPU).

The JAX side runs its quantized Pallas kernels in interpret mode (kernel
flags on) or its reference path (flags off); the port runs the wrappers'
plain versions. Tolerance: codes byte-equal and scales bit-equal; tokens,
ids and the integer step fields (exit points, exits, units_run, accept
lengths) exact; kernel values atol = rtol = 1e-5 (fp32 sums in another
order), the predictor MLP's probabilities atol = 1e-6."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import quant as jquant  # noqa: E402
from repro.api import Engine as JEngine  # noqa: E402
from repro.api import SpecEEStrategy as JSpecEE  # noqa: E402
from repro.api import TreeStrategy as JTree  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core.tree import TreeSpec as JTreeSpec  # noqa: E402
from repro.kernels.exit_gate import ops as jgate_ops  # noqa: E402
from repro.kernels.predictor_mlp import ops as jpm_ops  # noqa: E402
from repro.kernels.spec_head import ops as jsh_ops  # noqa: E402
from repro.models.model import ModelFlags as JFlags  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.serving.server import ServingEngine as JServingEngine  # noqa
from repro_torch import bridge, quant  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.api import (Engine, SpecEEStrategy,  # noqa: E402
                             TreeStrategy)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core.tree import TreeSpec  # noqa: E402
from repro_torch.kernels.exit_gate import exit_gate as eg  # noqa: E402
from repro_torch.kernels.exit_gate import ops as gate_ops  # noqa: E402
from repro_torch.kernels.exit_gate import ref as gate_ref  # noqa: E402
from repro_torch.kernels.predictor_mlp import ops as pm_ops  # noqa: E402
from repro_torch.kernels.spec_head import ops as sh_ops  # noqa: E402
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


VTOL = dict(atol=1e-5, rtol=1e-5)
KERNEL_FLAGS = dict(spec_head_kernel=True, exit_gate_kernel=True,
                    exit_gate_impl="kernel")


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_qtensor(a, b):
    """A port QTensor equals a JAX one: bits, byte-equal codes, bit-equal
    scales."""
    assert a.bits == b.bits and a.shape == tuple(b.shape)
    np.testing.assert_array_equal(_np(a.q), np.asarray(b.q))
    np.testing.assert_array_equal(_np(a.scale).view(np.int32),
                                  np.asarray(b.scale).view(np.int32))


def _same_tree(a, b):
    if isinstance(b, jquant.QTensor):
        _same_qtensor(a, b)
    elif isinstance(b, dict):
        assert set(a) == set(b)
        for k in b:
            _same_tree(a[k], b[k])
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    elif b is None:
        assert a is None
    else:
        np.testing.assert_array_equal(_np(a), np.asarray(b))


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
    return run_j, run_t, params_j, params_t, sw_j, sw_t


# ---------------- layout: packing, QTensor, conversion ----------------
def test_pack_unpack_int4_matches_jax():
    codes = np.random.default_rng(0).integers(-7, 8, (3, 64, 16))
    packed = quant.pack_int4(_t(codes))
    want = jquant.pack_int4(jnp.asarray(codes))
    assert packed.dtype == torch.int8 and packed.shape == (3, 32, 16)
    np.testing.assert_array_equal(_np(packed), np.asarray(want))
    for got, exp in zip(quant.unpack_int4(packed), jquant.unpack_int4(want)):
        np.testing.assert_array_equal(_np(got), np.asarray(exp))
    lo, hi = quant.unpack_int4(packed)
    np.testing.assert_array_equal(_np(torch.cat([lo, hi], -2)), codes)
    with pytest.raises(ValueError, match="even row count"):
        quant.pack_int4(torch.zeros(5, 3, dtype=torch.int32))


@pytest.mark.parametrize("shape,bits", [((64, 48), 8), ((64, 48), 4),
                                        ((63, 8), 4), ((3, 64, 48), 4),
                                        ((3, 64, 48), 8)])
def test_quantize_tensor_matches_jax(shape, bits):
    """Codes byte-equal and scales bit-equal (odd rows fall back to int8;
    stacked leaves are quantized one leading index at a time); dequantize
    and take_columns bit-equal."""
    rng = np.random.default_rng(1)
    w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    w[..., 0, 3] = 0.5 * w[..., 1, 3]             # a half-way code
    got = quant.quantize_tensor(_t(w), bits)
    want = jquant.quantize_tensor(jnp.asarray(w), bits)
    _same_qtensor(got, want)
    assert got.bits == (8 if shape[-2] % 2 else bits)
    assert got.nbytes() == want.nbytes()
    np.testing.assert_array_equal(_np(got.dequantize()),
                                  np.asarray(want.dequantize()))
    if len(shape) == 2:
        ids = rng.integers(0, shape[1], (4, 3))
        ids[0] = [0, shape[1] - 1, 0]
        np.testing.assert_array_equal(
            _np(quant.take_columns(got, _t(ids))),
            np.asarray(jquant.take_columns(want, jnp.asarray(ids))))


@pytest.mark.parametrize("spec", ["int8", "int4", 8, 4, None, "INT4",
                                  "int2", 16, "fp8"])
def test_quant_spec_resolve_matches_jax(spec):
    try:
        want = jquant.QuantSpec.resolve(spec)
    except ValueError:
        with pytest.raises(ValueError):
            quant.QuantSpec.resolve(spec)
        return
    got = quant.QuantSpec.resolve(spec)
    if want is None:
        assert got is None
    else:
        assert (got.bits, got.lm_head, got.predictors, got.proj) == \
            (want.bits, want.lm_head, want.predictors, want.proj)
    s = quant.QuantSpec(bits=4, proj=False)
    assert quant.QuantSpec.resolve(s) is s
    with pytest.raises(ValueError):
        quant.QuantSpec(bits=16)


@pytest.mark.parametrize("spec", ["int8", "int4"])
def test_quantize_params_matches_jax_and_bridges(setup, spec):
    """The whole bundle — LM head, the stacked (E, ...) predictor bank and
    the stacked (reps, d_in, d_out) segment projections — equals JAX's;
    ``qw_from_numpy`` carries JAX's bundle across unchanged; the
    dequantized reference equals JAX's; nothing is written to params or
    sw."""
    _, _, params_j, params_t, sw_j, sw_t = setup
    before = [x.clone() for x in _leaves([params_t, sw_t.predictors])]
    got = quant.quantize_params(params_t, sw_t, spec)
    want = jquant.quantize_params(params_j, sw_j, spec)
    assert got["predictors"]["layers"][0]["w"].shape[0] == \
        sw_t.predictors["layers"][0]["w"].shape[0]       # (E, ...)
    _same_tree(got, want)
    _same_tree(bridge.qw_from_numpy(
        jax.tree_util.tree_map(np.asarray, want), "cpu"), want)
    p2, sw2 = quant.dequantized_reference(params_t, sw_t, got)
    p2_j, sw2_j = jquant.dequantized_reference(params_j, sw_j, want)
    _same_tree(p2, p2_j)
    _same_tree(sw2.predictors, sw2_j.predictors)
    for a, b in zip(before, _leaves([params_t, sw_t.predictors])):
        assert torch.equal(a, b)
    assert quant.quantize_params(params_t, sw_t, None) is None
    sel = quant.quantize_params(
        params_t, sw_t, quant.QuantSpec(bits=8, lm_head=False, proj=False))
    assert sel["lm_head"] is None and sel["proj"] is None
    assert sel["predictors"] is not None


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# ---------------- plain versions of the _q kernels against JAX ----------
def _head(bits, D=64, V=500, seed=5):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((D, V)) * 0.1).astype(np.float32)
    return w, jquant.quantize_tensor(jnp.asarray(w), bits)


def _t_q(qt_j):
    return bridge.qw_from_numpy(jax.tree_util.tree_map(np.asarray, qt_j),
                                "cpu")


def _verify_q_plain_vs_jax_kernel(bits, R, dtype):
    """The plain argmax/top-k over a quantized head (the port, CPU) against
    JAX's Pallas kernels in interpret mode on the same hidden rows in
    ``dtype``: ids exact, with the last row's best column planted at ids 0
    and V-1 (codes and scale), so three columns tie and the lowest id must
    win; values atol = rtol = 1e-5. The hidden rows are small integers, so
    they are exact in bf16 and each column's integer dot is exact in any
    order: equal columns give equal logits on both sides."""
    _, qt_j = _head(bits, seed=R)
    hn = np.random.default_rng(10 + R).integers(-2, 3, (R, 64)).astype(
        np.float32)
    h_t = _t(hn).to(dtype)
    h_j = jnp.asarray(hn, dtype=jnp.bfloat16 if dtype == torch.bfloat16
                      else jnp.float32)
    q, s = np.array(qt_j.q), np.array(qt_j.scale)
    V = q.shape[1]
    best = int(eg.argmax_verify_fused_q(h_t[-1:], _t_q(qt_j))[0][0])
    for j in (0, V - 1):
        q[:, j], s[j] = q[:, best], s[best]
    qt_j = jquant.QTensor(jnp.asarray(q), jnp.asarray(s), bits)
    qt_t = _t_q(qt_j)
    K.reset_launches()
    tok, mx = eg.argmax_verify_fused_q(h_t, qt_t)
    ids, vals = eg.topk_verify_fused_q(h_t, qt_t, 4)
    assert all(v == 0 for v in K.LAUNCHES.values())      # CPU: plain
    tok_j, mx_j = jgate_ops.verify_argmax(h_j, qt_j, impl="kernel",
                                          block_v=128)
    ids_j, vals_j = jgate_ops.verify_topk(h_j, qt_j, 4, impl="kernel",
                                          block_v=128)
    np.testing.assert_array_equal(_np(tok), np.asarray(tok_j))
    np.testing.assert_array_equal(_np(ids), np.asarray(ids_j))
    dup = sorted({0, best, V - 1})
    assert int(tok[-1]) == 0 and _np(ids[-1, :len(dup)]).tolist() == dup
    np.testing.assert_allclose(_np(mx), np.asarray(mx_j), **VTOL)
    np.testing.assert_allclose(_np(vals), np.asarray(vals_j), **VTOL)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("R", [1, 4, 9, 17])
def test_verify_q_plain_matches_jax_kernel(bits, R):
    """argmax_verify_fused_q / topk_verify_fused_q (plain on the CPU)
    against JAX's Pallas kernels (``_verify_q_plain_vs_jax_kernel``, fp32
    hidden rows; R = 17 crosses a 16-row m-tile). First the "ref" impl,
    which dequantizes the head first (so its sums round), against JAX's."""
    _, qt_j = _head(bits, seed=R)
    hn = np.random.default_rng(10 + R).integers(-2, 3, (R, 64)).astype(
        np.float32)
    for got, want in ((gate_ops.verify_argmax(_t(hn), _t_q(qt_j),
                                              impl="ref"),
                       jgate_ops.verify_argmax(jnp.asarray(hn), qt_j,
                                               impl="ref")),
                      (gate_ops.verify_topk(_t(hn), _t_q(qt_j), 4,
                                            impl="ref"),
                       jgate_ops.verify_topk(jnp.asarray(hn), qt_j, 4,
                                             impl="ref"))):
        np.testing.assert_array_equal(_np(got[0]), np.asarray(want[0]))
        np.testing.assert_allclose(_np(got[1]), np.asarray(want[1]), **VTOL)
    _verify_q_plain_vs_jax_kernel(bits, R, torch.float32)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("R", [4, 17])
def test_verify_q_plain_matches_jax_kernel_bf16_rows(bits, R):
    """The same with bf16 hidden rows, the input of the tensor-core tile on
    the card: the plain versions that the card tests hold the tile against
    equal JAX's kernels at the tile's input dtype, across a 16-row m-tile
    boundary (R = 17)."""
    _verify_q_plain_vs_jax_kernel(bits, R, torch.bfloat16)


@pytest.mark.parametrize("bits", [8, 4])
def test_spec_head_q_plain_matches_jax_kernel(bits):
    """spec_head_logits_q (plain: gather, then dequantize) against JAX's
    Pallas kernel, with ids 0 and V-1 and a repeated id."""
    _, qt_j = _head(bits, seed=11)
    rng = np.random.default_rng(12)
    hn = rng.standard_normal((6, 64)).astype(np.float32)
    ids = rng.integers(0, 500, (6, 4)).astype(np.int32)
    ids[0] = [0, 499, 499, 7]
    got = sh_ops.spec_head(_t(hn), _t_q(qt_j), _t(ids))
    want = jsh_ops.spec_head(jnp.asarray(hn), qt_j, jnp.asarray(ids))
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), **VTOL)


@pytest.mark.parametrize("bits", [8, 4])
def test_predictor_mlp_q_plain_matches_jax_kernel(bits):
    """predictor_mlp_fused_q (plain) against JAX's Pallas kernel, on one
    predictor and through ``predictor_mlp_at`` on a stacked (E, ...)
    quantized bank (codes and scales sliced together)."""
    rng = np.random.default_rng(13)
    E, F, H = 3, 12, 64
    x = rng.standard_normal((7, F)).astype(np.float32)
    bank = {"layers": [
        {"w": (rng.standard_normal((E, F, H)) * 0.3).astype(np.float32),
         "b": (rng.standard_normal((E, H)) * 0.1).astype(np.float32)},
        {"w": (rng.standard_normal((E, H, 1)) * 0.3).astype(np.float32),
         "b": (rng.standard_normal((E, 1)) * 0.1).astype(np.float32)}]}
    qbank_j = {"layers": [{"w": jquant.quantize_tensor(jnp.asarray(l["w"]),
                                                       bits),
                           "b": jnp.asarray(l["b"])}
                          for l in bank["layers"]]}
    qbank_t = bridge.qw_from_numpy(
        jax.tree_util.tree_map(np.asarray, qbank_j), "cpu")
    for ep in range(E):
        want = jpm_ops.predictor_mlp_at(jnp.asarray(x), qbank_j, ep)
        got = pm_ops.predictor_mlp_at(_t(x), qbank_t, ep)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6,
                                   rtol=0)


# ---------------- engines against JAX ----------------
def _models(run_j, run_t, kernels):
    flags = KERNEL_FLAGS if kernels else {}
    return jbuild(run_j, JFlags(**flags)), build_model(run_t,
                                                       ModelFlags(**flags))


def _session(E, model, params, sw, strategy, quant_spec, prompts, cache,
             new=6):
    s = E.create(model, params, sw, strategy=strategy,
                 quant=quant_spec).new_session(cache=cache)
    out = [s.prefill(prompts, max_new_tokens=new)]
    while not s.all_done():
        out.append(s.step())
    return [(np.asarray(r.tokens).tolist(), np.asarray(r.counts).tolist(),
             np.asarray(r.accept_len).tolist(),
             np.asarray(r.exit_layer).tolist(),
             np.asarray(r.exited).tolist(), int(r.units_run)) for r in out]


def _strategies(name, thresh):
    if name == "specee":
        return JSpecEE(threshold=thresh), SpecEEStrategy(threshold=thresh)
    if name == "tree":
        return (JTree(tree=JTreeSpec(2, 3), threshold=thresh),
                TreeStrategy(tree=TreeSpec(2, 3), threshold=thresh))
    return name, name


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("strategy,cache,spec", [
    ("specee", "dense", "int8"), ("specee", "dense", "int4"),
    ("specee", "paged", "int8"), ("specee", "paged", "int4"),
    ("dense", "dense", "int8"), ("tree", "paged", "int4")])
def test_quant_engine_matches_jax(setup, strategy, cache, spec, kernels):
    """Engine.create(quant=...) sessions: tokens, counts, accept lengths,
    exit points, exits and units_run equal JAX's with the same quant.
    Threshold -0.1 sends every active exit point through the quantized
    gate and verify."""
    run_j, run_t, params_j, params_t, sw_j, sw_t = setup
    m_j, m_t = _models(run_j, run_t, kernels)
    s_j, s_t = _strategies(strategy, -0.1)
    prompts = np.random.default_rng(21).integers(0, 512, (2, 8))
    K.reset_launches()
    got = _session(Engine, m_t, params_t, sw_t, s_t, spec, prompts, cache)
    assert all(v == 0 for v in K.LAUNCHES.values())       # CPU: plain
    want = _session(JEngine, m_j, params_j, sw_j, s_j, spec,
                    jnp.asarray(prompts), cache)
    assert got == want


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("spec", ["int8", "int4"])
def test_quant_oracle_exits_match_jax(setup, spec, kernels):
    """Raw ``ar_decode_step(..., qw=...)`` with an oracle speculative set
    (the argmax after units 0 and 1 of the dequantized model): at
    threshold -0.1 rows exit, confirmed by the quantized verify; at 1.5
    none do. Tokens, exit points, exits, spec hits and units_run equal
    JAX's on the same bundle, bridged with ``qw_from_numpy``."""
    run_j, run_t, params_j, params_t, sw_j, sw_t = setup
    m_j, m_t = _models(run_j, run_t, kernels)
    qw_j = jquant.quantize_params(params_j, sw_j, spec)
    qw_t = bridge.qw_from_numpy(jax.tree_util.tree_map(np.asarray, qw_j),
                                "cpu")
    pv_j, sv_j = jquant.dequantized_reference(params_j, sw_j, qw_j)
    pv_t, sv_t = quant.dequantized_reference(params_t, sw_t, qw_t)
    # the port's steps take the projections already dequantized
    step_params = dict(params_t, segments=pv_t["segments"])
    step_qw = dict(qw_t, proj=None)
    prompts = np.random.default_rng(22).integers(0, 512, (2, 8))
    step_j = jax.jit(lambda st, ov, th: jeng.ar_decode_step(
        m_j, params_j, sw_j, st, threshold=th, spec_ids_override=ov,
        qw=qw_j))
    for thresh in (1.5, -0.1):
        _, st_j = jeng.init_decode_state(m_j, pv_j, sv_j,
                                         {"tokens": jnp.asarray(prompts)},
                                         16)
        _, st_t = teng.init_decode_state(m_t, pv_t, sv_t,
                                         {"tokens": _t(prompts)}, 16)
        exits = 0
        for _ in range(3):
            h = m_j.embed(pv_j, st_j.last_token[:, None])[:, 0, :]
            seg, pos, sets = st_j.cache["segments"][0], st_j.cache["len"], []
            for u in range(2):
                h, seg = m_j.run_unit(pv_j, 0, jnp.int32(u), h, seg, pos)
                sets.append(np.asarray(jnp.argmax(m_j.logits(pv_j, h), -1)))
            ov = np.stack(sets * 2, axis=1).astype(np.int32)
            tok_j, st_j, info_j = step_j(st_j, jnp.asarray(ov),
                                         jnp.float32(thresh))
            tok_t, st_t, info_t = teng.ar_decode_step(
                m_t, step_params, sw_t, st_t, threshold=thresh,
                spec_ids_override=_t(ov), qw=step_qw)
            np.testing.assert_array_equal(_np(tok_t), np.asarray(tok_j))
            for name in ("exit_point", "exited", "spec_hit"):
                np.testing.assert_array_equal(
                    _np(getattr(info_t, name)),
                    np.asarray(getattr(info_j, name)), err_msg=name)
            assert info_t.units_run == int(info_j.units_run)
            exits += int(info_t.exited.sum())
        assert (exits == 0) if thresh > 1 else (exits == 6)


def test_decode_step_refuses_proj(setup):
    """The port's decode steps take projections already dequantized
    (``Engine.decode_weights``, once per engine); a bundle that still
    holds ``proj`` is refused, not dequantized again on every step."""
    _, _, _, params_t, _, sw_t = setup
    qw = quant.quantize_params(params_t, sw_t, "int8")
    assert qw.get("proj") is not None
    with pytest.raises(ValueError, match="proj"):
        teng._apply_qw(params_t, sw_t, qw)
    p, lm_w, pred = teng._apply_qw(params_t, sw_t, dict(qw, proj=None))
    assert p is params_t and lm_w is qw["lm_head"]
    assert pred is qw["predictors"]


@pytest.mark.parametrize("strategy", ["dense", "specee"])
@pytest.mark.parametrize("cache", ["dense", "paged"])
@pytest.mark.parametrize("spec", ["int8", "int4"])
def test_quant_engine_equals_plain_engine_on_dequantized_view(
        setup, strategy, cache, spec):
    """The contract of JAX's ``test_engine_quant_token_parity``: the
    quantized engine emits exactly what the plain engine emits on
    ``dequantized_reference``, with the kernel flags on."""
    run_j, run_t, _, params_t, _, sw_t = setup
    m_t = build_model(run_t, ModelFlags(**KERNEL_FLAGS))
    prompts = np.random.default_rng(23).integers(0, 512, (2, 8))
    e_q = Engine.create(m_t, params_t, sw=sw_t, strategy=strategy,
                        quant=spec)
    assert e_q.quant_spec.bits == int(spec[-1]) and e_q.qw is not None
    pv, sv = quant.dequantized_reference(params_t, sw_t, e_q.qw)
    assert e_q.prefill_weights()[0]["lm_head"]["w"].dtype == torch.float32
    outs = []
    for e in (e_q, Engine.create(m_t, pv, sw=sv, strategy=strategy)):
        s = e.new_session(cache=cache)
        res = [s.prefill(prompts, max_new_tokens=6)]
        while not s.all_done():
            res.append(s.step())
        outs.append([sum((r.row_tokens(b) for r in res), [])
                     for b in range(2)])
    assert outs[0] == outs[1] and all(len(t) == 6 for t in outs[0])
    e = Engine.create(m_t, params_t, sw=sw_t, strategy=strategy)
    assert e.qw is None and e.quant_spec is None


def test_mixed_quant_spec_matches_jax(setup):
    """QuantSpec(lm_head=False, predictors=True, proj=False): only the
    predictor bank is quantized (the fused gate is left for the piecewise
    one); tokens and step fields equal JAX's."""
    run_j, run_t, params_j, params_t, sw_j, sw_t = setup
    m_j, m_t = _models(run_j, run_t, True)
    s_j, s_t = _strategies("specee", -0.1)
    prompts = np.random.default_rng(24).integers(0, 512, (2, 8))
    spec_j = jquant.QuantSpec(bits=4, lm_head=False, predictors=True,
                              proj=False)
    spec_t = quant.QuantSpec(bits=4, lm_head=False, predictors=True,
                             proj=False)
    got = _session(Engine, m_t, params_t, sw_t, s_t, spec_t, prompts,
                   "paged")
    want = _session(JEngine, m_j, params_j, sw_j, s_j, spec_j,
                    jnp.asarray(prompts), "paged")
    assert got == want


@pytest.mark.parametrize("chunk", [0, 4])
def test_quant_serving_matches_jax(setup, chunk):
    """ServingEngine(quant="int4", cache="paged"): three requests through
    the two slots, blocking and chunked admission; per-request tokens and
    exit points equal the JAX ServingEngine's; every page returns."""
    run_j, run_t, params_j, params_t, sw_j, sw_t = setup
    m_j, m_t = _models(run_j, run_t, False)
    rng = np.random.default_rng(25)
    prompts = [rng.integers(0, 512, int(rng.integers(4, 12)))
               for _ in range(3)]
    outs = []
    for E, m, p, sw in ((JServingEngine, m_j, params_j, sw_j),
                        (ServingEngine, m_t, params_t, sw_t)):
        se = E(m, p, sw, quant="int4", cache="paged", prefill_chunk=chunk)
        reqs = [se.submit(pr, max_new_tokens=6) for pr in prompts]
        se.run_to_completion()
        assert all(r.done and len(r.output) == 6 for r in reqs)
        mgr = se.session.cache_mgr
        assert mgr.free_pages == mgr.num_pages
        outs.append([(r.output, r.exit_points) for r in reqs])
    assert outs[0] == outs[1]
    assert se.engine.quant_spec.bits == 4
