"""The MoE configs of the port against the JAX package (CPU, fp32, the
``.smoke()`` of dbrx-132b and qwen3-moe-235b-a22b: 4 experts, top-2,
expert width 128): both MoE forms against JAX's and each other, router
ties, decode against the full forward, AR SpecEE and tree sessions, paged
serving, int8 weights that leave the expert banks alone, ``train_loss``
with its load-balancing term and its gradients, a ``TrainLoop`` step, and
the mesh flags ``moe_ep_quant`` and ``moe_bf16_reduce`` built and
behaving as JAX's (expert parallelism itself: ``test_torch_train_
mesh.py``).

Tolerance: tokens, exit points, exits, accept lengths and units_run
exact; logits, outputs and gradients atol = rtol = 1e-5 (fp32, another
summation order; the top-k form also sums the k experts apart from the
other E - k); under ``moe_bf16_reduce`` logits atol = rtol = 1e-3 (a
sum an fp32 ulp apart can round to the next bf16 value)."""
import dataclasses

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
from repro.models import moe as jmoe  # noqa: E402
from repro.models.common import KeyGen  # noqa: E402
from repro.models.model import ModelFlags as JFlags  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro.train import TrainLoop as JTrainLoop  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.api import Engine, SpecEEStrategy, TreeStrategy  # noqa
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.tree import TreeSpec  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.models.common import tree_unflatten  # noqa: E402
from repro_torch.models.model import ModelFlags, build_model  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.train import TrainLoop  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small ops: one intra-op thread, so parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=1e-3, rtol=1e-3)
MOE = ["dbrx-132b", "qwen3-moe-235b-a22b"]


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _to_torch(tree):
    return bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                                    "cpu", torch.float32)


@pytest.fixture(scope="module", params=MOE)
def bundle(request):
    name = request.param
    m_j = jbuild(jax_get_config(name).smoke())
    params_j = m_j.init(jax.random.PRNGKey(0))
    sw_j = jeng.init_specee(m_j, jax.random.PRNGKey(1))
    sw_np = jax.tree_util.tree_map(np.asarray, sw_j)
    sw_t = bridge.specee_from_numpy(sw_np.draft, sw_np.predictors,
                                    sw_np.offline_mask, "cpu", torch.float32)
    return name, m_j, params_j, sw_j, _to_torch(params_j), sw_t


def _moe_params(name, seed=3):
    cfg_j = jax_get_config(name).smoke().model
    p_j = jmoe.init_moe(cfg_j, KeyGen(jax.random.PRNGKey(seed)))
    return cfg_j, get_config(name).smoke().model, p_j, _to_torch(p_j)


@pytest.mark.parametrize("name", MOE)
def test_moe_forms_match_jax_and_each_other(name):
    """``apply_moe`` (dense einsum; one chunk, and chunks of 4 tokens whose
    aux losses average), ``apply_moe_topk`` (grouped by expert),
    ``router_probs`` and ``load_balancing_loss`` against JAX's, and the two
    forms against each other."""
    cfg_j, cfg_t, p_j, p_t = _moe_params(name)
    x = np.random.default_rng(0).standard_normal((2, 12, 128)).astype(
        np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    comb_j, logit_j = jmoe.router_probs(cfg_j, p_j, xj)
    comb_t, logit_t = moe.router_probs(cfg_t, p_t, xt)
    np.testing.assert_allclose(_np(comb_t), _np(comb_j), **TOL)
    np.testing.assert_allclose(_np(logit_t), _np(logit_j), **TOL)
    assert float(moe.load_balancing_loss(cfg_t, logit_t.reshape(-1, 4))) == \
        pytest.approx(float(jmoe.load_balancing_loss(
            cfg_j, logit_j.reshape(-1, 4))), rel=1e-6)
    outs = {}
    for chunk in (4096, 4):
        out_j, aux_j = jmoe.apply_moe(cfg_j, p_j, xj, token_chunk=chunk)
        out_t, aux_t = moe.apply_moe(cfg_t, p_t, xt, token_chunk=chunk)
        np.testing.assert_allclose(_np(out_t), _np(out_j), **TOL)
        assert float(aux_t) == pytest.approx(float(aux_j), rel=1e-6)
        outs[chunk] = out_t
    out_j, aux_j = jmoe.apply_moe_topk(cfg_j, p_j, xj)
    out_t, aux_t = moe.apply_moe_topk(cfg_t, p_t, xt)
    np.testing.assert_allclose(_np(out_t), _np(out_j), **TOL)
    np.testing.assert_allclose(_np(out_t), _np(outs[4096]), **TOL)
    assert float(aux_t) == pytest.approx(float(aux_j), rel=1e-6)


def test_router_ties_pick_the_lower_expert_first():
    """Equal router logits: ``lax.top_k`` takes the lower expert id first,
    and so do both port forms. Experts 1, 2 and 3 get the same router
    column, so every token ties three ways among them: the top two are
    (0, 1) or (1, 2), never expert 3. The top-k ids, the combine weights
    and both forms' outputs equal JAX's."""
    cfg_j, cfg_t, p_j, p_t = _moe_params("dbrx-132b", seed=5)
    w = np.asarray(p_j["router"]["w"]).copy()
    w[:, 2] = w[:, 1]
    w[:, 3] = w[:, 1]
    p_j = dict(p_j, router={"w": jnp.asarray(w)})
    p_t = dict(p_t, router={"w": torch.from_numpy(w)})
    x = np.random.default_rng(1).standard_normal((1, 9, 128)).astype(
        np.float32)
    logits = torch.from_numpy(x.reshape(9, 128)) @ torch.from_numpy(w)
    _, ids_t = moe._top_k(logits, 2)
    _, ids_j = jax.lax.top_k(jnp.asarray(logits.numpy()), 2)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    assert bool((ids_t != 3).all()) and bool((ids_t[:, 1] <= 2).all())
    comb_j, _ = jmoe.router_probs(cfg_j, p_j, jnp.asarray(x))
    comb_t, _ = moe.router_probs(cfg_t, p_t, torch.from_numpy(x))
    np.testing.assert_allclose(_np(comb_t), _np(comb_j), **TOL)
    for fj, ft in ((jmoe.apply_moe, moe.apply_moe),
                   (jmoe.apply_moe_topk, moe.apply_moe_topk)):
        out_j, _ = fj(cfg_j, p_j, jnp.asarray(x))
        out_t, _ = ft(cfg_t, p_t, torch.from_numpy(x))
        np.testing.assert_allclose(_np(out_t), _np(out_j), **TOL)


@pytest.mark.parametrize("impl", ["dense", "topk"])
def test_decode_matches_full_forward(bundle, impl):
    """JAX's ``test_decode_matches_full_forward`` on the port: prefill of
    6 tokens then 6 decode steps reproduce the teacher-forced full
    forward's logits, and both equal JAX's full forward."""
    name, m_j, params_j, _, params_t, _ = bundle
    m_t = build_model(get_config(name).smoke(), ModelFlags(moe_impl=impl))
    B, S, T = 2, 12, 6
    tokens = np.random.default_rng(2).integers(0, 512, (B, S)).astype(
        np.int32)
    h = m_j.embed(params_j, jnp.asarray(tokens))
    pos = jnp.broadcast_to(jnp.arange(S)[None, :], (B, S))
    want = np.asarray(m_j.logits(params_j,
                                 m_j.forward_hidden(params_j, h, pos)[0]))
    with torch.no_grad():
        tt = torch.from_numpy(tokens)
        hf, _, _ = m_t.forward_hidden(
            params_t, m_t.embed(params_t, tt),
            torch.arange(S)[None, :].expand(B, S))
        full = m_t.logits(params_t, hf).numpy()
        np.testing.assert_allclose(full, want, **TOL)
        logits, cache, _ = m_t.prefill(params_t, {"tokens": tt[:, :T]},
                                       max_seq=S + 2)
        np.testing.assert_allclose(logits.numpy(), full[:, T - 1], **TOL)
        for t in range(T, S):
            logits, cache = m_t.decode_step(params_t, tt[:, t], cache)
            np.testing.assert_allclose(logits.numpy(), full[:, t], **TOL,
                                       err_msg=f"{name} step {t}")


def _drain(session, first):
    toks = [first.row_tokens(b) for b in range(first.batch)]
    info = []
    while not session.all_done():
        res = session.step()
        info.append((np.asarray(res.exit_layer).tolist(),
                     np.asarray(res.exited).tolist(),
                     np.asarray(res.accept_len).tolist(),
                     int(res.units_run)))
        for b in range(res.batch):
            toks[b].extend(res.row_tokens(b))
    return toks, info


@pytest.mark.parametrize("impl", ["dense", "topk"])
@pytest.mark.parametrize("name", MOE)
def test_sessions_match_jax(name, impl):
    """AR SpecEE (threshold 0.4) and tree (TreeSpec(2, 3)) sessions through
    ``Engine``, each MoE form against JAX's same form, on the smoke config
    with a 16-token vocabulary so that the random draft's four guesses
    often hold the verified token and rows exit early (skipped units then
    propagate their K/V): every token, exit point, exit, accept length and
    units_run equal."""
    run_j = jax_get_config(name).smoke()
    run_j = dataclasses.replace(run_j, model=dataclasses.replace(
        run_j.model, vocab_size=16))
    run_t = get_config(name).smoke()
    run_t = dataclasses.replace(run_t, model=dataclasses.replace(
        run_t.model, vocab_size=16))
    m_j = jbuild(run_j, JFlags(moe_impl=impl))
    m_t = build_model(run_t, ModelFlags(moe_impl=impl))
    params_j = m_j.init(jax.random.PRNGKey(0))
    sw_j = jeng.init_specee(m_j, jax.random.PRNGKey(1))
    sw_np = jax.tree_util.tree_map(np.asarray, sw_j)
    sw_t = bridge.specee_from_numpy(sw_np.draft, sw_np.predictors,
                                    sw_np.offline_mask, "cpu", torch.float32)
    params_t = _to_torch(params_j)
    prompts = np.random.default_rng(7).integers(0, 16, (2, 9))
    exits = 0
    for strat_j, strat_t, new in (
            (JSpecEE(threshold=0.4), SpecEEStrategy(threshold=0.4), 8),
            (JTree(tree=JTreeSpec(2, 3), threshold=0.4),
             TreeStrategy(tree=TreeSpec(2, 3), threshold=0.4), 8)):
        s = JEngine.create(m_j, params_j, sw_j,
                           strategy=strat_j).new_session()
        want = _drain(s, s.prefill(jnp.asarray(prompts), max_new_tokens=new))
        s = Engine.create(m_t, params_t, sw_t,
                          strategy=strat_t).new_session()
        got = _drain(s, s.prefill(prompts, max_new_tokens=new))
        assert got == want, strat_t.name
        exits += sum(sum(e) for _, e, _, _ in got[1])
    assert exits > 0, "no row ever exited early"


def test_paged_serving_matches_jax(bundle):
    """``ServingEngine`` on the paged cache, SpecEE, three prompts of
    ragged lengths over two slots: every request's tokens and exit points
    equal JAX's engine's."""
    name, m_j, params_j, sw_j, params_t, sw_t = bundle
    m_t = build_model(get_config(name).smoke())
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 512, int(n)) for n in (5, 11, 8)]
    outs = []
    for cls, m, params, sw in ((JServingEngine, m_j, params_j, sw_j),
                               (ServingEngine, m_t, params_t, sw_t)):
        se = cls(m, params, sw, strategy="specee", cache="paged")
        reqs = [se.submit(p, max_new_tokens=5) for p in prompts]
        se.run_to_completion()
        outs.append([(list(r.output), list(r.exit_points)) for r in reqs])
    assert outs[0] == outs[1]


def test_int8_leaves_the_expert_banks_and_matches_jax():
    """``quant="int8"`` on dbrx: the attention projections of every MoE
    block are quantized and the router and expert banks are not (JAX
    ``quant/core.py``: expert banks are never quantized); the quantized
    SpecEE session emits JAX's quantized engine's tokens and exits."""
    name = "dbrx-132b"
    m_j = jbuild(jax_get_config(name).smoke())
    params_j = m_j.init(jax.random.PRNGKey(0))
    sw_j = jeng.init_specee(m_j, jax.random.PRNGKey(1))
    sw_np = jax.tree_util.tree_map(np.asarray, sw_j)
    sw_t = bridge.specee_from_numpy(sw_np.draft, sw_np.predictors,
                                    sw_np.offline_mask, "cpu", torch.float32)
    params_t = _to_torch(params_j)
    m_t = build_model(get_config(name).smoke())
    eng = Engine.create(m_t, params_t, sw_t,
                        strategy=SpecEEStrategy(threshold=0.4), quant="int8")
    view, _, _ = eng.decode_weights()
    qproj = eng.qw["proj"][0]["u0"]
    assert set(qproj) == {"attn"}
    for key in ("router", "wi", "wg", "wo"):
        a = tree_leaves(params_t["segments"][0]["u0"]["moe"][key])
        b = tree_leaves(view["segments"][0]["u0"]["moe"][key])
        assert all(torch.equal(x, y) for x, y in zip(a, b)), key
    assert not torch.equal(view["segments"][0]["u0"]["attn"]["wq"]["w"],
                           params_t["segments"][0]["u0"]["attn"]["wq"]["w"])
    prompts = np.random.default_rng(8).integers(0, 512, (2, 7))
    s = JEngine.create(m_j, params_j, sw_j, strategy=JSpecEE(threshold=0.4),
                       quant="int8").new_session()
    want = _drain(s, s.prefill(jnp.asarray(prompts), max_new_tokens=5))
    s = eng.new_session()
    assert _drain(s, s.prefill(prompts, max_new_tokens=5)) == want


def _pairs(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            yield from _pairs(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _pairs(x, y, f"{path}/{i}")
    else:
        yield path, _np(a), np.asarray(b)


@pytest.mark.parametrize("impl", ["dense", "topk"])
def test_train_loss_aux_and_grads_match_jax(bundle, impl):
    """``train_loss`` = CE + the summed load-balancing terms of every MoE
    block, and every gradient (router and expert banks included), equal
    ``jax.value_and_grad`` of JAX's for each MoE form."""
    name, _, params_j, _, params_t, _ = bundle
    m_j = jbuild(jax_get_config(name).smoke(), JFlags(moe_impl=impl))
    m_t = build_model(get_config(name).smoke(), ModelFlags(moe_impl=impl))
    tokens = np.random.default_rng(5).integers(0, 512, (2, 16)).astype(
        np.int32)
    (loss_j, aux_j), g_j = jax.jit(jax.value_and_grad(
        m_j.train_loss, has_aux=True))(params_j,
                                       {"tokens": jnp.asarray(tokens)})
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params_t)]
    loss_t, aux_t = m_t.train_loss(tree_unflatten(params_t, leaves),
                                   {"tokens": torch.from_numpy(tokens)})
    grads = tree_unflatten(params_t, torch.autograd.grad(loss_t, leaves))
    assert float(aux_t["aux"].detach()) > 0
    assert float(aux_t["aux"].detach()) == pytest.approx(float(aux_j["aux"]),
                                                rel=1e-5)
    assert float(loss_t.detach()) == pytest.approx(float(loss_j), rel=1e-5)
    n_moe = 0
    for path, a, b in _pairs(grads, g_j):
        np.testing.assert_allclose(a, b, err_msg=path, **TOL)
        n_moe += "/moe/" in path
    assert n_moe == 4             # router, wi, wg, wo


def test_train_loop_step_matches_jax(bundle):
    """One ``TrainLoop`` step (AdamW, the smoke train config) on the
    synthetic pipeline: the loss and every updated parameter equal JAX's
    loop's."""
    name, m_j, params_j, _, params_t, _ = bundle
    run_j = jax_get_config(name).smoke()
    run_t = get_config(name).smoke()
    loop_j = JTrainLoop(m_j, run_j, params_j)
    loop_t = TrainLoop(build_model(run_t), run_t,
                       tree_map(torch.clone, params_t))
    lj = loop_j.run_steps(1)["loss"]
    lt = loop_t.run_steps(1)["loss"]
    assert lt == pytest.approx(lj, rel=1e-4)
    atol = run_t.train.learning_rate
    for path, a, b in _pairs(loop_t.params, loop_j.params):
        np.testing.assert_allclose(a, b, atol=atol, err_msg=path)


def test_ep_options_are_refused_and_the_draft_drops_the_moe(bundle):
    """``moe_ep_quant`` and ``moe_bf16_reduce`` are built and behave as
    JAX's: the prefill logits of a model with each flag against JAX's
    same model (under ``moe_bf16_reduce`` at a quarter of a bf16 spacing,
    rtol = atol = 1e-3: a sum one fp32 ulp apart can round to the next bf16
    value, and later layers carry that on; ``moe_ep_quant`` quantizes
    only under ``act_batch_axes``,
    so without it the logits are the plain model's, in both packages;
    JAX's with it runs under a (1, 1) ("data", "model") mesh); an unknown
    ``moe_impl`` is refused. The draft of a MoE target is a dense
    one-layer block (JAX ``draft.py``: moe=None): its params carry a
    plain MLP."""
    from jax.sharding import Mesh
    name, _, params_j, _, params_t, sw_t = bundle
    run = get_config(name).smoke()
    tokens = np.random.default_rng(6).integers(0, run.model.vocab_size,
                                               (2, 12)).astype(np.int32)
    plain = None
    for kw in ({}, dict(moe_ep_quant=True), dict(moe_bf16_reduce=True),
               dict(moe_ep_quant=True, act_batch_axes="data")):
        m_j = jbuild(jax_get_config(name).smoke(), JFlags(**kw))
        with Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                  ("data", "model")):
            want = np.asarray(jax.jit(lambda p, t: m_j.prefill(p, {
                "tokens": t})[0])(params_j, jnp.asarray(tokens)))
        with torch.no_grad():
            got = build_model(run, ModelFlags(**kw)).prefill(
                params_t, {"tokens": torch.from_numpy(tokens)})[0]
        np.testing.assert_allclose(_np(got), want, err_msg=str(kw),
                                   **(BF16_TOL if "moe_bf16_reduce" in kw
                                      else TOL))
        if plain is None:
            plain = want
        elif kw == dict(moe_ep_quant=True):
            np.testing.assert_array_equal(want, plain)
        else:
            assert np.abs(want - plain).max() > 1e-6, kw
    with pytest.raises(ValueError, match="moe_impl"):
        build_model(run, ModelFlags(moe_impl="gather"))
    assert "mlp" in sw_t.draft and "moe" not in sw_t.draft
    assert dataclasses.replace(run.model, moe=None).param_count() < \
        run.model.param_count()
    assert run.model.param_count() == jax_get_config(name).smoke() \
        .model.param_count()
