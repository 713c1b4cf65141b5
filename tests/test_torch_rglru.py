"""The RG-LRU hybrid of the port against the JAX package (CPU, fp32, the
``.smoke()`` of recurrentgemma-9b: two (rglru, rglru, local_attention)
units, lru width 128, local window 64): the block's functions, the
log-depth scan, decode against the full forward, a prompt longer than the
window, AR SpecEE sessions on the dense and the paged cache (rows that
exit keep their recurrent state), paged serving, ``train_loss`` and its
gradients, a ``TrainLoop`` step, and the hybrid's rules (no tree, no
chunked admission).

Tolerance: tokens, exit points, exits and units_run exact; logits,
states and gradients atol = rtol = 1e-5 (fp32). The scan runs JAX's
``associative_scan`` recursion, combine for combine: on equal inputs it is
bit-equal to JAX's. Its inputs, the gates, come from exp, sigmoid, sqrt
and softplus, whose XLA and torch implementations differ by an ulp (b by
~1e-6); through the recurrence over the 98-token prompt those
differences reach the logits at ~1.2e-5, so that one test holds logits at
atol = rtol = 3e-5 (``LONG_TOL``)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import Engine as JEngine  # noqa: E402
from repro.api import SpecEEStrategy as JSpecEE  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models.common import KeyGen  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.models.model import segments_of as j_segments_of  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro.train import TrainLoop as JTrainLoop  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.api import Engine, SpecEEStrategy, TreeStrategy  # noqa
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import rglru  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.models.common import tree_unflatten  # noqa: E402
from repro_torch.models.model import _window, build_model  # noqa: E402
from repro_torch.models.model import segments_of  # noqa: E402
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
LONG_TOL = dict(atol=3e-5, rtol=3e-5)
NAME = "recurrentgemma-9b"


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _to_torch(tree):
    return bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                                    "cpu", torch.float32)


def _runs(vocab=None):
    run_j, run_t = jax_get_config(NAME).smoke(), get_config(NAME).smoke()
    if vocab is not None:
        run_j, run_t = (dataclasses.replace(r, model=dataclasses.replace(
            r.model, vocab_size=vocab)) for r in (run_j, run_t))
    return run_j, run_t


def _bundle(vocab=None):
    run_j, run_t = _runs(vocab)
    m_j = jbuild(run_j)
    params_j = m_j.init(jax.random.PRNGKey(0))
    sw_j = jeng.init_specee(m_j, jax.random.PRNGKey(1))
    sw_np = jax.tree_util.tree_map(np.asarray, sw_j)
    sw_t = bridge.specee_from_numpy(sw_np.draft, sw_np.predictors,
                                    sw_np.offline_mask, "cpu", torch.float32)
    return m_j, params_j, sw_j, build_model(run_t), _to_torch(params_j), sw_t


@pytest.fixture(scope="module")
def bundle():
    return _bundle()


@pytest.fixture(scope="module")
def rec():
    cfg_j = jax_get_config(NAME).smoke().model
    p_j = jrglru.init_rglru(cfg_j, KeyGen(jax.random.PRNGKey(3)))
    p_j = dict(p_j, wa={"w": p_j["wa"]["w"], "b": p_j["wa"]["b"] + 0.1},
               wi={"w": p_j["wi"]["w"], "b": p_j["wi"]["b"] - 0.1},
               conv_b=p_j["conv_b"] + 0.05)       # nonzero biases
    return cfg_j, get_config(NAME).smoke().model, p_j, _to_torch(p_j)


@pytest.mark.parametrize("S", [1, 2, 7, 64, 100])
def test_scan_matches_jax(rec, S):
    """``rglru_scan`` (log-depth, JAX's recursion) with and without an
    initial state, against JAX's ``associative_scan``: the hiddens and the
    final state; and ``rglru_step`` folded S times reproduces the scan."""
    cfg_j, cfg_t, p_j, p_t = rec
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, 128)).astype(np.float32)
    h0 = rng.standard_normal((2, 128)).astype(np.float32)
    for init in (None, h0):
        hj, fj = jrglru.rglru_scan(p_j, jnp.asarray(x),
                                   None if init is None else jnp.asarray(init))
        ht, ft = rglru.rglru_scan(p_t, torch.from_numpy(x),
                                  None if init is None else
                                  torch.from_numpy(init))
        np.testing.assert_allclose(_np(ht), _np(hj), **TOL)
        np.testing.assert_allclose(_np(ft), _np(fj), **TOL)
    h = torch.from_numpy(h0)
    for t in range(S):
        out, h = rglru.rglru_step(p_t, torch.from_numpy(x[:, t]), h)
    np.testing.assert_allclose(_np(h), _np(ft), **TOL)


def test_block_functions_match_jax(rec):
    """``_gates``, ``_conv_seq`` with and without a carried window,
    ``rglru_block_seq`` (its conv tail None below K-1 tokens, as JAX's)
    and ``rglru_block_step`` against JAX's."""
    cfg_j, cfg_t, p_j, p_t = rec
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 128)).astype(np.float32)
    carry = rng.standard_normal((2, 3, 128)).astype(np.float32)
    for a, b in zip(rglru._gates(p_t, torch.from_numpy(x)),
                    jrglru._gates(p_j, jnp.asarray(x))):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)
    for c in (None, carry):
        np.testing.assert_allclose(
            _np(rglru._conv_seq(p_t, torch.from_numpy(x),
                                None if c is None else torch.from_numpy(c))),
            _np(jrglru._conv_seq(p_j, jnp.asarray(x),
                                 None if c is None else jnp.asarray(c))),
            **TOL)
    for S in (9, 2):
        got = rglru.rglru_block_seq(cfg_t, p_t, torch.from_numpy(x[:, :S]))
        want = jrglru.rglru_block_seq(cfg_j, p_j, jnp.asarray(x[:, :S]))
        for a, b in zip(got, want):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_allclose(_np(a), _np(b), **TOL)
    h = rng.standard_normal((2, 128)).astype(np.float32)
    got = rglru.rglru_block_step(cfg_t, p_t, torch.from_numpy(x[:, 0]),
                                 torch.from_numpy(h), torch.from_numpy(carry))
    want = jrglru.rglru_block_step(cfg_j, p_j, jnp.asarray(x[:, 0]),
                                   jnp.asarray(h), jnp.asarray(carry))
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)


def _decode_vs_full(m_j, params_j, m_t, params_t, S, T, seed, tol=TOL):
    tokens = np.random.default_rng(seed).integers(
        0, m_t.cfg.vocab_size, (2, S)).astype(np.int32)
    h = m_j.embed(params_j, jnp.asarray(tokens))
    pos = jnp.broadcast_to(jnp.arange(S)[None, :], (2, S))
    want = np.asarray(m_j.logits(params_j,
                                 m_j.forward_hidden(params_j, h, pos)[0]))
    with torch.no_grad():
        tt = torch.from_numpy(tokens)
        hf, _, _ = m_t.forward_hidden(params_t, m_t.embed(params_t, tt),
                                      torch.arange(S)[None, :].expand(2, S))
        full = m_t.logits(params_t, hf).numpy()
        np.testing.assert_allclose(full, want, **tol)
        logits, cache, _ = m_t.prefill(params_t, {"tokens": tt[:, :T]},
                                       max_seq=S + 2)
        np.testing.assert_allclose(logits.numpy(), full[:, T - 1], **TOL)
        for t in range(T, S):
            logits, cache = m_t.decode_step(params_t, tt[:, t], cache)
            np.testing.assert_allclose(logits.numpy(), full[:, t], **TOL,
                                       err_msg=f"step {t}")
    return want


def test_decode_matches_full_forward(bundle):
    """JAX's ``test_decode_matches_full_forward`` on the port's hybrid:
    prefill of 6 tokens then 6 decode steps reproduce the full forward's
    logits, and both equal JAX's."""
    m_j, params_j, _, m_t, params_t, _ = bundle
    _decode_vs_full(m_j, params_j, m_t, params_t, S=12, T=6, seed=1)


def test_prompt_longer_than_the_window_matches_jax(bundle):
    """The local-attention blocks read the config's window (64 in the
    smoke config), not 2048: a 90-token prompt, then 8 decode steps past
    it, match JAX's full forward; the same stack with a 2048-token window
    (the port's old hard-coded value) gives other logits."""
    m_j, params_j, _, m_t, params_t, _ = bundle
    assert _window(m_t.cfg, "local_attention") == 64
    assert _window(m_t.cfg, "attention") is None
    want = _decode_vs_full(m_j, params_j, m_t, params_t, S=98, T=90,
                           seed=2, tol=LONG_TOL)
    wide = build_model(dataclasses.replace(
        m_t.run, model=dataclasses.replace(
            m_t.cfg, rglru=dataclasses.replace(m_t.cfg.rglru,
                                               window=2048))))
    tokens = np.random.default_rng(2).integers(0, 512, (2, 98))
    with torch.no_grad():
        logits, _, _ = wide.prefill(params_t,
                                    {"tokens": torch.as_tensor(tokens)})
    assert np.abs(logits.numpy() - want[:, -1]).max() > 1e-3


def _drain(session, first):
    toks = [first.row_tokens(b) for b in range(first.batch)]
    info = []
    while not session.all_done():
        res = session.step()
        info.append((np.asarray(res.exit_layer).tolist(),
                     np.asarray(res.exited).tolist(), int(res.units_run)))
        for b in range(res.batch):
            toks[b].extend(res.row_tokens(b))
    return toks, info


def test_sessions_match_jax_dense_and_paged():
    """AR SpecEE sessions (threshold 0.4) on the dense and the paged cache
    (attention entries paged, recurrent entries per row: JAX's
    ``test_paged_hybrid_arch``), on the smoke config with a 16-token
    vocabulary so that rows exit early: exited rows keep their recurrent
    state while their conv windows advance. Every token, exit point and
    units_run equals JAX's dense session's, and the port's two layouts
    agree."""
    m_j, params_j, sw_j, m_t, params_t, sw_t = _bundle(vocab=16)
    prompts = np.random.default_rng(5).integers(0, 16, (2, 6))
    s = JEngine.create(m_j, params_j, sw_j,
                       strategy=JSpecEE(threshold=0.4)).new_session()
    want = _drain(s, s.prefill(jnp.asarray(prompts), max_new_tokens=10))
    assert sum(sum(e) for _, e, _ in want[1]) > 0, "no row exited early"
    for cache in ("dense", "paged"):
        s = Engine.create(m_t, params_t, sw_t,
                          strategy=SpecEEStrategy(threshold=0.4)) \
            .new_session(cache=cache)
        got = _drain(s, s.prefill(prompts, max_new_tokens=10))
        assert got == want, cache


def test_paged_serving_matches_jax(bundle):
    """``ServingEngine`` on the paged hybrid cache (whole-prompt admission:
    the hybrid has no chunked prefill), SpecEE, three ragged prompts over
    two slots, one longer than the window: every request's tokens and
    exit points equal JAX's engine's."""
    m_j, params_j, sw_j, m_t, params_t, sw_t = bundle
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 512, int(n)) for n in (5, 70, 9)]
    outs = []
    for cls, m, params, sw in ((JServingEngine, m_j, params_j, sw_j),
                               (ServingEngine, m_t, params_t, sw_t)):
        se = cls(m, params, sw, strategy="specee", cache="paged")
        reqs = [se.submit(p, max_new_tokens=5) for p in prompts]
        se.run_to_completion()
        outs.append([(list(r.output), list(r.exit_points)) for r in reqs])
    assert outs[0] == outs[1]


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


def test_train_loss_grads_and_loop_match_jax(bundle):
    """``train_loss`` and every gradient (lam, the gates, the conv) equal
    ``jax.value_and_grad`` of JAX's; one ``TrainLoop`` step gives JAX's
    loss and parameters."""
    m_j, params_j, _, m_t, params_t, _ = bundle
    tokens = np.random.default_rng(6).integers(0, 512, (2, 16)).astype(
        np.int32)
    (loss_j, _), g_j = jax.jit(jax.value_and_grad(
        m_j.train_loss, has_aux=True))(params_j,
                                       {"tokens": jnp.asarray(tokens)})
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params_t)]
    loss_t, _ = m_t.train_loss(tree_unflatten(params_t, leaves),
                               {"tokens": torch.from_numpy(tokens)})
    grads = tree_unflatten(params_t, torch.autograd.grad(loss_t, leaves))
    assert float(loss_t.detach()) == pytest.approx(float(loss_j), rel=1e-5)
    n_rec = 0
    for path, a, b in _pairs(grads, g_j):
        np.testing.assert_allclose(a, b, err_msg=path, **TOL)
        n_rec += "/rec/" in path
    assert n_rec == 2 * 10        # both segments' ten RG-LRU leaves
    run_j, run_t = _runs()
    loop_j = JTrainLoop(m_j, run_j, params_j)
    loop_t = TrainLoop(m_t, run_t, tree_map(torch.clone, params_t))
    assert loop_t.run_steps(1)["loss"] == pytest.approx(
        loop_j.run_steps(1)["loss"], rel=1e-4)
    for path, a, b in _pairs(loop_t.params, loop_j.params):
        np.testing.assert_allclose(a, b, atol=run_t.train.learning_rate,
                                   err_msg=path)


def test_hybrid_rules_match_jax(bundle):
    """JAX's rules for the hybrid: the published pattern's segments (12
    three-block units, then two RG-LRU units), no tree strategy and no
    chunked admission; the cache entries: h fp32 (B, W), conv (B, K-1, W)
    in the compute dtype."""
    m_j, _, _, m_t, params_t, sw_t = bundle
    blocks = get_config(NAME).model.blocks()
    assert blocks == jax_get_config(NAME).model.blocks()
    assert segments_of(blocks) == j_segments_of(blocks) == [
        (("rglru", "rglru", "local_attention"), 12), (("rglru",), 2)]
    assert m_t.segments == m_j.segments and not m_t.supports_tree()
    assert not m_t.supports_chunked_prefill()
    assert m_t.supports_chunked_prefill() == m_j.supports_chunked_prefill()
    with pytest.raises(ValueError, match="pure-attention"):
        Engine.create(m_t, params_t, sw_t, strategy=TreeStrategy())
    bf16 = build_model(dataclasses.replace(m_t.run, model=dataclasses.replace(
        m_t.cfg, dtype="bfloat16")))
    entry = bf16.empty_cache(3, 16, "cpu")["segments"][0]["u0"]
    assert entry["h"].shape == (2, 3, 128)
    assert entry["h"].dtype == torch.float32
    assert entry["conv"].shape == (2, 3, 3, 128)
    assert entry["conv"].dtype == torch.bfloat16
    assert get_config(NAME).model.param_count() == \
        jax_get_config(NAME).model.param_count()
