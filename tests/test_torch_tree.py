"""The port's T3 tree path against the JAX package on the llama2-7b smoke
config (fp32, CPU): ``TreeSpec``, the hyper-token feature merge, feature
extraction, the read-only draft expansion, ``tree_decode_step`` through
``Engine`` sessions on dense and paged caches, oracle acceptance,
``TreeStrategy`` sessions and tree-mode ``ServingEngine``.

The JAX side runs jitted through its own ``Engine`` sessions (one compile
per cell); with ``spec_head_kernel`` / ``exit_gate_kernel`` on it runs its
Pallas kernels in interpret mode, and the port the kernels' plain versions.
Tolerance: tokens and integer fields (counts, accept lengths, exit points,
exits, units_run) exact; features atol = rtol = 1e-5 (fp32, different
summation order); hidden states through a draft layer atol = rtol = 1e-4."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import Engine as JEngine  # noqa: E402
from repro.api import TreeStrategy as JTree  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import draft as jdraft  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core import features as jfeat  # noqa: E402
from repro.core.tree import TreeSpec as JTreeSpec  # noqa: E402
from repro.models.model import ModelFlags as JFlags  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.serving.server import ServingEngine as JServingEngine  # noqa
from repro_torch import bridge  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.api import Engine, TreeStrategy, get_strategy  # noqa
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import draft as tdraft  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import features as tfeat  # noqa: E402
from repro_torch.core.tree import TreeSpec  # noqa: E402
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


FTOL = dict(atol=1e-5, rtol=1e-5)
HTOL = dict(atol=1e-4, rtol=1e-4)
KERNEL_FLAGS = dict(spec_head_kernel=True, exit_gate_kernel=True,
                    exit_gate_impl="kernel")


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


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
    return run_j, run_t, m_j, m_t, params_j, params_t, sw_j, sw_t


# ---------------- static structure ----------------
@pytest.mark.parametrize("depth,branch", [(2, 3), (3, 3), (1, 4)])
def test_tree_spec_matches_jax(depth, branch):
    t, j = TreeSpec(depth, branch), JTreeSpec(depth, branch)
    assert t.num_nodes == j.num_nodes
    assert t.level_sizes == j.level_sizes
    assert t.level_offsets == j.level_offsets
    for name in ("levels", "parents", "ancestor_mask", "path_nodes",
                 "children"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name),
                                      err_msg=name)
    clen = np.array([5, 0, 9], np.int32)
    np.testing.assert_array_equal(_np(t.attention_mask(_t(clen), 11)),
                                  _np(j.attention_mask(clen, 11)))
    np.testing.assert_array_equal(_np(t.attention_mask(_t(4), 6)),
                                  _np(j.attention_mask(4, 6)))
    np.testing.assert_array_equal(_np(t.positions(_t(clen))),
                                  _np(j.positions(clen)))


# ---------------- features ----------------
def test_merge_path_features_matches_jax():
    rng = np.random.default_rng(0)
    B, N, k = 2, 13, 4
    feats = rng.standard_normal((B, N, 3 * k)).astype(np.float32)
    probs = rng.uniform(size=(B, N, k)).astype(np.float32)
    paths = np.array([[0, 1, 4], [0, 2, -1], [0, 3, 12]], np.int32)
    lens = np.array([3, 2, 3], np.int32)
    want = jfeat.merge_path_features(feats, probs, paths, lens)
    got = tfeat.merge_path_features(_t(feats), _t(probs), _t(paths))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_np(a), _np(b))
    tree = TreeSpec(3, 3)
    feats = rng.standard_normal((B, tree.num_nodes, 3 * k)).astype(
        np.float32)
    got, _ = tfeat.merge_path_features(_t(feats), _t(feats[..., :k]),
                                       _t(tree.path_nodes))
    assert got.shape == (B, 27, 3 * k)
    np.testing.assert_array_equal(
        _np(got[:, 5]), feats[:, tree.path_nodes[5]].min(axis=1))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_extract_features_matches_jax(use_kernel):
    """The port's plain features against JAX's with its spec-head kernel
    off and on (the port's kernel route is the tree step's two stages,
    ``node_columns`` then ``column_features``)."""
    rng = np.random.default_rng(1)
    R, D, V, k = 40, 128, 512, 4
    hn = rng.standard_normal((R, D)).astype(np.float32)
    w = (rng.standard_normal((D, V)) * 0.05).astype(np.float32)
    ids = rng.integers(0, V, (R, k)).astype(np.int32)
    ids[0] = [0, V - 1, 0, 7]                         # edge and repeated ids
    prev = rng.dirichlet(np.ones(k), R).astype(np.float32)
    want = jfeat.extract_features(hn, w, ids, prev, use_kernel=use_kernel)
    K.reset_launches()
    got = tfeat.extract_features(_t(hn), _t(w), _t(ids), _t(prev))
    assert K.LAUNCHES["spec_head"] == 0            # CPU: plain version
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(b), **FTOL)
    np.testing.assert_allclose(_np(tfeat.spec_logits_ref(
        _t(hn), _t(w), _t(ids))), _np(jfeat.spec_logits_ref(hn, w, ids)),
        **FTOL)


def test_draft_step_readonly_matches_jax(setup):
    """Node queries grouped per cache row (no per-node copy of the cache)
    give JAX's repeated-cache result, for per-row positions and lengths."""
    run_j, run_t, *_, sw_j, sw_t = setup
    rng = np.random.default_rng(2)
    B, G, S, D = 2, 9, 12, 128
    emb = rng.standard_normal((B, S, D)).astype(np.float32)
    hs = rng.standard_normal((B, S, D)).astype(np.float32)
    dc_j = jdraft.draft_prefill(run_j.model, sw_j.draft, emb, hs, S + 4)
    dc_t = tdraft.draft_prefill(run_t.model, sw_t.draft, _t(emb), _t(hs),
                                S + 4)
    e = rng.standard_normal((B * G, D)).astype(np.float32)
    hp = rng.standard_normal((B * G, D)).astype(np.float32)
    pos = np.array([12, 7], np.int32)
    want = jdraft.draft_step_readonly(run_j.model, sw_j.draft, e, hp, dc_j,
                                      pos + 2, pos + 1)
    got = tdraft.draft_step_readonly(run_t.model, sw_t.draft, _t(e), _t(hp),
                                     dc_t, _t(pos + 2), _t(pos + 1))
    np.testing.assert_allclose(_np(got), _np(want), **HTOL)


# ---------------- tree_decode_step through sessions ----------------
def _session_steps(E, model, params, sw, strategy, prompts, cache, n):
    s = E.create(model, params, sw, strategy=strategy).new_session(
        cache=cache)
    out = [s.prefill(prompts, max_new_tokens=4 * n)]
    for _ in range(n):
        out.append(s.step())
    return [(np.asarray(r.tokens).tolist(), np.asarray(r.counts).tolist(),
             np.asarray(r.accept_len).tolist(),
             np.asarray(r.exit_layer).tolist(),
             np.asarray(r.exited).tolist(), int(r.units_run)) for r in out]


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("cache", ["dense", "paged"])
@pytest.mark.parametrize("thresh", [1.5, 0.3, -0.1])
def test_tree_decode_step_matches_jax(setup, kernels, cache, thresh):
    """Three tree steps (depth 2, branch 3): emitted tokens, n_emit,
    accepted_len, exit_point, exited and units_run equal JAX's. With the
    kernel flags JAX runs its spec-head, predictor-MLP and verify Pallas
    kernels (interpret mode) and the port the wrappers' plain versions."""
    run_j, run_t, _, _, params_j, params_t, sw_j, sw_t = setup
    flags = KERNEL_FLAGS if kernels else {}
    m_j = jbuild(run_j, JFlags(**flags))
    m_t = build_model(run_t, ModelFlags(**flags))
    tree_j, tree_t = JTreeSpec(2, 3), TreeSpec(2, 3)
    prompts = np.random.default_rng(4).integers(0, 512, (2, 8))
    want = _session_steps(JEngine, m_j, params_j, sw_j,
                          JTree(tree=tree_j, threshold=thresh),
                          jnp.asarray(prompts), cache, 3)
    got = _session_steps(Engine, m_t, params_t, sw_t,
                         TreeStrategy(tree=tree_t, threshold=thresh),
                         prompts, cache, 3)
    assert got == want
    exits = sum(sum(r[4]) for r in got[1:])
    assert (exits == 0) if thresh > 1 else (exits == 6)


def _dense_ref(m, params, tokens, steps, max_seq):
    _, st = teng.init_decode_state(m, params, None, {"tokens": tokens},
                                   max_seq)
    out = [st.last_token]
    for _ in range(steps):
        tok, st, _ = teng.dense_decode_step(m, params, None, st)
        out.append(tok)
    return torch.stack(out, 1).numpy()


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_tree_oracle_acceptance(setup, cache):
    """The case of the JAX package's test: a tree whose first chain follows
    the dense continuation accepts depth tokens + bonus each step, all
    equal to dense greedy decoding (so the accepted-KV commit is right
    across steps), on dense and paged caches; every step equals JAX's
    (jitted) ``tree_decode_step`` on the same oracle."""
    run_j, run_t, m_j, m_t, params_j, params_t, sw_j, sw_t = setup
    tree, tree_j = TreeSpec(2, 3), JTreeSpec(2, 3)
    B, T = 2, 8
    tokens = np.random.default_rng(3).integers(0, 512, (B, T))
    ref = _dense_ref(m_t, params_t, _t(tokens), 12, 64 + tree.num_nodes)
    if cache == "dense":
        _, st_t = teng.init_tree_decode_state(
            m_t, params_t, sw_t, {"tokens": _t(tokens)}, 64, tree)
    else:
        s = Engine.create(m_t, params_t, sw_t,
                          strategy=TreeStrategy(tree=tree)).new_session(
                              cache=cache)
        s.prefill(tokens, max_seq=64)
        st_t = s._state
    _, st_j = jeng.init_tree_decode_state(
        m_j, params_j, sw_j, {"tokens": jnp.asarray(tokens)}, 64, tree_j)
    jstep = jax.jit(lambda st, ov: jeng.tree_decode_step(
        m_j, params_j, sw_j, st, tree_j, threshold=1.5,
        node_tokens_override=ov))
    ptr = [1, 1]
    for step in range(4):
        node_toks = np.random.default_rng(step).integers(
            0, run_t.model.vocab_size, (B, tree.num_nodes)).astype(np.int32)
        for b in range(B):
            node_toks[b, 1] = ref[b, ptr[b]]
            node_toks[b, 4] = ref[b, ptr[b] + 1]
        out, n, st_t, info = teng.tree_decode_step(
            m_t, params_t, sw_t, st_t, tree, threshold=1.5,
            node_tokens_override=_t(node_toks))
        out_j, n_j, st_j, info_j = jstep(st_j, jnp.asarray(node_toks))
        assert info.accepted_len.tolist() == [2, 2]
        np.testing.assert_array_equal(_np(out), _np(out_j))
        np.testing.assert_array_equal(_np(n), _np(n_j))
        np.testing.assert_array_equal(_np(info.accepted_len),
                                      _np(info_j.accepted_len))
        assert info.units_run == int(info_j.units_run)
        for b in range(B):
            got = out[b, :int(n[b])].tolist()
            assert got == ref[b, ptr[b]:ptr[b] + int(n[b])].tolist()
            ptr[b] += int(n[b])
    np.testing.assert_array_equal(_np(st_t.cache["len"]),
                                  _np(st_j.cache["len"]))
    np.testing.assert_allclose(_np(st_t.h_last), _np(st_j.h_last), **HTOL)


# ---------------- sessions and serving ----------------
def _drain(session, first):
    toks = [first.row_tokens(b) for b in range(first.batch)]
    while not session.all_done():
        res = session.step()
        for b in range(res.batch):
            toks[b].extend(res.row_tokens(b))
    return toks


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_session_tree_no_exit_matches_dense(setup, cache):
    """Threshold 1.5 (no exits): the tree session's stream equals dense
    greedy decoding; then EOS inside a multi-token emit truncates it and
    the budget caps it (the JAX package's session tests)."""
    run_j, run_t, m_j, m_t, params_j, params_t, sw_j, sw_t = setup
    prompts = np.random.default_rng(5).integers(0, 512, (2, 8))
    s = Engine.create(m_t, params_t, sw_t, strategy="dense").new_session()
    dense = _drain(s, s.prefill(prompts, max_new_tokens=9))
    tree = TreeStrategy(tree=TreeSpec(2, 3), threshold=1.5)
    s = Engine.create(m_t, params_t, sw_t, strategy=tree).new_session(
        cache=cache)
    assert s.engine.emit_width == 3
    got = _drain(s, s.prefill(prompts, max_new_tokens=9))
    assert got == dense and all(len(t) == 9 for t in got)
    eos = dense[0][4]
    s = Engine.create(m_t, params_t, sw_t, strategy=tree).new_session(
        cache=cache)
    cut = _drain(s, s.prefill(prompts, max_new_tokens=9, eos_token=eos))
    assert cut[0] == dense[0][:dense[0].index(eos) + 1]
    assert len(cut[1]) <= 9


def test_get_strategy_tree(setup):
    run_j, run_t, m_j, m_t, params_j, params_t, sw_j, sw_t = setup
    assert isinstance(get_strategy("tree"), TreeStrategy)
    s = TreeStrategy(threshold=0.3)
    assert get_strategy(s) is s
    e = Engine.create(m_t, params_t, sw_t, strategy="tree")
    assert e.emit_width == m_t.run.specee.tree_depth + 1
    assert e.strategy.cache_seq_len(m_t, 100) == 100 + 40
    with pytest.raises(ValueError):
        Engine.create(m_t, params_t, None, strategy="tree")
    import dataclasses
    local = dataclasses.replace(
        m_t.run, model=dataclasses.replace(
            m_t.cfg, block_pattern=("attention", "local_attention") * 2))
    with pytest.raises(ValueError, match="pure-attention stack"):
        Engine.create(build_model(local), params_t, sw_t, strategy="tree")


@pytest.mark.parametrize("cache", ["paged", "dense"])
def test_serving_tree_matches_jax(setup, cache):
    """Tree-mode ServingEngine: three requests through two slots (one slot
    is reused); per-request output, exit points and accept lengths equal
    the JAX engine's, every request gets its budget, every page returns."""
    run_j, run_t, m_j, m_t, params_j, params_t, sw_j, sw_t = setup
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, int(rng.integers(4, 10)))
               for _ in range(3)]
    outs = []
    for E, m, p, sw in ((JServingEngine, m_j, params_j, sw_j),
                        (ServingEngine, m_t, params_t, sw_t)):
        se = E(m, p, sw, strategy="tree", cache=cache)
        reqs = [se.submit(pr, max_new_tokens=7) for pr in prompts]
        se.run_to_completion()
        assert all(r.done and len(r.output) == 7 for r in reqs)
        mgr = se.session.cache_mgr
        assert mgr.free_pages == getattr(mgr, "num_pages", 0)
        outs.append([(r.output, r.exit_points, r.accept_lens)
                     for r in reqs])
    assert outs[0] == outs[1]
    assert all(len(a) == len(e) for _, e, a in outs[1])
