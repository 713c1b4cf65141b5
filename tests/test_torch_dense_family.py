"""The dense-family configs of the port against the JAX package (CPU,
fp32, each config's ``.smoke()``): layernorm with bias, GELU, the plain
MLP, biases on every linear, GQA and tied embeddings, through AR SpecEE
and tree sessions on bridged weights; the layer functions alone; int8
weights keeping starcoder2's biases; the decode attention's plain version
at 12 query heads per KV head; the registry's ``ARCHS``.

Tolerance: tokens, exit points, exits and units_run exact; logits and
gradients atol = rtol = 1e-5 (fp32, different summation order)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import Engine as JEngine  # noqa: E402
from repro.api import SpecEEStrategy as JSpecEE  # noqa: E402
from repro.api import TreeStrategy as JTree  # noqa: E402
from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core.tree import TreeSpec as JTreeSpec  # noqa: E402
from repro.kernels.decode_attention import ref as jda_ref  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.api import Engine, SpecEEStrategy, TreeStrategy  # noqa
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.core.tree import TreeSpec  # noqa: E402
from repro_torch.kernels.decode_attention import ref as tda_ref  # noqa
from repro_torch.models import common  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_unflatten  # noqa
from repro_torch.models.model import build_model  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small ops: one intra-op thread, so parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(atol=1e-5, rtol=1e-5)
DENSE_FAMILY = ["llama2-13b", "llama2-70b", "deepseek-7b", "minicpm-2b",
                "starcoder2-15b", "command-r-plus-104b"]
# JAX's archs the port does not register: none, since the MoE, RG-LRU and
# frontend families came (tests/test_torch_moe.py, test_torch_rglru.py,
# test_torch_frontends.py)
NOT_PORTED: set = set()


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bundle(name):
    run_j = jax_get_config(name).smoke()
    m_j = jbuild(run_j)
    params_j = m_j.init(jax.random.PRNGKey(0))
    sw_j = jeng.init_specee(m_j, jax.random.PRNGKey(1))
    params_t = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params_j), "cpu", torch.float32)
    sw_np = jax.tree_util.tree_map(np.asarray, sw_j)
    sw_t = bridge.specee_from_numpy(sw_np.draft, sw_np.predictors,
                                    sw_np.offline_mask, "cpu", torch.float32)
    m_t = build_model(get_config(name).smoke())
    return m_j, params_j, sw_j, m_t, params_t, sw_t


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


@pytest.mark.parametrize("name", DENSE_FAMILY)
def test_smoke_config_sessions_match_jax(name):
    """Prefill logits, then AR SpecEE (threshold 0.4: the random
    predictors exit) and tree (TreeSpec(2, 3), dense cache) sessions
    through ``Engine``: every token, exit point, exit, accept length and
    units_run equals JAX's."""
    m_j, params_j, sw_j, m_t, params_t, sw_t = _bundle(name)
    cfg = m_t.cfg
    want_cfg = jax_get_config(name).smoke().model
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(want_cfg, f.name), f.name
    prompts = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 9))
    logits_j, _, _ = m_j.prefill(params_j, {"tokens": jnp.asarray(prompts)},
                                 max_seq=32)
    logits_t, _, _ = m_t.prefill(params_t, {"tokens": torch.as_tensor(
        prompts)}, max_seq=32)
    np.testing.assert_allclose(_np(logits_t), _np(logits_j), **TOL)
    for strat_j, strat_t, new in (
            (JSpecEE(threshold=0.4), SpecEEStrategy(threshold=0.4), 5),
            (JTree(tree=JTreeSpec(2, 3), threshold=0.4),
             TreeStrategy(tree=TreeSpec(2, 3), threshold=0.4), 7)):
        s = JEngine.create(m_j, params_j, sw_j,
                           strategy=strat_j).new_session()
        want = _drain(s, s.prefill(jnp.asarray(prompts), max_new_tokens=new))
        s = Engine.create(m_t, params_t, sw_t,
                          strategy=strat_t).new_session()
        got = _drain(s, s.prefill(prompts, max_new_tokens=new))
        assert got == want, strat_t.name


def test_layers_match_jax():
    """Layernorm (fp32, eps 1e-6, with bias), rmsnorm, each activation
    (JAX's gelu is the tanh approximation) and the gated and plain MLP."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    for norm in ("layernorm", "rmsnorm"):
        cfg_j = dataclasses.replace(
            jax_get_config("starcoder2-15b").smoke().model, norm=norm)
        cfg_t = dataclasses.replace(
            get_config("starcoder2-15b").smoke().model, norm=norm)
        p = {"scale": scale, "bias": bias}
        want = jcommon.apply_norm(cfg_j, {k: jnp.asarray(v)
                                          for k, v in p.items()},
                                  jnp.asarray(x))
        got = common.apply_norm(cfg_t, {k: torch.from_numpy(v)
                                        for k, v in p.items()},
                                torch.from_numpy(x))
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
        init = common.init_norm(cfg_t, 64, torch.float32, "cpu")
        assert set(init) == set(jcommon.init_norm(cfg_j, 64))
    for name in ("silu", "gelu", "relu"):
        np.testing.assert_allclose(
            _np(common.activation_fn(name)(torch.from_numpy(x))),
            _np(jcommon.activation_fn(name)(jnp.asarray(x))), **TOL)
    for gated, act in ((False, "gelu"), (True, "silu"), (False, "relu")):
        cfg_j = dataclasses.replace(
            jax_get_config("starcoder2-15b").smoke().model, gated_mlp=gated,
            activation=act, d_model=64, d_ff=96)
        cfg_t = dataclasses.replace(
            get_config("starcoder2-15b").smoke().model, gated_mlp=gated,
            activation=act, d_model=64, d_ff=96)
        p_j = jcommon.init_mlp(cfg_j, jcommon.KeyGen(jax.random.PRNGKey(3)))
        p_j = jax.tree_util.tree_map(
            lambda a: a + jnp.float32(0.1), p_j)      # nonzero biases
        p_t = bridge.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, p_j), "cpu", torch.float32)
        assert ("wg" in p_t) == gated and "b" in p_t["wi"]
        np.testing.assert_allclose(
            _np(common.apply_mlp(cfg_t, p_t, torch.from_numpy(x))),
            _np(jcommon.apply_mlp(cfg_j, p_j, jnp.asarray(x))), **TOL)


def test_starcoder2_train_loss_and_bias_grads_match_jax():
    """The training path (``Model.forward_hidden``) carries every linear
    ``b`` and norm ``bias``: loss and every gradient, biases included,
    equal JAX's ``value_and_grad`` on starcoder2's smoke config with
    nonzero biases."""
    run_j = jax_get_config("starcoder2-15b").smoke()
    m_j = jbuild(run_j)
    params_j = jax.tree_util.tree_map(
        lambda a: a + jnp.float32(0.01), m_j.init(jax.random.PRNGKey(1)))
    tokens = np.random.default_rng(5).integers(0, 512, (2, 16)).astype(
        np.int32)
    (loss_j, _), g_j = jax.value_and_grad(m_j.train_loss, has_aux=True)(
        params_j, {"tokens": jnp.asarray(tokens)})
    model = build_model(get_config("starcoder2-15b").smoke())
    params = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params_j), "cpu", torch.float32)
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    loss, _ = model.train_loss(tree_unflatten(params, leaves),
                               {"tokens": torch.from_numpy(tokens)})
    grads = tree_unflatten(params, torch.autograd.grad(loss, leaves))
    assert float(loss.detach()) == pytest.approx(float(loss_j), rel=1e-5)
    flat_j = dict(jax.tree_util.tree_leaves_with_path(g_j))
    seen = 0
    for path_j, g in flat_j.items():
        node = grads
        for key in path_j:
            node = node[getattr(key, "key", getattr(key, "idx", None))]
        np.testing.assert_allclose(_np(node.detach()), np.asarray(g),
                                   err_msg=jax.tree_util.keystr(path_j),
                                   **TOL)
        seen += "bias" in str(path_j) or "'b'" in str(path_j)
    # the stacked unit's 2 norm biases and 6 linear b, the final norm's
    assert seen == 9


def test_starcoder2_int8_keeps_biases_and_matches_jax():
    """``quant="int8"`` quantizes the linear ``w`` leaves only: the decode
    view keeps every bias as it was, and the quantized SpecEE session
    emits JAX's quantized engine's tokens and exits."""
    m_j, params_j, sw_j, m_t, params_t, sw_t = _bundle("starcoder2-15b")
    eng_t = Engine.create(m_t, params_t, sw_t,
                          strategy=SpecEEStrategy(threshold=0.4),
                          quant="int8")
    view, _, _ = eng_t.decode_weights()
    pairs = list(zip(tree_leaves(params_t["segments"]),
                     tree_leaves(view["segments"])))
    n_vec = 0
    for a, b in pairs:
        if a.ndim == 2:          # stacked (reps, d) biases and norm params
            n_vec += 1
            assert torch.equal(a, b)
    assert n_vec == 10           # ln1/ln2 scale and bias, 6 linear b
    prompts = np.random.default_rng(8).integers(0, 512, (2, 7))
    s = JEngine.create(m_j, params_j, sw_j, strategy=JSpecEE(threshold=0.4),
                       quant="int8").new_session()
    want = _drain(s, s.prefill(jnp.asarray(prompts), max_new_tokens=5))
    s = eng_t.new_session()
    assert _drain(s, s.prefill(prompts, max_new_tokens=5)) == want


@pytest.mark.parametrize("window", [None, 7])
def test_decode_attention_plain_at_12_heads_per_kv_head(window):
    """The plain version the card's n_rep-12 instances are held to, at
    12 query heads over 1 KV head (and 48 over 4), against JAX's
    ``decode_attention_ref``; and the paged plain version against JAX's
    paged reference."""
    rng = np.random.default_rng(1)
    for H, KVH in ((12, 1), (48, 4)):
        B, S, hd = 3, 40, 32
        q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
        k = rng.standard_normal((B, S, KVH, hd)).astype(np.float32)
        v = rng.standard_normal((B, S, KVH, hd)).astype(np.float32)
        clen = np.array([1, 17, 40], np.int32)
        want = jda_ref.decode_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v), clen, window)
        got = tda_ref.decode_attention_ref(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(clen), window)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
        ps, P = 8, 5
        table = rng.permutation(B * P).reshape(B, P).astype(np.int32)
        kp = rng.standard_normal((B * P, ps, KVH, hd)).astype(np.float32)
        vp = rng.standard_normal((B * P, ps, KVH, hd)).astype(np.float32)
        want = jda_ref.paged_decode_attention_ref(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(table), clen, window)
        got = tda_ref.paged_decode_attention_ref(
            torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
            torch.from_numpy(table), torch.from_numpy(clen), window)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_archs_match_jax_less_the_unported():
    """The port registers every one of JAX's archs, in JAX's order; each
    resolves to its JAX config's fields (the MoE and RG-LRU sub-configs,
    the frontend and its tokens among them) and its train config."""
    assert ARCHS == list(J_ARCHS)
    assert ARCHS == [a for a in J_ARCHS if a not in NOT_PORTED]
    assert set(J_ARCHS) - set(ARCHS) == NOT_PORTED
    def plain(x):
        return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x

    for name in ARCHS:
        got, want = get_config(name), jax_get_config(name)
        for f in dataclasses.fields(got.model):
            assert plain(getattr(got.model, f.name)) == plain(
                getattr(want.model, f.name)), (name, f.name)
        assert got.train == dataclasses.replace(
            got.train, **{f.name: getattr(want.train, f.name)
                          for f in dataclasses.fields(got.train)})
