"""The frontend configs of the port against the JAX package (CPU, fp32,
the ``.smoke()`` of internvl2-26b (8 image patches of 1024 projected and
prepended to the text) and hubert-xlarge (an encoder over projected audio
frames, bidirectional attention without RoPE)): the frontend layers, the
pipeline's batches and specs, prefill and decode, a dense session over
patches, ``train_loss`` and its gradients, and a ``TrainLoop`` step.

Tolerance: tokens exact; batches bit-equal; logits and gradients
atol = rtol = 1e-5 (fp32, another summation order)."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import Engine as JEngine  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.data import DataPipeline as JPipeline  # noqa: E402
from repro.data.pipeline import make_batch_specs as j_specs  # noqa: E402
from repro.models import frontends as jfe  # noqa: E402
from repro.models.common import KeyGen  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.train import TrainLoop as JTrainLoop  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.api import Engine, SpecEEStrategy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataPipeline  # noqa: E402
from repro_torch.data.pipeline import make_batch_specs  # noqa: E402
from repro_torch.models import frontends  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.models.common import tree_unflatten  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.train import TrainLoop  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
FRONTENDS = ["internvl2-26b", "hubert-xlarge"]


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _to_torch(tree):
    return bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                                    "cpu", torch.float32)


@functools.lru_cache(maxsize=None)
def _bundle(name):
    m_j = jbuild(jax_get_config(name).smoke())
    params_j = m_j.init(jax.random.PRNGKey(0))
    return name, m_j, params_j, build_model(get_config(name).smoke()), \
        _to_torch(params_j)


@pytest.fixture(scope="module", params=FRONTENDS)
def bundle(request):
    return _bundle(request.param)


@pytest.fixture(scope="module")
def vlm():
    return _bundle("internvl2-26b")


@pytest.fixture(scope="module")
def audio():
    return _bundle("hubert-xlarge")


def _batch(name, B=2, S=12, seed=0):
    return JPipeline(jax_get_config(name).smoke().model, B, S,
                     seed=seed).next()


@pytest.mark.parametrize("name", FRONTENDS)
def test_frontend_layer_and_init_match_jax(name):
    """``init_frontend``'s keys and shapes and ``apply_frontend`` against
    JAX's; the feature width (1024 for patches, d_model for frames)."""
    cfg_j = jax_get_config(name).smoke().model
    cfg_t = get_config(name).smoke().model
    p_j = jfe.init_frontend(cfg_j, KeyGen(jax.random.PRNGKey(2)))
    p_j = jax.tree_util.tree_map(lambda a: a + jnp.float32(0.05), p_j)
    p_t = _to_torch(p_j)
    init = frontends.init_frontend(cfg_t, torch.Generator().manual_seed(0),
                                   torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in init["proj"].items()} == \
        {k: tuple(v.shape) for k, v in p_j["proj"].items()}
    width = frontends.frontend_feature_dim(cfg_t)
    assert width == jfe.frontend_feature_dim(cfg_j)
    feats = np.random.default_rng(1).standard_normal((2, 5, width)).astype(
        np.float32)
    np.testing.assert_allclose(
        _np(frontends.apply_frontend(cfg_t, p_t, torch.from_numpy(feats),
                                     torch.float32)),
        _np(jfe.apply_frontend(cfg_j, p_j, jnp.asarray(feats), jnp.float32)),
        **TOL)
    assert frontends.init_frontend(get_config("llama2-7b").smoke().model,
                                   None, torch.float32, "cpu") is None


@pytest.mark.parametrize("name", FRONTENDS)
def test_pipeline_batches_and_specs_bit_equal(name):
    """The synthetic pipeline's frontend batches (patches and tokens;
    frames, unit targets and the mask) are bit-equal to JAX's for two
    seeds and four steps, and ``make_batch_specs`` equals JAX's."""
    cfg_t = get_config(name).smoke().model
    cfg_j = jax_get_config(name).smoke().model
    for seed in (0, 9):
        pt, pj = DataPipeline(cfg_t, 3, 20, seed=seed), JPipeline(
            cfg_j, 3, 20, seed=seed)
        for _ in range(4):
            a, b = pt.next(), pj.next()
            assert list(a) == list(b)
            for key in a:
                assert a[key].dtype == b[key].dtype, key
                np.testing.assert_array_equal(a[key], b[key])
    assert make_batch_specs(cfg_t, 3, 20) == j_specs(cfg_j, 3, 20)


def test_vlm_prefill_and_decode_match_jax(vlm):
    """internvl2: prefill over 8 patches + 12 tokens (the cache holds 20
    positions) and 4 decode steps against JAX's logits; the patches move
    the text's positions."""
    name, m_j, params_j, m_t, params_t = vlm
    batch = _batch(name)
    logits_j, cache_j, ex_j = m_j.prefill(
        params_j, {k: jnp.asarray(v) for k, v in batch.items()}, max_seq=30)
    with torch.no_grad():
        logits_t, cache_t, ex_t = m_t.prefill(
            params_t, {k: torch.as_tensor(v) for k, v in batch.items()},
            max_seq=30)
    assert tuple(ex_t["h_final"].shape) == (2, 20, 128)
    assert cache_t["len"].tolist() == [20, 20]
    np.testing.assert_allclose(_np(logits_t), _np(logits_j), **TOL)
    tok = np.argmax(np.asarray(logits_j), -1).astype(np.int32)
    for _ in range(4):
        logits_j, cache_j = m_j.decode_step(params_j, jnp.asarray(tok),
                                            cache_j)
        with torch.no_grad():
            logits_t, cache_t = m_t.decode_step(params_t,
                                                torch.as_tensor(tok), cache_t)
        np.testing.assert_allclose(_np(logits_t), _np(logits_j), **TOL)
        tok = np.argmax(np.asarray(logits_j), -1).astype(np.int32)


def test_vlm_dense_session_matches_jax(vlm):
    """A dense session over a batch dict with patches, sized explicitly
    for them (JAX sizes ``max_seq`` from the text alone): every token
    equals JAX's session's. SpecEE over prepended patches is refused (its
    draft pairs each token with the hidden at its position; the JAX
    session fails there too)."""
    name, m_j, params_j, m_t, params_t = vlm
    batch = _batch(name, S=7, seed=3)
    max_seq = 8 + 7 + 6 + 2
    outs = []
    for eng, m, params, b in (
            (JEngine, m_j, params_j,
             {k: jnp.asarray(v) for k, v in batch.items()}),
            (Engine, m_t, params_t, batch)):
        s = eng.create(m, params, None, strategy="dense").new_session()
        first = s.prefill(b, max_new_tokens=6, max_seq=max_seq)
        toks = [first.row_tokens(r) for r in range(2)]
        while not s.all_done():
            res = s.step()
            for r in range(2):
                toks[r].extend(res.row_tokens(r))
        outs.append(toks)
    assert outs[0] == outs[1] and len(outs[1][0]) == 6
    sw_j = jeng.init_specee(m_j, jax.random.PRNGKey(1))
    sw_np = jax.tree_util.tree_map(np.asarray, sw_j)
    sw_t = bridge.specee_from_numpy(sw_np.draft, sw_np.predictors,
                                    sw_np.offline_mask, "cpu", torch.float32)
    s = Engine.create(m_t, params_t, sw_t,
                      strategy=SpecEEStrategy()).new_session()
    with pytest.raises(ValueError, match="patches"):
        s.prefill(batch, max_new_tokens=4, max_seq=max_seq)


def test_encoder_prefill_matches_jax(audio):
    """hubert: prefill returns every frame's logits (B, S, V) and no cache,
    equal to JAX's; attention is bidirectional (a late frame changes an
    early frame's logits) and position-free."""
    name, m_j, params_j, m_t, params_t = audio
    batch = _batch(name, S=16)
    frames = batch["frames"]
    logits_j, cache_j, _ = m_j.prefill(params_j,
                                       {"frames": jnp.asarray(frames)})
    with torch.no_grad():
        logits_t, cache_t, _ = m_t.prefill(
            params_t, {"frames": torch.from_numpy(frames)})
        assert cache_t is None and cache_j is None
        assert tuple(logits_t.shape) == (2, 16, 512)
        np.testing.assert_allclose(_np(logits_t), _np(logits_j), **TOL)
        late = frames.copy()
        late[:, -1] += 1.0
        moved, _, _ = m_t.prefill(params_t,
                                  {"frames": torch.from_numpy(late)})
    assert float((moved[:, 0] - logits_t[:, 0]).abs().max()) > 1e-4
    assert not m_t.supports_chunked_prefill()


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


def test_train_loss_and_grads_match_jax(bundle):
    """``train_loss``: the VLM's next-token CE on the text region after the
    patches, the encoder's masked frame-unit CE; the loss and every
    gradient (the frontend projection's among them; zero for the encoder's
    unread token embedding, as ``jax.grad`` gives) equal JAX's."""
    name, m_j, params_j, m_t, params_t = bundle
    batch = _batch(name, S=16, seed=5)
    (loss_j, aux_j), g_j = jax.jit(jax.value_and_grad(
        m_j.train_loss, has_aux=True))(
            params_j, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params_t)]
    loss_t, aux_t = m_t.train_loss(
        tree_unflatten(params_t, leaves),
        {k: torch.as_tensor(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss_t, leaves, allow_unused=True)
    grads = tree_unflatten(params_t, [
        torch.zeros_like(x) if g is None else g
        for x, g in zip(leaves, grads)])
    assert float(loss_t.detach()) == pytest.approx(float(loss_j), rel=1e-5)
    assert float(aux_t["ce"].detach()) == pytest.approx(float(aux_j["ce"]),
                                                        rel=1e-5)
    seen = set()
    for path, a, b in _pairs(grads, g_j):
        np.testing.assert_allclose(a, b, err_msg=path, **TOL)
        seen.add(path.split("/")[1])
    assert "frontend" in seen


def test_train_loop_step_matches_jax(bundle):
    """One ``TrainLoop`` step on the pipeline's frontend batches (the smoke
    train config: 4 rows of 32): the loss and every updated parameter
    equal JAX's loop's."""
    name, m_j, params_j, m_t, params_t = bundle
    run_j, run_t = jax_get_config(name).smoke(), get_config(name).smoke()
    loop_j = JTrainLoop(m_j, run_j, params_j)
    loop_t = TrainLoop(m_t, run_t, tree_map(torch.clone, params_t))
    assert loop_t.run_steps(1)["loss"] == pytest.approx(
        loop_j.run_steps(1)["loss"], rel=1e-4)
    for path, a, b in _pairs(loop_t.params, loop_j.params):
        np.testing.assert_allclose(a, b, atol=run_t.train.learning_rate,
                                   err_msg=path)
