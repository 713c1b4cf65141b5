"""PyTorch port vs the JAX package: configs, ``models/common.py``,
``models/attention.py`` and ``models/model.py`` on the llama2-7b smoke
config (D=128, 4 layers, fp32, CPU). Inputs come from a numpy seed; JAX
weights reach the port through ``repro_torch.bridge``.

Tolerance: fp32 values that the two frameworks sum in different orders
agree to atol = rtol = 1e-5 (1e-4 after a whole layer stack)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import config as tcfg  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
STACK_TOL = dict(atol=1e-4, rtol=1e-4)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **tol)


@pytest.fixture(scope="module")
def smoke():
    run_j = jax_get_config("llama2-7b").smoke()
    run_t = get_config("llama2-7b").smoke()
    m_j = jmodel.build_model(run_j)
    params_j = m_j.init(jax.random.PRNGKey(0))
    params_t = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params_j), "cpu", torch.float32)
    return run_j, run_t, m_j, params_j, params_t


@pytest.mark.parametrize("name", ["llama2-7b", "mamba2-130m"])
@pytest.mark.parametrize("full", [True, False])
def test_config_matches_jax(full, name):
    """The port's own config copy equals the JAX one, field for field (the
    SSM sub-config too, with its derived widths)."""
    j, t = jax_get_config(name), get_config(name)
    if not full:
        j, t = j.smoke(), t.smoke()
    for f in dataclasses.fields(tcfg.ModelConfig):
        a, b = getattr(t.model, f.name), getattr(j.model, f.name)
        if f.name == "ssm" and a is not None:
            assert b is not None
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
            d = t.model.d_model
            assert (a.d_inner(d), a.n_heads(d)) == (b.d_inner(d),
                                                    b.n_heads(d))
        else:
            assert a == b, f.name
    assert t.model.resolved_head_dim() == j.model.resolved_head_dim()
    assert t.model.blocks() == j.model.blocks()
    for f in dataclasses.fields(tcfg.SpecEEConfig):
        assert getattr(t.specee, f.name) == getattr(j.specee, f.name), f.name
    assert t.specee.feature_dim() == j.specee.feature_dim()
    for f in dataclasses.fields(tcfg.ServeConfig):
        assert getattr(t.serve, f.name) == getattr(j.serve, f.name), f.name
    assert t.model.is_decoder() == j.model.is_decoder()


@pytest.mark.parametrize("pattern", [
    ("attention",) * 4,
    ("attention", "local_attention") * 3,
    ("attention",) * 3 + ("local_attention",) * 2,
])
def test_segments_of(pattern):
    assert tmodel.segments_of(pattern) == jmodel.segments_of(pattern)


def test_common_layers(smoke):
    run_j, run_t, _, params_j, params_t = smoke
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 128)).astype(np.float32)
    up_j = jax.tree_util.tree_map(lambda a: a[1], params_j["segments"][0])
    up_t = tcommon.index_tree(params_t["segments"][0], 1)
    _close(tcommon.apply_norm(run_t.model, up_t["u0"]["ln1"], _t(x)),
           jcommon.apply_norm(run_j.model, up_j["u0"]["ln1"], x))
    _close(tcommon.apply_mlp(run_t.model, up_t["u0"]["mlp"], _t(x)),
           jcommon.apply_mlp(run_j.model, up_j["u0"]["mlp"], x))
    _close(tcommon.apply_linear(up_t["u0"]["attn"]["wq"], _t(x)),
           jcommon.apply_linear(up_j["u0"]["attn"]["wq"], x))
    q = rng.standard_normal((2, 5, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 5)).astype(np.int32)
    _close(tcommon.apply_rope(_t(q), _t(pos), 10000.0),
           jcommon.apply_rope(q, pos, 10000.0), dict(atol=1e-4, rtol=1e-5))
    toks = rng.integers(0, 512, (2, 3)).astype(np.int32)
    _close(tcommon.embed_tokens(params_t["embed"], _t(toks), torch.float32),
           jcommon.embed_tokens(params_j["embed"], toks, jnp.float32))
    _close(tcommon.lm_head_weight(params_t),
           jcommon.lm_head_weight(params_j))


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_attention_functions(kv_heads):
    run_j = jax_get_config("llama2-7b").smoke()
    cfg_j = dataclasses.replace(run_j.model, num_kv_heads=kv_heads)
    cfg_t = dataclasses.replace(get_config("llama2-7b").smoke().model,
                                num_kv_heads=kv_heads)
    p_j = jattn.init_attention(cfg_j, jcommon.KeyGen(jax.random.PRNGKey(3)))
    p_t = bridge.to_torch(jax.tree_util.tree_map(np.asarray, p_j), "cpu")
    rng = np.random.default_rng(1)
    B, S = 3, 9
    x = rng.standard_normal((B, S, 128)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    q_j, k_j, v_j = jattn.qkv(cfg_j, p_j, x, pos)
    q_t, k_t, v_t = tattn.qkv(cfg_t, p_t, _t(x), _t(pos))
    for a, b in ((q_t, q_j), (k_t, k_j), (v_t, v_j)):
        _close(a, b)
    for a, b in zip(tattn.kv_only(cfg_t, p_t, _t(x), _t(pos)),
                    jattn.kv_only(cfg_j, p_j, x, pos)):
        _close(a, b)
    n_rep = 4 // kv_heads
    _close(tattn._repeat_kv(k_t, n_rep), jattn._repeat_kv(k_j, n_rep))
    for window in (None, 4):
        np.testing.assert_array_equal(
            tattn.causal_mask(S, S + 2, 2, window).numpy(),
            np.asarray(jattn.causal_mask(S, S + 2, 2, window)))
        _close(tattn.attend_full(cfg_t, q_t, k_t, v_t, window),
               jattn.attend_full(cfg_j, q_j, k_j, v_j, window))
        clen = np.array([9, 4, 1], np.int32)           # ragged live prefix
        _close(tattn.attend_decode(cfg_t, q_t[:, :1], k_t, v_t, _t(clen),
                                   window),
               jattn.attend_decode(cfg_j, q_j[:, :1], k_j, v_j, clen,
                                   window))
    mask = rng.random((B, 1, S, S)) > 0.3
    mask[..., 0] = True
    kk_j, vv_j = jattn._repeat_kv(k_j, n_rep), jattn._repeat_kv(v_j, n_rep)
    _close(tattn.sdpa(q_t, _t(np.asarray(kk_j)), _t(np.asarray(vv_j)),
                      _t(mask)),
           jattn.sdpa(q_j, kk_j, vv_j, mask))
    o = rng.standard_normal((B, S, 4, 32)).astype(np.float32)
    _close(tattn.out_proj(p_t, _t(o)), jattn.out_proj(p_j, o))


@pytest.mark.parametrize("decode_kernel", [False, True])
def test_prefill_units_and_decode(smoke, decode_kernel):
    """Model.prefill, run_unit, propagate_unit and decode_step_hidden: the
    port (plain decode attention, or the kernel's plain version on CPU)
    against the JAX model (reference path, or the Pallas decode kernel in
    interpret mode)."""
    run_j, run_t, _, params_j, params_t = smoke
    flags_j = jmodel.ModelFlags(decode_kernel=decode_kernel)
    flags_t = tmodel.ModelFlags(decode_kernel=decode_kernel)
    m_j = jmodel.build_model(run_j, flags_j)
    m_t = tmodel.build_model(run_t, flags_t)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 512, (2, 7)).astype(np.int32)
    lj, cj, xj = m_j.prefill(params_j, {"tokens": jnp.asarray(toks)},
                             max_seq=12)
    lt, ct, xt = m_t.prefill(params_t, {"tokens": _t(toks)}, max_seq=12)
    _close(lt, lj, STACK_TOL)
    _close(xt["h_final"], xj["h_final"], STACK_TOL)
    _close(ct["segments"][0]["u0"]["k"], cj["segments"][0]["u0"]["k"],
           STACK_TOL)
    np.testing.assert_array_equal(ct["len"].numpy(), np.asarray(cj["len"]))

    h = rng.standard_normal((2, 128)).astype(np.float32)
    hj, sj = m_j.run_unit(params_j, 0, jnp.int32(1), jnp.asarray(h),
                          cj["segments"][0], cj["len"])
    ht, st = m_t.run_unit(params_t, 0, 1, _t(h), ct["segments"][0],
                          ct["len"])
    _close(ht, hj, STACK_TOL)
    _close(st["u0"]["v"], sj["u0"]["v"], STACK_TOL)
    sj = m_j.propagate_unit(params_j, 0, jnp.int32(2), jnp.asarray(h), sj,
                            cj["len"])
    st = m_t.propagate_unit(params_t, 0, 2, _t(h), st, ct["len"])
    _close(st["u0"]["k"], sj["u0"]["k"], STACK_TOL)

    tok = rng.integers(0, 512, (2,)).astype(np.int32)
    _, cj2, _ = m_j.prefill(params_j, {"tokens": jnp.asarray(toks)},
                            max_seq=12)
    _, ct2, _ = m_t.prefill(params_t, {"tokens": _t(toks)}, max_seq=12)
    hj, cj2 = m_j.decode_step_hidden(params_j, jnp.asarray(tok), cj2)
    ht, ct2 = m_t.decode_step_hidden(params_t, _t(tok), ct2)
    _close(ht, hj, STACK_TOL)
    _close(ct2["segments"][0]["u0"]["k"], cj2["segments"][0]["u0"]["k"],
           STACK_TOL)
    np.testing.assert_array_equal(ct2["len"].numpy(), np.asarray(cj2["len"]))
    _close(m_t.logits(params_t, ht), m_j.logits(params_j, hj), STACK_TOL)


def test_empty_cache_and_seeded_init(smoke):
    run_j, run_t, m_j, params_j, _ = smoke
    m_t = tmodel.build_model(run_t)
    cj = m_j.empty_cache(3, 10)
    ct = m_t.empty_cache(3, 10, "cpu")
    assert ct["segments"][0]["u0"]["k"].shape == \
        cj["segments"][0]["u0"]["k"].shape
    assert not ct["segments"][0]["u0"]["k"].any()
    p_t = m_t.init(0, "cpu")
    shapes_j = jax.tree_util.tree_map(lambda a: a.shape, params_j)
    shapes_t = tcommon.tree_map(lambda a: tuple(a.shape), p_t)
    assert shapes_t == shapes_j
    again = m_t.init(0, "cpu")
    assert torch.equal(p_t["lm_head"]["w"], again["lm_head"]["w"])
