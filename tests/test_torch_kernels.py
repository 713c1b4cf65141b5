"""The port's kernel modules on the CPU (where every wrapper runs its plain
version) against the JAX package's Pallas kernels in interpret mode and its
``ref.py`` oracles.

Tolerances: argmax and top-k ids exact — the inputs are small integers, so
every logit is an exact fp32 integer in any summation order and ties are
real, exercising the lowest-id rule; other float outputs atol = rtol =
1e-5 (fp32, different summation order)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import SpecEEConfig as JSpecEEConfig  # noqa: E402
from repro.core import predictor as jpred  # noqa: E402
from repro.kernels.decode_attention.decode_attention import (  # noqa: E402
    decode_attention_fwd as jax_decode_attention_fwd)
from repro.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref as jax_decode_attention_ref)
from repro.kernels.exit_gate import ops as jgate  # noqa: E402
from repro.kernels.exit_gate.exit_gate import (  # noqa: E402
    argmax_verify_fused as jax_argmax, topk_verify_fused as jax_topk)
from repro.kernels.predictor_mlp import ops as jpm_ops  # noqa: E402
from repro.kernels.predictor_mlp.predictor_mlp import (  # noqa: E402
    predictor_mlp_fused as jax_predictor_mlp)
from repro.kernels.spec_head import ops as jsh_ops  # noqa: E402
from repro.kernels.spec_head.spec_head import (  # noqa: E402
    spec_head_logits as jax_spec_head_logits)
from repro_torch import bridge  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.config import SpecEEConfig  # noqa: E402
from repro_torch.core import predictor as tpred  # noqa: E402
from repro_torch.kernels.decode_attention.decode_attention import (  # noqa
    decode_attention_fwd)
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref)
from repro_torch.kernels.exit_gate import ops as tgate  # noqa: E402
from repro_torch.kernels.predictor_mlp import ops as tpm_ops  # noqa: E402
from repro_torch.kernels.predictor_mlp.predictor_mlp import (  # noqa: E402
    predictor_mlp_fused)
from repro_torch.kernels.spec_head import ops as tsh_ops  # noqa: E402
from repro_torch.kernels.spec_head.spec_head import (  # noqa: E402
    spec_head_logits)

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)


# ---------------- decode attention (Pallas row 4) ----------------
@pytest.mark.parametrize("kvh", [4, 2])
@pytest.mark.parametrize("window", [None, 3])
def test_decode_attention_matches_pallas(kvh, window):
    rng = np.random.default_rng(0)
    B, S, H, hd = 3, 16, 4, 32
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, kvh, hd)).astype(np.float32)
    clen = np.array([16, 5, 1], np.int32)               # ragged, >= 1
    want = jax_decode_attention_fwd(q, k, v, clen, window=window, block_k=4)
    got = decode_attention_fwd(_t(q), _t(k), _t(v), _t(clen), window=window)
    _close(got, want)
    _close(decode_attention_ref(_t(q), _t(k), _t(v), _t(clen), window),
           jax_decode_attention_ref(q, k, v, clen, window))


# ---------------- LM-head verify kernels (Pallas rows 2, 3) --------------
def _int_inputs(B, D, V, seed):
    """Small-integer hn and head: exact logits and many exact ties."""
    rng = np.random.default_rng(seed)
    hn = rng.integers(-2, 3, (B, D)).astype(np.float32)
    w = rng.integers(-2, 3, (D, V)).astype(np.float32)
    # duplicate the best column of row 0 at a higher and a lower id: the
    # tie must resolve to the lowest id
    best = int(np.argmax(hn[0] @ w))
    w[:, (best + 7) % V] = w[:, best]
    w[:, (best + V - 5) % V] = w[:, best]
    return hn, w


@pytest.mark.parametrize("B,D,V,seed", [(4, 128, 512, 0), (3, 96, 300, 1),
                                        (2, 64, 1000, 2)])
def test_verify_argmax_ties_match_pallas(B, D, V, seed):
    hn, w = _int_inputs(B, D, V, seed)
    logits = hn @ w
    assert (logits == logits.max(1, keepdims=True)).sum() > B  # real ties
    tok_j, mx_j = jax_argmax(hn, w, block_v=128, block_d=32)
    tok_t, mx_t = tgate.verify_argmax(_t(hn), _t(w), impl="kernel")
    np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
    np.testing.assert_array_equal(tok_t.numpy(), np.argmax(logits, 1))
    _close(mx_t, mx_j)
    ref_j = jgate.verify_argmax(hn, w, impl="ref")
    ref_t = tgate.verify_argmax(_t(hn), _t(w), impl="ref")
    np.testing.assert_array_equal(ref_t[0].numpy(), np.asarray(ref_j[0]))
    assert tok_t.dtype == torch.int32


@pytest.mark.parametrize("B,D,V,seed", [(4, 128, 512, 3), (3, 96, 300, 4),
                                        (2, 64, 1000, 5)])
@pytest.mark.parametrize("k", [4, 2])
def test_verify_topk_ties_match_pallas(B, D, V, seed, k):
    hn, w = _int_inputs(B, D, V, seed)
    ids_j, vals_j = jax_topk(hn, w, k, block_v=128, block_d=32)
    ids_t, vals_t = tgate.verify_topk(_t(hn), _t(w), k, impl="kernel")
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    _close(vals_t, vals_j)
    _, ids_lax = jax.lax.top_k(jnp.asarray(hn @ w), k)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_lax))
    ref_j = jgate.verify_topk(hn, w, k, impl="ref")
    ref_t = tgate.verify_topk(_t(hn), _t(w), k, impl="ref")
    np.testing.assert_array_equal(ref_t[0].numpy(), np.asarray(ref_j[0]))


# ---------------- exit gate (Pallas row 1) ----------------
@pytest.mark.parametrize("B,D,V,k", [(4, 128, 512, 4), (3, 96, 300, 3)])
@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_exit_gate_matches_jax(B, D, V, k, impl):
    spec_j = JSpecEEConfig(num_speculative=k)
    bank_j = jpred.init_predictors(spec_j, 5, jax.random.PRNGKey(7))
    bank_t = bridge.to_torch(jax.tree_util.tree_map(np.asarray, bank_j),
                             "cpu")
    rng = np.random.default_rng(B)
    hn = rng.standard_normal((B, D)).astype(np.float32)
    w = (rng.standard_normal((D, V)) * 0.05).astype(np.float32)
    ids = rng.integers(0, V, (B, k)).astype(np.int32)
    prev = rng.dirichlet(np.ones(k), B).astype(np.float32)
    for ep in (0, 4):
        want = jgate.exit_gate(hn, w, ids, prev, bank_j, jnp.int32(ep),
                               impl=impl)
        got = tgate.exit_gate(_t(hn), _t(w), _t(ids), _t(prev), bank_t, ep,
                              impl=impl)
        for a, b in zip(got, want):
            _close(a, b)


def test_exit_gate_kernel_rejects_other_predictor_depths():
    """The fused gate holds a 2-layer predictor. A bank of another depth is
    not refused: as in the JAX package it is dispatched, from its depth and
    before any launch, to the plain chain under every impl, and gives JAX's
    values (JAX's ``test_exit_gate_non_2layer_bank_falls_back``)."""
    spec_j = JSpecEEConfig(predictor_layers=3)
    bank_j = jpred.init_predictors(spec_j, 2, jax.random.PRNGKey(3))
    bank = bridge.to_torch(jax.tree_util.tree_map(np.asarray, bank_j), "cpu")
    rng = np.random.default_rng(6)
    hn = rng.standard_normal((2, 16)).astype(np.float32)
    w = rng.standard_normal((16, 32)).astype(np.float32)
    ids = np.array([[1, 2, 3, 4], [5, 6, 7, 31]], np.int32)
    prev = np.full((2, 4), 0.25, np.float32)
    K.reset_launches()
    for impl in ("kernel", "ref"):
        for sh in (False, True):
            want = jgate.exit_gate(hn, w, ids, prev, bank_j, jnp.int32(1),
                                   impl=impl, spec_head_kernel=sh)
            got = tgate.exit_gate(_t(hn), _t(w), _t(ids), _t(prev), bank, 1,
                                  impl=impl, spec_head_kernel=sh)
            for a, b in zip(got, want):
                _close(a, b)
    assert all(n == 0 for n in K.LAUNCHES.values())


@pytest.mark.parametrize("B,D,V,k", [(4, 128, 512, 4), (3, 96, 300, 3)])
def test_exit_gate_spec_head_kernel_matches_jax(B, D, V, k):
    """``spec_head_kernel`` under the "ref" gate: spec-head features plus
    the plain MLP (JAX ``exit_gate(impl="ref", spec_head_kernel=True)``,
    its Pallas spec head in interpret mode)."""
    bank_j = jpred.init_predictors(JSpecEEConfig(num_speculative=k), 3,
                                   jax.random.PRNGKey(8))
    bank_t = bridge.to_torch(jax.tree_util.tree_map(np.asarray, bank_j),
                             "cpu")
    rng = np.random.default_rng(B + 10)
    hn = rng.standard_normal((B, D)).astype(np.float32)
    w = (rng.standard_normal((D, V)) * 0.05).astype(np.float32)
    ids = rng.integers(0, V, (B, k)).astype(np.int32)
    prev = rng.dirichlet(np.ones(k), B).astype(np.float32)
    want = jgate.exit_gate(hn, w, ids, prev, bank_j, jnp.int32(2),
                           impl="ref", spec_head_kernel=True)
    got = tgate.exit_gate(_t(hn), _t(w), _t(ids), _t(prev), bank_t, 2,
                          impl="ref", spec_head_kernel=True)
    for a, b in zip(got, want):
        _close(a, b)


def _cluster_gate(hn, w, ids, prev, w1, b1, w2, b2, C):
    """The cluster-split CUDA gate (csrc/exit_gate.cu), emulated in torch:
    rank c of C gathers head rows [c * Dc, (c + 1) * Dc), Dc = ceil(D / C),
    the C partial logits are summed in rank order; rank c computes the
    hidden units [c * Hc, (c + 1) * Hc), Hc = ceil(H / C), and the C MLP
    shares are summed in rank order before b2 and the sigmoid. Ids are
    clamped to [0, V)."""
    B, D = hn.shape
    V, k, H = w.shape[1], ids.shape[1], w1.shape[1]
    cols = ids.long().clamp(0, V - 1)
    Dc, Hc = -(-D // C), -(-H // C)
    p_out, probs, logits = torch.zeros(B), torch.zeros(B, k), torch.zeros(
        B, k)
    for b in range(B):
        lg = torch.zeros(k)
        for c in range(C):
            sl = slice(c * Dc, (c + 1) * Dc)
            lg = lg + (hn[b, sl, None] * w[sl][:, cols[b]]).sum(0)
        pr = torch.softmax(lg, -1)
        feats = torch.cat([lg, pr, pr - prev[b]])
        o = torch.zeros(())
        for c in range(C):
            hs = slice(c * Hc, (c + 1) * Hc)
            o = o + (torch.relu(feats @ w1[:, hs] + b1[hs])
                     * w2[hs, 0]).sum()
        p_out[b] = torch.sigmoid(o + b2[0])
        probs[b], logits[b] = pr, lg
    return p_out, probs, logits


@pytest.mark.parametrize("C", [1, 4, 16])
@pytest.mark.parametrize("D", [768, 1024])
@pytest.mark.parametrize("k", [1, 4])
def test_cluster_gate_matches_pallas_and_plain(C, D, k):
    """The emulated cluster split at C CTAs per row against JAX's Pallas
    exit_gate_fused in interpret mode and the port's plain version (H =
    64 hidden units: at C = 16 four per rank); ids include 0 and V - 1."""
    from repro.kernels.exit_gate.exit_gate import (
        exit_gate_fused as jax_exit_gate_fused)
    from repro_torch.kernels.exit_gate import exit_gate as eg
    rng = np.random.default_rng(C + D + k)
    B, V, H = 3, 300, 64
    hn = rng.standard_normal((B, D)).astype(np.float32)
    w = (rng.standard_normal((D, V)) * 0.05).astype(np.float32)
    ids = rng.integers(0, V, (B, k)).astype(np.int32)
    ids[0, 0], ids[-1, -1] = 0, V - 1
    prev = rng.dirichlet(np.ones(k), B).astype(np.float32)
    w1 = (rng.standard_normal((3 * k, H)) * 0.3).astype(np.float32)
    b1 = (rng.standard_normal(H) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((H, 1)) * H ** -0.5).astype(np.float32)
    b2 = (rng.standard_normal(1) * 0.1).astype(np.float32)
    args = (hn, w, ids, prev, w1, b1, w2, b2)
    want = jax_exit_gate_fused(*args)
    K.reset_launches()
    plain = eg.exit_gate_fused(*map(_t, args))
    assert K.LAUNCHES["exit_gate"] == 0
    got = _cluster_gate(*map(_t, args), C)
    for a, b, c in zip(got, want, plain):
        _close(a, b)
        _close(a, c)


# ---------------- spec head (Pallas row 10) ----------------
@pytest.mark.parametrize("R", [1, 7, 40])
def test_spec_head_matches_pallas(R):
    rng = np.random.default_rng(R)
    D, V, k = 256, 700, 4
    hn = rng.standard_normal((R, D)).astype(np.float32)
    w = (rng.standard_normal((D, V)) * 0.05).astype(np.float32)
    ids = rng.integers(0, V, (R, k)).astype(np.int32)
    ids[0] = [V - 1, 0, V - 1, 3]                     # edge, repeated ids
    want = jax_spec_head_logits(hn, w, ids, block_d=64)
    K.reset_launches()
    _close(spec_head_logits(_t(hn), _t(w), _t(ids)), want)
    for a, b in zip(tsh_ops.spec_head(_t(hn), _t(w), _t(ids)),
                    jsh_ops.spec_head(hn, w, ids)):
        _close(a, b)
    assert K.LAUNCHES["spec_head"] == 0


# ---------------- predictor MLP (Pallas row 12) ----------------
@pytest.mark.parametrize("R", [1, 9, 40])
def test_predictor_mlp_matches_pallas(R):
    bank_j = jpred.init_predictors(JSpecEEConfig(), 4, jax.random.PRNGKey(R))
    bank_t = bridge.to_torch(jax.tree_util.tree_map(np.asarray, bank_j),
                             "cpu")
    x = np.random.default_rng(R).standard_normal((R, 12)).astype(np.float32)
    l1, l2 = (jax.tree_util.tree_map(lambda a: a[3], l)
              for l in bank_j["layers"])
    want = jax_predictor_mlp(x, l1["w"], l1["b"], l2["w"], l2["b"])
    t1, t2 = ({n: v[3] for n, v in l.items()} for l in bank_t["layers"])
    K.reset_launches()
    _close(predictor_mlp_fused(_t(x), t1["w"], t1["b"], t2["w"], t2["b"]),
           want)
    _close(tpm_ops.predictor_mlp_at(_t(x), bank_t, 3),
           jpm_ops.predictor_mlp_at(x, bank_j, jnp.int32(3)))
    assert K.LAUNCHES["predictor_mlp"] == 0


@pytest.mark.parametrize("layers", [2, 3])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_apply_predictor_banked_matches_jax(layers, use_kernel):
    """(B, P, F) path features through the stacked bank: the fused MLP for
    a 2-layer bank, the plain chain for another depth (chosen from the
    bank's depth, as in JAX)."""
    spec_j = JSpecEEConfig(predictor_layers=layers)
    bank_j = jpred.init_predictors(spec_j, 3, jax.random.PRNGKey(layers))
    bank_t = bridge.to_torch(jax.tree_util.tree_map(np.asarray, bank_j),
                             "cpu")
    feats = np.random.default_rng(4).standard_normal((2, 27, 12)).astype(
        np.float32)
    want = jpred.apply_predictor_banked(bank_j, jnp.int32(1), feats,
                                        use_kernel=use_kernel)
    got = tpred.apply_predictor_banked(bank_t, 1, _t(feats),
                                       use_kernel=use_kernel)
    assert got.shape == (2, 27)
    _close(got, want)
    _close(tpred.apply_predictor(tpred.predictor_at(bank_t, 1), _t(feats)),
           want)


def test_predictor_matches_jax():
    spec_j, spec_t = JSpecEEConfig(), SpecEEConfig()
    bank_j = jpred.init_predictors(spec_j, 3, jax.random.PRNGKey(1))
    bank_t = bridge.to_torch(jax.tree_util.tree_map(np.asarray, bank_j),
                             "cpu")
    feats = np.random.default_rng(0).standard_normal((5, 12)).astype(
        np.float32)
    _close(tpred.apply_predictor(tpred.predictor_at(bank_t, 2), _t(feats)),
           jpred.apply_predictor(jpred.predictor_at(bank_j, 2), feats))
    gen = torch.Generator().manual_seed(0)
    bank = tpred.init_predictors(spec_t, 3, gen, "cpu")
    assert [tuple(l["w"].shape) for l in bank["layers"]] == \
        [tuple(l["w"].shape) for l in bank_j["layers"]]


# ---------------- impl switch and wrapper rules ----------------
def test_impl_resolution_and_cpu_wrappers_do_not_launch():
    x = torch.zeros(2, 8)
    assert tgate.resolve_impl("auto", x) == "ref"
    assert tgate.resolve_impl(None, x) == "ref"
    assert tgate.resolve_impl("kernel", x) == "kernel"
    with pytest.raises(ValueError):
        tgate.resolve_impl("xla", x)

    class Flags:
        exit_gate_kernel = True
        exit_gate_impl = "kernel"
    assert tgate.impl_for_flags(Flags) == "kernel"
    Flags.exit_gate_kernel = False
    assert tgate.impl_for_flags(Flags) == "ref"
    K.reset_launches()
    tgate.verify_argmax(torch.randn(2, 8), torch.randn(8, 16), impl="kernel")
    tgate.verify_topk(torch.randn(2, 8), torch.randn(8, 16), 4,
                      impl="kernel")
    assert all(n == 0 for n in K.LAUNCHES.values())
