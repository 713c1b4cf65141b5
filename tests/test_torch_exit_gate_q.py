"""The quantized exit gate (``exit_gate_fused_q``, csrc/exit_gate_q.cu)
and ``Model.decode_step`` of the port against the JAX package on the CPU.

- ``Model.decode_step``: the port's logits against JAX's over three
  decode steps after a prefill, on the llama2-7b and mamba2-130m smoke
  configs (fp32).
- The quantized gate: a torch emulation of the kernel's cluster split
  (stored head rows split over C ranks, each column's rank-order sum
  scaled once, the hidden units split over the ranks, the shares summed
  in rank order before s2 and b2) against JAX's
  ``exit_gate(..., impl="kernel")`` on ``repro.quant.quantize_tensor``
  weights (its piecewise Pallas spec head and predictor MLP in interpret
  mode) and against the port's plain version; the gate entry point on
  the CPU launches nothing.

Tolerance: fp32 sums taken in another order by the two frameworks, by
the kernel's split and by the plain version: atol = rtol = 1e-5 on
logits, probabilities and exit probabilities, and on the decode logits.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import quant as jquant  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels.exit_gate import ops as jgate_ops  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import bridge, quant  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.predictor import predictor_at  # noqa: E402
from repro_torch.kernels.exit_gate import exit_gate as eg  # noqa: E402
from repro_torch.kernels.exit_gate import ops as gate_ops  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **TOL)


# ---------------- Model.decode_step ----------------
@pytest.mark.parametrize("name", ["llama2-7b", "mamba2-130m"])
def test_model_decode_step_matches_jax(name):
    """``Model.decode_step`` (``decode_step_hidden``, then the logits) of
    the port against JAX's ``Model.decode_step`` (``models/model.py``):
    a prefill of 7 tokens, then 3 decode steps on the same tokens; the
    (B, V) fp32 logits of every step allclose."""
    run_j, run_t = jax_get_config(name).smoke(), get_config(name).smoke()
    m_j, m_t = jmodel.build_model(run_j), tmodel.build_model(run_t)
    params_j = m_j.init(jax.random.PRNGKey(0))
    params_t = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params_j), "cpu", torch.float32)
    rng = np.random.default_rng(5)
    V = run_t.model.vocab_size
    prompt = rng.integers(0, V, (2, 7)).astype(np.int32)
    _, cj, _ = m_j.prefill(params_j, {"tokens": jnp.asarray(prompt)},
                           max_seq=12)
    _, ct, _ = m_t.prefill(params_t, {"tokens": _t(prompt)}, max_seq=12)
    step_j = jax.jit(m_j.decode_step)
    for _ in range(3):
        tok = rng.integers(0, V, (2,)).astype(np.int32)
        lj, cj = step_j(params_j, jnp.asarray(tok), cj)
        lt, ct = m_t.decode_step(params_t, _t(tok), ct)
        assert lt.dtype == torch.float32 and tuple(lt.shape) == (2, V)
        _close(lt, lj)
    np.testing.assert_array_equal(ct["len"].numpy(), np.asarray(cj["len"]))


# ---------------- the quantized gate ----------------
def _codes(qt):
    """A port QTensor's integer codes as fp32 (rows, cols): an int4
    weight's planes stacked (low nibbles rows [0, rows/2), high the
    rest)."""
    if qt.bits == 4:
        return torch.cat(quant.unpack_int4(qt.q), 0).float()
    return qt.q.float()


def _cluster_gate_q(hn, head, ids, prev, l1, l2, C):
    """The cluster-split quantized gate (csrc/exit_gate.cuh on the
    exit_gate_q.cu instances), emulated in torch: rank c of C gathers the
    stored head rows [c * Dc, (c + 1) * Dc), Dc = ceil(Dp / C), Dp = D for
    fp and int8 heads and D / 2 for int4 (stored row d feeds hidden entries
    d and d + D/2); the C partial logits are summed in rank order, then
    multiplied by the column's scale; rank c computes the hidden units
    [c * Hc, (c + 1) * Hc), Hc = ceil(H / C), each as (feats . c1) * s1 +
    b1, and the C shares relu(.) . c2 are summed in rank order before s2,
    b2 and the sigmoid. Ids are clamped to [0, V)."""
    B, D = hn.shape
    k = ids.shape[1]
    qh = isinstance(head, quant.QTensor)
    V = head.shape[-1]
    cols = ids.long().clamp(0, V - 1)
    P = 2 if qh and head.bits == 4 else 1
    Dp = D // P
    stored = ([p.float() for p in quant.unpack_int4(head.q)] if P == 2
              else [head.q.float() if qh else head.float()])
    qb = isinstance(l1["w"], quant.QTensor)
    c1 = _codes(l1["w"]) if qb else l1["w"]
    c2 = _codes(l2["w"])[:, 0] if qb else l2["w"][:, 0]
    s1 = l1["w"].scale if qb else torch.ones(c1.shape[1])
    s2 = l2["w"].scale[0] if qb else torch.ones(())
    b1, b2 = l1["b"], l2["b"]
    H = c1.shape[1]
    Dc, Hc = -(-Dp // C), -(-H // C)
    p_out, probs, logits = (torch.zeros(B), torch.zeros(B, k),
                            torch.zeros(B, k))
    for b in range(B):
        lg = torch.zeros(k)
        for c in range(C):
            sl = slice(c * Dc, min(Dp, (c + 1) * Dc))
            for p in range(P):
                x = hn[b, p * Dp:(p + 1) * Dp][sl]
                lg = lg + (x[:, None] * stored[p][sl][:, cols[b]]).sum(0)
        if qh:
            lg = lg * head.scale[cols[b]]
        pr = torch.softmax(lg, -1)
        feats = torch.cat([lg, pr, pr - prev[b]])
        o = torch.zeros(())
        for c in range(C):
            hs = slice(c * Hc, (c + 1) * Hc)
            hid = (feats @ c1[:, hs]) * s1[hs] + b1[hs]
            o = o + (torch.relu(hid) * c2[hs]).sum()
        p_out[b] = torch.sigmoid(o * s2 + b2[0])
        probs[b], logits[b] = pr, lg
    return p_out, probs, logits


def _gate_inputs(head_bits, bank_bits, k, D, V=300, B=3, E=2, H=64):
    """Seeded numpy inputs and the quantized weights on both sides: the
    head fp (None) or ``quantize_tensor``'d to 8 or 4 bits, a stacked
    2-layer bank of E predictors likewise (an odd 3k quantizes W1 to
    int8 under int4). Ids include 0 and V - 1."""
    rng = np.random.default_rng((head_bits or 1) + 10 * (bank_bits or 1)
                                + k + D)
    hn = rng.standard_normal((B, D)).astype(np.float32)
    w = (rng.standard_normal((D, V)) * 0.05).astype(np.float32)
    ids = rng.integers(0, V, (B, k)).astype(np.int32)
    ids[0, 0], ids[-1, -1] = 0, V - 1
    prev = rng.dirichlet(np.ones(k), B).astype(np.float32)
    bank = {"layers": [
        {"w": (rng.standard_normal((E, 3 * k, H)) * 0.3).astype(np.float32),
         "b": (rng.standard_normal((E, H)) * 0.1).astype(np.float32)},
        {"w": (rng.standard_normal((E, H, 1)) * H ** -0.5).astype(
            np.float32),
         "b": (rng.standard_normal((E, 1)) * 0.1).astype(np.float32)}]}
    head_j = (jnp.asarray(w) if head_bits is None
              else jquant.quantize_tensor(jnp.asarray(w), head_bits))
    bank_j = {"layers": [
        {"w": (jnp.asarray(l["w"]) if bank_bits is None
               else jquant.quantize_tensor(jnp.asarray(l["w"]), bank_bits)),
         "b": jnp.asarray(l["b"])} for l in bank["layers"]]}
    to_t = lambda tree: bridge.qw_from_numpy(  # noqa: E731
        jax.tree_util.tree_map(np.asarray, tree), "cpu")
    return hn, ids, prev, head_j, bank_j, to_t(head_j), to_t(bank_j)


COMBOS = [(h, b) for h in (None, 8, 4) for b in (None, 8, 4)
          if (h, b) != (None, None)]


@pytest.mark.parametrize("head_bits,bank_bits", COMBOS)
@pytest.mark.parametrize("k,D", [(3, 768), (4, 1024)])
def test_cluster_gate_q_matches_pallas_and_plain(head_bits, bank_bits, k,
                                                 D):
    """The emulated quantized cluster split at C in {1, 3, 8} against
    JAX's quantized gate (``exit_gate(impl="kernel")``: the Pallas spec
    head and predictor MLP on quantized weights, in interpret mode) and
    the port's plain version (``exit_gate_fused_q`` on the CPU), at exit
    point 1 of a stacked bank; k = 3 gives F = 9, whose W1 is int8 under
    int4 (bits1 != bits2)."""
    hn, ids, prev, head_j, bank_j, head_t, bank_t = _gate_inputs(
        head_bits, bank_bits, k, D)
    want = jgate_ops.exit_gate(jnp.asarray(hn), head_j, jnp.asarray(ids),
                               jnp.asarray(prev), bank_j, jnp.int32(1),
                               impl="kernel")
    l1, l2 = predictor_at(bank_t, 1)["layers"]
    if bank_bits is not None:
        assert l1["w"].bits == (8 if k == 3 else bank_bits)
    K.reset_launches()
    plain = eg.exit_gate_fused_q(_t(hn), head_t, _t(ids), _t(prev), l1, l2)
    assert all(v == 0 for v in K.LAUNCHES.values())
    for C in (1, 3, 8):
        got = _cluster_gate_q(_t(hn), head_t, _t(ids), _t(prev), l1, l2, C)
        for a, b, c in zip(got, want, plain):
            _close(a, b)
            _close(a, c)


@pytest.mark.parametrize("head_bits,bank_bits", COMBOS)
def test_gate_entry_point_on_cpu_launches_nothing(head_bits, bank_bits):
    """``ops.exit_gate`` under "kernel" with a quantized head or bank runs
    the quantized gate's plain version on a CPU tensor: no launch counted,
    and its outputs are the plain version's on the bank's slice, bit for
    bit."""
    hn, ids, prev, _, _, head_t, bank_t = _gate_inputs(head_bits, bank_bits,
                                                       4, 256)
    K.reset_launches()
    got = gate_ops.exit_gate(_t(hn), head_t, _t(ids), _t(prev), bank_t, 1,
                             impl="kernel")
    assert all(v == 0 for v in K.LAUNCHES.values())
    want = eg.exit_gate_fused_q(_t(hn), head_t, _t(ids), _t(prev),
                                *predictor_at(bank_t, 1)["layers"])
    for a, b in zip(got, want):
        assert torch.equal(a, b)
