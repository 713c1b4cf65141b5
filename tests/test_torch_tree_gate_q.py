"""The quantized tree gate against the JAX package on the CPU: the spec
head over a quantized head in two stages — the code-column gather
(csrc/spec_head_gather_q.cu) and the dot over the gathered codes
(csrc/spec_head_q.cu) — and the predictor MLP over quantized weights
(csrc/predictor_mlp_q.cu), int8 and int4, and over fp32 weights
(csrc/predictor_mlp.cu, the same body).

- The plain versions of both spec-head stages (``spec_gather_q_ref``, then
  ``spec_dot_q_ref``) on tree-shaped ids — the node tokens' code columns
  and scales gathered once, each node's k children read as rows
  ``b*N + child(n, j)`` — against JAX's ``spec_head_logits_q`` (its Pallas
  kernel in interpret mode) on the children's token ids, clamped to
  [0, V) as the gather clamps them.
- Torch emulations of the dot kernel's summation order (per lane an fp32
  multiply-add chain over its 16-byte code chunks, or its stored rows when
  they are not a multiple of 16, then a butterfly over the 32 lanes, then
  the scale) and of the predictor kernel's (per hidden unit the features'
  chain, s1 and b1; per thread its units in order; a butterfly in each
  warp; the warps in order; s2, b2, the sigmoid; the fp form's chain from
  b1, no scales) against JAX's Pallas kernels in interpret mode.
- ``tree_decode_step`` under ``quant="int8"`` and ``"int4"`` with the
  spec-head flag: tokens, counts, accept lengths, exit points and exits
  equal JAX's quantized tree sessions; the plain gather runs once per step
  when any exit point runs the gate, with one dot per such exit point, and
  never in a step where none does.

Tolerance: fp32 sums in another order than JAX's: atol = rtol = 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import quant as jquant  # noqa: E402
from repro.api import Engine as JEngine  # noqa: E402
from repro.api import TreeStrategy as JTree  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core.tree import TreeSpec as JTreeSpec  # noqa: E402
from repro.kernels.predictor_mlp.predictor_mlp import (  # noqa: E402
    predictor_mlp_fused as jax_predictor_mlp)
from repro.kernels.predictor_mlp.predictor_mlp import (  # noqa: E402
    predictor_mlp_fused_q as jax_predictor_mlp_q)
from repro.kernels.spec_head.spec_head import (  # noqa: E402
    spec_head_logits_q as jax_spec_head_logits_q)
from repro.models.model import ModelFlags as JFlags  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.api import Engine, TreeStrategy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core.tree import TreeSpec  # noqa: E402
from repro_torch.kernels.predictor_mlp.predictor_mlp import (  # noqa: E402
    predictor_mlp_fused, predictor_mlp_fused_q)
from repro_torch.kernels.spec_head import spec_head as sh  # noqa: E402
from repro_torch.kernels.spec_head.ref import (  # noqa: E402
    spec_dot_q_ref, spec_gather_q_ref)
from repro_torch.models.model import ModelFlags, build_model  # noqa: E402
from repro_torch.quant import unpack_int4  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
K_SPEC = 4
KERNEL_FLAGS = dict(spec_head_kernel=True, exit_gate_kernel=True,
                    exit_gate_impl="kernel")
# the predictor kernel's block: threads over the hidden units
# (csrc/predictor.cuh, PR_THREADS)
PRED_THREADS = 256


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _qhead(bits, D, V, seed):
    """A (D, V) head quantized by the JAX package, and the port's copy."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((D, V)) * 0.1).astype(np.float32)
    qt_j = jquant.quantize_tensor(jnp.asarray(w), bits)
    return qt_j, bridge.qw_from_numpy(
        jax.tree_util.tree_map(np.asarray, qt_j), "cpu")


def _tree_ids(rng, B, V, tree, k=K_SPEC):
    """Node tokens (B, N) with edge, repeated and out-of-range ids; the
    children's ids (B*N, k), clamped to [0, V), as the tree step builds
    them (a leaf's missing children clamp to the root, the padding repeats
    the first child); and the same as rows of the gathered node columns."""
    N = tree.num_nodes
    toks = rng.integers(0, V, (B, N)).astype(np.int32)
    toks[0, :4] = [0, V - 1, V - 1, 0]
    toks[-1, -2:] = [-3, V + 5]
    child = np.clip(tree.children, 0, None)
    if child.shape[1] < k:
        child = np.concatenate(
            [child, np.repeat(child[:, :1], k - child.shape[1], 1)], 1)
    child = child[:, :k]
    ids = np.clip(toks[:, child].reshape(B * N, k), 0, V - 1)
    rows = (np.arange(B)[:, None, None] * N + child[None]).reshape(B * N, k)
    return toks, ids.astype(np.int32), rows.astype(np.int32)


def _widen(q, bits):
    """int8 codes, or plane-packed int4 bytes widened along dim -2 (the
    low plane, then the high one), as fp32."""
    if bits == 4:
        return torch.cat(unpack_int4(q), dim=-2).float()
    return q.float()


def _fma_chain(terms):
    """fp32 accumulation of ``terms`` (..., S, L) over S in order, each
    step rounded once (the products exact in fp64): fmaf's chain."""
    acc = torch.zeros(terms.shape[:-2] + terms.shape[-1:],
                      dtype=torch.float32)
    for s in range(terms.shape[-2]):
        acc = (acc.double() + terms[..., s, :]).float()
    return acc


def _butterfly(acc):
    """The 32 lanes of the last dim summed by xor 16, 8, 4, 2, 1; lane 0."""
    lane = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lane ^ off]
    return acc[..., 0]


def _dot_q_emulated(hn, cols, idx):
    """csrc/spec_head_q.cu's order on the CPU: lane l takes the 16-byte
    code chunks l, l + 32, ... (each chunk's 16 stored rows in order), or
    the stored rows l, l + 32, ... when their count is not a multiple of
    16; a stored row adds hn[d] * code (int8) or hn[d] * lo, then
    hn[d + D/2] * hi (int4) into one fp32 accumulator; then the 32 lane
    sums in a butterfly, then the scale."""
    R, D = hn.shape
    i = idx.long()
    k = i.shape[1]
    codes = cols.codes[i]                                    # (R, k, Dp)
    Dp = codes.shape[-1]
    x = hn.double()[:, None, :]
    if cols.bits == 4:
        lo, hi = unpack_int4(codes)
        planes = [x[..., :Dp] * lo.double(), x[..., Dp:] * hi.double()]
    else:
        planes = [x * codes.double()]
    if Dp % 16 == 0:
        Q = Dp // 16
        order = np.full((-(-Q // 32) * 16, 32), -1)
        for lane in range(32):
            rows = [16 * q + e for q in range(lane, Q, 32)
                    for e in range(16)]
            order[:len(rows), lane] = rows
    else:
        order = np.full((-(-Dp // 32), 32), -1)
        for lane in range(32):
            rows = list(range(lane, Dp, 32))
            order[:len(rows), lane] = rows
    o = torch.as_tensor(order)
    valid = (o >= 0).double()
    steps = [p[..., o.clamp(min=0)] * valid for p in planes]  # (R,k,S,32)
    terms = torch.stack(steps, dim=-2).reshape(R, k, -1, 32)
    return _butterfly(_fma_chain(terms)) * cols.scales[i]


def _predictor_emulated(x, w1, b1, w2, b2, s1=None, s2=None,
                        threads=PRED_THREADS):
    """csrc/predictor.cuh's order on the CPU (``predictor_rows``): per
    hidden unit h the features' chain, for a scaled form (codes) from 0,
    then fmaf(dot, s1[h], b1[h]), for the fp form from b1[h]; thread t
    takes the units t, t + threads, ... in order into relu(hidden) *
    W2[h]; a butterfly in each warp; the warps' sums in warp order;
    fmaf(sum, s2, b2) for a scaled form, sum + b2 for the fp form; the
    sigmoid. ``w1`` (F, H) and ``w2`` (H,) are the weights or the widened
    codes."""
    R, F = x.shape
    H = w1.shape[1]
    terms = x.double()[:, :, None] * w1.double()[None]       # (R, F, H)
    if s1 is None:
        hid = _fma_chain(torch.cat([b1.double().expand(R, 1, H), terms], 1))
    else:
        dot = _fma_chain(terms)                               # (R, H)
        hid = (dot.double() * s1.double() + b1.double()).float()
    share = torch.relu(hid).double() * w2.double()            # (R, H)
    per_thread = -(-H // threads)
    pad = per_thread * threads - H
    share = torch.cat([share, share.new_zeros(R, pad)], 1)
    part = _fma_chain(share.reshape(R, per_thread, threads))  # (R, T)
    warps = _butterfly(part.reshape(R, threads // 32, 32))   # (R, W)
    o = _fma_chain(warps.double()[:, :, None])[:, 0].double()
    o = (o + b2.double()[0] if s2 is None
         else o * s2.double()[0] + b2.double()[0]).float()
    return 1.0 / (1.0 + torch.exp(-o))


def _predictor_q_emulated(x, qw1, b1, qw2, b2, threads=PRED_THREADS):
    """``_predictor_emulated`` on the quantized form: the widened codes
    with their scales."""
    return _predictor_emulated(x, _widen(qw1.q, qw1.bits), b1,
                               _widen(qw2.q, qw2.bits)[:, 0], b2,
                               qw1.scale, qw2.scale, threads)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("depth,branch", [(3, 3), (2, 2)])
def test_gather_then_dot_q_matches_jax_on_tree_ids(depth, branch, bits):
    """The node tokens' code columns and scales gathered once, then each
    node's k children read from them, equal JAX's quantized spec head on
    the children's ids (fp32); the wrappers on CPU tensors run exactly
    these plain versions, and ``spec_head_logits_q`` agrees."""
    rng = np.random.default_rng(depth * 10 + branch + bits)
    B, D, V = 2, 128, 512
    tree = TreeSpec(depth, branch)
    qt_j, qt = _qhead(bits, D, V, seed=bits)
    toks, ids, rows = _tree_ids(rng, B, V, tree)
    hn = rng.standard_normal((B * tree.num_nodes, D)).astype(np.float32)
    want = np.asarray(jax_spec_head_logits_q(jnp.asarray(hn), qt_j,
                                             jnp.asarray(ids)))
    cols = spec_gather_q_ref(qt, _t(toks).reshape(-1))
    assert cols.codes.shape == (B * tree.num_nodes, qt.q.shape[0])
    assert cols.bits == bits
    got = spec_dot_q_ref(_t(hn), cols, _t(rows))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    K.reset_launches()
    cols_w = sh.spec_head_gather_q(qt, _t(toks).reshape(-1))
    assert torch.equal(cols_w.codes, cols.codes)
    assert torch.equal(cols_w.scales, cols.scales)
    assert torch.equal(sh.spec_head_dot_q(_t(hn), cols_w, _t(rows)), got)
    np.testing.assert_allclose(
        sh.spec_head_logits_q(_t(hn), qt, _t(ids)).numpy(), want, **TOL)
    assert all(v == 0 for v in K.LAUNCHES.values())        # CPU: plain


@pytest.mark.parametrize("bits", [8, 4])
def test_gather_q_is_an_exact_clamped_copy(bits):
    """The gather copies each column's stored bytes and its scale exactly,
    with ids clamped to [0, V) as the kernel clamps them."""
    _, qt = _qhead(bits, 64, 300, seed=3)
    V = 300
    ids = torch.tensor([-3, V + 5, 7, 7, 0, V - 1], dtype=torch.int32)
    cols = spec_gather_q_ref(qt, ids)
    assert cols.codes.dtype == torch.int8 and cols.codes.is_contiguous()
    want = [0, V - 1, 7, 7, 0, V - 1]
    assert torch.equal(cols.codes, torch.stack([qt.q[:, j] for j in want]))
    assert torch.equal(cols.scales, qt.scale[want])


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("D", [128, 4096, 100])
def test_dot_q_kernel_order_matches_jax(D, bits):
    """The emulated dot order against JAX's quantized spec head on
    tree-shaped ids in fp32: 16-byte code chunks (D = 128: one chunk a
    lane or none; D = 4096: 8 a lane in int8, 4 in int4) and the stored
    row path (D = 100: 100 or 50 stored rows)."""
    rng = np.random.default_rng(D + bits)
    B, V = 2, 700
    tree = TreeSpec(2, 2)
    qt_j, qt = _qhead(bits, D, V, seed=D)
    toks, ids, rows = _tree_ids(rng, B, V, tree)
    hn = rng.standard_normal((B * tree.num_nodes, D)).astype(np.float32)
    want = np.asarray(jax_spec_head_logits_q(jnp.asarray(hn), qt_j,
                                             jnp.asarray(ids)))
    cols = spec_gather_q_ref(qt, _t(toks).reshape(-1))
    got = _dot_q_emulated(_t(hn), cols, _t(rows))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(
        got.numpy(), spec_dot_q_ref(_t(hn), cols, _t(rows)).numpy(), **TOL)


@pytest.mark.parametrize("bits", [8, 4])
def test_dot_q_kernel_order_bf16(bits):
    """bf16 hidden rows (every product with a code exact in fp32): the
    emulated order against the plain dot on the same inputs."""
    rng = np.random.default_rng(11 + bits)
    B, D, V = 2, 256, 512
    tree = TreeSpec(3, 3)
    _, qt = _qhead(bits, D, V, seed=11)
    toks, _, rows = _tree_ids(rng, B, V, tree)
    hn = _t(rng.standard_normal((B * tree.num_nodes, D)).astype(
        np.float32)).bfloat16()
    cols = spec_gather_q_ref(qt, _t(toks).reshape(-1))
    np.testing.assert_allclose(
        _dot_q_emulated(hn, cols, _t(rows)).numpy(),
        spec_dot_q_ref(hn, cols, _t(rows)).numpy(), **TOL)


@pytest.mark.parametrize("H", [512, 200])
@pytest.mark.parametrize("bits1,bits2", [(8, 8), (4, 4), (8, 4), (4, 8)])
def test_predictor_q_kernel_order_matches_jax(bits1, bits2, H):
    """The emulated predictor order against JAX's quantized predictor
    (interpret mode) and the plain version, at the tree's B*P = 54 merged
    paths of two TreeSpec(3, 3) rows, each weight's bits on its own; H =
    200 leaves threads without a unit."""
    rng = np.random.default_rng(bits1 * 10 + bits2 + H)
    R, F = 54, 3 * K_SPEC
    x = rng.standard_normal((R, F)).astype(np.float32)
    w1 = (rng.standard_normal((F, H)) * F ** -0.5).astype(np.float32)
    w2 = (rng.standard_normal((H, 1)) * H ** -0.5).astype(np.float32)
    b1 = (rng.standard_normal(H) * 0.1).astype(np.float32)
    b2 = (rng.standard_normal(1) * 0.1).astype(np.float32)
    q1_j = jquant.quantize_tensor(jnp.asarray(w1), bits1)
    q2_j = jquant.quantize_tensor(jnp.asarray(w2), bits2)
    want = np.asarray(jax_predictor_mlp_q(jnp.asarray(x), q1_j,
                                          jnp.asarray(b1), q2_j,
                                          jnp.asarray(b2)))
    q1, q2 = (bridge.qw_from_numpy(jax.tree_util.tree_map(np.asarray, q),
                                   "cpu") for q in (q1_j, q2_j))
    got = _predictor_q_emulated(_t(x), q1, _t(b1), q2, _t(b2))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(
        got.numpy(),
        predictor_mlp_fused_q(_t(x), q1, _t(b1), q2, _t(b2)).numpy(), **TOL)


@pytest.mark.parametrize("R", [1, 108])
@pytest.mark.parametrize("F", [12, 15, 24])
def test_predictor_fp_kernel_order_matches_jax(F, R):
    """The emulated predictor order on the fp form (csrc/predictor_mlp.cu:
    no scales, each unit's chain from b1) against JAX's
    ``predictor_mlp_fused`` (interpret mode) and the plain version, at
    H = 512 and F = 12 (the instance unrolled to 12), 15 and 24 (the
    instance unrolled to 32), one row and the B*P = 108 merged paths of
    four TreeSpec(3, 3) rows."""
    rng = np.random.default_rng(F * 1000 + R)
    H = 512
    x = rng.standard_normal((R, F)).astype(np.float32)
    w1 = (rng.standard_normal((F, H)) * F ** -0.5).astype(np.float32)
    w2 = (rng.standard_normal((H, 1)) * H ** -0.5).astype(np.float32)
    b1 = (rng.standard_normal(H) * 0.1).astype(np.float32)
    b2 = (rng.standard_normal(1) * 0.1).astype(np.float32)
    want = np.asarray(jax_predictor_mlp(*map(jnp.asarray,
                                             (x, w1, b1, w2, b2))))
    got = _predictor_emulated(_t(x), _t(w1), _t(b1), _t(w2)[:, 0], _t(b2))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(
        got.numpy(),
        predictor_mlp_fused(*map(_t, (x, w1, b1, w2, b2))).numpy(), **TOL)


@pytest.fixture(scope="module")
def setup():
    run_j = jax_get_config("llama2-7b").smoke()
    run_t = get_config("llama2-7b").smoke()
    m_j = jbuild(run_j, JFlags(**KERNEL_FLAGS))
    m_t = build_model(run_t, ModelFlags(**KERNEL_FLAGS))
    params_j = m_j.init(jax.random.PRNGKey(0))
    sw_j = jeng.init_specee(m_j, jax.random.PRNGKey(1))
    params_t = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params_j), "cpu", torch.float32)
    sw_np = jax.tree_util.tree_map(np.asarray, sw_j)
    sw_t = bridge.specee_from_numpy(sw_np.draft, sw_np.predictors,
                                    sw_np.offline_mask, "cpu", torch.float32)
    return m_j, m_t, params_j, params_t, sw_j, sw_t


def _counted(monkeypatch):
    """Count the calls of the quantized spec head's plain stages."""
    calls = {"gather": 0, "dot": 0}

    def counted(name, fn):
        def wrapper(*args):
            calls[name] += 1
            return fn(*args)
        return wrapper

    monkeypatch.setattr(sh, "spec_gather_q_ref",
                        counted("gather", spec_gather_q_ref))
    monkeypatch.setattr(sh, "spec_dot_q_ref",
                        counted("dot", spec_dot_q_ref))
    return calls


@pytest.mark.parametrize("thresh", [1.5, -0.1])
@pytest.mark.parametrize("spec", ["int8", "int4"])
def test_quant_tree_steps_match_jax_and_gather_once(setup, monkeypatch,
                                                    spec, thresh):
    """Quantized tree sessions (TreeSpec(2, 3), dense cache) with the
    kernel flags: every step's tokens, counts, accept lengths, exit points,
    exits and units_run equal JAX's (its Pallas kernels in interpret
    mode). Each step gathers its node columns once; at threshold 1.5 no
    row exits and every exit point dots with them, at -0.1 every row exits
    at the first, after one dot."""
    m_j, m_t, params_j, params_t, sw_j, sw_t = setup
    prompts = np.random.default_rng(31).integers(0, 512, (2, 8))
    tree_j, tree_t = JTreeSpec(2, 3), TreeSpec(2, 3)
    calls = _counted(monkeypatch)

    def summary(results):
        return [(np.asarray(r.tokens).tolist(),
                 np.asarray(r.counts).tolist(),
                 np.asarray(r.accept_len).tolist(),
                 np.asarray(r.exit_layer).tolist(),
                 np.asarray(r.exited).tolist(), int(r.units_run))
                for r in results]

    s_t = Engine.create(m_t, params_t, sw_t, strategy=TreeStrategy(
        tree=tree_t, threshold=thresh), quant=spec).new_session(
            cache="dense")
    got = [s_t.prefill(prompts, max_new_tokens=4)]
    K.reset_launches()
    while not s_t.all_done():
        before = dict(calls)
        got.append(s_t.step())
        units = got[-1].units_run
        assert calls["gather"] - before["gather"] == 1
        dots = calls["dot"] - before["dot"]
        assert dots == (units if thresh > 1 else 1) and units >= 1
    assert all(v == 0 for v in K.LAUNCHES.values())        # CPU: plain
    s_j = JEngine.create(m_j, params_j, sw_j, strategy=JTree(
        tree=tree_j, threshold=thresh), quant=spec).new_session(
            cache="dense")
    want = [s_j.prefill(jnp.asarray(prompts), max_new_tokens=4)]
    while not s_j.all_done():
        want.append(s_j.step())
    assert summary(got) == summary(want)
    exits = sum(int(np.asarray(r.exited).sum()) for r in got[1:])
    assert (exits == 0) if thresh > 1 else (exits > 0)


@pytest.mark.parametrize("spec", ["int8", "int4"])
def test_quant_tree_step_without_gate_gathers_nothing(setup, monkeypatch,
                                                      spec):
    """A quantized tree step in which no exit point is active (an empty
    schedule queue and no offline point) gathers nothing and dots
    nothing; the next step, with every point active, gathers once."""
    _, m_t, _, params_t, _, sw_t = setup
    calls = _counted(monkeypatch)
    tree = TreeSpec(2, 3)
    engine = Engine.create(m_t, params_t, sw_t, strategy=TreeStrategy(
        tree=tree), quant=spec)
    params, sw, qw = engine.decode_weights()
    prompts = torch.as_tensor(np.random.default_rng(4).integers(
        0, 512, (2, 8)), dtype=torch.int32)
    _, state = teng.init_tree_decode_state(m_t, params, sw,
                                           {"tokens": prompts}, 32, tree)
    quiet = sw._replace(offline_mask=torch.zeros_like(sw.offline_mask))
    _, _, _, info = teng.tree_decode_step(m_t, params, quiet, state, tree,
                                          threshold=1.5, qw=qw)
    assert calls == {"gather": 0, "dot": 0}
    assert info.units_run == m_t.num_exit_points
    _, _, _, info = teng.tree_decode_step(m_t, params, sw, state, tree,
                                          threshold=1.5, qw=qw)
    assert calls == {"gather": 1, "dot": info.units_run}
