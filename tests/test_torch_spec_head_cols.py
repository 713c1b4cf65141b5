"""The fp spec head in two stages — the column gather
(csrc/spec_head_gather.cu) and the dot over the gathered columns
(csrc/spec_head.cu) — against the JAX package on the CPU.

- The plain versions of both stages (``spec_gather_ref``, then
  ``spec_dot_ref``) on tree-shaped ids — the node tokens' columns gathered
  once, each node's k children read as rows ``b*N + child(n, j)`` —
  against JAX's ``spec_head_logits`` (its Pallas kernel in interpret mode)
  on the children's token ids.
- A torch emulation of the dot kernel's summation order (per lane an fp32
  multiply-add chain over its 16-byte chunks, or its elements when D is
  not a multiple of 16 bytes, then a butterfly over the 32 lanes) against
  the same, and against the plain dot in bf16.
- ``tree_decode_step`` with the spec-head kernel flag gathers once per
  step when any exit point runs the gate, and not at all when none does
  (the plain gather's calls counted).

Tolerance: fp32 sums in another order than JAX's: atol = rtol = 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.spec_head.spec_head import (  # noqa: E402
    spec_head_logits as jax_spec_head_logits)
from repro_torch import kernels as K  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core.tree import TreeSpec  # noqa: E402
from repro_torch.kernels.spec_head import spec_head as sh  # noqa: E402
from repro_torch.kernels.spec_head.ref import (spec_dot_ref,  # noqa: E402
                                               spec_gather_ref)
from repro_torch.models.model import ModelFlags, build_model  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
K_SPEC = 4


def _t(x):
    return torch.from_numpy(np.array(x))


def _tree_ids(rng, B, V, tree, k=K_SPEC):
    """Node tokens (B, N) with edge and repeated ids, the children's ids
    (B*N, k) as the tree step builds them (a leaf's missing children clamp
    to the root, the padding repeats the first child) and the same as rows
    of the gathered node columns."""
    N = tree.num_nodes
    toks = rng.integers(0, V, (B, N)).astype(np.int32)
    toks[0, :4] = [0, V - 1, V - 1, 0]
    child = np.clip(tree.children, 0, None)
    if child.shape[1] < k:
        child = np.concatenate(
            [child, np.repeat(child[:, :1], k - child.shape[1], 1)], 1)
    child = child[:, :k]
    ids = toks[:, child].reshape(B * N, k)
    rows = (np.arange(B)[:, None, None] * N + child[None]).reshape(B * N, k)
    return toks, ids, rows.astype(np.int32)


def _dot_emulated(hn, cols, idx):
    """csrc/spec_head.cu's order on the CPU: lane l takes the 16-byte
    chunks l, l + 32, ... (each chunk's elements in order), or the elements
    l, l + 32, ... when D is not a multiple of 16 bytes, into one fp32
    accumulator (each multiply-add rounded once: the products are exact in
    fp64, the sum rounded to fp32); then the 32 lane sums in a butterfly,
    xor 16, 8, 4, 2, 1."""
    R, D = hn.shape
    k = idx.shape[1]
    E = 16 // hn.element_size()
    prod = hn.double()[:, None, :] * cols.double()[idx.long()]   # (R, k, D)
    if D % E == 0:
        Q = D // E
        steps = -(-Q // 32)
        prod = prod.reshape(R, k, Q, E)
        prod = torch.cat([prod, prod.new_zeros(R, k, steps * 32 - Q, E)], 2)
        terms = prod.reshape(R, k, steps, 32, E).permute(0, 1, 2, 4, 3)
        terms = terms.reshape(R, k, steps * E, 32)
    else:
        steps = -(-D // 32)
        terms = torch.cat([prod, prod.new_zeros(R, k, steps * 32 - D)], 2)
        terms = terms.reshape(R, k, steps, 32)
    acc = torch.zeros(R, k, 32, dtype=torch.float32)
    for s in range(terms.shape[2]):
        acc = (acc.double() + terms[:, :, s]).float()
    lane = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[:, :, lane ^ off]
    return acc[:, :, 0]


@pytest.mark.parametrize("depth,branch", [(3, 3), (2, 3), (1, 4)])
def test_gather_then_dot_matches_jax_on_tree_ids(depth, branch):
    """The node tokens' columns gathered once, then each node's k children
    read from them, equal JAX's spec head on the children's ids (fp32);
    the wrappers on CPU tensors run exactly these plain versions, and
    ``spec_head_logits`` (gather of ids.flatten(), dot with arange)
    agrees."""
    rng = np.random.default_rng(depth * 10 + branch)
    B, D, V = 2, 128, 512
    tree = TreeSpec(depth, branch)
    toks, ids, rows = _tree_ids(rng, B, V, tree)
    hn = rng.standard_normal((B * tree.num_nodes, D)).astype(np.float32)
    w = (rng.standard_normal((D, V)) * 0.05).astype(np.float32)
    want = np.asarray(jax_spec_head_logits(hn, w, ids))
    cols = spec_gather_ref(_t(w), _t(toks).reshape(-1))
    assert cols.shape == (B * tree.num_nodes, D)
    got = spec_dot_ref(_t(hn), cols, _t(rows))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    K.reset_launches()
    cols_w = sh.spec_head_gather(_t(w), _t(toks).reshape(-1))
    assert torch.equal(cols_w, cols)
    assert torch.equal(sh.spec_head_dot(_t(hn), cols_w, _t(rows)), got)
    np.testing.assert_allclose(
        sh.spec_head_logits(_t(hn), _t(w), _t(ids)).numpy(), want, **TOL)
    assert all(v == 0 for v in K.LAUNCHES.values())        # CPU: plain


def test_gather_is_an_exact_clamped_copy():
    """The gather copies columns exactly, in the head's dtype, with ids
    clamped to [0, V) as the kernel clamps them."""
    rng = np.random.default_rng(3)
    D, V = 64, 300
    for dtype in (torch.float32, torch.bfloat16):
        w = _t(rng.standard_normal((D, V)).astype(np.float32)).to(dtype)
        ids = torch.tensor([-3, V + 5, 7, 7, 0, V - 1], dtype=torch.int32)
        cols = spec_gather_ref(w, ids)
        assert cols.dtype == dtype and cols.is_contiguous()
        want = torch.stack([w[:, j] for j in (0, V - 1, 7, 7, 0, V - 1)])
        assert torch.equal(cols, want)


@pytest.mark.parametrize("D", [128, 98, 4096])
def test_dot_kernel_order_matches_jax(D):
    """The emulated kernel order against JAX's spec head on tree-shaped ids
    in fp32: 16-byte chunks (D = 128, 4096: one and 32 chunks a lane) and
    the element path (D = 98)."""
    rng = np.random.default_rng(D)
    B, V = 2, 700
    tree = TreeSpec(2, 3)
    toks, ids, rows = _tree_ids(rng, B, V, tree)
    hn = rng.standard_normal((B * tree.num_nodes, D)).astype(np.float32)
    w = (rng.standard_normal((D, V)) * 0.05).astype(np.float32)
    want = np.asarray(jax_spec_head_logits(hn, w, ids))
    cols = spec_gather_ref(_t(w), _t(toks).reshape(-1))
    got = _dot_emulated(_t(hn), cols, _t(rows))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(
        got.numpy(), spec_dot_ref(_t(hn), cols, _t(rows)).numpy(), **TOL)


def test_dot_kernel_order_bf16():
    """bf16 operands (8 elements a chunk; every product exact in fp32):
    the emulated order against the plain dot on the same bf16 inputs."""
    rng = np.random.default_rng(11)
    B, D, V = 2, 256, 512
    tree = TreeSpec(3, 3)
    toks, _, rows = _tree_ids(rng, B, V, tree)
    hn = _t(rng.standard_normal((B * tree.num_nodes, D)).astype(
        np.float32)).bfloat16()
    w = _t((rng.standard_normal((D, V)) * 0.05).astype(
        np.float32)).bfloat16()
    cols = spec_gather_ref(w, _t(toks).reshape(-1))
    np.testing.assert_allclose(
        _dot_emulated(hn, cols, _t(rows)).numpy(),
        spec_dot_ref(hn, cols, _t(rows)).numpy(), **TOL)


def test_tree_step_gathers_once_per_step(monkeypatch):
    """With the spec-head kernel flag, ``tree_decode_step`` gathers the
    node tokens' columns once per step when any exit point runs the gate
    (whatever the number of exit points that dot with them), and not at
    all in a step where no exit point is active."""
    calls = {"gather": 0, "dot": 0}

    def counted(name, fn):
        def wrapper(*args):
            calls[name] += 1
            return fn(*args)
        return wrapper

    monkeypatch.setattr(sh, "spec_gather_ref",
                        counted("gather", spec_gather_ref))
    monkeypatch.setattr(sh, "spec_dot_ref", counted("dot", spec_dot_ref))
    run = get_config("llama2-7b").smoke()
    model = build_model(run, ModelFlags(spec_head_kernel=True))
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, "cpu")
    sw = teng.init_specee(model, gen, "cpu")
    tree = TreeSpec(2, 3)
    prompts = torch.as_tensor(np.random.default_rng(4).integers(
        0, 512, (2, 8)), dtype=torch.int32)
    _, state = teng.init_tree_decode_state(model, params, sw,
                                           {"tokens": prompts}, 32, tree)
    K.reset_launches()
    # no exit point active: an empty schedule queue and no offline point
    quiet = sw._replace(offline_mask=torch.zeros_like(sw.offline_mask))
    _, _, _, info = teng.tree_decode_step(model, params, quiet, state, tree,
                                          threshold=1.5)
    assert calls == {"gather": 0, "dot": 0}
    assert info.units_run == model.num_exit_points
    # every exit point active, none exits: one gather, a dot per point
    _, _, state, info = teng.tree_decode_step(model, params, sw, state, tree,
                                              threshold=1.5)
    assert info.units_run == model.num_exit_points >= 2
    assert calls == {"gather": 1, "dot": info.units_run}
    # every row exits at the first point: one gather, one dot
    _, _, _, info = teng.tree_decode_step(model, params, sw, state, tree,
                                          threshold=-0.1)
    assert info.units_run == 1
    assert calls == {"gather": 2, "dot": model.num_exit_points + 1}
    assert all(v == 0 for v in K.LAUNCHES.values())        # CPU: plain
