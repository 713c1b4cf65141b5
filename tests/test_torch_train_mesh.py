"""Training under a ``(DATA, MODEL)`` mesh at ``fsdp_tp`` against the JAX
package's UNSHARDED training (CPU, fp32; weights bridged from JAX; every
mesh slot on the CPU, ``make_host_mesh(D, P, "cpu")``).

``make_train_step(param_pspec=)`` and ``Model.train_loss_rows`` on
llama2-7b at (2, 2), (1, 2) and (2, 1); ``TrainLoop(mesh=)`` over three
steps; a MoE config with expert parallelism (its aux loss the whole
batch's), ``moe_ep_quant`` against JAX run under a (1, 1) ("data",
"model") mesh with ``act_batch_axes="data"`` (so JAX's quantization
runs), ``moe_bf16_reduce`` and ``matmul_bf16_reduce``; mamba2-130m (the
head-aligned SSD leaves and the tied head) at (2, 2); recurrentgemma-9b's
one KV head held by four shards at (1, 4); hubert-xlarge's masked loss
with unequal masks across the rows at (2, 1); checkpoints saved at
(2, 2) and restored at (1, 2) and (1, 1), and the launcher's elastic
restart.

Tolerances: loss rtol 1e-5 and gradients at ``test_torch_train.py``'s
GTOL (rtol 1e-4, atol 1e-6: fp32, the shards' partial sums and the
rows' reduce-scatters change the summation order; recurrentgemma-9b's at
``test_torch_rglru.py``'s atol = rtol = 1e-5, the scan's); TrainLoop
losses rtol 1e-4 and params atol steps * lr. Under the bf16 flags the
port at (1, 1) computes JAX's fp32 sum rounded to bf16 once and its loss
holds at rtol 1e-5; at (2, 2) each shard's and each row's partial is
rounded to bf16 and the partials add in bf16, so the loss is held at
rtol 5e-4 (an eighth of a bf16 spacing). The gradients are held at
BF16_GTOL on both meshes: rtol 1e-2, and an atol of 4 bf16 spacings
(4 * 2^-8) of the leaf's largest gradient, since JAX rounds the backward
products to bf16 as well and another fp32 summation order can move a
rounded cotangent by a bf16 spacing, which the layers below add up. The
largest differences over that scale are printed. Checkpoints restore
bit-equal."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data import DataPipeline as JPipeline  # noqa: E402
from repro.models.model import ModelFlags as JFlags  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro.train import TrainLoop as JTrainLoop  # noqa: E402
from repro.train import make_train_step as j_make_train_step  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_unflatten  # noqa
from repro_torch.models.model import ModelFlags, build_model  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.runtime import collectives  # noqa: E402
from repro_torch.sharding.ctx import DataShards, Shards  # noqa: E402
from repro_torch.sharding.policies import named  # noqa: E402
from repro_torch.sharding.training import TrainMesh  # noqa: E402
from repro_torch.train import TrainLoop, make_train_step  # noqa: E402

GTOL = dict(rtol=1e-4, atol=1e-6)
BF16_GTOL = dict(rtol=1e-2, spacings=4)
BLOCK_GTOL = dict(rtol=1e-4, atol=1e-5)
RG_TOL = dict(rtol=1e-5, atol=1e-5)     # tests/test_torch_rglru.py's


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The smoke config's ops are tiny: one intra-op thread, so that the
    test run's parallel workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_BUILT = {}


def _pair(arch, **flags):
    """(JAX run, model, params; port run, model, params) of ``arch``'s
    smoke config with ``flags`` on both sides, the port's weights bridged
    from JAX's; memoized."""
    key = (arch, tuple(sorted(flags.items())))
    if key not in _BUILT:
        run_j, run_t = jax_get_config(arch).smoke(), get_config(arch).smoke()
        m_j = jbuild(run_j, JFlags(**flags))
        params_j = m_j.init(jax.random.PRNGKey(0))
        params_t = bridge.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, params_j), "cpu",
            torch.float32)
        _BUILT[key] = (run_j, m_j, params_j, run_t,
                       build_model(run_t, ModelFlags(**flags)), params_t)
    return _BUILT[key]


def _batch(run, B=4, S=16, seed=5):
    """A seeded batch of the config's kind (numpy): tokens, or hubert's
    frames, targets and a mask whose density differs across the rows."""
    cfg = run.model
    if cfg.frontend != "audio_frames":
        return {"tokens": JPipeline(cfg, B, S, seed=seed).next()["tokens"]}
    rng = np.random.default_rng(seed)
    b = JPipeline(cfg, B, S, seed=seed).next()
    dens = np.linspace(0.1, 0.9, B)[:, None]
    b["mask"] = (rng.random((B, S)) < dens).astype(b["mask"].dtype)
    return b


def _pairs(a, b, path=""):
    """(path, port leaf, JAX leaf) over two nests of the same keys."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            yield from _pairs(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _pairs(x, y, f"{path}/{i}")
    else:
        yield path, a.detach().numpy(), np.asarray(b)


def _jax_grads(m_j, params_j, batch, mesh=None):
    fn = jax.jit(jax.value_and_grad(m_j.train_loss, has_aux=True))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if mesh is None:
        (loss, _), g = fn(params_j, jb)
    else:
        with mesh:
            (loss, _), g = fn(params_j, jb)
    return float(loss), g


def _mesh_grads(model, params, batch, D, P):
    """The port's loss and whole gradients over a (D, P) mesh, through
    ``train_loss_rows`` and the copies' all-reduce, as the step takes
    them."""
    tm = TrainMesh(model, make_host_mesh(D, P, "cpu"))
    placed = tm.place(params, tm.specs(params))
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(placed)]
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    loss, _ = model.train_loss_rows(tree_unflatten(placed, leaves),
                                    tm.split_batch(batch), tm)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)]
    grads = tm.reduce_grads(tree_unflatten(placed, grads))
    return float(loss.detach()), tm.unplace(grads, "cpu")


def _check_grads(g_t, g_j, tol=GTOL):
    """Every gradient leaf within ``tol``; BF16_GTOL's atol is in bf16
    spacings (2^-8 relative) of the leaf's largest |JAX gradient|.
    Returns the largest |diff| over that scale."""
    worst = 0.0
    for path, a, b in _pairs(g_t, g_j):
        scale = max(float(np.abs(b).max()), 1e-30)
        worst = max(worst, float(np.abs(a - b).max()) / scale)
        if "spacings" in tol:
            np.testing.assert_allclose(
                a, b, rtol=tol["rtol"], err_msg=path,
                atol=tol["spacings"] * 2.0 ** -8 * scale)
        else:
            np.testing.assert_allclose(a, b, err_msg=path, **tol)
    return worst


def _data_leaves(tree):
    """The ``DataShards`` leaves of a placed nest."""
    if isinstance(tree, DataShards):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _data_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _data_leaves(v)]
    return []


# ----------------------------- llama2-7b ---------------------------------
@pytest.mark.parametrize("D,P", [(2, 2), (1, 2), (2, 1)])
def test_llama_mesh_step_matches_jax(D, P):
    """Loss and gradients over the mesh against ``jax.value_and_grad`` of
    the unsharded loss; then ``make_train_step`` at the microbatch JAX's
    ``step_fn_for`` picks (``max(B // 16, D)``) against JAX's unsharded
    ``make_train_step`` at the same microbatch: loss, grad norm, params.
    Under remat the units' gathers run again in the recompute."""
    run_j, m_j, params_j, run_t, model, params = _pair("llama2-7b")
    batch = _batch(run_t)
    loss_j, g_j = _jax_grads(m_j, params_j, batch)
    loss_t, g_t = _mesh_grads(model, params, batch, D, P)
    assert loss_t == pytest.approx(loss_j, rel=1e-5)
    _check_grads(g_t, g_j)

    mb = max(4 // 16, D)
    cfg_j = dataclasses.replace(run_j.train, microbatch=mb)
    cfg_t = dataclasses.replace(run_t.train, microbatch=mb)
    pj, oj, sj = jax.jit(j_make_train_step(m_j, cfg_j))(
        params_j, j_adamw_init(params_j),
        {k: jnp.asarray(v) for k, v in batch.items()})
    mesh = make_host_mesh(D, P, "cpu")
    tm = TrainMesh(model, mesh)
    specs = tm.specs(params)
    placed = tm.place(params, specs)
    step = make_train_step(model, cfg_t, param_pspec=named(mesh, specs))
    collectives.reset_counts()
    pt, ot, st = step(placed, adamw_init(placed),
                      {k: torch.from_numpy(v) for k, v in batch.items()})
    counts = {k: dict(v) for k, v in collectives.COUNTS.items()}
    assert float(st["loss"]) == pytest.approx(float(sj["loss"]), rel=1e-5)
    assert float(st["grad_norm"]) == pytest.approx(float(sj["grad_norm"]),
                                                   rel=1e-5)
    for path, a, b in _pairs(tm.unplace(pt, "cpu"), pj):
        np.testing.assert_allclose(a, b, atol=1e-6, err_msg=path)
    if D == 1:
        assert all(c["calls"] == 0 for c in counts.values()), counts
        return
    # every gather's backward is one reduce-scatter; the copies' grads
    # and the loss's sums are all-reduced
    assert counts["all-gather"]["calls"] == \
        counts["reduce-scatter"]["calls"] > 0, counts
    assert counts["all-reduce"]["calls"] > 0, counts
    remat = build_model(run_t, ModelFlags(remat="full"))
    step_r = make_train_step(remat, cfg_t, param_pspec=named(mesh, specs))
    collectives.reset_counts()
    pr, _, sr = step_r(placed, adamw_init(placed),
                       {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(sr["loss"]) == float(st["loss"])
    assert collectives.COUNTS["all-gather"]["calls"] > \
        counts["all-gather"]["calls"]
    for a, b in zip(tree_leaves(pr), tree_leaves(pt)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)


def test_llama_train_loop_at_2x2_matches_jax():
    """``TrainLoop(mesh=)`` at (2, 2), three steps against JAX's
    ``TrainLoop``: losses, learning rates and params; the copies of the
    leaves replicated over 'data' stay bit-equal."""
    run_j, m_j, params_j, run_t, model, params = _pair("llama2-7b")
    loop_j = JTrainLoop(m_j, run_j, params_j)
    loop_t = TrainLoop(model, run_t, params,
                       mesh=make_host_mesh(2, 2, "cpu"))
    steps = 3
    lj = [loop_j.run_steps(1)["loss"] for _ in range(steps)]
    lt = [loop_t.run_steps(1)["loss"] for _ in range(steps)]
    np.testing.assert_allclose(lt, lj, rtol=1e-4)
    assert [h["lr"] for h in loop_t.history] == pytest.approx(
        [h["lr"] for h in loop_j.history], rel=1e-6)
    atol = steps * run_t.train.learning_rate
    whole = loop_t.whole("cpu")["params"]
    for path, a, b in _pairs(whole, loop_j.params):
        np.testing.assert_allclose(a, b, atol=atol, err_msg=path)
    copies = 0
    for leaf in _data_leaves(loop_t.params):
        if leaf.dim is None:
            copies += 1
            for e in leaf[1:]:
                for x, y in zip(tree_leaves(e), tree_leaves(leaf[0])):
                    assert torch.equal(x, y)
    assert copies > 0


def test_placement_is_jax_fsdp_tp_layout():
    """Each piece of a placed leaf is the block JAX's ``fsdp_tp`` spec
    gives its device: rows cut the 'data' dim, shards the 'model' dim."""
    _, _, _, run_t, model, params = _pair("llama2-7b")
    tm = TrainMesh(model, make_host_mesh(2, 2, "cpu"))
    specs = tm.specs(params)
    placed = tm.place(params, specs)
    wq = placed["segments"][0]["u0"]["attn"]["wq"]["w"]
    whole = params["segments"][0]["u0"]["attn"]["wq"]["w"]
    assert tuple(specs["segments"][0]["u0"]["attn"]["wq"]["w"]) == \
        (None, "data", "model")
    assert isinstance(wq, DataShards) and wq.dim == -2
    R, Din, Dout = whole.shape
    for d in range(2):
        assert isinstance(wq[d], Shards)
        for m in range(2):
            torch.testing.assert_close(
                wq[d][m], whole[:, d * Din // 2:(d + 1) * Din // 2,
                                m * Dout // 2:(m + 1) * Dout // 2],
                rtol=0, atol=0)
    norm = placed["final_norm"]["scale"]
    assert norm.dim is None and len(norm) == 2      # a copy per row
    for path, a, b in _pairs(tm.unplace(placed, "cpu"),
                             jax.tree_util.tree_map(np.asarray, params)):
        np.testing.assert_array_equal(a, b, err_msg=path)


# ------------------------------- MoE -------------------------------------
MOE = "qwen3-moe-235b-a22b"


def test_moe_expert_parallel_matches_jax():
    """The dense form at (2, 2): each row's local experts (E / 2) over
    both rows' gathered tokens, the outputs reduce-scattered; the loss
    with its aux term (the whole batch's routed fractions) and the
    gradients against JAX's unsharded; (2, 1) too. No expert stack is
    gathered over 'data'; the tokens are."""
    run_j, m_j, params_j, run_t, model, params = _pair(MOE)
    batch = _batch(run_t)
    loss_j, g_j = _jax_grads(m_j, params_j, batch)
    for D, P in ((2, 2), (2, 1)):
        collectives.reset_counts()
        loss_t, g_t = _mesh_grads(model, params, batch, D, P)
        assert loss_t == pytest.approx(loss_j, rel=1e-5), (D, P)
        _check_grads(g_t, g_j)
    # the aux loss is not the mean of the rows' aux losses
    tm = TrainMesh(model, make_host_mesh(2, 1, "cpu"))
    placed = tm.place(params, tm.specs(params))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        _, parts = model.train_loss_rows(placed, tm.split_batch(tb), tm)
        _, whole = model.train_loss(params, tb)
        rows = [model.train_loss(params, {"tokens": t})[1]["aux"]
                for t in tb["tokens"].split(2)]
    assert float(parts["aux"]) == pytest.approx(float(whole["aux"]),
                                                rel=1e-5)
    assert float(parts["aux"]) != pytest.approx(float(sum(rows)) / 2,
                                                rel=1e-5)


def _jax_mesh11():
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _unit0(tree):
    """Unit 0 of segment 0's MoE params (either package's)."""
    return jax.tree_util.tree_map(lambda x: x[0],
                                  tree["segments"][0]["u0"]["moe"])


def test_moe_ep_quant_matches_jax_under_a_mesh():
    """``moe_ep_quant`` with ``act_batch_axes="data"``, JAX in-process
    under a (1, 1) ("data", "model") mesh, so its ``_ep_quantized_gather``
    runs. The block: on the same input the port's codes are JAX's, so
    ``apply_moe`` on one row and ``apply_moe_rows`` over two rows with
    expert parallelism (the codes and scales gathered) hold to JAX's
    output and aux loss at the fp32 tolerances and its gradients (of order
    1: the output is weighted by N(0, 1) numbers) at rtol 1e-4, atol 1e-5.
    The model at
    (1, 1) and (2, 2): the loss at rtol 1e-5, the gradients at
    BF16_GTOL, since a code of a later layer can round the other way
    after an ulp's difference upstream and then moves that token's
    expert input by a whole quantization step (amax / 127). Without
    ``act_batch_axes`` neither package quantizes."""
    from repro.models import moe as jmoe
    from repro_torch.models import moe
    flags = dict(moe_ep_quant=True, act_batch_axes="data")
    run_j, m_j, params_j, run_t, model, params = _pair(MOE, **flags)
    cfg_j, cfg_t = run_j.model, run_t.model
    x = np.random.default_rng(3).standard_normal((4, 8, cfg_t.d_model)
                                                 ).astype(np.float32)
    r = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        out, aux = jmoe.apply_moe(cfg_j, p, xx, ep_axes="data", ep_extent=1,
                                  ep_quant=True)
        return jnp.sum(out * r) + aux, out

    with _jax_mesh11():
        (_, out_j), (gp_j, gx_j) = jax.jit(jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True))(_unit0(params_j),
                                                  jnp.asarray(x))
    p1 = jax.tree_util.tree_map(lambda t: t.detach().requires_grad_(True),
                                _unit0(params))
    E = cfg_t.moe.num_experts
    for D in (1, 2):
        xt = torch.from_numpy(x).requires_grad_(True)
        rows = [dict(p1, **{k: p1[k][d * E // D:(d + 1) * E // D]
                            for k in ("wi", "wg", "wo") if k in p1})
                for d in range(D)]
        outs, aux = moe.apply_moe_rows(cfg_t, rows, list(xt.split(4 // D)),
                                       ep_quant=True)
        out = torch.cat(outs)
        loss = (out * torch.from_numpy(r)).sum() + aux
        gs = torch.autograd.grad(loss, [xt] + tree_leaves(p1))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(gs[0].numpy(), np.asarray(gx_j),
                                   **BLOCK_GTOL)
        for path, a, b in _pairs(tree_unflatten(p1, gs[1:]), gp_j):
            np.testing.assert_allclose(a, b, err_msg=path, **BLOCK_GTOL)

    batch = _batch(run_t)
    loss_j, g_j = _jax_grads(m_j, params_j, batch, mesh=_jax_mesh11())
    for D, P in ((1, 1), (2, 2)):
        loss_t, g_t = _mesh_grads(model, params, batch, D, P)
        assert loss_t == pytest.approx(loss_j, rel=1e-5), (D, P)
        worst = _check_grads(g_t, g_j, BF16_GTOL)
        print(f"ep_quant at ({D}, {P}): loss rel diff "
              f"{abs(loss_t - loss_j) / abs(loss_j):.2e}, largest grad "
              f"diff {worst:.2e} of the leaf's largest")
    plain = _pair(MOE)[4]
    loss_p, _ = _mesh_grads(plain, params, batch, 1, 1)
    assert loss_p != pytest.approx(loss_j, rel=1e-6)
    off = build_model(run_t, ModelFlags(moe_ep_quant=True))
    assert _mesh_grads(off, params, batch, 1, 1)[0] == loss_p


@pytest.mark.parametrize("arch,flag", [(MOE, "moe_bf16_reduce"),
                                       ("llama2-7b", "matmul_bf16_reduce")])
def test_bf16_reduce_flags_match_jax(arch, flag):
    """The loss at (1, 1) at rtol 1e-5 (the same fp32 sum rounded to bf16
    once) and at (2, 2), each shard's and row's partial rounded to bf16
    and the partials added in bf16, at rtol 5e-4 (an eighth of a bf16
    spacing). The gradients at
    BF16_GTOL on both: JAX's transpose rule rounds the backward products
    to bf16 too, so one fp32 ulp of another summation order can move a
    gradient by a bf16 spacing. The largest differences printed."""
    run_j, m_j, params_j, run_t, model, params = _pair(arch, **{flag: True})
    batch = _batch(run_t)
    loss_j, g_j = _jax_grads(m_j, params_j, batch)
    for (D, P), rel in (((1, 1), 1e-5), ((2, 2), 5e-4)):
        loss_t, g_t = _mesh_grads(model, params, batch, D, P)
        assert loss_t == pytest.approx(loss_j, rel=rel), (D, P)
        worst = _check_grads(g_t, g_j, BF16_GTOL)
        print(f"{flag} at ({D}, {P}): loss rel diff "
              f"{abs(loss_t - loss_j) / abs(loss_j):.2e}, largest grad "
              f"diff {worst:.2e} of the leaf's largest")


# ------------------------- the other families ----------------------------
@pytest.mark.parametrize("arch,D,P", [("mamba2-130m", 2, 2),
                                      ("recurrentgemma-9b", 1, 4),
                                      ("hubert-xlarge", 2, 1)])
def test_family_mesh_grads_match_jax(arch, D, P):
    """mamba2-130m at (2, 2): each shard's whole SSD heads with B and C
    (and the conv's B/C channels) whole on both shards, and the tied
    head, its gradients the sum of their copies'; recurrentgemma-9b at
    (1, 4): one KV head held by four shards; hubert-xlarge at (2, 1):
    the masked loss with unequal masks across the rows, weighted by the
    rows' mask counts."""
    run_j, m_j, params_j, run_t, model, params = _pair(arch)
    batch = _batch(run_t)
    if arch == "hubert-xlarge":
        halves = batch["mask"].reshape(D, -1).sum(axis=1)
        assert halves[0] != halves[1]
    loss_j, g_j = _jax_grads(m_j, params_j, batch)
    loss_t, g_t = _mesh_grads(model, params, batch, D, P)
    assert loss_t == pytest.approx(loss_j, rel=1e-5)
    _check_grads(g_t, g_j, RG_TOL if arch == "recurrentgemma-9b" else GTOL)


# ---------------------------- checkpoints --------------------------------
def test_checkpoint_restores_across_meshes(tmp_path):
    """A ``TrainLoop`` saved at (2, 2) restores at (1, 2) and without a
    mesh, params and AdamW state bit-equal once gathered, and the step
    and the pipeline's position with them; a (1, 1)-saved run restores
    at (2, 2). The files hold whole tensors (JAX's layout): the same
    manifest as the gathered tree's."""
    _, _, _, run_t, model, params = _pair("llama2-7b")
    ck = str(tmp_path / "ck")
    a = TrainLoop(model, run_t, params, ckpt_dir=ck,
                  mesh=make_host_mesh(2, 2, "cpu"))
    a.run_steps(2)
    a.save()
    a.ckpt.wait()
    want = a.whole("cpu")
    for mesh in (make_host_mesh(1, 2, "cpu"), None):
        b = TrainLoop(model, run_t, params, ckpt_dir=ck, mesh=mesh)
        assert b.try_restore() and b.step == 2
        got = b.whole("cpu")
        for x, y in zip(tree_leaves(got), tree_leaves(want)):
            assert x.shape == y.shape and torch.equal(x, y)
        assert b.pipeline.state_dict() == a.pipeline.state_dict()
    # the files are the whole tree's: the same keys, shapes and dtypes as
    # a checkpoint of the gathered tree, whatever the mesh
    from repro_torch.checkpoint import CheckpointManager
    plain = CheckpointManager(str(tmp_path / "whole"), async_save=False)
    plain.save(2, want)
    for root in (ck, str(tmp_path / "whole")):
        with open(f"{root}/step_000000002/manifest.json") as f:
            man = json.load(f)["leaves"]
        if root == ck:
            placed_man = [(m["key"], m["shape"], m["torch_dtype"])
                          for m in man]
    assert placed_man == [(m["key"], m["shape"], m["torch_dtype"])
                          for m in man]
    ck2 = str(tmp_path / "ck2")
    c = TrainLoop(model, run_t, params, ckpt_dir=ck2)
    c.run_steps(1)
    c.save()
    c.ckpt.wait()
    d = TrainLoop(model, run_t, params, ckpt_dir=ck2,
                  mesh=make_host_mesh(2, 2, "cpu"))
    assert d.try_restore() and d.step == 1
    for x, y in zip(tree_leaves(d.whole("cpu")), tree_leaves(c.whole())):
        assert torch.equal(x, y)


def test_launcher_trains_on_a_mesh_and_restarts_elastically(tmp_path,
                                                            capsys):
    """``--data 2 --model 2`` trains on a (2, 2) mesh at fsdp_tp and saves;
    a restart at ``--data 1 --model 2`` (``plan_remesh``'s smaller mesh)
    resumes from its last step."""
    ck = str(tmp_path / "ck")
    base = ["--arch", "llama2-7b", "--smoke", "--device", "cpu", "--ckpt",
            ck, "--steps"]
    launch_train.main(base + ["2", "--data", "2", "--model", "2"])
    launch_train.main(base + ["3", "--data", "1", "--model", "2"])
    out = capsys.readouterr().out
    assert "mesh=(2, 2)" in out and "mesh=(1, 2)" in out
    assert "[launch] restored step 2" in out and "step=3" in out


def test_ssd_chunk_gradient_is_finite_where_the_decay_overflows():
    """``ssd_chunk_ref`` masks the decay's exponent before the exp: above
    the diagonal ``cum[t] - cum[s]`` is positive and overflows past ~88
    (mamba2-130m at published size, 256-token chunks), and an exp taken
    first gives its masked zero gradient times inf. The forward equals
    JAX's ``ssd_chunk_ref``; the gradient is finite where JAX's is
    NaN."""
    from repro.kernels.ssd_chunk.ref import ssd_chunk_ref as j_ref
    from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref
    rng = np.random.default_rng(9)
    c, nh, hd, ds = 64, 2, 4, 8
    xdt = rng.standard_normal((1, c, nh, hd)).astype(np.float32)
    cum = -np.cumsum(np.full((1, c, nh), 2.5, np.float32), axis=1)
    Bc = rng.standard_normal((1, c, ds)).astype(np.float32)
    Cc = rng.standard_normal((1, c, ds)).astype(np.float32)
    assert -cum.min() > 88                      # exp(-cum) overflows
    args = [torch.from_numpy(a).requires_grad_(True)
            for a in (xdt, cum, Bc, Cc)]
    y = ssd_chunk_ref(*args)
    want = j_ref(*map(jnp.asarray, (xdt, cum, Bc, Cc)))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    grads = torch.autograd.grad(y.sum(), args)
    assert all(torch.isfinite(g).all() for g in grads)
    g_j = jax.grad(lambda cm: j_ref(jnp.asarray(xdt), cm, jnp.asarray(Bc),
                                    jnp.asarray(Cc)).sum())(jnp.asarray(cum))
    assert np.isnan(np.asarray(g_j)).any()
