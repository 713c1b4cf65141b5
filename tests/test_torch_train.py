"""The port's training path against the JAX package (fp32, CPU): the LR
schedules, AdamW, the synthetic data pipeline, ``Model.train_loss`` and its
gradients (llama2-7b and mamba2-130m smoke configs, JAX's params bridged
in), remat, the chunked CE, ``TrainLoop`` and gradient accumulation, and
the refusals of what is not ported (the multi-host flags).

Tolerances: schedules rtol 1e-6; AdamW atol 1e-6; tokens bit-identical;
loss rtol 1e-5, gradients rtol 1e-4 with atol 1e-6 (fp32, another
summation order); ``TrainLoop`` losses rtol 1e-4 and params atol
steps * lr (Adam divides by sqrt(v), so an element whose gradient is
float noise can move by up to lr a step either way)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data import DataPipeline as JPipeline  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro.optim import adamw_update as j_adamw_update  # noqa: E402
from repro.optim import make_schedule as j_make_schedule  # noqa: E402
from repro.optim.adamw import clip_by_global_norm as j_clip  # noqa: E402
from repro.train import TrainLoop as JTrainLoop  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import TrainConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataPipeline  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_unflatten  # noqa
from repro_torch.models.model import ModelFlags, build_model  # noqa: E402
from repro_torch.optim import adamw_init, adamw_update  # noqa: E402
from repro_torch.optim import make_schedule  # noqa: E402
from repro_torch.optim.adamw import clip_by_global_norm  # noqa: E402
from repro_torch.train import TrainLoop, make_train_step  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The smoke config's ops are tiny: one intra-op thread, so that the
    test run's parallel workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GTOL = dict(rtol=1e-4, atol=1e-6)


def _to_torch(tree):
    return bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                                    "cpu", torch.float32)


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


def _port_grads(model, params, batch):
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    loss, aux = model.train_loss(tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(params, grads)


@pytest.fixture(scope="module")
def llama():
    run_j = jax_get_config("llama2-7b").smoke()
    m_j = jbuild(run_j)
    params_j = m_j.init(jax.random.PRNGKey(0))
    run_t = get_config("llama2-7b").smoke()
    return run_j, m_j, params_j, run_t, _to_torch(params_j)


def test_train_config_matches_jax():
    for name in ("llama2-7b", "mamba2-130m"):
        for smoke in (False, True):
            j, t = jax_get_config(name), get_config(name)
            if smoke:
                j, t = j.smoke(), t.smoke()
            for f in dataclasses.fields(TrainConfig):
                assert getattr(t.train, f.name) == getattr(j.train, f.name), \
                    f.name
            assert t.specee.offline_top_frac == j.specee.offline_top_frac
            assert t.model.param_count() == j.model.param_count()
    assert {f.name for f in dataclasses.fields(TrainConfig)} == \
        {f.name for f in dataclasses.fields(JTrainConfig)}


@pytest.mark.parametrize("name", ["cosine", "wsd", "constant"])
def test_schedule_matches_jax(name):
    base = get_config("llama2-7b").train
    cfg = dataclasses.replace(base, schedule=name, steps=100,
                              warmup_steps=10, learning_rate=1e-3)
    s, sj = make_schedule(cfg), j_make_schedule(
        dataclasses.replace(jax_get_config("llama2-7b").train, schedule=name,
                            steps=100, warmup_steps=10, learning_rate=1e-3))
    want = np.array([float(sj(i)) for i in range(101)])
    got = np.array([s(i) for i in range(101)])
    got_t = np.array([float(s(torch.tensor(i, dtype=torch.int32)))
                      for i in range(101)])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got_t, want, rtol=1e-6)
    # JAX's test_schedules assertions, on the port
    assert s(0) == 0.0 or s(0) < 1e-3
    assert s(10) == pytest.approx(1e-3, rel=0.01)
    if name == "wsd":
        assert s(50) == pytest.approx(1e-3, rel=0.01)
        assert s(99) < 0.5e-3
    if name == "cosine":
        assert s(99) < s(40)


@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_adamw_matches_jax(clip):
    rng = np.random.default_rng(3)
    shapes = {"a": {"w": (8, 16), "b": (16,)}, "z": [(5, 3), (7,)]}

    def draw(scale):
        return {"a": {k: (rng.standard_normal(v) * scale).astype(np.float32)
                      for k, v in shapes["a"].items()},
                "z": [(rng.standard_normal(v) * scale).astype(np.float32)
                      for v in shapes["z"]]}

    params, g1, g2 = draw(1.0), draw(3.0), draw(0.5)
    cfg = dataclasses.replace(get_config("llama2-7b").train, grad_clip=clip)
    cfg_j = dataclasses.replace(jax_get_config("llama2-7b").train,
                                grad_clip=clip)
    p_t, st_t = _to_torch(params), adamw_init(_to_torch(params))
    p_j = jax.tree_util.tree_map(jnp.asarray, params)
    st_j = j_adamw_init(p_j)
    for g, lr in ((g1, 1e-2), (g2, 3e-3)):
        p_t, st_t, stats_t = adamw_update(cfg, p_t, _to_torch(g), st_t,
                                          torch.tensor(lr))
        p_j, st_j, stats_j = j_adamw_update(
            cfg_j, p_j, jax.tree_util.tree_map(jnp.asarray, g), st_j,
            jnp.float32(lr))
        assert float(stats_t["grad_norm"]) == pytest.approx(
            float(stats_j["grad_norm"]), rel=1e-6)
    assert int(st_t.step) == int(st_j.step) == 2
    for tree_t, tree_j in ((p_t, p_j), (st_t.m, st_j.m), (st_t.v, st_j.v)):
        for path, a, b in _pairs(tree_t, tree_j):
            np.testing.assert_allclose(a, b, atol=1e-6, err_msg=path)
    assert all(x.dtype == torch.float32 for x in tree_leaves(st_t.m))
    clipped, norm = clip_by_global_norm(_to_torch(g1), 1.0)
    clipped_j, norm_j = j_clip(jax.tree_util.tree_map(jnp.asarray, g1), 1.0)
    assert float(norm) == pytest.approx(float(norm_j), rel=1e-6)
    for path, a, b in _pairs(clipped, clipped_j):
        np.testing.assert_allclose(a, b, atol=1e-6, err_msg=path)
    # params come back in their own dtype; m and v stay fp32
    pb = {"w": torch.ones(4, 4, dtype=torch.bfloat16)}
    nb, sb, _ = adamw_update(cfg, pb, {"w": torch.ones(4, 4)},
                             adamw_init(pb), 1e-3)
    assert nb["w"].dtype == torch.bfloat16
    assert sb.m["w"].dtype == sb.v["w"].dtype == torch.float32


def test_pipeline_bit_identical_to_jax():
    cfg_t = get_config("llama2-7b").smoke().model
    cfg_j = jax_get_config("llama2-7b").smoke().model
    for seed in (0, 7):
        pt, pj = DataPipeline(cfg_t, 4, 32, seed=seed), JPipeline(
            cfg_j, 4, 32, seed=seed)
        for _ in range(4):
            a, b = pt.next()["tokens"], pj.next()["tokens"]
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        # resume: the port's saved state, in the port and in JAX
        state = pt.state_dict()
        want = pj.next()["tokens"]
        np.testing.assert_array_equal(
            DataPipeline.from_state(cfg_t, 4, 32, state).next()["tokens"],
            want)
        np.testing.assert_array_equal(pt.next()["tokens"], want)
    # the frontend configs' patches and frames come from the same stream
    for name in ("internvl2-26b", "hubert-xlarge"):
        cfg_t = get_config(name).smoke().model
        cfg_j = jax_get_config(name).smoke().model
        a = DataPipeline(cfg_t, 2, 16, seed=3).next()
        b = JPipeline(cfg_j, 2, 16, seed=3).next()
        assert list(a) == list(b)
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("name", ["llama2-7b", "mamba2-130m"])
def test_train_loss_and_grads_match_jax(name):
    run_j = jax_get_config(name).smoke()
    m_j = jbuild(run_j)
    params_j = m_j.init(jax.random.PRNGKey(1))
    tokens = JPipeline(run_j.model, 2, 24, seed=5).next()["tokens"]
    (loss_j, aux_j), g_j = jax.jit(jax.value_and_grad(
        m_j.train_loss, has_aux=True))(params_j, {"tokens": tokens})
    model = build_model(get_config(name).smoke())
    params = _to_torch(params_j)
    batch = {"tokens": torch.from_numpy(tokens)}
    loss_t, g_t = _port_grads(model, params, batch)
    assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-5)
    for path, a, b in _pairs(g_t, g_j):
        np.testing.assert_allclose(a, b, err_msg=path, **GTOL)
    # remat="full" recomputes each unit and gives the same gradients
    remat = build_model(get_config(name).smoke(), ModelFlags(remat="full"))
    loss_r, g_r = _port_grads(remat, params, batch)
    assert float(loss_r) == float(loss_t)
    for (path, a, _), (_, b, _) in zip(_pairs(g_r, g_j), _pairs(g_t, g_j)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-8, err_msg=path)


def test_chunked_ce_matches_direct_and_jax(llama):
    """Above S*V = 2^24 the CE runs over checkpointed chunks: against the
    direct formula in the port and against JAX's chunked scan, value and
    gradient with respect to h."""
    run_j, m_j, params_j, run_t, params = llama
    model = build_model(run_t, ModelFlags(ce_chunk=4096))
    B, S, D, V = 1, (1 << 24) // 512 + 100, run_t.model.d_model, 512
    assert S * V > (1 << 24) and S % 4096
    rng = np.random.default_rng(2)
    h_np = rng.standard_normal((B, S, D)).astype(np.float32)
    t_np = rng.integers(0, V, (B, S)).astype(np.int32)
    h = torch.from_numpy(h_np).requires_grad_(True)
    loss = model._ce_loss(params, h, torch.from_numpy(t_np), chunk=4096)
    (g_h,) = torch.autograd.grad(loss, h)
    hd = torch.from_numpy(h_np).requires_grad_(True)
    lse = torch.log_softmax(model.logits(params, hd), dim=-1)
    direct = -torch.gather(lse, -1, torch.from_numpy(t_np).long()[..., None]
                           ).mean()
    (g_d,) = torch.autograd.grad(direct, hd)
    loss, direct = float(loss.detach()), float(direct.detach())
    assert loss == pytest.approx(direct, rel=1e-5)
    np.testing.assert_allclose(g_h.numpy(), g_d.numpy(), **GTOL)
    lj, gj = jax.value_and_grad(
        lambda x: m_j._ce_loss(params_j, x, jnp.asarray(t_np), chunk=4096))(
            jnp.asarray(h_np))
    assert loss == pytest.approx(float(lj), rel=1e-5)
    np.testing.assert_allclose(g_h.numpy(), np.asarray(gj), **GTOL)


def test_train_loop_matches_jax(llama):
    run_j, m_j, params_j, run_t, params = llama
    loop_j = JTrainLoop(m_j, run_j, params_j)
    loop_t = TrainLoop(build_model(run_t), run_t, params)
    steps = 3
    lj = [loop_j.run_steps(1)["loss"] for _ in range(steps)]
    lt = [loop_t.run_steps(1)["loss"] for _ in range(steps)]
    np.testing.assert_allclose(lt, lj, rtol=1e-4)
    assert len(loop_t.history) == steps and loop_t.step == steps
    assert all(h["step_time"] > 0 for h in loop_t.history)
    assert [h["lr"] for h in loop_t.history] == pytest.approx(
        [h["lr"] for h in loop_j.history], rel=1e-6)
    atol = steps * run_t.train.learning_rate
    worst = 0.0
    for path, a, b in _pairs(loop_t.params, loop_j.params):
        worst = max(worst, float(np.abs(a - b).max()))
        np.testing.assert_allclose(a, b, atol=atol, err_msg=path)
    print(f"largest param diff after {steps} steps: {worst:.3e} "
          f"(atol {atol:.1e})")


def test_microbatch_matches_full_batch(llama):
    """JAX's test_grad_accumulation_matches_full_batch, on the port."""
    _, _, _, run_t, params = llama
    model = build_model(run_t)
    tokens = np.random.default_rng(1).integers(
        0, run_t.model.vocab_size, (8, 16)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tokens)}
    full = make_train_step(model, dataclasses.replace(run_t.train,
                                                      microbatch=0))
    acc = make_train_step(model, dataclasses.replace(run_t.train,
                                                     microbatch=2))
    p1, _, s1 = full(params, adamw_init(params), batch)
    p2, _, s2 = acc(params, adamw_init(params), batch)
    assert float(s1["loss"]) == pytest.approx(float(s2["loss"]), rel=1e-5)
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_loss_falls_over_eight_steps():
    """JAX's test_adamw_reduces_loss, on the port (seeded torch init)."""
    run = get_config("llama2-7b").smoke()
    model = build_model(run)
    loop = TrainLoop(model, run, model.init(0, "cpu"))
    losses = [loop.run_steps(1)["loss"] for _ in range(8)]
    assert losses[-1] < losses[0], losses


def test_refusals_name_their_roadmap_items(llama, tmp_path, capsys):
    """The multi-host flags are refused naming "multi-GPU"; the mesh
    flags ``--data`` and ``--model`` are taken (``tests/test_torch_train_
    mesh.py`` trains with them). ``TrainLoop(ckpt_dir=)`` and ``--ckpt``
    are taken as JAX takes them: a launch with ``--ckpt`` saves, and a
    second resumes from its last step."""
    _, _, _, run_t, params = llama
    loop = TrainLoop(build_model(run_t), run_t, params,
                     ckpt_dir=str(tmp_path / "loop"))
    assert loop.ckpt is not None and loop.try_restore() is False
    for argv in (["--coordinator", "h:1"], ["--num-hosts", "2"]):
        with pytest.raises(SystemExit, match="ROADMAP: multi-GPU"):
            launch_train.parse_args(["--arch", "llama2-7b"] + argv)
    for argv in (["--data", "2"], ["--model", "2"]):
        args = launch_train.parse_args(["--arch", "llama2-7b"] + argv)
        assert (args.data, args.model) == ((2, 1) if argv[0] == "--data"
                                           else (0, 2))
    args = launch_train.parse_args(["--arch", "llama2-7b", "--smoke"])
    assert args.device == "cuda"
    ck = str(tmp_path / "ck")
    base = ["--arch", "llama2-7b", "--smoke", "--device", "cpu", "--ckpt",
            ck, "--steps"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # tiny ops: spare the parallel workers
    try:
        launch_train.main(base + ["2"])
        launch_train.main(base + ["3"])
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    assert "[launch] restored step 2" in out and "step=3" in out


@pytest.mark.parametrize("flag", ["flash_attention", "ssd_kernel"])
def test_forward_hidden_raises_under_grad_with_kernel_flags(llama, flag):
    _, _, _, run_t, params = llama
    model = build_model(run_t, ModelFlags(**{flag: True}))
    batch = {"tokens": torch.zeros(1, 8, dtype=torch.int32)}
    with pytest.raises(ValueError, match="no backward"):
        _port_grads(model, params, batch)
    with torch.no_grad():                  # no gradient asked: it runs
        loss, _ = model.train_loss(params, batch)
    assert torch.isfinite(loss)
