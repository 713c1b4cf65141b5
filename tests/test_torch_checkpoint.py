"""The port's ``CheckpointManager``, session snapshots and ``TrainLoop``
restart against the JAX package (CPU; the llama2-7b smoke config, fp32).

Tolerance: restored tensors bit-equal (fp32, bf16, int32); session meta,
tokens and pipeline batches exact; the restarted loss within rel 1e-5 of
the uninterrupted one, JAX's own tolerance."""
import dataclasses
import json
import os
import typing

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import Engine as JEngine  # noqa: E402
from repro.checkpoint import CheckpointManager as JCheckpointManager  # noqa
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.train import TrainLoop as JTrainLoop  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.api import Engine  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.train import TrainLoop  # noqa: E402



@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The smoke config's ops are tiny: one intra-op thread, so that the
    test run's parallel workers do not oversubscribe the cores (spinning
    thread pools made these tests 20-50x slower under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

class Pair(typing.NamedTuple):
    step: torch.Tensor
    rest: typing.Any


def _tree(scale: int = 1):
    g = torch.Generator().manual_seed(scale)
    return {"a": torch.arange(10.0) * scale,
            "b": {"c": torch.randn(3, 4, generator=g).to(torch.bfloat16),
                  "d": (torch.arange(6, dtype=torch.int32).reshape(2, 3),
                        None)},
            "e": [Pair(torch.tensor(scale, dtype=torch.int32),
                       {"f": 0.5, "prng": 7 * scale})]}


def _leaves_equal(a, b):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype
        assert torch.equal(a, b)
        return
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _leaves_equal(a[k], b[k])
        return
    if isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _leaves_equal(x, y)
        return
    assert a == b


def test_roundtrip_every_leaf_kind_and_jax_layout(tmp_path):
    """fp32, bf16 (its bits as uint16), int32, 0-d, a NamedTuple and leaves
    that are not tensors come back bit-equal; the directory holds JAX's
    layout (step_%09d, manifest.json, shard_%05d.npz, COMMITTED), and the
    leaf paths are JAX's ``tree_flatten_with_path`` key strings."""
    cm = CheckpointManager(str(tmp_path), async_save=False, shard_bytes=32)
    tree = _tree(3)
    cm.save(5, tree, extra={"data": {"seed": 0, "data_step": 5}})
    step_dir = tmp_path / "step_000000005"
    files = sorted(os.listdir(step_dir))
    n_shards = len(files) - 2
    assert n_shards > 1                           # 32-byte shards split
    assert files == sorted(["COMMITTED", "manifest.json"] + [
        f"shard_{i:05d}.npz" for i in range(n_shards)])
    assert os.listdir(tmp_path) == ["step_000000005"]
    manifest = json.loads((step_dir / "manifest.json").read_text())
    meta = {m["key"]: m for m in manifest["leaves"]}
    assert meta["['b']/['c']"]["dtype"] == "uint16"
    assert meta["['b']/['c']"]["torch_dtype"] == "bfloat16"
    assert meta["['e']/[0]/.rest/['prng']"]["value"] == 21
    got, extra = cm.restore(5, _tree(1))
    _leaves_equal(got, tree)
    assert extra == {"data": {"seed": 0, "data_step": 5}}
    # the same nest through JAX's walker: the same key strings (JAX has
    # no leaf for None; the manifest keeps it)
    assert meta["['b']/['d']/[1]"]["value"] is None
    jtree = {"a": np.zeros(10), "b": {"c": np.zeros((3, 4)),
                                      "d": (np.zeros((2, 3)), None)},
             "e": [Pair(np.zeros(()), {"f": 0.5, "prng": 21})]}
    jkeys = ["/".join(str(p) for p in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(jtree)[0]]
    assert jkeys == [k for k in meta if k != "['b']/['d']/[1]"]


def test_jax_reads_a_port_checkpoint(tmp_path):
    """JAX's manager restores what the port wrote (fp32 / int32 leaves)."""
    tree = {"a": torch.arange(4.0), "b": torch.arange(6, dtype=torch.int32)}
    CheckpointManager(str(tmp_path), async_save=False).save(3, tree)
    step, got, _ = JCheckpointManager(str(tmp_path)).restore_latest(
        {"a": jnp.zeros(4), "b": jnp.zeros(6, jnp.int32)})
    assert step == 3
    np.testing.assert_array_equal(got["a"], np.arange(4.0))
    np.testing.assert_array_equal(got["b"], np.arange(6))


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_roundtrip_and_gc_match_jax(tmp_path, pkg):
    """JAX's ``test_checkpoint_roundtrip_and_gc`` on both packages."""
    if pkg == "jax":
        tree = {"a": jnp.arange(10.0),
                "b": {"c": jnp.ones((3, 4), jnp.bfloat16)}}
        cm = JCheckpointManager(str(tmp_path), keep=2, async_save=False)
        scaled = lambda s: jax.tree_util.tree_map(lambda x: x * s, tree)
    else:
        tree = {"a": torch.arange(10.0),
                "b": {"c": torch.ones((3, 4), dtype=torch.bfloat16)}}
        cm = CheckpointManager(str(tmp_path), keep=2, async_save=False)
        scaled = lambda s: {"a": tree["a"] * s, "b": {"c": tree["b"]["c"] * s}}
    for s in (1, 2, 3):
        cm.save(s, scaled(s), extra={"data": {"seed": 0, "data_step": s}})
    assert cm.all_steps() == [2, 3]              # gc keeps 2
    got, extra = cm.restore(3, tree)
    np.testing.assert_allclose(np.asarray(got["a"]), np.arange(10.0) * 3)
    assert extra["data"]["data_step"] == 3


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_crash_safety_matches_jax(tmp_path, pkg):
    """An uncommitted (crashed) save is invisible to restore_latest."""
    if pkg == "jax":
        tree, cm = {"a": jnp.arange(4.0)}, JCheckpointManager(
            str(tmp_path), async_save=False)
    else:
        tree, cm = {"a": torch.arange(4.0)}, CheckpointManager(
            str(tmp_path), async_save=False)
    cm.save(1, tree)
    os.makedirs(tmp_path / "step_000000002")
    (tmp_path / "step_000000002" / "manifest.json").write_text("{}")
    os.makedirs(tmp_path / "step_000000003.tmp")
    step, _, _ = cm.restore_latest(tree)
    assert step == 1


def test_async_save_copies_before_it_returns(tmp_path):
    """The state is written in place after ``save`` returns (the serving
    engine's page pools change every tick): the checkpoint holds the values
    at the call."""
    x = torch.arange(1 << 16, dtype=torch.float32)
    cm = CheckpointManager(str(tmp_path), async_save=True)
    cm.save(1, {"x": x})
    x.add_(1.0)
    cm.wait()
    got, _ = cm.restore(1, {"x": torch.empty_like(x)})
    assert torch.equal(got["x"], torch.arange(1 << 16, dtype=torch.float32))


def test_restore_checks_shapes_dtypes_and_kinds(tmp_path):
    cm = CheckpointManager(str(tmp_path), async_save=False)
    cm.save(1, {"a": torch.zeros(3), "n": 4})
    for like, match in (({"a": torch.zeros(4), "n": 4}, "shape"),
                        ({"a": torch.zeros(3, dtype=torch.float64),
                          "n": 4}, "dtype"),
                        ({"a": torch.zeros(3), "n": torch.zeros(1)},
                         "expected a tensor"),
                        ({"a": torch.zeros(3)}, "leaf count")):
        with pytest.raises(ValueError, match=match):
            cm.restore(1, like)


# ---------------- session snapshot / restore ----------------
@pytest.fixture(scope="module")
def bridged():
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
    return m_j, m_t, params_j, params_t, sw_j, sw_t


def _tokens(res):
    return np.asarray(res.tokens).tolist(), np.asarray(res.counts).tolist()


def _session(engine, prompts):
    s = engine.new_session(2, 128, cache="paged")
    for row, p in enumerate(prompts):
        s.prefill_row(row, p, max_new_tokens=10)
    return s


def test_session_snapshot_restore_roundtrip_matches_jax(bridged, tmp_path):
    """A paged SpecEE session steps twice and snapshots: its meta equals
    JAX's after the same calls; saved through the (async) manager, the
    original steps on (in place), and a fresh session restored from the
    checkpoint steps to the same tokens; a restore into a session of
    another batch is refused before anything is touched."""
    m_j, m_t, params_j, params_t, sw_j, sw_t = bridged
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 512, n) for n in (7, 11)]
    js = _session(JEngine.create(m_j, params_j, sw_j, strategy="specee"),
                  prompts)
    engine = Engine.create(m_t, params_t, sw_t, strategy="specee")
    ts = _session(engine, prompts)
    for _ in range(2):
        assert _tokens(ts.step()) == _tokens(js.step())
    _, meta_j = js.snapshot()
    state, meta = ts.snapshot()
    assert meta == meta_j
    cm = CheckpointManager(str(tmp_path), async_save=True)
    cm.save(2, {"state": state}, extra=meta)
    want = [_tokens(ts.step()) for _ in range(3)]
    cm.wait()
    fresh = engine.new_session(2, 128, cache="paged")
    _, tree, extra = cm.restore_latest({"state": fresh._state})
    other = engine.new_session(3, 128, cache="paged")
    with pytest.raises(ValueError, match="batch"):
        other.restore(tree["state"], extra)
    assert other.cache_mgr.free_pages == other.cache_mgr.num_pages
    fresh.restore(tree["state"], extra)
    assert fresh.cache_mgr.export_state() == meta["cache"]
    assert [_tokens(fresh.step()) for _ in range(3)] == want


def test_snapshot_refuses_outstanding_megaticks(bridged):
    """JAX's ``test_snapshot_requires_drained_pipeline`` on the port: a
    snapshot across an unread async megatick is refused; after the finish
    it is taken."""
    _, m_t, _, params_t, _, sw_t = bridged
    s = _session(Engine.create(m_t, params_t, sw_t, strategy="specee"),
                 [np.arange(5), np.arange(6) + 9])
    handle = s.step_async(2)
    with pytest.raises(AssertionError, match="outstanding megaticks"):
        s.snapshot()
    s.finish_step(handle)
    _, meta = s.snapshot()
    assert meta["strategy"] == "specee"


# ---------------- TrainLoop restart ----------------
def test_train_restart_reproduces_stream(tmp_path):
    """JAX's ``test_train_restart_reproduces_stream`` on the port, beside
    JAX's own: 2 steps, save, 1 step; a fresh loop (other init) restores
    step 2 and runs 1 step to the uninterrupted loss (rel 1e-5). The
    restored pipeline state equals JAX's restored one and the next batch
    is bit-equal to JAX's."""
    run_t = get_config("llama2-7b").smoke()
    run_t = dataclasses.replace(run_t, train=dataclasses.replace(
        run_t.train, checkpoint_every=100))
    m = build_model(run_t)
    d = str(tmp_path / "torch")
    loop = TrainLoop(m, run_t, m.init(0, "cpu"), ckpt_dir=d)
    loop.run_steps(2)
    loop.save()
    loop.ckpt.wait()
    loop.run_steps(1)
    loss_after_3 = loop.history[-1]["loss"]
    loop2 = TrainLoop(m, run_t, m.init(5, "cpu"), ckpt_dir=d)
    assert loop2.try_restore() and loop2.step == 2
    state_t = loop2.pipeline.state_dict()
    loop2.run_steps(1)
    assert loop2.history[-1]["loss"] == pytest.approx(loss_after_3,
                                                      rel=1e-5)

    run_j = jax_get_config("llama2-7b").smoke()
    run_j = dataclasses.replace(run_j, train=dataclasses.replace(
        run_j.train, checkpoint_every=100))
    mj = jbuild(run_j)
    dj = str(tmp_path / "jax")
    jl = JTrainLoop(mj, run_j, mj.init(jax.random.PRNGKey(0)), ckpt_dir=dj)
    jl.run_steps(2)
    jl.save()
    jl.ckpt.wait()
    jl2 = JTrainLoop(mj, run_j, mj.init(jax.random.PRNGKey(5)), ckpt_dir=dj)
    assert jl2.try_restore() and jl2.step == 2
    assert state_t == jl2.pipeline.state_dict()
    loop3 = TrainLoop(m, run_t, m.init(5, "cpu"), ckpt_dir=d)
    assert loop3.try_restore()
    bt, bj = loop3.pipeline.next(), jl2.pipeline.next()
    assert set(bt) == set(bj)
    for k in bt:
        np.testing.assert_array_equal(np.asarray(bt[k]), np.asarray(bj[k]))
