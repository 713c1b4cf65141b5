"""The port's offline SpecEE training against the JAX package (fp32, CPU,
llama2-7b smoke config): the teacher-forced draft and its loss, draft
training, the draft's top-k hit rate, feature collection, predictor
training, offline exit counts and the offline schedule.

A tiny bundle is trained once in JAX (the target 2 ``TrainLoop`` steps,
the draft 3, the predictors 5) and bridged in; each port stage starts from
the JAX-produced inputs of that stage, so drift does not add up across
stages. The port's initialisers are replaced by JAX's own initial weights
where a stage starts from an init.

Tolerances: draft hidden states and losses rtol 1e-5 (atol 1e-5 on
hiddens), draft gradients rtol 1e-4 with atol 1e-6; trained draft params
atol steps * lr (Adam's sqrt(v) division, as in test_torch_train.py);
features atol 1e-5, labels exact; predictor params atol 1e-5; hit rate,
accuracy, positive rate, exit counts and the offline mask exact."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import draft as jdraft  # noqa: E402
from repro.core import draft_training as jdt  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core import predictor as jpred  # noqa: E402
from repro.core import predictor_training as jpt  # noqa: E402
from repro.core import scheduler as jsched  # noqa: E402
from repro.data import DataPipeline as JPipeline  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.train import TrainLoop as JTrainLoop  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.config import SpecEEConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import draft as tdraft  # noqa: E402
from repro_torch.core import draft_training as tdt  # noqa: E402
from repro_torch.core import predictor as tpred  # noqa: E402
from repro_torch.core import predictor_training as tpt  # noqa: E402
from repro_torch.core import scheduler as tsched  # noqa: E402
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


GTOL = dict(rtol=1e-4, atol=1e-6)
DRAFT_STEPS, PRED_STEPS, MAX_NEW = 3, 5, 4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _to_torch(tree):
    return bridge.params_from_numpy(_np_tree(tree), "cpu", torch.float32)


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


@pytest.fixture(scope="module")
def b():
    """The JAX bundle, stage by stage, and the port's model beside it."""
    run_j = jax_get_config("llama2-7b").smoke()
    m_j = jbuild(run_j)
    loop = JTrainLoop(m_j, run_j, m_j.init(jax.random.PRNGKey(0)))
    loop.run_steps(2)
    params_j = loop.params
    pipe = JPipeline(run_j.model, 2, 16, seed=3)
    tokens = [pipe.next()["tokens"] for _ in range(2)]
    batches_j = [jnp.asarray(t) for t in tokens]
    spec = run_j.specee
    E = m_j.num_exit_points
    out = dict(run_j=run_j, m_j=m_j, params_j=params_j, tokens=tokens,
               batches_j=batches_j)
    out["dinit_j"] = jdraft.init_draft(run_j.model, jax.random.PRNGKey(1))
    out["draft_j"], out["dmetrics_j"] = jdt.train_draft(
        m_j, params_j, batches_j, jax.random.PRNGKey(1), steps=DRAFT_STEPS)
    out["data_j"] = jpt.collect_dataset(m_j, params_j, out["draft_j"],
                                        batches_j)
    out["pinit_j"] = jpred.init_predictors(spec, E, jax.random.PRNGKey(2))
    out["pred_j"], out["pmetrics_j"] = jpt.train_predictors(
        spec, out["data_j"], jax.random.PRNGKey(2), steps=PRED_STEPS)
    out["sw_j"] = jeng.SpecEEWeights(draft=out["draft_j"],
                                     predictors=out["pred_j"],
                                     offline_mask=jnp.ones((E,), bool))
    out["counts_j"] = jpt.offline_exit_counts(m_j, params_j, out["sw_j"],
                                              batches_j[:1], max_new=MAX_NEW)
    out["m_t"] = build_model(get_config("llama2-7b").smoke())
    out["params_t"] = _to_torch(params_j)
    out["batches_t"] = [torch.from_numpy(t) for t in tokens]
    return out


def test_draft_forward_seq_and_loss_match_jax(b):
    m_j, m_t = b["m_j"], b["m_t"]
    cfg = m_t.cfg
    rng = np.random.default_rng(5)
    emb = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    hp = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    dp_t = _to_torch(b["dinit_j"])
    got = tdraft.draft_forward_seq(cfg, dp_t, torch.from_numpy(emb),
                                   torch.from_numpy(hp))
    want = jdraft.draft_forward_seq(b["run_j"].model, b["dinit_j"],
                                    jnp.asarray(emb), jnp.asarray(hp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(
        tdraft.shift_hidden(torch.from_numpy(hp)).numpy(),
        np.asarray(jdraft.shift_hidden(jnp.asarray(hp))))
    # draft_loss and its gradients in the draft's params (target frozen)
    (lj, (cej, fj)), gj = jax.value_and_grad(
        lambda d: jdt.draft_loss(m_j, b["params_j"], d, b["batches_j"][0]),
        has_aux=True)(b["dinit_j"])
    leaves = [x.requires_grad_(True) for x in tree_leaves(dp_t)]
    lt, (cet, ft) = tdt.draft_loss(m_t, b["params_t"],
                                   tree_unflatten(dp_t, leaves),
                                   b["batches_t"][0])
    gt = tree_unflatten(dp_t, torch.autograd.grad(lt, leaves))
    for x, y in ((lt, lj), (cet, cej), (ft, fj)):
        assert float(x.detach()) == pytest.approx(float(y), rel=1e-5)
    for path, x, y in _pairs(gt, gj):
        np.testing.assert_allclose(x, y, err_msg=path, **GTOL)
    assert all(p.grad is None for p in tree_leaves(b["params_t"]))
    # the draft's size against JAX's, and the paper's overhead claim
    assert tdraft.draft_param_count(cfg) == jdraft.draft_param_count(
        b["run_j"].model)
    full = get_config("llama2-7b").model
    assert tdraft.draft_param_count(full) < 0.05 * full.param_count()


def test_train_draft_matches_jax(b, monkeypatch):
    dinit = _to_torch(b["dinit_j"])
    monkeypatch.setattr(tdraft, "init_draft", lambda *a, **k: dinit)
    dp, metrics = tdt.train_draft(b["m_t"], b["params_t"], b["batches_t"],
                                  torch.Generator().manual_seed(1),
                                  steps=DRAFT_STEPS)
    want = b["dmetrics_j"]
    assert metrics["final_loss"] == pytest.approx(want["final_loss"],
                                                  rel=1e-4)
    assert metrics["first_loss"] > metrics["final_loss"]
    assert metrics["topk_hit_rate"] == want["topk_hit_rate"]
    atol = DRAFT_STEPS * 1e-3
    worst = 0.0
    for path, x, y in _pairs(dp, b["draft_j"]):
        worst = max(worst, float(np.abs(x - y).max()))
        np.testing.assert_allclose(x, y, atol=atol, err_msg=path)
    print(f"largest draft param diff: {worst:.3e} (atol {atol:.0e})")


def test_topk_hit_rate_matches_jax(b):
    k = b["run_j"].specee.num_speculative
    for i in range(2):
        got = tdt.topk_hit_rate(b["m_t"], b["params_t"],
                                _to_torch(b["draft_j"]), b["batches_t"][i], k)
        want = jdt.topk_hit_rate(b["m_j"], b["params_j"], b["draft_j"],
                                 b["batches_j"][i], k)
        assert got == want


def test_collect_dataset_matches_jax(b):
    data = tpt.collect_dataset(b["m_t"], b["params_t"],
                               _to_torch(b["draft_j"]), b["batches_t"])
    want = b["data_j"]
    assert data.features.shape == want.features.shape
    flips = np.argwhere(data.labels.numpy() != np.asarray(want.labels))
    if len(flips):
        pytest.fail("labels flipped (exit point, row: top-2 logit margin at "
                    "the exit point, at the last unit): " + ", ".join(
                        f"({e}, {t}: {_margins(b, e, t)})" for e, t in flips))
    np.testing.assert_allclose(data.features.numpy(),
                               np.asarray(want.features), atol=1e-5)


def _margins(b, e, t):
    """The port's top-2 logit margins of dataset row ``t`` at exit point
    ``e`` and at the last unit."""
    from repro_torch.models.common import index_tree
    from repro_torch.models.model import _block_seq
    m, params = b["m_t"], b["params_t"]
    tokens = torch.cat(b["batches_t"])
    S = tokens.shape[1]
    h = m.embed(params, tokens)
    pos = torch.arange(S)[None, :].expand(tokens.shape[0], S)
    out = []
    with torch.no_grad():
        for u in range(m.num_exit_points):
            h, _ = _block_seq(m.cfg, "attention",
                              index_tree(params["segments"][0], u)["u0"], h,
                              pos, m.flags)
            if u in (e, m.num_exit_points - 1):
                top2 = m.logits(params, h).reshape(-1, m.cfg.vocab_size)[
                    t].topk(2).values
                out.append(f"{float(top2[0] - top2[1]):.2e}")
    return " / ".join(out)


def test_train_predictors_matches_jax(b, monkeypatch):
    pinit = bridge.to_torch(_np_tree(b["pinit_j"]), "cpu")
    monkeypatch.setattr(tpred, "init_predictors", lambda *a, **k: pinit)
    data = tpt.FeatureDataset(
        features=torch.from_numpy(np.array(b["data_j"].features)),
        labels=torch.from_numpy(np.array(b["data_j"].labels)))
    pred, metrics = tpt.train_predictors(
        b["m_t"].run.specee, data, torch.Generator().manual_seed(2),
        steps=PRED_STEPS)
    for path, x, y in _pairs(pred, b["pred_j"]):
        np.testing.assert_allclose(x, y, atol=1e-5, err_msg=path)
    for key in ("accuracy", "positive_rate"):
        assert metrics[key] == b["pmetrics_j"][key], key
    assert metrics["final_loss"] < metrics["first_loss"]


def test_offline_exit_counts_match_jax(b):
    sw_np = _np_tree(b["sw_j"])
    sw = bridge.specee_from_numpy(sw_np.draft, sw_np.predictors,
                                  sw_np.offline_mask, "cpu", torch.float32)
    counts = tpt.offline_exit_counts(b["m_t"], b["params_t"], sw,
                                     b["batches_t"][:1], max_new=MAX_NEW)
    np.testing.assert_array_equal(counts, b["counts_j"])
    assert counts[:-1].sum() > 0, "the tiny bundle should exit early"
    spec = b["m_t"].run.specee
    mask = tsched.offline_mask_from_counts(
        torch.as_tensor(counts[:-1], dtype=torch.float32), spec)
    want = jsched.offline_mask_from_counts(
        jnp.asarray(b["counts_j"][:-1], jnp.float32), b["run_j"].specee)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want))


@pytest.mark.parametrize("counts", [
    [5, 100, 2, 50, 1, 1, 1, 1],           # tests/test_specee.py:182
    [3, 7, 7, 0, 7, 1, 0, 0, 2, 7, 0, 3],  # ties go to the lower exit point
    [0] * 6,
])
def test_offline_mask_from_counts_matches_jax(counts):
    for frac in (0.25, 0.3, 0.5):
        spec = SpecEEConfig(offline_top_frac=frac)
        spec_j = dataclasses.replace(jax_get_config("llama2-7b").specee,
                                     offline_top_frac=frac)
        got = tsched.offline_mask_from_counts(
            torch.tensor(counts, dtype=torch.float32), spec)
        want = jsched.offline_mask_from_counts(
            jnp.asarray(counts, jnp.float32), spec_j)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    mask = tsched.offline_mask_from_counts(
        torch.tensor([5, 100, 2, 50, 1, 1, 1, 1], dtype=torch.float32),
        SpecEEConfig(offline_top_frac=0.25))
    assert int(mask.sum()) == 2 and bool(mask[1]) and bool(mask[3])


def test_expected_active_count_matches_jax():
    """tests/test_specee.py:190's case: scheduling activates far fewer
    predictors than all exit points."""
    E = 32
    spec = dataclasses.replace(get_config("llama2-7b").specee,
                               offline_top_frac=0.25)
    spec_j = dataclasses.replace(jax_get_config("llama2-7b").specee,
                                 offline_top_frac=0.25)
    offline = np.zeros(E, bool)
    offline[:8] = True
    st = tsched.update(tsched.init_state(4, spec, "cpu"),
                       torch.tensor([10, 10, 11, 9]))
    st_j = jsched.update(jsched.init_state(4, spec_j),
                         jnp.array([10, 10, 11, 9]))
    got = float(tsched.expected_active_count(st, torch.from_numpy(offline),
                                             spec, E))
    want = float(jsched.expected_active_count(st_j, jnp.asarray(offline),
                                              spec_j, E))
    assert got == want and got < 0.5 * E
