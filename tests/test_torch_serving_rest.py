"""The rest of serving against the JAX package (CPU, fp32, llama2-7b smoke
config): ``ServingEngine.cancel`` (a queued request, one mid chunked
admission, a slotted one) and ``completed``, chunked prefill attention
(``ModelFlags.chunk_threshold`` / ``chunk_size`` / ``attn_prune``), and the
serving launcher ``repro_torch.launch.serve``.

Tolerance: tokens, finish order and page counts exact; attention outputs
and logits atol = rtol = 1e-5 (fp32, different summation order)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.model import ModelFlags as JFlags  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.serving.server import ServingEngine as JServingEngine  # noqa
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.model import ModelFlags, build_model  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small ops: one intra-op thread, so parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def setup():
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
    return run_j, run_t, m_j, m_t, params_j, params_t, sw_j, sw_t


def _cancel_script(se, prompts):
    """Submit 6 requests to 2 slots with 8-token chunks (budgets that end
    the first two rows apart, so an admission runs beside a live row, a
    chunk a tick), then cancel a queued request, the request mid chunked
    admission and a slotted one, each at a fixed point of the run. Returns
    (cancel results, uids cancelled, outputs by uid, completed uids in
    finish order)."""
    reqs = [se.submit(p, max_new_tokens=n)
            for p, n in zip(prompts, (3, 8, 6, 6, 6, 6))]
    got, cancelled = [], []
    se.step()
    queued = se.scheduler.queued[-1]
    got.append(se.cancel(queued))
    cancelled.append(queued)
    for _ in range(20):                 # until an admission is mid-prompt
        if se.scheduler.admitting:
            break
        se.step()
    admitting = se.scheduler.admitting[0]
    got.append(se.cancel(admitting))
    cancelled.append(admitting)
    slotted = next(r.uid for r in se.slots if r is not None)
    got.append(se.cancel(slotted))
    cancelled.append(slotted)
    got.append(se.cancel(slotted))      # gone: not found twice
    got.append(se.cancel(10 ** 6))
    se.run_to_completion()
    outs = {r.uid: list(r.output) for r in reqs if r.uid not in cancelled}
    return got, cancelled, outs, [r.uid for r in se.completed]


@pytest.mark.parametrize("megatick", [1, 2])
def test_cancel_and_completed_match_jax(setup, megatick):
    """The same cancels through both packages' ServingEngine (a megatick of
    2 is async: a slotted cancel drains the in-flight megatick first): the
    cancels find the same uids, the other requests emit JAX's tokens, and
    ``completed`` holds them in JAX's finish order; no cancelled request
    completes, and every page is back in the pool."""
    run_j, run_t, m_j, m_t, params_j, params_t, sw_j, sw_t = setup
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 512, int(n)).astype(np.int32)
               for n in (5, 21, 9, 30, 4, 17)]
    se = ServingEngine(m_t, params_t, sw_t, prefill_chunk=8,
                       megatick=megatick)
    jse = JServingEngine(m_j, params_j, sw_j, prefill_chunk=8,
                         megatick=megatick)
    got = _cancel_script(se, prompts)
    want = _cancel_script(jse, prompts)
    assert got == want
    assert got[0] == [True, True, True, False, False]
    assert not set(got[1]) & set(got[3])
    assert sorted(got[3]) == sorted(got[2])
    mgr = se.session.cache_mgr
    assert mgr.free_pages == mgr.num_pages
    assert not se.busy and se.scheduler.queued == []


@pytest.mark.parametrize("prune", [False, True])
@pytest.mark.parametrize("window", [None, 5])
def test_chunked_attention_functions_match_jax(prune, window):
    """``attend_full_chunked`` and its pruned form against JAX's, with a
    query chunk that halves to divide S (12 -> 6), GQA and a window."""
    if prune:
        want_fn, got_fn = (jattn.attend_full_chunked_pruned,
                           tattn.attend_full_chunked_pruned)
    else:
        want_fn, got_fn = jattn.attend_full_chunked, tattn.attend_full_chunked
    cfg_j = jax_get_config("llama2-70b").smoke().model
    cfg_t = get_config("llama2-70b").smoke().model
    rng = np.random.default_rng(2)
    B, S, H, KVH, hd = 2, 30, 4, 2, 32
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KVH, hd)).astype(np.float32)
    want = want_fn(cfg_j, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   window, chunk=12)
    got = got_fn(cfg_t, torch.from_numpy(q), torch.from_numpy(k),
                 torch.from_numpy(v), window, chunk=12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    full = tattn.attend_full(cfg_t, torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), window)
    np.testing.assert_allclose(got.numpy(), full.numpy(), **TOL)


@pytest.mark.parametrize("prune", [False, True])
def test_chunked_prefill_matches_jax(setup, prune):
    """A 40-token prefill above ``chunk_threshold=16`` with ``chunk_size=8``
    takes the chunked path in both packages: last-position logits and the
    cache's K/V equal JAX's, and equal the unchunked prefill's; the flash
    flag takes precedence (its plain version on the CPU)."""
    run_j, run_t, m_j, m_t, params_j, params_t, sw_j, sw_t = setup
    kw = dict(chunk_threshold=16, chunk_size=8, attn_prune=prune)
    mj = jbuild(run_j, JFlags(**kw))
    mt = build_model(run_t, ModelFlags(**kw))
    tokens = np.random.default_rng(4).integers(0, 512, (2, 40))
    lj, cj, _ = mj.prefill(params_j, {"tokens": jnp.asarray(tokens)},
                           max_seq=48)
    outs = [mt.prefill(params_t, {"tokens": torch.as_tensor(tokens)},
                       max_seq=48)
            for mt in (mt, m_t, build_model(run_t, ModelFlags(
                flash_attention=True, **kw)))]
    for lt, ct, _ in outs:
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        np.testing.assert_allclose(
            ct["segments"][0]["u0"]["k"].numpy(),
            np.asarray(cj["segments"][0]["u0"]["k"]), **TOL)


@pytest.mark.parametrize("mode", [["--mode", "specee"], ["--mode", "tree"],
                                  ["--mode", "dense", "--temperature", "0.8",
                                   "--megatick", "2"]])
def test_launcher_ci_on_cpu(mode, capsys):
    """``python -m repro_torch.launch.serve --smoke --device cpu --ci``
    in-process: every request done with its budget, every page freed,
    tokens equal to the plain per-tick reference engine's."""
    launch_serve.main(["--smoke", "--device", "cpu", "--ci"] + mode)
    out = capsys.readouterr().out
    assert "[serve] 4 requests, 24 tokens" in out
    assert "CI smoke OK" in out


@pytest.mark.parametrize("argv,item", [
    (["--checkpoint-dir", "ckpt"], "fault tolerance"),
    (["--restore"], "fault tolerance"),
    (["--inject", "dispatch"], "fault tolerance"),
    (["--fault-log", "log.jsonl"], "fault tolerance"),
    (["--mesh", "1,2"], "multi-GPU"),
    (["--replicas", "2"], "multi-GPU")])
def test_launcher_refusals_name_their_roadmap_item(argv, item, capsys):
    """The fault-tolerance flags (``item`` "fault tolerance") and the
    multi-GPU ones are taken, as JAX's launcher takes them
    (``tests/test_torch_fault_serving.py`` and
    ``tests/test_torch_tp_decode.py`` run them); what JAX's launcher
    refuses stays refused: ``--mesh`` with DATA > 1, and ``--replicas``
    beside the single-engine fault paths."""
    base = ["--smoke", "--device", "cpu"]
    if item == "multi-GPU":
        args = launch_serve.parse_args(base + argv)
        assert (args.model_par, args.replicas) == (
            (2, 1) if argv[0] == "--mesh" else (1, 2))
        bad = (["--mesh", "2,1"] if argv[0] == "--mesh"
               else argv + ["--inject", "dispatch"])
        with pytest.raises(SystemExit):
            launch_serve.parse_args(base + bad)
        assert ("DATA must be 1" if argv[0] == "--mesh"
                else "in-pool failover") in capsys.readouterr().err
        return
    extra = ["--checkpoint-dir", "ck"] if argv == ["--restore"] else []
    args = launch_serve.parse_args(base + argv + extra)
    flag = argv[0].lstrip("-").replace("-", "_")
    assert getattr(args, flag) == (argv[1] if len(argv) > 1 else True)


def test_launcher_argument_rules(capsys):
    """Sampling needs ``--mode dense`` (as in JAX); ``--ci`` caps the
    workload; ``--num-pages`` needs the paged cache and may be below the
    batch's rows (the engine evicts), ``--restore`` needs
    ``--checkpoint-dir`` (as in JAX), and ``--inject device_lost`` needs a
    mesh to lose a device from (JAX's refusal)."""
    with pytest.raises(SystemExit):
        launch_serve.parse_args(["--temperature", "0.5"])
    capsys.readouterr()
    args = launch_serve.parse_args(["--ci", "--requests", "9", "--no-specee",
                                    "--max-new", "30"])
    assert (args.requests, args.max_new, args.mode) == (4, 6, "dense")
    assert args.device == "cuda" and not args.smoke
    assert launch_serve.parse_args(["--num-pages", "8"]).num_pages == 8
    for argv in (["--num-pages", "8", "--cache", "dense"], ["--restore"]):
        with pytest.raises(SystemExit):
            launch_serve.parse_args(argv)
    capsys.readouterr()
    with pytest.raises(SystemExit):
        launch_serve.parse_args(["--inject", "device_lost"])
    assert "needs a tensor-parallel mesh" in capsys.readouterr().err
    args = launch_serve.parse_args(["--inject", "device_lost",
                                    "--mesh", "1,2"])
    assert (args.inject, args.model_par) == ("device_lost", 2)
