"""Tensor-parallel serving of the remaining families against the JAX
package's UNSHARDED runs (CPU, fp32; weights bridged from JAX; shards on
repeated CPU devices, ``make_host_mesh(1, P, "cpu")``).

MoE (both ``moe_impl`` forms), Mamba2's SSD (each shard whole heads), the
RG-LRU hybrid (W slices, the post-conv activation gathered for the gates;
one KV head, below the degree, held by several shards), the VLM frontend
(whole on the lead) and the encoder, at P = 2 and 4: the sharded blocks
against JAX's blocks; sessions with every strategy a family runs over the
dense and the paged cache (a 16-token vocabulary, so rows exit early);
``ServingEngine(mesh=)`` on the paged cache; the encoder's frame logits;
a snapshot taken at P = 4 restored at P = 2; a ``device_lost`` remesh
4 -> 2; ``kv_quant`` and ``quant="int8"`` at P = 2; and ``launch.mesh``
refusing to fall back to the CPU. JAX's own tests show its sharded decode
equal to its unsharded one.

Tolerance: tokens, exit points, exits, accept lengths and ``units_run``
exact; block outputs, states, conv windows, aux losses and frame logits
atol = rtol = 1e-5 (fp32; the shards' partial sums change the summation
order). Each JAX reference is jitted once (its blocks) or run through
JAX's sessions and engines, and memoized across the cases."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import Engine as JEngine  # noqa: E402
from repro.api import SpecEEStrategy as JSpecEE  # noqa: E402
from repro.api import TreeStrategy as JTree  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core.tree import TreeSpec as JTreeSpec  # noqa: E402
from repro.data import DataPipeline as JPipeline  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models import ssd as jssd  # noqa: E402
from repro.models.model import ModelFlags as JFlags  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.api import Engine, SpecEEStrategy, TreeStrategy  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.tree import TreeSpec  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import moe, rglru, ssd  # noqa: E402
from repro_torch.models.common import index_tree  # noqa: E402
from repro_torch.models.model import ModelFlags, build_model  # noqa: E402
from repro_torch.runtime import faultinject  # noqa: E402
from repro_torch.runtime.faultinject import FaultSchedule  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.sharding.ctx import Shards, gather  # noqa: E402
from repro_torch.sharding.serving import shard_params  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
VOCAB = 16          # rows exit early: the draft's guesses often hold
DEGREES = (2, 4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small ops: one intra-op thread, so parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, Shards):
        x = gather(x, torch.device("cpu"))
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _close(a, b, tol=TOL, what=""):
    np.testing.assert_allclose(_np(a), np.asarray(b), err_msg=what, **tol)


_BUILT = {}


def _pair(arch, vocab=VOCAB, **flags):
    """(JAX model, params, sw; port model, params, sw) of ``arch``'s smoke
    config at ``vocab`` tokens, the port's weights bridged from JAX's."""
    key = (arch, vocab, tuple(sorted(flags.items())))
    if key not in _BUILT:
        run_j, run_t = jax_get_config(arch).smoke(), get_config(arch).smoke()
        if vocab is not None:
            run_j, run_t = (dataclasses.replace(r, model=dataclasses.replace(
                r.model, vocab_size=vocab)) for r in (run_j, run_t))
        m_j, m_t = jbuild(run_j, JFlags(**flags)), build_model(
            run_t, ModelFlags(**flags))
        params_j = m_j.init(jax.random.PRNGKey(0))
        sw_j = jeng.init_specee(m_j, jax.random.PRNGKey(1))
        params_t = bridge.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, params_j), "cpu",
            torch.float32)
        sw_np = jax.tree_util.tree_map(np.asarray, sw_j)
        sw_t = bridge.specee_from_numpy(sw_np.draft, sw_np.predictors,
                                        sw_np.offline_mask, "cpu",
                                        torch.float32)
        _BUILT[key] = (m_j, params_j, sw_j, m_t, params_t, sw_t)
    return _BUILT[key]


def mesh(P):
    return make_host_mesh(1, P, "cpu")


# ---------------------------- the blocks ---------------------------------
def _unit(m_t, params_t, P, seg=0, rep=0):
    """Unit ``rep`` of segment ``seg`` of the port's params placed on a
    (1, P) mesh (``shard_params``), and of the JAX-layout whole params."""
    placed, _ = shard_params(params_t, None, mesh(P), "tp_dp", m_t)
    return index_tree(placed["segments"][seg], rep)


@pytest.mark.parametrize("P", DEGREES)
@pytest.mark.parametrize("block", ["moe_dense", "moe_topk", "ssd", "rglru"])
def test_sharded_block_matches_jax(block, P):
    """Each block with ``Shards`` params (one sequence pass, then two
    steps, each carrying its own state) against JAX's unsharded block:
    MoE's output and aux loss in both forms; SSD's output, state and conv
    window (each shard's heads, gathered); RG-LRU's output, state and conv
    window (W slices)."""
    arch = {"ssd": "mamba2-130m", "rglru": "recurrentgemma-9b"}.get(
        block, "dbrx-132b")
    m_j, params_j, _, m_t, params_t, _ = _pair(arch)   # shared: decode's
    cfg_j, cfg_t = m_j.cfg, m_t.cfg
    pj = jax.tree_util.tree_map(lambda a: a[0], params_j["segments"][0])
    u = _unit(m_t, params_t, P)
    rng = np.random.default_rng(P)
    x = rng.standard_normal((2, 40, 128)).astype(np.float32)
    steps = rng.standard_normal((2, 2, 128)).astype(np.float32)
    if block.startswith("moe"):
        pm = u["u0"]["moe"]
        assert isinstance(pm["wi"], Shards) and len(pm["wi"]) == P
        assert isinstance(pm["router"]["w"], torch.Tensor)
        fj, ft = ((jmoe.apply_moe, moe.apply_moe) if block == "moe_dense"
                  else (jmoe.apply_moe_topk, moe.apply_moe_topk))
        fj = jax.jit(functools.partial(fj, cfg_j))
        for xs in (x, steps[:, :1], steps[:, 1:]):
            out_j, aux_j = fj(pj["u0"]["moe"], jnp.asarray(xs))
            out_t, aux_t = ft(cfg_t, pm, torch.from_numpy(xs))
            _close(out_t, out_j)
            assert float(aux_t) == pytest.approx(float(aux_j), rel=1e-5)
        return
    if block == "ssd":
        ps = u["u0"]["ssd"]
        assert len(ps["in_proj"]["w"]) == P
        out_j, st_j, cv_j = jax.jit(functools.partial(
            jssd.ssd_block_seq, cfg_j))(pj["u0"]["ssd"], jnp.asarray(x))
        step_j = jax.jit(functools.partial(jssd.ssd_block_step, cfg_j))
        out_t, st_t, cv_t = ssd.ssd_block_seq(cfg_t, ps, torch.from_numpy(x))
        assert isinstance(st_t, Shards) and len(st_t) == P
        for a, b in ((out_t, out_j), (st_t, st_j), (cv_t, cv_j)):
            _close(a, b)
        for t in range(2):
            out_j, st_j, cv_j = step_j(pj["u0"]["ssd"],
                                       jnp.asarray(steps[:, t]), st_j, cv_j)
            out_t, st_t, cv_t = ssd.ssd_block_step(
                cfg_t, ps, torch.from_numpy(steps[:, t]), st_t, cv_t)
            for a, b in ((out_t, out_j), (st_t, st_j), (cv_t, cv_j)):
                _close(a, b, what=f"step {t}")
        return
    pr = u["u0"]["rec"]
    assert len(pr["wa"]["w"]) == P and pr["wa"]["w"][0].shape[-2] == 128
    out_j, h_j, cv_j = jax.jit(functools.partial(
        jrglru.rglru_block_seq, cfg_j))(pj["u0"]["rec"], jnp.asarray(x))
    step_j = jax.jit(functools.partial(jrglru.rglru_block_step, cfg_j))
    out_t, h_t, cv_t = rglru.rglru_block_seq(cfg_t, pr, torch.from_numpy(x))
    assert isinstance(h_t, Shards) and len(h_t) == P
    for a, b in ((out_t, out_j), (h_t, h_j), (cv_t, cv_j)):
        _close(a, b)
    for t in range(2):
        out_j, h_j, cv_j = step_j(pj["u0"]["rec"], jnp.asarray(steps[:, t]),
                                  h_j, cv_j)
        out_t, h_t, cv_t = rglru.rglru_block_step(
            cfg_t, pr, torch.from_numpy(steps[:, t]), h_t, cv_t)
        for a, b in ((out_t, out_j), (h_t, h_j), (cv_t, cv_j)):
            _close(a, b, what=f"step {t}")


# ---------------------------- decode -------------------------------------
def _strategies(name):
    """(JAX strategy, port strategy) of a strategy name."""
    if name == "specee":
        return JSpecEE(threshold=0.4), SpecEEStrategy(threshold=0.4)
    if name == "tree":
        return (JTree(tree=JTreeSpec(2, 3), threshold=0.4),
                TreeStrategy(tree=TreeSpec(2, 3), threshold=0.4))
    return "dense", "dense"


def _prompts(m, patches=False, seed=7):
    if not patches:
        return np.random.default_rng(seed).integers(
            0, m.cfg.vocab_size, (2, 8))
    return JPipeline(m.cfg, 2, 6, seed=3).next()


def _patch_seq(batch, new):
    """A session's length over prepended patches (JAX sizes ``max_seq``
    from the text alone, so it is given)."""
    return batch["patches"].shape[1] + batch["tokens"].shape[1] + new + 2


def _drain(s, first, K):
    toks = [list(first.row_tokens(b)) for b in range(first.batch)]
    info = []
    while not s.all_done():
        res = s.step(num_ticks=K)
        info.append((np.asarray(res.exit_layer).tolist(),
                     np.asarray(res.exited).tolist(),
                     np.asarray(res.accept_len).tolist(),
                     int(res.units_run)))
        for b in range(res.batch):
            toks[b].extend(int(t) for t in res.row_tokens(b))
    return toks, info


_REF = {}


def _jax_ref(arch, strategy, flags, quant=None, new=8, patches=False):
    """JAX's unsharded session (dense cache, megaticks of 2): tokens and
    every tick's exit planes and units_run; memoized."""
    key = (arch, strategy, tuple(sorted(flags.items())), quant)
    if key not in _REF:
        m_j, pj, sj, m_t, _, _ = _pair(arch, None if patches else VOCAB,
                                       **flags)
        prompts = _prompts(m_t, patches)
        s = JEngine.create(m_j, pj, None if strategy == "dense" else sj,
                           strategy=_strategies(strategy)[0],
                           quant=quant).new_session()
        batch = ({k: jnp.asarray(v) for k, v in prompts.items()} if patches
                 else jnp.asarray(prompts))
        kw = dict(max_seq=_patch_seq(prompts, new)) if patches else {}
        _REF[key] = _drain(s, s.prefill(batch, max_new_tokens=new, **kw), 2)
    return _REF[key]


def _port_run(arch, strategy, flags, P, cache, quant=None, new=8,
              patches=False):
    _, _, _, m_t, pt, st = _pair(arch, None if patches else VOCAB, **flags)
    prompts = _prompts(m_t, patches)
    e = Engine.create(m_t, pt, None if strategy == "dense" else st,
                      strategy=_strategies(strategy)[1], quant=quant,
                      mesh=mesh(P))
    s = e.new_session(cache=cache)
    kw = dict(max_seq=_patch_seq(prompts, new)) if patches else {}
    return _drain(s, s.prefill(prompts, max_new_tokens=new, **kw), 2)


DECODE = [
    ("dbrx-132b", dict(moe_impl="dense"), ("specee", "tree")),
    ("dbrx-132b", dict(moe_impl="topk"), ("specee", "tree")),
    ("qwen3-moe-235b-a22b", dict(moe_impl="topk"), ("specee", "tree")),
    ("mamba2-130m", {}, ("specee", "dense")),
    ("recurrentgemma-9b", {}, ("specee", "dense")),
    ("internvl2-26b", {}, ("dense",)),
]


@pytest.mark.parametrize("arch,flags,strategies", DECODE,
                         ids=lambda v: v if isinstance(v, str) else
                         "-".join(f"{k}={x}" for k, x in v.items())
                         if isinstance(v, dict) else "+".join(v))
def test_sharded_decode_matches_jax_unsharded(arch, flags, strategies):
    """P = 2 and 4, dense and paged caches, megaticks of 2: JAX's
    unsharded tokens, exit points, exits, accept lengths and units_run
    for every strategy the family runs (internvl2 over prepended patches,
    dense); some row exits early."""
    patches = arch == "internvl2-26b"
    exits = 0
    for strategy in strategies:
        want = _jax_ref(arch, strategy, flags, patches=patches)
        exits += sum(sum(map(sum, e)) if isinstance(e[0], list) else sum(e)
                     for _, e, _, _ in want[1])
        for P in DEGREES:
            for cache in ("dense", "paged"):
                got = _port_run(arch, strategy, flags, P, cache,
                                patches=patches)
                assert got == want, (arch, strategy, P, cache)
    assert patches or exits > 0, "no row exited early"


def test_kv_quant_and_int8_sharded_match_jax():
    """recurrentgemma-9b's int8 KV cache (its local attention's pools and
    scales, one KV head on both shards) and dbrx-132b under
    ``quant="int8"`` (the expert banks unquantized, as unsharded) at
    P = 2, against JAX's same runs."""
    flags = dict(kv_quant=True)
    want = _jax_ref("recurrentgemma-9b", "specee", flags)
    for cache in ("dense", "paged"):
        assert _port_run("recurrentgemma-9b", "specee", flags, 2,
                         cache) == want
    flags = dict(moe_impl="topk")
    want = _jax_ref("dbrx-132b", "specee", flags, quant="int8")
    assert _port_run("dbrx-132b", "specee", flags, 2, "paged",
                     quant="int8") == want


# ---------------------------- serving ------------------------------------
def _serve(cls, m, params, sw, prompts, **kw):
    se = cls(m, params, sw, strategy="specee", megatick=2, cache="paged",
             **kw)
    reqs = [se.submit(p, max_new_tokens=6) for p in prompts]
    se.run_to_completion()
    se.close()
    return se, [(list(r.output), list(r.exit_points)) for r in reqs]


_SERVED = {}


def _serve_ref(arch):
    if arch not in _SERVED:
        m_j, pj, sj, m_t, _, _ = _pair(arch)
        rng = np.random.default_rng(5)
        prompts = [rng.integers(0, VOCAB, int(n)) for n in (5, 11, 8)]
        _SERVED[arch] = prompts, _serve(JServingEngine, m_j, pj, sj,
                                        prompts)[1]
    return _SERVED[arch]


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-9b"])
def test_serving_engine_mesh_matches_jax(arch):
    """``ServingEngine(mesh=P2)`` on the paged cache (SSD rows unpaged, per
    shard): JAX's unsharded engine's outputs and exit points; every page
    returned."""
    prompts, want = _serve_ref(arch)
    _, _, _, m_t, pt, st = _pair(arch)
    se, got = _serve(ServingEngine, m_t, pt, st, prompts, mesh=mesh(2))
    assert got == want and se.tp_degree == 2
    mgr = se.session.cache_mgr
    assert mgr.free_pages == mgr.num_pages


def test_device_lost_remeshes_ssd_engine_4_to_2():
    """A mamba2 ``ServingEngine(mesh=P4)`` loses a device at its second
    tick, remeshes to P = 2 and finishes with JAX's unsharded outputs."""
    prompts, want = _serve_ref("mamba2-130m")
    _, _, _, m_t, pt, st = _pair("mamba2-130m")
    with faultinject.injected(FaultSchedule.once("device_lost", visit=2)):
        se, got = _serve(ServingEngine, m_t, pt, st, prompts, mesh=mesh(4))
    assert se.tp_degree == 2 and got == want
    assert "remesh" in [e.action for e in se.fault_log]


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-9b"])
def test_snapshot_at_4_restores_at_2(arch):
    """A P = 4 session's snapshot is the whole layout (the SSD state's
    heads, the RG-LRU's W, one KV head gathered from its first holder);
    restored into a P = 2 session it decodes on to JAX's unsharded
    tokens."""
    _, _, _, m_t, pt, st = _pair(arch)
    want, _ = _jax_ref(arch, "specee", {})
    prompts = _prompts(m_t)

    def session(P):
        return Engine.create(m_t, pt, st, strategy=_strategies("specee")[1],
                             mesh=mesh(P)).new_session(batch=2, max_seq=20)

    a = session(4)
    toks = [[a.prefill_row(b, prompts[b], max_new_tokens=8)]
            for b in range(2)]
    for _ in range(2):
        r = a.step()
        for b in range(2):
            toks[b].extend(int(t) for t in r.row_tokens(b))
    state, meta = a.snapshot()
    entry = state.cache["segments"][0]["u0"]
    name = "state" if arch == "mamba2-130m" else "h"
    assert isinstance(entry[name], torch.Tensor)
    assert entry[name].shape == m_t.empty_cache_entry(
        *entry[name].shape[:2], 1, "cpu", m_t.segments[0][0][0])[name].shape
    b = session(2)
    b.restore(state, meta)
    while not b.all_done():
        r = b.step()
        for row in range(2):
            toks[row].extend(int(t) for t in r.row_tokens(row))
    assert toks == want


# ---------------------------- the encoder --------------------------------
def test_encoder_frame_logits_match_jax():
    """hubert-xlarge's smoke config placed by ``Engine.create(...,
    strategy="dense", mesh=)``: ``Model.prefill`` over the engine's params
    gives every frame's logits, no cache, equal to JAX's unsharded
    prefill at P = 2 and 4."""
    m_j, pj, _, m_t, pt, _ = _pair("hubert-xlarge", vocab=None)
    frames = JPipeline(m_j.cfg, 2, 16, seed=0).next()["frames"]
    want, cache_j, _ = m_j.prefill(pj, {"frames": jnp.asarray(frames)})
    for P in DEGREES:
        e = Engine.create(m_t, pt, None, strategy="dense", mesh=mesh(P))
        assert isinstance(e.params["segments"][0]["u0"]["attn"]["wq"]["w"],
                          Shards)
        with torch.no_grad():
            got, cache, _ = e.model.prefill(
                e.params, {"frames": torch.from_numpy(frames)})
        assert cache is None and cache_j is None
        _close(got, want)


def test_pool_raises_without_a_card(monkeypatch):
    """``launch.mesh`` never falls back to the CPU unasked: without a card
    and without a named device, slots raise naming ``device=``; a named
    CPU device still gives a mesh."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device.*device="):
        mesh_lib._pool(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_lib.make_host_mesh(1, 2)
    assert mesh(2).flat == [torch.device("cpu")] * 2
