"""Tensor-parallel decode of the port against the JAX package's unsharded
decode (CPU, fp32; weights bridged from JAX; shards on repeated CPU
devices, ``make_host_mesh(1, P, "cpu")``, the counterpart of JAX's forced
host devices).

JAX's ``tests/test_sharding.py`` shows that its sharded decode equals its
unsharded decode; here the port's sharded decode at P = 2 and 4 must give
JAX's unsharded tokens: dense / specee / tree x dense / paged caches with
``step(num_ticks=2)`` on the llama2-7b smoke config, a 509-token
vocabulary (the last vocabulary slice narrower), ``ServingEngine(mesh=)``
on the paged cache, starcoder2-15b's smoke config (biases, layernorm,
GELU: a row-parallel bias added once, after the reduce), ``quant="int8"``
and ``kv_quant`` at P = 2, and ``tp2d`` with DATA = 1. A snapshot taken at
one degree restores at another. What a mesh does not serve is refused
naming "multi-GPU"; MoE's ``moe_ep_quant`` and ``moe_bf16_reduce`` are
served at P = 2 as JAX's unsharded engine serves them, and DATA > 1 and
the training policy as JAX's unsharded engine serves (the other
families' meshes: ``tests/test_torch_tp_families.py``; the data rows:
``tests/test_torch_dp_serving.py``). Then the launcher's multi-GPU
flags, in this process. Tolerance: tokens exact."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import Engine as JEngine  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.models.model import ModelFlags as JFlags  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.api import Engine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
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


_BUILT = {}


def _pair(arch="llama2-7b", vocab=None, **flags):
    """(JAX model, params, sw; port model, params, sw) of ``arch``'s smoke
    config, the port's weights bridged from JAX's."""
    key = (arch, vocab, tuple(sorted(flags.items())))
    if key not in _BUILT:
        run_j, run_t = (jax_get_config(arch).smoke(),
                        get_config(arch).smoke())
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


def _decode(E, m, params, sw, strategy, cache, mesh=None, quant=None,
            policy="tp_dp", K=2, new=10):
    kw = dict(mesh=mesh, policy=policy) if mesh is not None else {}
    e = E.create(m, params, sw, strategy=strategy, quant=quant, **kw)
    s = e.new_session(batch=2, max_seq=48, cache=cache)
    prompts = np.random.default_rng(7).integers(
        0, m.run.model.vocab_size, (2, 8))
    toks = [[s.prefill_row(b, prompts[b], max_new_tokens=new)]
            for b in range(2)]
    while not s.all_done():
        res = s.step(num_ticks=K)
        for b in range(2):
            toks[b].extend(int(t) for t in res.row_tokens(b))
    return toks


_JAX_DECODE = {}


def _both(strategy, cache, degrees=(2, 4), arch="llama2-7b", vocab=None,
          quant=None, flags=None, policy="tp_dp", data=1):
    """The port over (``data``, P) meshes for P in ``degrees`` against
    JAX's unsharded decode (memoized per case)."""
    m_j, pj, sj, m_t, pt, st = _pair(arch, vocab, **(flags or {}))
    key = (strategy, cache, arch, vocab, quant,
           tuple(sorted((flags or {}).items())))
    if key not in _JAX_DECODE:
        _JAX_DECODE[key] = _decode(JEngine, m_j, pj, sj, strategy, cache,
                                   quant=quant)
    want = _JAX_DECODE[key]
    for P in degrees:
        got = _decode(Engine, m_t, pt, st, strategy, cache,
                      mesh=make_host_mesh(data, P, "cpu"), quant=quant,
                      policy=policy)
        assert got == want, (arch, strategy, cache, data, P)
    return want


@pytest.mark.parametrize("cache", ["dense", "paged"])
@pytest.mark.parametrize("strategy", ["dense", "specee", "tree"])
def test_sharded_decode_matches_jax_unsharded(strategy, cache):
    """P = 2 and 4, megaticks of 2: JAX's unsharded tokens."""
    _both(strategy, cache)


def test_odd_vocab_sharded_decode_matches_jax():
    """V = 509: slices of 255/254 and 128 x 3 + 125 columns."""
    _both("specee", "paged", vocab=509)


def test_bias_layernorm_config_matches_jax():
    """starcoder2-15b's smoke config (biases on every projection,
    layernorm, plain GELU MLP, 2 KV heads) at P = 2, AR and tree."""
    for strategy, cache in (("specee", "paged"), ("tree", "dense")):
        _both(strategy, cache, degrees=(2,), arch="starcoder2-15b")


def test_quant_and_kv_quant_sharded_match_jax():
    """``quant="int8"`` (the quantized head and bank whole on the lead) and
    the int8 KV cache (each shard's pools and scales) at P = 2."""
    _both("specee", "paged", degrees=(2,), quant="int8")
    _both("tree", "dense", degrees=(2,), quant="int8")
    for cache in ("dense", "paged"):
        _both("specee", cache, degrees=(2,), flags=dict(kv_quant=True))


def test_tp2d_with_data_one_matches_jax():
    _both("specee", "paged", degrees=(4,), policy="tp2d")


def _serve(S, m, p, s, **kw):
    """Three requests through ``S`` (SpecEE, megaticks of 2, paged):
    (engine, {uid: (output, exit points)})."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 512, int(rng.integers(4, 12)))
               for _ in range(3)]
    se = S(m, p, s, strategy="specee", megatick=2, cache="paged", **kw)
    for x in prompts:
        se.submit(x, max_new_tokens=6)
    se.run_to_completion()
    se.close()
    return se, {r.uid: (list(r.output), list(r.exit_points))
                for r in se.completed}


_JAX_SERVE = []


def _jax_serve():
    """JAX's unsharded ``_serve`` (memoized)."""
    if not _JAX_SERVE:
        m_j, pj, sj, _, _, _ = _pair()
        _JAX_SERVE.append(_serve(JServingEngine, m_j, pj, sj)[1])
    return _JAX_SERVE[0]


def test_serving_engine_mesh_paged_matches_jax():
    """``ServingEngine(mesh=)`` on the paged cache: JAX's unsharded
    engine's outputs and stats; ``tp_degree`` reports the degree."""
    _, _, _, m_t, pt, st = _pair()
    want = _jax_serve()
    se, got = _serve(ServingEngine, m_t, pt, st,
                     mesh=make_host_mesh(1, 2, "cpu"))
    assert got == want and se.tp_degree == 2
    mgr = se.session.cache_mgr
    assert mgr.free_pages == mgr.num_pages


def test_snapshot_restores_at_another_degree():
    """A P = 2 session's snapshot holds the whole-tensor layout; restored
    into P = 4 and unsharded sessions it decodes on to the uninterrupted
    run's tokens."""
    _, _, _, m, params, sw = _pair()
    prompts = np.random.default_rng(9).integers(0, 512, (2, 8))

    def session(mesh):
        e = Engine.create(m, params, sw, strategy="specee", mesh=mesh)
        s = e.new_session(batch=2, max_seq=48, cache="paged")
        return s

    def drain(s):
        out = [[], []]
        while not s.all_done():
            r = s.step()
            for b in range(2):
                out[b].extend(int(t) for t in r.row_tokens(b))
        return out

    a = session(make_host_mesh(1, 2, "cpu"))
    for b in range(2):
        a.prefill_row(b, prompts[b], max_new_tokens=8)
    a.step()
    a.step()
    state, meta = a.snapshot()
    k = state.cache["segments"][0]["u0"]["k"]
    assert isinstance(k, torch.Tensor) and \
        k.shape[3] == m.cfg.num_kv_heads
    ref = drain(a)
    for mesh in (make_host_mesh(1, 4, "cpu"), None):
        s = session(mesh)
        s.restore(state, meta)
        assert drain(s) == ref


def _refused(case):
    """The call a refusal case makes (raising ValueError)."""
    def engine(arch, data, model, policy="tp_dp", **flags):
        m = build_model(get_config(arch).smoke(), ModelFlags(**flags))
        Engine.create(m, {}, None, strategy="dense", policy=policy,
                      mesh=make_host_mesh(data, model, "cpu"))
    return {
        "ssd_heads": lambda: engine("mamba2-130m", 1, 3),
        "minicpm_p3": lambda: engine("minicpm-2b", 1, 3),
    }[case]


# the meshes with DATA > 1 and the training policy, served since they
# were refused: (data, degrees, policy)
_OVER_DATA = {"data_2": (2, (1,), "tp_dp"),
              "tp2d_over_data": (2, (2,), "tp2d"),
              "fsdp_tp": (2, (2,), "fsdp_tp")}


_MOE_FLAGS = {"moe_ep_quant": ("dbrx-132b", dict(moe_ep_quant=True)),
              "moe_bf16_reduce": ("qwen3-moe-235b-a22b",
                                  dict(moe_bf16_reduce=True))}


def _margin(m_j, pj, prompt, toks, t):
    """JAX's top-2 logit margin at generated token ``t`` of a row."""
    seq = np.concatenate([prompt, np.asarray(toks[:t], np.int32)])
    logits = np.asarray(m_j.prefill(pj, {"tokens": jnp.asarray(
        seq[None].astype(np.int32))})[0])[0]
    top = np.sort(logits)[-2:]
    return float(top[1] - top[0])


def _served_as_jax(case):
    """A (1, 2) mesh serves a MoE flag as JAX's unsharded engine with the
    same flag: dense decode tokens equal, or where a token differs JAX's
    top-2 margin there is a near-tie (below 1e-2), printed."""
    arch, flags = _MOE_FLAGS[case]
    m_j, pj, sj, m_t, pt, st = _pair(arch, **flags)
    want = _decode(JEngine, m_j, pj, sj, "dense", "dense")
    got = _decode(Engine, m_t, pt, st, "dense", "dense",
                  mesh=make_host_mesh(1, 2, "cpu"))
    prompts = np.random.default_rng(7).integers(
        0, m_t.run.model.vocab_size, (2, 8))
    for b in range(2):
        w = [int(t) for t in np.ravel(np.concatenate(
            [np.ravel(x) for x in want[b]]))]
        g = [int(t) for t in np.ravel(np.concatenate(
            [np.ravel(x) for x in got[b]]))]
        assert len(w) == len(g), case
        diff = [t for t in range(len(w)) if w[t] != g[t]]
        if diff:
            margin = _margin(m_j, pj, prompts[b], w, diff[0])
            print(f"{case}: row {b} token {diff[0]} differs "
                  f"({w[diff[0]]} vs {g[diff[0]]}), JAX's top-2 margin "
                  f"{margin:.3e}")
            assert margin < 1e-2, (case, b, diff[0], margin)


@pytest.mark.parametrize("case", ["data_2", "tp2d_over_data", "fsdp_tp",
                                  "moe_ep_quant", "moe_bf16_reduce",
                                  "ssd_heads", "minicpm_p3"])
def test_remaining_meshes_refused(case):
    """What a mesh still does not serve is refused naming "multi-GPU",
    before anything is placed: a degree that does not divide Mamba2's 8
    smoke SSD heads (P = 3), and minicpm-2b's smoke config at P = 3 (4
    query heads). MoE's ``moe_ep_quant`` and ``moe_bf16_reduce`` are
    served: a (1, 2) mesh with each flag decodes as JAX's unsharded engine
    with it (``_served_as_jax``). So are DATA > 1 and the training policy,
    once refused: (2, 1) tp_dp, (2, 2) tp2d (the second dim over 'data')
    and (2, 2) fsdp_tp give JAX's unsharded SpecEE tokens on the paged
    cache. Every family of ``ARCHS`` is served at P = 2 and 4
    (``tests/test_torch_tp_families.py``) and over data rows
    (``tests/test_torch_dp_serving.py``)."""
    if case in _MOE_FLAGS:
        _served_as_jax(case)
        return
    if case in _OVER_DATA:
        data, degrees, policy = _OVER_DATA[case]
        _both("specee", "paged", degrees=degrees, policy=policy, data=data)
        return
    with pytest.raises(ValueError, match="multi-GPU"):
        _refused(case)()


def test_mesh_refusals():
    """A degree that neither divides the KV heads nor is a multiple of
    them (nor divides the query heads) is refused naming "multi-GPU"; a
    (1, 1) mesh is the unsharded engine. DATA > 1 and the training
    policy, once refused, serve: ``ServingEngine`` at (2, 1) tp_dp and
    (1, 2) fsdp_tp gives JAX's unsharded engine's outputs and stats."""
    _, _, _, m, params, sw = _pair()
    want = _jax_serve()
    for mesh, policy in ((make_host_mesh(2, 1, "cpu"), "tp_dp"),
                         (make_host_mesh(1, 2, "cpu"), "fsdp_tp")):
        _, got = _serve(ServingEngine, m, params, sw, mesh=mesh,
                        policy=policy)
        assert got == want, (mesh, policy)
    sc = build_model(get_config("starcoder2-15b").smoke())
    with pytest.raises(ValueError, match="multi-GPU"):
        Engine.create(sc, {}, None, strategy="dense",
                      mesh=make_host_mesh(1, 3, "cpu"))
    e = Engine.create(m, params, sw, mesh=make_host_mesh(1, 1, "cpu"))
    wq = params["segments"][0]["u0"]["attn"]["wq"]["w"]
    assert e.shard is None and e.device == torch.device("cpu")
    assert e.params["segments"][0]["u0"]["attn"]["wq"]["w"] is wq


def test_replica_meshes_place_engines_on_their_devices(monkeypatch):
    """With one slot per replica over two distinct devices (cpu and meta
    standing in for two cards), ``make_replica_meshes`` gives each replica
    its own degree-1 mesh and each replica's engine holds its weights on
    that mesh's device; the whole tree stays on the host as the engines'
    ``source``. A sharded engine keeps no whole copy on its devices."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.common import tree_leaves
    from repro_torch.sharding.ctx import Shards
    monkeypatch.setattr(mesh_lib, "_pool", lambda device: [
        torch.device("cpu"), torch.device("meta")])
    meshes = mesh_lib.make_replica_meshes(2, 1)
    assert [ms.flat for ms in meshes] == [[torch.device("cpu")],
                                          [torch.device("meta")]]
    _, _, _, m, params, sw = _pair()
    for ms in meshes:
        e = Engine.create(m, params, sw, strategy="specee", mesh=ms)
        assert e.shard is None and e.device == ms.flat[0]
        assert {x.device for x in tree_leaves(e.params)} == {ms.flat[0]}
        assert {x.device for x in tree_leaves(e.sw)} == {ms.flat[0]}
        assert {x.device for x in tree_leaves(e.source)} == {
            torch.device("cpu")}
    monkeypatch.setattr(mesh_lib, "_pool", lambda device: [
        torch.device("meta")])
    e = Engine.create(m, params, sw, strategy="specee",
                      mesh=mesh_lib.make_host_mesh(1, 2))
    head = e.params["lm_head"]
    assert isinstance(head["vocab_shards"], Shards)
    assert {x.device for x in tree_leaves(e.params)} == {
        torch.device("meta")}
    assert {x.device for x in tree_leaves(e.source)} == {
        torch.device("cpu")}


LAUNCH = ["--smoke", "--device", "cpu", "--ci"]


@pytest.mark.parametrize("argv,want", [
    (["--mesh", "1,2"], "CI smoke OK (every request done"),
    (["--mesh", "1,2", "--replicas", "2", "--mode", "tree"],
     "CI smoke OK (replica-pool token parity"),
    (["--mesh", "1,4", "--megatick", "2", "--inject", "device_lost"],
     "remeshed tp 4->2")])
def test_launcher_multi_gpu_flags(argv, want, capsys):
    """``--mesh 1,N``, ``--replicas M`` and ``--inject device_lost`` serve
    on the CPU's repeated shard slots, with the launcher's parity checks;
    the launcher reports the slots per device."""
    launch_serve.main(LAUNCH + argv)
    out = capsys.readouterr().out
    assert want in out and "slots per device" in out
    assert "CI smoke OK" in out
