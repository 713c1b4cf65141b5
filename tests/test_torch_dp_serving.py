"""Serving over a ``(DATA, MODEL)`` mesh with DATA > 1 against the JAX
package's UNSHARDED engine (CPU, fp32; weights bridged from JAX; every
mesh slot on the CPU, ``make_host_mesh(D, P, "cpu")``).

The placement of every weight and cache leaf at (2, 2) and (4, 1) equals
JAX's ``param_specs`` and its managers' ``partition_specs`` for tp_dp,
tp2d and fsdp_tp, read through a fake mesh shape, except the documented
differences (``sharding/serving.py``); a (1, P) engine places as before.
Sessions at (2, 1) tp_dp, (2, 2) tp2d and (4, 1) fsdp_tp give JAX's
unsharded tokens, exit points and ``units_run``: llama2-7b with SpecEE
and tree on the dense and the paged cache, ``quant="int8"`` and
``kv_quant``; mamba2-130m, recurrentgemma-9b, dbrx-132b (both MoE forms,
expert parallelism over the rows), qwen3-moe (top-k) and internvl2-26b
(dense, patches split by row); hubert-xlarge's frame logits. llama2-7b
SpecEE, mamba2 and recurrentgemma admit per row (each family's per-row
insert), the rest by a whole-batch prefill split over the rows. At (2, 2)
the hidden rows equal the (1, 2) engine's; ``ServingEngine`` at (2, 2)
serves blocking and chunked admission, megaticks and an evicting pool as
JAX's unsharded engine does; snapshots restore across (2, 2), (1, 2) and
unsharded; ``device_lost`` remeshes to (1, new_tp); the 'data'
collectives of one step are counted.

Tolerance: tokens, exit points and ``units_run`` exact; frame logits and
hidden rows atol = rtol = 1e-5 (fp32: a row's GEMMs over B / D rows may
block their sums otherwise than over B; the expert-parallel MoE adds its
rows' partials in another order)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.api import CacheSpec as JCacheSpec  # noqa: E402
from repro.api import Engine as JEngine  # noqa: E402
from repro.api.cache import make_cache_manager as jmake_mgr  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.data import DataPipeline as JPipeline  # noqa: E402
from repro.models.model import ModelFlags as JFlags  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro.sharding import policies as jpol  # noqa: E402
from repro.sharding.policies import _path_str  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.api import CacheSpec, Engine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models.model import ModelFlags, build_model  # noqa: E402
from repro_torch.runtime import collectives, faultinject  # noqa: E402
from repro_torch.runtime.faultinject import FaultSchedule  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.sharding.ctx import DataShards, Shards, cut  # noqa: E402
from repro_torch.sharding.rows import layouts  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
VOCAB = 16          # rows exit early: the draft's guesses often hold
MESHES = ((2, 1, "tp_dp"), (2, 2, "tp2d"), (4, 1, "fsdp_tp"))
B = 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small ops: one intra-op thread, so parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_BUILT = {}
_WEIGHTS = {}


def _pair(arch, vocab=VOCAB, specee=True, **flags):
    """(JAX model, params, sw; port model, params, sw) of ``arch``'s smoke
    config at ``vocab`` tokens and ``B`` serving slots, the port's weights
    bridged from JAX's. The weights are made once per (arch, vocab), for
    every set of model flags (they do not depend on them); ``sw`` is None
    without ``specee``."""
    key = (arch, vocab, specee, tuple(sorted(flags.items())))
    if key not in _BUILT:
        runs = []
        for r in (jax_get_config(arch).smoke(), get_config(arch).smoke()):
            model = r.model if vocab is None else dataclasses.replace(
                r.model, vocab_size=vocab)
            runs.append(dataclasses.replace(r, model=model, serve=(
                dataclasses.replace(r.serve, max_batch=B))))
        m_j, m_t = jbuild(runs[0], JFlags(**flags)), build_model(
            runs[1], ModelFlags(**flags))
        wkey = (arch, vocab, specee)
        if wkey not in _WEIGHTS:
            params_j = m_j.init(jax.random.PRNGKey(0))
            params_t = bridge.params_from_numpy(
                jax.tree_util.tree_map(np.asarray, params_j), "cpu",
                torch.float32)
            sw_j = sw_t = None
            if specee:
                sw_j = jeng.init_specee(m_j, jax.random.PRNGKey(1))
                sw_np = jax.tree_util.tree_map(np.asarray, sw_j)
                sw_t = bridge.specee_from_numpy(
                    sw_np.draft, sw_np.predictors, sw_np.offline_mask,
                    "cpu", torch.float32)
            _WEIGHTS[wkey] = (params_j, sw_j, params_t, sw_t)
        params_j, sw_j, params_t, sw_t = _WEIGHTS[wkey]
        _BUILT[key] = (m_j, params_j, sw_j, m_t, params_t, sw_t)
    return _BUILT[key]


def mesh(D, P):
    return make_host_mesh(D, P, "cpu")


# ---------------------------- placement ----------------------------------
class _FakeMesh:
    def __init__(self, D, P):
        self.shape = {"data": D, "model": P}


def _placed_spec(x, nd):
    """The axes a placed leaf splits, one entry per dim (None: whole)."""
    dims = [None] * nd
    if isinstance(x, DataShards):
        if x.dim is not None:
            dims[nd + x.dim] = "data"
        x = x[0]
    if isinstance(x, Shards):
        dims[nd + x.dim] = "model"
    return tuple(dims)


def _flat(tree, prefix=""):
    """{JAX path string: leaf} of a nest of dicts and lists whose leaves
    are tensors, ``Shards`` or ``DataShards``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list) and not isinstance(tree,
                                                   (Shards, DataShards)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _jax_flat(spec_tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda x: isinstance(x, JP))
    return {_path_str(p): tuple(s) for p, s in flat}


def _without_unit_axes(spec, D, P):
    """A spec with the axes of extent 1 dropped (no split)."""
    drop = {a for a, n in (("data", D), ("model", P)) if n == 1}
    return tuple(None if a in drop else a for a in spec)


def _check_cache(m_j, eng, kind, D, P, policy):
    """A session's cache placement equals JAX's manager's specs (B rows),
    the per-row entries of a paged cache split over 'data' (documented)."""
    s = eng.new_session(batch=B, max_seq=32, cache=kind)
    jmgr = jmake_mgr(m_j, B, 32, JCacheSpec.resolve(kind, m_j.run.serve))
    want = _jax_flat(jmgr.partition_specs(jmgr.empty_cache(),
                                          _FakeMesh(D, P), policy))
    got = _flat(s._state.cache)
    for path, spec in want.items():
        x = got[path]
        nd = len(spec)
        spec = _without_unit_axes(spec, D, P)
        if kind == "paged" and path.endswith(("/h", "/state", "/conv")):
            spec = (None, "data") + spec[2:]
        assert _placed_spec(x, nd) == spec, (kind, path)
    return s


@pytest.mark.parametrize("policy", ["tp_dp", "tp2d", "fsdp_tp"])
def test_placement_matches_jax_specs(policy):
    """Every weight leaf at (2, 2) and (4, 1) is placed by JAX's
    ``param_specs``: cut over 'data' where the spec names it (tp2d's second
    dim, fsdp_tp's largest, the MoE experts under every policy), a
    ``Shards`` where it names 'model', each slice equal to the whole
    tensor's. Documented differences: the LM head is held as at (1, P)
    (whole on the lead beside row 0's vocabulary slices) and Mamba2's
    head-aligned SSD leaves follow ``ssd.param_segs`` in each row. The
    caches: JAX's dense and paged ``partition_specs``, the pools a copy
    per row. A (1, 2) engine's placement is the (1, P) layout, unchanged:
    no ``DataShards``, every ``Shards`` part cut from the whole."""
    for arch in ("llama2-7b", "dbrx-132b", "mamba2-130m"):
        m_j, pj, _, m_t, pt, _ = _pair(arch)
        shapes = jax.tree_util.tree_map(np.asarray, pj)
        whole = _flat(pt)
        for D, P in ((2, 2), (4, 1)):
            want = _jax_flat(jpol.param_specs(m_j, _FakeMesh(D, P), policy,
                                              shapes))
            e = Engine.create(m_t, pt, None, strategy="dense",
                              mesh=mesh(D, P), policy=policy)
            got = _flat(e.params)
            table = layouts(m_t)["ssd"] if arch == "mamba2-130m" else {}
            for path, spec in want.items():
                if path.startswith("lm_head"):
                    assert isinstance(got[path], torch.Tensor)
                    continue
                x = got[path]
                assert isinstance(x, DataShards), path
                spec = _without_unit_axes(spec, D, P)
                placed = _placed_spec(x, len(spec))
                layout = table.get(path.split("/ssd/")[-1]) \
                    if P > 1 and "/ssd/" in path else None
                if layout is not None and x.dim != layout[0]:
                    assert (x[0].dim, x[0].segs) == layout, path
                    assert [a == "data" for a in placed] == \
                        [a == "data" for a in spec], path
                else:
                    assert placed == spec, (arch, path)
                if x.dim is not None:
                    n = whole[path].shape[x.dim] // D
                    for d, entry in enumerate(x):
                        piece = whole[path].narrow(x.dim, d * n, n)
                        if isinstance(entry, Shards):
                            piece = cut(piece, entry.dim, entry.segs, 0, P)
                            entry = entry[0]
                        assert torch.equal(entry, piece), (arch, path, d)
            if arch == "llama2-7b":
                for kind in ("dense", "paged"):
                    _check_cache(m_j, e, kind, D, P, policy)
        e = Engine.create(m_t, pt, None, strategy="dense", mesh=mesh(1, 2),
                          policy=policy)
        for path, x in _flat(e.params).items():
            assert not isinstance(x, DataShards), path
            if isinstance(x, Shards) and x.segs is not None:
                for s, part in enumerate(x):
                    assert torch.equal(part, cut(whole[path], x.dim, x.segs,
                                                 s, 2)), path


# ------------------------------ sessions ---------------------------------
def _decode(E, m, params, sw, strategy, cache, mesh=None, policy="tp_dp",
            quant=None, patches=None, per_row=True, K=2, new=8):
    """A B-row session: ``prefill_row`` per slot (a batch-1 admission on
    row 0, inserted into its data row), or (``per_row`` False, or
    ``patches``) one whole-batch ``prefill``, split over the data rows;
    then megaticks of K. Returns each step's tokens, exit points and
    units_run."""
    kw = dict(mesh=mesh, policy=policy) if mesh is not None else {}
    e = E.create(m, params, sw, strategy=strategy, quant=quant, **kw)
    V = m.run.model.vocab_size
    prompts = np.random.default_rng(7).integers(0, V, (B, 8))
    if per_row and patches is None:
        s = e.new_session(batch=B, max_seq=48, cache=cache)
        out = [[s.prefill_row(b, prompts[b], max_new_tokens=new)
                for b in range(B)]]
    else:
        s = e.new_session(cache=cache)
        batch = (prompts if patches is None
                 else {"tokens": prompts, "patches": patches})
        r = s.prefill(batch, max_new_tokens=new, max_seq=48)
        out = [np.asarray(r.tokens).tolist()]
    while not s.all_done():
        r = s.step(num_ticks=K)
        out.append((np.asarray(r.tokens).tolist(),
                    np.asarray(r.exit_layer).tolist(), int(r.units_run)))
    return out


# arch, strategy, caches, flags, quant, admission: per row ("row": the
# llama, SSD and RG-LRU states' per-row inserts) or whole-batch ("batch":
# the prefill split over the rows; JAX's per-row admission is most of this
# file's time)
_CASES = {
    "llama_specee": ("llama2-7b", "specee", ("dense", "paged"), {}, None,
                     "row"),
    "llama_tree": ("llama2-7b", "tree", ("dense", "paged"), {}, None,
                   "batch"),
    "llama_int8": ("llama2-7b", "specee", ("paged",), {}, "int8", "batch"),
    "llama_kv_quant": ("llama2-7b", "specee", ("paged",),
                       dict(kv_quant=True), None, "batch"),
    "mamba2": ("mamba2-130m", "specee", ("dense", "paged"), {}, None,
               "row"),
    "recurrentgemma": ("recurrentgemma-9b", "specee", ("dense", "paged"),
                       {}, None, "row"),
    "dbrx_dense": ("dbrx-132b", "specee", ("dense",), {}, None, "batch"),
    "dbrx_topk": ("dbrx-132b", "specee", ("paged",), dict(moe_impl="topk"),
                  None, "batch"),
    "qwen3_topk": ("qwen3-moe-235b-a22b", "specee", ("paged",),
                   dict(moe_impl="topk"), None, "batch"),
    "internvl2": ("internvl2-26b", "dense", ("dense",), {}, None, "batch"),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_tokens_match_jax_unsharded(case):
    """Each case at (2, 1) tp_dp, (2, 2) tp2d and (4, 1) fsdp_tp, on each
    of its caches: JAX's unsharded engine's tokens, exit points and
    ``units_run`` (JAX's run on the first cache: its dense and paged
    layouts decode alike)."""
    arch, strategy, caches, flags, quant, admission = _CASES[case]
    m_j, pj, sj, m_t, pt, st = _pair(arch, specee=strategy != "dense",
                                     **flags)
    patches = None
    if arch == "internvl2-26b":
        patches = np.random.default_rng(3).standard_normal(
            (B, 8, 1024)).astype(np.float32)
    per_row = admission == "row"
    want = _decode(JEngine, m_j, pj, sj, strategy, caches[0], quant=quant,
                   patches=None if patches is None else jnp.asarray(patches),
                   per_row=per_row)
    for cache in caches:
        for D, P, policy in MESHES:
            got = _decode(Engine, m_t, pt, st, strategy, cache, mesh(D, P),
                          policy, quant, patches, per_row)
            assert got == want, (case, cache, D, P, policy)


def test_encoder_frame_logits_match_jax():
    """hubert-xlarge: ``Model.prefill`` over a (D, P) engine's params
    splits the frames by row; every frame's logits equal JAX's unsharded
    prefill within TOL, no cache."""
    m_j, pj, _, m_t, pt, _ = _pair("hubert-xlarge", vocab=None,
                                   specee=False)
    frames = JPipeline(m_j.cfg, B, 16, seed=0).next()["frames"]
    want, cache_j, _ = m_j.prefill(pj, {"frames": jnp.asarray(frames)})
    for D, P, policy in MESHES:
        e = Engine.create(m_t, pt, None, strategy="dense", mesh=mesh(D, P),
                          policy=policy)
        with torch.no_grad():
            got, cache, _ = e.model.prefill(
                e.params, {"frames": torch.from_numpy(frames)})
        assert cache is None and cache_j is None
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_hidden_rows_match_one_row_engine():
    """At (2, 2) tp2d the fp32 hidden rows of every step (``h_last``) are
    allclose to the (1, 2) engine's within TOL; whether they came out
    bit-equal is printed."""
    _, _, _, m, params, sw = _pair("llama2-7b")
    prompts = np.random.default_rng(4).integers(0, VOCAB, (B, 8))

    def hiddens(mesh_, policy):
        e = Engine.create(m, params, sw, strategy="specee", mesh=mesh_,
                          policy=policy)
        s = e.new_session(cache="paged")
        s.prefill(prompts, max_new_tokens=6)
        out = [s._state.h_last.clone()]
        while not s.all_done():
            s.step()
            out.append(s._state.h_last.clone())
        return out

    want = hiddens(mesh(1, 2), "tp_dp")
    got = hiddens(mesh(2, 2), "tp2d")
    assert len(got) == len(want)
    worst = max(float((g - w).abs().max()) for g, w in zip(got, want))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)
    print(f"(2, 2) hidden rows against (1, 2): max |diff| {worst:.3g}, "
          f"bit-equal {all(torch.equal(g, w) for g, w in zip(got, want))}")


# ------------------------------ serving ----------------------------------
def _prompts(n=6, seed=5):
    """``n`` prompts of two lengths (JAX compiles a prefill per length)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, (5, 9)[i % 2]) for i in range(n)]


def _serve(S, m, p, s, prompts, CS, **kw):
    if kw.pop("tight", False):
        kw["cache"] = CS(kind="paged", page_size=16, num_pages=16)
    se = S(m, p, s, strategy="specee", **kw)
    for x in prompts:
        se.submit(x, max_new_tokens=6)
    se.run_to_completion()
    se.close()
    return se, {r.uid: (list(r.output), list(r.exit_points))
                for r in se.completed}


_SERVE = {"blocking": dict(prefill_chunk=0),
          "chunked": dict(prefill_chunk=4),
          "megatick": dict(megatick=2),
          "evicting": dict(tight=True, prefill_chunk=0)}
_SERVE_REF = {}


def _serve_ref(case):
    """JAX's unsharded engine's outputs for ``case``: its own run where the
    pool evicts, else its blocking run (JAX's chunked admission and
    megaticks give the blocking outputs: ``tests/test_paged_cache.py``,
    ``tests/test_megatick.py``)."""
    case = "evicting" if case == "evicting" else "blocking"
    if case not in _SERVE_REF:
        m_j, pj, sj, _, _, _ = _pair("llama2-7b")
        _SERVE_REF[case] = _serve(JServingEngine, m_j, pj, sj, _prompts(),
                                  JCacheSpec, **_SERVE[case])
    return _SERVE_REF[case]


@pytest.mark.parametrize("case", list(_SERVE))
def test_serving_engine_2x2_matches_jax(case):
    """``ServingEngine(mesh=(2, 2), policy="tp2d")``: blocking and chunked
    admission, megaticks of 2 and a 16-page pool that evicts and replays
    give JAX's unsharded outputs and exit points; every page comes back;
    ``tp_degree`` is the model extent."""
    _, _, _, m, p, s = _pair("llama2-7b")
    jse, want = _serve_ref(case)
    se, got = _serve(ServingEngine, m, p, s, _prompts(), CacheSpec,
                     mesh=mesh(2, 2), policy="tp2d", **_SERVE[case])
    assert got == want and se.tp_degree == 2
    evicts = [e for e in se.fault_log if e.action == "evict"]
    assert len(evicts) == len([e for e in jse.fault_log
                               if e.action == "evict"])
    assert (case == "evicting") == bool(evicts)
    mgr = se.session.cache_mgr
    assert mgr.free_pages == mgr.num_pages


def test_device_lost_2x2_remeshes_to_one_row():
    """A (2, 2) engine losing its highest device remeshes to JAX's
    ``(1, new_tp)`` over the survivors (tp 2 -> 2 of three devices),
    token-identical to JAX's fault-free unsharded run."""
    _, _, _, m, p, s = _pair("llama2-7b")
    _, want = _serve_ref("megatick")
    with faultinject.injected(FaultSchedule.once("device_lost", visit=2)):
        se, got = _serve(ServingEngine, m, p, s, _prompts(), CacheSpec,
                         mesh=mesh(2, 2), policy="tp2d", megatick=2)
    assert got == want
    assert se.engine.mesh.shape == {"data": 1, "model": 2}
    assert se.engine.rows is None and se.tp_degree == 2
    assert [e.detail.split(" readmitted")[0] for e in se.fault_log
            if e.action == "remesh"] == ["tp 2->2"]


def test_snapshot_restores_across_meshes():
    """A paged (2, 2) session's snapshot (the pools joined page by page
    from the rows that own them) restores at (1, 2) and unsharded with the
    same drain; an unsharded and a (1, 2) snapshot restore at (2, 2)."""
    _, _, _, m, params, sw = _pair("llama2-7b")
    prompts = np.random.default_rng(9).integers(0, VOCAB, (B, 8))

    def session(mesh_):
        e = Engine.create(m, params, sw, strategy="specee", mesh=mesh_,
                          policy="tp2d")
        return e.new_session(batch=B, max_seq=48, cache="paged")

    def drain(s):
        out = [[] for _ in range(B)]
        while not s.all_done():
            r = s.step()
            for b in range(B):
                out[b].extend(int(t) for t in r.row_tokens(b))
        return out

    for src, dsts in ((mesh(2, 2), (mesh(1, 2), None)),
                      (None, (mesh(2, 2),)), (mesh(1, 2), (mesh(2, 2),))):
        a = session(src)
        for b in range(B):
            a.prefill_row(b, prompts[b], max_new_tokens=10)
        a.step()
        a.step()
        state, meta = a.snapshot()
        k = state.cache["segments"][0]["u0"]["k"]
        assert isinstance(k, torch.Tensor)
        ref = drain(a)
        for dst in dsts:
            s = session(dst)
            s.restore(state, meta)
            assert drain(s) == ref, (src, dst)


def test_data_collectives_per_step():
    """One step's 'data' collectives (``collectives.COUNTS``): tp2d
    gathers each unit's cut weights for each row; tp_dp without MoE moves
    nothing over 'data'; dbrx's expert parallelism at tp_dp gathers the
    tokens and reduce-scatters the outputs."""
    def counts(arch, policy, **flags):
        _, _, _, m, p, s = _pair(arch, **flags)
        e = Engine.create(m, p, s, strategy="specee", mesh=mesh(2, 2),
                          policy=policy)
        sess = e.new_session(cache="dense")
        sess.prefill(np.random.default_rng(1).integers(0, VOCAB, (B, 6)),
                     max_new_tokens=4)
        collectives.reset_counts()
        sess.step()
        return {k: dict(v) for k, v in collectives.COUNTS.items()}

    tp2d = counts("llama2-7b", "tp2d")
    assert tp2d["all-gather"]["calls"] > 0 and tp2d["all-gather"]["bytes"]
    assert tp2d["reduce-scatter"]["calls"] == 0
    tp_dp = counts("llama2-7b", "tp_dp")
    assert all(c["calls"] == 0 for c in tp_dp.values())
    ep = counts("dbrx-132b", "tp_dp")
    assert ep["all-gather"]["calls"] > 0 and \
        ep["reduce-scatter"]["calls"] > 0
