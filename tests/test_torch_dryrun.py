"""The dry run on the torch meta device (``repro_torch.launch.specs``,
``repro_torch.launch.dryrun``) against JAX's ``repro.launch.specs`` and
``repro.launch.dryrun`` (CPU; no JAX step is lowered: JAX's analytic
per-device argument bytes come from its ``input_specs`` over a mesh that
is only a ``.shape``, as ``tests/test_sharding.py`` reads its specs).

* The shape cells, their skip rules and each arch's serving policy equal
  JAX's.
* Each placed argument leaf's bytes per slot equal JAX's per-device
  bytes (``dryrun.py:196-206``) leaf by leaf on the lead slot and as the
  largest slot, except the named placements of ``sharding/serving.py``,
  each held to its own expected bytes: the LM head whole on the lead
  beside its vocabulary slices, the SpecEE weights and the decode state
  between the units whole on the lead (JAX's PRNG key is the port's
  integer seed), the batch whole on the lead, KV heads fewer than the
  degree held whole by P / KVH shards each. Cells: llama2-7b's smoke
  config at (2, 2) (train at fsdp_tp; prefill and decode at tp_dp and
  tp2d), llama2-70b's at (2, 4) (two KV heads over four shards) and
  llama2-7b at full width on a (16, 16) mesh (placement alone).
* The meta step runs every unit and counts the collectives of both axes
  that the same step counts on CPU tensors at (2, 2); its flops equal
  ``FlopCounterMode``'s and its outputs' shapes and dtypes those of the
  step run without the dry run's mode.
* The collectives are one device's: (2, 2) makes (1, 2)'s 'model' calls
  and (2, 1)'s 'data' calls, on its share of the batch and the weights.
* ``ModelFlags``' lowering hints change no token and no logit.
* The CLI writes JAX's keys and exits 0, or 1 when a cell raises;
  ``--multi-pod`` refuses a spec naming 'data' alone.
* dbrx-132b (expert parallelism at (2, 2)) and mamba2-130m decode on
  meta at smoke size.

Tolerance: bytes, counts and flops exact; tokens and logits bit-equal.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import config as jconfig  # noqa: E402
from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models.model import ModelFlags as JFlags  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.sharding.policies import _path_str  # noqa: E402
from repro_torch import config as tconfig  # noqa: E402
from repro_torch.api import Engine  # noqa: E402
from repro_torch.config import ShapeCell  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.core import engine as eng  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.specs import input_specs  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.models.model import ModelFlags, build_model  # noqa: E402
from repro_torch.runtime import collectives  # noqa: E402
from repro_torch.sharding.serving import vocab_widths  # noqa: E402

SMALL = {"train": ShapeCell("train_4k", "train", 32, 4),
         "prefill": ShapeCell("prefill_32k", "prefill", 32, 4),
         "decode": ShapeCell("decode_32k", "decode", 64, 4)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Smoke-sized ops: one intra-op thread, so that the test run's
    parallel workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _FakeMesh:
    def __init__(self, D, P):
        self.shape = {"data": D, "model": P}


def _runs(arch, policy=None, smoke=True):
    """(port run, JAX run) of ``arch``, smoke-sized, at ``policy``."""
    t, j = get_config(arch), jax_get_config(arch)
    if smoke:
        t, j = t.smoke(), j.smoke()
    if policy is not None:
        t = dataclasses.replace(t, sharding=dataclasses.replace(
            t.sharding, policy=policy))
        j = dataclasses.replace(j, sharding=dataclasses.replace(
            j.sharding, policy=policy))
    return t, j


def _jax_bytes(jrun, cell, D, P):
    """JAX's analytic per-device bytes of each argument leaf, by path."""
    jcell = jconfig.ShapeCell(cell.name, cell.kind, cell.seq_len,
                              cell.global_batch)
    args, specs = jspecs.input_specs(jbuild(jrun, JFlags()), jcell,
                                     _FakeMesh(D, P))
    flat = jax.tree_util.tree_flatten_with_path(args)[0]
    sflat = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, JP))
    assert len(flat) == len(sflat)
    out = {}
    for (path, leaf), spec in zip(flat, sflat):
        shard = 1
        for ax in jax.tree_util.tree_leaves(tuple(spec)):
            shard *= {"data": D, "model": P}[ax]
        out[_path_str(path)] = (int(np.prod(leaf.shape)) * leaf.dtype.itemsize
                                // shard, leaf)
    return out


def _placed(run, cell, D, P):
    model = build_model(run, dryrun.dryrun_flags(run, cell, False, False, D))
    args, _ = input_specs(model, cell, _FakeMesh(D, P))
    placed, _, _ = dryrun.place(model, run, cell,
                                make_host_mesh(D, P, "meta"), args, False)
    return placed


def _leaf_slot_bytes(tree, D, P):
    """``dryrun.slot_bytes`` leaf by leaf, keyed by path."""
    out = {}

    def add(path, d, m, n):
        out.setdefault(path, [[0] * P for _ in range(D)])[d][m] += n
    dryrun.walk_slots(tree, add)
    return out


def _whole(leaf):
    return int(np.prod(leaf.shape)) * leaf.dtype.itemsize


def _check_bytes(run, jrun, cell, D, P, kv_rep=1):
    """Each placed leaf's slots against JAX's per-device bytes; the named
    placements against their own. ``kv_rep``: P / KVH where the degree
    exceeds the KV heads (the port's copies of each KV head)."""
    want = _jax_bytes(jrun, cell, D, P)
    got = _leaf_slot_bytes(_placed(run, cell, D, P), D, P)
    lead_only = lambda n: [[n if (d, m) == (0, 0) else 0  # noqa: E731
                            for m in range(P)] for d in range(D)]
    named = 0
    for path, (jb, leaf) in want.items():
        key = path.split("/", 1)[1] if "/" in path else path
        if path == "2/.prng":                    # the port's int seed
            assert path not in got
            named += 1
            continue
        slots = got[path]
        whole = _whole(leaf)
        if key == "lm_head/w" and cell.kind != "train":
            # whole on the lead beside the vocabulary slices
            assert slots == lead_only(whole), path
            named += 1
        elif cell.kind == "decode" and path.startswith("1/"):
            assert slots == lead_only(whole), path        # SpecEE weights
            named += 1
        elif path.startswith("2/.") and not path.startswith("2/.cache"):
            assert slots == lead_only(whole), path        # state on lead
            named += 1
        elif (cell.kind != "decode" and path.startswith(
                "2/" if cell.kind == "train" else "1/")):
            assert slots == lead_only(whole), path        # the batch
            named += 1
        elif kv_rep > 1 and (path.endswith(("wk/w", "wv/w", "/k", "/v"))):
            assert max(map(max, slots)) == jb * kv_rep, path
            assert slots[0][0] == jb * kv_rep, path
            named += 1
        else:
            assert max(map(max, slots)) == jb, (path, slots, jb)
            assert slots[0][0] == jb, (path, slots, jb)
    extra = set(got) - set(want)
    if cell.kind != "train":
        head = want["0/lm_head/w"][1]
        Dm, V = head.shape
        assert extra == {"0/lm_head/vocab_shards"}
        item = head.dtype.itemsize
        assert got["0/lm_head/vocab_shards"] == [
            [Dm * w * item for w in vocab_widths(V, P)] if d == 0 else
            [0] * P for d in range(D)]
    else:
        assert not extra
    assert named
    return got


def test_shape_cells_and_policies_match_jax():
    assert tconfig.SHAPES == tuple(
        ShapeCell(*dataclasses.astuple(s)) for s in jconfig.SHAPES)
    assert tconfig.shape_by_name("decode_32k") == ShapeCell(
        *dataclasses.astuple(jconfig.shape_by_name("decode_32k")))
    with pytest.raises(KeyError):
        tconfig.shape_by_name("decode_1m")
    assert ARCHS == list(J_ARCHS)
    for arch in ARCHS:
        t, j = get_config(arch), jax_get_config(arch)
        assert [dataclasses.astuple(c) for c in
                tconfig.applicable_shapes(t.model)] == [
            dataclasses.astuple(c) for c in
            jconfig.applicable_shapes(j.model)], arch
        assert t.model.supports_long_context() == \
            j.model.supports_long_context(), arch
        for f in dataclasses.fields(t.sharding):
            assert getattr(t.sharding, f.name) == getattr(j.sharding,
                                                          f.name), arch


@pytest.mark.parametrize("kind,policy", [
    ("train", "fsdp_tp"), ("prefill", "tp_dp"), ("prefill", "tp2d"),
    ("decode", "tp_dp"), ("decode", "tp2d")])
def test_slot_bytes_match_jax_smoke(kind, policy):
    run, jrun = _runs("llama2-7b", None if kind == "train" else policy)
    _check_bytes(run, jrun, SMALL[kind], 2, 2)


def test_slot_bytes_kv_heads_fewer_than_degree():
    """llama2-70b's smoke config: 2 KV heads over 4 shards, each held
    whole by 2 shards (wk/wv columns and the cache), where JAX splits
    head_dim columns and the cache's sequence evenly."""
    run, jrun = _runs("llama2-70b", "tp2d")
    assert run.model.num_kv_heads == 2
    _check_bytes(run, jrun, SMALL["decode"], 2, 4, kv_rep=2)


def test_slot_bytes_match_jax_full_width():
    """llama2-7b at published width on the (16, 16) production mesh,
    decode_32k, placement alone: the lead's extra leaves are the draft
    cache, the LM head and the SpecEE weights."""
    run, jrun = _runs("llama2-7b", smoke=False)
    cell = tconfig.shape_by_name("decode_32k")
    got = _check_bytes(run, jrun, cell, 16, 16)
    lead = sum(s[0][0] for s in got.values())
    other = sum(s[1][1] for s in got.values())
    want = _jax_bytes(jrun, cell, 16, 16)
    draft = sum(_whole(leaf) for p, (_, leaf) in want.items()
                if p.startswith("2/.draft_cache"))
    assert draft == 2 * 128 * 32768 * 4096 * 2          # K and V, bf16
    assert lead > other + draft


def _cpu_step(run, cell, D, P, seed=0):
    """The same step as the dry run's, on CPU tensors over a (D, P) mesh
    of CPU slots: its collectives by axis and its units_run. The caller
    gives the decode step meta's branches (``_meta_branches``)."""
    model = build_model(run, dryrun.dryrun_flags(run, cell, False, False, D))
    gen = torch.Generator().manual_seed(seed)
    mesh = make_host_mesh(D, P, "cpu")
    params = model.init(gen, "cpu")
    if cell.kind == "train":
        from repro_torch.launch.specs import batch_struct
        batch = {k: torch.randint(0, run.model.vocab_size, x.shape,
                                  generator=gen, dtype=x.dtype)
                 for k, x in batch_struct(model, cell).items()}
        params = tree_map(lambda x: x.float() if x.is_floating_point()
                          else x, params)
        args = (params, None, batch)
    elif cell.kind == "prefill":
        args = (params, {"tokens": torch.randint(
            0, run.model.vocab_size, (cell.global_batch, cell.seq_len),
            generator=gen, dtype=torch.int32)})
    else:
        args = (params, eng.init_specee(model, gen, "cpu"), None)
    placed, step_model, pspec = dryrun.place(model, run, cell, mesh, args,
                                             False)
    fn = dryrun.step_fn_for(step_model, run, cell, data_extent=D,
                            param_pspec=pspec)
    collectives.reset_counts()
    out = fn(*placed)
    counts = {ax: {k: dict(c) for k, c in rec.items()}
              for ax, rec in collectives.PER_DEVICE.items()}
    return counts, (out[-1] if cell.kind == "decode" else None)


def _meta_branches(monkeypatch):
    """The decode step's host reads answer as on meta (every unit, every
    exit point's gate and verify), so a step on values takes the dry
    run's branches: random weights would exit or skip a verify where
    their values say so."""
    monkeypatch.setattr(eng, "host_read", lambda flag, on_meta: on_meta)


@pytest.mark.parametrize("kind,policy", [
    ("decode", "tp2d"), ("prefill", "tp_dp"), ("train", None)])
def test_meta_step_counts_equal_cpu_step(kind, policy, monkeypatch):
    run, _ = _runs("llama2-7b", policy)
    cell = SMALL[kind]
    r = dryrun.run_cell("llama2-7b", cell.name,
                        mesh=make_host_mesh(2, 2, "meta"), run=run,
                        cell=cell)
    _meta_branches(monkeypatch)
    counts, units_run = _cpu_step(run, cell, 2, 2)
    assert r["collectives_exact"]["by_axis"] == counts
    model_calls = sum(c["calls"] for c in counts["model"].values())
    assert model_calls > 0
    if kind != "prefill":
        assert sum(c["calls"] for c in counts["data"].values()) > 0
    assert r["collectives"]["total_bytes"] == sum(
        c["bytes"] for rec in counts.values() for c in rec.values())
    if kind == "decode":
        assert r["units_run"] == r["units"] == units_run == 4


def _per_device(run, kind, D, P):
    r = dryrun.run_cell("llama2-7b", SMALL[kind].name,
                        mesh=make_host_mesh(D, P, "meta"), run=run,
                        cell=SMALL[kind])
    return {ax: {k: (c["calls"], c["bytes"]) for k, c in rec.items()
                 if c["calls"]}
            for ax, rec in r["collectives_exact"]["by_axis"].items()}


@pytest.mark.parametrize("kind,policy", [
    ("decode", "tp_dp"), ("decode", "tp2d"), ("prefill", "tp_dp"),
    ("prefill", "tp2d"), ("train", None)])
def test_collectives_are_per_device(kind, policy):
    """One device's collectives: the 'model' ones of (2, 2) are (1, 2)'s
    calls, each on its row's half of the batch (the decode step's
    embedding, before the rows split, on the whole batch), and the 'data'
    ones of (2, 2) are (2, 1)'s calls, each gathering one model shard's
    half of the cut weights; a (1, P) or (D, 1) mesh moves nothing over
    the axis it lacks. Train takes JAX's microbatch per data extent, so
    only its (2, 1) and (2, 2) share a step."""
    run, _ = _runs("llama2-7b", policy)
    c12, c21, c22 = (_per_device(run, kind, D, P)
                     for D, P in ((1, 2), (2, 1), (2, 2)))
    assert not c21["model"] and not c12["data"]
    assert {k: n for k, (n, _) in c22["data"].items()} == \
        {k: n for k, (n, _) in c21["data"].items()}
    if kind == "train":
        for k in ("all-gather", "reduce-scatter"):
            assert c22["data"][k][1] * 2 == c21["data"][k][1], k
        assert c22["model"]["all-reduce"][0] > 0
        return
    assert {k: n for k, (n, _) in c22["model"].items()} == \
        {k: n for k, (n, _) in c12["model"].items()}
    if policy == "tp_dp":
        assert not c22["data"]
    else:
        assert c22["data"]["all-gather"][1] * 2 == \
            c21["data"]["all-gather"][1]
    n, b12 = c12["model"]["all-reduce"]
    b22 = c22["model"]["all-reduce"][1]
    if kind == "prefill":
        assert b22 * 2 == b12
    else:                               # the embedding on the whole batch
        assert b22 == b12 // n * (1 + (n - 1) // 2)
        assert c22["model"]["all-gather"] == c12["model"]["all-gather"]


def test_backward_reduce_counts_the_lead_row_once():
    """``count_backward_reduce`` counts one 'model' all-reduce of the
    gradient's bytes per tensor on data row 0, none on another row and
    none without a gradient."""
    collectives.reset_counts()
    xs = [torch.ones(3, 4, requires_grad=True) for _ in range(2)]
    for x in collectives.each_row(xs):
        collectives.count_backward_reduce(x)
    with torch.no_grad():
        collectives.count_backward_reduce(torch.ones(2, requires_grad=True))
    sum((x * 2).sum() for x in xs).backward()
    assert collectives.PER_DEVICE["model"]["all-reduce"] == {
        "calls": 1, "bytes": 48}
    assert collectives.COUNTS["all-reduce"]["calls"] == 0


def test_meta_step_flops_and_outputs():
    """``MetaStep``'s flops equal ``FlopCounterMode``'s over the same
    step, and its pointwise answers give the outputs the meta kernels
    give (shapes and dtypes)."""
    from torch.utils.flop_counter import FlopCounterMode
    run, _ = _runs("llama2-7b", "tp2d")
    for kind in ("decode", "train"):
        cell = SMALL[kind]
        model = build_model(run, dryrun.dryrun_flags(run, cell, False,
                                                     False, 2))
        mesh = make_host_mesh(2, 2, "meta")
        outs, flops = [], []
        for mode in ("meta", "counter"):
            args, _ = input_specs(model, cell, _FakeMesh(2, 2))
            placed, sm, ps = dryrun.place(model, run, cell, mesh, args,
                                          False)
            fn = dryrun.step_fn_for(sm, run, cell, data_extent=2,
                                    param_pspec=ps)
            if mode == "meta":
                with dryrun.MetaStep() as m:
                    out = fn(*placed)
                flops.append(m.flops)
                assert m.peak > 0
            else:
                with FlopCounterMode(display=False) as fc:
                    out = fn(*placed)
                flops.append(fc.get_total_flops())
            outs.append([(tuple(x.shape), x.dtype) for x in tree_leaves(out)
                         if isinstance(x, torch.Tensor)])
        assert flops[0] == flops[1] > 0, kind
        assert outs[0] == outs[1], kind


def test_lowering_hints_change_nothing():
    """JAX's act_pin_full / act_seq_shard / unroll: JAX's defaults, and
    the tokens and logits of a SpecEE session are unchanged when set."""
    for name in ("act_pin_full", "act_seq_shard", "unroll"):
        assert getattr(ModelFlags(), name) == getattr(JFlags(), name) \
            is False
    run = get_config("llama2-7b").smoke()
    gen = torch.Generator().manual_seed(3)
    base = build_model(run)
    params = base.init(gen, "cpu")
    sw = eng.init_specee(base, gen, "cpu")
    prompts = np.random.default_rng(4).integers(0, 512, (2, 12))
    outs = []
    for flags in (ModelFlags(), ModelFlags(act_pin_full=True,
                                           act_seq_shard=True, unroll=True)):
        m = build_model(run, flags)
        logits, _, _ = m.prefill(params, {"tokens": torch.as_tensor(
            prompts, dtype=torch.int32)})
        s = Engine.create(m, params, sw, strategy="specee").new_session()
        first = s.prefill(prompts, max_new_tokens=5)
        toks = [list(first.row_tokens(b)) for b in range(2)]
        while not s.all_done():
            r = s.step()
            for b in range(2):
                toks[b].extend(int(t) for t in r.row_tokens(b))
        outs.append((logits, toks))
    assert torch.equal(outs[0][0], outs[1][0])
    assert outs[0][1] == outs[1][1]


JAX_KEYS = {"arch", "shape", "mesh", "devices", "lower_s", "compile_s",
            "loop_scale", "units", "memory", "analytic_arg_bytes_per_device",
            "cost", "collectives", "collectives_exact"}


def _small_cli(monkeypatch, D, P):
    """The CLI at smoke size: smoke configs, ``SMALL``'s cells, a (D, P)
    mesh of meta slots."""
    monkeypatch.setattr(dryrun, "get_config",
                        lambda a: get_config(a).smoke())
    monkeypatch.setattr(dryrun, "shape_by_name", lambda n: dataclasses.replace(
        SMALL[tconfig.shape_by_name(n).kind], name=n))
    monkeypatch.setattr(dryrun, "DATA", D)
    monkeypatch.setattr(dryrun, "MODEL", P)


def test_cli_writes_jax_keys(monkeypatch, tmp_path, capsys):
    _small_cli(monkeypatch, 2, 2)
    out = tmp_path / "dry.json"
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "llama2-7b", "--shape", "decode_32k",
                     "--out", str(out)])
    assert e.value.code == 0
    (r,) = json.loads(out.read_text())
    assert JAX_KEYS <= set(r)
    assert r["compile_s"] is None and r["units"] == r["units_run"] == 4
    assert r["mesh"] == "2x2" and r["devices"] == 4
    assert set(r["collectives_exact"]["by_axis"]) == {"data", "model"}
    assert r["analytic_arg_bytes_per_device"] == max(
        map(max, r["analytic_arg_bytes_per_slot"]))
    assert "1/1 cells ran on meta" in capsys.readouterr().out


def test_cli_exits_1_when_a_cell_raises(monkeypatch, tmp_path, capsys):
    _small_cli(monkeypatch, 1, 3)        # 3 shards over 4 heads: refused
    out = tmp_path / "dry.json"
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "llama2-7b", "--shape", "prefill_32k",
                     "--out", str(out)])
    assert e.value.code == 1
    (r,) = json.loads(out.read_text())
    assert "multi-GPU" in r["error"]
    assert "FAILED" in capsys.readouterr().out


def test_multi_pod_rows_and_refusal():
    """(pod, data) entries read as one row axis; a spec naming 'data'
    alone (dbrx's 4 smoke experts over 2 x 4 rows fall back to 'data')
    is refused."""
    run, _ = _runs("llama2-7b")
    r = dryrun.run_cell("llama2-7b", "decode_32k", multi_pod=True,
                        mesh=make_host_mesh(4, 2, "meta"), run=run,
                        cell=SMALL["decode"])
    assert r["mesh"] == "2x2x2" and r["devices"] == 8
    run, _ = _runs("dbrx-132b")
    with pytest.raises(ValueError, match="multi-GPU"):
        dryrun.run_cell("dbrx-132b", "decode_32k", multi_pod=True,
                        mesh=make_host_mesh(8, 1, "meta"), run=run,
                        cell=SMALL["decode"])


@pytest.mark.parametrize("arch", ["dbrx-132b", "mamba2-130m"])
def test_other_families_decode_on_meta(arch):
    run, _ = _runs(arch)
    r = dryrun.run_cell(arch, "decode_32k", mesh=make_host_mesh(2, 2, "meta"),
                        run=run, cell=SMALL["decode"])
    assert r["units_run"] == r["units"] == len(run.model.blocks())
    assert r["cost"]["flops"] > 0
    by = r["collectives_exact"]["by_axis"]
    assert by["model"]["all-reduce"]["calls"] > 0
    if arch == "dbrx-132b":        # experts over the rows: EP's gathers
        assert by["data"]["all-gather"]["calls"] > 0
        assert by["data"]["reduce-scatter"]["calls"] > 0
