"""The port's sharding policies, paged pool layout and sharded verify
against the JAX package's (``tests/test_sharding.py``'s cases).

Specs are computed from shapes alone: one tree of zero-stride numpy arrays
at each config's published size goes to JAX's ``repro.sharding`` functions
and to the port's, and every leaf's spec must be equal (the port's ``Spec``
reads as JAX's ``PartitionSpec``), for every arch × policy on a 16 x 16
extent mesh and on the (1, 4) mesh the port serves. The sharded verify's
plain versions at P = 2 and 4 and V = 512, 509 and 500 (509 and 500 leave
the last vocabulary slice narrower), with forced cross-shard ties, must be
bit-equal in tokens and values to JAX's unsharded ``verify_*``
(impl="ref"). Tolerance: exact everywhere."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import sharding as jsharding  # noqa: E402
from repro.api.cache import CacheSpec as JCacheSpec  # noqa: E402
from repro.api.cache import make_cache_manager as jmake_mgr  # noqa: E402
from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core.paged import pool_partition_dims as jpool_dims  # noqa: E402
from repro.kernels.exit_gate import ops as jops  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.sharding.policies import _path_str  # noqa: E402
from repro_torch.api.cache import CacheSpec, make_cache_manager  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.core import engine as eng  # noqa: E402
from repro_torch.core.paged import pool_partition_dims  # noqa: E402
from repro_torch.kernels.exit_gate import ops as tops  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim.adamw import AdamWState  # noqa: E402
from repro_torch.sharding import ShardCtx  # noqa: E402
from repro_torch.sharding import policies as pol  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small ops: one intra-op thread, so parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Mesh16:
    shape = {"data": 16, "model": 16}


class Mesh14:
    shape = {"data": 1, "model": 4}


MESHES = {"16x16": Mesh16(), "1x4": Mesh14()}
POLICIES = ("tp_dp", "tp2d", "fsdp_tp")


def _zeros(shape):
    """A numpy array of ``shape`` that holds no memory (zero strides)."""
    return np.broadcast_to(np.float32(0), tuple(shape))


_SHAPES = {}


def _shapes(arch):
    """(params, SpecEE weights) of ``arch`` at published size, as
    zero-stride arrays: JAX's ``eval_shape`` of its inits."""
    if arch not in _SHAPES:
        m = jbuild(jax_get_config(arch))
        key = jax.random.PRNGKey(0)
        to = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda s: _zeros(s.shape), t)
        _SHAPES[arch] = (m, to(jax.eval_shape(m.init, key)),
                         to(jax.eval_shape(lambda k: jeng.init_specee(m, k),
                                           key)))
    return _SHAPES[arch]


def _jax_flat(spec_tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda x: isinstance(x, JP))
    return {_path_str(p): tuple(s) for p, s in flat}


def _port_flat(spec_tree):
    out = {}
    pol.map_with_paths(spec_tree, lambda p, s: out.__setitem__(p, tuple(s)))
    return out


def _as_port_sw(sw):
    return eng.SpecEEWeights(draft=sw.draft, predictors=sw.predictors,
                             offline_mask=sw.offline_mask)


def test_archs_are_jax_archs():
    assert list(ARCHS) == list(JARCHS)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", list(JARCHS))
def test_param_and_specee_specs_match_jax(arch, mesh):
    """``param_specs`` and ``specee_specs`` equal JAX's leaf for leaf for
    every policy (shapes at published size), and every split dim divides
    its extent."""
    fake = MESHES[mesh]
    m_j, p_shapes, sw_shapes = _shapes(arch)
    m_t = build_model(get_config(arch))
    for policy in POLICIES:
        want = _jax_flat(jsharding.param_specs(m_j, fake, policy, p_shapes))
        got = _port_flat(pol.param_specs(m_t, fake, policy, p_shapes))
        assert got == want, (arch, policy)
        want = _jax_flat(jsharding.specee_specs(m_j, fake, policy,
                                                sw_shapes))
        got = _port_flat(pol.specee_specs(m_t, fake, policy,
                                          _as_port_sw(sw_shapes)))
        assert list(got.values()) == list(want.values()), (arch, policy)
    flat = jax.tree_util.tree_leaves(p_shapes)
    specs = jax.tree_util.tree_leaves(
        pol.param_specs(m_t, fake, "tp2d", p_shapes),
        is_leaf=lambda x: isinstance(x, pol.Spec))
    for leaf, spec in zip(flat, specs):
        for dim, ax in zip(leaf.shape, spec):
            if ax is not None:
                axes = ax if isinstance(ax, tuple) else (ax,)
                assert dim % int(np.prod([fake.shape[a] for a in axes])) == 0


@pytest.mark.parametrize("arch", ["llama2-7b", "dbrx-132b",
                                  "recurrentgemma-9b", "mamba2-130m"])
def test_cache_batch_state_specs_match_jax(arch):
    """``cache_specs`` (with and without the sequence split),
    ``batch_specs`` and ``state_specs`` equal JAX's on the same shapes."""
    m_j, p_shapes, _ = _shapes(arch)
    m_t = build_model(get_config(arch))
    cache = jax.tree_util.tree_map(
        lambda s: _zeros(s.shape),
        jax.eval_shape(lambda: m_j.empty_cache(32, 4096)))
    batch = {"tokens": _zeros((32, 4096)), "mask": _zeros((32, 2048))}
    for mesh in MESHES.values():
        for policy in POLICIES:
            for seq in (True, False):
                assert _port_flat(pol.cache_specs(
                    m_t, mesh, policy, cache, kv_seq_shard=seq)) == \
                    _jax_flat(jsharding.cache_specs(
                        m_j, mesh, policy, cache, kv_seq_shard=seq))
        for seq in (True, False):
            assert _port_flat(pol.batch_specs(m_t, mesh, batch, seq)) == \
                _jax_flat(jsharding.batch_specs(m_j, mesh, batch, seq))
        ps = pol.param_specs(m_t, mesh, "fsdp_tp", p_shapes)
        st = pol.state_specs(mesh, "fsdp_tp", ps, None)
        jst = jsharding.state_specs(
            mesh, "fsdp_tp", jsharding.param_specs(m_j, mesh, "fsdp_tp",
                                                   p_shapes), None)
        assert isinstance(st, AdamWState) and tuple(st.step) == ()
        assert _port_flat(st.m) == _jax_flat(jst.m) == _jax_flat(jst.v)


def test_odd_vocab_falls_back_to_replicated():
    """minicpm's 122753 vocabulary divides nothing: the embedding does not
    split V, it splits D (both packages)."""
    m_j, p_shapes, _ = _shapes("minicpm-2b")
    m_t = build_model(get_config("minicpm-2b"))
    for mesh in MESHES.values():
        specs = pol.param_specs(m_t, mesh, "tp_dp", p_shapes)
        assert tuple(specs["embed"]["tok"]) == (None, "model")
        jspecs = jsharding.param_specs(m_j, mesh, "tp_dp", p_shapes)
        assert tuple(jspecs["embed"]["tok"]) == (None, "model")


def test_tp2d_with_data_one_is_tp_dp_layout():
    """With DATA = 1, tp2d's second axis has extent 1: every leaf splits
    exactly where tp_dp's does (as JAX's specs say)."""
    m_j, p_shapes, _ = _shapes("command-r-plus-104b")
    m_t = build_model(get_config("command-r-plus-104b"))
    mesh = Mesh14()
    a = _port_flat(pol.param_specs(m_t, mesh, "tp2d", p_shapes))
    b = _port_flat(pol.param_specs(m_t, mesh, "tp_dp", p_shapes))
    assert a == _jax_flat(jsharding.param_specs(m_j, mesh, "tp2d", p_shapes))
    for path in a:
        assert ([d for d, ax in enumerate(a[path]) if ax == "model"]
                == [d for d, ax in enumerate(b[path]) if ax == "model"])
    assert a["segments/0/u0/attn/wq/w"] == (None, "data", "model")


def test_pool_partition_dims_matches_jax():
    """Paged pools shard one trailing dim, never the page-indexed leading
    ones (JAX's cases, on both packages)."""
    cases = [((2, 9, 16, 4, 32), 2, (None, None, None, "model", None)),
             ((2, 9, 16, 3, 32), 2, (None, None, None, None, "model")),
             ((2, 9, 16, 3, 31), 2, (None,) * 5),
             ((2, 9, 16, 8), 2, (None, None, None, "model")),
             ((2, 9, 16, 4, 32), 1, (None,) * 5),
             ((2, 9, 16, 4), 4, (None, None, None, "model"))]
    for shape, extent, want in cases:
        assert pool_partition_dims(shape, extent) == \
            jpool_dims(shape, extent) == want


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_cache_partition_specs_layout(kind, kv_quant):
    """``partition_specs`` of both managers: the page table and lengths
    replicated, the page-indexed leading dims whole, the KV-head dim over
    'model', equal to JAX's manager's (the dense int8 cache's scale planes
    follow their codes in the port, see ``api/cache.py``); and a sharded
    model's cache holds each shard's KV heads as its parts."""
    run = get_config("llama2-7b").smoke()
    flags = dict(kv_quant=True) if kv_quant else {}
    from repro.models.model import ModelFlags as JFlags
    from repro_torch.models.model import ModelFlags
    m = build_model(run, ModelFlags(**flags))
    m_j = jbuild(jax_get_config("llama2-7b").smoke(), JFlags(**flags))
    mgr = make_cache_manager(m, 2, 64, CacheSpec.resolve(kind, run.serve),
                             "cpu")
    jmgr = jmake_mgr(m_j, 2, 64, JCacheSpec.resolve(kind, m_j.run.serve))
    mesh = Mesh14()
    got = _port_flat(mgr.partition_specs(mgr.empty_cache(), mesh))
    want = _jax_flat(jmgr.partition_specs(jmgr.empty_cache(), mesh))
    for path, spec in want.items():
        if kv_quant and kind == "dense" and path.endswith(("/ks", "/vs")):
            assert got[path] == got[path[:-1]][:-1]
            continue
        assert got[path] == spec, path
    assert got["len"] == () and (kind == "dense" or got["page_table"] == ())
    for path, spec in got.items():
        if path.startswith("segments"):
            assert spec[3] == "model" and all(d in (None, "data")
                                              for d in spec[:3]), path
    sharded = m.with_shard(ShardCtx.from_mesh(make_host_mesh(1, 2, "cpu")))
    mgr = make_cache_manager(sharded, 2, 64,
                             CacheSpec.resolve(kind, run.serve), "cpu")
    cache = mgr.empty_cache()
    entry = cache["segments"][0]["u0"]
    kvh = run.model.num_kv_heads
    assert [p.shape[3] for p in entry["k"]] == [kvh // 2] * 2
    assert entry["k"].dim == -2 and (not kv_quant or entry["ks"].dim == -1)
    assert isinstance(cache["len"], torch.Tensor)


@pytest.mark.parametrize("degree", [2, 4])
def test_sharded_verify_bit_equal_to_jax(degree):
    """The sharded ``verify_argmax`` / ``verify_topk`` (plain versions,
    both impls) equal JAX's unsharded ``impl="ref"`` verify in tokens and
    values, bit for bit, at V = 512, 509, 500, on the ``Shards`` head of
    ``split_vocab``."""
    from repro_torch.sharding.serving import split_vocab
    shard = ShardCtx.from_mesh(make_host_mesh(1, degree, "cpu"))
    rng = np.random.default_rng(degree)
    for V in (512, 509, 500):
        hn = rng.standard_normal((3, 64)).astype(np.float32)
        w = rng.standard_normal((64, V)).astype(np.float32)
        t0, v0 = jops.verify_argmax(jnp.asarray(hn), jnp.asarray(w),
                                    impl="ref")
        i0, x0 = jops.verify_topk(jnp.asarray(hn), jnp.asarray(w), 4,
                                  impl="ref")
        ht, wt = torch.tensor(hn), torch.tensor(w)
        slices = split_vocab(wt, shard)
        assert sum(p.shape[1] for p in slices) == V
        for impl in ("ref", "kernel"):
            t1, v1 = tops.verify_argmax(ht, slices, impl=impl)
            i1, x1 = tops.verify_topk(ht, slices, 4, impl=impl)
            assert np.array_equal(np.asarray(t0), t1.numpy())
            assert np.array_equal(np.asarray(v0), v1.numpy())
            assert np.array_equal(np.asarray(i0), i1.numpy())
            assert np.array_equal(np.asarray(x0), x1.numpy())


@pytest.mark.parametrize("degree", [2, 4])
def test_sharded_verify_cross_shard_ties(degree):
    """Duplicated columns put equal maxima on every shard: argmax takes the
    lowest global id, top-k keeps ascending ids among equal values, as
    JAX's unsharded verify does; a k wider than a slice is refused."""
    from repro_torch.sharding.serving import split_vocab
    shard = ShardCtx.from_mesh(make_host_mesh(1, degree, "cpu"))
    rng = np.random.default_rng(3)
    hn = np.ones((2, 8), np.float32)
    w = np.tile(rng.standard_normal((8, 16)).astype(np.float32), (1, 4))
    t0, v0 = jops.verify_argmax(jnp.asarray(hn), jnp.asarray(w), impl="ref")
    i0, x0 = jops.verify_topk(jnp.asarray(hn), jnp.asarray(w), 6, impl="ref")
    slices = split_vocab(torch.tensor(w), shard)
    t1, v1 = tops.verify_argmax(torch.tensor(hn), slices, impl="ref")
    i1, x1 = tops.verify_topk(torch.tensor(hn), slices, 6, impl="ref")
    assert np.array_equal(np.asarray(t0), t1.numpy())
    assert np.array_equal(np.asarray(i0), i1.numpy())
    assert np.array_equal(np.asarray(x0), x1.numpy())
    assert len(set(i1[0].tolist()) & {int(t1[0]) % 16 + 16 * j
                                      for j in range(4)}) >= 2
    with pytest.raises(ValueError, match="exceeds the per-shard"):
        tops.verify_topk(torch.tensor(hn), slices, 65 // degree + 1,
                         impl="ref")


def test_quantized_head_stays_unsharded():
    """A ``QTensor`` head verifies on the unsharded path under a mesh: the
    engine's verify head is the replicated quantized head, not the sharded
    model's vocabulary slices (as in JAX)."""
    from repro_torch.quant import QuantSpec, quantize_params
    from repro_torch.sharding.serving import shard_params
    run = get_config("llama2-7b").smoke()
    m = build_model(run)
    params = m.init(0, device="cpu")
    qw = quantize_params(params, None, QuantSpec.resolve("int8"))
    p, _ = shard_params(params, None, make_host_mesh(1, 2, "cpu"),
                        "tp_dp", m)
    assert "vocab_shards" in p["lm_head"]
    head = eng._verify_head(p, qw["lm_head"])
    assert head is qw["lm_head"]
    hn = torch.randn(3, run.model.d_model, generator=torch.Generator()
                     .manual_seed(0))
    a = tops.verify_argmax(hn, qw["lm_head"], impl="ref")
    b = tops.verify_argmax(hn, head, impl="ref")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("shape,dim,widths", [
    ((5, 6, 12), 2, None), ((5, 12, 6), 1, None), ((7, 509), 1,
                                                    [128, 128, 128, 125]),
    ((12, 6), 0, None)])
def test_split_leaf_host_blocks(monkeypatch, shape, dim, widths):
    """A host tensor cut past its leading dim crosses in blocks of leading
    rows (here a few bytes each, so blocks end mid-tensor) and is cut on
    the device: every part equals the plain narrow, contiguous, and the
    split dim is kept from the end."""
    from repro_torch.sharding import rows, serving as shs
    monkeypatch.setattr(rows, "_BLOCK_BYTES", 3 * 4 * shape[-1])
    shard = ShardCtx.from_mesh(make_host_mesh(1, 4, "cpu"))
    x = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    got = shs.split_leaf(x, dim, shard, widths)
    want = widths or [shape[dim] // 4] * 4
    assert [p.shape[dim] for p in got] == want
    assert got.dim == dim - len(shape)
    c0 = 0
    for part, w in zip(got, want):
        assert part.is_contiguous()
        assert torch.equal(part, x.narrow(dim, c0, w))
        c0 += w


def test_shard_params_layout():
    """``shard_params``: column-parallel leaves split on their output dim,
    row-parallel on their input dim, the row-parallel bias and the norms
    whole on the lead, the head whole beside its vocabulary slices, the
    SpecEE weights whole; every part contiguous; the input untouched."""
    from repro_torch.sharding.ctx import Shards
    from repro_torch.sharding.serving import shard_params
    run = get_config("starcoder2-15b").smoke()
    m = build_model(run)
    params = m.init(0, device="cpu")
    sw = eng.init_specee(m, torch.Generator().manual_seed(1), device="cpu")
    before = {k: v.clone() for k, v in params["segments"][0]["u0"]["attn"]
              ["wq"].items()}
    mesh = make_host_mesh(1, 2, "cpu")
    p, s = shard_params(params, sw, mesh, "tp_dp", m)
    attn = p["segments"][0]["u0"]["attn"]
    mlp = p["segments"][0]["u0"]["mlp"]
    assert isinstance(attn["wq"]["w"], Shards) and attn["wq"]["w"].dim == -1
    assert isinstance(attn["wq"]["b"], Shards)
    assert isinstance(attn["wo"]["w"], Shards) and attn["wo"]["w"].dim == -2
    assert isinstance(attn["wo"]["b"], torch.Tensor)
    assert isinstance(mlp["wi"]["w"], Shards) and mlp["wo"]["w"].dim == -2
    assert isinstance(p["segments"][0]["u0"]["ln1"]["scale"], torch.Tensor)
    assert isinstance(p["lm_head"]["w"], torch.Tensor)
    assert [x.shape[1] for x in p["lm_head"]["vocab_shards"]] == \
        [run.model.vocab_size // 2] * 2
    assert all(x.is_contiguous() for x in attn["wq"]["w"])
    assert isinstance(s.draft["attn"]["wq"]["w"], torch.Tensor)
    assert torch.equal(torch.cat(list(attn["wq"]["w"]), -1),
                       params["segments"][0]["u0"]["attn"]["wq"]["w"])
    for k, v in before.items():
        assert torch.equal(params["segments"][0]["u0"]["attn"]["wq"][k], v)
