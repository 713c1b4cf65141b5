"""The port's paged decode-attention and flash-attention modules on the CPU
(where each wrapper runs its plain version) against the JAX package's
Pallas kernels in interpret mode, an emulation of the split-KV CUDA
kernels' arithmetic (paged and dense) against both, plus the
chunked-prefill attention (``attend_extend``) and
``Model.prefill_extend`` against JAX.

Tolerance: atol = rtol = 1e-5 for the attention functions (fp32, different
summation order); the prefill_extend hiddens and cache atol = rtol = 1e-4
(fp32 through the whole layer stack)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels.decode_attention.decode_attention import (  # noqa: E402
    paged_decode_attention_fwd as jax_paged_fwd)
from repro.kernels.flash_attention.flash_attention import (  # noqa: E402
    flash_attention_fwd as jax_flash_fwd)
from repro.models import attention as jattn  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.decode_attention.decode_attention import (  # noqa
    paged_decode_attention_fwd)
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa
    flash_attention_fwd)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
HTOL = dict(atol=1e-4, rtol=1e-4)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


# ---------------- paged decode attention (Pallas row 5) ----------------
@pytest.mark.parametrize("kvh", [4, 2])
@pytest.mark.parametrize("window", [None, 20])
def test_paged_decode_attention_matches_pallas(kvh, window):
    """A shuffled page table, ragged lengths {1, 5, 33, 64} and a pool
    larger than the rows' reservations."""
    rng = np.random.default_rng(1)
    B, H, hd, ps, P = 4, 4, 32, 16, 4
    NP = B * P + 3
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    kp = rng.standard_normal((NP, ps, kvh, hd)).astype(np.float32)
    vp = rng.standard_normal((NP, ps, kvh, hd)).astype(np.float32)
    table = rng.permutation(NP)[:B * P].reshape(B, P).astype(np.int32)
    clen = np.array([1, 5, 33, 64], np.int32)
    want = jax_paged_fwd(q, kp, vp, table, clen, window=window)
    K.reset_launches()
    got = paged_decode_attention_fwd(_t(q), _t(kp), _t(vp), _t(table),
                                     _t(clen), window=window)
    _close(got, want)
    assert K.LAUNCHES["paged_decode_attention"] == 0   # plain version only
    # the model-layer entry point is the same function
    _close(da_ops.paged_decode_attention(None, _t(q), _t(kp), _t(vp),
                                         _t(table), _t(clen), window), want)


# ---------------- the split-KV arithmetic of the paged kernels ----------
def _split_merge(q, kp, vp, table, clen, window, split, ks=None, vs=None):
    """The split-KV CUDA kernels' split-and-merge, emulated in torch: each
    row's keys cut into splits of ``split`` keys, each split's (m, l, acc)
    in fp32 (a split wholly outside [lo, len) at m = -1e30, l = 0, acc =
    0), merged in split order; l == 0 writes zeros. With a ``table`` the
    K/V are pools read through it (the paged kernels; ``split`` a multiple
    of the page size); with ``table`` None a dense (B, S, KVH, hd) cache
    (the dense kernel: key s of row b at slot b * S + s). With ``ks``/``vs``
    the pools hold int8 codes: a key's score is its scale times q . codes,
    and its V row enters at weight p * vs."""
    B, _, H, hd = q.shape
    KVH = kp.shape[2]
    n_rep = H // KVH
    if table is None:
        n_keys = kp.shape[1]
        slots_of = [torch.arange(n_keys) + b * n_keys for b in range(B)]
    else:
        ps, P = kp.shape[1], table.shape[1]
        n_keys = P * ps
        slots_of = [(table[b].long()[:, None] * ps
                     + torch.arange(ps)[None, :]).reshape(-1)
                    for b in range(B)]
    out = torch.zeros(B, 1, H, hd)
    for b in range(B):
        n = min(int(clen[b]), n_keys)
        lo = max(0, n - window) if window else 0
        slots = slots_of[b]
        k = kp.reshape(-1, KVH, hd)[slots].float().repeat_interleave(n_rep, 1)
        v = vp.reshape(-1, KVH, hd)[slots].float().repeat_interleave(n_rep, 1)
        sk = sv = torch.ones(len(slots), H)
        if ks is not None:
            sk = ks.reshape(-1, KVH)[slots].repeat_interleave(n_rep, 1)
            sv = vs.reshape(-1, KVH)[slots].repeat_interleave(n_rep, 1)
        parts = []
        for j in range(-(-n_keys // split)):
            s0, s1 = max(lo, j * split), min(n, (j + 1) * split)
            if s0 >= s1:
                parts.append((torch.full((H,), -1e30), torch.zeros(H),
                              torch.zeros(H, hd)))
                continue
            sc = (torch.einsum("hd,shd->hs", q[b, 0].float(), k[s0:s1])
                  * sk[s0:s1].T / np.sqrt(hd))
            m = sc.max(-1).values
            p = torch.exp(sc - m[:, None])
            acc = torch.einsum("hs,shd->hd", p * sv[s0:s1].T, v[s0:s1])
            parts.append((m, p.sum(-1), acc))
        M = torch.stack([m for m, _, _ in parts]).max(0).values
        L, O = torch.zeros(H), torch.zeros(H, hd)
        for m, l, acc in parts:
            f = torch.exp(m - M)
            L, O = L + l * f, O + acc * f[:, None]
        out[b, 0] = torch.where(L[:, None] > 0, O / L[:, None],
                                torch.zeros(()))
    return out


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("window", [None, 20])
def test_split_merge_matches_pallas_and_plain(quantized, window):
    """The emulated split-and-merge at splits of 1, 2, 3 and 8 pages
    against JAX's Pallas kernel in interpret mode and the port's plain
    version: a shuffled table, rows of 64, 1, 37 and 17 keys (window 20
    leaves whole splits before the first key of row 0; row 1 is one key;
    splits past a row's length are empty), fp32 or int8 pools."""
    from repro.models import model as jmodel
    from repro_torch.kernels.decode_attention.ref import (
        paged_decode_attention_ref)
    rng = np.random.default_rng(5)
    B, H, KVH, hd, ps, P = 4, 4, 2, 32, 8, 8
    NP = B * P + 3
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    kp = rng.standard_normal((NP, ps, KVH, hd)).astype(np.float32)
    vp = rng.standard_normal((NP, ps, KVH, hd)).astype(np.float32)
    table = rng.permutation(NP)[:B * P].reshape(B, P).astype(np.int32)
    clen = np.array([64, 1, 37, 17], np.int32)
    scales = {}
    if quantized:
        kp, ks = map(np.asarray, jmodel._kv_quantize(jnp.asarray(kp)))
        vp, vs = map(np.asarray, jmodel._kv_quantize(jnp.asarray(vp)))
        scales = dict(k_scale=ks, v_scale=vs)
    want = jax_paged_fwd(q, kp, vp, table, clen, window=window, **scales)
    t = {name: _t(x) for name, x in scales.items()}
    plain = paged_decode_attention_ref(_t(q), _t(kp), _t(vp), _t(table),
                                       _t(clen), window, t.get("k_scale"),
                                       t.get("v_scale"))
    _close(plain, want)
    for split in (ps, 2 * ps, 3 * ps, P * ps):
        got = _split_merge(_t(q), _t(kp), _t(vp), _t(table), _t(clen),
                           window, split, t.get("k_scale"),
                           t.get("v_scale"))
        _close(got, want)
        _close(got, plain)


@pytest.mark.parametrize("split", [8, 13, 40])
@pytest.mark.parametrize("window", [None, 20])
def test_split_merge_dense_matches_pallas_and_plain(split, window):
    """The emulated split-and-merge over a dense 40-slot cache (the dense
    kernel's DenseRows) at splits of 8, 13 and 40 keys against JAX's
    Pallas decode_attention_fwd in interpret mode and the port's plain
    version: rows of 40 keys, 1 key, and lengths at and one past the
    second split boundary (window 20 leaves whole splits before the first
    key of row 0 at split 8; splits past a row's length are empty)."""
    from repro.kernels.decode_attention.decode_attention import (
        decode_attention_fwd as jax_decode_fwd)
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    rng = np.random.default_rng(split)
    B, S, H, KVH, hd = 4, 40, 4, 2, 32
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KVH, hd)).astype(np.float32)
    clen = np.array([S, 1, min(2 * split, S), min(2 * split + 1, S)],
                    np.int32)
    want = jax_decode_fwd(q, k, v, clen, window=window, block_k=8)
    plain = decode_attention_ref(_t(q), _t(k), _t(v), _t(clen), window)
    _close(plain, want)
    got = _split_merge(_t(q), _t(k), _t(v), None, _t(clen), window, split)
    _close(got, want)
    _close(got, plain)


# ---------------- flash attention (Pallas row 7) ----------------
@pytest.mark.parametrize("S", [16, 24, 77])
@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("n_rep", [1, 2])
def test_flash_attention_matches_pallas(S, window, n_rep):
    rng = np.random.default_rng(S + n_rep)
    B, H, hd = 2, 4, 32
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, H // n_rep, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, H // n_rep, hd)).astype(np.float32)
    want = jax_flash_fwd(q, k, v, causal=True, window=window)
    K.reset_launches()
    got = flash_attention_fwd(_t(q), _t(k), _t(v), causal=True,
                              window=window)
    _close(got, want)
    assert K.LAUNCHES["flash_attention"] == 0
    _close(fa_ops.flash_attention(_t(q), _t(k), _t(v), window=window), want)


def test_flash_attention_non_causal_matches_pallas():
    rng = np.random.default_rng(9)
    q = rng.standard_normal((1, 24, 4, 32)).astype(np.float32)
    k = rng.standard_normal((1, 24, 2, 32)).astype(np.float32)
    v = rng.standard_normal((1, 24, 2, 32)).astype(np.float32)
    _close(flash_attention_fwd(_t(q), _t(k), _t(v), causal=False),
           jax_flash_fwd(q, k, v, causal=False))


# ---------------- chunked prefill ----------------
@pytest.mark.parametrize("kvh,window", [(4, None), (2, None), (2, 6)])
def test_attend_extend_matches_jax(kvh, window):
    rng = np.random.default_rng(3)
    cfg_j = jax_get_config("llama2-7b").smoke().model
    cfg_t = get_config("llama2-7b").smoke().model
    B, C, S, H, hd = 2, 5, 24, 4, 32
    q = rng.standard_normal((B, C, H, hd)).astype(np.float32)
    kc = rng.standard_normal((B, S, kvh, hd)).astype(np.float32)
    vc = rng.standard_normal((B, S, kvh, hd)).astype(np.float32)
    start = np.array([0, 11], np.int32)
    _close(tattn.attend_extend(cfg_t, _t(q), _t(kc), _t(vc), _t(start),
                               window),
           jattn.attend_extend(cfg_j, q, kc, vc, start, window))


def test_prefill_extend_matches_jax():
    """Two chunks (the second padded past the prompt) through both
    packages: hiddens, K/V cache and lengths agree, and the chunked cache
    equals the whole-prompt prefill's."""
    run_j = jax_get_config("llama2-7b").smoke()
    run_t = get_config("llama2-7b").smoke()
    m_j, m_t = jbuild(run_j), build_model(run_t)
    assert m_t.supports_chunked_prefill() == m_j.supports_chunked_prefill()
    params_j = m_j.init(jax.random.PRNGKey(0))
    params_t = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params_j), "cpu", torch.float32)
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, 512, 11).astype(np.int32)
    S, C = 20, 8
    cache_j = m_j.empty_cache(1, S)
    cache_t = m_t.empty_cache(1, S, "cpu")
    hs_t = []
    for c0 in (0, C):
        n = min(C, len(prompt) - c0)
        chunk = np.zeros((1, C), np.int32)
        chunk[0, :n] = prompt[c0:c0 + n]
        h_j, cache_j = m_j.prefill_extend(params_j, jnp.asarray(chunk),
                                          cache_j, n)
        h_t, cache_t = m_t.prefill_extend(params_t, _t(chunk), cache_t, n)
        _close(h_t[:, :n], np.asarray(h_j)[:, :n], HTOL)
        hs_t.append(h_t[:, :n])
    assert int(cache_t["len"][0]) == int(cache_j["len"][0]) == len(prompt)
    T = len(prompt)
    for name in ("k", "v"):
        got = cache_t["segments"][0]["u0"][name]
        _close(got[:, :, :T],
               np.asarray(cache_j["segments"][0]["u0"][name])[:, :, :T],
               HTOL)
    _, full, extras = m_t.prefill(params_t, {"tokens": _t(prompt[None])}, S)
    _close(torch.cat(hs_t, 1), extras["h_final"], HTOL)
    _close(cache_t["segments"][0]["u0"]["k"][:, :, :T],
           full["segments"][0]["u0"]["k"][:, :, :T], HTOL)
