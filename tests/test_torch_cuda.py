"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA Hopper card and ``nvcc``; without them they
skip. On such a machine (where JAX may be absent, so the repository's
conftest is left out):

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerances: argmax/top-k ids exact in fp32 (random inputs: the top-2 gap
dwarfs fp32 rounding); fp32 values atol = rtol = 1e-4 (different
summation order); attention is held against the plain version on its
inputs upcast to fp32 (the kernels keep scores and sums in fp32; the bf16
flash kernel multiplies P as two bf16 parts, ~16 bits), atol 1e-4 and in
bf16 rtol 2**-7 (the output's rounding to bf16 errs by at most 2**-8
relative). The bf16 argmax runs on the tensor cores: bf16 products are
exact in fp32, so its values keep the fp32 tolerance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import build
    build.build_all()
    return torch.device("cuda")


def _rand(gen, shape, dev, dtype=torch.float32, scale=1.0):
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_verify_kernels_match_plain(dev, dtype):
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.exit_gate import exit_gate as eg
    from repro_torch.kernels.exit_gate import ref
    gen = torch.Generator(device=dev).manual_seed(0)
    hn = _rand(gen, (4, 512), dev, dtype)
    w = _rand(gen, (512, 3001), dev, dtype, 0.05)
    reset_launches()
    tok, mx = eg.argmax_verify_fused(hn, w)
    ids, vals = eg.topk_verify_fused(hn, w, 4)
    torch.cuda.synchronize()
    assert LAUNCHES["argmax_verify"] == 1 and LAUNCHES["topk_verify"] == 1
    tok_r, mx_r = ref.verify_argmax_ref(hn, w)
    ids_r, vals_r = ref.verify_topk_ref(hn, w, 4)
    assert torch.equal(tok, tok_r) and torch.equal(ids, ids_r)
    torch.testing.assert_close(mx, mx_r, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(vals, vals_r, atol=1e-4, rtol=1e-4)


def test_verify_kernels_break_ties_to_lowest_id(dev):
    from repro_torch.kernels.exit_gate import exit_gate as eg
    gen = torch.Generator(device=dev).manual_seed(1)
    hn = _rand(gen, (2, 256), dev)
    w = _rand(gen, (256, 1000), dev, scale=0.05)
    best = int((hn[0] @ w).argmax())
    for j in (3, best + 1, 999):
        w[:, j] = w[:, best]
    tok, _ = eg.argmax_verify_fused(hn, w)
    ids, _ = eg.topk_verify_fused(hn, w, 4)
    dup = sorted({3, best, best + 1, 999})
    assert int(tok[0]) == dup[0]
    assert ids[0].tolist() == dup[:4]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_exit_gate_kernel_matches_plain(dev, dtype):
    from repro_torch.kernels.exit_gate import exit_gate as eg
    gen = torch.Generator(device=dev).manual_seed(2)
    B, D, V, k, H = 4, 512, 3001, 4, 512
    hn = _rand(gen, (B, D), dev, dtype)
    w = _rand(gen, (D, V), dev, dtype, 0.05)
    ids = torch.randint(0, V, (B, k), generator=gen, device=dev,
                        dtype=torch.int32)
    prev = torch.softmax(_rand(gen, (B, k), dev), -1)
    w1, b1 = _rand(gen, (3 * k, H), dev, scale=0.3), _rand(gen, (H,), dev)
    w2, b2 = _rand(gen, (H, 1), dev, scale=0.05), _rand(gen, (1,), dev)
    got = eg.exit_gate_fused(hn, w, ids, prev, w1, b1, w2, b2)
    want = eg.exit_gate_fused(hn.cpu(), w.cpu(), ids.cpu(), prev.cpu(),
                              w1.cpu(), b1.cpu(), w2.cpu(), b2.cpu())
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kvh,hd,window", [(8, 128, None), (2, 64, 5),
                                           (4, 32, None)])
def test_decode_attention_kernel_matches_plain(dev, dtype, kvh, hd, window):
    from repro_torch.kernels.decode_attention.decode_attention import (
        decode_attention_fwd)
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    gen = torch.Generator(device=dev).manual_seed(3)
    B, S, H = 3, 77, 8
    q = _rand(gen, (B, 1, H, hd), dev, dtype)
    k = _rand(gen, (B, S, kvh, hd), dev, dtype)
    v = _rand(gen, (B, S, kvh, hd), dev, dtype)
    clen = torch.tensor([77, 30, 1], dtype=torch.int32, device=dev)
    got = decode_attention_fwd(q, k, v, clen, window=window)
    want = decode_attention_ref(q.float(), k.float(), v.float(), clen, window)
    rtol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(got.float(), want, atol=1e-4, rtol=rtol)


def test_engine_kernels_match_plain_path(dev):
    """The SpecEE slice on the card: kernel flags vs plain flags, smoke
    width, fp32 — tokens and exit decisions identical."""
    from repro_torch.api import Engine, SpecEEStrategy
    from repro_torch.configs import get_config
    from repro_torch.core import engine as eng
    from repro_torch.models.model import ModelFlags, build_model
    run = get_config("llama2-7b").smoke()
    m_plain = build_model(run)
    m_ker = build_model(run, ModelFlags(exit_gate_kernel=True,
                                        exit_gate_impl="kernel",
                                        decode_kernel=True))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = m_plain.init(gen, dev)
    sw = eng.init_specee(m_plain, gen, dev)
    prompts = np.random.default_rng(0).integers(0, 512, (2, 8))
    for thresh in (1.5, 0.4, -0.1):
        outs = []
        for m in (m_plain, m_ker):
            s = Engine.create(m, params, sw,
                              strategy=SpecEEStrategy(threshold=thresh)
                              ).new_session()
            res = [s.prefill(prompts, max_new_tokens=5)]
            while not s.all_done():
                res.append(s.step())
            outs.append([(r.tokens.tolist(), r.exit_layer.tolist(),
                          r.exited.tolist()) for r in res])
        assert outs[0] == outs[1]


def _shuffled_table(B, P, n_pages, seed):
    """(B, P) page table over pages [0, n_pages) in shuffled order."""
    rng = np.random.default_rng(seed)
    return rng.permutation(n_pages)[:B * P].reshape(B, P).astype(np.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kvh,hd,ps,window", [(8, 128, 16, None),
                                              (2, 64, 7, 5),
                                              (4, 32, 32, None),
                                              (8, 128, 128, 20)])
def test_paged_decode_attention_kernel_matches_plain(dev, dtype, kvh, hd, ps,
                                                     window):
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.decode_attention.decode_attention import (
        paged_decode_attention_fwd)
    from repro_torch.kernels.decode_attention.ref import (
        paged_decode_attention_ref)
    gen = torch.Generator(device=dev).manual_seed(4)
    B, H, P = 4, 8, 6
    NP = B * P + 3
    q = _rand(gen, (B, 1, H, hd), dev, dtype)
    kp = _rand(gen, (NP + 1, ps, kvh, hd), dev, dtype)
    vp = _rand(gen, (NP + 1, ps, kvh, hd), dev, dtype)
    table = torch.as_tensor(_shuffled_table(B, P, NP, 0), device=dev)
    table[3] = NP                        # a retired row: all trash page
    clen = torch.tensor([P * ps, 2 * ps + 3, 1, 1], dtype=torch.int32,
                        device=dev)
    reset_launches()
    got = paged_decode_attention_fwd(q, kp, vp, table, clen, window=window)
    torch.cuda.synchronize()
    assert LAUNCHES["paged_decode_attention"] == 1
    want = paged_decode_attention_ref(q.float(), kp.float(), vp.float(),
                                      table, clen, window)
    rtol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(got.float(), want, atol=1e-4, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,H,kvh,hd,window", [(77, 8, 8, 128, None),
                                               (130, 8, 2, 64, 9),
                                               (64, 4, 4, 32, None),
                                               (1, 8, 8, 128, None),
                                               (200, 8, 2, 128, 64)])
def test_flash_attention_kernel_matches_plain(dev, dtype, S, H, kvh, hd,
                                              window):
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_fwd)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    gen = torch.Generator(device=dev).manual_seed(5)
    B = 2
    q = _rand(gen, (B, S, H, hd), dev, dtype)
    k = _rand(gen, (B, S, kvh, hd), dev, dtype)
    v = _rand(gen, (B, S, kvh, hd), dev, dtype)
    reset_launches()
    got = flash_attention_fwd(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == 1
    want = flash_attention_ref(q.float(), k.float(), v.float(), True, window)
    rtol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(got.float(), want, atol=1e-4, rtol=rtol)


def test_serving_kernels_match_plain_path(dev):
    """Continuous batching on the card at smoke width, fp32: the kernel
    path (flash prefill, paged decode, fused gate) gives the same
    per-request tokens and exit points as the plain path (dense cache —
    a paged cache on the card always takes the paged kernel — and the
    reference gate), and every page returns to the free list."""
    from repro_torch.configs import get_config
    from repro_torch.core import engine as eng
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.model import ModelFlags, build_model
    from repro_torch.serving import ServingEngine
    run = get_config("llama2-7b").smoke()
    m_plain = build_model(run, ModelFlags(exit_gate_impl="ref"))
    m_ker = build_model(run, ModelFlags(flash_attention=True,
                                        decode_kernel=True,
                                        exit_gate_kernel=True,
                                        exit_gate_impl="kernel"))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = m_plain.init(gen, dev)
    sw = eng.init_specee(m_plain, gen, dev)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, n) for n in (5, 19, 3, 40, 11)]
    outs = []
    reset_launches()
    for m, fused, cache in ((m_ker, True, "paged"),
                            (m_plain, False, "dense")):
        e = ServingEngine(m, params, sw, cache=cache, prefill_chunk=0,
                          fused_gate=fused)
        reqs = [e.submit(p, max_new_tokens=6) for p in prompts]
        e.run_to_completion()
        mgr = e.session.cache_mgr
        assert mgr.free_pages == getattr(mgr, "num_pages", 0)
        outs.append([(r.output, r.exit_points) for r in reqs])
    assert outs[0] == outs[1]
    assert LAUNCHES["flash_attention"] > 0
    assert LAUNCHES["paged_decode_attention"] > 0


def _plant_ties(w, hn, rows):
    """Copy each listed row's best column to a higher and a lower id, and
    to id 0, in order (only the last row's tie at id 0 is sure to survive
    the later copies): the kernels must keep the lowest id among equal
    logits."""
    for r in rows:
        best = int((hn[r].float() @ w.float()).argmax())
        for j in (0, (best + 5) % w.shape[1], (best + w.shape[1] - 3)
                  % w.shape[1]):
            w[:, j] = w[:, best]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R", [9, 160, 320])
def test_verify_kernels_any_row_count(dev, dtype, R):
    """Row counts past one 8-row group (the tree acceptance walk verifies
    B*N node rows): ids equal the plain version's, ties to the lowest id."""
    from repro_torch.kernels.exit_gate import exit_gate as eg
    from repro_torch.kernels.exit_gate import ref
    gen = torch.Generator(device=dev).manual_seed(R)
    hn = _rand(gen, (R, 256), dev, dtype)
    w = _rand(gen, (256, 3001), dev, dtype, 0.05)
    _plant_ties(w, hn, (0, R // 2, R - 1))
    tok, mx = eg.argmax_verify_fused(hn, w)
    ids, vals = eg.topk_verify_fused(hn, w, 4)
    tok_r, mx_r = ref.verify_argmax_ref(hn, w)
    ids_r, vals_r = ref.verify_topk_ref(hn, w, 4)
    assert torch.equal(tok, tok_r) and torch.equal(ids, ids_r)
    assert int(tok[R - 1]) == 0 and int(ids[R - 1, 0]) == 0
    torch.testing.assert_close(mx, mx_r, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(vals, vals_r, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R", [1, 160, 320])
def test_spec_head_kernel_matches_plain(dev, dtype, R):
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.spec_head.ref import spec_logits_ref
    from repro_torch.kernels.spec_head.spec_head import spec_head_logits
    gen = torch.Generator(device=dev).manual_seed(4)
    D, V, k = 512, 3001, 4
    hn = _rand(gen, (R, D), dev, dtype)
    w = _rand(gen, (D, V), dev, dtype, 0.05)
    ids = torch.randint(0, V, (R, k), generator=gen, device=dev,
                        dtype=torch.int32)
    ids[0] = torch.tensor([0, V - 1, V - 1, 0], dtype=torch.int32)
    reset_launches()
    got = spec_head_logits(hn, w, ids)
    torch.cuda.synchronize()
    assert LAUNCHES["spec_head_gather"] == 1 and LAUNCHES["spec_head"] == 1
    torch.testing.assert_close(got, spec_logits_ref(hn, w, ids), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("F", [12, 15, 24])
@pytest.mark.parametrize("R", [1, 108, 216])
def test_predictor_mlp_kernel_matches_plain(dev, R, F):
    """The fp predictor at one row and the tree's B*P paths at B = 4 and
    8; F = 12 runs the instance unrolled to 12, F = 15 and 24 the one
    unrolled to 32."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.predictor_mlp.predictor_mlp import (
        predictor_mlp_fused)
    from repro_torch.kernels.predictor_mlp.ref import predictor_mlp_ref
    gen = torch.Generator(device=dev).manual_seed(5)
    H = 512
    x = _rand(gen, (R, F), dev)
    w1, b1 = _rand(gen, (F, H), dev, scale=0.3), _rand(gen, (H,), dev)
    w2, b2 = _rand(gen, (H, 1), dev, scale=0.05), _rand(gen, (1,), dev)
    reset_launches()
    got = predictor_mlp_fused(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert LAUNCHES["predictor_mlp"] == 1
    torch.testing.assert_close(got, predictor_mlp_ref(x, w1, b1, w2, b2),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_tree_kernels_match_plain_path(dev, cache):
    """Tree decode on the card at smoke width, fp32: every kernel on
    (spec head, predictor MLP, verify, decode attention) against the plain
    paths — tokens, accept lengths and exit points identical."""
    from repro_torch.api import Engine, TreeStrategy
    from repro_torch.configs import get_config
    from repro_torch.core import engine as eng
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.model import ModelFlags, build_model
    run = get_config("llama2-7b").smoke()
    m_plain = build_model(run)
    m_ker = build_model(run, ModelFlags(spec_head_kernel=True,
                                        exit_gate_kernel=True,
                                        exit_gate_impl="kernel",
                                        decode_kernel=True))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = m_plain.init(gen, dev)
    sw = eng.init_specee(m_plain, gen, dev)
    prompts = np.random.default_rng(0).integers(0, 512, (2, 8))
    for thresh in (1.5, 0.4, -0.1):
        outs = []
        reset_launches()
        for m in (m_plain, m_ker):
            s = Engine.create(m, params, sw,
                              strategy=TreeStrategy(threshold=thresh)
                              ).new_session(cache=cache)
            res = [s.prefill(prompts, max_new_tokens=6)]
            while not s.all_done():
                res.append(s.step())
            outs.append([(r.tokens.tolist(), r.counts.tolist(),
                          r.accept_len.tolist(), r.exit_layer.tolist())
                         for r in res])
        assert outs[0] == outs[1]
        assert LAUNCHES["argmax_verify"] > 0
        if thresh < 1:
            # the node columns gathered once per step, a dot per exit point
            assert 0 < LAUNCHES["spec_head_gather"] <= LAUNCHES["spec_head"]
            assert LAUNCHES["predictor_mlp"] > 0


# ---------------- weight-only quantized kernels ----------------
def _quant_head(gen, dev, bits, D=512, V=3001):
    from repro_torch import quant
    return quant.quantize_tensor(_rand(gen, (D, V), dev, scale=0.05), bits)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("R", [1, 4, 9, 160, 320])
def test_verify_q_kernels_match_plain(dev, dtype, bits, R):
    """argmax_verify_q / topk_verify_q against their plain versions and
    against the fp kernels on the dequantized fp32 head (hn upcast
    exactly): ids exact, planted ties (codes and scale copied) to the
    lowest id, values atol = rtol = 1e-4."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.exit_gate import exit_gate as eg
    from repro_torch.kernels.exit_gate import ref
    gen = torch.Generator(device=dev).manual_seed(10 * R + bits)
    qt = _quant_head(gen, dev, bits)
    hn = _rand(gen, (R, 512), dev, dtype)
    V = qt.shape[1]
    best = int(ref.verify_argmax_q_ref(hn[-1:], qt)[0][0])
    for j in (0, (best + 5) % V):
        qt.q[:, j], qt.scale[j] = qt.q[:, best], qt.scale[best]
    reset_launches()
    tok, mx = eg.argmax_verify_fused_q(hn, qt)
    ids, vals = eg.topk_verify_fused_q(hn, qt, 4)
    torch.cuda.synchronize()
    assert LAUNCHES["argmax_verify_q"] == 1 and LAUNCHES["topk_verify_q"] == 1
    assert LAUNCHES["argmax_verify"] == LAUNCHES["topk_verify"] == 0
    tok_r, mx_r = ref.verify_argmax_q_ref(hn, qt)
    ids_r, vals_r = ref.verify_topk_q_ref(hn, qt, 4)
    assert torch.equal(tok, tok_r) and torch.equal(ids, ids_r)
    assert int(tok[-1]) == 0 and int(ids[-1, 0]) == 0
    torch.testing.assert_close(mx, mx_r, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(vals, vals_r, atol=1e-4, rtol=1e-4)
    w = qt.dequantize()
    tok_f, mx_f = eg.argmax_verify_fused(hn.float(), w)
    ids_f, _ = eg.topk_verify_fused(hn.float(), w, 4)
    assert torch.equal(tok, tok_f) and torch.equal(ids, ids_f)
    torch.testing.assert_close(mx, mx_f, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("R", [1, 4, 9, 160, 320])
def test_spec_head_q_kernel_matches_plain(dev, dtype, bits, R):
    """spec_head_logits_q (a gather of the R*k code columns, then the
    dot) against its plain version (gather, then dequantize) and the fp
    kernel on the dequantized fp32 head; ids 0 and V-1, repeated."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.spec_head.ref import spec_logits_ref
    from repro_torch.kernels.spec_head.spec_head import (spec_head_logits,
                                                         spec_head_logits_q)
    gen = torch.Generator(device=dev).manual_seed(20 * R + bits)
    qt = _quant_head(gen, dev, bits)
    V = qt.shape[1]
    hn = _rand(gen, (R, 512), dev, dtype)
    ids = torch.randint(0, V, (R, 4), generator=gen, device=dev,
                        dtype=torch.int32)
    ids[0] = torch.tensor([0, V - 1, V - 1, 0], dtype=torch.int32)
    reset_launches()
    got = spec_head_logits_q(hn, qt, ids)
    torch.cuda.synchronize()
    # a gather of the R*k code columns, then the dot
    assert LAUNCHES["spec_head_gather_q"] == 1 and LAUNCHES["spec_head_q"] == 1
    assert LAUNCHES["spec_head"] == LAUNCHES["spec_head_gather"] == 0
    torch.testing.assert_close(got, spec_logits_ref(hn, qt, ids), atol=1e-4,
                               rtol=1e-4)
    torch.testing.assert_close(got, spec_head_logits(hn.float(),
                                                     qt.dequantize(), ids),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("R", [1, 4, 9, 160, 320])
def test_predictor_mlp_q_kernel_matches_plain(dev, bits, R):
    """predictor_mlp_q against its plain version and the fp kernel on the
    dequantized weights: atol = rtol = 1e-5 on probabilities."""
    from repro_torch import quant
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.predictor_mlp.predictor_mlp import (
        predictor_mlp_fused, predictor_mlp_fused_q)
    from repro_torch.kernels.predictor_mlp.ref import predictor_mlp_q_ref
    gen = torch.Generator(device=dev).manual_seed(30 * R + bits)
    F, H = 12, 512
    x = _rand(gen, (R, F), dev)
    q1 = quant.quantize_tensor(_rand(gen, (F, H), dev, scale=0.3), bits)
    q2 = quant.quantize_tensor(_rand(gen, (H, 1), dev, scale=0.05), bits)
    b1, b2 = _rand(gen, (H,), dev), _rand(gen, (1,), dev)
    reset_launches()
    got = predictor_mlp_fused_q(x, q1, b1, q2, b2)
    torch.cuda.synchronize()
    assert LAUNCHES["predictor_mlp_q"] == 1 and LAUNCHES["predictor_mlp"] == 0
    torch.testing.assert_close(got, predictor_mlp_q_ref(x, q1, b1, q2, b2),
                               atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got, predictor_mlp_fused(
        x, q1.dequantize(), b1, q2.dequantize(), b2), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("strategy", ["specee", "dense", "tree"])
@pytest.mark.parametrize("spec", ["int8", "int4"])
def test_quant_engine_kernels_match_plain_path(dev, strategy, spec):
    """Engine.create(quant=...) on the card at smoke width, fp32: kernel
    flags vs plain flags give identical tokens and step fields; the kernel
    path launches the quantized kernels and neither the fp verify kernels
    nor the fused exit gate."""
    from repro_torch.api import Engine, SpecEEStrategy, TreeStrategy
    from repro_torch.configs import get_config
    from repro_torch.core import engine as eng
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.model import ModelFlags, build_model
    run = get_config("llama2-7b").smoke()
    m_plain = build_model(run)
    m_ker = build_model(run, ModelFlags(spec_head_kernel=True,
                                        exit_gate_kernel=True,
                                        exit_gate_impl="kernel",
                                        decode_kernel=True))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = m_plain.init(gen, dev)
    sw = eng.init_specee(m_plain, gen, dev)
    prompts = np.random.default_rng(0).integers(0, 512, (2, 8))
    strat = {"specee": SpecEEStrategy(threshold=-0.1), "dense": "dense",
             "tree": TreeStrategy(threshold=-0.1)}[strategy]
    outs = []
    for m in (m_plain, m_ker):
        reset_launches()
        s = Engine.create(m, params, sw, strategy=strat,
                          quant=spec).new_session()
        res = [s.prefill(prompts, max_new_tokens=6)]
        while not s.all_done():
            res.append(s.step())
        outs.append([(r.tokens.tolist(), r.counts.tolist(),
                      r.exit_layer.tolist(), r.exited.tolist(), r.units_run)
                     for r in res])
    assert outs[0] == outs[1]
    assert LAUNCHES["argmax_verify_q"] > 0
    assert (LAUNCHES["exit_gate"] == LAUNCHES["argmax_verify"]
            == LAUNCHES["topk_verify"] == 0)
    if strategy == "specee":
        # the AR gate is the one quantized gate kernel, never the pieces
        assert LAUNCHES["topk_verify_q"] > 0 and LAUNCHES["exit_gate_q"] > 0
        assert LAUNCHES["spec_head_q"] == LAUNCHES["predictor_mlp_q"] == 0
        assert LAUNCHES["spec_head_gather_q"] == 0
    if strategy == "tree":
        # the tree gate keeps its pieces around the hyper-token merge: the
        # node tokens' code columns gathered once per step, a dot per exit
        # point
        assert 0 < LAUNCHES["spec_head_gather_q"] <= LAUNCHES["spec_head_q"]
        assert LAUNCHES["predictor_mlp_q"] > 0
        assert LAUNCHES["exit_gate_q"] == 0
    assert LAUNCHES["spec_head"] == LAUNCHES["spec_head_gather"] == 0


def _int8_pools(gen, dev, n_pages, ps, kvh, hd):
    """int8 K/V pools with their fp32 scale pools, quantized as the model
    stores them; the last page (the trash page) zeroed, scales too."""
    from repro_torch.models.model import _kv_quantize
    out = []
    for _ in range(2):
        codes, scale = _kv_quantize(_rand(gen, (n_pages, ps, kvh, hd), dev))
        codes[-1], scale[-1] = 0, 0.0
        out += [codes, scale]
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kvh,hd,ps,window", [(8, 128, 16, None),
                                              (2, 64, 7, 5),
                                              (4, 32, 32, None),
                                              (8, 128, 128, 20)])
def test_paged_decode_attention_q_kernel_matches_plain(dev, dtype, kvh, hd,
                                                       ps, window):
    """The int8 paged kernel against its plain version (codes and scales
    gathered, dequantized and attended in fp32): a shuffled table, ragged
    lengths, a retired row reading the zeroed trash page; counted under
    ``paged_decode_attention_q`` only."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.decode_attention.decode_attention import (
        paged_decode_attention_fwd)
    from repro_torch.kernels.decode_attention.ref import (
        paged_decode_attention_ref)
    gen = torch.Generator(device=dev).manual_seed(14)
    B, H, P = 4, 8, 6
    NP = B * P + 3
    q = _rand(gen, (B, 1, H, hd), dev, dtype)
    kp, ks, vp, vs = _int8_pools(gen, dev, NP + 1, ps, kvh, hd)
    table = torch.as_tensor(_shuffled_table(B, P, NP, 1), device=dev)
    table[3] = NP
    clen = torch.tensor([P * ps, 2 * ps + 3, 1, 1], dtype=torch.int32,
                        device=dev)
    reset_launches()
    got = paged_decode_attention_fwd(q, kp, vp, table, clen, window=window,
                                     k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert LAUNCHES["paged_decode_attention_q"] == 1
    assert LAUNCHES["paged_decode_attention"] == 0
    want = paged_decode_attention_ref(q.float(), kp, vp, table, clen,
                                      window, ks, vs)
    assert bool(torch.isfinite(got.float()).all())
    rtol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(got.float(), want, atol=1e-4, rtol=rtol)


def _split_case(gen, dev, reader, dtype, n_rep, hd, lens, kvh=2, P=32,
                ps=128):
    """Inputs of a paged kernel over rows of P pages of ps tokens: a
    shuffled table, pools (int8 codes and fp32 scales for ``reader``
    "int8", trash page zeroed) and the given lengths; a last row of length
    1 is retired (every entry the trash page). Returns the wrapper's
    positional and keyword arguments."""
    B = len(lens)
    NP = B * P + 3
    q = _rand(gen, (B, 1, kvh * n_rep, hd), dev, dtype)
    table = torch.as_tensor(_shuffled_table(B, P, NP, 2), device=dev)
    if lens[-1] == 1:
        table[-1] = NP
    clen = torch.tensor(lens, dtype=torch.int32, device=dev)
    if reader == "int8":
        kp, ks, vp, vs = _int8_pools(gen, dev, NP + 1, ps, kvh, hd)
        return (q, kp, vp, table, clen), dict(k_scale=ks, v_scale=vs)
    kp = _rand(gen, (NP + 1, ps, kvh, hd), dev, dtype)
    vp = _rand(gen, (NP + 1, ps, kvh, hd), dev, dtype)
    return (q, kp, vp, table, clen), {}


@pytest.mark.parametrize("window", [None, 300])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("n_rep", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reader", ["fp", "int8"])
def test_paged_kernels_split_long_rows(dev, reader, dtype, n_rep, hd,
                                       window):
    """Both paged kernels on rows cut into many splits: 32 pages of 128
    tokens, lengths 4096 (every split live), 1, 2 * ps + 3, one ending on
    a split boundary, one ending one key past it, and a retired row;
    window 300 leaves whole splits before its first key. Against the plain
    version on q upcast to fp32, at the file's tolerances; one launch."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.decode_attention.decode_attention import (
        paged_decode_attention_fwd, split_keys)
    from repro_torch.kernels.decode_attention.ref import (
        paged_decode_attention_ref)
    name = "paged_decode_attention" + ("_q" if reader == "int8" else "")
    split = split_keys(name, 32, 128)
    assert split % 128 == 0 and 32 * 128 // split >= 4
    gen = torch.Generator(device=dev).manual_seed(24)
    args, kw = _split_case(gen, dev, reader, dtype, n_rep, hd,
                           [4096, 1, 2 * 128 + 3, 2 * split, split + 1, 1])
    reset_launches()
    got = paged_decode_attention_fwd(*args, window=window, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == 1 and sum(LAUNCHES.values()) == 1
    q, kp, vp, table, clen = args
    if reader == "fp":
        kp, vp = kp.float(), vp.float()
    want = paged_decode_attention_ref(q.float(), kp, vp, table, clen, window,
                                      kw.get("k_scale"), kw.get("v_scale"))
    assert bool(torch.isfinite(got.float()).all())
    rtol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(got.float()[:-1], want[:-1], atol=1e-4,
                               rtol=rtol)


@pytest.mark.parametrize("reader", ["fp", "int8"])
def test_paged_kernels_deterministic(dev, reader):
    """The splits of a row merge in split order, whichever CTA merges: two
    calls on the same inputs are bit-equal, and every (row, KV head)
    ticket is back at 0 after each."""
    from repro_torch.kernels.decode_attention import decode_attention as da
    gen = torch.Generator(device=dev).manual_seed(25)
    args, kw = _split_case(gen, dev, reader, torch.bfloat16, 1, 128,
                           [4096, 3001, 1, 2048, 4095, 1], kvh=8)
    outs = []
    for _ in range(2):
        outs.append(da.paged_decode_attention_fwd(*args, **kw))
        torch.cuda.synchronize()
        assert int(da._WORKSPACES[args[0].device].tickets.abs().sum()) == 0
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("chunk", [0, 4])
def test_kv_quant_serving_kernels_match_plain_path(dev, chunk):
    """kv_quant ``ServingEngine`` on the card at smoke width, fp32: the
    kernel path (int8 paged kernel, flash prefill, fused gate) gives the
    same per-request tokens and exit points as the plain path (dense cache,
    reference gate) at the same admission mode; the kernel path launches
    ``paged_decode_attention_q`` and never the fp paged kernel."""
    from repro_torch.configs import get_config
    from repro_torch.core import engine as eng
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.model import ModelFlags, build_model
    from repro_torch.serving import ServingEngine
    run = get_config("llama2-7b").smoke()
    m_plain = build_model(run, ModelFlags(exit_gate_impl="ref",
                                          kv_quant=True))
    m_ker = build_model(run, ModelFlags(flash_attention=True,
                                        decode_kernel=True,
                                        exit_gate_kernel=True,
                                        exit_gate_impl="kernel",
                                        kv_quant=True))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = m_plain.init(gen, dev)
    sw = eng.init_specee(m_plain, gen, dev)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 512, n) for n in (5, 19, 3, 40, 11)]
    outs = []
    for m, fused, cache in ((m_ker, True, "paged"),
                            (m_plain, False, "dense")):
        reset_launches()
        e = ServingEngine(m, params, sw, cache=cache, prefill_chunk=chunk,
                          fused_gate=fused)
        reqs = [e.submit(p, max_new_tokens=6) for p in prompts]
        e.run_to_completion()
        mgr = e.session.cache_mgr
        assert mgr.free_pages == getattr(mgr, "num_pages", 0)
        outs.append([(r.output, r.exit_points) for r in reqs])
        if m is m_ker:
            assert LAUNCHES["paged_decode_attention_q"] > 0
            assert LAUNCHES["paged_decode_attention"] == 0
    assert outs[0] == outs[1]


@pytest.mark.parametrize("bc_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,ds,hd,nh", [(32, 16, 32, 4), (64, 128, 64, 24),
                                        (64, 16, 32, 5), (32, 128, 64, 24),
                                        (40, 16, 48, 5), (64, 128, 64, 12),
                                        (64, 128, 64, 6)])
@pytest.mark.parametrize("cells", [1, 8, 32])
def test_ssd_chunk_kernel_matches_plain(dev, bc_dtype, c, ds, hd, nh, cells):
    """The SSD intra-chunk kernel against its plain version on the same
    inputs (bf16 B/C upcast in both): fp32 accumulation in another order,
    atol = rtol = 1e-4. Steep decay (cum falling by up to 40 per token)
    makes exp(cum_t - cum_s) overflow for s > t: the kernel must not
    evaluate it there, so the output stays finite. c = 40, hd = 48 (not
    multiples of 16) hold the zero-filled rows and columns of the
    tensor-core tiles."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref
    from repro_torch.kernels.ssd_chunk.ssd_chunk import ssd_chunk_fwd
    gen = torch.Generator(device=dev).manual_seed(c + ds + cells)
    xdt = _rand(gen, (cells, c, nh, hd), dev)
    steep = torch.rand((cells, c, nh), generator=gen, device=dev) * 40.0
    cum = -torch.cumsum(steep, dim=1)
    bm = _rand(gen, (cells, c, ds), dev, bc_dtype, ds ** -0.25)
    cm = _rand(gen, (cells, c, ds), dev, bc_dtype, ds ** -0.25)
    reset_launches()
    got = ssd_chunk_fwd(xdt, cum, bm, cm)
    torch.cuda.synchronize()
    assert LAUNCHES["ssd_chunk"] == 1
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, ssd_chunk_ref(xdt, cum, bm, cm),
                               atol=1e-4, rtol=1e-4)
    mild = -torch.cumsum(steep / 40.0, dim=1)
    torch.testing.assert_close(ssd_chunk_fwd(xdt, mild, bm, cm),
                               ssd_chunk_ref(xdt, mild, bm, cm),
                               atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError):
        ssd_chunk_fwd(xdt[:, :, :1].expand(cells, c, nh, hd), cum, bm, cm)


@pytest.mark.parametrize("bc_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,ds,hd,nh", [(33, 18, 30, 3), (17, 200, 17, 2),
                                        (64, 256, 128, 3), (1, 1, 1, 1)])
def test_ssd_chunk_kernel_unaligned_and_wide(dev, bc_dtype, c, ds, hd, nh):
    """The SSD kernel's other load and store paths against the plain
    version (atol = rtol = 1e-4): B/C rows that are not 16-byte aligned
    (ds = 18, 17, 1: element loads), xdt rows that are not (hd = 30, 17,
    1: 4-byte copies; an odd hd's element stores), ds past one 128-column
    slice (200, 256: the Gram matrix over two slices), hd = 128 (8
    n-tiles a warp) and the least shape."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref
    from repro_torch.kernels.ssd_chunk.ssd_chunk import ssd_chunk_fwd
    gen = torch.Generator(device=dev).manual_seed(c + ds + hd)
    cells = 3
    xdt = _rand(gen, (cells, c, nh, hd), dev)
    cum = -torch.cumsum(torch.rand((cells, c, nh), generator=gen,
                                   device=dev) * 40.0, dim=1)
    bm = _rand(gen, (cells, c, ds), dev, bc_dtype, ds ** -0.25)
    cm = _rand(gen, (cells, c, ds), dev, bc_dtype, ds ** -0.25)
    reset_launches()
    for decay in (1.0, 40.0):
        got = ssd_chunk_fwd(xdt, cum / decay, bm, cm)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, ssd_chunk_ref(xdt, cum / decay, bm,
                                                      cm),
                                   atol=1e-4, rtol=1e-4)
    assert LAUNCHES["ssd_chunk"] == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gate_and_verify_kernels_at_mamba2_width(dev, dtype):
    """The fused gate and the streaming verifies at mamba2-130m's widths
    (D=768: three 256-entry stages; V=50280: a ragged last column block)
    on a tied head made contiguous once, as the engine holds it: ids exact,
    values atol = rtol = 1e-4. The strided ``embed.T`` view itself is
    refused, not read."""
    from repro_torch.kernels.exit_gate import exit_gate as eg
    from repro_torch.kernels.exit_gate import ref
    from repro_torch.models.common import lm_head_weight, with_contiguous_head
    gen = torch.Generator(device=dev).manual_seed(3)
    B, D, V, k, H = 4, 768, 50280, 4, 512
    params = {"embed": {"tok": _rand(gen, (V, D), dev, dtype, 0.05)}}
    head = lm_head_weight(with_contiguous_head(params))
    assert head.is_contiguous() and head.shape == (D, V)
    hn = _rand(gen, (B, D), dev, dtype)
    tok, mx = eg.argmax_verify_fused(hn, head)
    tok_r, mx_r = ref.verify_argmax_ref(hn, head)
    assert torch.equal(tok, tok_r)
    torch.testing.assert_close(mx, mx_r, atol=1e-4, rtol=1e-4)
    ids, vals = eg.topk_verify_fused(hn, head, k)
    ids_r, vals_r = ref.verify_topk_ref(hn, head, k)
    assert torch.equal(ids, ids_r)
    torch.testing.assert_close(vals, vals_r, atol=1e-4, rtol=1e-4)
    spec = torch.randint(V - 8, V, (B, k), generator=gen, device=dev,
                         dtype=torch.int32)          # the ragged tail
    prev = torch.softmax(_rand(gen, (B, k), dev), -1)
    w1 = _rand(gen, (3 * k, H), dev, scale=12 ** -0.5)
    b1 = _rand(gen, (H,), dev, scale=0.1)
    w2 = _rand(gen, (H, 1), dev, scale=H ** -0.5)
    b2 = _rand(gen, (1,), dev, scale=0.1)
    got = eg.exit_gate_fused(hn, head, spec, prev, w1, b1, w2, b2)
    pred = {"layers": [{"w": w1, "b": b1}, {"w": w2, "b": b2}]}
    for a, b in zip(got, ref.exit_gate_ref(hn, head, spec, prev, pred)):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    tied = lm_head_weight(params)
    assert not tied.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        eg.argmax_verify_fused(hn, tied)
    with pytest.raises(ValueError, match="contiguous"):
        eg.topk_verify_fused(hn, tied, k)


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_mamba2_serving_kernels_match_plain_path(dev, quant):
    """mamba2-130m at smoke width on the card, fp32: ``ServingEngine`` with
    the SSD, gate and verify kernels gives the same per-request tokens and
    exit points as the plain path (dense cache, reference gate, plain
    intra-chunk term), at threshold -0.1 so the verify runs at every active
    exit point; 4-token chunks fall back to whole-prompt admission; the
    kernel path launches ``ssd_chunk`` once per layer per admission. Under
    ``quant=`` the quantized tied head and bank take the quantized gate
    and verify kernels, on both paths' quantized weights."""
    from repro_torch.api import SpecEEStrategy
    from repro_torch.configs import get_config
    from repro_torch.core import engine as eng
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.model import ModelFlags, build_model
    from repro_torch.serving import ServingEngine
    run = get_config("mamba2-130m").smoke()
    m_plain = build_model(run, ModelFlags(exit_gate_impl="ref"))
    m_ker = build_model(run, ModelFlags(ssd_kernel=True,
                                        exit_gate_kernel=True,
                                        exit_gate_impl="kernel"))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = m_plain.init(gen, dev)
    sw = eng.init_specee(m_plain, gen, dev)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 512, n) for n in (5, 19, 3, 40, 70)]
    outs = []
    for m, fused, cache in ((m_ker, True, "paged"),
                            (m_plain, False, "dense")):
        reset_launches()
        e = ServingEngine(m, params, sw, cache=cache, prefill_chunk=4,
                          fused_gate=fused, quant=quant,
                          strategy=SpecEEStrategy(threshold=-0.1))
        reqs = [e.submit(p, max_new_tokens=6) for p in prompts]
        e.run_to_completion()
        mgr = e.session.cache_mgr
        assert mgr.free_pages == getattr(mgr, "num_pages", 0)
        outs.append([(r.output, r.exit_points) for r in reqs])
        if m is m_ker:
            assert LAUNCHES["ssd_chunk"] == len(prompts) * run.model.num_layers
            q = "" if quant is None else "_q"
            assert LAUNCHES["argmax_verify" + q] > 0
            assert LAUNCHES["topk_verify" + q] > 0
            assert LAUNCHES["exit_gate" + q] > 0
        else:
            assert all(v == 0 for v in LAUNCHES.values())
    assert outs[0] == outs[1]


def _plant_ties_mma(w, hn, r):
    """Copy row r's best column inside its own 8-column MMA tile, into
    another 128-column strip and into the same offset of the first strip:
    the bf16 tensor-core tile must give the copies bit-identical logits and
    keep the lowest id. Returns that id."""
    V = w.shape[1]
    best = int((hn[r].float() @ w.float()).argmax())
    dups = {best, (best // 8) * 8 + (best % 8 + 1) % 8, (best + 3 * 128) % V,
            best % 128}
    dups = {j for j in dups if j < V}
    for j in dups:
        w[:, j] = w[:, best]
    return min(dups)


@pytest.mark.parametrize("D,V", [(128, 3001), (768, 50280), (4096, 32000)])
@pytest.mark.parametrize("R", [1, 4, 8, 17, 160, 320])
def test_argmax_verify_bf16_mma_matches_plain(dev, R, D, V):
    """The bf16 tensor-core argmax (csrc/lm_head_mma.cuh) at every row-tile
    choice, the element-load head path (V = 3001) and ragged last strips
    and hidden chunks (D = 128, 768; V = 50280): ids equal the plain fp32
    version's, values atol = rtol = 1e-4 (fp32 sums of exact bf16
    products in another order); ties planted inside one MMA tile and
    across strips resolve to the lowest id."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.exit_gate import exit_gate as eg
    from repro_torch.kernels.exit_gate import ref
    gen = torch.Generator(device=dev).manual_seed(R * 7 + D)
    hn = _rand(gen, (R, D), dev, torch.bfloat16)
    w = _rand(gen, (D, V), dev, torch.bfloat16, 0.05)
    lowest = _plant_ties_mma(w, hn, R - 1)
    reset_launches()
    tok, mx = eg.argmax_verify_fused(hn, w)
    torch.cuda.synchronize()
    assert LAUNCHES["argmax_verify"] == 1
    tok_r, mx_r = ref.verify_argmax_ref(hn, w)
    assert torch.equal(tok, tok_r)
    assert int(tok[R - 1]) == lowest
    torch.testing.assert_close(mx, mx_r, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("D,V", [(768, 50280), (4096, 32000)])
def test_argmax_verify_bf16_row_alone_bit_identical(dev, D, V):
    """A row's max logit is bit-identical whether it is verified alone, in
    a batch of 8 or inside the 160 node rows of a tree step (one, one and
    two row tiles of different heights)."""
    from repro_torch.kernels.exit_gate import exit_gate as eg
    gen = torch.Generator(device=dev).manual_seed(D)
    hn = _rand(gen, (160, D), dev, torch.bfloat16)
    w = _rand(gen, (D, V), dev, torch.bfloat16, 0.05)
    tok, mx = eg.argmax_verify_fused(hn, w)
    for r in (0, 7, 15, 16, 100, 159):
        t1, m1 = eg.argmax_verify_fused(hn[r:r + 1].clone(), w)
        assert int(t1[0]) == int(tok[r]) and torch.equal(m1[0], mx[r])
    t8, m8 = eg.argmax_verify_fused(hn[152:].clone(), w)
    assert torch.equal(t8, tok[152:]) and torch.equal(m8, mx[152:])


def test_bf16_kernels_refuse_what_their_tiles_cannot_take(dev):
    """The bf16 argmax refuses hidden rows it cannot copy 16 bytes at a time
    (D % 8 != 0, or a start off 16 bytes) and the strided ``embed.T``
    view; a head off 16 bytes is staged with element loads instead and
    gives the plain version's ids. The fp32 instance keeps taking any D.
    The bf16 flash kernel refuses q, k or v off 16 bytes."""
    from repro_torch.kernels.exit_gate import exit_gate as eg
    from repro_torch.kernels.exit_gate import ref
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_fwd)
    gen = torch.Generator(device=dev).manual_seed(9)
    bf = torch.bfloat16
    hn = _rand(gen, (4, 100), dev, bf)
    w = _rand(gen, (100, 1000), dev, bf, 0.05)
    with pytest.raises(ValueError, match="D % 8"):
        eg.argmax_verify_fused(hn, w)
    tok, mx = eg.argmax_verify_fused(hn.float(), w.float())
    tok_r, mx_r = ref.verify_argmax_ref(hn.float(), w.float())
    assert torch.equal(tok, tok_r)
    torch.testing.assert_close(mx, mx_r, atol=1e-4, rtol=1e-4)
    off = torch.empty(4 * 128 + 1, device=dev, dtype=bf)[1:].view(4, 128)
    off.copy_(_rand(gen, (4, 128), dev, bf))
    w = _rand(gen, (128, 1024), dev, bf, 0.05)
    with pytest.raises(ValueError, match="aligned"):
        eg.argmax_verify_fused(off, w)
    with pytest.raises(ValueError, match="contiguous"):
        eg.argmax_verify_fused(off.clone(), w.t().contiguous().t())
    w_off = torch.empty(128 * 1024 + 1, device=dev, dtype=bf)[1:].view(
        128, 1024)
    w_off.copy_(w)
    tok, mx = eg.argmax_verify_fused(off.clone(), w_off)
    tok_r, mx_r = ref.verify_argmax_ref(off.clone(), w)
    assert torch.equal(tok, tok_r)
    torch.testing.assert_close(mx, mx_r, atol=1e-4, rtol=1e-4)
    q = _rand(gen, (1, 9, 4, 64), dev, bf)
    kv = _rand(gen, (1, 9, 4, 64), dev, bf)
    q_off = torch.empty(q.numel() + 1, device=dev, dtype=bf)[1:].view(
        q.shape)
    q_off.copy_(q)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_fwd(q_off, kv, kv)
    torch.testing.assert_close(flash_attention_fwd(q.clone(), kv, kv).float(),
                               flash_attention_fwd(q, kv, kv).float())


@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("n_rep", [1, 4, 8])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 777])
def test_flash_attention_bf16_mma_matches_plain(dev, S, hd, n_rep, window):
    """The bf16 tensor-core flash kernel against the plain version on the
    inputs upcast to fp32, with the bf16 tolerance of the fp kernels'
    tests (atol 1e-4, rtol 2**-7: the output's rounding to bf16 errs by at
    most 2**-8 relative; P enters the products as two bf16 parts, ~16
    bits): one key tile, its edges and a ragged many-tile prompt, GQA up
    to 8 query heads per KV head, causal with and without a window."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_fwd)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    gen = torch.Generator(device=dev).manual_seed(S * 3 + hd + n_rep)
    B, H = 2, 8
    kvh = H // n_rep
    q = _rand(gen, (B, S, H, hd), dev, torch.bfloat16)
    k = _rand(gen, (B, S, kvh, hd), dev, torch.bfloat16)
    v = _rand(gen, (B, S, kvh, hd), dev, torch.bfloat16)
    reset_launches()
    got = flash_attention_fwd(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == 1
    want = flash_attention_ref(q.float(), k.float(), v.float(), True, window)
    torch.testing.assert_close(got.float(), want, atol=1e-4, rtol=2.0 ** -7)


# ---- the bf16 top-k and the quantized argmax on the tensor-core tile ----
def _plant_ties_q_mma(qt, hn, r):
    """Copy row r's best column (codes and scale) inside its own MMA tile
    (the code tile's n-tiles hold the even or the odd columns of a
    16-column block: best ^ 2 shares best's n-tile, best ^ 1 is in the
    other), into another 128-column strip and into the same offset of the
    first strip. Returns the lowest id among the copies."""
    from repro_torch.kernels.exit_gate import ref
    V = qt.shape[1]
    best = int(ref.verify_argmax_q_ref(hn[r:r + 1], qt)[0][0])
    dups = {best, best ^ 1, best ^ 2, (best + 3 * 128) % V, best % 128}
    dups = {j for j in dups if j < V}
    for j in dups:
        qt.q[:, j], qt.scale[j] = qt.q[:, best], qt.scale[best]
    return min(dups)


@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("D,V", [(128, 3001), (768, 50280), (4096, 32000)])
@pytest.mark.parametrize("R", [1, 4, 8, 17, 160, 320])
def test_topk_verify_bf16_mma_matches_plain(dev, R, D, V, k):
    """The bf16 tensor-core top-k (csrc/lm_head_mma.cuh, top-k epilogue)
    at every row-tile choice, the element-load head path (V = 3001) and
    ragged last strips and hidden chunks: ids equal the plain fp32
    version's (value descending, then id ascending), values atol = rtol =
    1e-4 (fp32 sums of exact bf16 products in another order); ties
    planted inside one MMA tile and across strips come out lowest id
    first."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.exit_gate import exit_gate as eg
    from repro_torch.kernels.exit_gate import ref
    gen = torch.Generator(device=dev).manual_seed(R * 11 + D + k)
    hn = _rand(gen, (R, D), dev, torch.bfloat16)
    w = _rand(gen, (D, V), dev, torch.bfloat16, 0.05)
    lowest = _plant_ties_mma(w, hn, R - 1)
    reset_launches()
    ids, vals = eg.topk_verify_fused(hn, w, k)
    torch.cuda.synchronize()
    assert LAUNCHES["topk_verify"] == 1
    ids_r, vals_r = ref.verify_topk_ref(hn, w, k)
    assert torch.equal(ids, ids_r)
    assert int(ids[R - 1, 0]) == lowest
    torch.testing.assert_close(vals, vals_r, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("D,V", [(512, 3001), (768, 50280), (4096, 32000)])
@pytest.mark.parametrize("R", [1, 4, 8, 17, 160, 320])
def test_argmax_verify_q_bf16_mma_matches_plain(dev, R, D, V, bits):
    """argmax_verify_q with bf16 hidden rows on the tensor-core tile (int8
    codes or plane-packed int4 bytes made bf16 in registers) at every
    row-tile choice and each head staging (16-byte copies at V = 32000,
    4-byte at V = 50280, element loads at V = 3001): ids equal the plain
    version's, values atol = rtol = 1e-4; planted ties (codes and scale
    copied) resolve to the lowest id; and ids and values equal the fp
    kernel's on the dequantized fp32 head."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.exit_gate import exit_gate as eg
    from repro_torch.kernels.exit_gate import ref
    gen = torch.Generator(device=dev).manual_seed(R * 13 + D + bits)
    qt = _quant_head(gen, dev, bits, D, V)
    hn = _rand(gen, (R, D), dev, torch.bfloat16)
    lowest = _plant_ties_q_mma(qt, hn, R - 1)
    reset_launches()
    tok, mx = eg.argmax_verify_fused_q(hn, qt)
    torch.cuda.synchronize()
    assert LAUNCHES["argmax_verify_q"] == 1
    tok_r, mx_r = ref.verify_argmax_q_ref(hn, qt)
    assert torch.equal(tok, tok_r)
    assert int(tok[R - 1]) == lowest
    torch.testing.assert_close(mx, mx_r, atol=1e-4, rtol=1e-4)
    tok_f, mx_f = eg.argmax_verify_fused(hn.float(), qt.dequantize())
    assert torch.equal(tok, tok_f)
    torch.testing.assert_close(mx, mx_f, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kernel", ["topk", "int8", "int4", "topk_int8",
                                    "topk_int4"])
@pytest.mark.parametrize("D,V", [(768, 50280), (4096, 32000)])
def test_verify_bf16_tiles_row_alone_bit_identical(dev, kernel, D, V):
    """The bf16 top-k and the bf16-input quantized argmax and top-k give a
    row bit-identical values whether it is verified alone, in a batch of 8
    or inside the 160 node rows of a tree step (one, one and two row tiles
    of different heights)."""
    from repro_torch.kernels.exit_gate import exit_gate as eg
    gen = torch.Generator(device=dev).manual_seed(D + len(kernel))
    hn = _rand(gen, (160, D), dev, torch.bfloat16)
    if kernel == "topk":
        w = _rand(gen, (D, V), dev, torch.bfloat16, 0.05)

        def run(x):
            return eg.topk_verify_fused(x, w, 4)
    elif kernel.startswith("topk_"):
        qt = _quant_head(gen, dev, 8 if kernel == "topk_int8" else 4, D, V)

        def run(x):
            return eg.topk_verify_fused_q(x, qt, 4)
    else:
        qt = _quant_head(gen, dev, 8 if kernel == "int8" else 4, D, V)

        def run(x):
            return eg.argmax_verify_fused_q(x, qt)
    ids, vals = run(hn)
    for r in (0, 7, 15, 16, 100, 159):
        i1, v1 = run(hn[r:r + 1].clone())
        assert torch.equal(i1[0], ids[r]) and torch.equal(v1[0], vals[r])
    i8, v8 = run(hn[152:].clone())
    assert torch.equal(i8, ids[152:]) and torch.equal(v8, vals[152:])


def test_bf16_tiles_refuse_before_any_launch(dev):
    """The bf16 top-k refuses hidden rows with D % 8 != 0 or a start off 16
    bytes, and the bf16-input quantized argmax D % 8 != 0 (int8) or D % 16
    != 0 (int4, whose high half must start 16-byte aligned), with a
    ValueError before any launch; fp32 hidden rows of the same width still
    stream. Codes off 16 bytes (and off 4) are staged with element loads
    and give the plain version's ids."""
    from repro_torch import quant
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.exit_gate import exit_gate as eg
    from repro_torch.kernels.exit_gate import ref
    gen = torch.Generator(device=dev).manual_seed(17)
    bf = torch.bfloat16
    reset_launches()
    hn = _rand(gen, (4, 100), dev, bf)
    w = _rand(gen, (100, 1000), dev, bf, 0.05)
    with pytest.raises(ValueError, match="D % 8"):
        eg.topk_verify_fused(hn, w, 4)
    off = torch.empty(4 * 128 + 1, device=dev, dtype=bf)[1:].view(4, 128)
    off.copy_(_rand(gen, (4, 128), dev, bf))
    with pytest.raises(ValueError, match="aligned"):
        eg.topk_verify_fused(off, _rand(gen, (128, 1000), dev, bf, 0.05), 4)
    q8 = _quant_head(gen, dev, 8, 100, 1000)
    with pytest.raises(ValueError, match="D % 8"):
        eg.argmax_verify_fused_q(hn, q8)
    h24 = _rand(gen, (4, 24), dev, bf)
    q4 = _quant_head(gen, dev, 4, 24, 1000)
    with pytest.raises(ValueError, match="D % 16"):
        eg.argmax_verify_fused_q(h24, q4)
    with pytest.raises(ValueError, match="aligned"):
        eg.argmax_verify_fused_q(off, _quant_head(gen, dev, 8, 128, 1000))
    torch.cuda.synchronize()
    assert all(v == 0 for v in LAUNCHES.values())
    ids, _ = eg.topk_verify_fused(hn.float(), w.float(), 4)
    assert torch.equal(ids, ref.verify_topk_ref(hn.float(), w.float(), 4)[0])
    for x, qt in ((hn, q8), (h24, q4)):
        tok, _ = eg.argmax_verify_fused_q(x.float(), qt)
        assert torch.equal(tok, ref.verify_argmax_q_ref(x.float(), qt)[0])
    qt = _quant_head(gen, dev, 8, 128, 1024)
    codes = torch.empty(qt.q.numel() + 1, device=dev,
                        dtype=torch.int8)[1:].view(128, 1024)
    codes.copy_(qt.q)
    q_off = quant.QTensor(codes, qt.scale, 8)
    h128 = _rand(gen, (4, 128), dev, bf)
    tok, mx = eg.argmax_verify_fused_q(h128, q_off)
    tok_r, mx_r = ref.verify_argmax_q_ref(h128, qt)
    assert torch.equal(tok, tok_r)
    torch.testing.assert_close(mx, mx_r, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("window", [None, "splits"])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("n_rep", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_split_long_cache(dev, dtype, n_rep, hd, window):
    """The dense split-KV kernel over a cache of four splits (4 * split
    slots, split from the kernel's rule): lengths 4 * split (every split
    live), 1, one key past a split boundary and one ending on it; a window
    of split + 300 keys leaves two whole splits before the first key of
    the full row. Against the plain version on the inputs upcast to fp32,
    at the file's tolerances; one launch."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.decode_attention.decode_attention import (
        decode_attention_fwd, dense_split_keys)
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    kvh = 2
    split = dense_split_keys(4096, hd, torch.empty(0, dtype=dtype)
                             .element_size())
    S = 4 * split
    assert dense_split_keys(S, hd, 2 if dtype == torch.bfloat16 else 4) \
        == split
    window = None if window is None else split + 300
    gen = torch.Generator(device=dev).manual_seed(26)
    q = _rand(gen, (4, 1, kvh * n_rep, hd), dev, dtype)
    k = _rand(gen, (4, S, kvh, hd), dev, dtype)
    v = _rand(gen, (4, S, kvh, hd), dev, dtype)
    clen = torch.tensor([S, 1, split + 1, split], dtype=torch.int32,
                        device=dev)
    reset_launches()
    got = decode_attention_fwd(q, k, v, clen, window=window)
    torch.cuda.synchronize()
    assert LAUNCHES["decode_attention"] == 1 and sum(LAUNCHES.values()) == 1
    want = decode_attention_ref(q.float(), k.float(), v.float(), clen, window)
    rtol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(got.float(), want, atol=1e-4, rtol=rtol)


def test_decode_attention_split_deterministic(dev):
    """The dense kernel's splits merge in split order, whichever CTA
    merges: two calls on the same inputs are bit-equal, and every (row, KV
    head) ticket is back at 0 after each."""
    from repro_torch.kernels.decode_attention import decode_attention as da
    gen = torch.Generator(device=dev).manual_seed(27)
    S = 4096
    q = _rand(gen, (6, 1, 32, 128), dev, torch.bfloat16)
    k = _rand(gen, (6, S, 8, 128), dev, torch.bfloat16)
    v = _rand(gen, (6, S, 8, 128), dev, torch.bfloat16)
    clen = torch.tensor([4096, 3001, 1, 2048, 4095, 513], dtype=torch.int32,
                        device=dev)
    outs = []
    for _ in range(2):
        outs.append(da.decode_attention_fwd(q, k, v, clen))
        torch.cuda.synchronize()
        assert int(da._WORKSPACES[q.device].tickets.abs().sum()) == 0
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("B", [1, 4, 8, 33])
@pytest.mark.parametrize("D,V", [(768, 50280), (4096, 32000)])
def test_exit_gate_cluster_matches_plain(dev, D, V, B, k, dtype):
    """The cluster-split gate at mamba2-130m's and Llama-2-7B's widths
    (clusters of 3 and 8 CTAs per row), any row count, k up to its
    limit: against the plain version on the ids clamped to [0, V) (ids 0,
    V - 1, -5 and V + 7 among them), atol = rtol = 1e-4; one launch; two
    calls bit-equal (the partials are summed in rank order)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.exit_gate import exit_gate as eg
    from repro_torch.kernels.exit_gate import ref
    gen = torch.Generator(device=dev).manual_seed(28)
    H = 512
    hn = _rand(gen, (B, D), dev, dtype)
    w = _rand(gen, (D, V), dev, dtype, 0.05)
    ids = torch.randint(0, V, (B, k), generator=gen, device=dev,
                        dtype=torch.int32)
    edge = torch.tensor([0, V - 1, -5, V + 7], dtype=torch.int32, device=dev)
    ids.view(-1)[:min(4, B * k)] = edge[:min(4, B * k)]
    prev = torch.softmax(_rand(gen, (B, k), dev), -1)
    w1 = _rand(gen, (3 * k, H), dev, scale=(3 * k) ** -0.5)
    b1 = _rand(gen, (H,), dev, scale=0.1)
    w2 = _rand(gen, (H, 1), dev, scale=H ** -0.5)
    b2 = _rand(gen, (1,), dev, scale=0.1)
    reset_launches()
    got = eg.exit_gate_fused(hn, w, ids, prev, w1, b1, w2, b2)
    again = eg.exit_gate_fused(hn, w, ids, prev, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert LAUNCHES["exit_gate"] == 2 and sum(LAUNCHES.values()) == 2
    pred = {"layers": [{"w": w1, "b": b1}, {"w": w2, "b": b2}]}
    want = ref.exit_gate_ref(hn, w, ids.clamp(0, V - 1), prev, pred)
    for a, a2, b in zip(got, again, want):
        assert torch.equal(a, a2)
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def _quant_bank(gen, dev, k, H, bits):
    """A 2-layer predictor (l1, l2): fp32 weights for ``bits`` None, else
    ``quantize_tensor``'d (an odd 3k quantizes W1 to int8 under int4)."""
    from repro_torch import quant
    w1 = _rand(gen, (3 * k, H), dev, scale=(3 * k) ** -0.5)
    w2 = _rand(gen, (H, 1), dev, scale=H ** -0.5)
    if bits is not None:
        w1, w2 = quant.quantize_tensor(w1, bits), quant.quantize_tensor(
            w2, bits)
    return ({"w": w1, "b": _rand(gen, (H,), dev, scale=0.1)},
            {"w": w2, "b": _rand(gen, (1,), dev, scale=0.1)})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head_bits,bank_bits",
                         [(h, b) for h in (None, 8, 4) for b in (None, 8, 4)
                          if (h, b) != (None, None)])
@pytest.mark.parametrize("B", [1, 4, 8, 33])
@pytest.mark.parametrize("D,V", [(256, 3001), (768, 50280), (4096, 32000)])
def test_exit_gate_q_matches_plain(dev, D, V, B, head_bits, bank_bits,
                                   dtype):
    """The quantized cluster gate (csrc/exit_gate_q.cu) at mamba2-130m's
    and Llama-2-7B's widths and at D = 256 (a cluster of one CTA, whose
    threads each take two of the H = 512 hidden units), every (head, bank)
    pair of fp / int8 / int4 but the fp pair, any row count: against its plain version on the ids
    clamped to [0, V) (ids 0, V - 1, -5 and V + 7 among them), atol = rtol
    = 1e-4; k = 3 at odd B (F = 9: an int4 bank's W1 stays int8) and 4 at
    even B; one launch per call; two calls bit-equal."""
    from repro_torch import quant
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.exit_gate import exit_gate as eg
    from repro_torch.kernels.exit_gate import ref
    gen = torch.Generator(device=dev).manual_seed(B + D)
    k, H = (3 if B % 2 else 4), 512
    hn = _rand(gen, (B, D), dev, dtype)
    w = _rand(gen, (D, V), dev, dtype, 0.05)
    head = w if head_bits is None else quant.quantize_tensor(w.float(),
                                                             head_bits)
    del w
    ids = torch.randint(0, V, (B, k), generator=gen, device=dev,
                        dtype=torch.int32)
    edge = torch.tensor([0, V - 1, -5, V + 7], dtype=torch.int32, device=dev)
    ids.view(-1)[:min(4, B * k)] = edge[:min(4, B * k)]
    prev = torch.softmax(_rand(gen, (B, k), dev), -1)
    l1, l2 = _quant_bank(gen, dev, k, H, bank_bits)
    reset_launches()
    got = eg.exit_gate_fused_q(hn, head, ids, prev, l1, l2)
    again = eg.exit_gate_fused_q(hn, head, ids, prev, l1, l2)
    torch.cuda.synchronize()
    assert LAUNCHES["exit_gate_q"] == 2 and sum(LAUNCHES.values()) == 2
    want = ref.exit_gate_q_ref(hn, head, ids.clamp(0, V - 1), prev, l1, l2)
    for a, a2, b in zip(got, again, want):
        assert torch.equal(a, a2)
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_exit_gate_q_refuses_before_any_launch(dev):
    """The quantized gate raises a ValueError, and launches nothing, for k
    above ``exit_gate_q_max_k``, a bank slice that is not contiguous (never
    copied), layers of which one is quantized and one not, and an fp head
    with an fp bank (the fp gate's)."""
    from repro_torch import quant
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels import build
    from repro_torch.kernels.exit_gate import exit_gate as eg
    gen = torch.Generator(device=dev).manual_seed(41)
    B, D, V, H = 4, 512, 3001, 64
    hn = _rand(gen, (B, D), dev)
    w = _rand(gen, (D, V), dev, scale=0.05)
    head = quant.quantize_tensor(w, 8)
    reset_launches()
    k = build.c_func("exit_gate_q", "exit_gate_q_max_k", [])() + 1
    ids = torch.zeros(B, k, dtype=torch.int32, device=dev)
    prev = torch.full((B, k), 1.0 / k, device=dev)
    with pytest.raises(ValueError, match="k="):
        eg.exit_gate_fused_q(hn, head, ids, prev,
                             *_quant_bank(gen, dev, k, H, 8))
    ids, prev = ids[:, :4].contiguous(), prev[:, :4].contiguous()
    l1, l2 = _quant_bank(gen, dev, 4, H, 8)
    # a stacked bank laid out (E, H, F): its slice's (F, H) codes are strided
    codes = torch.zeros(3, H, 12, dtype=torch.int8, device=dev)
    strided = dict(l1, w=quant.QTensor(codes.transpose(1, 2)[1],
                                       l1["w"].scale, 8))
    with pytest.raises(ValueError, match="contiguous"):
        eg.exit_gate_fused_q(hn, head, ids, prev, strided, l2)
    fp1, fp2 = _quant_bank(gen, dev, 4, H, None)
    with pytest.raises(ValueError, match="both"):
        eg.exit_gate_fused_q(hn, head, ids, prev, l1, fp2)
    with pytest.raises(ValueError, match="neither"):
        eg.exit_gate_fused_q(hn, w, ids, prev, fp1, fp2)
    torch.cuda.synchronize()
    assert all(v == 0 for v in LAUNCHES.values())


# ---- the quantized top-k on the tensor-core tile ----
@pytest.mark.parametrize("k", [1, 3, 4, 8])
@pytest.mark.parametrize("D,V", [(512, 3008), (768, 50280), (512, 3001)])
@pytest.mark.parametrize("R", [1, 4, 8, 33, 160, 320])
@pytest.mark.parametrize("bits", [8, 4])
def test_topk_verify_q_bf16_mma_matches_plain(dev, bits, R, D, V, k):
    """topk_verify_q with bf16 hidden rows on the tensor-core tile (int8
    codes or plane-packed int4 bytes made bf16 in registers, the top-k
    epilogue) at every row-tile choice, k up to its limit and each head
    staging (16-byte copies at V = 3008, 4-byte at V = 50280, element
    loads at V = 3001): ids equal the plain version's (value descending,
    then id ascending), values atol = rtol = 1e-4; ties planted inside one
    MMA tile and across strips (codes and scale copied) come out lowest id
    first; and the first column is argmax_verify_q's result on the same
    inputs, the value bit-equal (one main loop, one k-order)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.exit_gate import exit_gate as eg
    from repro_torch.kernels.exit_gate import ref
    gen = torch.Generator(device=dev).manual_seed(R * 7 + D + V + k + bits)
    qt = _quant_head(gen, dev, bits, D, V)
    hn = _rand(gen, (R, D), dev, torch.bfloat16)
    lowest = _plant_ties_q_mma(qt, hn, R - 1)
    reset_launches()
    ids, vals = eg.topk_verify_fused_q(hn, qt, k)
    torch.cuda.synchronize()
    assert LAUNCHES["topk_verify_q"] == 1 and sum(LAUNCHES.values()) == 1
    ids_r, vals_r = ref.verify_topk_q_ref(hn, qt, k)
    assert torch.equal(ids, ids_r)
    assert int(ids[R - 1, 0]) == lowest
    torch.testing.assert_close(vals, vals_r, atol=1e-4, rtol=1e-4)
    tok, mx = eg.argmax_verify_fused_q(hn, qt)
    assert torch.equal(ids[:, 0], tok) and torch.equal(vals[:, 0], mx)


def test_topk_verify_q_refuses_before_any_launch(dev):
    """The bf16-input quantized top-k refuses hidden rows the tile cannot
    copy 16 bytes at a time (int8: D % 8 != 0; int4: D % 16 != 0, whose
    high half must start 16-byte aligned; a start off 16 bytes) and k above
    its limit, with a ValueError before any launch; fp32 hidden rows of the
    same widths still stream and give the plain version's ids."""
    from repro_torch.kernels import LAUNCHES, build, reset_launches
    from repro_torch.kernels.exit_gate import exit_gate as eg
    from repro_torch.kernels.exit_gate import ref
    gen = torch.Generator(device=dev).manual_seed(23)
    bf = torch.bfloat16
    reset_launches()
    hn = _rand(gen, (4, 100), dev, bf)
    q8 = _quant_head(gen, dev, 8, 100, 1000)
    with pytest.raises(ValueError, match="D % 8"):
        eg.topk_verify_fused_q(hn, q8, 4)
    h24 = _rand(gen, (4, 24), dev, bf)
    q4 = _quant_head(gen, dev, 4, 24, 1000)
    with pytest.raises(ValueError, match="D % 16"):
        eg.topk_verify_fused_q(h24, q4, 4)
    off = torch.empty(4 * 128 + 1, device=dev, dtype=bf)[1:].view(4, 128)
    off.copy_(_rand(gen, (4, 128), dev, bf))
    with pytest.raises(ValueError, match="aligned"):
        eg.topk_verify_fused_q(off, _quant_head(gen, dev, 8, 128, 1000), 4)
    k = build.c_func("topk_verify_q", "topk_verify_q_max_k", [])() + 1
    with pytest.raises(ValueError, match="k="):
        eg.topk_verify_fused_q(off.clone(),
                               _quant_head(gen, dev, 8, 128, 1000), k)
    torch.cuda.synchronize()
    assert all(v == 0 for v in LAUNCHES.values())
    for x, qt in ((hn, q8), (h24, q4)):
        ids, _ = eg.topk_verify_fused_q(x.float(), qt, 4)
        assert torch.equal(ids, ref.verify_topk_q_ref(x.float(), qt, 4)[0])


# ---- the fp spec head in two stages: column gather, then dot ----
def _tree_shaped(gen, dev, B, V, k=4, depth=3, branch=3):
    """Node tokens (B, N) with ids 0 and V - 1 and repeats, and rows of the
    gathered node columns (B*N, k) as the tree step builds them."""
    from repro_torch.core.tree import TreeSpec
    tree = TreeSpec(depth, branch)
    N = tree.num_nodes
    toks = torch.randint(0, V, (B, N), generator=gen, device=dev,
                         dtype=torch.int32)
    toks[0, :4] = torch.tensor([0, V - 1, V - 1, 0], dtype=torch.int32)
    child = torch.as_tensor(tree.children, device=dev).long().clamp(min=0)
    if branch < k:
        child = torch.cat([child, child[:, :1].expand(N, k - branch)], 1)
    child = child[:, :k]
    rows = (torch.arange(B, device=dev)[:, None, None] * N
            + child[None]).reshape(B * N, k).to(torch.int32)
    return toks, rows


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,V", [(512, 3001), (4096, 32000)])
@pytest.mark.parametrize("C", [1, 5, 160, 320])
def test_spec_head_gather_is_exact(dev, C, D, V, dtype):
    """The column gather: an exact (bit-equal) copy of the plain version's
    columns, ids 0, V - 1, repeated and out of range (clamped to [0, V))
    among them; one launch."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.spec_head.ref import spec_gather_ref
    from repro_torch.kernels.spec_head.spec_head import spec_head_gather
    gen = torch.Generator(device=dev).manual_seed(C + D)
    w = _rand(gen, (D, V), dev, dtype, 0.05)
    ids = torch.randint(0, V, (C,), generator=gen, device=dev,
                        dtype=torch.int32)
    edge = torch.tensor([0, V - 1, V - 1, -4, V + 9], dtype=torch.int32,
                        device=dev)
    ids[:min(C, 5)] = edge[:min(C, 5)]
    reset_launches()
    cols = spec_head_gather(w, ids)
    torch.cuda.synchronize()
    assert LAUNCHES["spec_head_gather"] == 1 and sum(LAUNCHES.values()) == 1
    assert cols.dtype == dtype and cols.shape == (C, D)
    assert torch.equal(cols, spec_gather_ref(w, ids))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,V", [(512, 3001), (4096, 32000), (100, 999)])
@pytest.mark.parametrize("R", [1, 5, 160, 320])
def test_spec_head_dot_matches_plain(dev, R, D, V, dtype):
    """The dot over gathered columns against its plain version, atol = rtol
    = 1e-4 (fp32 sums in another order): on tree-shaped rows (the node
    columns of B = R // 40 rows of a TreeSpec(3, 3) step, gathered once)
    where R is a whole number of trees, else on rows of R*k gathered ids;
    D = 100 in bf16 takes the element path. Two calls are bit-equal, and a
    row's logits do not depend on the rows beside it."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.spec_head.ref import spec_dot_ref
    from repro_torch.kernels.spec_head.spec_head import (spec_head_dot,
                                                         spec_head_gather)
    gen = torch.Generator(device=dev).manual_seed(R + D)
    w = _rand(gen, (D, V), dev, dtype, 0.05)
    if R % 40 == 0:
        toks, rows = _tree_shaped(gen, dev, R // 40, V)
        ids = toks.reshape(-1)
    else:
        ids = torch.randint(0, V, (R * 4,), generator=gen, device=dev,
                            dtype=torch.int32)
        ids[:4] = torch.tensor([0, V - 1, V - 1, 0], dtype=torch.int32)
        rows = torch.arange(R * 4, device=dev, dtype=torch.int32).view(R, 4)
    hn = _rand(gen, (R, D), dev, dtype)
    cols = spec_head_gather(w, ids)
    reset_launches()
    got = spec_head_dot(hn, cols, rows)
    again = spec_head_dot(hn, cols, rows)
    torch.cuda.synchronize()
    assert LAUNCHES["spec_head"] == 2 and sum(LAUNCHES.values()) == 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got, spec_dot_ref(hn, cols, rows), atol=1e-4,
                               rtol=1e-4)
    alone = spec_head_dot(hn[-1:].clone(), cols, rows[-1:].clone())
    assert torch.equal(alone[0], got[-1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spec_head_two_stages_on_tree_ids(dev, dtype):
    """One step's composition at Llama-2-7B widths: the node tokens of a
    B = 4 TreeSpec(3, 3) step gathered once, dotted with the nodes'
    children, equal spec_head_logits on the children's ids and the plain
    version (atol = rtol = 1e-4); spec_head_logits itself is one gather
    and one dot."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.spec_head.ref import spec_logits_ref
    from repro_torch.kernels.spec_head.spec_head import (spec_head_dot,
                                                         spec_head_gather,
                                                         spec_head_logits)
    gen = torch.Generator(device=dev).manual_seed(160)
    D, V = 4096, 32000
    toks, rows = _tree_shaped(gen, dev, 4, V)
    w = _rand(gen, (D, V), dev, dtype, 0.05)
    hn = _rand(gen, (rows.shape[0], D), dev, dtype)
    ids = toks.reshape(-1)[rows.long()].contiguous()
    got = spec_head_dot(hn, spec_head_gather(w, toks.reshape(-1)), rows)
    reset_launches()
    direct = spec_head_logits(hn, w, ids)
    torch.cuda.synchronize()
    assert LAUNCHES["spec_head_gather"] == 1 and LAUNCHES["spec_head"] == 1
    assert torch.equal(got, direct)
    torch.testing.assert_close(got, spec_logits_ref(hn, w, ids), atol=1e-4,
                               rtol=1e-4)


# ---- the quantized tree gate: code-column gather, dot, predictor ----
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("D,V", [(512, 3001), (4096, 32000)])
@pytest.mark.parametrize("C", [1, 5, 160, 320])
def test_spec_head_gather_q_is_exact(dev, C, D, V, bits):
    """The code-column gather: codes and scales bit-equal to the plain
    version's, ids 0, V - 1, repeated and out of range (clamped to
    [0, V)) among them; one launch."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.spec_head.ref import spec_gather_q_ref
    from repro_torch.kernels.spec_head.spec_head import spec_head_gather_q
    gen = torch.Generator(device=dev).manual_seed(C + D + bits)
    qt = _quant_head(gen, dev, bits, D, V)
    ids = torch.randint(0, V, (C,), generator=gen, device=dev,
                        dtype=torch.int32)
    edge = torch.tensor([0, V - 1, V - 1, -4, V + 9], dtype=torch.int32,
                        device=dev)
    ids[:min(C, 5)] = edge[:min(C, 5)]
    reset_launches()
    cols = spec_head_gather_q(qt, ids)
    torch.cuda.synchronize()
    assert LAUNCHES["spec_head_gather_q"] == 1 and sum(LAUNCHES.values()) == 1
    want = spec_gather_q_ref(qt, ids)
    assert cols.bits == bits and cols.codes.shape == want.codes.shape
    assert torch.equal(cols.codes, want.codes)
    assert torch.equal(cols.scales, want.scales)


@pytest.mark.parametrize("k", [1, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("D,V", [(512, 3001), (4096, 32000), (100, 999)])
@pytest.mark.parametrize("R", [1, 160, 320])
def test_spec_head_dot_q_matches_plain(dev, R, D, V, bits, dtype, k):
    """The dot over gathered code columns against its plain version, atol
    = rtol = 1e-4 (fp32 sums in another order, then the scale), on rows of
    R*k gathered ids; D = 100 takes the stored-row path (100 or 50 stored
    rows). Two calls are bit-equal, and a row's logits do not depend on
    the rows beside it."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.spec_head.ref import spec_dot_q_ref
    from repro_torch.kernels.spec_head.spec_head import (spec_head_dot_q,
                                                         spec_head_gather_q)
    gen = torch.Generator(device=dev).manual_seed(R + D + k + bits)
    qt = _quant_head(gen, dev, bits, D, V)
    ids = torch.randint(0, V, (R * k,), generator=gen, device=dev,
                        dtype=torch.int32)
    n = min(2, R * k)
    ids[:n] = torch.tensor([0, V - 1], dtype=torch.int32)[:n]
    cols = spec_head_gather_q(qt, ids)
    rows = torch.randint(0, R * k, (R, k), generator=gen, device=dev,
                         dtype=torch.int32)
    hn = _rand(gen, (R, D), dev, dtype)
    reset_launches()
    got = spec_head_dot_q(hn, cols, rows)
    again = spec_head_dot_q(hn, cols, rows)
    torch.cuda.synchronize()
    assert LAUNCHES["spec_head_q"] == 2 and sum(LAUNCHES.values()) == 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got, spec_dot_q_ref(hn, cols, rows),
                               atol=1e-4, rtol=1e-4)
    alone = spec_head_dot_q(hn[-1:].clone(), cols, rows[-1:].clone())
    assert torch.equal(alone[0], got[-1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4])
def test_spec_head_q_two_stages_on_tree_ids(dev, bits, dtype):
    """One quantized tree step's composition at Llama-2-7B widths: the node
    tokens of a B = 4 TreeSpec(3, 3) step gathered once, dotted with the
    nodes' children, equal spec_head_logits_q on the children's ids (bit
    for bit: the same dot of each pair) and the plain version (atol = rtol
    = 1e-4)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.spec_head.ref import spec_logits_ref
    from repro_torch.kernels.spec_head.spec_head import (spec_head_dot_q,
                                                         spec_head_gather_q,
                                                         spec_head_logits_q)
    gen = torch.Generator(device=dev).manual_seed(160 + bits)
    D, V = 4096, 32000
    toks, rows = _tree_shaped(gen, dev, 4, V)
    qt = _quant_head(gen, dev, bits, D, V)
    hn = _rand(gen, (rows.shape[0], D), dev, dtype)
    ids = toks.reshape(-1)[rows.long()].contiguous()
    reset_launches()
    got = spec_head_dot_q(hn, spec_head_gather_q(qt, toks.reshape(-1)), rows)
    torch.cuda.synchronize()
    assert LAUNCHES["spec_head_gather_q"] == 1 and LAUNCHES["spec_head_q"] == 1
    assert torch.equal(got, spec_head_logits_q(hn, qt, ids))
    torch.testing.assert_close(got, spec_logits_ref(hn, qt, ids), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("F", [12, 15, 24])
@pytest.mark.parametrize("H", [512, 200])
@pytest.mark.parametrize("bits1,bits2", [(8, 8), (4, 4), (8, 4), (4, 8)])
@pytest.mark.parametrize("R", [1, 4, 108, 216])
def test_predictor_mlp_q_rows_match_plain(dev, R, bits1, bits2, H, F):
    """The quantized predictor over blocks of rows against its plain
    version, atol = rtol = 1e-5 on probabilities, each weight's bits on
    its own (H = 200 leaves threads without a hidden unit); two calls are
    bit-equal and a row's probability does not depend on the rows beside
    it. F = 12 (k = 4) runs the kernel's instance unrolled to 12 features,
    F = 15 and 24 (k = 8) the one unrolled to 32; an odd F's int4 W1 is
    stored as int8 codes (plane packing needs even rows)."""
    from repro_torch import quant
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.predictor_mlp.predictor_mlp import (
        predictor_mlp_fused_q)
    from repro_torch.kernels.predictor_mlp.ref import predictor_mlp_q_ref
    gen = torch.Generator(device=dev).manual_seed(
        R + 10 * bits1 + bits2 + H + 1000 * F)
    x = _rand(gen, (R, F), dev)
    q1 = quant.quantize_tensor(_rand(gen, (F, H), dev, scale=0.3), bits1)
    q2 = quant.quantize_tensor(_rand(gen, (H, 1), dev, scale=0.05), bits2)
    b1, b2 = _rand(gen, (H,), dev), _rand(gen, (1,), dev)
    reset_launches()
    got = predictor_mlp_fused_q(x, q1, b1, q2, b2)
    again = predictor_mlp_fused_q(x, q1, b1, q2, b2)
    torch.cuda.synchronize()
    assert LAUNCHES["predictor_mlp_q"] == 2 and sum(LAUNCHES.values()) == 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got, predictor_mlp_q_ref(x, q1, b1, q2, b2),
                               atol=1e-5, rtol=1e-5)
    alone = predictor_mlp_fused_q(x[-1:].clone(), q1, b1, q2, b2)
    assert torch.equal(alone[0], got[-1])


def test_train_steps_on_card_match_cpu(dev, monkeypatch):
    """Two smoke-config ``TrainLoop`` steps and three ``train_predictors``
    steps on the card against the same steps on the CPU, from the same
    weights and data, TF32 off: losses rtol 1e-5; parameters atol steps *
    lr (Adam divides by sqrt(v): an element whose gradient is float noise
    can move by up to lr a step either way; the first step's lr is 0)."""
    from repro_torch.configs import get_config
    from repro_torch.core import predictor as pred_lib
    from repro_torch.core import predictor_training as pt
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.model import build_model
    from repro_torch.train import TrainLoop
    run = get_config("llama2-7b").smoke()
    model = build_model(run)
    params = model.init(0, "cpu")
    loops = [TrainLoop(model, run, tree_map(lambda x: x.to(d), params))
             for d in ("cpu", dev)]
    for loop in loops:
        loop.run_steps(2)
    cpu, card = loops
    assert all(x.is_cuda for x in tree_leaves(card.params))
    np.testing.assert_allclose([h["loss"] for h in card.history],
                               [h["loss"] for h in cpu.history], rtol=1e-5)
    atol = 2 * run.train.learning_rate
    for a, b in zip(tree_leaves(card.params), tree_leaves(cpu.params)):
        torch.testing.assert_close(a.cpu(), b, atol=atol, rtol=0)
    # predictors: the same init and features on both devices
    spec = run.specee
    gen = torch.Generator().manual_seed(3)
    init = pred_lib.init_predictors(spec, 4, gen, "cpu")
    feats = torch.randn(4, 300, spec.feature_dim(), generator=gen)
    labels = (torch.rand(4, 300, generator=gen) < 0.4).float()
    out = []
    for d in ("cpu", dev):
        monkeypatch.setattr(pred_lib, "init_predictors",
                            lambda *a, d=d, **k: tree_map(lambda x: x.to(d),
                                                          init))
        data = pt.FeatureDataset(features=feats.to(d), labels=labels.to(d))
        out.append(pt.train_predictors(spec, data, None, steps=3))
    (p_cpu, m_cpu), (p_card, m_card) = out
    assert m_card["final_loss"] == pytest.approx(m_cpu["final_loss"],
                                                 rel=1e-5)
    for a, b in zip(tree_leaves(p_card), tree_leaves(p_cpu)):
        assert a.is_cuda
        torch.testing.assert_close(a.cpu(), b, atol=3e-3, rtol=0)


@pytest.mark.parametrize("window", [None, 300])
@pytest.mark.parametrize("kvh", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reader", ["dense", "fp", "int8"])
def test_attention_kernels_at_12_heads_per_kv_head(dev, reader, dtype, kvh,
                                                   window):
    """The dense, paged and int8-paged split-KV kernels at 12 query heads
    per KV head of 128 (StarCoder2-15B's 48 over 4, Command R+'s 96 over
    8): rows of one and of many splits, a retired paged row; against the
    plain version on the inputs upcast to fp32, at the file's tolerances;
    one launch each. At another head dim there is no n_rep-12 instance:
    the call raises and launches nothing."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.decode_attention.decode_attention import (
        decode_attention_fwd, paged_decode_attention_fwd)
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref, paged_decode_attention_ref)
    hd = 128
    gen = torch.Generator(device=dev).manual_seed(27 + kvh)
    rtol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    if reader == "dense":
        reset_launches()
        with pytest.raises(RuntimeError):
            decode_attention_fwd(
                _rand(gen, (1, 1, 12, 64), dev, dtype),
                *[_rand(gen, (1, 8, 1, 64), dev, dtype)] * 2,
                torch.ones(1, dtype=torch.int32, device=dev))
        torch.cuda.synchronize()
        assert sum(LAUNCHES.values()) == 0
        S = 4096
        q = _rand(gen, (4, 1, 12 * kvh, hd), dev, dtype)
        k = _rand(gen, (4, S, kvh, hd), dev, dtype)
        v = _rand(gen, (4, S, kvh, hd), dev, dtype)
        clen = torch.tensor([150, S, 1, 2049], dtype=torch.int32,
                            device=dev)
        reset_launches()
        got = decode_attention_fwd(q, k, v, clen, window=window)
        torch.cuda.synchronize()
        assert LAUNCHES["decode_attention"] == 1
        want = decode_attention_ref(q.float(), k.float(), v.float(), clen,
                                    window)
        torch.testing.assert_close(got.float(), want, atol=1e-4, rtol=rtol)
        return
    name = "paged_decode_attention" + ("_q" if reader == "int8" else "")
    args, kw = _split_case(gen, dev, reader, dtype, 12, hd,
                           [4096, 150, 2 * 128 + 3, 1], kvh=kvh)
    reset_launches()
    got = paged_decode_attention_fwd(*args, window=window, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == 1 and sum(LAUNCHES.values()) == 1
    q, kp, vp, table, clen = args
    if reader == "fp":
        kp, vp = kp.float(), vp.float()
    want = paged_decode_attention_ref(q.float(), kp, vp, table, clen, window,
                                      kw.get("k_scale"), kw.get("v_scale"))
    assert bool(torch.isfinite(got.float()).all())
    torch.testing.assert_close(got.float()[:-1], want[:-1], atol=1e-4,
                               rtol=rtol)


@pytest.mark.parametrize("kernel", ["argmax", "topk", "argmax_int8",
                                    "argmax_int4", "topk_int8", "topk_int4"])
@pytest.mark.parametrize("R", [1, 4, 160])
def test_verify_tiles_at_minicpm_head(dev, kernel, R):
    """The four verify tiles (fp and quantized argmax and top-k) on bf16
    hidden rows at MiniCPM-2B's head, D = 2304 and an odd vocabulary V =
    122753 (element-load head staging): ids equal the plain version's,
    values atol = rtol = 1e-4; a planted tie resolves to the lowest id."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.exit_gate import exit_gate as eg
    from repro_torch.kernels.exit_gate import ref
    D, V, k = 2304, 122753, 4
    gen = torch.Generator(device=dev).manual_seed(R + len(kernel))
    hn = _rand(gen, (R, D), dev, torch.bfloat16)
    reset_launches()
    if kernel in ("argmax", "topk"):
        w = _rand(gen, (D, V), dev, torch.bfloat16, 0.05)
        lowest = _plant_ties_mma(w, hn, R - 1)
        if kernel == "argmax":
            got, got_r = eg.argmax_verify_fused(hn, w), \
                ref.verify_argmax_ref(hn, w)
        else:
            got, got_r = eg.topk_verify_fused(hn, w, k), \
                ref.verify_topk_ref(hn, w, k)
        launched = kernel + "_verify"
    else:
        qt = _quant_head(gen, dev, int(kernel[-1]), D, V)
        lowest = _plant_ties_q_mma(qt, hn, R - 1)
        if kernel.startswith("argmax"):
            got, got_r = eg.argmax_verify_fused_q(hn, qt), \
                ref.verify_argmax_q_ref(hn, qt)
        else:
            got, got_r = eg.topk_verify_fused_q(hn, qt, k), \
                ref.verify_topk_q_ref(hn, qt, k)
        launched = kernel.split("_")[0] + "_verify_q"
    torch.cuda.synchronize()
    assert LAUNCHES[launched] == 1
    ids, vals = got
    assert torch.equal(ids, got_r[0])
    first = ids[R - 1] if ids.dim() == 1 else ids[R - 1, 0]
    assert int(first) == lowest
    torch.testing.assert_close(vals, got_r[1], atol=1e-4, rtol=1e-4)


def test_sampler_on_card_matches_cpu(dev):
    """The per-row sampler draws the CPU's tokens on the card for the same
    logits and keys (integer hashing is exact on both; the fp64 Gumbel
    noise's logarithms may differ by an ulp, so a differing draw is only
    allowed where the CPU's top two perturbed scores lie within 1e-12 of
    each other), across temperatures and top-k."""
    from repro_torch.serving import sampler
    gen = torch.Generator().manual_seed(31)
    B, V = 64, 32000
    logits = torch.randn((B, V), generator=gen) * 4
    pos = torch.randint(0, 4096, (B,), generator=gen)
    tok = torch.randint(0, V, (B,), generator=gen)
    for seed in (0, 7):
        keys = sampler.row_keys(seed, pos, tok)
        keys_d = sampler.row_keys(seed, pos.to(dev), tok.to(dev))
        assert torch.equal(keys_d.cpu(), keys)
        for temperature, top_k in ((1.0, None), (0.8, 50), (0.3, 1)):
            want = sampler.sample_rows(logits, keys, temperature, top_k)
            got = sampler.sample_rows(logits.to(dev), keys_d, temperature,
                                      top_k).cpu()
            for r in torch.nonzero(got != want).flatten().tolist():
                s = (sampler._scale(logits[r:r + 1], temperature, top_k)
                     .double() + sampler._gumbel(
                         keys[r:r + 1, None], torch.arange(V)[None]))[0]
                top2 = torch.topk(s, 2).values
                assert float(top2[0] - top2[1]) < 1e-12 * float(
                    top2[0].abs()), (seed, temperature, r)


# ---- the MoE, hybrid and VLM configs' head shapes ----
# (n_rep, hd, KV heads): DBRX's and InternVL2's 48 heads over 8 of 128,
# Qwen3-MoE's 64 over 4 of 64, RecurrentGemma's 16 over one of 256 (MQA,
# two CTAs per KV head of 8 heads each)
NEW_HEAD_SHAPES = [(6, 128, 8), (16, 64, 4), (16, 256, 1)]


@pytest.mark.parametrize("window", [None, 64, 300])
@pytest.mark.parametrize("shape", NEW_HEAD_SHAPES,
                         ids=lambda s: f"nrep{s[0]}-hd{s[1]}")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reader", ["dense", "fp", "int8"])
def test_attention_kernels_at_new_head_shapes(dev, reader, dtype, shape,
                                              window):
    """The dense, paged and int8-paged split-KV kernels at the head shapes
    of dbrx-132b / internvl2-26b, qwen3-moe-235b-a22b and
    recurrentgemma-9b: rows of one and of many splits (the fill rule cuts
    the MQA rows of one KV head into more), a retired paged row; against
    the plain version on the inputs upcast to fp32, at the file's
    tolerances; one launch each."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.decode_attention.decode_attention import (
        decode_attention_fwd, paged_decode_attention_fwd)
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref, paged_decode_attention_ref)
    n_rep, hd, kvh = shape
    gen = torch.Generator(device=dev).manual_seed(41 + n_rep + hd)
    rtol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    if reader == "dense":
        S = 2300
        q = _rand(gen, (4, 1, n_rep * kvh, hd), dev, dtype)
        k = _rand(gen, (4, S, kvh, hd), dev, dtype)
        v = _rand(gen, (4, S, kvh, hd), dev, dtype)
        clen = torch.tensor([150, S, 1, 2113], dtype=torch.int32,
                            device=dev)
        reset_launches()
        got = decode_attention_fwd(q, k, v, clen, window=window)
        torch.cuda.synchronize()
        assert LAUNCHES["decode_attention"] == 1
        want = decode_attention_ref(q.float(), k.float(), v.float(), clen,
                                    window)
        torch.testing.assert_close(got.float(), want, atol=1e-4, rtol=rtol)
        return
    name = "paged_decode_attention" + ("_q" if reader == "int8" else "")
    args, kw = _split_case(gen, dev, reader, dtype, n_rep, hd,
                           [4096, 150, 2 * 128 + 3, 2113, 1], kvh=kvh)
    reset_launches()
    got = paged_decode_attention_fwd(*args, window=window, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == 1 and sum(LAUNCHES.values()) == 1
    q, kp, vp, table, clen = args
    if reader == "fp":
        kp, vp = kp.float(), vp.float()
    want = paged_decode_attention_ref(q.float(), kp, vp, table, clen, window,
                                      kw.get("k_scale"), kw.get("v_scale"))
    assert bool(torch.isfinite(got.float()).all())
    torch.testing.assert_close(got.float()[:-1], want[:-1], atol=1e-4,
                               rtol=rtol)


# (n_rep, hd, KV heads) of a tensor-parallel shard of RecurrentGemma: its 16
# query heads over one KV head of 256 at P = 2 (8 heads a shard, two CTAs a
# KV head) and P = 4 (4 heads a shard, one CTA)
TP_HEAD_SHAPES = [(8, 256, 1), (4, 256, 1), (6, 128, 4), (6, 128, 2),
                  (16, 64, 1)]


@pytest.mark.parametrize("window", [None, 64, 300])
@pytest.mark.parametrize("shape", TP_HEAD_SHAPES,
                         ids=lambda s: f"nrep{s[0]}-hd{s[1]}")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reader", ["dense", "fp", "int8"])
def test_attention_kernels_at_tp_shard_head_shapes(dev, reader, dtype,
                                                   shape, window):
    """The dense, paged and int8-paged split-KV kernels at the head shapes
    of the tensor-parallel shards: n_rep 8 and 4 with hd 256 (the
    instances a shard of recurrentgemma-9b launches), and n_rep 6 at 128
    over 4 and 2 KV heads and 16 at 64 over one (dbrx-132b / internvl2-26b
    at P = 2, 4 and qwen3-moe at P = 4: fewer CTAs, other splits), by the
    cases of ``test_attention_kernels_at_new_head_shapes``: against the
    plain version, one launch each."""
    test_attention_kernels_at_new_head_shapes(dev, reader, dtype, shape,
                                              window)


def test_grid_split_fills_the_card_only_where_it_is_idle(dev):
    """The fill rule: a launch whose first split index already gives at
    least one CTA per SM keeps the shape rule's split (Llama-2-7B's 32 KV
    heads at B = 4, 4096 slots: 2 splits of 128 CTAs); RecurrentGemma's
    one KV head at B = 4 (2 CTAs per KV head) is cut into splits of at least 256 KB of K and V that give more
    CTAs, whole pages in the paged kernels; the merged output stays
    deterministic and every ticket returns to 0."""
    from repro_torch.kernels.decode_attention import decode_attention as da
    assert da.dense_grid_split(4096, 128, 2, 4, 32, 1) == \
        da.dense_split_keys(4096, 128, 2)
    base = da.dense_split_keys(2300, 256, 2)
    split = da.dense_grid_split(2300, 256, 2, 4, 1, 16)
    assert 256 <= split < base and 8 * -(-2300 // split) > 8
    for name in ("paged_decode_attention", "paged_decode_attention_q"):
        esize = 1 if name.endswith("_q") else 2
        ps_split = da.grid_split(name, 20, 128, 256, esize, 4, 1, 16)
        assert ps_split % 128 == 0
        assert ps_split <= da.split_keys(name, 20, 128)
        assert ps_split * 2 * 256 * esize >= 1 << 18
    gen = torch.Generator(device=dev).manual_seed(44)
    q = _rand(gen, (4, 1, 16, 256), dev, torch.bfloat16)
    k = _rand(gen, (4, 2300, 1, 256), dev, torch.bfloat16)
    v = _rand(gen, (4, 2300, 1, 256), dev, torch.bfloat16)
    clen = torch.tensor([2300, 2200, 700, 1], dtype=torch.int32, device=dev)
    outs = []
    for _ in range(2):
        outs.append(da.decode_attention_fwd(q, k, v, clen, window=2048))
        torch.cuda.synchronize()
        assert int(da._WORKSPACES[q.device].tickets.abs().sum()) == 0
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("window", [None, 64, 2048])
@pytest.mark.parametrize("dtype,S", [(torch.bfloat16, 2100),
                                     (torch.bfloat16, 77),
                                     (torch.float32, 300)])
def test_flash_attention_at_hd_256(dev, dtype, S, window):
    """Flash attention at RecurrentGemma's head dim 256, 16 query heads
    over one KV head: the bf16 tensor-core body (32-key tiles, Q
    fragments reloaded per tile) over a prompt that crosses the 2048
    window and a ragged one-tile prompt, and the fp32 body; against the
    plain version on the inputs upcast to fp32, at the file's
    tolerances; one launch each."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_fwd)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    gen = torch.Generator(device=dev).manual_seed(S + (window or 0))
    B, H, hd = 2, 16, 256
    q = _rand(gen, (B, S, H, hd), dev, dtype)
    k = _rand(gen, (B, S, 1, hd), dev, dtype)
    v = _rand(gen, (B, S, 1, hd), dev, dtype)
    reset_launches()
    got = flash_attention_fwd(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == 1
    want = flash_attention_ref(q.float(), k.float(), v.float(), True, window)
    rtol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(got.float(), want, atol=1e-4, rtol=rtol)


@pytest.fixture(scope="module")
def card():
    """The card alone, for tests that build no kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_row_collectives_autograd_on_the_card(card):
    """The 'data' axis's collectives (``gather_rows``, ``reduce_scatter_
    rows``, ``all_reduce_rows``) on the card give the CPU's values and
    gradients bit for bit, with their rows on the card, and count one
    call each way."""
    from repro_torch.runtime import collectives as C
    gen = torch.Generator().manual_seed(0)
    xs = [torch.randn(3, 5, generator=gen) for _ in range(2)]
    ys = [torch.randn(6, 5, generator=gen) for _ in range(2)]
    ws = [torch.randn(6, 5, generator=gen) for _ in range(2)]
    out = {}
    for dev in (torch.device("cpu"), card):
        a = [x.to(dev).requires_grad_(True) for x in xs]
        b = [y.to(dev).requires_grad_(True) for y in ys]
        C.reset_counts()
        g = C.gather_rows(a, [dev, dev], 0)
        r = C.reduce_scatter_rows(b, [dev, dev], 0, [3, 3])
        s = C.all_reduce_rows([x * 2 for x in a], [dev, dev])
        loss = sum((o * w.to(dev)).sum() for o, w in zip(g, ws)) + \
            sum((o * x.to(dev)).sum() for o, x in zip(r, xs)) + \
            sum((o ** 2).sum() for o in s)
        loss.backward()
        assert {k: v["calls"] for k, v in C.COUNTS.items()} == {
            "all-gather": 2, "reduce-scatter": 2, "all-reduce": 2}
        out[dev.type] = [t.detach().cpu() for t in g + r + s] + \
            [x.grad.cpu() for x in a + b]
    for u, v in zip(out["cpu"], out["cuda"]):
        assert torch.equal(u, v)


def test_ep_quant_scale_on_the_card(card):
    """``quantize_tokens`` on the card: scales and codes bit-equal to the
    CPU's (the scale multiplies by fp32(1/127) as a tensor, which both
    devices round alike), and so is the dequantized gradient."""
    from repro_torch.runtime.collectives import (dequantize_tokens,
                                                 quantize_tokens)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(4, 64, 4096, generator=gen) * 3
    got = {}
    for dev in (torch.device("cpu"), card):
        xd = x.to(dev).requires_grad_(True)
        q, s = quantize_tokens(xd)
        y = dequantize_tokens(q, s, torch.float32)
        (g,) = torch.autograd.grad((y * y).sum(), xd)
        got[dev.type] = (q.cpu(), s.detach().cpu(), g.cpu())
    for u, v in zip(got["cpu"], got["cuda"]):
        assert torch.equal(u, v)
    amax = x.abs().amax(dim=-1) + 1e-8
    assert torch.equal(got["cuda"][1], amax * torch.tensor(1 / 127.0))


def test_mesh_training_on_the_card(card):
    """llama2-7b's smoke config trained at (2, 2) (every slot on the
    card, fsdp_tp) against (1, 1) on the card: three steps' losses and
    grad norms at rtol 1e-5, params at atol 1e-6."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.model import build_model
    from repro_torch.train import TrainLoop
    run = get_config("llama2-7b").smoke()
    run = dataclasses.replace(run, train=dataclasses.replace(
        run.train, microbatch=2))
    model = build_model(run)
    params = model.init(0, "cpu")
    a = TrainLoop(model, run, {k: v for k, v in params.items()},
                  mesh=make_host_mesh(1, 1, card))
    b = TrainLoop(model, run, params, mesh=make_host_mesh(2, 2, card))
    for _ in range(3):
        sa, sb = a.run_steps(1), b.run_steps(1)
        assert sb["loss"] == pytest.approx(sa["loss"], rel=1e-5)
        assert sb["grad_norm"] == pytest.approx(sa["grad_norm"], rel=1e-5)
    for x, y in zip(tree_leaves(a.whole("cpu")), tree_leaves(b.whole("cpu"))):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-6)
