"""The SSD intra-chunk kernel's operand rounding (csrc/ssd_chunk.cu) on the
CPU, against JAX's Pallas ``ssd_chunk_fwd`` in interpret mode.

The kernel runs both of its products on tensor cores: the Gram matrix
C.B^T by bf16 mma (bf16 B/C: exact products, fp32 sums) or by 3xTF32 mma
(fp32 B/C), and y = W . xdt by 3xTF32 mma, W = C.B^T * exp(cum_t - cum_s)
where s <= t, else 0. 3xTF32 splits each fp32 operand x into hi = tf32(x)
and lo = tf32(x - hi) (tf32: 10 stored mantissa bits, rounded to nearest,
ties away from zero, as ``cvt.rna.tf32.f32``) and sums a_hi.b_lo +
a_lo.b_hi + a_hi.b_hi in fp32, dropping a_lo.b_lo. The decay is __expf,
2^(x log2 e) with the product rounded to fp32. ``_ssd_split`` below
rounds every operand so, sums in fp32, and must meet the tolerance the
card tests hold the kernel to (atol = rtol = 1e-4) against JAX at the
card tests' shapes and scales (B/C scaled by ds^-0.25; steep decay, cum
falling by up to 40 per token, and mild, up to 1), with 1-2 cells, and a
ragged case (c, hd, ds not multiples of 16). Plain TF32 (the hi parts
alone) is shown to miss that tolerance at mamba2-130m's shapes, so the
split is needed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_chunk.ssd_chunk import ssd_chunk_fwd as j_chunk  # noqa
from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
LOG2E = 1.4426950408889634
# (cells, c, ds, hd, nh): the card tests' shapes at 1-2 cells, and ragged
SHAPES = [(2, 32, 16, 32, 4), (1, 64, 128, 64, 24), (2, 64, 16, 32, 5),
          (1, 32, 128, 64, 24), (2, 40, 16, 48, 5)]


def _tf32(x):
    """fp32 rounded to tf32 as cvt.rna.tf32.f32 does: the 13 low mantissa
    bits dropped after adding half of their weight to the magnitude."""
    u = x.float().contiguous().view(torch.int32).to(torch.int64)
    u = ((u & 0xFFFFFFFF) + 0x1000) & 0xFFFFE000
    u = torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32)
    return u.view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x.float() - hi)


def _prod3(eq, a, b):
    """a . b from 3xTF32-split operands, each product summed in fp32."""
    ah, al = _split(a)
    bh, bl = _split(b)
    return (torch.einsum(eq, ah, bl) + torch.einsum(eq, al, bh)
            + torch.einsum(eq, ah, bh))


def _ssd_split(xdt, cum, Bc, Cc, split=True):
    """The kernel's function with its operand rounding: the Gram matrix
    exact-product bf16 or 3xTF32, the decayed weights where s <= t, the
    second product 3xTF32 (``split=False``: plain TF32, the hi parts
    alone)."""
    c = xdt.shape[1]
    if Bc.dtype == torch.bfloat16:
        cb = torch.einsum("bqd,bsd->bqs", Cc.float(), Bc.float())
    elif split:
        cb = _prod3("bqd,bsd->bqs", Cc, Bc)
    else:
        cb = torch.einsum("bqd,bsd->bqs", _tf32(Cc), _tf32(Bc))
    rel = cum[:, :, None, :] - cum[:, None, :, :]             # (B,c,c,nh)
    causal = torch.ones(c, c, dtype=torch.bool).tril()[None, :, :, None]
    # __expf: 2 ** (x * log2 e), the product rounded to fp32
    dec = torch.exp2(rel * torch.tensor(LOG2E, dtype=torch.float32))
    w = torch.where(causal, cb[..., None] * dec, torch.zeros(()))
    if split:
        return _prod3("bqsh,bshp->bqhp", w, xdt)
    return torch.einsum("bqsh,bshp->bqhp", _tf32(w), _tf32(xdt))


def _inputs(seed, cells, c, ds, hd, nh, bc_dtype, steep):
    rng = np.random.default_rng(seed)
    xdt = rng.standard_normal((cells, c, nh, hd)).astype(np.float32)
    cum = -np.cumsum(rng.uniform(0, steep, (cells, c, nh)), axis=1
                     ).astype(np.float32)
    bc = [torch.from_numpy((rng.standard_normal((cells, c, ds))
                            * ds ** -0.25).astype(np.float32)).to(bc_dtype)
          for _ in range(2)]
    return torch.from_numpy(xdt), torch.from_numpy(cum), bc[0], bc[1]


def _jax(xdt, cum, Bc, Cc):
    bf = Bc.dtype == torch.bfloat16
    bj, cj = (jnp.asarray(t.float().numpy()) for t in (Bc, Cc))
    if bf:
        bj, cj = bj.astype(jnp.bfloat16), cj.astype(jnp.bfloat16)
    return np.asarray(j_chunk(jnp.asarray(xdt.numpy()),
                              jnp.asarray(cum.numpy()), bj, cj))


@pytest.mark.parametrize("steep", [1.0, 40.0])
@pytest.mark.parametrize("bc_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cells,c,ds,hd,nh", SHAPES)
def test_split_products_match_jax(cells, c, ds, hd, nh, bc_dtype, steep):
    """The kernel's operand rounding against JAX's kernel and the plain
    version, atol = rtol = 1e-4, finite under steep decay."""
    args = _inputs(c * 1000 + ds + hd + int(steep), cells, c, ds, hd, nh,
                   bc_dtype, steep)
    got = _ssd_split(*args)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), _jax(*args), **TOL)
    np.testing.assert_allclose(got.numpy(), ssd_chunk_ref(*args).numpy(),
                               **TOL)


def test_plain_tf32_misses_the_tolerance():
    """Without the split (tf32 operands, as a plain TF32 product would
    take them) the output leaves atol = rtol = 1e-4 at mamba2-130m's
    shapes with fp32 B/C and mild decay, where the split stays inside."""
    args = _inputs(7, 1, 64, 128, 64, 24, torch.float32, 1.0)
    want = ssd_chunk_ref(*args)
    split = _ssd_split(*args)
    torch.testing.assert_close(split, want, **TOL)
    err = (_ssd_split(*args, split=False) - want).abs()
    assert bool((err > 1e-4 + 1e-4 * want.abs()).any())
