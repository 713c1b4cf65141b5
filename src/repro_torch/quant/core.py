"""Quantized-weight containers and the params → parallel-pytree converter
(counterpart of ``repro/quant/core.py``).

Layout contract (byte-identical to the JAX package, so codes quantized
there bridge over unchanged, and shared with the quantized CUDA kernels):

* Scales are **per output channel**: a weight ``W (..., d_in, d_out)``
  stores ``scale (..., d_out)`` fp32 and integer codes ``q`` with
  ``W ≈ q * scale[..., None, :]``. The scale is constant down the
  contracted dimension, so a kernel multiplies a column's dot product by
  its scale once, after the dot.
* int8: symmetric, codes in [-127, 127], ``scale = (amax + 1e-8) / 127``.
* int4: symmetric, codes in [-7, 7], ``scale = (amax + 1e-8) / 7``, two
  codes per byte in **plane packing**: the low nibble holds row ``i`` of
  the first half ``[0, d_in/2)`` and the high nibble row ``i + d_in/2``.
  ``d_in`` must be even (odd tensors fall back to int8).

Rounding is bit-equal to the JAX package: ``torch.round`` and
``jnp.round`` both round half to even, and the scale is formed in fp32 in
the same order. Stacked leaves ``(reps, d_in, d_out)`` are quantized and
dequantized one leading index at a time: the ops are per column along
``d_in``, so the codes are the same, and no fp32 temporary of a whole
stacked projection (5.8 GB for llama2-7b's stacked ``wg``) is made.

Quantization never mutates the source pytree: ``quantize_params`` builds a
parallel structure of ``QTensor`` leaves.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

INT4_MAX = 7
INT8_MAX = 127


# ---------------------------------------------------------------------------
# int4 plane packing
# ---------------------------------------------------------------------------
def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """Pack int codes in [-7, 7] along dim -2: (..., d, n) -> (..., d/2, n)
    int8 bytes ``(lo & 0xF) | (hi << 4)``, lo = rows [0, d/2), hi = rows
    [d/2, d)."""
    d = codes.shape[-2]
    if d % 2:
        raise ValueError(f"int4 plane packing needs an even row count, got {d}")
    c = codes.to(torch.int32).clamp(-INT4_MAX, INT4_MAX)
    lo, hi = c.split(d // 2, dim=-2)
    return ((lo & 0xF) | (hi << 4)).to(torch.int8)


def unpack_int4(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of ``pack_int4``: (..., d/2, n) -> (lo, hi) int32 planes,
    sign-extended; the full matrix is their dim -2 concatenation."""
    p = packed.to(torch.int32)
    return ((p & 0xF) ^ 8) - 8, p >> 4


# ---------------------------------------------------------------------------
# QTensor
# ---------------------------------------------------------------------------
class QTensor:
    """A quantized weight: integer codes + per-output-channel fp32 scales.

    ``q``: int8 codes, (..., d_in, d_out) for bits=8 or the packed
    (..., d_in/2, d_out) plane layout for bits=4. ``scale``: fp32
    (..., d_out). ``models.common.tree_map`` maps a function over both,
    so a stacked (E, ...) bank slices like any other leaf.
    """

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, bits: int):
        self.q = q
        self.scale = scale
        self.bits = int(bits)

    @property
    def shape(self) -> Tuple[int, ...]:
        mult = 2 if self.bits == 4 else 1
        s = tuple(self.q.shape)
        return s[:-2] + (s[-2] * mult, s[-1])

    def nbytes(self) -> int:
        """Weight-stream footprint (codes + scales) in bytes."""
        return self.q.numel() + 4 * self.scale.numel()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"QTensor(shape={self.shape}, bits={self.bits}, "
                f"packed={tuple(self.q.shape)})")

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return dequantize(self, dtype)


def _quantize_2d(wf: torch.Tensor, qmax: int) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    amax = wf.abs().amax(dim=-2) + 1e-8                  # (d_out,) fp32
    scale = amax / qmax
    codes = torch.round(wf / scale[None, :]).clamp(-qmax, qmax)
    return codes, scale


def quantize_tensor(w: torch.Tensor, bits: int) -> QTensor:
    """Symmetric per-output-column quantization of ``w (..., d_in, d_out)``;
    leading dims one index at a time."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if bits == 4 and w.shape[-2] % 2:
        bits = 8                      # plane packing needs even rows
    qmax = INT4_MAX if bits == 4 else INT8_MAX
    lead, (d_in, d_out) = tuple(w.shape[:-2]), tuple(w.shape[-2:])
    rows = d_in // 2 if bits == 4 else d_in
    q = torch.empty(lead + (rows, d_out), dtype=torch.int8, device=w.device)
    scale = torch.empty(lead + (d_out,), dtype=torch.float32,
                        device=w.device)
    flat_w = w.reshape((-1, d_in, d_out))
    flat_q, flat_s = q.view((-1, rows, d_out)), scale.view((-1, d_out))
    for i in range(flat_w.shape[0]):
        codes, s = _quantize_2d(flat_w[i].float(), qmax)
        flat_s[i] = s
        flat_q[i] = pack_int4(codes) if bits == 4 else codes.to(torch.int8)
    return QTensor(q, scale, bits)


def _codes(q: torch.Tensor, bits: int, dim: int = -2) -> torch.Tensor:
    """The int32 codes of packed ``q``, the int4 planes concatenated along
    the row dim ``dim``."""
    if bits == 4:
        return torch.cat(unpack_int4(q), dim=dim)
    return q.to(torch.int32)


def dequantize(qt: QTensor, dtype=torch.float32) -> torch.Tensor:
    """Materialize the fp weight: codes * per-column scale (fp32, then cast
    to ``dtype``); leading dims one index at a time."""
    d_in, d_out = qt.shape[-2:]
    out = torch.empty(qt.shape, dtype=dtype, device=qt.q.device)
    flat_q = qt.q.reshape((-1,) + tuple(qt.q.shape[-2:]))
    flat_s = qt.scale.reshape(-1, d_out)
    flat_o = out.view(-1, d_in, d_out)
    for i in range(flat_q.shape[0]):
        flat_o[i] = (_codes(flat_q[i], qt.bits).float()
                     * flat_s[i][None, :]).to(dtype)
    return out


def take_columns(qt: QTensor, ids: torch.Tensor) -> torch.Tensor:
    """Gather-then-dequantize columns of a (d_in, d_out) QTensor:
    (d_in, *ids.shape) fp32. Per-column scales make this equal to
    gathering the dequantized weight."""
    idx = ids.long()
    qcols = qt.q[:, idx]                                  # (rows, *ids)
    scols = qt.scale[idx]                                 # (*ids,)
    return _codes(qcols, qt.bits, dim=0).float() * scols[None]


def matmul_codes(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """``x (R, d_in) @ dequantize(qt)`` in the quantized kernels' order:
    fp32 products with the integer codes, int4 as the two half-planes'
    products summed, then the per-column scale. Returns (R, d_out) fp32."""
    xf = x.float()
    if qt.bits == 4:
        lo, hi = unpack_int4(qt.q)
        half = qt.q.shape[-2]
        part = xf[:, :half] @ lo.float() + xf[:, half:] @ hi.float()
    else:
        part = xf @ qt.q.float()
    return part * qt.scale[None, :]


# ---------------------------------------------------------------------------
# QuantSpec + params conversion
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """What to compress and how: ``bits`` for every selected tensor;
    ``lm_head`` — the verify/spec-head LM head; ``predictors`` — the stacked
    exit-predictor bank; ``proj`` — the per-layer attention/MLP projection
    matrices. Norms, biases and embeddings are never quantized."""

    bits: int = 8
    lm_head: bool = True
    predictors: bool = True
    proj: bool = True

    def __post_init__(self):
        if self.bits not in (4, 8):
            raise ValueError(f"QuantSpec.bits must be 4 or 8, got {self.bits}")

    @classmethod
    def resolve(cls, spec) -> Optional["QuantSpec"]:
        """Accept a QuantSpec, 'int8'/'int4', 8/4, or None (-> no quant)."""
        if spec is None or isinstance(spec, cls):
            return spec
        if isinstance(spec, str):
            name = spec.lower().lstrip("int")
            if name in ("8", "4"):
                return cls(bits=int(name))
            raise ValueError(f"unknown quant spec {spec!r} "
                             "(want 'int8' or 'int4')")
        if spec in (4, 8):
            return cls(bits=int(spec))
        raise ValueError(f"cannot resolve quant spec {spec!r}")


def _quantize_proj_subtree(p: Dict[str, Any], bits: int,
                           device=None) -> Dict[str, Any]:
    """Parallel subtree of QTensors for the attn/mlp linear ``w`` leaves of
    one segment (only the quantized leaves; ``merge_dequant`` grafts them
    back). Stacked leaves keep their leading (reps,) dim. A MoE block's
    router and expert banks (``moe``) and an RG-LRU block's recurrence
    (``rec``) are never quantized, as in the JAX package: a MoE block's
    subtree holds its attention alone."""
    out: Dict[str, Any] = {}
    for unit_key, unit in p.items():
        got: Dict[str, Any] = {}
        for sub in ("attn", "mlp"):
            if sub not in unit:
                continue
            qsub = {}
            for name, lin in unit[sub].items():
                if isinstance(lin, dict) and "w" in lin and lin["w"].ndim >= 2:
                    qsub[name] = {"w": quantize_tensor(
                        _on(lin["w"], device), bits)}
            if qsub:
                got[sub] = qsub
        if got:
            out[unit_key] = got
    return out


def _on(x: torch.Tensor, device) -> torch.Tensor:
    return x if device is None else x.to(device)


def quantize_params(params, sw, spec, device=None
                    ) -> Optional[Dict[str, Any]]:
    """The parallel quantized pytree of a params + SpecEE bundle:
    ``{"lm_head": QTensor|None, "predictors": bank|None, "proj":
    [per-segment subtree]|None}``, or None when ``spec`` is None.
    ``params`` and ``sw`` are read, never written. ``device``: quantize
    there, each tensor copied to it one at a time (a mesh engine's lead,
    from its host copy), else where each tensor is."""
    from repro_torch.models.common import lm_head_weight
    spec = QuantSpec.resolve(spec)
    if spec is None:
        return None
    qw: Dict[str, Any] = {"lm_head": None, "predictors": None, "proj": None}
    if spec.lm_head:
        qw["lm_head"] = quantize_tensor(_on(lm_head_weight(params), device),
                                        spec.bits)
    if spec.predictors and sw is not None and sw.predictors is not None:
        qw["predictors"] = {"layers": [
            {"w": quantize_tensor(_on(layer["w"], device), spec.bits),
             "b": _on(layer["b"], device)}
            for layer in sw.predictors["layers"]]}
    if spec.proj:
        qw["proj"] = [_quantize_proj_subtree(seg, spec.bits, device)
                      for seg in params["segments"]]
    return qw


def merge_dequant(params, qproj):
    """Params view with the projection leaves replaced by their dequantized
    copies (in each original leaf's dtype); other leaves are shared."""
    if qproj is None:
        return params

    def graft(dst, src):
        if isinstance(src, QTensor):
            return src.dequantize(dst.dtype)
        out = dict(dst)
        for k, v in src.items():
            out[k] = graft(dst[k], v)
        return out

    segs = [graft(seg, qseg) if qseg else seg
            for seg, qseg in zip(params["segments"], qproj)]
    return dict(params, segments=segs)


def dequantized_reference(params, sw, qw):
    """(params', sw') with every quantized tensor replaced by its
    dequantized copy (the LM head and the predictor bank in fp32, as in the
    JAX package): a plain engine on (params', sw') emits exactly what a
    quantized engine on (params, sw, qw) emits."""
    p2 = merge_dequant(params, qw.get("proj"))
    if qw.get("lm_head") is not None:
        p2 = dict(p2, lm_head={"w": qw["lm_head"].dequantize()})
    sw2 = sw
    if qw.get("predictors") is not None and sw is not None:
        layers = [{"w": l["w"].dequantize(), "b": l["b"]}
                  for l in qw["predictors"]["layers"]]
        sw2 = sw._replace(predictors={"layers": layers})
    return p2, sw2
