"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

Each kernel package ships:
  ref.py — the plain PyTorch version (mirrors the JAX package's ``ref.py``);
  ops.py — the wrapper: on a CPU tensor it runs the plain version, on a
           CUDA tensor it launches the kernel from ``csrc/`` or raises.

``LAUNCHES`` counts kernel launches per wrapper (one per wrapper call that
launched its kernel, never for the plain version), so a run can show that a
path went through the kernels. The quantized kernels (``*_q``: weight-only
quantization's, and the paged decode attention over an int8 KV cache)
count under their own names, so a run also shows which path it took. The
spec head's two stages count as ``spec_head_gather`` (the column gather)
and ``spec_head`` (the dot over the gathered columns), and over a
quantized head as ``spec_head_gather_q`` and ``spec_head_q``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import torch

LAUNCHES: Dict[str, int] = {"exit_gate": 0, "argmax_verify": 0,
                            "topk_verify": 0, "decode_attention": 0,
                            "paged_decode_attention": 0,
                            "flash_attention": 0, "spec_head": 0,
                            "predictor_mlp": 0, "argmax_verify_q": 0,
                            "topk_verify_q": 0, "spec_head_q": 0,
                            "predictor_mlp_q": 0,
                            "paged_decode_attention_q": 0,
                            "ssd_chunk": 0, "exit_gate_q": 0,
                            "spec_head_gather": 0,
                            "spec_head_gather_q": 0}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def runs_plain(t: torch.Tensor) -> bool:
    """Whether a wrapper given ``t`` runs its plain version: True on the
    CPU, False on a CUDA card (the kernel launches or the wrapper raises);
    any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return False


def check_arg(name: str, t: torch.Tensor, device: torch.device,
              dtype=None, shape: Sequence[int] = None) -> None:
    """Validate one kernel argument before its pointer is passed."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check_kv_aligned(name: str, t: torch.Tensor) -> None:
    """The split-KV attention kernels copy K/V rows in 16-byte chunks:
    ``t`` must start on a 16-byte boundary."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned")


def check_qtensor(name: str, qt, device: torch.device, shape) -> None:
    """Validate a ``QTensor`` argument of logical ``shape`` (d_in, d_out):
    int8 codes (d_in, d_out) for bits 8 or packed (d_in/2, d_out) for bits
    4, fp32 scales (d_out,), both contiguous on ``device``."""
    d_in, d_out = shape
    if qt.bits not in (4, 8) or (qt.bits == 4 and d_in % 2):
        raise ValueError(f"{name}: cannot hold {qt.bits}-bit codes of "
                         f"{d_in} rows")
    rows = d_in // 2 if qt.bits == 4 else d_in
    check_arg(f"{name}.q", qt.q, device, torch.int8, (rows, d_out))
    check_arg(f"{name}.scale", qt.scale, device, torch.float32, (d_out,))


def dtype_code(t: torch.Tensor) -> int:
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise ValueError(f"kernels take float32 or bfloat16, got "
                         f"{t.dtype}") from None


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
