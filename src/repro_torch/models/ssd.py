"""Mamba2 — SSD (state-space duality) block (counterpart of
``repro/models/ssd.py``). [arXiv:2405.21060]

The sequence path is the chunked SSD algorithm: an intra-chunk quadratic
term and an inter-chunk linear state recurrence (a Python loop over the
chunks where JAX scans); the decode path is the O(1) recurrent update. The
intra-chunk ("diagonal block") term goes through the CUDA kernel
``kernels/ssd_chunk`` when the caller asks for it (``ModelFlags.
ssd_kernel``), and through its plain version otherwise; everything else is
plain PyTorch.

Layout conventions (single B/C group, as in mamba2-130m):
  x  : (B, S, nh, hd)      — inner activations split into SSM heads
  dt : (B, S, nh)          — per-head timestep (softplus(dt + bias))
  A  : (nh,)               — negative decay rate (−exp(A_log))
  Bm : (B, S, ds)          — input matrix  (shared across heads)
  Cm : (B, S, ds)          — output matrix (shared across heads)
  state: (B, nh, hd, ds)

Tensor parallelism (a ``(1, P)`` mesh): each shard holds whole heads
(``sharding/serving.py``: its z, x and dt columns of ``in_proj``, B and C
whole, its conv channels, A, D, dt_bias and norm scale, and its
``out_proj`` rows), so the block functions, given ``Shards`` params, run
the projection, conv, SSD scan (the ``ssd_chunk`` kernel on the shard's
``nh / P`` heads) and D term per shard. The gated norm's mean of squares
runs over the whole ``di``: each shard's sum of squares goes through
``all_reduce_sum`` (a (B, S, 1) tensor) before the ``rsqrt``, then
``out_proj``'s row-parallel partials are reduced. The state and the conv
window come back as ``Shards`` of each shard's heads and channels
(``state_segs``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig, SSMConfig
from repro_torch.kernels.ssd_chunk import ops as ssd_ops
from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref
from repro_torch.models import common
from repro_torch.models.common import Params
from repro_torch.runtime.collectives import (all_reduce_sum,
                                             count_backward_reduce)
from repro_torch.sharding.ctx import from_parts, local, parts


def dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    s = cfg.ssm or SSMConfig()
    di = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    return di, nh, s.head_dim, s.d_state


def _segs(cfg: ModelConfig):
    """(a head, a head's hd channels, B and C whole) as segments."""
    _, nh, hd, ds = dims(cfg)
    return (nh, 1, True), (nh, hd, True), (1, 2 * ds, False)


def state_segs(cfg: ModelConfig):
    """Shard layouts (``sharding.ctx`` segments) of an SSD cache entry's
    leaves, as (dim from the end, segments): the state by heads, the conv
    window's channels by the heads' x channels with B and C whole."""
    heads, cols, bc = _segs(cfg)
    return {"state": (-3, (heads,)), "conv": (-1, (cols, bc))}


def param_segs(cfg: ModelConfig):
    """Shard layouts of the block's weights, by leaf path in the block, as
    (dim from the end, segments): whole heads on each shard — the z, x and
    dt columns of its heads in ``in_proj`` with B and C whole, the conv
    over the same channels, its heads' A, D, dt_bias and norm scale and
    its heads' ``out_proj`` rows (``sharding/serving.py`` says why this
    differs from JAX's spec)."""
    heads, cols, bc = _segs(cfg)
    return {"in_proj/w": (-1, (cols, cols, bc, heads)),
            "conv_w": (-1, (cols, bc)), "conv_b": (-1, (cols, bc)),
            "A_log": (-1, (heads,)), "D": (-1, (heads,)),
            "dt_bias": (-1, (heads,)), "norm/scale": (-1, (cols,)),
            "out_proj/w": (-2, (cols,))}


def _local_dims(cfg: ModelConfig, p: Params) -> Tuple[int, int, int, int]:
    """(di, nh, hd, ds) of the heads ``p`` holds (a shard's or all)."""
    _, _, hd, ds = dims(cfg)
    nh = p["A_log"].shape[-1]
    return nh * hd, nh, hd, ds


def init_ssd(cfg: ModelConfig, gen: torch.Generator, dtype,
             device) -> Params:
    """Seeded SSD block weights: the JAX init's shapes and scales (other
    numbers), every floating leaf in ``dtype`` as ``common.cast_tree``
    leaves a JAX pytree."""
    s = cfg.ssm or SSMConfig()
    d = cfg.d_model
    di, nh, hd, ds = dims(cfg)
    conv_ch = di + 2 * ds
    # in_proj emits [z (di), x (di), B (ds), C (ds), dt (nh)]
    out_dim = 2 * di + 2 * ds + nh
    # dt ~ logUniform[1e-3, 1e-1]; dt_bias = softplus^-1(dt)
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = torch.rand(nh, generator=gen, device=device) * (hi - lo) + lo
    dt = torch.exp(u).clamp(min=1e-4)
    return {
        "in_proj": {"w": common.normal_init(gen, (d, out_dim),
                                            1.0 / math.sqrt(d), dtype,
                                            device)},
        "conv_w": common.normal_init(gen, (s.conv_kernel, conv_ch),
                                     1.0 / math.sqrt(s.conv_kernel), dtype,
                                     device),
        "conv_b": torch.zeros(conv_ch, dtype=dtype, device=device),
        # A in [-1, -16]: A_log = log(linspace(1, 16))
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, device=device)
                           ).to(dtype),
        "D": torch.ones(nh, dtype=dtype, device=device),
        "dt_bias": torch.log(torch.expm1(dt)).to(dtype),
        "norm": {"scale": torch.ones(di, dtype=dtype, device=device)},
        "out_proj": {"w": common.normal_init(
            gen, (di, d), 1.0 / math.sqrt(di) / math.sqrt(2 * cfg.num_layers),
            dtype, device)},
    }


def _split_proj(cfg: ModelConfig, proj: torch.Tensor, p: Params):
    """(z, xBC, dt) of an ``in_proj`` output of the block params ``p``
    (a shard's heads, or all)."""
    di, nh, hd, ds = _local_dims(cfg, p)
    z, xBC, dt = torch.split(proj, [di, di + 2 * ds, nh], dim=-1)
    return z, xBC, dt  # (…, di), (…, di+2ds), (…, nh)


def _gate_in(x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """The gated norm's input x * silu(z), fp32."""
    return (x * F.silu(z.float()).to(x.dtype)).float()


def _gated_rmsnorm_parts(ps, cores, dst: torch.device, di: int) -> list:
    """Mamba2 out-norm RMSNorm(x * silu(z)) over the (x, z) ``cores`` of
    the shards holding the block params ``ps`` (one part unsharded): the
    mean of squares runs over the whole ``di``, from the parts' sums of
    squares reduced onto ``dst``."""
    gs = [_gate_in(x, z) for x, z in cores]
    ms = all_reduce_sum([(g * g).sum(dim=-1, keepdim=True) for g in gs],
                        dst) / di
    return [(g * torch.rsqrt(ms.to(g.device) + 1e-6)
             * pp["norm"]["scale"].float()).to(x.dtype)
            for pp, g, (x, _) in zip(ps, gs, cores)]


def _gated_rmsnorm(p: Params, x: torch.Tensor, z: torch.Tensor
                   ) -> torch.Tensor:
    """Mamba2 out-norm: RMSNorm(x * silu(z)), unsharded."""
    return _gated_rmsnorm_parts([p], [(x, z)], x.device, x.shape[-1])[0]


def _out(cfg: ModelConfig, p: Params, cores, dst: torch.device
         ) -> torch.Tensor:
    """The gated norm and ``out_proj`` over the shards' (y, z) ``cores``,
    ``out_proj``'s row-parallel partials reduced onto ``dst``."""
    ps = [local(p, s) for s in range(len(cores))]
    ys = _gated_rmsnorm_parts(ps, cores, dst, dims(cfg)[0])
    return all_reduce_sum([common.apply_linear(pp["out_proj"], y)
                           for pp, y in zip(ps, ys)], dst)


# ---------------------------------------------------------------------------
# chunked SSD over a sequence
# ---------------------------------------------------------------------------
def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                initial_state: Optional[torch.Tensor] = None,
                use_kernel: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan. Returns (y (B,S,nh,hd), final_state (B,nh,hd,ds)).

    Discretization: a_t = exp(A * dt_t); input contribution dt_t * x_t ⊗ B_t.
    y_t = C_t · h_t (D is added by the caller). ``use_kernel``: the
    intra-chunk term through the ``ssd_chunk`` wrapper (the CUDA kernel on
    a CUDA tensor), on the (B·nc, chunk, …) cells its shapes expect;
    otherwise through its plain version on the same cells.
    """
    B, S, nh, hd = x.shape
    ds = Bm.shape[-1]
    S_orig = S
    if S % chunk != 0:
        # pad with dt=0 tokens: a=exp(A*0)=1 and input dt*x=0, so padding is
        # a no-op on the state; padded outputs are sliced off below
        pad = chunk - S % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        S = S + pad
    nc = S // chunk

    xc = x.reshape(B, nc, chunk, nh, hd)
    dtc = dt.reshape(B, nc, chunk, nh)
    Bc = Bm.reshape(B, nc, chunk, ds)
    Cc = Cm.reshape(B, nc, chunk, ds)

    # log decay within chunk: cum[t] = cumsum of A*dt up to t (inclusive)
    cum = torch.cumsum(A[None, None, None, :] * dtc, dim=2)  # (B,nc,Q,nh)
    xdt = xc.float() * dtc[..., None]                         # (B,nc,Q,nh,hd)
    # intra-chunk ("diagonal block") term: decay-masked attention
    diag = ssd_ops.ssd_chunk if use_kernel else ssd_chunk_ref
    y_diag = diag(xdt.reshape(B * nc, chunk, nh, hd),
                  cum.reshape(B * nc, chunk, nh),
                  Bc.reshape(B * nc, chunk, ds),
                  Cc.reshape(B * nc, chunk, ds)
                  ).reshape(B, nc, chunk, nh, hd)

    # chunk-level states: contribution of chunk c to the state after it,
    # decayed from position s to the end of the chunk
    dec_to_end = torch.exp(cum[:, :, -1:, :] - cum)           # (B,nc,Q,nh)
    states = torch.einsum("bcsd,bcsh,bcshp->bchpd", Bc.float(), dec_to_end,
                          xdt)                                # (B,nc,nh,hd,ds)
    chunk_decay = torch.exp(cum[:, :, -1, :])                 # (B,nc,nh)

    # inter-chunk recurrence over the chunks
    h = (torch.zeros(B, nh, hd, ds, dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    h_before = []
    for ci in range(nc):
        h_before.append(h)                                    # state BEFORE
        h = h * chunk_decay[:, ci, :, None, None] + states[:, ci]
    h_before = torch.stack(h_before, dim=1)                   # (B,nc,nh,hd,ds)

    # inter-chunk ("off-diagonal") output: y += C_t · (decay(0..t) h_before)
    dec_from_start = torch.exp(cum)                           # (B,nc,Q,nh)
    y_off = torch.einsum("bcqd,bchpd,bcqh->bcqhp", Cc.float(), h_before,
                         dec_from_start)

    y = (y_diag + y_off).reshape(B, S, nh, hd)[:, :S_orig]
    return y.to(x.dtype), h


def ssd_recurrent_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       Bm: torch.Tensor, Cm: torch.Tensor,
                       state: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token update. x: (B,nh,hd); dt: (B,nh); Bm,Cm: (B,ds);
    state: (B,nh,hd,ds) -> (y (B,nh,hd), new_state)."""
    a = torch.exp(A[None, :] * dt)                            # (B,nh)
    xdt = x.float() * dt[..., None]                           # (B,nh,hd)
    new_state = (state.float() * a[:, :, None, None]
                 + xdt[..., None] * Bm[:, None, None, :].float())
    y = torch.einsum("bhpd,bd->bhp", new_state, Cm.float())
    return y.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# full block (norm -> in_proj -> conv -> SSD -> gated norm -> out_proj)
# ---------------------------------------------------------------------------
def conv1d_seq(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor
               ) -> torch.Tensor:
    """Depthwise causal conv over sequence. x: (B, S, C); w: (K, C)."""
    K, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + S, :] * w[i][None, None, :] for i in range(K))
    return out + b[None, None, :]


def conv1d_step(w: torch.Tensor, b: torch.Tensor, x_t: torch.Tensor,
                conv_state: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_t: (B, C); conv_state: (B, K-1, C) holding the previous K-1
    inputs."""
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)  # (B,K,C)
    out = torch.einsum("bkc,kc->bc", window, w) + b[None, :]
    return out, window[:, 1:, :]


def _ssm_inputs(cfg: ModelConfig, p: Params, xBC: torch.Tensor,
                dt: torch.Tensor):
    """(xin, Bm, Cm, dt, A) from the convolved xBC and the raw dt."""
    di, _, _, ds = _local_dims(cfg, p)
    xin, Bm, Cm = torch.split(xBC, [di, ds, ds], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])
    return xin, Bm, Cm, dt, -torch.exp(p["A_log"])


def _seq_core(cfg: ModelConfig, p: Params, x: torch.Tensor,
              initial_state: Optional[torch.Tensor], use_kernel: bool):
    """in_proj, conv, SSD scan and D term on the heads ``p`` holds:
    (y (B,S,di) before the gated norm, z, final state, conv tail)."""
    s = cfg.ssm or SSMConfig()
    di, nh, hd, ds = _local_dims(cfg, p)
    proj = common.apply_linear(p["in_proj"], x)              # (B,S,2di+2ds+nh)
    z, xBC, dt = _split_proj(cfg, proj, p)
    xBC = F.silu(conv1d_seq(p["conv_w"].to(x.dtype),
                            p["conv_b"].to(x.dtype), xBC))
    xin, Bm, Cm, dt, A = _ssm_inputs(cfg, p, xBC, dt)
    xh = xin.reshape(*xin.shape[:-1], nh, hd)
    y, h_final = ssd_chunked(xh, dt, A, Bm, Cm, s.chunk_size, initial_state,
                             use_kernel=use_kernel)
    y = y + xh * p["D"].to(x.dtype)[None, None, :, None]
    K = s.conv_kernel
    proj_tail = (proj[:, -(K - 1):, di:di + di + 2 * ds]
                 if x.shape[1] >= K - 1 else None)
    return y.reshape(*x.shape[:-1], di), z, h_final, proj_tail


def ssd_block_seq(cfg: ModelConfig, p: Params, x: torch.Tensor,
                  initial_state: Optional[torch.Tensor] = None,
                  use_kernel: bool = False):
    """Full-sequence SSD block (prefill). x: (B,S,D), pre-normed outside.
    Returns (out (B,S,D), final state (B,nh,hd,ds) fp32, the last K-1
    positions of the conv input (B,K-1,di+2ds) — None for a sequence
    shorter than K-1, as in the JAX package). Sharded params give the
    state and the conv tail as ``Shards`` (an ``initial_state`` too)."""
    segs = state_segs(cfg)
    if len(parts(p["A_log"])) > 1:
        count_backward_reduce(x)
    cores = [_seq_core(cfg, local(p, s), x.to(a.device),
                       local(initial_state, s), use_kernel)
             for s, a in enumerate(parts(p["A_log"]))]
    tails = [c[3] for c in cores]
    return (_out(cfg, p, [c[:2] for c in cores], x.device),
            from_parts([c[2] for c in cores], *segs["state"]),
            None if tails[0] is None else from_parts(tails, *segs["conv"]))


def _step_core(cfg: ModelConfig, p: Params, x_t: torch.Tensor,
               state: torch.Tensor, conv_state: torch.Tensor):
    """One token's in_proj, conv, recurrent update and D term on the
    heads ``p`` holds: (y (B,di), z, new state, new conv window)."""
    di, nh, hd, ds = _local_dims(cfg, p)
    proj = common.apply_linear(p["in_proj"], x_t)            # (B, 2di+2ds+nh)
    z, xBC, dt = _split_proj(cfg, proj, p)
    xBC, new_conv = conv1d_step(p["conv_w"].to(x_t.dtype),
                                p["conv_b"].to(x_t.dtype), xBC, conv_state)
    xin, Bm, Cm, dt, A = _ssm_inputs(cfg, p, F.silu(xBC), dt)
    xh = xin.reshape(-1, nh, hd)
    y, new_state = ssd_recurrent_step(xh, dt, A, Bm, Cm, state)
    y = y + xh * p["D"].to(x_t.dtype)[None, :, None]
    return y.reshape(-1, di), z, new_state, new_conv


def ssd_block_step(cfg: ModelConfig, p: Params, x_t: torch.Tensor,
                   state: torch.Tensor, conv_state: torch.Tensor):
    """Single-token SSD block. x_t: (B, D) pre-normed; returns (out (B,D),
    new_state, new_conv_state) — ``Shards`` of each shard's under sharded
    params (``state`` and ``conv_state`` then ``Shards`` too)."""
    segs = state_segs(cfg)
    cores = [_step_core(cfg, local(p, s), x_t.to(a.device),
                        local(state, s), local(conv_state, s))
             for s, a in enumerate(parts(p["A_log"]))]
    return (_out(cfg, p, [c[:2] for c in cores], x_t.device),
            from_parts([c[2] for c in cores], *segs["state"]),
            from_parts([c[3] for c in cores], *segs["conv"]))
