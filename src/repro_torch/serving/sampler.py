"""Token samplers (greedy / temperature / top-k) for the serving engine
(counterpart of ``repro/serving/sampler.py``).

SpecEE's verification is defined on greedy argmax; sampling applies to the
dense path's final-layer logits.

Sampled decode is keyed PER ROW: a row's key is a pure function of (session
seed, the row's position before the step, the token fed) (``row_keys``),
never of a generator's state. So a row's samples do not depend on its batch
or slot or the global step count, ``step(num_ticks=K)`` draws what K single
steps draw, and a row that replays its prefix draws the same tokens again.

``jax.random`` cannot be matched, so the samples are not JAX's; the
contract above is. The draw is Gumbel-max: each (row, vocab id) gets a
uniform from a counter-based hash (splitmix64's finaliser over int64
tensor ops, which wrap alike on the CPU and the card) of the row's key and
the id, turned into Gumbel noise in fp64 and added to the scaled fp32
logits; the sample is the argmax, ties to the lowest id. Integer hashing
is exact on both devices; the noise's two logarithms may differ by an ulp
of fp64 between the CPU's libm and CUDA's, so a card and the CPU draw the
same token unless two perturbed scores lie within about 1e-15 of each
other.
"""
from __future__ import annotations

from typing import Optional

import torch

_GOLDEN = 0x9E3779B97F4A7C15 - (1 << 64)      # 2^64 / phi, as int64
_M1 = 0xBF58476D1CE4E5B9 - (1 << 64)
_M2 = 0x94D049BB133111EB - (1 << 64)
_NEG = -1e30


def _shr(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 (torch's ``>>`` is arithmetic)."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def _mix(z: torch.Tensor) -> torch.Tensor:
    """splitmix64's finaliser on int64 tensors (wrapping products)."""
    z = (z ^ _shr(z, 30)) * _M1
    z = (z ^ _shr(z, 27)) * _M2
    return z ^ _shr(z, 31)


def row_keys(seed: int, pos: torch.Tensor,
             last_token: torch.Tensor) -> torch.Tensor:
    """(B,) int64 per-row keys = mix(mix(seed, pos), last_token).

    ``pos``/``last_token``: (B,) ints — the row's cache length BEFORE the
    step and the token being fed, i.e. row-local history only."""
    base = _mix(torch.full_like(pos, int(seed), dtype=torch.int64) * _GOLDEN
                + pos.long() + 1)
    return _mix(base + (last_token.long() + 1) * _GOLDEN)


def _gumbel(keys: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """fp64 Gumbel noise for each (key, id) pair (broadcast)."""
    u = _shr(_mix(keys + (ids + 1) * _M2), 11)               # 53 bits
    uf = (u.double() + 0.5) * (2.0 ** -53)                   # in (0, 1)
    return -torch.log(-torch.log(uf))


def _scale(logits: torch.Tensor, temperature: float,
           top_k: Optional[int]) -> torch.Tensor:
    """logits / T; under ``top_k`` every logit below the k-th largest is
    masked (all at or above it stay, as JAX's ``lax.top_k`` cutoff)."""
    logits = logits / temperature
    if top_k is not None:
        cutoff = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < cutoff,
                             torch.full_like(logits, _NEG), logits)
    return logits


def _draw(scaled: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    return torch.argmax(scaled.double() + noise, dim=-1).to(torch.int32)


def sample(logits: torch.Tensor, seed: int, temperature: float = 0.0,
           top_k: Optional[int] = None) -> torch.Tensor:
    """logits: (B, V) fp32, one key for the whole batch -> (B,) int32."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    B, V = logits.shape
    key = _mix(torch.tensor(int(seed), dtype=torch.int64,
                            device=logits.device) * _GOLDEN)
    ids = torch.arange(B * V, device=logits.device).reshape(B, V)
    return _draw(_scale(logits, temperature, top_k), _gumbel(key, ids))


def sample_rows(logits: torch.Tensor, keys: torch.Tensor,
                temperature: float = 0.0,
                top_k: Optional[int] = None) -> torch.Tensor:
    """logits: (B, V) fp32, per-row keys (from ``row_keys``) -> (B,)
    int32. ``temperature <= 0`` is the argmax, ties to the lowest id."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    ids = torch.arange(logits.shape[-1], device=logits.device)
    return _draw(_scale(logits, temperature, top_k),
                 _gumbel(keys.long()[:, None], ids[None, :]))
