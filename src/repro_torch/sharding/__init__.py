"""Tensor-parallel serving and training over a device mesh (counterpart of
``repro/sharding``): ``ctx`` (the shard context and sharded leaves),
``policies`` (partition specs by Megatron role), ``serving`` (the decode
state's specs and the placement of weights and state on a mesh),
``training`` (params, optimizer state and batch on a ``(DATA, MODEL)``
mesh at ``fsdp_tp``, and each data row's view). JAX's ``compat``
(JAX-version shims) has no counterpart.

The package exports ``ctx``'s names (the model layers import it); import
``policies``, ``serving`` and ``training`` as modules.
"""
from repro_torch.sharding.ctx import ShardCtx, Shards, gather, local

__all__ = ["ShardCtx", "Shards", "gather", "local"]
