"""Device meshes (counterpart of ``repro/launch/mesh.py``).

The port's ``Mesh`` is its own small class: a ``(data, model)`` grid of
``torch.device``s with JAX's ``.shape`` mapping and axis names. One process
drives every device of a mesh (a single controller, as a JAX mesh is), so
the tensor-parallel layers make each split and each reduction explicit
(``repro_torch.sharding``).

Devices may repeat: ``make_host_mesh(1, 4)`` on a machine with one card (or
on the CPU) places all four shards on that one device. That is the torch
counterpart of JAX's ``--xla_force_host_platform_device_count``: every
shard-local computation, partial merge and reduction runs, but no byte
crosses between cards. ``make_production_mesh`` (TPU pods) has no
counterpart.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch

AXES = ("data", "model")


class Mesh:
    """A ``(data, model)`` grid of devices. ``devices[d][m]`` is the device
    of data index ``d`` and model index ``m``; ``shape`` maps each axis
    name to its extent, as a JAX mesh's does."""

    def __init__(self, devices: Sequence[Sequence[torch.device]],
                 axis_names: Tuple[str, ...] = AXES):
        self.devices: List[List[torch.device]] = [
            [torch.device(d) for d in row] for row in devices]
        if not self.devices or len({len(r) for r in self.devices}) != 1:
            raise ValueError("a mesh needs a non-empty rectangular grid")
        self.axis_names = tuple(axis_names)
        self.shape = {axis_names[0]: len(self.devices),
                      axis_names[1]: len(self.devices[0])}

    @property
    def flat(self) -> List[torch.device]:
        """Every device, data-major (JAX's ``mesh.devices.flat``)."""
        return [d for row in self.devices for d in row]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.flat]})"


def _pool(device: Union[None, str, torch.device]) -> List[torch.device]:
    """The devices slots cycle over: ``device`` alone when named, else
    every card. Without a card and without a named device it raises: a
    mesh never falls back to the CPU unasked (pass ``device="cpu"``)."""
    if device is not None:
        return [torch.device(device)]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found for the mesh: pass device= (e.g. "
            "device=\"cpu\", the launcher's --device cpu) to place every "
            "shard on a named device")
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def slots(n: int, device: Union[None, str, torch.device] = None
          ) -> List[torch.device]:
    """``n`` device slots: slot ``i`` on ``cuda:(i mod device_count)``, or
    every slot on ``device`` when given (``_pool`` raises without a card
    and without ``device``)."""
    pool = _pool(device)
    return [pool[i % len(pool)] for i in range(n)]


def make_mesh(devices: Sequence[torch.device], data: int = 1,
              model: int = 1) -> Mesh:
    """A ``(data, model)`` mesh over ``devices`` in order (data-major)."""
    devices = list(devices)
    if len(devices) != data * model:
        raise ValueError(f"mesh ({data},{model}) needs {data * model} "
                         f"devices, got {len(devices)}")
    return Mesh([devices[d * model:(d + 1) * model] for d in range(data)])


def make_host_mesh(data: int = 1, model: int = 1,
                   device: Union[None, str, torch.device] = None) -> Mesh:
    """A small mesh over whatever devices exist, repeating them when there
    are fewer than ``data * model`` (tests, one-card runs)."""
    return make_mesh(slots(data * model, device), data, model)


def make_replica_meshes(replicas: int, model: int = 1,
                        device: Union[None, str, torch.device] = None
                        ) -> List[Optional[Mesh]]:
    """Per-replica ``(1, model)`` meshes for a ``ReplicaPool``: replica
    ``i`` owns slots ``[i·model, (i+1)·model)`` — tensor parallelism within
    a replica, no collective across them. ``model=1`` gives ``[None] *
    replicas`` when one device holds every slot (the replicas time-share
    it, as JAX's one-device degeneration)."""
    devs = slots(replicas * model, device)
    if model == 1 and len(set(devs)) == 1:
        return [None] * replicas
    return [make_mesh(devs[i * model:(i + 1) * model], 1, model)
            for i in range(replicas)]
