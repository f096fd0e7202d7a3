"""The devices a serving engine runs on.

Counterpart of ``src/repro/launch/mesh.py``'s ``make_serving_mesh``: a
``ServingMesh`` is the ordered list of the tp devices that tensor-parallel
paged serving (DESIGN.md §11) shards the KV heads over.  One controller (one
``RealEngine``, one scheduler) drives every shard; shard 0's device is the
lead, where everything but the paged attention and its pools runs.

A device may appear more than once: two shards named on one card each hold
their own heads and launch their own kernels there, as the reference's
virtual CPU devices (``--xla_force_host_platform_device_count``) do on one
host.  ``make_serving_mesh(tp)`` never does that by itself: it takes the
first tp CUDA devices or raises.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist (there is
    no silent fallback to the CPU).  A CUDA device without an index gets the
    calling thread's current one, so the engine's tensors stay on that card
    when another thread (the wall-clock runtime's engine thread, whose
    current device is its own) drives it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass(frozen=True)
class ServingMesh:
    """tp shards, one device each (shard 0 leads)."""

    devices: Tuple[torch.device, ...]

    @property
    def tp(self) -> int:
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        return self.devices[0]

    def distinct(self) -> Tuple[torch.device, ...]:
        """The mesh's devices without repeats, in shard order."""
        return tuple(dict.fromkeys(self.devices))


def make_serving_mesh(tp: int = 1, devices: Optional[Sequence] = None) -> ServingMesh:
    """A mesh of ``tp`` shards: the first ``tp`` CUDA devices (raises when
    fewer are visible, as the reference does), or the ``devices`` named,
    one per shard, which may repeat a device and may be the CPU."""
    if tp < 1:
        raise ValueError(f"tp must be at least 1, got {tp}")
    if devices is None:
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if visible < tp:
            raise ValueError(
                f"serving mesh needs {tp} CUDA devices, only {visible} visible "
                "(name the devices to place several shards on one)"
            )
        devices = [torch.device("cuda", i) for i in range(tp)]
    if len(devices) != tp:
        raise ValueError(f"serving mesh of tp={tp} given {len(devices)} devices")
    devs = tuple(resolve_device(d) for d in devices)
    if len({d.type for d in devs}) != 1:
        raise ValueError(f"serving mesh mixes device types: {devs}")
    return ServingMesh(devs)
