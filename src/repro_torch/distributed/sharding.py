"""Tensor-parallel layout of the paged serving path (DESIGN.md §11).

Counterpart of the serving part of ``src/repro/distributed/sharding.py``
(``mesh_axis_size``, ``pool_pspec``, ``pool_shardings``).  The KV pools
and the attention over them shard over KV heads: shard s of a
``launch.mesh.ServingMesh`` of tp shards owns heads
``[s * Hkv / tp, (s + 1) * Hkv / tp)`` of every physical block, in a tensor
of its own on its own device.  Head counts that do not divide tp replicate
instead (never the head dim: D is the contraction of the attention dots,
and a sharded contraction would change the sums' order).  Params, block
tables, token ids and lengths replicate; everything on the host stays
mesh-oblivious.

``HeadSharded`` is the port's counterpart of a jax.Array laid out by
``pool_shardings``: one part per shard, split along the head axis (the
second to last) or replicated, one copy per distinct device.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

HEAD_AXIS = -2  # (..., heads, head_dim) for pools, q, k, v and outputs


def mesh_axis_size(mesh) -> int:
    """tp of ``mesh`` (a ``ServingMesh``), 1 without one."""
    return 1 if mesh is None else mesh.tp


def shards_heads(heads: int, mesh) -> bool:
    """The reference's rule: shard when ``tp > 1`` divides the heads."""
    tp = mesh_axis_size(mesh)
    return tp > 1 and heads % tp == 0


def pool_pspec(shape: Sequence[int], mesh) -> Tuple:
    """The layout of a pool leaf (num_periods, num_blocks, block_size, Hkv,
    D) as the reference's ``PartitionSpec``: ``"model"`` on the KV-head
    axis when it shards, else all ``None`` (replicated)."""
    spec: list = [None] * len(shape)
    if len(shape) == 5 and shards_heads(shape[3], mesh):
        spec[3] = "model"
    return tuple(spec)


def head_ranges(heads: int, mesh) -> List[Tuple[int, int]]:
    """The ``[lo, hi)`` heads each shard holds: contiguous equal runs when
    they shard, every head on every shard when they replicate."""
    tp = mesh_axis_size(mesh)
    if not shards_heads(heads, mesh):
        return [(0, heads)] * tp
    n = heads // tp
    return [(s * n, (s + 1) * n) for s in range(tp)]


def split_heads(x: torch.Tensor, mesh, axis: int = HEAD_AXIS) -> List[torch.Tensor]:
    """Each shard's part of ``x`` on its device (the counterpart of the
    reference's ``layers.shard_paged_heads``): a contiguous copy of its head
    range when the heads shard (the kernels take contiguous tensors only),
    else ``x`` itself, moved where the shard lives."""
    parts = []
    for dev, (lo, hi) in zip(mesh.devices, head_ranges(x.shape[axis], mesh)):
        part = x if hi - lo == x.shape[axis] else x.narrow(axis, lo, hi - lo).contiguous()
        parts.append(part.to(dev))
    return parts


def gather_heads(parts: Sequence[torch.Tensor], device, axis: int = HEAD_AXIS) -> torch.Tensor:
    """The shards' outputs concatenated along the head axis on ``device``
    (the counterpart of ``layers.replicate_on_mesh``: pure data movement,
    before any contraction over heads)."""
    return torch.cat([p.to(device) for p in parts], dim=axis)


def over_kv_shards(fn, q: torch.Tensor, k_pool: "HeadSharded", v_pool: "HeadSharded",
                   replicated: Sequence[torch.Tensor], mesh, head_axis: int, **kw):
    """Attention over a mesh's KV-head shards: ``fn(q_s, k_s, v_s,
    *replicated, **kw)`` on each shard's device, with its contiguous run of
    q's heads (the query-head axis ``head_axis`` is grouped KV-head-major,
    so the run holds the G queries of each local KV head), its parts of the
    pools and its own copies of ``replicated``; the outputs gathered along
    heads onto q's device.  Where the head counts do not divide tp the
    pools are replicated, and one unsharded call runs on shard 0's copy, as
    the reference's sharded kernels fall back.  Returns ``(out, shards)``:
    the shards that ran ``fn``, 0 for the fallback."""
    if not shards_heads(k_pool.heads, mesh) or q.shape[head_axis] % mesh.tp:
        return fn(q, k_pool.parts[0], v_pool.parts[0], *replicated, **kw), 0
    qs = split_heads(q, mesh, head_axis)
    outs = [fn(qs[s], k_pool.parts[s], v_pool.parts[s],
               *(t.to(dev) for t in replicated), **kw)
            for s, dev in enumerate(mesh.devices)]
    return gather_heads(outs, q.device, head_axis), len(outs)


class HeadSharded:
    """A tensor split over a mesh's shards along its head axis (the second
    to last), or replicated, one part per shard.  Replicated parts of
    shards on one device are one tensor.

    An integer index takes the leading axis of every part, so the
    period-stacked pools slice into per-layer views as plain tensors do."""

    def __init__(self, parts: Sequence[torch.Tensor], heads: int, sharded: bool):
        self.parts = tuple(parts)
        self.heads = heads
        self.sharded = sharded

    @property
    def shape(self) -> torch.Size:
        s = list(self.parts[0].shape)
        s[HEAD_AXIS] = self.heads
        return torch.Size(s)

    def __getitem__(self, idx: int) -> "HeadSharded":
        if not isinstance(idx, int):
            raise TypeError("HeadSharded takes an integer index of its leading axis")
        return HeadSharded([p[idx] for p in self.parts], self.heads, self.sharded)

    def writers(self) -> List[int]:
        """The shards whose part has storage of its own: every shard when
        the heads shard, the first shard on each device when they
        replicate.  A write goes to each of them."""
        if self.sharded:
            return list(range(len(self.parts)))
        first: dict = {}
        for s, p in enumerate(self.parts):
            first.setdefault(p.device, s)
        return list(first.values())

    def readers(self) -> List[int]:
        """The shards a read of the whole tensor takes: every shard when the
        heads shard, else shard 0."""
        return list(range(len(self.parts))) if self.sharded else [0]


def place(x: torch.Tensor, mesh) -> HeadSharded:
    """``x`` (heads on the second to last axis) laid out over ``mesh``:
    each shard's head range copied to its device when the heads shard, else
    one copy per distinct device."""
    heads = x.shape[HEAD_AXIS]
    if shards_heads(heads, mesh):
        return HeadSharded(split_heads(x, mesh), heads, True)
    copies = {dev: x.to(dev, copy=True) for dev in mesh.distinct()}
    return HeadSharded([copies[dev] for dev in mesh.devices], heads, False)


def zeros(shape: Sequence[int], dtype, mesh) -> HeadSharded:
    """A zero tensor of ``shape`` laid out over ``mesh`` as ``place`` lays
    one out, allocated part by part (no whole copy is made)."""
    heads = shape[HEAD_AXIS]
    local = list(shape)
    if shards_heads(heads, mesh):
        local[HEAD_AXIS] = heads // mesh.tp
        parts = [torch.zeros(local, dtype=dtype, device=d) for d in mesh.devices]
        return HeadSharded(parts, heads, True)
    copies = {dev: torch.zeros(local, dtype=dtype, device=dev) for dev in mesh.distinct()}
    return HeadSharded([copies[dev] for dev in mesh.devices], heads, False)

