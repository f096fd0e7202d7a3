"""Turn the JAX package's parameters, paged pools and contiguous caches
into the port's tensors, and back.

The input is the reference pytree as plain numpy arrays (for example
``jax.tree.map(np.asarray, tf.init_params(cfg, PRNGKey(0)))``), so this
module never imports JAX: nested dicts map to nested dicts, each array to
a tensor on ``device``, and the period-major stacking is kept as it is.
A contiguous cache tree (``{pos: {"k", "v", "pos"}}``) keeps its int32
slot positions as int32.  Every leaf carries over, MoE layers' ``ffn``
(``router``, ``w_up``, ``w_gate``, ``w_down``, the expert axis after the
period axis), Mamba-2 mixers' (``in_proj``, ``conv_w``, ..., stacked
period-major like every leaf, a hybrid's attention and Mamba positions side
by side) and a tied-embedding tree's (no ``lm_head``) included; a MoE
``router`` and a Mamba mixer's ``A_log``, ``dt_bias`` and ``D`` stay fp32
when the rest is cast, as the reference keeps them.  Tests use it so both
packages compute with the same weights and caches, with nothing
downloaded, and compare the results.
``replicate`` places a tree on the devices of a tensor-parallel serving
mesh, where params replicate (DESIGN.md §11).
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np
import torch


# leaves that stay fp32 whatever ``dtype`` the rest is cast to
FP32_LEAVES = ("router", "A_log", "dt_bias", "D")


def to_torch(tree: Any, device="cpu", dtype: Optional[torch.dtype] = None) -> Any:
    """Nested dicts of arrays -> the same dicts of tensors on ``device``
    (cast to ``dtype`` when given, but for ``FP32_LEAVES``; integer leaves
    keep their type)."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device, None if k in FP32_LEAVES else dtype)
                for k, v in tree.items()}
    t = torch.from_numpy(np.array(tree, copy=True)).to(device)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


def to_numpy(tree: Any) -> Any:
    """The reverse of ``to_torch``: tensors -> numpy arrays (bf16 as fp32)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def replicate(tree: Any, devices: Sequence[torch.device]) -> List[Any]:
    """One copy of a tree of tensors per distinct device of ``devices``,
    listed per entry: entries naming one device share its copy (two shards
    on one card hold one set of weights), and a tree already on a device is
    not copied there."""
    def move(t, dev):
        if isinstance(t, dict):
            return {k: move(v, dev) for k, v in t.items()}
        return t.to(dev)

    copies = {dev: move(tree, dev) for dev in dict.fromkeys(devices)}
    return [copies[dev] for dev in devices]
