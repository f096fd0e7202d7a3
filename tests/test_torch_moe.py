"""The port's Mixture-of-Experts FFN against the JAX package's, on the CPU.

``repro_torch.models.moe`` must compute the reference's ``moe_ffn``
(dropless and at a capacity factor that drops tokens) and its dense oracle
on the same weights (the reference's ``init_moe`` carried over by
``repro_torch.bridge``) and the same numpy inputs, at fp32, on
``olmoe-1b-7b`` reduced (4 experts, top 2), on a wider reduced variant
(16 experts, top 4) where a factor of 1.25 drops assignments, and at the
routings of mixtral-8x22b (8 experts, top 2) and jamba-1.5-large-398b (16
experts, top 2).
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as get_config_t  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

# fp32 on both sides; the products and the k-way combine sum in other
# orders (outputs of magnitude ~1, differences of a few 1e-7)
TOL = dict(atol=1e-5, rtol=1e-5)
VARIANTS = {
    "reduced": {},
    "16 experts top 4": dict(num_experts=16, experts_per_token=4),
    "mixtral 8 experts top 2": dict(num_experts=8, experts_per_token=2),
    "jamba 16 experts top 2": dict(num_experts=16, experts_per_token=2),
    "geglu": dict(activation="geglu"),
    "gelu": dict(activation="gelu"),
}


@functools.lru_cache(maxsize=None)
def _moe(variant):
    cfg = dataclasses.replace(get_config("olmoe-1b-7b").reduced(), **VARIANTS[variant])
    cfgt = dataclasses.replace(get_config_t("olmoe-1b-7b").reduced(), **VARIANTS[variant])
    p = jmoe.init_moe(cfg, jax.random.PRNGKey(3), jnp.float32)
    return cfg, cfgt, p, bridge.to_torch(jax.tree.map(np.asarray, p))


# jitted: one compile per shape instead of one per primitive
_ref_ffn = jax.jit(jmoe.moe_ffn, static_argnums=(0, 3))
_ref_oracle = jax.jit(jmoe.moe_ffn_dense_oracle, static_argnums=(0,))


def _x(cfg, shape, seed):
    return np.random.default_rng(seed).standard_normal(shape + (cfg.d_model,)).astype(np.float32)


# (B, T): one token; a ragged batch's (1, T) with padded rows of zeros at
# the end, as the engine's fused batches carry them; a prefill wave
SHAPES = [(1, 1), (1, 13), (3, 8)]


# every shape for the two routings; one shape for the other activations; a
# token and a prefill wave at mixtral's and jamba's routings
CASES = [(v, s, f) for v in ("reduced", "16 experts top 4") for s in SHAPES
         for f in (-1.0, 1.25)] + [(v, (1, 13), f) for v in ("geglu", "gelu")
                                   for f in (-1.0, 1.25)] + [
    (v, s, f) for v in ("mixtral 8 experts top 2", "jamba 16 experts top 2")
    for s in ((1, 1), (3, 8)) for f in (-1.0, 1.25)]


@pytest.mark.parametrize("variant,shape,factor", CASES,
                         ids=[f"{v}-{s[0]}x{s[1]}-{f:g}" for v, s, f in CASES])
def test_moe_ffn_matches_reference(variant, shape, factor):
    cfg, cfgt, p, tp = _moe(variant)
    x = _x(cfg, shape, seed=sum(shape))
    if shape == (1, 13):
        x[0, 9:] = 0.0  # padded rows route too
    want, waux = _ref_ffn(cfg, p, jnp.asarray(x), factor)
    got, aux = tmoe.moe_ffn(cfgt, tp, torch.from_numpy(x), capacity_factor=factor)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(waux), **TOL)
    if factor <= 0:  # dropless: the dense oracle, on both sides
        oracle = tmoe.moe_ffn_dense_oracle(cfgt, tp, torch.from_numpy(x))
        np.testing.assert_allclose(oracle.numpy(), np.asarray(
            _ref_oracle(cfg, p, jnp.asarray(x))), **TOL)
        np.testing.assert_allclose(got.numpy(), oracle.numpy(), **TOL)


def test_capacity_drops_in_token_order():
    """At 16 experts, top 4 and factor 1.25, 24 tokens give each expert 8
    rows for 96 assignments: some are dropped, as in the reference, and a
    dropped token's output lacks exactly its dropped experts' share."""
    cfg, cfgt, p, tp = _moe("16 experts top 4")
    x = torch.from_numpy(_x(cfg, (1, 24), seed=5))
    idx, w, _ = tmoe.router_topk(cfgt, tp, x[0])
    counts = torch.bincount(idx.reshape(-1), minlength=cfg.num_experts)
    capacity = int(round(24 * 4 / 16 * 1.25))
    assert int(counts.max()) > capacity  # the factor drops something here
    dropless, _ = tmoe.moe_ffn(cfgt, tp, x, capacity_factor=-1.0)
    dropped, _ = tmoe.moe_ffn(cfgt, tp, x, capacity_factor=1.25)
    # rebuild the dropped output from the dense oracle's per-expert outputs
    dense = tmoe._experts(cfgt, tp, x[0][None].expand(cfg.num_experts, 24, cfg.d_model))
    seen = torch.zeros(cfg.num_experts, dtype=torch.long)
    want = torch.zeros(24, cfg.d_model)
    for t in range(24):
        for j in range(4):
            e = int(idx[t, j])
            if seen[e] < capacity:
                want[t] += w[t, j] * dense[e, t]
            seen[e] += 1
    torch.testing.assert_close(dropped[0], want, **TOL)
    assert not torch.allclose(dropped, dropless, **TOL)


def test_router_topk_matches_reference():
    cfg, cfgt, p, tp = _moe("16 experts top 4")
    x = _x(cfg, (40,), seed=9)
    idx, w, aux = jmoe.router_topk(cfg, p, jnp.asarray(x))
    tidx, tw, taux = tmoe.router_topk(cfgt, tp, torch.from_numpy(x))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
    np.testing.assert_allclose(tw.numpy(), np.asarray(w), **TOL)
    np.testing.assert_allclose(float(taux), float(aux), **TOL)


def test_router_stays_fp32_in_a_bf16_model():
    """The router's weights and logits stay fp32 when the experts are bf16
    (the reference's ``init_moe`` and ``router_topk``); the output is bf16."""
    cfg, cfgt, p, tp = _moe("reduced")
    own = tmoe.init_moe(cfgt, torch.Generator().manual_seed(0), torch.bfloat16, periods=2)
    assert own["router"].dtype == torch.float32 and own["w_up"].dtype == torch.bfloat16
    assert {k: tuple(v.shape) for k, v in own.items()} == {
        k: (2,) + tuple(np.shape(v)) for k, v in p.items()}
    bf = {k: v if k == "router" else v.bfloat16() for k, v in tp.items()}
    x = torch.from_numpy(_x(cfg, (1, 6), seed=2)).bfloat16()
    out, _ = tmoe.moe_ffn(cfgt, bf, x, capacity_factor=-1.0)
    assert out.dtype == torch.bfloat16
    idx, _, _ = tmoe.router_topk(cfgt, bf, x.reshape(6, -1))
    want, _, _ = jmoe.router_topk(cfg, p, jnp.asarray(x.float().numpy().reshape(6, -1)))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want))
