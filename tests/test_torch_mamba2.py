"""The port's Mamba-2 mixer against the JAX package's, on the CPU.

``repro_torch.models.mamba2`` must compute the reference's chunked SSD
(``mamba_full``), its sequential oracle (``mamba_full_ref``) and its O(1)
decode recurrence (``mamba_decode_step``) on the same weights (the
reference's ``init_mamba`` carried over by ``repro_torch.bridge``) and the
same numpy inputs and carried states, at fp32: the mixer's output, the conv
state and the SSM state, at ``mamba2-1.3b.reduced()`` (d_inner 512, 32 heads
of 16, state 16, chunks of 32), with sequences shorter than a chunk, a whole
number of chunks and a ragged last chunk.
"""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import mamba2 as jm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as get_config_t  # noqa: E402
from repro_torch.models import mamba2 as tm  # noqa: E402

# fp32 on both sides, sums in other orders: outputs of magnitude ~1 and
# states up to ~10 differ by a few 1e-6
TOL = dict(atol=2e-5, rtol=1e-5)


@functools.lru_cache(maxsize=None)
def _mixer():
    cfg = get_config("mamba2-1.3b").reduced()
    p = jm.init_mamba(cfg, jax.random.PRNGKey(5), jnp.float32)
    # random conv bias, dt bias and skip, so every term of the mixer counts
    rng = np.random.default_rng(5)
    p = dict(p, conv_b=jnp.asarray(rng.standard_normal(p["conv_b"].shape), jnp.float32) * 0.1,
             dt_bias=jnp.asarray(rng.standard_normal(p["dt_bias"].shape), jnp.float32) * 0.5,
             D=jnp.asarray(rng.standard_normal(p["D"].shape), jnp.float32))
    return cfg, get_config_t("mamba2-1.3b").reduced(), p, bridge.to_torch(
        jax.tree.map(np.asarray, p))


# jitted: one compile per shape instead of one per primitive
_ref_full = jax.jit(jm.mamba_full, static_argnums=(0,))
_ref_step = jax.jit(jm.mamba_decode_step, static_argnums=(0,))


def _ref_sequential(cfg, p, x, state):
    """The reference's ``mamba_full_ref``, its loop of ``mamba_decode_step``
    over the tokens, with the step jitted."""
    state = jm.zero_state(cfg, x.shape[0]) if state is None else state
    outs = []
    for i in range(x.shape[1]):
        y, state = _ref_step(cfg, p, x[:, i:i + 1, :], state)
        outs.append(y)
    return jnp.concatenate(outs, axis=1), state


def _x(cfg, b, t, seed):
    return np.random.default_rng(seed).standard_normal((b, t, cfg.d_model)).astype(np.float32)


def _state(cfg, b, seed):
    """A carried (ssm, conv) state of realistic size, or None for seed None."""
    if seed is None:
        return None
    rng = np.random.default_rng(seed)
    st = jm.zero_state(cfg, b)
    return (rng.standard_normal(st.ssm.shape).astype(np.float32),
            rng.standard_normal(st.conv.shape).astype(np.float32))


def _pair(state):
    if state is None:
        return None, None
    ssm, conv = state
    return (jm.MambaState(ssm=jnp.asarray(ssm), conv=jnp.asarray(conv)),
            tm.MambaState(ssm=torch.from_numpy(ssm), conv=torch.from_numpy(conv)))


def _assert_out_and_state(got, want, tol=TOL):
    (y, st), (wy, wst) = got, want
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), **tol)
    np.testing.assert_allclose(st.conv.numpy(), np.asarray(wst.conv), **tol)
    np.testing.assert_allclose(st.ssm.numpy(), np.asarray(wst.ssm), **tol)


# (B, T, state seed): shorter than a chunk, one chunk, a ragged last chunk
# (40 = 32 + 8) and three whole chunks, from zeros and from a carried state
CASES = [(2, 5, None), (1, 32, 7), (2, 40, None), (2, 40, 8), (1, 96, 9)]


@pytest.mark.parametrize("b,t,seed", CASES, ids=[f"{b}x{t}-{s}" for b, t, s in CASES])
def test_mamba_full_matches_reference(b, t, seed):
    cfg, cfgt, p, tp = _mixer()
    x = _x(cfg, b, t, seed=t)
    wst, tst = _pair(_state(cfg, b, seed))
    want = _ref_full(cfg, p, jnp.asarray(x), wst)
    got = tm.mamba_full(cfgt, tp, torch.from_numpy(x), tst)
    _assert_out_and_state(got, want)
    # and the reference's sequential oracle, which the chunked form must equal
    _assert_out_and_state(got, _ref_sequential(cfg, p, jnp.asarray(x), wst))


def test_mamba_full_ref_and_decode_step_match_reference():
    """The port's sequential oracle against the reference's, and one decode
    step from a carried state against the reference's step."""
    cfg, cfgt, p, tp = _mixer()
    x = _x(cfg, 2, 12, seed=3)
    wst, tst = _pair(_state(cfg, 2, 4))
    _assert_out_and_state(tm.mamba_full_ref(cfgt, tp, torch.from_numpy(x), tst),
                          jm.mamba_full_ref(cfg, p, jnp.asarray(x), wst))
    _assert_out_and_state(tm.mamba_decode_step(cfgt, tp, torch.from_numpy(x[:, :1]), tst),
                          jm.mamba_decode_step(cfg, p, jnp.asarray(x[:, :1]), wst))


def test_decode_steps_chained_match_mamba_full():
    """A prefill of 37 tokens by ``mamba_full``, then 9 decode steps chained
    from its state, equal one ``mamba_full`` over the 46 tokens: outputs
    token by token and the final state.  The states passed in are left as
    they were."""
    cfg, cfgt, p, tp = _mixer()
    x = torch.from_numpy(_x(cfg, 2, 46, seed=11))
    whole, whole_st = tm.mamba_full(cfgt, tp, x)
    y, st = tm.mamba_full(cfgt, tp, x[:, :37])
    outs = [y]
    for i in range(37, 46):
        before = (st.ssm.clone(), st.conv.clone())
        y, nst = tm.mamba_decode_step(cfgt, tp, x[:, i:i + 1], st)
        assert torch.equal(st.ssm, before[0]) and torch.equal(st.conv, before[1])
        outs.append(y)
        st = nst
    _assert_out_and_state((torch.cat(outs, dim=1), st), (whole.numpy(), whole_st))


def test_conv_and_projection_split_match_reference():
    """The depthwise causal conv with a carried conv state, and the split of
    the input projection into z, xBC and dt."""
    cfg, cfgt, p, tp = _mixer()
    rng = np.random.default_rng(2)
    xbc = rng.standard_normal((2, 9, tm.conv_channels(cfgt))).astype(np.float32)
    conv0 = rng.standard_normal((2, cfg.ssm_conv_width - 1, tm.conv_channels(cfgt))
                                ).astype(np.float32)
    want = jm._causal_conv_full(cfg, p, jnp.asarray(xbc), jnp.asarray(conv0))
    got = tm._causal_conv_full(cfgt, tp, torch.from_numpy(xbc), torch.from_numpy(conv0))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    proj = rng.standard_normal((2, 3, p["in_proj"].shape[1])).astype(np.float32)
    for g, w in zip(tm._split_proj(cfgt, torch.from_numpy(proj)),
                    jm._split_proj(cfg, jnp.asarray(proj))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_init_mamba_keeps_the_reference_layout_and_fp32_leaves():
    """Shapes stacked over periods, ``A_log`` the reference's values, and
    ``A_log`` / ``dt_bias`` / ``D`` fp32 in a bf16 model, from the port's
    own init and through the bridge; bf16 states keep the SSM state fp32."""
    cfg, cfgt, p, _ = _mixer()
    own = tm.init_mamba(cfgt, torch.Generator().manual_seed(0), torch.bfloat16, 3)
    assert {k: tuple(v.shape) for k, v in own.items()} == {
        k: (3,) + tuple(np.shape(v)) for k, v in p.items()}
    np.testing.assert_allclose(own["A_log"][1].numpy(),
                               np.asarray(jm.init_mamba(cfg, jax.random.PRNGKey(0),
                                                        jnp.float32)["A_log"]), rtol=1e-6)
    bf = bridge.to_torch(jax.tree.map(np.asarray, p), dtype=torch.bfloat16)
    for tree in (own, bf):
        assert all(tree[k].dtype == torch.float32 for k in ("A_log", "dt_bias", "D"))
        assert tree["in_proj"].dtype == torch.bfloat16
    st = tm.zero_state(cfgt, 2, torch.bfloat16)
    assert st.ssm.dtype == torch.float32 and st.conv.dtype == torch.bfloat16


def test_bf16_mixer_tracks_the_reference():
    """At bf16 weights and activations both packages keep the decays and the
    SSM state in fp32 and round the same products to bf16: outputs agree to
    a few bf16 steps and the state closely."""
    cfg, cfgt, _, _ = _mixer()
    pb = jm.init_mamba(cfg, jax.random.PRNGKey(6), jnp.bfloat16)
    tpb = bridge.to_torch(jax.tree.map(lambda a: np.asarray(a, np.float32), pb),
                          dtype=torch.bfloat16)
    x = _x(cfg, 2, 40, seed=13)
    want_y, want_st = _ref_full(cfg, pb, jnp.asarray(x, jnp.bfloat16))
    got_y, got_st = tm.mamba_full(cfgt, tpb, torch.from_numpy(x).to(torch.bfloat16))
    assert got_y.dtype == torch.bfloat16 and got_st.ssm.dtype == torch.float32
    np.testing.assert_allclose(got_y.float().numpy(), np.asarray(want_y, np.float32),
                               atol=6e-2, rtol=3e-2)
    np.testing.assert_allclose(got_st.ssm.numpy(), np.asarray(want_st.ssm), atol=6e-2,
                               rtol=3e-2)
