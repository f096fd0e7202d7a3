"""The port's encoder, hubert-xlarge, against the JAX package's on the CPU:
a bidirectional stack (``causal=False``) over precomputed frame embeddings
(``embed_inputs=False``), at ``.reduced()`` (D = 64) and at
``.reduced(head_dim=80)`` (hubert's own head dim), fp32.

``forward_full`` is the encoder's entry point in both packages.  Every
layer's attention runs through ``kernels.ops.flash_attention(causal=False)``
(its plain version here; the flash kernel on the card, which takes D = 80);
the reference switches from its plain attention to its blockwise form above
1024 frames, and both sides are held to each other there too.  The weights'
zero biases (qkv and MLP) are replaced by random ones, so the bias paths
count.  No serving path takes an encoder: the reference's engine fails on
one (ROADMAP Queue 3), and the port's engine and ``serve`` refuse it.
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.request import Priority, Request  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serving.real_engine import RealEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as get_config_t  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serving import real_engine as engine_t  # noqa: E402

ARCH = "hubert-xlarge"
HEAD_DIMS = {"D64": {}, "D80": dict(head_dim=80)}
# fp32 on both sides over 2 layers; the blockwise form's online softmax adds
# its own rounding above 1024 frames
TOL = dict(atol=1e-4, rtol=1e-4)
BIASES = ("bq", "bk", "bv", "b_up", "b_down")


@functools.lru_cache(maxsize=None)
def _model(dims):
    kw = HEAD_DIMS[dims]
    cfg = get_config(ARCH).reduced(**kw)
    nparams = jax.tree.map(np.asarray, jtf.init_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)

    def biased(tree):
        return {k: biased(v) if isinstance(v, dict) else
                (0.1 * rng.standard_normal(v.shape).astype(v.dtype) if k in BIASES else v)
                for k, v in tree.items()}

    nparams = biased(nparams)
    return cfg, get_config_t(ARCH).reduced(**kw), jax.tree.map(jnp.asarray, nparams), nparams


def _frames(cfg, b, t, seed):
    return np.random.default_rng(seed).standard_normal((b, t, cfg.d_model)).astype(np.float32)


def test_configs_and_the_bridge_without_embed():
    """The configs equal the reference's; the tree has no ``embed`` and an
    untied ``lm_head`` (the port's own init too) and carries over the
    bridge both ways; the encoder takes no paged or serving path."""
    assert dataclasses.asdict(get_config_t(ARCH)) == dataclasses.asdict(get_config(ARCH))
    for dims in HEAD_DIMS:
        cfg, cfgt, _, nparams = _model(dims)
        assert dataclasses.asdict(cfgt) == dataclasses.asdict(cfg)
        assert not cfgt.causal and not cfgt.embed_inputs
        assert "embed" not in nparams and nparams["lm_head"].shape == (cfg.d_model, 504)
        own = ttf.init_params(cfgt, torch.Generator().manual_seed(0))
        assert (jax.tree.map(lambda t: tuple(t.shape), own)
                == jax.tree.map(lambda a: tuple(a.shape), nparams))
        assert own["layers"]["0"]["mixer"]["wq"].shape[-1] == cfg.resolved_head_dim
        back = bridge.to_numpy(bridge.to_torch(nparams))
        assert all(np.array_equal(a, b) for a, b in
                   zip(jax.tree.leaves(back), jax.tree.leaves(nparams)))
        assert not ttf.supports_paged(cfgt)
    assert _model("D80")[1].resolved_head_dim == 80


@pytest.mark.parametrize("t", [96, 1100], ids=["T96", "T1100 blockwise"])
@pytest.mark.parametrize("dims", list(HEAD_DIMS))
def test_forward_full_on_frames_matches_reference(dims, t):
    """Logits of every frame, below the reference's blockwise threshold of
    1024 frames (its plain attention) and above it (its blockwise form)."""
    cfg, cfgt, params, nparams = _model(dims)
    b = 2 if t < 1024 else 1
    x = _frames(cfg, b, t, 11)
    if t > jl.BLOCKWISE_THRESHOLD:
        assert t % jl.BLOCK_Q and t % jl.BLOCK_K  # padded blocks on the reference's side
    want, _, _ = jtf.forward_full(cfg, params, jnp.asarray(x))
    got, _, _ = ttf.forward_full(cfgt, bridge.to_torch(nparams), torch.from_numpy(x))
    assert got.shape == (b, t, cfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("dims", list(HEAD_DIMS))
def test_encoder_is_bidirectional(dims):
    """Flipping the last frame changes the first position's logits, as the
    reference's ``tests/test_models.py`` checks; a causal stack would leave
    them as they were."""
    _, cfgt, _, nparams = _model(dims)
    tparams = bridge.to_torch(nparams)
    x = torch.from_numpy(_frames(cfgt, 2, 12, 13))
    x2 = x.clone()
    x2[:, -1] *= -1.0
    a, _, _ = ttf.forward_full(cfgt, tparams, x)
    b, _, _ = ttf.forward_full(cfgt, tparams, x2)
    assert float((a[:, 0] - b[:, 0]).abs().max()) > 1e-6
    causal = dataclasses.replace(cfgt, causal=True)
    a, _, _ = ttf.forward_full(causal, tparams, x)
    b, _, _ = ttf.forward_full(causal, tparams, x2)
    assert torch.equal(a[:, :-1], b[:, :-1])


def test_reference_engine_cannot_serve_an_encoder():
    """The reference's fault (ROADMAP Queue 3): its ``RealEngine`` passes a
    request's token ids to ``forward_full``, which takes them for frame
    embeddings: a 12-token request fails to broadcast."""
    cfg, _, params, _ = _model("D64")
    eng = RealEngine(cfg, params)
    eng.submit(Request(Priority.OFFLINE, prompt_len=12, max_new_tokens=1,
                       prompt=np.arange(12, dtype=np.int32)))
    with pytest.raises(ValueError, match="Incompatible shapes for broadcasting"):
        eng.run()


def test_engine_and_serve_refuse_the_encoder():
    """The port's engine refuses an encoder at construction, naming the
    reference's fault, and ``serve`` exits with the same refusal, in both
    modes."""
    from repro_torch.launch import serve

    _, cfgt, _, nparams = _model("D64")
    for cfg in (cfgt, dataclasses.replace(get_config_t("llama-2-7b").reduced(), causal=False)):
        with pytest.raises(ValueError, match="no serving path.*ROADMAP Queue 3"):
            engine_t.RealEngine(cfg, bridge.to_torch(nparams), device="cpu")
    for mode in ("real", "wallclock"):
        with pytest.raises(SystemExit, match="serve: hubert-xlarge: an encoder.*Queue 3"):
            serve.main(["--mode", mode, "--arch", ARCH, "--device", "cpu", "--dtype", "float32"])
