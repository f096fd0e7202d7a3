"""The port's VLM, llama-3.2-vision-11b, against the JAX package's on the CPU,
at ``.reduced()`` (10 layers in 2 periods of 4 self-attention layers and 1
cross-attention layer, 4 / 4 heads of D = 64, 16 image tokens of width 128)
and fp32.

Both packages compute with the same weights (the reference's
``init_params(cfg, PRNGKey(0))`` carried over by ``repro_torch.bridge``) and
the same numpy inputs: ``forward_full`` with image embeds and emitted
caches, ``prefill_chunk`` chunk by chunk with the image at offset 0 (which
writes each cross layer's ``ck`` / ``cv``), ``decode_step`` and
``run_segment``.  The cross-attention runs through
``kernels.ops.flash_attention(causal=False)``, its plain version here; the
reference's is the plain ``gqa_scores_softmax_values``.  ``RealEngine``
serves on the contiguous path and emits the reference engine's greedy
tokens under preemption with recompute resume, for requests with and
without an image; a safepoint abort of a decode batch leaves every
request's cache, cross K/V included, untouched; and ``serve --arch
llama-3.2-vision-11b`` finishes.
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.profiler import TPU_V5E  # noqa: E402
from repro.core.request import Priority, Request  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serving.real_engine import RealEngine, RealEngineConfig  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as get_config_t  # noqa: E402
from repro_torch.core.profiler import AnalyticalCostModel, HardwareSpec  # noqa: E402
from repro_torch.core.request import Priority as PriorityT, Request as RequestT  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serving import real_engine as engine_t  # noqa: E402
from test_torch_engine import MARGIN_BOUND, _prompt  # noqa: E402

ARCH = "llama-3.2-vision-11b"
# fp32 on both sides, sums in other orders: logits of magnitude ~4 a few
# 1e-6 apart after 10 layers, cross K/V a few 1e-6
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """One intra-op thread per test, as the other engine tests run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _model():
    cfg = get_config(ARCH).reduced()
    params = jtf.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, get_config_t(ARCH).reduced(), params, jax.tree.map(np.asarray, params)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _images(cfg, b, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.num_image_tokens, cfg.vision_dim)).astype(np.float32)


def _assert_caches(got, want):
    """Every leaf: slot positions exactly, K/V and cross K/V within TOL."""
    for pos, leaves in want.items():
        assert set(got[pos]) == set(leaves)
        for name, w in leaves.items():
            if name == "pos":
                np.testing.assert_array_equal(got[pos][name].numpy(), np.asarray(w))
            else:
                np.testing.assert_allclose(got[pos][name].numpy(), np.asarray(w), **TOL)


def test_configs_layout_and_bridge():
    """The port's configs equal the reference's (full and reduced); its own
    init has the reference's tree: ``vision_proj``, the cross layer's mixer
    shaped as a self-attention one's, period-major stacking; the bridge
    carries the tree both ways; ``init_caches`` has the reference's
    ``ck`` / ``cv`` leaves; the paged pools refuse the arch."""
    for cfg, cfgt in ((get_config(ARCH), get_config_t(ARCH)), _model()[:2]):
        assert dataclasses.asdict(cfgt) == dataclasses.asdict(cfg)
        assert cfgt.param_count() == cfg.param_count()
    cfg, cfgt, _, nparams = _model()
    assert [s.mixer for s in cfgt.layer_pattern()] == ["attn"] * 4 + ["cross_attn"]
    own = ttf.init_params(cfgt, torch.Generator().manual_seed(0))
    shapes = jax.tree.map(lambda a: tuple(a.shape), nparams)
    assert jax.tree.map(lambda t: tuple(t.shape), own) == shapes
    assert shapes["vision_proj"] == (cfg.vision_dim, cfg.d_model)
    assert shapes["layers"]["4"]["mixer"]["wq"] == (2, cfg.d_model, 4, 64)
    back = bridge.to_numpy(bridge.to_torch(nparams))
    assert jax.tree.map(lambda a, b: bool(np.array_equal(a, b)), back, nparams) == \
        jax.tree.map(lambda _: True, nparams)
    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jtf.init_caches(cfg, 2, 64))
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[1]),
                       ttf.init_caches(cfgt, 2, 64))
    assert got == want and got["4"]["ck"][0] == (2, 2, cfg.num_image_tokens, 4, 64)
    assert not ttf.supports_paged(cfgt)
    with pytest.raises(ValueError, match="paged pools"):
        ttf.init_paged_pools(cfgt, 8, 16)


def test_forward_full_with_images_matches_reference():
    """Logits over 40 tokens with image embeds, and the emitted caches
    (self-attention slots, cross K/V); a VLM forward with neither image
    nor caches has no K/V to attend over and is refused."""
    cfg, cfgt, params, nparams = _model()
    tparams = bridge.to_torch(nparams)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    img = _images(cfg, 2, 2)
    want, wc, _ = jtf.forward_full(cfg, params, jnp.asarray(toks), image_embeds=jnp.asarray(img),
                                   emit_caches=True, max_seq=64)
    got, gc, _ = ttf.forward_full(cfgt, tparams, _t(toks), image_embeds=_t(img),
                                  emit_caches=True, max_seq=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_caches(gc, wc)
    with pytest.raises(ValueError, match="cross-attention needs image embeds"):
        ttf.forward_full(cfgt, tparams, _t(toks))


@pytest.mark.parametrize("with_image", [True, False], ids=["image", "no image"])
def test_chunked_prefill_decode_and_segments_match_reference(with_image):
    """``prefill_chunk`` over 48 tokens in chunks of 16 and 32 (the image at
    offset 0 only), then ``decode_step`` and ``run_segment`` by segment:
    logits and every cache leaf equal the reference's.  Without an image the
    cross K/V stay zero on both sides."""
    cfg, cfgt, params, nparams = _model()
    tparams = bridge.to_torch(nparams)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 49)).astype(np.int32)
    img = _images(cfg, 2, 4) if with_image else None
    wc, gc = jtf.init_caches(cfg, 2, 64), ttf.init_caches(cfgt, 2, 64)
    for lo, hi in ((0, 16), (16, 48)):
        first = img is not None and lo == 0
        want, wc = jtf.prefill_chunk(cfg, params, jnp.asarray(toks[:, lo:hi]), wc,
                                     jnp.asarray([lo, lo], jnp.int32),
                                     image_embeds=jnp.asarray(img) if first else None)
        got, gc = ttf.prefill_chunk(cfgt, tparams, _t(toks[:, lo:hi]), gc, [lo, lo],
                                    image_embeds=_t(img) if first else None)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_caches(gc, wc)
    assert (gc["4"]["ck"].abs().max() > 0) == with_image

    last, lens = toks[:, 48], np.array([48, 48], np.int32)
    seg_caches = bridge.to_torch(bridge.to_numpy(gc))
    want, wc2 = jtf.decode_step(cfg, params, jnp.asarray(last), wc, jnp.asarray(lens))
    got, gc = ttf.decode_step(cfgt, tparams, _t(last), gc, _t(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_caches(gc, wc2)
    wx = jtf.embed(cfg, params, jnp.asarray(last)[:, None])
    x = ttf.embed(cfgt, tparams, _t(last)[:, None])
    assert ttf.num_segments(cfgt) == 2
    for seg in range(ttf.num_segments(cfgt)):
        wx, wc = jtf.run_segment(cfg, params, seg, wx, wc, mode="decode",
                                 positions=jnp.asarray(lens[:, None]))
        x, _ = ttf.run_segment(cfgt, tparams, seg, x, seg_caches, mode="decode",
                               positions=_t(lens)[:, None])
    np.testing.assert_allclose(x.numpy(), np.asarray(wx), **TOL)
    _assert_caches(seg_caches, wc)


# --------------------------------------------------------------- the engine
# three offline jobs, then two online arrivals under block pressure: a
# preemption whose recompute rebuilds the cross K/V from the image; the
# second offline job and the second online request carry no image
JOBS, PREEMPT_STEP, ENG_KW = [(40, 12)] * 3, 5, dict(num_device_blocks=12)
NO_IMAGE = {1, 101}


def _drive(eng, mk):
    reqs = [mk(False, plen, gen, seed) for seed, (plen, gen) in enumerate(JOBS)]
    for r in reqs:
        eng.submit(r)
    for _ in range(PREEMPT_STEP):
        eng.step()
    online = [mk(True, 50, 6, 100 + s) for s in range(2)]
    for r in online:
        eng.on_online_arrival(r)
    eng.run()
    return reqs + online


def _image_of(cfg, seed):
    return None if seed in NO_IMAGE else _images(cfg, 1, 1000 + seed)[0]


@pytest.fixture(scope="module")
def reference_tokens():
    cfg, _, params, _ = _model()
    eng = RealEngine(cfg, params, eng_cfg=RealEngineConfig(**ENG_KW))

    def mk(on, plen, gen, seed):
        return Request(Priority.ONLINE if on else Priority.OFFLINE, prompt_len=plen,
                       max_new_tokens=gen, prompt=_prompt(cfg.vocab_size, plen, seed),
                       image_embeds=_image_of(cfg, seed))

    reqs = _drive(eng, mk)
    assert not eng.ckpt.enabled
    return [r.output_tokens for r in reqs], sum(r.num_preemptions for r in reqs)


def test_engine_emits_reference_tokens_under_preemption(reference_tokens):
    """The contiguous path with the checkpointer off: a preempted request's
    cache is dropped and its recompute at offset 0 rebuilds the cross K/V
    from its image.  Every request's greedy tokens, with and without an
    image, equal the reference engine's, each sampled token clear of a
    near-tie."""
    want, npre = reference_tokens
    _, cfgt, _, nparams = _model()
    eng = engine_t.RealEngine(cfgt, bridge.to_torch(nparams), device="cpu",
                              eng_cfg=engine_t.RealEngineConfig(**ENG_KW))
    # the reference's prior latency model, so both schedulers plan alike
    eng.sched.model = AnalyticalCostModel(cfgt, HardwareSpec(**dataclasses.asdict(TPU_V5E)))
    eng.margins = {}
    images = []
    prefill = eng._prefill_contiguous

    def spy(plan, tokens):  # which chunks carried an image
        images.extend((c.request.request_id, c.offset, c.request.image_embeds is not None)
                      for c in plan.prefill_chunks)
        return prefill(plan, tokens)

    eng._prefill_contiguous = spy

    def mk(on, plen, gen, seed):
        return RequestT(PriorityT.ONLINE if on else PriorityT.OFFLINE, prompt_len=plen,
                        max_new_tokens=gen, prompt=_prompt(cfgt.vocab_size, plen, seed),
                        image_embeds=_image_of(cfgt, seed))

    reqs = _drive(eng, mk)
    low = min(min(m) for m in eng.margins.values())
    assert low > MARGIN_BOUND, f"near-tie: a top-2 logit margin is {low:.2e}"
    assert not eng.paged and eng.recompute_only and not eng.ckpt.enabled
    assert eng.ckpt.stats.blocks_checkpointed == 0 and len(eng.host) == 0
    got_pre = sum(r.num_preemptions for r in reqs)
    assert npre > 0 and got_pre == npre, "the case must preempt, as in the reference"
    assert len(eng.recomputed) == npre
    resumed = {rid for rid, _n in eng.recomputed}
    assert any(rid in resumed and has for rid, off, has in images if off == 0), \
        "a resumed request with an image must recompute from offset 0"
    assert eng.dispatches["segment"] > 0 and eng.dispatches["prefill"] > 0
    assert [r.output_tokens for r in reqs] == want


def test_serve_real_takes_the_vlm():
    """``serve --mode real --arch llama-3.2-vision-11b --device cpu``: text
    requests without images, as the reference's serve sends them, on the
    contiguous path; every stream and the batch job finish."""
    from repro_torch.launch import serve

    argv = ["--arch", ARCH, "--device", "cpu", "--dtype", "float32", "--online", "1",
            "--offline", "2", "--prompt-len", "64", "--max-new", "4"]
    res = serve.run_real(serve.build_parser().parse_args(argv))
    assert res["cfg"].name == f"{ARCH}-smoke" and not res["engine"].paged
    assert res["engine"].recompute_only
    assert res["job"].done and all(h.finished for h in res["streams"])
    assert all(len(r.output_tokens) == 4
               for r in list(res["job"].requests) + [h.request for h in res["streams"]])


def test_aborted_decode_leaves_the_caches_untouched():
    """A safepoint abort of a pure-offline decode batch: the batch runs on
    a stacked copy of the requests' caches, so every request's leaves, the
    cross K/V included, are as they were; the engine then finishes with the
    tokens of an engine that never aborted."""
    _, cfgt, _, nparams = _model()
    tparams = bridge.to_torch(nparams)

    def run(abort):
        eng = engine_t.RealEngine(cfgt, tparams, device="cpu")
        reqs = [RequestT(PriorityT.OFFLINE, prompt_len=20, max_new_tokens=4,
                         prompt=_prompt(cfgt.vocab_size, 20, s), image_embeds=_image_of(cfgt, s))
                for s in (0, 2)]
        for r in reqs:
            eng.submit(r)
        while not all(r.num_generated for r in reqs):
            eng.step()
        if abort:
            before = {rid: bridge.to_numpy(c) for rid, c in eng.caches.items()}
            eng.flag.set()
            eng.step()
            assert eng.safepoints.stats.preemptions == 1 and eng.dispatches["segment"] == 1
            assert all(r.num_generated == 1 for r in reqs)
            for rid, cache in eng.caches.items():
                for pos, leaves in cache.items():
                    for name, leaf in leaves.items():
                        np.testing.assert_array_equal(leaf.numpy(), before[rid][pos][name])
            assert eng.caches[reqs[0].request_id]["4"]["ck"].abs().max() > 0
        eng.run()
        return [r.output_tokens for r in reqs]

    assert run(abort=True) == run(abort=False)
