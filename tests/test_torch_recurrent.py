"""The port's archs that resume by recompute against the JAX package's, on
the CPU: mamba2-1.3b (pure SSM), jamba-1.5-large-398b (attention + Mamba-2
+ MoE, a period of 8 layers) and mixtral-8x22b (sliding-window attention
with ring caches, 8 experts top 2), each at its ``.reduced()`` size
(mixtral's window 64) and fp32.

Both packages compute with the same weights (the reference's
``init_params(cfg, PRNGKey(0))`` carried over by ``repro_torch.bridge``)
and the same numpy inputs: ``forward_full`` with emitted caches (attention
slots and rings, Mamba ``ssm`` / ``conv`` states), ``prefill_chunk`` chunk by
chunk, ``decode_step`` and ``run_segment``.  Mixtral's ring prefill in
chunks that cross the window is held to the reference's ``forward_full``,
not to its ``prefill_chunk``, which writes a chunk into the ring before
reading it (ROADMAP Queue 3).  ``RealEngine`` emits the reference engine's
greedy tokens under preemption with the checkpointer off and recompute
resume, and refuses the paged backend and tensor parallelism for them.
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
from repro.models import layers as jl  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serving.real_engine import RealEngine, RealEngineConfig  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as get_config_t  # noqa: E402
from repro_torch.core.profiler import AnalyticalCostModel, HardwareSpec  # noqa: E402
from repro_torch.core.request import Priority as PriorityT, Request as RequestT  # noqa: E402
from repro_torch.core.scheduler import SchedulerConfig  # noqa: E402
from repro_torch.launch.mesh import make_serving_mesh  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serving import real_engine as engine_t  # noqa: E402
from test_torch_engine import MARGIN_BOUND, _drive, _prompt  # noqa: E402

ARCHS = ["mamba2-1.3b", "mixtral-8x22b", "jamba-1.5-large-398b"]
# fp32 on both sides, sums in other orders, carried through recurrent state:
# jamba's 16 layers leave logits of magnitude ~5 a few 1e-5 apart and SSM
# states of magnitude up to ~35 up to 7e-4 apart
LOGIT_TOL = dict(atol=2e-4, rtol=1e-4)
STATE_TOL = dict(atol=1e-3, rtol=1e-4)


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """One intra-op thread per test, as the other engine tests run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _model(arch, **kw):
    cfg = get_config(arch).reduced(**kw)
    params = jtf.init_params(cfg, jax.random.PRNGKey(0))
    nparams = jax.tree.map(np.asarray, params)
    return cfg, get_config_t(arch).reduced(**kw), params, nparams


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _assert_caches(got, want):
    """Attention positions' slot positions exactly and K/V, Mamba positions'
    conv and SSM states, within the tolerances."""
    for pos, leaves in want.items():
        assert set(got[pos]) == set(leaves)
        for name, w in leaves.items():
            if name == "pos":
                np.testing.assert_array_equal(got[pos][name].numpy(), np.asarray(w))
            else:
                np.testing.assert_allclose(got[pos][name].numpy(), np.asarray(w),
                                           **(STATE_TOL if name == "ssm" else LOGIT_TOL))


def _layer_aux(cfgt, tparams, toks):
    """``forward_full``'s router losses per MoE layer, ``{(period,
    position): aux}``, at capacity factor 1.25."""
    auxes = []
    x = ttf.embed(cfgt, tparams, _t(toks))
    positions = torch.arange(toks.shape[1], dtype=torch.int32).expand(toks.shape)
    ttf.run_periods(cfgt, tparams["layers"], 0, cfgt.num_periods, x, None, None, positions,
                    mode="full", aux_out=auxes)
    where = [(per, i) for per in range(cfgt.num_periods)
             for i, s in enumerate(cfgt.layer_pattern()) if s.ffn == "moe"]
    assert len(where) == len(auxes)
    return {k: float(a) for k, a in zip(where, auxes)}


def _toks(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def test_configs_layouts_and_caches():
    """The port's own init has the reference's tree, shapes and period-major
    stacking for the three archs (jamba: 7 Mamba positions and attention at
    the last, MoE on odd positions); ``init_caches`` has the reference's
    leaves, a ring of the window's slots for mixtral; the paged pools
    refuse them."""
    for arch in ARCHS:
        cfg, cfgt, _, nparams = _model(arch)
        own = ttf.init_params(cfgt, torch.Generator().manual_seed(0))
        assert (jax.tree.map(lambda t: tuple(t.shape), own)
                == jax.tree.map(lambda a: tuple(a.shape), nparams))
        want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                            jtf.init_caches(cfg, 2, 128))
        got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[1]),
                           ttf.init_caches(cfgt, 2, 128))
        assert got == want
        assert not ttf.supports_paged(cfgt)
        with pytest.raises(ValueError, match="paged pools"):
            ttf.init_paged_pools(cfgt, 8, 16)
    jamba = _model("jamba-1.5-large-398b")[1]
    assert [s.mixer for s in jamba.layer_pattern()] == ["mamba"] * 7 + ["attn"]
    assert [s.ffn for s in jamba.layer_pattern()] == ["dense", "moe"] * 4
    assert ttf.init_caches(_model("mixtral-8x22b")[1], 1, 256)["0"]["k"].shape[2] == 64


@pytest.mark.parametrize("arch", ARCHS)
def test_contiguous_entry_points_match_reference(arch):
    """``forward_full`` over 100 tokens (past mixtral's window of 64) with
    emitted caches, at capacity factor 1.25 on both sides; then
    ``prefill_chunk`` over 48 tokens in two chunks, ``decode_step`` and
    ``run_segment`` (1.25 again, as the reference's engine runs it)."""
    cfg, cfgt, params, nparams = _model(arch)
    tparams = bridge.to_torch(nparams)
    toks = _toks(cfg, (2, 100), 25)
    want, wfull, waux = jtf.forward_full(cfg, params, jnp.asarray(toks), emit_caches=True,
                                         max_seq=128)
    got, gfull, aux = ttf.forward_full(cfgt, tparams, _t(toks), emit_caches=True, max_seq=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    layer_aux = _layer_aux(cfgt, tparams, toks)
    np.testing.assert_allclose(float(aux), sum(layer_aux.values()), atol=1e-6, rtol=1e-5)
    # the reference sums only the last pattern position's aux of each period
    last = cfgt.pattern_period - 1
    np.testing.assert_allclose(sum(a for (_per, i), a in layer_aux.items() if i == last),
                               float(waux), atol=1e-6, rtol=1e-5)
    assert (float(aux) > 0) == bool(cfg.num_experts)
    _assert_caches(gfull, wfull)

    wc, gc = jtf.init_caches(cfg, 2, 128), ttf.init_caches(cfgt, 2, 128)
    for lo, hi in ((0, 16), (16, 48)):
        want, wc = jtf.prefill_chunk(cfg, params, jnp.asarray(toks[:, lo:hi]), wc,
                                     jnp.asarray([lo, lo], jnp.int32))
        got, gc = ttf.prefill_chunk(cfgt, tparams, _t(toks[:, lo:hi]), gc, [lo, lo])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    _assert_caches(gc, wc)

    last, lens = toks[:, 47], np.array([48, 48], np.int32)
    seg_caches = bridge.to_torch(bridge.to_numpy(gc))
    want, wc2 = jtf.decode_step(cfg, params, jnp.asarray(last), wc, jnp.asarray(lens))
    got, gc = ttf.decode_step(cfgt, tparams, _t(last), gc, _t(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    _assert_caches(gc, wc2)
    wx = jtf.embed(cfg, params, jnp.asarray(last)[:, None])
    x = ttf.embed(cfgt, tparams, _t(last)[:, None])
    for seg in range(ttf.num_segments(cfgt)):
        wx, wc = jtf.run_segment(cfg, params, seg, wx, wc, mode="decode",
                                 positions=jnp.asarray(lens[:, None]))
        x, _ = ttf.run_segment(cfgt, tparams, seg, x, seg_caches, mode="decode",
                               positions=_t(lens)[:, None])
    np.testing.assert_allclose(x.numpy(), np.asarray(wx), **LOGIT_TOL)
    _assert_caches(seg_caches, wc)


def test_ssm_prefill_refuses_padded_chunks():
    """Padding would run through the recurrent state: refused, as in the
    reference."""
    for arch in ("mamba2-1.3b", "jamba-1.5-large-398b"):
        _, cfgt, _, nparams = _model(arch)
        with pytest.raises(ValueError, match="SSM"):
            ttf.prefill_chunk(cfgt, bridge.to_torch(nparams), torch.zeros((2, 8), dtype=torch.int32),
                              ttf.init_caches(cfgt, 2, 64), [0, 0],
                              lengths=torch.tensor([8, 5]))


# the reference's ring fault: reduced mixtral (window 64), seed 0, 160 tokens
RING_T, RING_CHUNK = 160, 32


def test_ring_prefill_in_chunks_holds_to_forward_full():
    """Mixtral's prefill in chunks of 32 over 160 tokens (the ring of 64
    slots wraps from the third chunk on): each chunk's last logits equal the
    reference's ``forward_full`` (dropless) at that position, and the ring
    equals the one ``forward_full`` emits.  The reference's own chunked
    prefill misses by more than 1.0 once a chunk crosses the window: a
    chunk is written into the ring before it is read."""
    cfg, cfgt, params, nparams = _model("mixtral-8x22b")
    tparams = bridge.to_torch(nparams)
    toks = _toks(cfg, (1, RING_T), 0)
    full, wfull, _ = jtf.forward_full(cfg, params, jnp.asarray(toks), emit_caches=True,
                                      capacity_factor=-1.0)
    full = np.asarray(full)
    gc, wc = ttf.init_caches(cfgt, 1, RING_T), jtf.init_caches(cfg, 1, RING_T)
    ref_miss = 0.0
    for lo in range(0, RING_T, RING_CHUNK):
        hi = lo + RING_CHUNK
        got, gc = ttf.prefill_chunk(cfgt, tparams, _t(toks[:, lo:hi]), gc, [lo])
        np.testing.assert_allclose(got.numpy(), full[:, hi - 1], **LOGIT_TOL)
        ref, wc = jtf.prefill_chunk(cfg, params, jnp.asarray(toks[:, lo:hi]), wc,
                                    jnp.asarray([lo], jnp.int32))
        ref_miss = float(np.abs(np.asarray(ref) - full[:, hi - 1]).max())
    assert ref_miss > 1.0, f"the reference's chunked prefill missed by only {ref_miss:.3f}"
    _assert_caches(gc, wfull)


def test_ring_prefill_padded_rows_hold_to_forward_full():
    """Two rows in chunks of 48, the second with 8 padded tokens in its
    third chunk: each row's last real logits equal ``forward_full`` of its
    own tokens, across the window."""
    cfg, cfgt, params, nparams = _model("mixtral-8x22b")
    tparams = bridge.to_torch(nparams)
    toks = _toks(cfg, (2, 144), 3)
    gc = ttf.init_caches(cfgt, 2, 144)
    for lo, n in ((0, (48, 48)), (48, (48, 48)), (96, (48, 40))):
        got, gc = ttf.prefill_chunk(cfgt, tparams, _t(toks[:, lo:lo + 48]), gc, [lo, lo],
                                    lengths=torch.tensor(n))
    for row, t in ((0, 144), (1, 136)):
        want, _, _ = jtf.forward_full(cfg, params, jnp.asarray(toks[row:row + 1, :t]),
                                      capacity_factor=-1.0)
        np.testing.assert_allclose(got[row].numpy(), np.asarray(want)[0, -1], **LOGIT_TOL)


# --------------------------------------------------------------- the engine
# an online burst mid-decode under block pressure: preemption, then resume
JOBS, PREEMPT_STEP, ENG_KW = [(40, 16)] * 3, 6, dict(num_device_blocks=14)
# mixtral with prompts past its window, so prefill and recompute chunks cross it
RING_JOBS, RING_ENG_KW = [(100, 12)] * 3, dict(num_device_blocks=24)
# the engine cases' models: jamba at one period of 8 layers, with shorter
# jobs (the reference compiles each shape the engine runs, for every layer)
ENGINE_MODELS = {"mamba2-1.3b": {}, "jamba-1.5-large-398b": dict(num_layers=8),
                 "mixtral-8x22b": {}}
ENGINE_CASES = {"mamba2-1.3b": (JOBS, ENG_KW),
                "jamba-1.5-large-398b": ([(32, 8)] * 3, dict(num_device_blocks=10))}


def _reference_tokens(arch, jobs, eng_kw):
    cfg, _, params, _ = _model(arch, **ENGINE_MODELS[arch])
    eng = RealEngine(cfg, params, eng_cfg=RealEngineConfig(**eng_kw))

    def mk(on, plen, gen, seed):
        return Request(Priority.ONLINE if on else Priority.OFFLINE, prompt_len=plen,
                       max_new_tokens=gen, prompt=_prompt(cfg.vocab_size, plen, seed))

    reqs, online = _drive(eng, mk, jobs, PREEMPT_STEP)
    assert not eng.ckpt.enabled
    return [r.output_tokens for r in reqs + online], sum(r.num_preemptions for r in reqs)


def _port_engine(arch, **kw):
    _, cfgt, _, nparams = _model(arch, **ENGINE_MODELS[arch])
    eng = engine_t.RealEngine(cfgt, bridge.to_torch(nparams), device="cpu",
                              eng_cfg=engine_t.RealEngineConfig(**kw))
    # the reference's prior latency model, so both schedulers plan alike
    eng.sched.model = AnalyticalCostModel(cfgt, HardwareSpec(**dataclasses.asdict(TPU_V5E)))
    return eng


def _port_tokens(arch, jobs, eng_kw):
    eng = _port_engine(arch, **eng_kw)
    eng.margins = {}

    def mk(on, plen, gen, seed):
        return RequestT(PriorityT.ONLINE if on else PriorityT.OFFLINE, prompt_len=plen,
                        max_new_tokens=gen, prompt=_prompt(eng.cfg.vocab_size, plen, seed))

    reqs, online = _drive(eng, mk, jobs, PREEMPT_STEP)
    low = min(min(m) for m in eng.margins.values())
    assert low > MARGIN_BOUND, (
        f"near-tie: a sampled token's top-2 logit margin is {low:.2e} <= {MARGIN_BOUND}")
    # recompute resume: nothing checkpointed, stored or restored
    assert not eng.paged and eng.recompute_only and not eng.ckpt.enabled
    assert eng.ckpt.stats.blocks_checkpointed == 0 and eng.restored_blocks == 0
    assert len(eng.host) == 0 and eng.ckpt_gathers == 0
    return [r.output_tokens for r in reqs + online], sum(r.num_preemptions for r in reqs), eng


@pytest.mark.parametrize("arch", list(ENGINE_CASES))
def test_engine_emits_reference_tokens_under_preemption(arch):
    jobs, eng_kw = ENGINE_CASES[arch]
    want, npre = _reference_tokens(arch, jobs, eng_kw)
    got, got_pre, eng = _port_tokens(arch, jobs, eng_kw)
    assert npre > 0 and got_pre == npre, "the case must preempt, as in the reference"
    # every resume prefilled its whole context again: past its prompt
    assert len(eng.recomputed) == npre and all(n > jobs[0][0] for _rid, n in eng.recomputed)
    assert eng.dispatches["segment"] > 0 and eng.dispatches["prefill"] > 0
    assert got == want


@pytest.fixture
def reference_ring_chunks_repaired(monkeypatch):
    """The reference with its ring-cache chunk fault (ROADMAP Queue 3)
    repaired in this process only (no file of the reference changes): its
    ``cached_attention`` attends over the cache as it was before the write
    together with the new tokens' own K/V, masked by position, then writes
    them.  Decode steps compute what they computed before."""
    def cached_attention(cfg, p, x, cache, positions, valid=None):
        q, k, v = jl.project_qkv(cfg, p, x)
        q = jl.apply_rope(q, positions, cfg.rope_theta)
        k = jl.apply_rope(k, positions, cfg.rope_theta)
        new_pos = positions if valid is None else jnp.where(valid, positions, -1)
        kk = jnp.concatenate([cache["k"], k.astype(cache["k"].dtype)], axis=1)
        vv = jnp.concatenate([cache["v"], v.astype(cache["v"].dtype)], axis=1)
        kp = jnp.concatenate([cache["pos"], new_pos], axis=1)[:, None, None, :]
        qp = positions[:, None, :, None]
        mask = (kp >= 0) & (kp <= qp) & (kp > qp - cfg.sliding_window)
        attn = jl.gqa_scores_softmax_values(q, kk, vv, mask, cfg.logit_softcap)
        return jl.out_proj(p, attn), jl.write_kv(cache, k, v, positions, valid)

    monkeypatch.setattr(jtf, "cached_attention", cached_attention)


def test_mixtral_engine_across_the_window(reference_ring_chunks_repaired):
    """Prompts of 100 tokens against a window of 64: prefill chunks and the
    recompute after preemption cross the window.  The port emits the tokens
    of a reference whose ring fault is repaired in this process (the
    unrepaired reference's tokens differ on this case)."""
    want, npre = _reference_tokens("mixtral-8x22b", RING_JOBS, RING_ENG_KW)
    got, got_pre, eng = _port_tokens("mixtral-8x22b", RING_JOBS, RING_ENG_KW)
    assert npre > 0 and got_pre == npre
    assert eng.recomputed and all(n > 64 for _rid, n in eng.recomputed)
    assert eng.dispatches["segment"] > 0 and eng.dispatches["prefill"] > 0
    assert got == want


def test_engine_refusals():
    """The paged backend, tensor parallelism, the pipeline and swap-out are
    refused for the three archs (the first two with the reference's
    errors); ``backend="auto"`` resolves to the contiguous path."""
    mesh = make_serving_mesh(2, devices=["cpu", "cpu"])
    for arch in ARCHS:
        _, cfgt, _, nparams = _model(arch)
        tparams = bridge.to_torch(nparams)

        def build(sched_cfg=None, **kw):
            return engine_t.RealEngine(cfgt, tparams, sched_cfg=sched_cfg, device="cpu",
                                       eng_cfg=engine_t.RealEngineConfig(**kw))

        assert not build().paged
        with pytest.raises(ValueError, match="arch cannot run the paged backend"):
            build(backend="paged")
        with pytest.raises(ValueError, match="resolved to the contiguous fallback"):
            build(mesh=mesh)
        with pytest.raises(ValueError, match="pipeline=True requires"):
            build(pipeline=True)
        with pytest.raises(ValueError, match="resumes by recompute"):
            build(SchedulerConfig(swap_on_preempt=True))


def test_calibration_on_the_contiguous_path():
    """``calibrate()`` measures each arch's contiguous dispatches (one
    sequence's prefill chunks, decode batches over SSM states and rings)
    and installs the fitted profile; ``block_bytes`` is 0 for the pure SSM
    stack, and its engine serves a request with it."""
    from repro_torch.core.profiler import CalibrationGrid, MeasuredProfiler, block_bytes

    grid = CalibrationGrid(chunk_sizes=(8,), prefill_batches=(1,), decode_buckets=(1, 2),
                           ctx_fractions=(0.5,), repeats=1, warmup=0, swap_block_counts=())
    for arch in ARCHS:
        eng = _port_engine(arch)
        prof = eng.calibrate(grid)
        assert isinstance(prof, MeasuredProfiler) and eng.sched.model is prof
        assert prof.samples and all(t > 0 for _, t in prof.samples)
    assert block_bytes(_model("mamba2-1.3b")[1], 16) == 0
    eng.submit(RequestT(PriorityT.OFFLINE, prompt_len=20, max_new_tokens=3,
                        prompt=_prompt(eng.cfg.vocab_size, 20, 1)))
    eng.run()
    assert len(eng.sched.finished[0].output_tokens) == 3


# ------------------------------------------------------------- the launcher
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_real_takes_the_arch(arch):
    """``serve --mode real --arch <arch> --device cpu`` on the reduced
    model: the contiguous path, every stream and the batch job finish with
    all their tokens; ``--layers`` cuts the depth by whole periods."""
    from repro_torch.launch import serve

    argv = ["--arch", arch, "--device", "cpu", "--dtype", "float32", "--online", "1",
            "--offline", "2", "--prompt-len", "64", "--max-new", "4"]
    res = serve.run_real(serve.build_parser().parse_args(argv))
    assert res["cfg"].name == f"{arch}-smoke" and not res["engine"].paged
    assert res["job"].done and all(h.finished for h in res["streams"])
    assert all(len(r.output_tokens) == 4 for r in res["job"].requests)
    period = res["cfg"].pattern_period
    cut = serve.model_config(serve.build_parser().parse_args(argv + ["--layers", str(period)]),
                             res["cfg"])
    assert cut.num_layers == period and cut.num_periods == 1
    with pytest.raises(ValueError, match="--layers"):
        serve.model_config(serve.build_parser().parse_args(argv + ["--layers", "3"]),
                           get_config_t("jamba-1.5-large-398b"))


def test_serve_wallclock_and_tp2_refusal(capsys):
    """``--mode wallclock`` on jamba reduced to one period (calibration, the
    threaded runtime); ``--tp 2`` refuses mamba2 with the reference's
    error."""
    from repro_torch.launch import serve

    serve.main(["--mode", "wallclock", "--arch", "jamba-1.5-large-398b", "--device", "cpu",
                "--dtype", "float32", "--duration", "0.5", "--rate", "4", "--offline", "2"])
    out = capsys.readouterr().out
    assert "arch=jamba-1.5-large-398b-smoke" in out and "batch done=True" in out, out
    assert "contiguous path" in out
    with pytest.raises(ValueError, match="requires the paged backend"):
        serve.main(["--mode", "real", "--arch", "mamba2-1.3b", "--device", "cpu", "--dtype",
                    "float32", "--tp", "2", "--online", "1", "--offline", "1"])
