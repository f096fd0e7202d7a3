"""The port's other dense and MoE architectures against the JAX package's,
on the CPU.

gemma-7b (GeGLU, tied embeddings), yi-34b and command-r-plus-104b (GQA
llama-family stacks) and olmoe-1b-7b (64 experts, top 8: the MoE FFN of
``repro_torch.models.moe``), each at its ``.reduced()`` size, and gemma-7b
reduced with its published head dim of 256 (``.reduced(head_dim=256)``:
the plain attention versions at the D the card's kernels gained): both
packages compute with the same weights (the reference's
``init_params(cfg, PRNGKey(0))`` carried over by ``repro_torch.bridge``)
and the same numpy inputs, at fp32, through the fused, split and
contiguous entry points and ``forward_full``; ``RealEngine`` emits the
reference engine's greedy tokens on a preemption case, also at tp 2 for
olmoe.  The SSM, hybrid and sliding-window archs are held to the reference
in ``tests/test_torch_recurrent.py``, the VLM and the encoder in
``tests/test_torch_vlm.py`` and ``tests/test_torch_encoder.py``.
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
from repro_torch.launch.mesh import make_serving_mesh  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serving import real_engine as engine_t  # noqa: E402
from test_torch_engine import (  # noqa: E402,F401
    MARGIN_BOUND, _drive, _prompt, reference_checkpoints_written_blocks,
)
from test_torch_model import (  # noqa: E402
    BS, FIELDS, ITEMS, MODEL_TOL, N_BLOCKS, _assert_caches, _assert_pools_close,
    _decode_batch, _pools, _prefill_batch, _ragged_batch, _t,
)

# name -> (registered arch, .reduced() overrides)
VARIANTS = {
    "gemma-7b": ("gemma-7b", {}),
    "gemma-7b-d256": ("gemma-7b", dict(head_dim=256)),
    "yi-34b": ("yi-34b", {}),
    "command-r-plus-104b": ("command-r-plus-104b", {}),
    "olmoe-1b-7b": ("olmoe-1b-7b", {}),
}
ARCHS = list(VARIANTS)


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """One intra-op thread per test, as ``tests/test_torch_tp_engine.py``
    runs its engines: many small operators otherwise spin thread pools
    against the other workers of a parallel run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _model(variant):
    arch, kw = VARIANTS[variant]
    cfg = get_config(arch).reduced(**kw)
    params = jtf.init_params(cfg, jax.random.PRNGKey(0))
    nparams = jax.tree.map(np.asarray, params)
    return cfg, get_config_t(arch).reduced(**kw), params, nparams


def _tparams(variant):
    return bridge.to_torch(_model(variant)[3])


def test_configs_are_the_reference_configs():
    """The seven configs are the reference's, field for field, with their
    published sources, and their parameter counts are the reference's."""
    for arch, src in (("gemma-7b", "arXiv:2403.08295"), ("yi-34b", "arXiv:2403.04652"),
                      ("command-r-plus-104b", "hf:CohereForAI/c4ai-command-r-v01"),
                      ("olmoe-1b-7b", "arXiv:2409.02060"),
                      ("mixtral-8x22b", "arXiv:2401.04088"),
                      ("mamba2-1.3b", "arXiv:2405.21060"),
                      ("jamba-1.5-large-398b", "arXiv:2403.19887")):
        ref, got = get_config(arch), get_config_t(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref) and got.source == src
        assert got.param_count() == ref.param_count()
        assert got.active_param_count() == ref.active_param_count()
    assert round(get_config_t("gemma-7b").param_count() / 1e9, 2) == 8.54
    olmoe = get_config_t("olmoe-1b-7b")
    assert round(olmoe.param_count() / 1e9, 2) == 6.92
    assert olmoe.active_param_count() < olmoe.param_count() / 5


@pytest.mark.parametrize("variant", ARCHS)
def test_init_params_and_bridge_keep_the_reference_layout(variant):
    """The port's own init has the reference's tree, shapes and stacking
    (MoE leaves with the expert axis after the period axis, no ``lm_head``
    where embeddings are tied); the bridge carries the weights over exactly
    and back, and a bf16 cast keeps the router fp32."""
    cfg, cfgt, params, nparams = _model(variant)
    own = ttf.init_params(cfgt, torch.Generator().manual_seed(0))
    shapes = jax.tree.map(lambda a: tuple(a.shape), nparams)
    assert jax.tree.map(lambda t: tuple(t.shape), own) == shapes
    assert ("lm_head" in own) == (not cfg.tie_embeddings)
    back = bridge.to_numpy(bridge.to_torch(nparams))
    jax.tree.map(np.testing.assert_array_equal, nparams, back)
    bf = bridge.to_torch(nparams, dtype=torch.bfloat16)
    own_bf = ttf.init_params(cfgt, torch.Generator().manual_seed(0), dtype=torch.bfloat16)
    for tree in (bf, own_bf):
        ffn = tree["layers"]["0"]["ffn"]
        if cfg.num_experts:
            assert ffn["router"].dtype == torch.float32
            assert ffn["w_up"].shape[:2] == (cfg.num_periods, cfg.num_experts)
        assert ffn["w_up"].dtype == torch.bfloat16


@pytest.mark.parametrize("variant", ARCHS)
def test_run_tokens_paged_logits_and_pools_match_reference(variant):
    cfg, cfgt, params, nparams = _model(variant)
    tparams = _tparams(variant)
    a = _ragged_batch(cfg, ITEMS, 10, 16, seed=6)
    pools = _pools(cfg, 10, 16, 7)
    meta = jl.RaggedMeta(*(jnp.asarray(a[f]) for f in FIELDS))
    want, wpools = jtf.run_tokens_paged(
        cfg, params, jnp.asarray(a["tokens"]), jax.tree.map(jnp.asarray, pools),
        jnp.asarray(a["tables"]), jnp.asarray(a["positions"]), meta,
        jnp.asarray(a["logit_idx"]),
    )
    got, gpools = ttf.run_tokens_paged(
        cfgt, tparams, _t(a["tokens"]), bridge.to_torch(pools), _t(a["tables"]),
        _t(a["positions"]), tl.RaggedMeta(*(_t(a[f]) for f in FIELDS)), _t(a["logit_idx"]),
    )
    s = len(ITEMS)
    np.testing.assert_allclose(got.numpy()[:s], np.asarray(want)[:s], **MODEL_TOL)
    for pos in wpools:
        for kv in ("k", "v"):
            np.testing.assert_allclose(gpools[pos][kv].numpy()[:, :-1],
                                       np.asarray(wpools[pos][kv])[:, :-1], **MODEL_TOL)


@pytest.mark.parametrize("variant", ARCHS)
def test_split_entry_points_match_reference(variant):
    """``prefill_chunk_paged`` on a padded wave, then ``decode_step_paged``
    and the segmented ``run_segment_paged_at`` on the pools it left."""
    cfg, cfgt, params, nparams = _model(variant)
    tparams = _tparams(variant)
    pools = _pools(cfg, N_BLOCKS, BS, 13)
    toks, tables, offs, last = _prefill_batch(cfg.vocab_size, 14)
    want, wpools = jtf.prefill_chunk_paged(
        cfg, params, jnp.asarray(toks), jax.tree.map(jnp.asarray, pools),
        jnp.asarray(tables), jnp.asarray(offs), last_index=jnp.asarray(last))
    got, gpools = ttf.prefill_chunk_paged(cfgt, tparams, _t(toks), bridge.to_torch(pools),
                                          _t(tables), _t(offs), _t(last))
    real = [0, 1, 3]
    np.testing.assert_allclose(got.numpy()[real], np.asarray(want)[real], **MODEL_TOL)
    _assert_pools_close(gpools, wpools, MODEL_TOL)

    dlast, dtables, lens = _decode_batch(cfg.vocab_size, 15)
    seg_pools, wseg = bridge.to_torch(bridge.to_numpy(gpools)), wpools
    want, wpools = jtf.decode_step_paged(cfg, params, jnp.asarray(dlast), wpools,
                                         jnp.asarray(dtables), jnp.asarray(lens))
    got, gpools = ttf.decode_step_paged(cfgt, tparams, _t(dlast), gpools, _t(dtables), _t(lens))
    np.testing.assert_allclose(got.numpy()[:3], np.asarray(want)[:3], **MODEL_TOL)
    _assert_pools_close(gpools, wpools, MODEL_TOL)
    wx = jtf.embed(cfg, params, jnp.asarray(dlast)[:, None])
    x = ttf.embed(cfgt, tparams, _t(dlast)[:, None])
    for lo, pps in ttf.segment_spans(cfgt):
        wx, wseg = jtf.run_segment_paged_at(cfg, params, pps, jnp.int32(lo), wx, wseg,
                                            jnp.asarray(dtables), jnp.asarray(lens[:, None]))
        x, _ = ttf.run_segment_paged_at(cfgt, tparams, pps, lo, x, seg_pools, _t(dtables),
                                        _t(lens)[:, None])
    np.testing.assert_allclose(x.numpy()[:3], np.asarray(wx)[:3], **MODEL_TOL)
    _assert_pools_close(seg_pools, wseg, MODEL_TOL)


@pytest.mark.parametrize("variant", ARCHS)
def test_contiguous_entry_points_match_reference(variant):
    """``forward_full`` (capacity factor 1.25 by default on both sides) with
    emitted caches, ``prefill_chunk`` chunk by chunk, ``decode_step`` and
    ``run_segment`` (1.25 again, as the reference's engine runs it)."""
    cfg, cfgt, params, nparams = _model(variant)
    tparams = _tparams(variant)
    toks = np.random.default_rng(25).integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    want, wfull, waux = jtf.forward_full(cfg, params, jnp.asarray(toks), emit_caches=True,
                                         max_seq=64)
    got, gfull, aux = ttf.forward_full(cfgt, tparams, _t(toks), emit_caches=True, max_seq=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    np.testing.assert_allclose(float(aux), float(waux), atol=1e-6, rtol=1e-5)
    assert (float(aux) > 0) == bool(cfg.num_experts)
    _assert_caches(gfull, wfull, MODEL_TOL)

    wc, gc = jtf.init_caches(cfg, 2, 64), ttf.init_caches(cfgt, 2, 64)
    for lo, hi in ((0, 16), (16, 40)):
        want, wc = jtf.prefill_chunk(cfg, params, jnp.asarray(toks[:, lo:hi]), wc,
                                     jnp.asarray([lo, lo], jnp.int32))
        got, gc = ttf.prefill_chunk(cfgt, tparams, _t(toks[:, lo:hi]), gc, [lo, lo])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    _assert_caches(gc, wc, MODEL_TOL)

    last, lens = toks[:, -1], np.array([40, 40], np.int32)
    seg_caches = bridge.to_torch(bridge.to_numpy(gc))
    want, wc2 = jtf.decode_step(cfg, params, jnp.asarray(last), wc, jnp.asarray(lens))
    got, gc = ttf.decode_step(cfgt, tparams, _t(last), gc, _t(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    _assert_caches(gc, wc2, MODEL_TOL)
    wx = jtf.embed(cfg, params, jnp.asarray(last)[:, None])
    x = ttf.embed(cfgt, tparams, _t(last)[:, None])
    for seg in range(ttf.num_segments(cfgt)):
        wx, wc = jtf.run_segment(cfg, params, seg, wx, wc, mode="decode",
                                 positions=jnp.asarray(lens[:, None]))
        x, _ = ttf.run_segment(cfgt, tparams, seg, x, seg_caches, mode="decode",
                               positions=_t(lens)[:, None])
    np.testing.assert_allclose(x.numpy(), np.asarray(wx), **MODEL_TOL)
    _assert_caches(seg_caches, wc, MODEL_TOL)


# --------------------------------------------------------------- the engine
# an online burst mid-decode under block pressure: eviction and restore
JOBS, PREEMPT_STEP, ENG_KW = [(40, 16)] * 3, 6, dict(num_device_blocks=14)


@functools.lru_cache(maxsize=None)
def _reference_tokens(variant, backend="auto"):
    cfg, _, params, _ = _model(variant)
    eng = RealEngine(cfg, params, eng_cfg=RealEngineConfig(backend=backend, **ENG_KW))

    def mk(on, plen, gen, seed):
        return Request(Priority.ONLINE if on else Priority.OFFLINE, prompt_len=plen,
                       max_new_tokens=gen, prompt=_prompt(cfg.vocab_size, plen, seed))

    reqs, online = _drive(eng, mk, JOBS, PREEMPT_STEP)
    return ([r.output_tokens for r in reqs + online],
            sum(r.num_preemptions for r in reqs))


def _port_tokens(variant, mesh=None, backend="auto"):
    _, cfgt, _, _ = _model(variant)
    eng = engine_t.RealEngine(
        cfgt, _tparams(variant), device="cpu",
        eng_cfg=engine_t.RealEngineConfig(mesh=mesh, backend=backend, **ENG_KW))
    # the reference's prior latency model, so both schedulers plan alike
    eng.sched.model = AnalyticalCostModel(cfgt, HardwareSpec(**dataclasses.asdict(TPU_V5E)))
    eng.margins = {}

    def mk(on, plen, gen, seed):
        return RequestT(PriorityT.ONLINE if on else PriorityT.OFFLINE, prompt_len=plen,
                        max_new_tokens=gen, prompt=_prompt(cfgt.vocab_size, plen, seed))

    reqs, online = _drive(eng, mk, JOBS, PREEMPT_STEP)
    low = min(min(m) for m in eng.margins.values())
    assert low > MARGIN_BOUND, (
        f"near-tie: a sampled token's top-2 logit margin is {low:.2e} <= {MARGIN_BOUND}")
    return [r.output_tokens for r in reqs + online], sum(r.num_preemptions for r in reqs), eng


@pytest.mark.parametrize("variant", ["gemma-7b", "yi-34b", "command-r-plus-104b",
                                     "olmoe-1b-7b"])
def test_engine_emits_reference_tokens_under_preemption(variant):
    want, npre = _reference_tokens(variant)
    got, got_pre, eng = _port_tokens(variant)
    assert npre > 0 and got_pre == npre, "the case must preempt, as in the reference"
    assert eng.restored_blocks > 0 and eng.ckpt_gathers > 0
    assert got == want


def test_olmoe_contiguous_engine_emits_reference_tokens(reference_checkpoints_written_blocks):
    """The contiguous path's segmented decode routes at capacity factor 1.25,
    as the reference's engine runs ``run_segment``, while its prefill chunks
    and the paged paths are dropless: the port emits the reference's
    contiguous tokens, drops included.  On this case a request is preempted
    with its context at a block boundary, where the reference's checkpoint
    fault (the fixture) would restore a stale slot: the reference runs with
    that fault repaired, as the port runs."""
    cfg, _, params, _ = _model("olmoe-1b-7b")
    ref = RealEngine(cfg, params, eng_cfg=RealEngineConfig(backend="contiguous", **ENG_KW))

    def mk(on, plen, gen, seed):
        return Request(Priority.ONLINE if on else Priority.OFFLINE, prompt_len=plen,
                       max_new_tokens=gen, prompt=_prompt(cfg.vocab_size, plen, seed))

    reqs, online = _drive(ref, mk, JOBS, PREEMPT_STEP)
    want, npre = [r.output_tokens for r in reqs + online], sum(r.num_preemptions for r in reqs)
    got, got_pre, eng = _port_tokens("olmoe-1b-7b", backend="contiguous")
    assert not eng.paged and npre > 0 and got_pre == npre
    assert eng.dispatches["segment"] > 0
    assert got == want


def test_olmoe_at_tp2_emits_reference_tokens():
    """The MoE stack over two CPU shards of the KV heads (params replicate,
    the pools shard by KV heads, as for Llama)."""
    mesh = make_serving_mesh(2, devices=["cpu", "cpu"])
    got, _, eng = _port_tokens("olmoe-1b-7b", mesh=mesh)
    assert eng.mesh is mesh and all(p.shape[-2] == 2 for p in eng.pools["0"]["k"].parts)
    assert got == _reference_tokens("olmoe-1b-7b")[0]


def test_olmoe_prior_and_calibration():
    """The prior latency model prices a MoE model by its active parameters
    (top 8 of 64 experts), and ``calibrate()`` measures the MoE engine's own
    dispatches on the three paths and installs the fitted profile."""
    from repro_torch.core.profiler import BatchShape, CalibrationGrid, MeasuredProfiler

    cfgt = get_config_t("olmoe-1b-7b")
    prior = AnalyticalCostModel(cfgt, HardwareSpec(**dataclasses.asdict(TPU_V5E)))
    assert prior.active_params == cfgt.active_param_count() < cfgt.param_count()
    assert prior.iter_time(BatchShape(decode_tokens=8, decode_ctx=8 * 128, num_seqs=8)) > 0
    grid = CalibrationGrid(chunk_sizes=(8,), prefill_batches=(1,), decode_buckets=(1, 2),
                           ctx_fractions=(0.5,), repeats=1, warmup=0, swap_block_counts=())
    _, small, _, _ = _model("olmoe-1b-7b")
    for kw in (dict(), dict(fused_batch=False), dict(backend="contiguous")):
        eng = engine_t.RealEngine(small, _tparams("olmoe-1b-7b"), device="cpu",
                                  eng_cfg=engine_t.RealEngineConfig(**kw))
        prof = eng.calibrate(grid)
        assert isinstance(prof, MeasuredProfiler) and eng.sched.model is prof
        assert prof.samples and all(t > 0 for _, t in prof.samples)


# ------------------------------------------------------------- the launcher
@pytest.mark.parametrize("arch", ["gemma-7b", "yi-34b", "command-r-plus-104b", "olmoe-1b-7b"])
def test_serve_real_takes_the_arch(arch, capsys):
    """``serve --mode real --arch <arch> --device cpu`` on the reduced
    model: every stream and the batch job finish with all their tokens."""
    from repro_torch.launch import serve

    res = serve.run_real(serve.build_parser().parse_args(
        ["--arch", arch, "--device", "cpu", "--dtype", "float32", "--online", "1",
         "--offline", "2", "--prompt-len", "64", "--max-new", "4"]))
    assert res["cfg"].name == f"{arch}-smoke"
    assert res["job"].done and all(h.finished for h in res["streams"])
    assert all(len(r.output_tokens) == 4 for r in res["job"].requests)


def test_serve_wallclock_and_tp2_take_olmoe(capsys):
    """``--mode wallclock`` (calibration, the threaded runtime) and
    ``--mode real --tp 2`` on two CPU shards, on olmoe-1b-7b reduced."""
    from repro_torch.launch import serve

    serve.main(["--mode", "wallclock", "--arch", "olmoe-1b-7b", "--device", "cpu",
                "--dtype", "float32", "--duration", "0.5", "--rate", "4", "--offline", "2"])
    out = capsys.readouterr().out
    assert "arch=olmoe-1b-7b-smoke" in out and "batch done=True" in out, out
    serve.main(["--mode", "real", "--arch", "olmoe-1b-7b", "--device", "cpu", "--dtype",
                "float32", "--tp", "2", "--online", "1", "--offline", "2", "--prompt-len",
                "64", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "arch=olmoe-1b-7b-smoke" in out and "tp=2" in out, out
