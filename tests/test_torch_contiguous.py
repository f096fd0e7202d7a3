"""The port's contiguous fallback engine and its calibration, on the CPU.

``repro_torch``'s ``RealEngine(backend="contiguous", device="cpu")`` must emit
the greedy tokens of the reference's contiguous ``RealEngine`` on the
differential cases of ``tests/test_backend_differential.py``, with the same
weights, prompts and latency model and the same top-2 margin guard as
``tests/test_torch_engine.py``; within the port, the contiguous and fused
legs emit identical tokens.  Every prefill chunk's flash attention reads
only slots that hold their own positions (the condition under which it
equals the reference's masked attention over the cache).  Calibration
installs a measured profile and leaves the live caches alone.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as get_config_t  # noqa: E402
from repro_torch.core.profiler import BatchShape, CalibrationGrid, MeasuredProfiler  # noqa: E402
from repro_torch.core.request import Priority, Request  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.serving import real_engine as engine_t  # noqa: E402
from test_backend_differential import CASES  # noqa: E402
from test_torch_engine import (  # noqa: E402
    MARGIN_BOUND, _prompt, _run_port, _run_reference, _serve, _weights,
)


@pytest.fixture
def chunk_slots_checked(monkeypatch):
    """Wrap ``layers.write_kv`` so that every multi-token write (a prefill
    chunk at ``off .. off + L - 1``) is followed by a check that the cache
    slots ``0 .. off + L - 1`` hold positions ``0 .. off + L - 1``: what the
    flash attention over ``cache[:, :off + L]`` needs to equal the masked
    attention.  Yields the number of checked writes."""
    orig = tl.write_kv
    seen = []

    def checked(cache, k_new, v_new, positions, valid=None):
        out = orig(cache, k_new, v_new, positions, valid)
        if positions.shape[1] > 1:
            for row, pos in zip(out["pos"], positions):
                end = int(pos[-1]) + 1
                assert torch.equal(row[:end], torch.arange(end, dtype=row.dtype)), (
                    f"slots 0..{end - 1} do not hold their positions: {row[:end].tolist()}")
            seen.append(1)
        return out

    monkeypatch.setattr(tl, "write_kv", checked)
    yield seen


@pytest.mark.parametrize("arch,jobs,preempt_step,eng_kw", CASES)
def test_contiguous_port_emits_reference_contiguous_tokens(
        arch, jobs, preempt_step, eng_kw, chunk_slots_checked):
    kw = dict(eng_kw, backend="contiguous")
    ref, ref_on = _run_reference(arch, jobs, preempt_step, kw)
    got, got_on, eng = _run_port(arch, jobs, preempt_step, kw)
    low = min(min(m) for m in eng.margins.values())
    assert low > MARGIN_BOUND, (
        f"near-tie: a sampled token's top-2 logit margin is {low:.2e} <= "
        f"{MARGIN_BOUND}, so token identity with the reference is not meaningful"
    )
    assert [len(r.output_tokens) for r in got] == [g for _, g in jobs]
    assert [r.output_tokens for r in got] == [r.output_tokens for r in ref]
    assert [r.output_tokens for r in got_on] == [r.output_tokens for r in ref_on]
    npre = sum(r.num_preemptions for r in ref)
    assert sum(r.num_preemptions for r in got) == npre
    if preempt_step is not None:
        assert npre > 0 and eng.restored_blocks > 0
    d = eng.dispatches
    assert not eng.paged and d["prefill"] > 0 and d["decode"] + d["segment"] > 0
    assert d["fused_segment"] == d["fused_logits"] == 0
    assert len(chunk_slots_checked) > 0
    assert not hasattr(eng, "pools") and set(eng.caches) == set()  # all finished
    # the port's fused leg emits the contiguous leg's tokens
    fused, fused_on, _ = _run_port(arch, jobs, preempt_step, eng_kw)
    assert [r.output_tokens for r in fused] == [r.output_tokens for r in got]
    assert [r.output_tokens for r in fused_on] == [r.output_tokens for r in got_on]


def test_contiguous_serve_legs_match_the_fused_path(chunk_slots_checked):
    """``launch.serve`` with ``--backend contiguous`` on a pool small enough
    to preempt (swap or discard, checkpoints, resumes) emits the fused
    path's tokens, and so does an uninterrupted contiguous run."""
    pre, toks = _serve("--num-device-blocks", "56", "--backend", "contiguous")
    eng = pre["engine"]
    assert not eng.paged and pre["preemptions"] > 0 and eng.restored_blocks > 0
    assert eng.ckpt.stats.blocks_checkpointed > 0
    _, fused_toks = _serve("--num-device-blocks", "56")
    calm, calm_toks = _serve("--num-device-blocks", "512", "--backend", "contiguous")
    assert calm["preemptions"] == 0
    assert toks == fused_toks == calm_toks and all(len(t) == 48 for t in toks)


GRID = CalibrationGrid(chunk_sizes=(8, 16), prefill_batches=(1,), decode_buckets=(1, 2),
                       ctx_fractions=(0.5,), repeats=1, warmup=0)


def _engine(**kw):
    cfg = get_config_t("llama-2-7b").reduced()
    return engine_t.RealEngine(
        cfg, bridge.to_torch(_weights("llama-2-7b")[2]), device="cpu",
        eng_cfg=engine_t.RealEngineConfig(backend="contiguous", **kw),
    )


def _jobs(eng):
    reqs = [Request(Priority.OFFLINE, prompt_len=p, max_new_tokens=8,
                    prompt=_prompt(eng.cfg.vocab_size, p, seed))
            for seed, p in enumerate((40, 24, 33, 17))]
    for r in reqs:
        eng.submit(r)
    return reqs


def test_contiguous_calibration_installs_profile_and_keeps_caches():
    plain = _engine()
    reqs = _jobs(plain)
    plain.run()
    eng = _engine()
    got = _jobs(eng)
    for _ in range(3):
        eng.step()
    live = bridge.to_numpy(eng.caches)
    assert live
    prof = eng.calibrate(GRID)
    jax.tree.map(np.testing.assert_array_equal, live, bridge.to_numpy(eng.caches))
    eng.run()
    assert [r.output_tokens for r in got] == [r.output_tokens for r in reqs]
    assert isinstance(prof, MeasuredProfiler)
    assert eng.sched.model is prof and eng.profile is prof
    ctx = int(0.5 * eng.ec.max_model_len)
    want = [BatchShape(prefill_tokens=c, prefill_attn_tokens=c * c / 2.0,
                       prefill_ctx_end=c, num_seqs=1) for c in (8, 16)]
    want += [BatchShape(decode_tokens=b, decode_ctx=b * ctx, num_seqs=b) for b in (1, 2)]
    assert [s for s, _ in prof.samples] == want and all(t > 0 for _, t in prof.samples)
    assert prof.swap_samples == []  # no swap probes, as in the reference
    grid = eng._default_grid()
    assert grid.prefill_batches == (1,) and grid.token_buckets == ()
    assert grid.chunk_sizes == (8, 16, 32)


def test_contiguous_backend_refusals():
    """A windowed (ring-cache) arch resolves to the contiguous backend with
    the checkpointer off (it resumes by recompute), and the paged backend
    refuses it, as in the reference; so does a cross-attention arch, which
    resolves to the contiguous backend and resumes by recompute."""
    cfg = get_config_t("llama-2-7b").reduced()
    params = bridge.to_torch(_weights("llama-2-7b")[2])
    windowed = dataclasses.replace(cfg, sliding_window=8)
    eng = engine_t.RealEngine(windowed, params, device="cpu")  # backend="auto"
    assert not eng.paged and eng.recompute_only and not eng.ckpt.enabled
    cross = dataclasses.replace(cfg, cross_attn_period=2)
    eng = engine_t.RealEngine(cross, params, device="cpu")
    assert not eng.paged and eng.recompute_only and not eng.ckpt.enabled
    with pytest.raises(ValueError, match="paged"):
        engine_t.RealEngine(cross, params, device="cpu",
                            eng_cfg=engine_t.RealEngineConfig(backend="paged"))
    with pytest.raises(ValueError, match="paged"):
        engine_t.RealEngine(windowed, params, device="cpu",
                            eng_cfg=engine_t.RealEngineConfig(backend="paged"))
    eng = engine_t.RealEngine(cfg, params, device="cpu",
                              eng_cfg=engine_t.RealEngineConfig(backend="contiguous",
                                                                fused_batch=True))
    assert not eng.paged and not eng.fused and not eng.blocks.prefix_cache
