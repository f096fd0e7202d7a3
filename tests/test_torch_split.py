"""The port's split serving path and its calibration, on the CPU.

``repro_torch``'s ``RealEngine(fused_batch=False, device="cpu")`` must emit
the greedy tokens of the reference's split ``RealEngine`` on the differential
cases of ``tests/test_backend_differential.py``, with the same weights,
prompts and latency model and the same top-2 margin guard as
``tests/test_torch_engine.py``; within the port, the split and fused legs
emit identical tokens.  ``RealEngine.calibrate`` must install a measured
profile built from every probe of its grid, leave live KV alone, and leave
the tokens of a run unchanged.
"""
import dataclasses

import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as get_config_t  # noqa: E402
from repro_torch.core.profiler import BatchShape, CalibrationGrid, MeasuredProfiler  # noqa: E402
from repro_torch.core.request import Priority, Request  # noqa: E402
from repro_torch.serving import real_engine as engine_t  # noqa: E402
from test_backend_differential import CASES  # noqa: E402
from test_torch_engine import MARGIN_BOUND, _prompt, _run_port, _run_reference, _weights  # noqa: E402


@pytest.mark.parametrize("arch,jobs,preempt_step,eng_kw", CASES)
def test_split_port_emits_reference_split_tokens(arch, jobs, preempt_step, eng_kw):
    split_kw = dict(eng_kw, fused_batch=False)
    ref, ref_on = _run_reference(arch, jobs, preempt_step, split_kw)
    got, got_on, eng = _run_port(arch, jobs, preempt_step, split_kw)
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
        assert npre > 0 and eng.restored_blocks > 0 and eng.ckpt_gathers > 0
    d = eng.dispatches
    assert d["prefill"] > 0 and d["decode"] + d["segment"] > 0
    assert d["fused_segment"] == d["fused_logits"] == 0
    # the port's fused leg emits the split leg's tokens
    fused, fused_on, feng = _run_port(arch, jobs, preempt_step, eng_kw)
    assert feng.dispatches["prefill"] == feng.dispatches["decode"] == 0
    assert [r.output_tokens for r in fused] == [r.output_tokens for r in got]
    assert [r.output_tokens for r in fused_on] == [r.output_tokens for r in got_on]


GRID = CalibrationGrid(chunk_sizes=(8, 16), prefill_batches=(1, 2), decode_buckets=(1, 2),
                       ctx_fractions=(0.5,), repeats=1, warmup=0, swap_block_counts=(1, 2))


def _engine(fused):
    cfg = get_config_t("llama-2-7b").reduced()
    return engine_t.RealEngine(
        cfg, bridge.to_torch(_weights("llama-2-7b")[2]), device="cpu",
        eng_cfg=engine_t.RealEngineConfig(fused_batch=fused),
    )


def _serve(eng, calibrate_after=None):
    """Four offline jobs; calibrate after ``calibrate_after`` steps."""
    reqs = [Request(Priority.OFFLINE, prompt_len=p, max_new_tokens=8,
                    prompt=_prompt(eng.cfg.vocab_size, p, seed))
            for seed, p in enumerate((40, 24, 33, 17))]
    for r in reqs:
        eng.submit(r)
    prof = None
    if calibrate_after is not None:
        for _ in range(calibrate_after):
            eng.step()
        live = {(pos, kv): eng.pools[pos][kv][:, :eng._scratch_block].clone()
                for pos, kv in eng._leaves()}
        grid = dataclasses.replace(GRID, token_buckets=(64,) if eng.fused else ())
        prof = eng.calibrate(grid)
        for (pos, kv), before in live.items():  # probes touch only the scratch row
            assert torch.equal(eng.pools[pos][kv][:, :eng._scratch_block], before)
    eng.run()
    return [r.output_tokens for r in reqs], prof


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
def test_calibrate_installs_measured_profile_and_keeps_tokens(fused):
    plain, _ = _serve(_engine(fused))
    eng = _engine(fused)
    got, prof = _serve(eng, calibrate_after=3)
    assert got == plain and all(len(t) == 8 for t in got)
    assert isinstance(prof, MeasuredProfiler)
    assert eng.sched.model is prof and eng.profile is prof
    ctx = int(0.5 * eng.ec.max_model_len)
    want = [BatchShape(prefill_tokens=b * c, prefill_attn_tokens=b * c * c / 2.0,
                       prefill_ctx_end=b * c, num_seqs=b) for b in (1, 2) for c in (8, 16)]
    want += [BatchShape(decode_tokens=b, decode_ctx=b * ctx, num_seqs=b) for b in (1, 2)]
    if fused:  # one mixed point: a 32-token chunk and 32 decode rows at ctx
        want.append(BatchShape(prefill_tokens=32, prefill_attn_tokens=512.0,
                               prefill_ctx_end=32, decode_tokens=32, decode_ctx=32 * ctx,
                               num_seqs=33))
    assert [s for s, _ in prof.samples] == want
    assert all(t > 0 for _, t in prof.samples)
    assert [n for n, _ in prof.swap_samples] == [
        k * eng.ckpt.bytes_per_block for k in GRID.swap_block_counts]
    assert prof.iter_time(want[0]) > 0


def test_default_grid_covers_the_serve_time_buckets():
    """With no grid, calibration probes every bucket serving can dispatch:
    chunk buckets 8..chunk size, decode batches up to ``max_batch_seqs``,
    prefill groups up to ``max_prefill_batch``; mixed points only when fused."""
    split, fused = _engine(False), _engine(True)
    g = split._default_grid()
    assert g.chunk_sizes == (8, 16, 32)
    assert g.prefill_batches == (1, 2, 4, 8)
    assert g.decode_buckets == tuple(2**i for i in range(9))  # up to 256
    assert g.token_buckets == () and fused._default_grid().token_buckets == (64, 128)
    with pytest.raises(NotImplementedError, match="Queue 1: the async pipeline"):
        split.calibrate(dataclasses.replace(GRID, pipeline_depth=4))
