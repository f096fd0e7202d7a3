"""Tensor-parallel paged serving in the port (DESIGN.md §11), on the CPU.

The port's ``RealEngine(device="cpu")`` over a mesh of CPU shards
(``make_serving_mesh(tp, devices=["cpu"] * tp)``) against the reference's
fused engine on its serving mesh and against the port at tp = 1, with the
same weights and prompts and the reference's prior latency model:

* the six differential cases at tp = 2, and the Qwen2 cases at tp = 4 too,
  where its 2 KV heads do not divide and the pool replicates; the split
  path at tp = 2 against the fused path;
* the counterparts of the reference's sharded-pool, paged-only and
  calibration tests (``tests/test_backend_differential.py``);
* the ``HostKVStore``'s blocks under forced preemption at tp = 2 against
  tp = 1's, step by step;
* a ManualClock runtime trace with a safepoint abort at tp = 2 against
  tp = 1;
* ``serve --mode real --tp 2 --device cpu`` and ``--mode wallclock --tp 2``.
"""
import dataclasses
import functools

import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.core.profiler import TPU_V5E  # noqa: E402
from repro.launch.mesh import make_serving_mesh as ref_mesh  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.profiler import AnalyticalCostModel, BatchShape, CalibrationGrid  # noqa: E402
from repro_torch.core.profiler import HardwareSpec  # noqa: E402
from repro_torch.core.request import Priority, Request  # noqa: E402
from repro_torch.core.slo import SLO  # noqa: E402
from repro_torch.distributed.sharding import HeadSharded  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.mesh import make_serving_mesh  # noqa: E402
from repro_torch.serving.real_engine import RealEngine, RealEngineConfig  # noqa: E402
from repro_torch.serving.runtime import CoServingRuntime, ManualClock  # noqa: E402
from test_backend_differential import CASES, _tp  # noqa: E402
from test_torch_engine import MARGIN_BOUND, _drive, _prompt, _run_reference, _weights  # noqa: E402


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """One intra-op thread per test: the engines here run many small
    operators, whose thread pools otherwise spin against the other
    workers of a parallel test run (``tests/test_torch_gateway.py`` does
    the same for its threaded serve)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(tp):
    return make_serving_mesh(tp, devices=["cpu"] * tp) if tp > 1 else None


def engine(arch, tp, **eng_kw):
    cfg = get_config(arch).reduced()
    eng = RealEngine(cfg, bridge.to_torch(_weights(arch)[2]), device="cpu",
                     eng_cfg=RealEngineConfig(mesh=cpu_mesh(tp), **eng_kw))
    # the reference's prior latency model, so both schedulers plan alike
    eng.sched.model = AnalyticalCostModel(cfg, HardwareSpec(**dataclasses.asdict(TPU_V5E)))
    eng.margins = {}
    return eng


def run_port(arch, jobs, preempt_step, eng_kw, tp):
    eng = engine(arch, tp, **eng_kw)

    def mk(on, plen, gen, seed):
        return Request(Priority.ONLINE if on else Priority.OFFLINE, prompt_len=plen,
                       max_new_tokens=gen, prompt=_prompt(eng.cfg.vocab_size, plen, seed))

    reqs, online = _drive(eng, mk, jobs, preempt_step)
    low = min(min(m) for m in eng.margins.values())
    assert low > MARGIN_BOUND, f"near-tie: a top-2 logit margin of {low:.2e}"
    return [r.output_tokens for r in reqs + online], sum(r.num_preemptions for r in reqs), eng


@functools.lru_cache(maxsize=None)
def reference_tokens(case):
    arch, jobs, preempt_step, eng_kw = CASES[case]
    reqs, online = _run_reference(arch, jobs, preempt_step,
                                  dict(eng_kw, mesh=ref_mesh(_tp())))
    return [r.output_tokens for r in reqs + online], sum(r.num_preemptions for r in reqs)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_tp_engine_emits_reference_tokens(case):
    """tp = 2 (and tp = 4 for Qwen2) fused emits the reference's fused
    tokens and the port's tp = 1 tokens; tp = 2 split emits the fused
    tokens; every leg preempts alike."""
    arch, jobs, preempt_step, eng_kw = CASES[case]
    want, npre = reference_tokens(case)
    one, npre1, _ = run_port(arch, jobs, preempt_step, eng_kw, tp=1)
    assert one == want and npre1 == npre
    tps = (2, 4) if arch == "qwen2-0.5b" else (2,)
    for tp in tps:
        got, npre_tp, eng = run_port(arch, jobs, preempt_step, eng_kw, tp=tp)
        assert got == want, f"tp={tp} fused diverged from the reference"
        assert npre_tp == npre
        assert eng.dispatches["fused_segment"] > 0
    split, npre_split, eng = run_port(arch, jobs, preempt_step,
                                      dict(eng_kw, fused_batch=False), tp=2)
    assert split == want and npre_split == npre
    assert eng.dispatches["prefill"] > 0 and eng.dispatches["fused_segment"] == 0
    if preempt_step is not None:
        assert npre > 0 and eng.restored_blocks > 0


@pytest.mark.parametrize("arch,tp", [("llama-2-7b", 2), ("llama-2-7b", 4),
                                     ("qwen2-0.5b", 2), ("qwen2-0.5b", 4)])
def test_sharded_pool_is_actually_sharded(arch, tp):
    """Each shard's pool holds Hkv / tp heads where tp divides Hkv, and the
    whole head axis where it does not (a replica per device: shards on one
    device share it); params are placed once per distinct device."""
    eng = engine(arch, tp)
    hkv = eng.cfg.num_kv_heads
    leaf = eng.pools["0"]["k"]
    assert isinstance(leaf, HeadSharded) and leaf.heads == hkv
    if hkv % tp == 0:
        assert leaf.sharded and [p.shape[3] for p in leaf.parts] == [hkv // tp] * tp
        assert len({p.data_ptr() for p in leaf.parts}) == tp
    else:
        assert not leaf.sharded and [p.shape[3] for p in leaf.parts] == [hkv] * tp
        assert len({p.data_ptr() for p in leaf.parts}) == 1
    assert all(p.shape[:3] == eng.pools["0"]["k"].shape[:3] for p in leaf.parts)
    assert all(a is eng.params for a in eng.shard_params)


def test_mesh_requires_paged_backend():
    cfg = get_config("llama-2-7b").reduced()
    params = bridge.to_torch(_weights("llama-2-7b")[2])
    with pytest.raises(ValueError, match="paged backend"):
        RealEngine(cfg, params, device="cpu",
                   eng_cfg=RealEngineConfig(backend="contiguous", mesh=cpu_mesh(2)))
    # a mesh without tp devices (the reference: without a "model" axis)
    with pytest.raises(ValueError, match="tp devices"):
        RealEngine(cfg, params, device="cpu", eng_cfg=RealEngineConfig(mesh=object()))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
def test_sharded_calibration_runs(fused):
    """calibrate() on a mesh: every probe is the sharded dispatch, and the
    fitted profile installs as the scheduler's latency model."""
    eng = engine("llama-2-7b", 2, fused_batch=fused)
    prof = eng.calibrate(CalibrationGrid(
        chunk_sizes=(8,), decode_buckets=(1, 2), ctx_fractions=(0.25,), repeats=1,
        swap_block_counts=(1,), token_buckets=(64,) if fused else ()))
    assert eng.sched.model is prof
    assert prof.iter_time(BatchShape(decode_tokens=2, decode_ctx=64, num_seqs=2)) > 0.0


def test_host_store_blocks_are_mesh_independent():
    """Under forced preemption, the HostKVStore holds after every step the
    same blocks, every KV head of each, at tp = 2 as at tp = 1."""
    arch, jobs, preempt_step, eng_kw = CASES[2]  # burst mid-decode, 14 blocks
    engs = [engine(arch, tp, **eng_kw) for tp in (1, 2)]
    reqs = [[Request(Priority.OFFLINE, prompt_len=p, max_new_tokens=g,
                     prompt=_prompt(eng.cfg.vocab_size, p, seed))
             for seed, (p, g) in enumerate(jobs)] for eng in engs]
    for eng, mine in zip(engs, reqs):
        for r in mine:
            eng.submit(r)
    compared = 0
    for step in range(200):
        if step == preempt_step:
            for eng, mine in zip(engs, reqs):
                for s in range(2):
                    mine.append(Request(Priority.ONLINE, prompt_len=60, max_new_tokens=8,
                                        prompt=_prompt(eng.cfg.vocab_size, 60, 100 + s)))
                    eng.on_online_arrival(mine[-1])
        alive = [eng.step() for eng in engs]
        assert alive[0] == alive[1]
        if not alive[0]:
            break
        for r1, r2 in zip(*reqs):  # the same request in each engine
            for idx in range(8):
                x, y = (eng.host.get(r.request_id, idx) for eng, r in zip(engs, (r1, r2)))
                assert (x is None) == (y is None)
                for pos in x or {}:
                    for kv in ("k", "v"):
                        assert y[pos][kv].shape[-2] == engs[0].cfg.num_kv_heads
                        # the same projections, written per shard: exact
                        assert torch.equal(x[pos][kv], y[pos][kv])
                        compared += 1
    assert compared > 0 and engs[1].restored_blocks == engs[0].restored_blocks > 0
    assert [r.output_tokens for r in reqs[0]] == [r.output_tokens for r in reqs[1]]


def test_runtime_trace_with_safepoint_abort_matches_tp1():
    """The wall-clock runtime is mesh-oblivious: a ManualClock replay whose
    first online arrival aborts a pure-offline decode at a safepoint emits
    the same tokens, aborts and preemptions at tp = 2 as at tp = 1."""
    from test_torch_runtime import DIFF_JOBS, DIFF_ONLINE

    out = []
    for tp in (1, 2):
        eng = engine("llama-2-7b", tp, max_model_len=128, num_device_blocks=14)
        eng.sched.slo = SLO(ttft=0.0, tpot=10.0)

        def make(on, plen, gen, t, seed):
            return Request(Priority.ONLINE if on else Priority.OFFLINE, prompt_len=plen,
                           max_new_tokens=gen, arrival_time=t,
                           prompt=_prompt(eng.cfg.vocab_size, plen, seed))

        reqs = [make(False, p, g, 0.0, s) for s, (p, g) in enumerate(DIFF_JOBS)]
        reqs += [make(True, p, g, t, 100 + s) for s, (t, p, g) in enumerate(DIFF_ONLINE)]
        rt = CoServingRuntime(eng, clock=ManualClock(auto_tick=1e-3))
        m = rt.replay(reqs)
        out.append(([r.output_tokens for r in reqs], rt.stats.safepoint_aborts,
                    sum(r.num_preemptions for r in reqs), m.num_finished))
    assert out[1] == out[0] and out[0][1] >= 1 and out[0][2] >= 1


def test_serve_tp_on_the_cpu(capsys):
    """``serve --mode real --tp 2 --device cpu`` serves the reduced model on
    two CPU shards with the tokens of tp = 1, under forced preemption; the
    wall-clock mode takes ``--tp`` too."""
    argv = ("--device cpu --dtype float32 --online 2 --offline 4 --prompt-len 256 "
            "--max-new 8 --online-after 2 --num-device-blocks 12").split()
    runs = []
    for tp in ("1", "2"):
        res = serve.run_real(serve.build_parser().parse_args(argv + ["--tp", tp]))
        runs.append(([h.request.output_tokens for h in res["streams"]]
                     + [r.output_tokens for r in res["job"].requests], res["preemptions"]))
        assert (res["engine"].mesh is None) == (tp == "1")
    assert runs[0] == runs[1] and runs[0][1] > 0
    serve.main(argv + ["--mode", "real", "--tp", "2"])
    assert "tp=2" in capsys.readouterr().out
    serve.main(["--mode", "wallclock", "--device", "cpu", "--dtype", "float32", "--tp", "2",
                "--duration", "0.5", "--rate", "4", "--offline", "2"])
    out = capsys.readouterr().out
    assert "tp=2" in out and "batch done=True" in out, out
