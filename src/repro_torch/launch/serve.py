"""Serving launcher of the PyTorch port: ``--mode real`` and ``--mode wallclock``.

Both build the port's ``RealEngine`` on a CUDA card (``--device cpu`` to run
on the CPU) with random weights drawn from ``--seed``.  Without ``--full``
the config is the ``.reduced()`` smoke variant; with it, the published width
and depth.  ``--no-fused-batch`` serves through the split per-family
dispatches instead of the fused ragged batch; ``--backend contiguous``
serves from contiguous per-request caches instead of the paged pool (its
prefill chunks run the flash attention kernel).

* ``real``: a ``Frontend`` in front of the engine; online streams and one
  offline batch job are submitted from this thread between engine steps,
  and the engine runs until both are done.  ``--calibrate`` measures the
  engine's dispatches on the device and installs the fitted latency model
  before serving.
* ``wallclock``: the full serving stack.  The engine is calibrated first
  (the TTFT SLO defaults to 3x the calibrated time of one 32-token chunk),
  then ``CoServingRuntime`` runs its loop on a background thread while this
  (the API) thread submits one offline batch and replays a gamma-arrival
  online trace live against the wall clock through a ``Frontend``: per-token
  streams with a consumer thread each, bounded admission under
  ``--backpressure``, the metrics registry (``--metrics`` prints it,
  ``--metrics-port`` serves it on 127.0.0.1 with ``/health``).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --mode real --full
  PYTHONPATH=src python -m repro_torch.launch.serve --mode real --full \
      --no-fused-batch --calibrate
  PYTHONPATH=src python -m repro_torch.launch.serve --mode real --full \
      --backend contiguous
  PYTHONPATH=src python -m repro_torch.launch.serve --mode real \
      --device cpu --dtype float32 --online 2 --offline 4 --max-new 8
  PYTHONPATH=src python -m repro_torch.launch.serve --mode wallclock --full \
      --duration 20 --rate 2 --offline 16 --metrics-port 9400
  PYTHONPATH=src python -m repro_torch.launch.serve --mode wallclock \
      --device cpu --dtype float32 --duration 2 --rate 3 --offline 6
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama-2-7b")
    ap.add_argument("--mode", choices=["real", "wallclock"], default="real")
    ap.add_argument("--full", action="store_true",
                    help="the config at its published width (default: reduced)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=sorted(_DTYPES), default="bfloat16")
    ap.add_argument("--online", type=int, default=4)
    ap.add_argument("--offline", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=1024)
    ap.add_argument("--max-new", type=int, default=128)
    ap.add_argument("--num-device-blocks", type=int, default=256)
    ap.add_argument("--online-after", type=int, default=0,
                    help="engine steps to run before the online streams "
                         "arrive (0: they arrive first)")
    ap.add_argument("--no-prefix-cache", action="store_true")
    ap.add_argument("--no-fused-batch", action="store_true",
                    help="the split prefill / decode dispatches "
                         "(RealEngineConfig(fused_batch=False))")
    ap.add_argument("--backend", choices=["auto", "paged", "contiguous"], default="auto",
                    help="KV layout: the paged pool ('auto' and 'paged' here) or "
                         "contiguous per-request caches")
    ap.add_argument("--calibrate", action="store_true",
                    help="calibrate the latency model on the device first")
    ap.add_argument("--seed", type=int, default=0)
    # tensor-parallel mesh size: not ported, any value above 1 raises
    ap.add_argument("--tp", type=int, default=1)
    # wallclock: the online trace and the SLO
    ap.add_argument("--duration", type=float, default=120.0,
                    help="seconds of online arrivals (wallclock)")
    ap.add_argument("--rate", type=float, default=2.0,
                    help="online arrivals per second (wallclock)")
    ap.add_argument("--cv", type=float, default=1.0,
                    help="coefficient of variation of the arrival gaps (wallclock)")
    ap.add_argument("--ttft", type=float, default=None,
                    help="TTFT SLO in s (wallclock default: 3x the calibrated "
                         "time of one 32-token chunk)")
    ap.add_argument("--tpot", type=float, default=0.110, help="TPOT SLO in s")
    # wallclock gateway surface (DESIGN.md §15)
    ap.add_argument("--backpressure",
                    choices=["queue-with-timeout", "reject-fast"],
                    default="queue-with-timeout",
                    help="ingress policy: block-to-deadline (503) or "
                         "reject at capacity (429)")
    ap.add_argument("--max-queued-online", type=int, default=64)
    ap.add_argument("--max-queued-offline", type=int, default=256)
    ap.add_argument("--queue-timeout", type=float, default=2.0,
                    help="queue-with-timeout deadline (s)")
    ap.add_argument("--metrics", action="store_true",
                    help="print the metrics registry at the end of the run")
    ap.add_argument("--metrics-port", type=int, default=0,
                    help="serve the metrics registry as text on "
                         "127.0.0.1:PORT while running")
    return ap


def build_real_engine(args):
    """``--mode real``'s config, weights and engine (calibrated with
    ``--calibrate``): ``(cfg, engine)``."""
    from ..configs import get_config
    from ..models import transformer as tf
    from ..serving.real_engine import RealEngine, RealEngineConfig, resolve_device

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = tf.init_params(cfg, gen, dtype=_DTYPES[args.dtype])
    eng = RealEngine(
        cfg, params,
        eng_cfg=RealEngineConfig(
            # size the KV capacity to the requested lengths (the longest job
            # is prompt_len // 4 prompt tokens + max_new generated)
            max_model_len=max(256, args.prompt_len // 4 + args.max_new),
            num_device_blocks=args.num_device_blocks,
            prefix_cache=not args.no_prefix_cache,
            fused_batch=not args.no_fused_batch,
            backend=args.backend,
        ),
        device=device,
    )
    if args.calibrate:
        eng.calibrate()
    return cfg, eng


def real_prompts(args, cfg):
    """``--mode real``'s prompts from ``--seed``: ``--online`` of
    ``prompt_len // 8`` tokens, then ``--offline`` of ``prompt_len // 4``."""
    rng = np.random.default_rng(args.seed)

    def prompt(n):
        return rng.integers(0, cfg.vocab_size, n).astype(np.int32)

    online = [prompt(args.prompt_len // 8) for _ in range(args.online)]
    offline = [prompt(args.prompt_len // 4) for _ in range(args.offline)]
    return online, offline


def run_real(args, *, record_margins: bool = False) -> dict:
    """Serve the workload; returns the engine, the handles and the timing.
    ``record_margins`` keeps each sampled token's top-1 minus top-2 logit in
    ``engine.margins``."""
    from ..serving.api import Frontend

    cfg, eng = build_real_engine(args)
    if record_margins:
        eng.margins = {}
    fe = Frontend(eng)
    online, offline = real_prompts(args, cfg)
    t0 = time.perf_counter()
    if args.online_after > 0:
        job = fe.submit_batch(offline, max_new_tokens=args.max_new)
        eng.run(max_steps=args.online_after)
        streams = [fe.stream(p, args.max_new) for p in online]
    else:
        streams = [fe.stream(p, args.max_new) for p in online]
        job = fe.submit_batch(offline, max_new_tokens=args.max_new)
    eng.run()
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    seconds = time.perf_counter() - t0
    reqs = [h.request for h in streams] + list(job.requests)
    generated = sum(len(r.output_tokens) for r in reqs)
    return {
        "cfg": cfg, "engine": eng, "streams": streams, "job": job,
        "seconds": seconds, "generated": generated,
        "preemptions": sum(r.num_preemptions for r in reqs),
    }


def metrics_server(registry, port: int, health_cb=None):
    """Serve ``MetricsRegistry.render_text`` over HTTP (stdlib only) from a
    daemon thread -- the ``--metrics-port`` text endpoint (DESIGN.md §15).
    Snapshots never block the engine thread, so scraping under load is
    safe by construction.

    With ``health_cb`` (``CoServingRuntime.check_health``), ``GET /health``
    reports the runtime's health state machine (DESIGN.md §16): 200 for
    HEALTHY/DEGRADED (degraded still serves), 503 for FAILED -- the shape a
    load balancer's probe wants.  Every other path serves the metrics.
    The handler threads touch host state only (the registry, the health
    state), never the device.  Returns the server; ``shutdown()`` and
    ``server_close()`` stop it."""
    import http.server
    import threading

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (stdlib API name)
            if self.path.rstrip("/") == "/health" and health_cb is not None:
                health, age = health_cb()
                body = (
                    f"health {health.name}\nheartbeat_age_seconds {age:.3f}\n"
                ).encode()
                code = 503 if health.name == "FAILED" else 200
            else:
                body = registry.render_text().encode()
                code = 200
            self.send_response(code)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet access log
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", port), Handler)
    threading.Thread(
        target=srv.serve_forever, name="metrics-http", daemon=True
    ).start()
    return srv


def wallclock_model(args):
    """``--mode wallclock``'s config and random weights: the published
    width with ``--full``, else the reference's 4-layer reduced variant with
    a safepoint after every layer.  Returns ``(cfg, params)``."""
    from ..configs import get_config
    from ..models import transformer as tf
    from ..serving.real_engine import resolve_device

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced(num_layers=4, safepoint_interval=1)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    return cfg, tf.init_params(cfg, gen, dtype=_DTYPES[args.dtype])


def wallclock_engine(cfg, params, args, max_model_len: int = 128):
    """An engine with the reference's wall-clock serving settings: 32-token
    chunks, SLO-aware budgets, at most 8 sequences per iteration and 4
    chunks per split prefill dispatch, ``max_model_len`` tokens of context.
    Not calibrated: ``calibrate_wallclock`` does that."""
    from ..core.scheduler import SchedulerConfig
    from ..serving.real_engine import RealEngine, RealEngineConfig

    return RealEngine(
        cfg, params,
        sched_cfg=SchedulerConfig(
            chunk_size=32, slo_aware=True, avg_ctx_estimate=64,
            max_batch_seqs=8,
        ),
        eng_cfg=RealEngineConfig(
            max_model_len=max_model_len,
            num_device_blocks=args.num_device_blocks, max_prefill_batch=4,
            prefix_cache=not args.no_prefix_cache,
            fused_batch=not args.no_fused_batch, backend=args.backend,
        ),
        device=args.device,
    )


def calibrate_wallclock(eng, args) -> float:
    """Calibrate ``eng`` on its device and set its SLO: TTFT ``--ttft``, or
    3x the calibrated time of one 32-token chunk; TPOT ``--tpot``.  Returns
    that chunk time in s."""
    from ..core.profiler import BatchShape
    from ..core.slo import SLO

    prof = eng.calibrate()
    t_chunk = prof.iter_time(BatchShape(
        prefill_tokens=32, prefill_attn_tokens=512.0, prefill_ctx_end=32,
        num_seqs=1,
    ))
    eng.sched.slo = SLO(ttft=args.ttft or 3 * t_chunk, tpot=args.tpot)
    return t_chunk


def run_wallclock(args) -> dict:
    """Calibrated wall-clock co-serving: engine thread + API thread, with
    the gateway surface live -- per-token streaming consumers, bounded
    admission with the selected backpressure policy, and the metrics
    registry (printable with ``--metrics``, scrapable with
    ``--metrics-port``).  The offline jobs take ``prompt_len // 16`` prompt
    tokens and ``max_new // 4`` new ones, the online streams
    ``prompt_len // 32`` and ``max_new // 8``, as in the reference.
    Returns the runtime, the handles and what the consumers received."""
    import threading

    from ..serving import loadgen
    from ..serving.api import Frontend, QueueFull, QueueTimeout
    from ..serving.runtime import CoServingRuntime, ServingConfig

    cfg, params = wallclock_model(args)
    eng = wallclock_engine(cfg, params, args)
    print("calibrating (also warms every shape bucket serving will hit)...")
    calibrate_wallclock(eng, args)
    rt = CoServingRuntime(
        eng,
        serving=ServingConfig(
            policy=args.backpressure,
            max_queued_online=args.max_queued_online,
            max_queued_offline=args.max_queued_offline,
            queue_timeout_s=args.queue_timeout,
        ),
    )
    fe = Frontend(rt, clock=rt.now)
    srv = (metrics_server(rt.registry, args.metrics_port, health_cb=rt.check_health)
           if args.metrics_port else None)
    if srv is not None:
        print(f"metrics endpoint: http://127.0.0.1:{args.metrics_port}/ "
              f"(health: http://127.0.0.1:{args.metrics_port}/health)")
    rng = np.random.default_rng(args.seed)
    arrivals = loadgen.gamma_arrivals(args.rate, args.cv, args.duration, rng)
    # per-token streaming consumers: one thread per stream iterates its
    # TokenChannel (blocking, lossless) and keeps what it received
    streamed: dict = {}
    consumers: list = []

    def consume(handle) -> None:
        streamed[handle.request.request_id] = list(handle)

    shed = 0
    streams: list = []
    rt.start()
    try:
        job = fe.submit_batch(
            [rng.integers(0, cfg.vocab_size, args.prompt_len // 16)
             .astype(np.int32) for _ in range(args.offline)],
            max_new_tokens=args.max_new // 4,
        )
        for t in arrivals:  # the API thread replays the online trace live
            while True:
                gap = t - rt.now()
                if gap <= 0:
                    break
                time.sleep(min(0.005, gap))
            try:
                h = fe.stream(
                    rng.integers(0, cfg.vocab_size, args.prompt_len // 32)
                    .astype(np.int32),
                    args.max_new // 8,
                )
            except (QueueFull, QueueTimeout):
                shed += 1  # intentional load shedding, not an error
                continue
            streams.append(h)
            th = threading.Thread(target=consume, args=(h,), daemon=True)
            th.start()
            consumers.append(th)
    finally:
        rt.stop(drain=True)
        for th in consumers:
            th.join(timeout=30.0)
        if srv is not None:
            srv.shutdown()
            srv.server_close()
    return {
        "cfg": cfg, "engine": eng, "runtime": rt, "streams": streams, "job": job,
        "streamed": streamed, "shed": shed, "metrics": rt.metrics(),
        "consumers_alive": sum(th.is_alive() for th in consumers),
    }


def main_wallclock(args) -> None:
    res = run_wallclock(args)
    eng, cfg, rt, m = res["engine"], res["cfg"], res["runtime"], res["metrics"]
    streams = res["streams"]
    width = "full" if args.full else "reduced"
    path = "fused" if eng.fused else "split" if eng.paged else "contiguous"
    print(f"arch={cfg.name} ({width}, {args.dtype}, {path} path) wall-clock on {eng.device}")
    print(f"online streams={len(streams)} finished="
          f"{sum(1 for h in streams if h.finished)} shed={res['shed']} "
          f"policy={args.backpressure}; batch done={res['job'].done}")
    print(f"tokens streamed per-token: "
          f"{sum(len(t) for t in res['streamed'].values())} "
          f"(generated {sum(len(h.request.output_tokens) for h in streams)})")
    print(f"p99 TTFT {m.p99_ttft * 1e3:.0f} ms   p99 TPOT "
          f"{m.p99_tpot * 1e3:.1f} ms   attainment "
          f"{m.ttft_slo_attainment:.2f}/{m.tpot_slo_attainment:.2f}")
    print(f"throughput {m.throughput_tokens_per_s:.0f} tok/s "
          f"(online {m.online_throughput:.0f}, offline "
          f"{m.offline_throughput:.0f}); safepoint aborts "
          f"{rt.stats.safepoint_aborts}; preemptions {m.num_preemptions}")
    health, _age = rt.check_health()
    print(f"engine steps={eng.steps} health={health.name}")
    if args.metrics:
        print("--- metrics ---")
        print(rt.registry.render_text(), end="")


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.tp > 1:
        raise NotImplementedError(
            "tensor-parallel serving is not ported yet (ROADMAP Queue 1: "
            "tensor parallelism)"
        )
    if args.mode == "wallclock":
        main_wallclock(args)
        return
    res = run_real(args)
    eng, cfg = res["engine"], res["cfg"]
    width = "full" if args.full else "reduced"
    path = "fused" if eng.fused else "split" if eng.paged else "contiguous"
    print(f"arch={cfg.name} ({width}, {args.dtype}, {path} path) on {eng.device}")
    for i, h in enumerate(res["streams"]):
        print(f"stream {i}: {h.poll()}")
    print(f"batch job done={res['job'].done} progress={res['job'].progress:.0%}")
    print(f"engine steps={eng.steps} preemptions={res['preemptions']} "
          f"ckpt_blocks={eng.ckpt.stats.blocks_checkpointed} "
          f"generated={res['generated']} in {res['seconds']:.2f}s "
          f"({res['generated'] / res['seconds']:.1f} tok/s)")
    model = "measured" if eng.profile is not None else "analytical prior"
    iters = max(1, eng.measured_iters)
    print(f"seconds per iteration: measured {eng.measured_iter_seconds / iters:.4f}, "
          f"predicted by the {model} {eng.predicted_iter_seconds / iters:.4f}")


if __name__ == "__main__":
    main()
