"""Serving launcher of the PyTorch port: ``--mode real``.

Builds the port's ``RealEngine`` on a CUDA card (``--device cpu`` to run on
the CPU), puts a ``Frontend`` in front of it, submits online streams and one
offline batch job, and runs the engine until both are done.  Weights are
random, drawn from ``--seed``.  Without ``--full`` the config is the
``.reduced()`` smoke variant; with it, the published width and depth.
``--no-fused-batch`` serves through the split per-family dispatches instead
of the fused ragged batch; ``--backend contiguous`` serves from contiguous
per-request caches instead of the paged pool (its prefill chunks run the
flash attention kernel); ``--calibrate`` measures the engine's dispatches on
the device and installs the fitted latency model before serving.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --mode real --full
  PYTHONPATH=src python -m repro_torch.launch.serve --mode real --full \
      --no-fused-batch --calibrate
  PYTHONPATH=src python -m repro_torch.launch.serve --mode real --full \
      --backend contiguous
  PYTHONPATH=src python -m repro_torch.launch.serve --mode real \
      --device cpu --dtype float32 --online 2 --offline 4 --max-new 8
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
    ap.add_argument("--mode", choices=["real"], default="real")
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
    return ap


def run_real(args, *, record_margins: bool = False) -> dict:
    """Serve the workload; returns the engine, the handles and the timing.
    ``record_margins`` keeps each sampled token's top-1 minus top-2 logit in
    ``engine.margins``."""
    from ..configs import get_config
    from ..models import transformer as tf
    from ..serving.api import Frontend
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
    if record_margins:
        eng.margins = {}
    fe = Frontend(eng)
    rng = np.random.default_rng(args.seed)

    def prompt(n):
        return rng.integers(0, cfg.vocab_size, n).astype(np.int32)

    online = [prompt(args.prompt_len // 8) for _ in range(args.online)]
    offline = [prompt(args.prompt_len // 4) for _ in range(args.offline)]
    t0 = time.perf_counter()
    if args.online_after > 0:
        job = fe.submit_batch(offline, max_new_tokens=args.max_new)
        eng.run(max_steps=args.online_after)
        streams = [fe.stream(p, args.max_new) for p in online]
    else:
        streams = [fe.stream(p, args.max_new) for p in online]
        job = fe.submit_batch(offline, max_new_tokens=args.max_new)
    eng.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    reqs = [h.request for h in streams] + list(job.requests)
    generated = sum(len(r.output_tokens) for r in reqs)
    return {
        "cfg": cfg, "engine": eng, "streams": streams, "job": job,
        "seconds": seconds, "generated": generated,
        "preemptions": sum(r.num_preemptions for r in reqs),
    }


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
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
