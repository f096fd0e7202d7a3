#!/usr/bin/env python3
"""Decode step of the port's fused engine at tp = 1 and tp = 2 on one card.

    python3 tools/tp_step_profile.py [--src DIR] [--tp 1,2] [--repeats 3] [--pipeline]

Builds Llama-2-7B at full width (bf16, random weights from seed 0) on the
fused path of ``repro_torch``'s ``RealEngine`` -- at tp = 2 over a
``ServingMesh`` that names this card twice -- submits 8 offline requests of
64-token prompts, runs their prefill, then per repeat times ``--steps``
decode steps on the host clock (ended by a device synchronisation) and
``--steps`` more under ``torch.profiler``, whose kernels, copies and fills
give the device-busy time per step.  Prints one JSON line per (tp, repeat)
with the card's name and power limit.

``--src`` points at another checkout's ``src`` (a parent commit, unpacked
with ``git archive``), so two versions are compared in one call; a tree
without tensor parallelism runs tp = 1 only.  ``--pipeline`` runs the
engine with ``RealEngineConfig(pipeline=True)`` (the async pipeline,
DESIGN.md §13), so serial and pipelined steps are compared in one call.
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path


def device_busy_ms(torch, prof) -> float:
    """Device time of the kernels, copies and fills in a profile, in ms."""
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--tp", default="1,2")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--pipeline", action="store_true")
    args = ap.parse_args()
    os.environ.setdefault("TEARDOWN_CUPTI", "1")  # as chip_smoke.py: profiles end cleanly
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("tp_step_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, args.src)
    from repro_torch.configs import get_config
    from repro_torch.core.request import Priority, Request
    from repro_torch.models import transformer as tf
    from repro_torch.serving.real_engine import RealEngine, RealEngineConfig

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("llama-2-7b")
    params = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                            dtype=torch.bfloat16)
    for tp in (int(t) for t in args.tp.split(",")):
        mesh = None
        if tp > 1:
            try:
                from repro_torch.launch.mesh import make_serving_mesh
            except ImportError:
                print(json.dumps({"src": args.src, "tp": tp, "skipped": "no mesh in this tree"}))
                continue
            dev = torch.device("cuda", torch.cuda.current_device())
            mesh = make_serving_mesh(tp, devices=[dev] * tp)
        kw = {} if mesh is None else {"mesh": mesh}
        if args.pipeline:
            kw["pipeline"] = True
        eng = RealEngine(cfg, params, eng_cfg=RealEngineConfig(**kw), device="cuda")
        rng = np.random.default_rng(1)
        for _ in range(8):
            prompt = rng.integers(0, cfg.vocab_size, 64).astype(np.int32)
            eng.submit(Request(Priority.OFFLINE, prompt_len=64, max_new_tokens=160,
                               prompt=prompt))
        for _ in range(4):  # the prefill steps
            eng.step()
        for rep in range(args.repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(args.steps):
                eng.step()
            torch.cuda.synchronize()
            host = (time.perf_counter() - t0) / args.steps * 1e3
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(args.steps):
                    eng.step()
                torch.cuda.synchronize()
            busy = device_busy_ms(torch, prof) / args.steps
            print(json.dumps({"src": args.src, "tp": tp, "pipeline": args.pipeline,
                              "repeat": rep,
                              "host_step_ms": host, "device_busy_ms": busy,
                              "card": smi}), flush=True)
        del eng
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
