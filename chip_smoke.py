#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --kernels-only  # phases 1 and 2, and the kernels'
                                          # long-context timings

Needs one CUDA card (an H100: the kernels are built for sm_90a), the CUDA
toolkit's ``nvcc`` and the repository's sources next to this file.  It
imports nothing of JAX or of the JAX package ``repro``.  Phases, in order;
any failure exits non-zero before the result lines:

1. Device: the card's name and power limit, TF32 off, kernel build time,
   and ptxas's registers, spills and static shared memory of every kernel
   instantiation (a bf16 tensor-core or split-merge kernel that spills
   fails), and per flash and ragged attention instantiation its warpgroup
   products (``HGMMA``) and TMA tile loads (``UTMALDG``) in ``cuobjdump
   -sass`` (a bf16 flash or ragged kernel with none of either fails).
2. Each hand-written kernel against its plain PyTorch version on the card,
   at fp32 and bf16, at the attention shapes of ``ATTN_SHAPES``
   (Llama-2-7B, Qwen2-0.5B, gemma-7b's head dim 256, yi-34b's and
   command-r-plus-104b's groups of 7 and 12; for the flash kernel also
   hubert-xlarge's head dim 80 and llama-3.2-vision-11b's cross-attention
   calls, ``CROSS_CASES``), with cases at the
   tensor-core kernels' 16-row and 64-key edges, and decode batches that
   the bf16 decode kernel cuts into several key splits (``DECODE_CASES``;
   each logs its splits), and ragged batches that the bf16 ragged kernel
   cuts into key splits, some of which keep no key (``RAGGED_CASES``), and
   at bf16 on pages of 8, 24, 64 and 256 tokens (``RAGGED_PAGE_CASES``).
   Each paged call logs the splits and merges its wrapper launched
   (``.last_splits``), held to the shape rule.
3. Llama-2-7B at full width (bf16, 32 layers, random weights from a seed)
   served through ``repro_torch.launch.serve.run_real`` on the fused path:
   online streams arrive while an offline batch job runs on a pool small
   enough to force preemption, so checkpoint gathers and resume restores
   run.  Kernel launch counts are zeroed just before and read just after.
3b. The same workload, model and pool on the split path
   (``--no-fused-batch``): prefill chunks batched, decodes through the
   paged decode attention kernel, counted and profiled the same way (the
   profiled decode steps must run ``paged_tc_kernel``, not the CUDA-core
   kernel); its prefill and decode dispatches must not synchronise with
   the host.
3c. The same workload on the contiguous path (``--backend contiguous``):
   per-request caches, every prefill chunk's attention through the flash
   attention kernel in every layer, decodes through the plain masked
   attention over the batched caches, preemption by swap or discard and
   resume into a fresh cache; counted and profiled the same way, and its
   dispatches must not synchronise with the host either.
4. Self-consistency of the port, at fp32 (same width and depth): greedy
   tokens of a preempted fused run equal those of an uninterrupted run, of
   a run with the prefix cache off and of a preempted split run, up to the
   first near-tie (a top-2 logit margin below MARGIN_BOUND), and those of
   a preempted contiguous run for every request.  bf16 logits tie exactly
   too often for a token comparison to say much.
4b. ``forward_full`` at full width and fp32 on one 2048-token sequence:
   the last position's logits with the flash kernel in every layer against
   the same forward with the kernel's plain version, within FULL_TOL.
5. One JSON line ``{"kernels": [...]}``: per kernel its main-path launches,
   error against the plain version, time (``Timer``: device time alone)
   and the host's enqueue time, plain time, bound and library time,
   measured on the heaviest call of its path (captured while it ran; the
   kernel must agree with its plain version there), and for attention the
   same at contexts of 2-4 thousand tokens (``long_context``: Llama-2-7B,
   and Qwen2-0.5B decodes; for flash attention ``forward_full``'s 2048 and
   4096 tokens, and 4096 at llama-3.2-vision-11b's 32 / 8 heads), and its
   ptxas report per instantiation with the bf16 kernels' dynamic shared
   memory (``build``).  Each flash time is also logged on a line of its
   own beside the replaced mma.sync kernel's on the same input, a figure
   copied from PERF.md (PREVIOUS_FLASH_MS), never put in the JSON line; the
   bf16 flash call's host cost, its three tensor maps' encoding included,
   is its ``enqueue_ms``.  The decode and ragged kernels add their key
   splits and split-merge launches, and each bf16 ragged time is logged
   beside the replaced mma.sync kernel's F1 time (PREVIOUS_RAGGED_MS), as
   the flash times are; the gather, unchanged since it was ported, is also
   timed by the Timer of earlier runs, as the control.
6. Calibration: ``RealEngine.calibrate()`` on a bf16 engine of each path
   (``--calibrate``), the fitted profile, and phase 3's workload served on
   each calibrated engine: measured against predicted seconds per
   iteration, beside the same figures of the uncalibrated runs of 3-3c.
7. Wall-clock co-serving through ``repro_torch.serving.runtime``:
   (a) the fused engine of ``launch.serve --mode wallclock`` at full width
   and bf16, calibrated, replays a ``loadgen`` trace (gamma online
   arrivals over an offline batch) with ``CoServingRuntime.replay`` on the
   host clock: P99 TTFT / TPOT, SLO attainment, tok/s, aborts, preemptions,
   checkpoint and restore counts, the kernels' launches (zeroed just
   before, read just after), the host step under the runtime, and per
   safepoint abort the host time to the online prefill's launch and the
   device work still queued.  (b) The threaded runtime (``start()``)
   behind a ``Frontend`` and the metrics server: decode steps timed and
   profiled while it runs, against phase 3's; streams with consumer
   threads and one ``submit_batch``; the metrics text and ``/health``
   scraped (200, HEALTHY); ``stop(drain=True)``; every stream lossless and
   every request finished.  (c) Phase 4's requests at fp32 replayed under a
   ManualClock so that online arrivals abort pure-offline batches at
   safepoints: at least one abort, and every request's tokens equal phase
   4's serial run's up to the first near-tie.  The kernel line carries (a)'s
   launches of the ragged attention and checkpoint gather kernels.
8. Tensor-parallel paged serving (DESIGN.md §11) on a ``ServingMesh`` of
   two shards on this one card (``make_serving_mesh(2, devices=[dev,
   dev])``): each shard holds 16 of Llama-2-7B's 32 KV heads in pools of its
   own and launches the attention kernels on them.  (a) Both sharded
   functions at tp 2 and 4, fp32 and bf16, on the Llama-2-7B and Qwen2-0.5B
   shapes, against the unsharded plain version at TOL (Qwen2-0.5B's 2 KV
   heads at tp 4 must take the unsharded fallback; decode key splits are
   logged per shard).  (b) Phase 3's workload at bf16 on the fused and the
   split path at tp 2: launches counted (per-shard ragged launches = 2 x 32
   x iterations), preemption, checkpoint and restore counts, each shard's
   pool, the decode steps profiled beside phases 3 and 3b's, and dispatches
   that must not synchronise with the host.  (c) Phase 4's preempted
   workload at fp32, fused and split at tp 2: every request's tokens equal
   phase 4's tp = 1 run's up to the first near-tie, and every block the
   ``HostKVStore`` takes holds all 32 KV heads.  (d) ``calibrate()`` on the
   tp = 2 fused engine, its profile beside phase 6's.  (e) With two or more
   cards, (b) again across two of them; otherwise a line says why not.
   The kernel line gains ``ragged_paged_attention_sharded`` and
   ``paged_attention_sharded``, timed at (b)'s heaviest calls (one sharded
   call and one shard's launch).
9. The async host/device pipeline (DESIGN.md §13) on engines built with
   ``RealEngineConfig(pipeline=True)`` (``Pipelined``): (a) phase 3's
   workload at bf16, launches counted (the kernel line's
   ``launches_pipelined``), its decode batch profiled beside phase 3's with
   ``host_gap_s`` p50 / p99; (b) phase 4's preempted workload at fp32, every
   request's tokens against phase 4's up to the first near-tie, and a
   safepoint abort of a staged batch; (c) at Llama-2-7B's widths and
   OVERLAP_LAYERS layers, a device spin of OVERLAP_SPIN_MS enqueued in
   steady decode: the pipelined ``step()`` must return in under half of it,
   its steady steps under sync debug mode "error" (only the engine's event
   waits let through), and the serial ``step()`` must take at least the
   spin; (d) ``calibrate()`` at depth 4, its profile beside phase 6's fused
   one, and phase 3's workload on it; (e) 7(c)'s replay through
   ``CoServingRuntime`` over a pipelined engine (PIPELINED_ONLINE_AT): at
   least one safepoint abort, lossless streams, tokens equal to 7(c)'s.
10. The other architectures, gemma-7b (GeGLU, tied embeddings, D = 256)
   and olmoe-1b-7b (64 experts, top 8), each at full width and depth with
   random weights from seed 0, after Llama's engines are freed (memory
   logged): (a) phase 3's workload at bf16 with ``--arch`` on the fused,
   split and contiguous paths, counted as phases 3-3c count (every request
   finishes; ragged launches per fused iteration = layers; gathers run),
   each path's dispatches reading nothing back, the fused decode step
   profiled with the experts' ``aten::bmm`` share; (b) phase 4's legs at
   fp32: preempted against uninterrupted, split and contiguous tokens up to
   the first near-tie (olmoe's contiguous leg, whose segmented decode routes
   at capacity factor 1.25 as the reference's does, only reported);
   (c) gemma's ``forward_full`` on 1024 tokens at fp32 against the flash
   kernel's plain version (FULL_TOL); (d) the kernel line's
   ``head_dim_256`` entries: each kernel at gemma's heaviest call of its
   path and the attention kernels at 2-4 thousand-token contexts.
11. The archs that resume a preempted request by recompute, on the
   contiguous path (their only one; the checkpointer off), each serve
   counted (zeroed just before, read just after: the flash kernel once per
   attention layer of every prefill dispatch, no other kernel) and its
   dispatches reading nothing back: (a) mamba2-1.3b (pure SSM) at full
   width and depth, bf16, phase 3's workload, the tokens recomputed at each
   resume, its decode step profiled with the top operators; (b) its fp32
   legs at MAMBA_FP32_LAYERS layers, preempted against uninterrupted and
   the safepoint-segmented decode against the plain one
   (``--no-safepoints``), up to the first near-tie;
   (c) mixtral-8x22b at full width and MIXTRAL_LAYERS layers, bf16, with
   prompts of 4608 tokens prefilled in chunks of 512 into rings of 4096
   slots (chunks that cross the window; a preemption whose recompute
   crosses it again), then at fp32 and MIXTRAL_FP32_LAYERS layers its
   legs (a MoE arch's compared on the plain, dropless decode) and the ring
   prefill's last logits against ``forward_full``'s (FULL_TOL); (d) the
   kernel line's flash entry gains ``sliding_window_4096``: the launches of
   these paths and the kernel at ``forward_full``'s 8192 tokens with the
   window and at the serve's heaviest ring chunk, each against its plain
   version, with bound (kept pairs) and SDPA time; (e) jamba-1.5-large-398b
   at ``.reduced()`` (one period of its full width does not fit the card;
   the parameter counts behind each depth cut are logged), served at bf16,
   and its fp32 legs.
12. The last two architecture families, after phase 11's models are freed
   (memory logged): (a) llama-3.2-vision-11b at full width and depth
   (40 layers in periods of 4 self-attention and 1 cross-attention layer),
   bf16, random weights from seed 0, on the contiguous path (its only
   one): phase 3's workload with each request given its own 576 x 1280
   image embeds from the seed, submitted to ``RealEngine`` directly; every
   request finishes, preemptions and the tokens recomputed at each resume
   are counted, the flash kernel's launches must equal (32 self + 8 cross)
   x prefill dispatches + 8 x decode dispatches + (cross layers per
   segment) x segment dispatches (the cross-attention runs the kernel
   non-causally over the image's K/V at every prefill chunk and decode),
   the dispatches read nothing back, and one decode step is profiled with
   the share of stacking the cross K/V; (b) its fp32 legs at
   VLM_FP32_LAYERS layers, preempted against uninterrupted and segmented
   against plain decode up to the first near-tie, and one request's
   chunked prefill against ``forward_full(image_embeds=...)`` (FULL_TOL);
   (c) hubert-xlarge at full width and depth (48 layers, D = 80, an encoder
   with no serving path): ``forward_full`` on 2 x 1500 frames at bf16 and
   fp32, the fp32 logits against the kernel's plain version (FULL_TOL), and
   flipping the last frame moves the first position's logits; (d) the
   kernel line's flash entry gains ``head_dim_80`` (hubert's call) and
   ``cross_attention`` (the serve's heaviest cross prefill call and its
   largest decode batch), each against its plain version, with time, host
   enqueue, bound and SDPA time.
Last line: ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import ctypes
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Kernel vs plain version on the card.  fp32: both sum in fp32 in another
# order (errors of a few 1e-6 on outputs of magnitude <= 4).  bf16: both
# take the same bf16 inputs and compute scores, the softmax and every sum in
# fp32; the kernels (tensor cores) also round the probabilities to bf16
# before P V, relative to the running row max, where the plain version
# keeps them fp32, and both round the output once.  One bf16 step of an
# output <= 4 is 2**-6; the probabilities' rounding adds at most 2**-9 of
# the weighted mean of |v| and mostly cancels over the keys:
# tests/test_torch_kernels.py emulates the kernels' arithmetic on the CPU
# and finds it well inside this bound on cases shaped like phase 2's.
TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=2**-6, rtol=2**-7)}
# A greedy token is trusted only if its top-1 minus top-2 logit exceeds
# this: two batch compositions run different cuBLAS reductions, which move
# fp32 logits by about 1e-5 after 32 layers; phase 4 prints the largest
# margin change it saw on tokens that agree, as evidence for the bound.
MARGIN_BOUND = 1e-3
# tokens each request of the served workload generates
MAX_NEW = 48
# forward_full at full width, flash kernel vs its plain version at fp32: the
# attention outputs differ by a few 1e-7 (sums in another order), which 32
# layers carry to the logits (|logits| <= ~5) as differences near 1e-5.
FULL_TOL = dict(atol=1e-3, rtol=1e-3)
# FP32 outside the tensor cores and dense bf16 (NVIDIA H100 data sheet).
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


# ------------------------------------------------------------- build report
def kernel_name(mangled: str) -> str:
    """``ns::name<args>`` of a mangled kernel in an anonymous namespace, as
    ``name<float, 128>`` or ``name<128>``; the mangled name if it is not
    one."""
    m = re.match(r"_ZN(\d+)", mangled)
    if not m:
        return mangled
    i = m.end() + int(m[1])
    m = re.match(r"\d+", mangled[i:])
    if not m:
        return mangled
    n, i = int(m[0]), i + m.end()
    name, rest = mangled[i:i + n], mangled[i + n:]
    if not rest.startswith("I") or "EE" not in rest:
        return name
    targs = rest[1:rest.index("EE") + 1]
    args = ["float"] if targs.startswith("f") else (
        ["bf16"] if targs.startswith("13__nv_bfloat16") else [])
    args += re.findall(r"Li(\d+)E", targs)
    return f"{name}<{', '.join(args)}>"


def ptxas_report(text: str) -> dict:
    """Per kernel instantiation in one source's ``ptxas -v`` output: its
    registers, spill stores and loads (bytes) and static shared memory."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = out.setdefault(kernel_name(m[1]), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m[1]), int(m[2])
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m[1])
            m = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(m[1]) if m else 0
    return out


def sass_counts(build, name: str, ops=("HGMMA", "UTMALDG")) -> dict:
    """Per kernel instantiation of ``csrc/<name>.cu``'s built library, the
    number of SASS instructions of each of ``ops`` (``cuobjdump -sass``):
    ``HGMMA`` is a warpgroup product (wgmma), ``UTMALDG`` a TMA tile load."""
    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(cuobjdump), "-sass", str(build._lib_path(name))],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise AssertionError(f"cuobjdump failed on {name}: {out.stderr[-2000:]}")
    counts, cur = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = counts.setdefault(kernel_name(m[1]), dict.fromkeys(ops, 0))
        elif cur is not None:
            for op in ops:
                cur[op] += bool(re.search(rf"\b{op}\b", line))
    return counts


def smem_bytes(build, name: str, *args: int) -> int:
    """Dynamic shared memory of one block, from ``csrc/<name>.cu``'s own
    ``<name>_smem_bytes``."""
    fn = getattr(build.load(name), f"{name}_smem_bytes")
    fn.argtypes, fn.restype = [ctypes.c_int] * len(args), ctypes.c_longlong
    return int(fn(*args))


# --------------------------------------------------------------------- timing
class Timer:
    """CUDA-event timing of single launches with the 50 MB L2 flushed
    before each one (a caller finds these pages cold): the median of
    ``reps`` launches after ``warm`` untimed ones, in ms.

    After the flush the stream spins on the device (``torch.cuda._sleep``)
    for twice the host's longest enqueue of the call in the warm-up, so the
    device reaches the start event only once the host has queued the call
    and the end event behind it: the pair times device work, not the host.
    A repetition whose start event had already passed when the host
    finished queueing is run again with a spin twice as long (up to 5
    times; ``late`` counts those that still were).  ``enqueue_ms`` is the
    median host time, over the last ``ms`` call's repetitions, of queueing
    the call: start event to end event.  ``device_wait=False`` leaves the spin out, as the Timer of
    earlier runs did (a slow host's enqueue is then counted): the control.
    Nothing touches CUDA before the first ``ms`` call."""

    def __init__(self, torch, device_wait: bool = True):
        self.torch, self.device_wait = torch, device_wait
        self.flush = None
        self.cycles_per_ms = 0.0
        self.enqueue_ms = 0.0
        self.late = 0

    def _setup(self):
        torch = self.torch
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1000)
        a.record()
        torch.cuda._sleep(1 << 22)
        b.record()
        b.synchronize()
        self.cycles_per_ms = (1 << 22) / a.elapsed_time(b)

    def ms(self, fn, reps: int = 25, warm: int = 3) -> float:
        torch = self.torch
        if self.flush is None:
            self._setup()
        slowest = 0.0
        for i in range(warm):
            t0 = time.perf_counter()
            fn()
            if i or warm == 1:  # the first call may pay one-time costs
                slowest = max(slowest, time.perf_counter() - t0)
        wait_ms = min(2e3 * slowest + 0.05, 50.0)
        times, enqueue = [], []
        for _ in range(reps):
            for attempt in range(6):
                self.flush.zero_()
                if self.device_wait:
                    torch.cuda._sleep(int(wait_ms * self.cycles_per_ms))
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                a.record()
                fn()
                b.record()
                t1 = time.perf_counter()
                late = self.device_wait and a.query()
                b.synchronize()
                if not late:
                    break
                if attempt == 5:
                    self.late += 1
                wait_ms *= 2
            times.append(a.elapsed_time(b))
            enqueue.append((t1 - t0) * 1e3)
        self.enqueue_ms = statistics.median(enqueue)
        return statistics.median(times)


def timed(timer, fn, **kw) -> dict:
    """``{"ms": ..., "enqueue_ms": ...}`` of ``fn`` under ``timer``."""
    ms = timer.ms(fn, **kw)
    return {"ms": ms, "enqueue_ms": timer.enqueue_ms}


# ------------------------------------------------------------ phase 2 inputs
def attention_case(torch, dtype, h, hkv, d, softcap, seed,
                   q_lens=(32, 1, 9, 1, 1, 0), kv_lens=(32 + 131, 50, 9, 300, 1, 0),
                   qmax=32, page=16):
    """A ragged batch as the engine builds it.  The default is a mixed
    batch: prefill chunks, q_len = 1 decodes, a padded sequence with
    kv_len = 0, padded query slots at q_pos = 0, -1 table entries past each
    sequence's pages."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    s = len(q_lens)
    m = max(-(-kv // page) for kv in kv_lens) + 2
    n = s * m + 1
    q = torch.randn((s, qmax, h, d), generator=g, device="cuda").to(dtype)
    kp = torch.randn((n, page, hkv, d), generator=g, device="cuda").to(dtype)
    vp = torch.randn((n, page, hkv, d), generator=g, device="cuda").to(dtype)
    perm = torch.randperm(n - 1, generator=g, device="cuda")[: s * m].reshape(s, m)
    tables = perm.to(torch.int32).clone()
    q_pos = torch.zeros((s, qmax), dtype=torch.int32, device="cuda")
    for i, (ql, kv) in enumerate(zip(q_lens, kv_lens)):
        tables[i, -(-kv // page):] = -1
        if ql:
            q_pos[i, :ql] = torch.arange(kv - ql, kv, device="cuda")
    kvl = torch.tensor(kv_lens, dtype=torch.int32, device="cuda")
    return q, kp, vp, tables, q_pos, kvl, float(softcap)


# ragged_paged_attention cases of phase 2 (attention_case arguments); each
# ends with a padded sequence (kv_len = 0) whose rows must be exactly 0.
# K/V tiles of the bf16 kernel are 64 keys (4 pages of 16).  The last two
# are cut into key splits at every ATTN_SHAPES entry (``ragged_splits``:
# few (sequence, KV head, row tile) jobs, tables of 1040 keys): a 20-token
# chunk at the end of a 1000-token context across splits, a decode whose
# later splits keep none of its keys, and a sequence whose every split but
# the first is a job with no key.
RAGGED_CASES = {
    "mixed batch": {},
    "Qmax * G off 16 rows": dict(q_lens=(3, 1, 2, 0), kv_lens=(40, 17, 70, 0), qmax=3),
    "kv_len inside a round": dict(q_lens=(1, 5, 1, 0), kv_lens=(101, 101, 64, 0), qmax=5),
    "chunk across two rounds": dict(q_lens=(32, 20, 0), kv_lens=(80, 70, 0), qmax=32),
    "warp tiles of padded slots only": dict(q_lens=(1, 48, 2, 0), kv_lens=(200, 48, 130, 0),
                                            qmax=48),
    "key splits": dict(q_lens=(1, 20, 1, 0), kv_lens=(384, 1000, 700, 0), qmax=20),
    "splits that keep no key": dict(q_lens=(1, 1, 0), kv_lens=(1000, 40, 0), qmax=1),
}

# The bf16 ragged kernel's K/V boxes are gcd(page, 64) rows of one page, 64 /
# gcd of them to a 64-key tile, so phase 2 also runs it (bf16 only: the
# fp32 kernel's page ring does not fit at page 256) at pages other than the
# engine's 16: 8-row boxes, a page of 24 that straddles tiles, one box a
# tile, and pages of four tiles; the two of RAGGED_CASES["key splits"]'s
# lengths are cut into key splits at every ATTN_SHAPES entry.
RAGGED_PAGE_CASES = {
    "page 8 across key splits": dict(page=8, **RAGGED_CASES["key splits"]),
    "page 24": dict(page=24, q_lens=(32, 1, 9, 0), kv_lens=(163, 50, 300, 0), qmax=32),
    "page 64": dict(page=64, q_lens=(32, 1, 9, 0), kv_lens=(163, 50, 300, 0), qmax=32),
    "page 256 across key splits": dict(page=256, **RAGGED_CASES["key splits"]),
}


def decode_case(torch, dtype, h, hkv, d, softcap, seed,
                seq_lens=(163, 50, 16, 300, 1, 0, 64, 33), hole=(6, 0), page=16):
    """A decode batch as the split path builds it: one query per sequence,
    -1 table entries past each sequence's pages.  The default has a
    seq_len = 0 row, lengths at exact page multiples (16, 64), and -- in
    row ``hole[0]`` at page ``hole[1]`` -- a -1 entry inside a context
    (masked by both versions; the engine never builds one)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    b = len(seq_lens)
    m = max(-(-n // page) for n in seq_lens) + 2
    n = b * m + 1
    q = torch.randn((b, h, d), generator=g, device="cuda").to(dtype)
    kp = torch.randn((n, page, hkv, d), generator=g, device="cuda").to(dtype)
    vp = torch.randn((n, page, hkv, d), generator=g, device="cuda").to(dtype)
    tables = torch.randperm(n - 1, generator=g, device="cuda")[: b * m].reshape(b, m)
    tables = tables.to(torch.int32).clone()
    for i, sl in enumerate(seq_lens):
        tables[i, -(-sl // page):] = -1
    if hole is not None:
        tables[hole] = -1
    lens = torch.tensor(seq_lens, dtype=torch.int32, device="cuda")
    return q, kp, vp, tables, lens, float(softcap)


# paged_attention cases of phase 2 (decode_case arguments), each with a
# seq_len = 0 row that must come out exactly 0 and a -1 entry inside a
# context: a serving batch; long contexts, which the bf16 kernel cuts into
# 3 (Llama-2-7B) or 4 (Qwen2-0.5B) key splits, with splits past the first
# row's seq_len and the -1 entry inside a later split; and pages of 24
# tokens, so rounds of 64 keys straddle pages.
DECODE_CASES = {
    "serving batch": {},
    "long contexts": dict(seq_lens=(384, 1000, 0), hole=(1, 40)),
    "page 24": dict(seq_lens=(75, 0, 700, 72), hole=(2, 5), page=24),
}


def ragged_splits_of(torch, rpa, q, kp, tb):
    """(splits, keys per split) that ``ragged_paged_attention`` should use
    on these inputs by the shape rule: the host's choice from shapes for
    bf16; fp32 does not split.  Phase 2 holds the wrapper's recorded plan
    (``.last_splits``) to it."""
    if q.dtype != torch.bfloat16:
        return 1, tb.shape[1] * kp.shape[1]
    s, qmax, h, d = q.shape
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    tiles = rpa.ragged_row_tiles(h // kp.shape[2], qmax)[1]
    return rpa.ragged_splits(s, kp.shape[2], tiles, tb.shape[1] * kp.shape[1],
                             sms * rpa.ragged_pipes(d))


def decode_splits_of(torch, rpa, q, kp, tb):
    """(splits, keys per split) that ``paged_attention`` should use on these
    inputs by the shape rule: the host's choice from shapes for bf16; fp32
    does not split.  Phase 2 holds the wrapper's recorded plan
    (``.last_splits``) to it."""
    if q.dtype != torch.bfloat16:
        return 1, tb.shape[1] * kp.shape[1]
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    return rpa.decode_splits(q.shape[0], kp.shape[2], tb.shape[1] * kp.shape[1], sms)


# flash_attention cases of phase 2: (name, B, Tq, Tk, causal, window, q_offset).
# K/V are prefix views of a longer cache (batch stride > Tk rows), as the
# contiguous path's prefill chunks pass them.
FLASH_CASES = [
    ("chunk behind a cached prefix", 2, 96, 224, True, 0, 128),
    ("sliding window", 1, 200, 200, True, 48, 0),
    ("non-causal", 2, 80, 144, False, 0, 0),
    ("Tq/Tk off the tile size", 1, 130, 300, True, 0, 170),
    ("Tq = 1", 2, 1, 300, True, 0, 299),
    ("rows that keep no key", 1, 8, 64, False, 16, 100),
    # a ring prefill chunk: the window's earlier keys, then the chunk's own
    ("window chunk behind a q_offset", 1, 96, 159, True, 64, 63),
    # the tensor-core kernel's 16-row warp tiles and key splits: Tq of one,
    # just over one and just under two warp tiles behind a q_offset, Tk one
    # short of and one past a 64-key tile
    *((f"Tq = {tq} behind a q_offset, Tk = {tk}", 2, tq, tk, True, 0, tk - tq)
      for tq in (16, 17, 31) for tk in (63, 65)),
]


# Phase 2's flash cases at the last two archs' shapes: every FLASH_CASES
# entry at hubert-xlarge's heads (16 / 16 of D = 80, a head dim only the
# flash kernel takes), and llama-3.2-vision-11b's cross-attention calls at
# its heads (32 / 8 of 128): non-causal over its 576 image keys, a decode
# batch of 12 rows of one query (K/V a torch.cat of 12 caches, batch stride
# 576 rows) and a prefill chunk of 32 queries.
HUBERT_SHAPE = (16, 16, 80)
VLM_SHAPE = (32, 8, 128)
CROSS_CASES = [("cross-attention decode batch", 12, 1, 576, False, 0, 0),
               ("cross-attention prefill chunk", 1, 32, 576, False, 0, 0)]


# Attention shapes (H, Hkv, D) of phase 2 per arch, and the softcaps each is
# checked at: Llama-2-7B and Qwen2-0.5B as before; gemma-7b's D = 256 at
# both; yi-34b's G = 7, command-r-plus-104b's G = 12 and mixtral-8x22b's
# G = 6 at D = 128 without a softcap (the fp32 decode kernel's 16 outputs
# per thread at G = 12).
ATTN_SHAPES = {
    "llama-2-7b": (32, 32, 128), "qwen2-0.5b": (14, 2, 64), "gemma-7b": (16, 16, 256),
    "yi-34b": (56, 8, 128), "command-r-plus-104b": (96, 8, 128),
    "mixtral-8x22b": (48, 8, 128),
}
SOFTCAPS = {"yi-34b": (0.0,), "command-r-plus-104b": (0.0,), "mixtral-8x22b": (0.0,),
            "hubert-xlarge": (0.0,), "llama-3.2-vision-11b": (0.0,)}


def softcaps(arch: str):
    return SOFTCAPS.get(arch, (0.0, 30.0))


def flash_case(torch, dtype, h, hkv, d, b, tq, tk, seed, spare=40):
    """q (B, Tq, H, D) and k, v as the first Tk slots of (B, Tk + spare,
    Hkv, D) caches."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, tq, h, d), generator=g, device="cuda").to(dtype)
    kc = torch.randn((b, tk + spare, hkv, d), generator=g, device="cuda").to(dtype)
    vc = torch.randn((b, tk + spare, hkv, d), generator=g, device="cuda").to(dtype)
    return q, kc[:, :tk], vc[:, :tk]


def check_flash(torch, fa):
    """Phase 2, flash_attention: every FLASH_CASES entry at each arch's
    softcaps, fp32 and bf16, at every ATTN_SHAPES entry and at
    HUBERT_SHAPE (D = 80), and the CROSS_CASES at VLM_SHAPE (K/V with no
    spare rows, as a torch.cat of caches)."""
    shapes = [(arch, shape, FLASH_CASES, 40) for arch, shape in ATTN_SHAPES.items()]
    shapes += [("hubert-xlarge", HUBERT_SHAPE, FLASH_CASES, 40),
               ("llama-3.2-vision-11b", VLM_SHAPE, CROSS_CASES, 0)]
    for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for arch, (h, hkv, d), cases, spare in shapes:
            for case, b, tq, tk, causal, window, off in cases:
                for cap in softcaps(arch):
                    q, k, v = flash_case(torch, dtype, h, hkv, d, b, tq, tk, 5, spare)
                    kw = dict(causal=causal, sliding_window=window, q_offset=off,
                              logit_softcap=cap)
                    got = fa.flash_attention(q, k, v, **kw)
                    want = fa.flash_attention_ref(q, k, v, **kw)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    log(f"  flash_attention {dname} {arch} H={h} Hkv={hkv} D={d} {case} "
                        f"(B={b} Tq={tq} Tk={tk} causal={causal} window={window} "
                        f"q_offset={off}) softcap={cap:g}: max_abs_err={err:.3e} "
                        f"(tolerance {TOL[dname]})")
                    if not torch.allclose(got.float(), want.float(), **TOL[dname]):
                        raise AssertionError(f"flash_attention disagrees ({dname}, {arch}, {case})")


def check_kernels(torch, ops, rpa, cg, fa):
    """Phase 2: every kernel against its plain version, fp32 and bf16."""
    check_flash(torch, fa)
    for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for arch, (h, hkv, d) in ATTN_SHAPES.items():
            for cap in softcaps(arch):
                for case, kw in DECODE_CASES.items():
                    q, kp, vp, tb, lens, cap = decode_case(torch, dtype, h, hkv, d, cap, 4, **kw)
                    merges = rpa.paged_attention.merge_launches
                    got = rpa.paged_attention(q, kp, vp, tb, lens, logit_softcap=cap)
                    merges = rpa.paged_attention.merge_launches - merges
                    splits, keys = rpa.paged_attention.last_splits
                    want = rpa.paged_attention_ref(q, kp, vp, tb, lens, logit_softcap=cap)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    zero = got[lens == 0].float().abs().max().item()
                    log(f"  paged_attention {dname} {arch} H={h} Hkv={hkv} D={d} {case} "
                        f"(seq_lens={lens.tolist()} page={kp.shape[1]} table={tb.shape[1]} "
                        f"splits={splits} of {keys} keys, merges={merges}) softcap={cap:g}: "
                        f"max_abs_err={err:.3e} seq_len=0 rows max={zero:g}")
                    if not torch.allclose(got.float(), want.float(), **TOL[dname]) or zero != 0:
                        raise AssertionError(f"paged_attention disagrees ({dname}, {arch}, {case})")
                    if merges != (splits > 1):
                        raise AssertionError(f"paged_attention: {merges} merges for {splits} splits")
                    rule = decode_splits_of(torch, rpa, q, kp, tb)
                    if (splits, keys) != rule:
                        raise AssertionError(f"paged_attention launched {splits} splits of "
                                             f"{keys} keys, the shape rule says {rule}")
                cases = dict(RAGGED_CASES, **(RAGGED_PAGE_CASES if dtype == torch.bfloat16
                                              else {}))
                for case, kw in cases.items():
                    q, kp, vp, tb, qp, kvl, cap = attention_case(torch, dtype, h, hkv, d, cap,
                                                                 1, **kw)
                    merges = rpa.ragged_paged_attention.merge_launches
                    got = rpa.ragged_paged_attention(q, kp, vp, tb, qp, kvl, logit_softcap=cap)
                    merges = rpa.ragged_paged_attention.merge_launches - merges
                    splits, keys = rpa.ragged_paged_attention.last_splits
                    want = rpa.ragged_paged_attention_ref(q, kp, vp, tb, qp, kvl,
                                                          logit_softcap=cap)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    zero = got[-1].float().abs().max().item()
                    log(f"  ragged_paged_attention {dname} {arch} H={h} Hkv={hkv} D={d} {case} "
                        f"(Qmax={q.shape[1]} page={kp.shape[1]} table={tb.shape[1]} "
                        f"splits={splits} of {keys} "
                        f"keys, merges={merges}) softcap={cap:g}: max_abs_err={err:.3e} "
                        f"kv_len=0 rows max={zero:g}")
                    if not torch.allclose(got.float(), want.float(), **TOL[dname]) or zero != 0:
                        raise AssertionError(f"ragged_paged_attention disagrees ({dname}, {arch}, "
                                             f"{case})")
                    if merges != (splits > 1) or (dtype == torch.bfloat16 and "split" in case
                                                  and splits == 1):
                        raise AssertionError(f"ragged_paged_attention {case}: {merges} merges "
                                             f"for {splits} splits")
                    rule = ragged_splits_of(torch, rpa, q, kp, tb)
                    if (splits, keys) != rule:
                        raise AssertionError(f"ragged_paged_attention launched {splits} splits "
                                             f"of {keys} keys, the shape rule says {rule}")
            g = torch.Generator(device="cuda").manual_seed(2)
            pool = torch.randn((4, 33, 16, hkv, d), generator=g, device="cuda").to(dtype)
            ids = torch.tensor([5, 2, 32, 9, 31, 32, 32, 0], dtype=torch.int32, device="cuda")
            got = cg.checkpoint_gather(pool, ids)
            torch.cuda.synchronize()
            same = torch.equal(got, cg.checkpoint_gather_ref(pool, ids))
            log(f"  checkpoint_gather {dname} {arch} pool={tuple(pool.shape)} "
                f"ids={ids.tolist()}: exact={same}")
            if not same:
                raise AssertionError(f"checkpoint_gather disagrees ({dname}, {arch})")


def attention_bound(torch, q, kp, tb, qp, kvl, peak_flops, hbm_bw):
    """The least time of one attention call on these inputs: the bytes it
    must move over the HBM rate, or its operations over the peak rate,
    whichever is larger.  Counted from the data: q only for rows that keep
    a key (a row that keeps none is written 0 without reading it), the whole
    output, and for each sequence the K/V pages and table entries up to
    min(kv_len, its largest q_pos + 1)."""
    s, qmax, h, d = q.shape
    page, hkv = kp.shape[1], kp.shape[2]
    elt = q.element_size()
    kv = kvl.long().cpu()
    qpos = qp.long().cpu()
    kept = torch.minimum(qpos + 1, kv[:, None]).clamp(min=0)  # keys kept per row
    end = torch.minimum(kv, qpos.max(dim=1).values + 1).clamp(min=0)
    pages = int(((end + page - 1) // page).sum())
    nbytes = ((int((kept > 0).sum()) + q.numel() // (h * d)) * h * d * elt
              + pages * 4 + qp.numel() * 4 + kvl.numel() * 4
              + 2 * pages * page * hkv * d * elt)
    flops = 4 * d * h * int(kept.sum())
    t_b, t_f = nbytes / hbm_bw * 1e3, flops / peak_flops * 1e3
    return max(t_b, t_f), "bytes" if t_b >= t_f else "operations"


def decode_bound(torch, q, kp, tb, lens, peak_flops, hbm_bw):
    """The least time of one decode attention call on these inputs, counted
    from the data: q for rows with seq_len > 0, the whole output, seq_lens,
    and for each sequence the table entries and K/V pages up to its
    seq_len (pages with a -1 entry are not read)."""
    b, h, d = q.shape
    page, hkv = kp.shape[1], kp.shape[2]
    elt = q.element_size()
    n = lens.long().cpu()
    col = torch.arange(tb.shape[1])[None, :]
    entries = col < ((n + page - 1) // page)[:, None]
    pages = int((entries & (tb.cpu() >= 0)).sum())
    nbytes = ((int((n > 0).sum()) + b) * h * d * elt + int(entries.sum()) * 4
              + lens.numel() * 4 + 2 * pages * page * hkv * d * elt)
    flops = 4 * d * h * int(n.sum())
    t_b, t_f = nbytes / hbm_bw * 1e3, flops / peak_flops * 1e3
    return max(t_b, t_f), "bytes" if t_b >= t_f else "operations"


# ------------------------------------------------------------ phase 3 and 4
class Capture:
    """Wraps a kernel-layer entry point on the main path: delegates every
    call unchanged, and keeps a clone of the arguments of the heaviest call
    (by ``size``; the first of equals) for the timing phase."""

    def __init__(self, fn, size, clone):
        self.fn, self.size, self.clone = fn, size, clone
        self.best, self.args = -1, None

    def __call__(self, *args, **kw):
        n = self.size(*args)
        if n > self.best:
            self.best, self.args = n, self.clone(*args, **kw)
        return self.fn(*args, **kw)


class PagesRead:
    """Size of an attention call: the K/V pages it reads, the sum over
    sequences of ceil(kv_len / page), from the argument at ``lens_at``
    (``kv_lens``, or the decode kernel's ``seq_lens``: the last one, or the
    one before a sharded call's mesh).  The layers of one dispatch share one
    block-table tensor, so the lengths are read back once per dispatch."""

    def __init__(self, lens_at: int = -1):
        self.key, self.pages, self.lens_at = None, 0, lens_at

    def __call__(self, q, kp, vp, tb, *rest):
        if tb is not self.key:
            page, lens = kp.shape[1], rest[self.lens_at]
            self.key, self.pages = tb, int(((lens.long() + page - 1) // page).sum())
        return self.pages


def serve(serve_mod, argv, mesh=None):
    args = serve_mod.build_parser().parse_args(argv)
    return serve_mod.run_real(args, record_margins=True, mesh=mesh)


def offline_tokens(res):
    eng = res["engine"]
    return [(list(r.output_tokens), eng.margins[r.request_id]) for r in res["job"].requests]


def compare_runs(name, a, b):
    """Token identity up to the first near-tie, request by request."""
    identical = near_tie = 0
    drift = 0.0  # largest margin change on tokens both runs agree on
    for i, ((ta, ma), (tb, mb)) in enumerate(zip(a, b)):
        k = next((j for j, (x, y) in enumerate(zip(ta, tb)) if x != y), None)
        same = len(ta) if k is None else k
        drift = max([drift] + [abs(x - y) for x, y in zip(ma[:same], mb[:same])])
        if k is None and len(ta) == len(tb):
            identical += 1
            continue
        k = min(len(ta), len(tb)) if k is None else k
        low = min(ma[: k + 1] + mb[: k + 1])
        if low >= MARGIN_BOUND:
            raise AssertionError(
                f"{name}: request {i} diverged at token {k} with no near-tie "
                f"(smallest margin up to there {low:.3e} >= {MARGIN_BOUND})"
            )
        near_tie += 1
        log(f"  {name}: request {i} diverged at token {k} after a near-tie "
            f"(margin {low:.3e} < {MARGIN_BOUND})")
    log(f"  {name}: {identical} identical, {near_tie} diverged after a near-tie; "
        f"largest margin change on agreeing tokens {drift:.3e}")
    return identical


# phase 3's workload: Llama-2-7B at full width, 8 offline jobs, then 4 online
# streams after 4 steps, on a pool of 56 blocks that forces preemption
SERVE_ARGV = ["--full", "--device", "cuda", "--dtype", "bfloat16", "--online", "4",
              "--offline", "8", "--prompt-len", "512", "--max-new", str(MAX_NEW),
              "--online-after", "4", "--num-device-blocks", "56"]


def iteration_figures(eng) -> str:
    iters = max(1, eng.measured_iters)
    model = "measured profile" if eng.profile is not None else "analytical prior"
    return (f"measured_iter_seconds={eng.measured_iter_seconds:.4f} "
            f"predicted_iter_seconds={eng.predicted_iter_seconds:.4f} "
            f"measured_iters={eng.measured_iters}: {eng.measured_iter_seconds / iters * 1e3:.2f} "
            f"ms measured vs {eng.predicted_iter_seconds / iters * 1e3:.2f} ms predicted per "
            f"iteration by the {model}")


def path_of(eng) -> str:
    return "fused" if eng.fused else "split" if eng.paged else "contiguous"


def flash_clone(q, k, v, **kw):
    return (q.clone(), k.clone(), v.clone(),
            dict(dict(causal=True, sliding_window=0, q_offset=0, logit_softcap=0.0), **kw))


def sharded_clone(q, kp, vp, tb, *rest, logit_softcap=0.0):
    """A clone of a sharded attention call's arguments: the pools' parts
    cloned, the mesh (the last argument) kept."""
    def parts(hs):
        return type(hs)([p.clone() for p in hs.parts], hs.heads, hs.sharded)

    return (q.clone(), parts(kp), parts(vp), tb.clone(),
            *(t.clone() for t in rest[:-1]), rest[-1], logit_softcap)


def run_serve(torch, ops, serve_mod, tf, argv, mesh=None):
    """Phases 3-3c and 8(b): one serve run at full width, every kernel
    captured and counted (counts zeroed just before, read just after); on a
    tensor-parallel ``mesh`` the sharded attention calls too, each of which
    must have launched the kernel once per shard."""
    caps = {
        "flash_attention": Capture(
            ops.flash_attention, lambda q, k, v: q.shape[1] * k.shape[1], flash_clone),
        "ragged_paged_attention": Capture(
            ops.ragged_paged_attention, PagesRead(),
            lambda q, kp, vp, tb, qp, kvl, logit_softcap=0.0: (
                q.clone(), kp.clone(), vp.clone(), tb.clone(), qp.clone(), kvl.clone(),
                logit_softcap)),
        "paged_attention": Capture(
            ops.paged_attention, PagesRead(),
            lambda q, kp, vp, tb, lens, logit_softcap=0.0: (
                q.clone(), kp.clone(), vp.clone(), tb.clone(), lens.clone(), logit_softcap)),
        "checkpoint_gather": Capture(
            ops.checkpoint_gather, lambda pool, ids: ids.numel(),
            lambda pool, ids, out=None: (pool.clone(), ids.clone())),
    }
    if mesh is not None:
        for name in ("ragged_paged_attention_sharded", "paged_attention_sharded"):
            caps[name] = Capture(getattr(ops, name), PagesRead(-2), sharded_clone)
    for name, cap in caps.items():
        setattr(ops, name, cap)
    try:
        ops.reset_launch_counts()
        res = serve(serve_mod, argv, mesh)
        counts = ops.launch_counts()
        counts["paged_attention merges"] = ops.KERNELS["paged_attention"].merge_launches
        counts["ragged_paged_attention merges"] = (
            ops.KERNELS["ragged_paged_attention"].merge_launches)
    finally:
        for name, cap in caps.items():
            setattr(ops, name, cap.fn)
    eng, cfg = res["engine"], res["cfg"]
    aborts = eng.safepoints.stats.preemptions
    log(f"  {cfg.name}: layers={cfg.num_layers} d_model={cfg.d_model} heads={cfg.num_heads}"
        f"/{cfg.num_kv_heads} head_dim={cfg.resolved_head_dim} d_ff={cfg.d_ff} "
        f"vocab={cfg.vocab_size} dtype=bfloat16, {path_of(eng)} path")
    log(f"  steps={eng.steps} safepoint_aborts={aborts} preemptions={res['preemptions']} "
        f"ckpt_blocks={eng.ckpt.stats.blocks_checkpointed} ckpt_gather_rounds={eng.ckpt_gathers} "
        f"restored_blocks={eng.restored_blocks} cow_rounds={eng.cow_dispatches} "
        f"fused_buckets={eng.fused_trace_count} dispatches={eng.dispatches}")
    log(f"  generated={res['generated']} tokens in {res['seconds']:.3f} s = "
        f"{res['generated'] / res['seconds']:.1f} tok/s (host clock, includes every phase of serving)")
    log(f"  {iteration_figures(eng)}")
    log(f"  launches: {counts}")
    reqs = [h.request for h in res["streams"]] + list(res["job"].requests)
    short = [r.request_id for r in reqs if len(r.output_tokens) != MAX_NEW]
    if short:
        raise AssertionError(f"requests without all their tokens: {short}")
    per_segment = cfg.num_layers // len(tf.segment_spans(cfg))
    d = eng.dispatches
    # attention calls of the path: the sharded wrapper's on a mesh, each of
    # which launched the kernel once per shard
    calls = {name: counts[name] for name in ("ragged_paged_attention", "paged_attention")}
    if mesh is not None:
        for name in calls:
            sharded = f"{name}_sharded"
            calls[name] = counts[sharded]
            if (counts[f"{sharded} fallbacks"] or counts[name] != counts[f"{sharded} shard_launches"]
                    or counts[name] != mesh.tp * counts[sharded]):
                raise AssertionError(f"{sharded}: {counts[sharded]} calls did not launch "
                                     f"{name} once per shard ({counts[name]} launches)")
    if eng.paged and counts["flash_attention"] != 0:
        raise AssertionError("a paged path launched the flash attention kernel")
    if not eng.paged:
        if counts["flash_attention"] != cfg.num_layers * d["prefill"] or d["prefill"] == 0:
            raise AssertionError("flash_attention launches != 32 x contiguous prefill dispatches")
        if counts["ragged_paged_attention"] or counts["paged_attention"]:
            raise AssertionError("the contiguous path launched a paged attention kernel")
        if d["decode"] + d["segment"] == 0:
            raise AssertionError("the contiguous path ran no decode dispatch")
    elif eng.fused:
        if calls["ragged_paged_attention"] != per_segment * d["fused_segment"]:
            raise AssertionError("ragged_paged_attention launches != layers of the segments run")
        if calls["ragged_paged_attention"] < cfg.num_layers * (eng.steps - aborts):
            raise AssertionError("ragged_paged_attention launched fewer than 32 x completed steps")
        if counts["paged_attention"] != 0:
            raise AssertionError("the fused path launched the decode kernel")
    else:
        if calls["paged_attention"] != cfg.num_layers * d["decode"] + per_segment * d["segment"]:
            raise AssertionError("paged_attention launches != 32 x decode dispatches + "
                                 "layers per segment x segment dispatches")
        if calls["paged_attention"] == 0 or d["prefill"] == 0:
            raise AssertionError("the split path ran no decode or no prefill dispatch")
        if counts["ragged_paged_attention"] != 0:
            raise AssertionError("the split path launched the ragged kernel")
    ckpt = counts["checkpoint_gather"] if eng.paged else eng.ckpt.stats.blocks_checkpointed
    if res["preemptions"] == 0 or ckpt == 0 or eng.restored_blocks == 0:
        raise AssertionError("the run did not preempt, checkpoint and restore")
    return res, counts, {name: cap.args for name, cap in caps.items()}


def check_reads_nothing_back(torch, tf, eng):
    """The served paths' dispatches read nothing back to the host, under
    ``torch.cuda.set_sync_debug_mode("error")`` (a synchronising call
    raises).  Fused (phase 8): one whole fused dispatch of 4 prefill chunks
    and 4 decodes.  Split: one ``prefill_chunk_paged`` and one
    ``decode_step_paged`` on the served engine's pools (over its mesh, if
    it has one), every row on the scratch block.  Contiguous: two
    ``prefill_chunk`` dispatches (the second behind the first, so the flash
    kernel reads a cached prefix; a VLM's first with image embeds, which
    write the cross K/V) and one ``decode_step`` on a fresh cache."""
    import numpy as np

    b, scratch = 8, eng._scratch_block
    toks = eng._put(np.zeros((b, 32), np.int32))
    last = eng._put(np.full((b,), 31, np.int32))
    lens = eng._put(np.full((b,), 100, np.int32))
    if eng.fused:
        ftoks, ftables, fpos, meta, logit_idx = eng._fused_inputs(eng._build_ragged(
            [(32, 0, None, None)] * 4 + [(1, 100, None, None)] * 4))
    elif eng.paged:
        tables = eng._put(np.full((b, eng._table_width), scratch, np.int32))
        offs = eng._put(np.zeros((b,), np.int32))
    else:
        caches = tf.init_caches(eng.cfg, b, eng.ec.max_model_len, eng.dtype, eng.device)
        img = None
        if eng.cfg.vision_dim:
            img = eng._put(np.zeros((b, eng.cfg.num_image_tokens, eng.cfg.vision_dim),
                                    np.float32))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        if eng.fused:
            x = tf.embed(eng.cfg, eng.params, ftoks[None])
            for lo, pps in tf.segment_spans(eng.cfg):
                x, _ = tf.run_tokens_paged_at(eng.cfg, eng.params, pps, lo, x, eng.pools,
                                              ftables, fpos, meta, mesh=eng.mesh)
            tf.ragged_lm_head(eng.cfg, eng.params, x, logit_idx)
        elif eng.paged:
            tf.prefill_chunk_paged(eng.cfg, eng.params, toks, eng.pools, tables, offs, last,
                                   mesh=eng.mesh)
            tf.decode_step_paged(eng.cfg, eng.params, offs, eng.pools, tables, lens,
                                 mesh=eng.mesh)
        else:
            tf.prefill_chunk(eng.cfg, eng.params, toks, caches, [0] * b, image_embeds=img)
            tf.prefill_chunk(eng.cfg, eng.params, toks, caches, [32] * b)
            tf.decode_step(eng.cfg, eng.params, last, caches, lens)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log(f"  {path_of(eng)} dispatches ran under sync debug mode 'error': no host read-back")


def time_decode_stacking(torch, eng, n: int = 12, names=None):
    """Host-clock time of the contiguous decode's batching: concatenating
    ``n`` requests' B=1 caches (every leaf, or only the leaves ``names``)
    into one batch, as ``RealEngine._decode_contiguous`` does each decode
    step.  Returns the time in ms."""
    caches = [eng._fresh_cache(None) for _ in range(n)]
    keep = {pos: [name for name in c if names is None or name in names]
            for pos, c in caches[0].items()}

    def stack():
        return {pos: {name: torch.cat([c[pos][name] for c in caches], dim=1)
                      for name in leaves} for pos, leaves in keep.items() if leaves}

    stack()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        out = stack()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / reps * 1e3
    nbytes = 2 * sum(leaf.numel() * leaf.element_size()
                     for c in out.values() for leaf in c.values())
    what = "every leaf" if names is None else "leaves " + "/".join(names)
    log(f"  stacking {n} caches of max_model_len {eng.ec.max_model_len} for one decode step "
        f"(torch.cat, {what}): {ms:.3f} ms for {nbytes / 1e6:.1f} MB read and written "
        f"= {nbytes / ms / 1e9:.2f} TB/s")
    del caches, out
    return ms


def profile_steps(torch, eng, steps: int = 6, figures=None, op_names=(), top_ops=False):
    """Where an iteration's time goes, on the served engine with 8 fresh
    offline requests (64-token prompts) decoding: ``steps`` steps timed
    without the profiler, then ``steps`` more under ``torch.profiler``.
    Prints the device-busy time per step over both step times (the
    profiler stretches a step) and the kernels by device time: the ten
    largest and every kernel of the port.  Returns the rows (device us,
    calls, name) per step, or None where the profiler cannot trace the
    card: that is reported, not fatal.  ``figures`` (a dict) receives the
    step and busy times as text, and the p50 and p99 of the engine's
    ``host_gap_s`` samples over the unprofiled steps (``"gap"``).  It also
    prints the device time per step of the kernels launched by each
    operator of ``op_names`` (for example ``aten::bmm``, the MoE experts),
    and with ``top_ops`` the eight operators with the most device time."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.request import Priority, Request

    rng = np.random.default_rng(1)
    for _ in range(8):
        prompt = rng.integers(0, eng.cfg.vocab_size, 64).astype(np.int32)
        eng.submit(Request(Priority.OFFLINE, prompt_len=64, max_new_tokens=32, prompt=prompt))
    for _ in range(4):  # the prefill steps
        eng.step()
    torch.cuda.synchronize()
    g0 = len(eng.host_gap_s)
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    plain = time.perf_counter() - t0
    gaps = sorted(eng.host_gap_s[g0:])  # only the fused path samples them
    if figures is not None and gaps:
        figures["gap"] = (f"host_gap_s over {len(gaps)} steps: p50 "
                          f"{gaps[len(gaps) // 2] * 1e3:.3f} ms, p99 "
                          f"{gaps[min(len(gaps) - 1, int(0.99 * len(gaps)))] * 1e3:.3f} ms")
        log(f"  {figures['gap']}")
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                eng.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # kernels only: an operator's row repeats the device time of the
        # kernels it launched
        events = prof.key_averages()
        rows = [(getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0),
                 e.count, e.key) for e in events
                if e.device_type == torch.autograd.DeviceType.CUDA]
        op_ms = {e.key: (getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0))
                 / steps / 1e3 for e in events
                 if e.key in op_names or (top_ops and e.key.startswith("aten::"))}
    except Exception as e:  # noqa: BLE001 -- a measurement, not the port
        log(f"  profiler unavailable: {e!r}")
        return None
    rows = sorted(((us / steps, n // steps, name) for us, n, name in rows if us > 0),
                  reverse=True)
    if not rows:
        log("  profiler unavailable: no device time in its trace")
        return None
    busy = sum(r[0] for r in rows) * steps / 1e6
    text = (f"{plain * 1e3 / steps:.2f} ms per step without the profiler, "
            f"{wall * 1e3 / steps:.2f} ms with it (host clock); device busy "
            f"{busy * 1e3 / steps:.2f} ms per step = {busy / plain:.1%} of an unprofiled step "
            f"({busy / wall:.1%} of a profiled one)")
    log(f"  decode steps: {text}")
    if figures is not None:
        figures["decode"] = text
    if op_names:
        log("  by operator: " + ", ".join(
            f"{name} {op_ms.get(name, 0.0):.3f} ms/step = "
            f"{op_ms.get(name, 0.0) / (busy * 1e3 / steps):.1%} of device busy"
            for name in op_names))
    if top_ops:
        log("  top operators by device time: " + ", ".join(
            f"{name} {ms:.3f} ms/step" for name, ms in sorted(
                op_ms.items(), key=lambda kv: -kv[1])[:8]))
    for i, (us, n, name) in enumerate(rows):
        if i < 10 or "(anonymous namespace)::" in name:
            log(f"    {us / 1e3:8.3f} ms/step  {n:5d} calls/step  {name[:90]}")
    return rows


def check_split_decode_kernel(rows, cfg):
    """Phase 3b: the profiled split decode steps ran the bf16 tensor-core
    decode kernel and not the CUDA-core one (skipped where the profiler
    could not trace the card; the serve's launch count, exact, is checked
    in ``run_serve``)."""
    if rows is None:
        return
    d = cfg.resolved_head_dim
    tc = [(us, n) for us, n, name in rows if f"paged_tc_kernel<{d}>" in name]
    old = [name for _us, _n, name in rows if "decode_kernel" in name]
    if not tc or old:
        raise AssertionError(f"split decode step: paged_tc_kernel<{d}> rows {tc}, "
                             f"CUDA-core decode kernels {old}")
    log(f"  split decode step: paged_tc_kernel<{d}> {tc[0][1]} calls and {tc[0][0] / 1e3:.3f} ms "
        f"per step ({cfg.num_layers} layers), no decode_kernel")


# ------------------------------------------------------------------- phase 5
# Contexts of a few thousand tokens at the Llama-2-7B shape, bf16: a decode
# batch (Qmax 1) and a fused batch of prefill chunks among decodes (Qmax 32).
LONG_CASES = {
    "decode": dict(q_lens=(1,) * 16, qmax=1,
                   kv_lens=tuple(2048 + 128 * i for i in range(16))),
    "prefill chunks + decodes": dict(q_lens=(32,) * 4 + (1,) * 12, qmax=32,
                                     kv_lens=tuple(2048 + 128 * i for i in range(16))),
}


def attention_entry(torch, rpa, args, spec, timer):
    """Time, plain time and bound of one ragged attention call; raises if
    the kernel disagrees with its plain version on these inputs."""
    q, kp, vp, tb, qp, kvl, cap = args
    dname = "bfloat16" if q.dtype == torch.bfloat16 else "float32"
    got = rpa.ragged_paged_attention(q, kp, vp, tb, qp, kvl, logit_softcap=cap)
    splits, keys = rpa.ragged_paged_attention.last_splits  # the plan this call launched
    want = rpa.ragged_paged_attention_ref(q, kp, vp, tb, qp, kvl, logit_softcap=cap)
    err = (got.float() - want.float()).abs().max().item()
    if not torch.allclose(got.float(), want.float(), **TOL[dname]):
        raise AssertionError(f"ragged_paged_attention disagrees at {tuple(q.shape)} "
                             f"kv_lens={kvl.tolist()}: max_abs_err={err:.3e}")
    bound, by = attention_bound(torch, q, kp, tb, qp, kvl, PEAK_FLOPS[dname], spec.hbm_bw)
    return {
        "max_abs_err": err, "splits": splits, "split_keys": keys,
        **timed(timer, lambda: rpa.ragged_paged_attention(q, kp, vp, tb, qp, kvl,
                                                          logit_softcap=cap)),
        "plain_ms": timer.ms(lambda: rpa.ragged_paged_attention_ref(q, kp, vp, tb, qp, kvl, logit_softcap=cap)),
        "bound_ms": bound, "bound_by": by,
        "shape": {"q": list(q.shape), "pool": list(kp.shape), "tables": list(tb.shape),
                  "kv_lens": kvl.tolist(), "dtype": dname},
    }


def decode_entry(torch, rpa, args, spec, timer):
    """Time, plain time and bound of one decode attention call, and the key
    splits it runs; raises if the kernel disagrees with its plain version on
    these inputs."""
    q, kp, vp, tb, lens, cap = args
    dname = "bfloat16" if q.dtype == torch.bfloat16 else "float32"
    got = rpa.paged_attention(q, kp, vp, tb, lens, logit_softcap=cap)
    splits, keys = rpa.paged_attention.last_splits  # the plan this call launched
    want = rpa.paged_attention_ref(q, kp, vp, tb, lens, logit_softcap=cap)
    err = (got.float() - want.float()).abs().max().item()
    if not torch.allclose(got.float(), want.float(), **TOL[dname]):
        raise AssertionError(f"paged_attention disagrees at {tuple(q.shape)} "
                             f"seq_lens={lens.tolist()}: max_abs_err={err:.3e}")
    bound, by = decode_bound(torch, q, kp, tb, lens, PEAK_FLOPS[dname], spec.hbm_bw)
    return {
        "max_abs_err": err, "splits": splits, "split_keys": keys,
        **timed(timer, lambda: rpa.paged_attention(q, kp, vp, tb, lens, logit_softcap=cap)),
        "plain_ms": timer.ms(lambda: rpa.paged_attention_ref(q, kp, vp, tb, lens, logit_softcap=cap)),
        "bound_ms": bound, "bound_by": by,
        "shape": {"q": list(q.shape), "pool": list(kp.shape), "tables": list(tb.shape),
                  "seq_lens": lens.tolist(), "dtype": dname},
    }


def long_context_entries(torch, rpa, spec, timer, shape=(32, 32, 128), qwen=True):
    """Both paged attention kernels on the same long-context inputs: the
    ragged kernel on every ``LONG_CASES`` batch at ``shape`` (H, Hkv, D;
    Llama-2-7B's by default, gemma-7b's in phase 10) and, with ``qwen``, on
    the decode batch at the Qwen2-0.5B shape (14 query heads on 2 KV heads,
    D = 64), the decode kernel on the decode batches recast as q (B, H, D)
    and seq_lens = kv_lens (at Qwen2-0.5B's 32 (sequence, KV head) pairs it
    splits the keys)."""
    ragged, decode = [], []
    cases = [(case, kw, shape) for case, kw in LONG_CASES.items()]
    if qwen:
        cases.append(("qwen2-0.5b decode", LONG_CASES["decode"], (14, 2, 64)))
    arch = "gemma-7b" if shape[2] == 256 else "llama-2-7b"
    for case, kw, (h, hkv, d) in cases:
        args = attention_case(torch, torch.bfloat16, h, hkv, d, 0.0, 3, **kw)
        lens = f"{min(kw['kv_lens'])}..{max(kw['kv_lens'])}"
        entry = {"case": case, **attention_entry(torch, rpa, args, spec, timer)}
        entry["shape"]["kv_lens"] = lens
        log(f"  ragged_paged_attention, {case}: {entry}")
        log_previous_ragged(case if case.startswith("qwen") else f"{arch} {case}", entry)
        ragged.append(entry)
        if kw["qmax"] == 1:
            q, kp, vp, tb, _qp, kvl, cap = args
            entry = {"case": case, **decode_entry(
                torch, rpa, (q[:, 0].contiguous(), kp, vp, tb, kvl, cap), spec, timer)}
            entry["shape"]["seq_lens"] = lens
            log(f"  paged_attention, {case}: {entry}")
            decode.append(entry)
        del args
    return ragged, decode


# The time of the mma.sync bf16 flash kernel that the wgmma one replaced, on
# each timed input, in ms, copied from PERF.md (row 4: its last runs on an
# NVIDIA H100 80GB HBM3 at 700 W).  Not measured here: ``log_previous``
# prints it beside this run's time, and no JSON line carries it.
PREVIOUS_FLASH_MS = {
    "llama-2-7b contiguous": 0.0136, "llama-2-7b forward_full T=2048": 0.2920,
    "llama-2-7b forward_full T=4096": 0.9704, "gemma-7b contiguous": 0.0192,
    "gemma-7b forward_full T=2048": 0.3844, "gemma-7b forward_full T=4096": 1.2740,
    "forward_full T=8192 window 4096": 3.884, "heaviest mixtral ring prefill chunk": 0.3918,
    "hubert-xlarge": 0.1785, "heaviest cross-attention prefill chunk": 0.0262,
    "largest cross-attention decode batch": 0.0278,
}


# The same for the mma.sync bf16 ragged kernel that the wgmma one replaced:
# its times in run F1 (PERF.md row 1; row 5 for one shard's launch and the
# sharded call at tp 2), on the inputs phase 5, 8 and 10(d) time.
PREVIOUS_RAGGED_MS = {
    "llama-2-7b fused": 0.0207, "llama-2-7b decode": 0.3164,
    "llama-2-7b prefill chunks + decodes": 0.3565, "qwen2-0.5b decode": 0.1162,
    "gemma-7b fused": 0.0223, "gemma-7b decode": 0.5362,
    "gemma-7b prefill chunks + decodes": 0.5810,
    "tp=2 shard launch": 0.0150, "tp=2 sharded call": 0.0405,
}


def log_previous(key, entry, name="flash_attention", previous=PREVIOUS_FLASH_MS, ms="ms"):
    """Logs a flash (or ragged) entry's time beside the replaced kernel's on
    the same input (PREVIOUS_FLASH_MS or PREVIOUS_RAGGED_MS, where it was
    timed)."""
    was = previous.get(key)
    if was is not None:
        log(f"  {name}, {key}: {entry[ms]:.5f} ms against the replaced mma.sync "
            f"kernel's {was} ms (copied from PERF.md, not measured in this run): "
            f"{was / entry[ms]:.2f}x faster")


def log_previous_ragged(key, entry, ms="ms"):
    log_previous(key, entry, "ragged_paged_attention", PREVIOUS_RAGGED_MS, ms)


def flash_keep(torch, tq, tk, causal, window, q_offset):
    """The (Tq, Tk) mask of kept (query, key) pairs, on the CPU."""
    qp = q_offset + torch.arange(tq)[:, None]
    kp = torch.arange(tk)[None, :]
    keep = torch.ones((tq, tk), dtype=torch.bool)
    if causal:
        keep &= kp <= qp
    if window:
        keep &= kp > qp - window
    return keep


def flash_bound(torch, q, k, kw, peak_flops, hbm_bw):
    """The least time of one flash attention call on these inputs: 4 * D
    flops per kept (query head, query, key) triple over the peak rate, or
    the bytes over the HBM rate -- q read, the K/V rows some query keeps
    read once, the output written -- whichever is larger."""
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    keep = flash_keep(torch, tq, tk, kw["causal"], kw["sliding_window"], kw["q_offset"])
    pairs = int(keep.sum())
    keys = int(keep.any(dim=0).sum())
    elt = q.element_size()
    nbytes = 2 * b * tq * h * d * elt + 2 * b * keys * hkv * d * elt
    flops = 4 * d * h * b * pairs
    t_b, t_f = nbytes / hbm_bw * 1e3, flops / peak_flops * 1e3
    return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations"), pairs


def sdpa_call(torch, q, k, v, kw):
    """One ``scaled_dot_product_attention`` call computing the same function
    on the same inputs (the yardstick; the port never calls it), or None
    where it has no counterpart (a softcap)."""
    if kw["logit_softcap"]:
        return None
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    extra = {"enable_gqa": True} if q.shape[2] != k.shape[2] else {}
    tq, tk = q.shape[1], k.shape[1]
    if not kw["causal"] and not kw["sliding_window"]:
        return lambda: sdpa(qt, kt, vt, **extra)
    if kw["causal"] and not kw["q_offset"] and not kw["sliding_window"] and tq == tk:
        return lambda: sdpa(qt, kt, vt, is_causal=True, **extra)
    mask = flash_keep(torch, tq, tk, kw["causal"], kw["sliding_window"],
                      kw["q_offset"]).to(q.device)
    return lambda: sdpa(qt, kt, vt, attn_mask=mask, **extra)


def flash_entry(torch, fa, args, spec, timer):
    """Time, plain time, SDPA time and bound of one flash attention call;
    raises if the kernel disagrees with its plain version on these inputs."""
    q, k, v, kw = args
    dname = "bfloat16" if q.dtype == torch.bfloat16 else "float32"
    got = fa.flash_attention(q, k, v, **kw)
    want = fa.flash_attention_ref(q, k, v, **kw)
    err = (got.float() - want.float()).abs().max().item()
    if not torch.allclose(got.float(), want.float(), **TOL[dname]):
        raise AssertionError(f"flash_attention disagrees at q{tuple(q.shape)} k{tuple(k.shape)} "
                             f"{kw}: max_abs_err={err:.3e}")
    del got, want
    bound, by, pairs = flash_bound(torch, q, k, kw, PEAK_FLOPS[dname], spec.hbm_bw)
    lib = sdpa_call(torch, q, k, v, kw)
    return {
        "max_abs_err": err,
        **timed(timer, lambda: fa.flash_attention(q, k, v, **kw)),
        "plain_ms": timer.ms(lambda: fa.flash_attention_ref(q, k, v, **kw), reps=5),
        "bound_ms": bound, "bound_by": by,
        "library_ms": None if lib is None else timer.ms(lib),
        "shape": {"q": list(q.shape), "k": list(k.shape), "dtype": dname,
                  "kept_pairs_per_head": pairs, **kw},
    }


def flash_long_entries(torch, fa, spec, timer, shape=(32, 32, 128), arch="llama-2-7b",
                       ts=(2048, 4096)):
    """The flash kernel at forward_full's shapes: one sequence of each of
    ``ts`` tokens at ``shape`` (H, Hkv, D; Llama-2-7B's by default),
    causal, bf16."""
    out = []
    h, hkv, d = shape
    for t in ts:
        q, k, v = flash_case(torch, torch.bfloat16, h, hkv, d, 1, t, t, 6, spare=0)
        kw = dict(causal=True, sliding_window=0, q_offset=0, logit_softcap=0.0)
        entry = {"case": f"forward_full T={t}", "arch": arch,
                 **flash_entry(torch, fa, (q, k, v, kw), spec, timer)}
        log(f"  flash_attention, {arch} forward_full T={t} ({h} / {hkv} heads of {d}): {entry}")
        log_previous(f"{arch} forward_full T={t}", entry)
        out.append(entry)
        del q, k, v
    return out


def forward_full_check(torch, ops, fa, tf, t: int = 2048, arch: str = "llama-2-7b"):
    """Phase 4b (and 10(c) for gemma-7b): ``forward_full`` of ``arch`` at
    full width, fp32 weights from a seed, on one ``t``-token sequence: flash
    kernel launches counted (zeroed just before, read just after), then the
    same forward with the kernel's plain version; the last position's
    logits must agree within FULL_TOL."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tf.init_params(cfg, gen, dtype=torch.float32)
    toks = torch.randint(0, cfg.vocab_size, (1, t), generator=gen, device="cuda")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, _, _ = tf.forward_full(cfg, params, toks)
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t0
    launches = ops.launch_counts()["flash_attention"]
    got = logits[0, -1].clone()
    del logits
    kernel = ops.flash_attention
    ops.flash_attention = lambda q, k, v, **kw: fa.flash_attention_ref(q, k, v, **kw)
    try:
        t0 = time.perf_counter()
        logits, _, _ = tf.forward_full(cfg, params, toks)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    finally:
        ops.flash_attention = kernel
    want = logits[0, -1]
    err = (got - want).abs().max().item()
    log(f"  {arch} forward_full (1, {t}) fp32: flash_attention launches={launches}; last-position "
        f"logits kernel vs plain max_abs_err={err:.3e} (|logits| max "
        f"{want.abs().max().item():.3f}; tolerance {FULL_TOL}); argmax "
        f"{int(got.argmax())} vs {int(want.argmax())}; {kernel_s * 1e3:.1f} ms vs "
        f"{plain_s * 1e3:.1f} ms (host clock, first call)")
    if launches != cfg.num_layers:
        raise AssertionError(f"forward_full launched flash_attention {launches} times, "
                             f"not once per layer ({cfg.num_layers})")
    if not torch.isfinite(got).all() or not torch.allclose(got, want, **FULL_TOL):
        raise AssertionError("forward_full: kernel path disagrees with the plain path")
    del params, logits
    torch.cuda.empty_cache()
    return launches


def kernel_line(torch, rpa, cg, fa, counts, split_counts, contiguous_counts, full_launches,
                args, split_args, contiguous_args, spec, timer):
    main = attention_entry(torch, rpa, args["ragged_paged_attention"], spec, timer)
    log(f"  ragged_paged_attention, heaviest main-path call: {main}")
    log_previous_ragged("llama-2-7b fused", main)
    dmain = decode_entry(torch, rpa, split_args["paged_attention"], spec, timer)
    log(f"  paged_attention, heaviest split-path call: {dmain}")
    long_ragged, long_decode = long_context_entries(torch, rpa, spec, timer)
    shape, dshape = main.pop("shape"), dmain.pop("shape")
    out = [{
        "name": "ragged_paged_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/ragged_paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:217",
        "launches": counts["ragged_paged_attention"],
        "merge_launches": counts["ragged_paged_attention merges"], **main,
        "library_ms": None, "shape": shape, "long_context": long_ragged,
    }, {
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:87",
        "launches": split_counts["paged_attention"],
        "merge_launches": split_counts["paged_attention merges"], **dmain,
        "library_ms": None, "shape": dshape, "long_context": long_decode,
    }]
    fmain = flash_entry(torch, fa, contiguous_args["flash_attention"], spec, timer)
    log(f"  flash_attention, heaviest contiguous-path call: {fmain}")
    log_previous("llama-2-7b contiguous", fmain)
    fshape = fmain.pop("shape")
    out.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:107",
        "launches": contiguous_counts["flash_attention"],
        "launches_forward_full": full_launches, **fmain, "shape": fshape,
        "long_context": flash_long_entries(torch, fa, spec, timer)
        + flash_long_entries(torch, fa, spec, timer, VLM_SHAPE, "llama-3.2-vision-11b",
                             ts=(4096,)),
    })
    out.append({
        "name": "checkpoint_gather", "route": "cuda",
        "source": "src/repro_torch/csrc/checkpoint_gather.cu",
        "replaces": "src/repro/kernels/kv_checkpoint.py:30",
        "launches": counts["checkpoint_gather"],
        **gather_entry(torch, cg, *args["checkpoint_gather"], spec, timer, control=True),
    })
    return out


def gather_entry(torch, cg, pool, ids, spec, timer, control=False):
    """Time, plain time, ``index_select`` time and bound of one checkpoint
    gather; raises unless it equals its plain version exactly.  ``control``
    adds its time under the Timer of earlier runs."""
    got = cg.checkpoint_gather(pool, ids)
    want = cg.checkpoint_gather_ref(pool, ids)
    if not torch.equal(got, want):
        raise AssertionError(f"checkpoint_gather disagrees at pool {tuple(pool.shape)}, "
                             f"{ids.numel()} ids")
    err = (got.float() - want.float()).abs().max().item()
    nbytes = 2 * got.numel() * got.element_size() + ids.numel() * 4
    entry = {"max_abs_err": err, **timed(timer, lambda: cg.checkpoint_gather(pool, ids))}
    if control:  # the unchanged kernel under the Timer of earlier runs
        entry["old_timer_ms"] = Timer(torch, device_wait=False).ms(
            lambda: cg.checkpoint_gather(pool, ids))
    return {
        **entry,
        "plain_ms": timer.ms(lambda: cg.checkpoint_gather_ref(pool, ids)),
        "bound_ms": nbytes / spec.hbm_bw * 1e3, "bound_by": "bytes",
        "library_ms": timer.ms(lambda: pool.index_select(1, ids)),
        "shape": {"pool": list(pool.shape), "ids": ids.numel(), "dtype": str(pool.dtype)},
    }


def add_build_reports(build, builds, line, ragged_args, decode_args, dims=(64, 128)):
    """Each kernel's ptxas report per instantiation (``build``), with the
    dynamic shared memory of a block of each attention kernel (bf16 tensor
    core and fp32) at a head dim of ``dims``: the flash kernel's is fixed,
    the ragged and decode kernels' at their paths' heaviest calls (Qmax * G
    rows or G heads, page size, table width)."""
    q, kp, _vp, tb = ragged_args[:4]
    rows, page, m = q.shape[1] * (q.shape[2] // kp.shape[2]), kp.shape[1], tb.shape[1]
    group, split_m = decode_args[0].shape[1] // decode_args[1].shape[2], decode_args[3].shape[1]
    split_page = decode_args[1].shape[1]
    for entry in line:
        name = entry["name"]
        report = builds.get(name)
        entry["build"] = report if report else "not built in this run"
        for inst, r in (report or {}).items():
            d = re.search(r"(_tc_kernel<|_wg_kernel<|<float, )(\d+)", inst)
            if not d or int(d[2]) not in dims:
                continue
            dtype, d = int(d[1] != "<float, "), int(d[2])
            if name == "flash_attention":
                r["dynamic_smem"] = smem_bytes(build, name, dtype, d)
            elif name == "ragged_paged_attention":
                r["dynamic_smem"] = smem_bytes(build, name, dtype, d, rows, page, m)
                r["dynamic_smem_at"] = {"rows": rows, "page": page, "table_width": m}
            elif name == "paged_attention" and "merge" not in inst:
                r["dynamic_smem"] = smem_bytes(build, name, dtype, d, group, split_page,
                                               split_m)
                r["dynamic_smem_at"] = {"group": group, "page": split_page,
                                        "table_width": split_m}


def calibrated_serve(torch, serve_mod, path, argv, mesh=None) -> str:
    """Calibrate a bf16 engine (``--calibrate``), print its profile, and
    serve phase 3's workload on it; returns the profile as text."""
    names = ("c0 (s)", "prefill token", "prefill attention token", "decode token",
             "decode context token")
    t0 = time.perf_counter()
    res = serve(serve_mod, argv + ["--calibrate"], mesh)
    eng = res["engine"]
    prof = eng.profile
    if prof is None or eng.sched.model is not prof:
        raise AssertionError(f"{path}: calibrate() installed no measured profile")
    coef = ", ".join(f"{n} {c:.4g}" for n, c in zip(names, prof._coef))
    text = (f"{len(prof.samples)} probes + {len(prof.swap_samples)} swap probes; "
            f"profile s/iteration = {coef}; swap "
            f"{None if prof._swap_coef is None else prof._swap_coef.tolist()}")
    log(f"  {path}: {text}; calibration and serving took {time.perf_counter() - t0:.1f} s")
    reqs = [h.request for h in res["streams"]] + list(res["job"].requests)
    if any(len(r.output_tokens) != MAX_NEW for r in reqs):
        raise AssertionError(f"{path}: a request lacks tokens after calibration")
    log(f"  {path} calibrated: {iteration_figures(eng)}")
    del res, eng
    torch.cuda.empty_cache()
    return text


def calibrated_serves(torch, serve_mod, uncalibrated):
    """Phase 6: calibrate a bf16 engine of each path, print its profile, and
    serve phase 3's workload on it; measured against predicted seconds per
    iteration beside the uncalibrated runs' figures.  Returns the fused
    path's profile as text."""
    profiles = {}
    for path, extra in (("fused", []), ("split", ["--no-fused-batch"]),
                        ("contiguous", ["--backend", "contiguous"])):
        phase = {"fused": "3", "split": "3b", "contiguous": "3c"}[path]
        log(f"  {path} uncalibrated (phase {phase}): {uncalibrated[path]}")
        profiles[path] = calibrated_serve(torch, serve_mod, path, SERVE_ARGV + extra)
    return profiles["fused"]


# ------------------------------------------------------------------- phase 7
# (a): the fused engine of ``--mode wallclock`` at full width and bf16, its
# context raised to phase 3's lengths, on a pool that forces preemption
WALL_ARGV = ["--mode", "wallclock", "--full", "--device", "cuda", "--dtype", "bfloat16",
             "--num-device-blocks", "96"]
WALL_CONTEXT = 256
# the replayed trace: gamma arrivals of online requests (64-token prompts),
# and an offline batch (128-token prompts) submitted at t = 0; 48 new tokens
WALL_RATE, WALL_CV, WALL_SECONDS, WALL_OFFLINE = 2.0, 1.0, 20.0, 16
# (c): phase 4's requests replayed at fp32 under ManualClock(auto_tick=1e-3)
# with TTFT SLO 0 (Algorithm 2 trips on any arrival into a pure-offline
# batch): the offline jobs at t = 0, the online requests at these times.
# The plans and the clock's readings depend on the depth and the lengths,
# not on the width or the device: at 32 layers the first two arrivals land
# at a safepoint of a pure-offline iteration and abort it; the last two
# land while online work runs.
REPLAY_ONLINE_AT = (0.040, 0.380, 0.600, 0.900)


class AbortProbe:
    """Per safepoint abort of an engine under the runtime: the host time from
    the trigger (a drained online arrival setting the preemption flag, the
    runtime's ``_abort_trigger_t``) to the abort and to the first launch of
    that request's prefill, and on the device the work still queued at the
    abort (an event recorded behind it on the engine's stream, against one
    recorded at the same moment on an idle side stream) and the time from
    the abort to the prefill's start.  Wraps the engine instance's methods;
    ``close()`` restores them."""

    def __init__(self, torch, eng):
        self.torch, self.eng = torch, eng
        self.side = torch.cuda.Stream(eng.device)
        self.trigger = None  # (host time, request) of the flag-setting arrival
        self.aborts = []
        on_arrival, run, build = eng.on_online_arrival, eng.safepoints.run, eng._build_fused

        def on_online_arrival(req):
            was = eng.flag.is_set()
            on_arrival(req)
            if eng.flag.is_set() and not was:
                self.trigger = (time.perf_counter(), req)

        def safepoints_run(*a, **kw):
            completed, done = run(*a, **kw)
            if not completed and self.trigger is not None:
                self.aborts.append({"trigger": self.trigger[0], "request": self.trigger[1],
                                    "abort": time.perf_counter(), "segment": done,
                                    "now": self.event(self.side), "queued": self.event(None),
                                    "launch": None, "launch_event": None})
                self.trigger = None
            return completed, done

        def build_fused(plan):
            out = build(plan)
            chunked = {c.request.request_id for c in plan.prefill_chunks}
            for a in self.aborts:
                if a["launch"] is None and a["request"].request_id in chunked:
                    a["launch"], a["launch_event"] = time.perf_counter(), self.event(None)
            return out

        eng.on_online_arrival = on_online_arrival
        eng.safepoints.run = safepoints_run
        eng._build_fused = build_fused

    def event(self, stream):
        torch = self.torch
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream if stream is not None else torch.cuda.current_stream(self.eng.device))
        return ev

    def close(self):
        eng = self.eng
        del eng.on_online_arrival, eng.safepoints.run, eng._build_fused  # the class's

    def report(self, label):
        self.torch.cuda.synchronize(self.eng.device)
        rows = []
        for i, a in enumerate(self.aborts):
            queued = max(0.0, a["now"].elapsed_time(a["queued"]))
            row = {"segment": a["segment"],
                   "trigger_to_abort_ms": (a["abort"] - a["trigger"]) * 1e3,
                   "device_queued_at_abort_ms": queued}
            if a["launch"] is not None:
                row["trigger_to_prefill_launch_ms"] = (a["launch"] - a["trigger"]) * 1e3
                row["device_abort_to_prefill_start_ms"] = a["now"].elapsed_time(a["launch_event"])
            rows.append(row)
            log(f"  {label} abort {i}: " + ", ".join(
                f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}" for k, v in row.items()))
        return rows


def wall_trace(loadgen, vocab):
    """Phase 7(a)'s trace, from seed 7."""
    import numpy as np

    rng = np.random.default_rng(7)
    times = loadgen.gamma_arrivals(WALL_RATE, WALL_CV, WALL_SECONDS, rng)
    online = loadgen.make_online_requests(times, loadgen.LengthSpec(64, MAX_NEW), rng)
    offline = loadgen.make_offline_batch(WALL_OFFLINE, loadgen.LengthSpec(128, MAX_NEW), rng)
    return loadgen.attach_prompts(online + offline, vocab, rng)


def check_served(label, rt, m, reqs):
    """Every request finished with all its tokens; the replay did not run
    out of steps; the runtime is not FAILED."""
    short = [r.request_id for r in reqs if len(r.output_tokens) != r.max_new_tokens]
    health, _age = rt.check_health()
    if rt.stats.steps_exhausted:
        raise AssertionError(f"{label}: the replay exhausted its steps")
    if m.num_finished != len(reqs) or short:
        raise AssertionError(f"{label}: {m.num_finished} of {len(reqs)} requests finished; "
                             f"without all their tokens: {short}")
    if health.name == "FAILED":
        raise AssertionError(f"{label}: runtime health FAILED")
    return health


def replay_bf16(torch, ops, serve_mod, args):
    """Phase 7(a): the calibrated bf16 fused engine replays ``wall_trace``
    through ``CoServingRuntime.replay`` on the host clock; kernel launches
    counted (zeroed just before, read just after), every step's host time
    kept, every abort probed.  Returns (cfg, params, counts)."""
    import statistics as st

    from repro_torch.models import transformer as tf
    from repro_torch.serving import loadgen
    from repro_torch.serving.runtime import CoServingRuntime

    cfg, params = serve_mod.wallclock_model(args)
    eng = serve_mod.wallclock_engine(cfg, params, args, max_model_len=WALL_CONTEXT)
    t0 = time.perf_counter()
    t_chunk = serve_mod.calibrate_wallclock(eng, args)
    log(f"  calibrated in {time.perf_counter() - t0:.1f} s: one 32-token chunk {t_chunk * 1e3:.2f} "
        f"ms, SLO TTFT {eng.sched.slo.ttft * 1e3:.2f} ms (3x) TPOT {eng.sched.slo.tpot * 1e3:.0f} ms")
    reqs = wall_trace(loadgen, cfg.vocab_size)
    n_on = sum(r.is_online for r in reqs)
    log(f"  trace: {n_on} online (gamma rate {WALL_RATE}/s cv {WALL_CV} over {WALL_SECONDS:g} s, "
        f"64-token prompts) + {len(reqs) - n_on} offline at t=0 (128-token prompts), "
        f"{MAX_NEW} new tokens each; pool {eng.ec.num_device_blocks} blocks of "
        f"{eng.ec.block_size}, at most {eng.sched.sc.max_batch_seqs} sequences per iteration")
    steps = []
    step = eng.step

    def timed_step():
        s0 = time.perf_counter()
        alive = step()
        steps.append(time.perf_counter() - s0)
        return alive

    eng.step = timed_step
    rt = CoServingRuntime(eng)
    probe = AbortProbe(torch, eng)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    try:
        m = rt.replay(reqs)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    finally:
        probe.close()
        del eng.step
    health = check_served("7(a)", rt, m, reqs)
    log(f"  P99 TTFT {m.p99_ttft * 1e3:.2f} ms, P99 TPOT {m.p99_tpot * 1e3:.2f} ms; SLO attainment "
        f"TTFT {m.ttft_slo_attainment:.4f} TPOT {m.tpot_slo_attainment:.4f}; processed tok/s "
        f"online {m.online_throughput:.1f} offline {m.offline_throughput:.1f}; generated tok/s "
        f"online {m.online_gen_throughput:.1f} offline {m.offline_gen_throughput:.1f} over "
        f"{rt.duration:.2f} s (host clock)")
    log(f"  steps={eng.steps} safepoint_aborts={rt.stats.safepoint_aborts} "
        f"preemptions={m.num_preemptions} ckpt_blocks={eng.ckpt.stats.blocks_checkpointed} "
        f"ckpt_gather_rounds={eng.ckpt_gathers} restored_blocks={eng.restored_blocks} "
        f"health={health.name} finished={m.num_finished}/{len(reqs)}")
    log(f"  launches: {counts}")
    if not counts["ragged_paged_attention"] or not counts["checkpoint_gather"]:
        raise AssertionError("7(a): the runtime did not launch the ragged attention and the "
                             "checkpoint gather kernels")
    if counts["ragged_paged_attention"] != cfg.num_layers // len(
            tf.segment_spans(cfg)) * eng.dispatches["fused_segment"]:
        raise AssertionError("7(a): ragged_paged_attention launches != layers of the segments run")
    q = st.quantiles([s * 1e3 for s in steps], n=10)
    log(f"  host step under the runtime: {len(steps)} steps, median {st.median(steps) * 1e3:.2f} ms, "
        f"p10 {q[0]:.2f} ms, p90 {q[-1]:.2f} ms; {iteration_figures(eng)}")
    log(f"  abort latency (runtime, host clock): {[round(x * 1e3, 3) for x in rt.stats.preemption_latencies]} ms")
    probe.report("7(a)")
    del rt, eng, reqs
    torch.cuda.empty_cache()
    return cfg, params, counts


def http_get(url):
    """GET on 127.0.0.1 with proxies off: (status, body)."""
    import urllib.error
    import urllib.request

    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    try:
        with opener.open(url, timeout=30) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


class StepWindows:
    """Wraps an engine's ``step`` on the runtime's engine thread.  On
    request (``measure``) it times the next ``n`` steps as one window: each
    ``step()`` and the window's wall time, which also holds the runtime
    loop's work between steps.  The requester blocks on an event or, with
    ``poll_s``, sleeps in a loop as ``launch.serve``'s API thread does while
    it waits for the next arrival.  With ``profiled`` the engine thread runs
    the window under ``torch.profiler`` itself (a profiler on another
    thread does not always see its kernels) and the window gets the device
    time of the kernels, copies and fills in the trace."""

    def __init__(self, torch, eng):
        import threading

        self.torch, self.eng, self.step = torch, eng, eng.step
        self.want, self.result, self.done = None, None, threading.Event()
        eng.step = self

    def __call__(self):
        w = self.want
        if w is not None and not w["steps"]:
            if w["profiled"]:
                from torch.profiler import ProfilerActivity, profile

                w["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                w["prof"].__enter__()
            w["t0"] = time.perf_counter()
        s0 = time.perf_counter()
        alive = self.step()
        if w is not None:
            w["steps"].append(time.perf_counter() - s0)
            if len(w["steps"]) == w["n"]:
                w["wall"] = time.perf_counter() - w["t0"]
                if w["profiled"]:
                    self.torch.cuda.synchronize(self.eng.device)
                    prof = w.pop("prof")
                    prof.__exit__(None, None, None)
                    w["device_us"] = device_time_us(prof)
                self.result, self.want = w, None
                self.done.set()
        return alive

    def measure(self, n=6, profiled=False, poll_s=None, timeout=120.0):
        self.done.clear()
        self.want = {"n": n, "profiled": profiled, "steps": []}
        if poll_s is None:
            ended = self.done.wait(timeout)
        else:
            t0 = time.perf_counter()
            while not self.done.is_set() and time.perf_counter() - t0 < timeout:
                time.sleep(poll_s)
            ended = self.done.is_set()
        if not ended:
            raise AssertionError("7(b): a window of steps did not end")
        return self.result

    def close(self):
        del self.eng.step


def device_time_us(prof) -> float:
    """Device time of the kernels, copies and fills in a profile's trace."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
    return sum(e.get("dur", 0) for e in events
               if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))


def threaded_serve(torch, serve_mod, cfg, params, args, decode_phase3):
    """Phase 7(b): the threaded runtime with the metrics server on
    127.0.0.1 (an ephemeral port).  8 offline jobs (64-token prompts:
    phase 3's profiled decode batch) first decode on the engine alone, 12
    steps timed on this thread; then ``start()`` takes them over and their
    decode steps are measured while the runtime runs (``StepWindows``: 12
    steps with this thread blocked, 12 with it polling every 5 ms, 6
    profiled).  Then, through a ``Frontend``, 4 streams with a consumer
    thread each and one ``submit_batch`` of 4 offline jobs; the metrics text
    and ``/health`` scraped; ``stop(drain=True)``.  Each stream must receive
    exactly its request's tokens and every request must finish."""
    import threading

    import numpy as np

    from repro_torch.core.request import Phase, Priority, Request
    from repro_torch.serving.api import Frontend
    from repro_torch.serving.runtime import CoServingRuntime

    eng = serve_mod.wallclock_engine(cfg, params, args, max_model_len=WALL_CONTEXT)
    rng = np.random.default_rng(11)
    first = [Request(Priority.OFFLINE, prompt_len=64, max_new_tokens=64,
                     prompt=rng.integers(0, cfg.vocab_size, 64).astype(np.int32))
             for _ in range(8)]
    for r in first:
        eng.submit(r)
    while any(r.phase != Phase.DECODE for r in first):
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(12):
        eng.step()
    torch.cuda.synchronize()
    alone = (time.perf_counter() - t0) / 12 * 1e3
    windows = StepWindows(torch, eng)
    rt = CoServingRuntime(eng)
    fe = Frontend(rt, clock=rt.now)
    srv = serve_mod.metrics_server(rt.registry, 0, health_cb=rt.check_health)
    port = srv.server_address[1]
    received, consumers, handles = {}, [], []

    def consume(h):
        received[h.request.request_id] = list(h)

    def figures(w):
        return statistics.mean(w["steps"]) * 1e3, w["wall"] / len(w["steps"]) * 1e3

    rt.start()
    try:
        quiet = figures(windows.measure(n=12))
        polled = figures(windows.measure(n=12, poll_s=0.005))
        prof = windows.measure(profiled=True)
        decoding = all(r.phase == Phase.DECODE for r in first)
        busy = prof["device_us"] / len(prof["steps"]) / 1e3
        log(f"  decode steps of 8 offline requests (host clock): {alone:.2f} ms per step on the "
            f"engine alone (12 steps, this thread); under the threaded runtime with the metrics "
            f"server up, step() {quiet[0]:.2f} ms and loop period {quiet[1]:.2f} ms with this "
            f"thread blocked, step() {polled[0]:.2f} ms and period {polled[1]:.2f} ms with it "
            f"polling every 5 ms (12 steps each); device busy "
            + (f"{busy:.2f} ms per step = {busy / quiet[1]:.1%} of the quiet period (6 profiled "
               f"steps, period {figures(prof)[1]:.2f} ms)" if busy > 0 else
               "not measured (no device time in the profile)")
            + f"; all 8 still decoding after the windows: {decoding}")
        log(f"  phase 3's fused decode steps (engine alone): {decode_phase3}")
        for _ in range(4):
            h = fe.stream(rng.integers(0, cfg.vocab_size, 64).astype(np.int32), MAX_NEW)
            th = threading.Thread(target=consume, args=(h,), daemon=True)
            th.start()
            consumers.append(th)
            handles.append(h)
        job = fe.submit_batch([rng.integers(0, cfg.vocab_size, 128).astype(np.int32)
                               for _ in range(4)], max_new_tokens=MAX_NEW)
        code, text = http_get(f"http://127.0.0.1:{port}/")
        hcode, health = http_get(f"http://127.0.0.1:{port}/health")
    finally:
        rt.stop(drain=True, timeout=300.0)
        srv.shutdown()
        srv.server_close()
        windows.close()
    for th in consumers:
        th.join(timeout=60.0)
    alive = sum(th.is_alive() for th in consumers)
    lines = dict(line.split(" ", 1) for line in text.splitlines() if " " in line)
    log(f"  scrape: metrics {code}, {len(lines)} series (iterations_total "
        f"{lines.get('iterations_total')}, running_seqs {lines.get('running_seqs')}); "
        f"/health {hcode}: {health.strip()!r}")
    if code != 200 or "iterations_total" not in lines:
        raise AssertionError(f"7(b): metrics scrape returned {code}")
    if hcode != 200 or not health.startswith("health HEALTHY"):
        raise AssertionError(f"7(b): /health returned {hcode} {health!r}")
    lost = [h.request.request_id for h in handles
            if received.get(h.request.request_id) != list(h.request.output_tokens)
            or len(h.request.output_tokens) != MAX_NEW]
    reqs = [h.request for h in handles] + list(job.requests) + first
    unfinished = [r.request_id for r in reqs if r.phase != Phase.FINISHED
                  or len(r.output_tokens) != r.max_new_tokens]
    log(f"  streams: {len(handles)}, tokens received {sum(map(len, received.values()))} of "
        f"{sum(len(h.request.output_tokens) for h in handles)}; consumers still alive {alive}; "
        f"batch done={job.done}; {len(reqs)} requests; steps={eng.steps} "
        f"health={rt.check_health()[0].name}")
    if lost or alive:
        raise AssertionError(f"7(b): streams that lost tokens {lost}, consumers alive {alive}")
    if unfinished or not job.done:
        raise AssertionError(f"7(b): unfinished requests {unfinished}")
    if rt.check_health()[0].name == "FAILED":
        raise AssertionError("7(b): runtime health FAILED")
    del rt, eng
    torch.cuda.empty_cache()


def replay_fp32_tokens(torch, serve_mod, serial, label="7(c)", online_at=REPLAY_ONLINE_AT,
                       streams=False, against="wall-clock runtime vs engine alone"):
    """Phase 7(c): phase 4's workload at fp32 (the same engine settings and
    prompts) replayed through the runtime under a ManualClock with TTFT SLO
    0: the offline jobs at t = 0, the online requests at ``online_at``.
    At least one online arrival must abort a pure-offline batch at a
    safepoint; every request's tokens must equal ``serial``'s (phase 4's
    serial run) up to the first near-tie.  With ``streams`` every request
    has a token channel, which must hold exactly its tokens, closed, once
    the replay (which flushes a pipelined engine) returns.  Returns every
    request's tokens and margins."""
    from repro_torch.core.request import Priority, Request
    from repro_torch.core.slo import SLO
    from repro_torch.serving.runtime import CoServingRuntime, ManualClock

    args = serve_mod.build_parser().parse_args(
        [a if a != "bfloat16" else "float32" for a in SERVE_ARGV])
    cfg, eng = serve_mod.build_real_engine(args)
    eng.margins = {}
    eng.sched.slo = SLO(ttft=0.0, tpot=eng.sched.slo.tpot)
    online, offline = serve_mod.real_prompts(args, cfg)
    reqs = [Request(Priority.ONLINE, prompt_len=len(p), max_new_tokens=MAX_NEW, arrival_time=t,
                    prompt=p) for t, p in zip(online_at, online)]
    reqs += [Request(Priority.OFFLINE, prompt_len=len(p), max_new_tokens=MAX_NEW, prompt=p)
             for p in offline]
    rt = CoServingRuntime(eng, clock=ManualClock(auto_tick=1e-3))
    channels = [rt.register_stream(r) for r in reqs] if streams else []
    probe = AbortProbe(torch, eng)
    t0 = time.perf_counter()
    try:
        m = rt.replay(reqs)
        torch.cuda.synchronize()
    finally:
        probe.close()
    check_served(label, rt, m, reqs)
    log(f"  {len(online)} online at manual t={list(online_at)} s + {len(offline)} offline, "
        f"pool {eng.ec.num_device_blocks} blocks: steps={eng.steps} safepoint_aborts="
        f"{rt.stats.safepoint_aborts} preemptions={m.num_preemptions} restored_blocks="
        f"{eng.restored_blocks} pipeline_discards={eng.pipeline_discards}; "
        f"{time.perf_counter() - t0:.1f} s (host clock)")
    probe.report(label)
    if rt.stats.safepoint_aborts < 1:
        raise AssertionError(f"{label}: no online arrival aborted a pure-offline batch")
    for r, ch in zip(reqs, channels):
        if not ch.closed or ch.get(timeout=0) != r.output_tokens or len(r.output_tokens) != \
                r.num_generated:
            raise AssertionError(f"{label}: request {r.request_id}'s stream is not its "
                                 f"{len(r.output_tokens)} tokens, closed")
    if channels:
        log(f"  {len(channels)} streams closed, each holding exactly its request's tokens")
    got = [(list(r.output_tokens), eng.margins[r.request_id]) for r in reqs]
    compare_runs(f"{label}: {against} (fp32, every request)", got, serial)
    del rt, eng, reqs
    torch.cuda.empty_cache()
    return got


def wallclock_phase(torch, ops, serve_mod, serial, decode_phase3):
    """Phase 7: (a) bf16 replay, (b) threaded serving with the gateway,
    (c) fp32 tokens of a replay with a safepoint abort.  Returns (a)'s
    kernel launches and (c)'s tokens and margins."""
    args = serve_mod.build_parser().parse_args(WALL_ARGV)
    log("[7a] replay of a loadgen trace through CoServingRuntime, bf16, host clock")
    cfg, params, counts = replay_bf16(torch, ops, serve_mod, args)
    log("[7b] the threaded runtime behind a Frontend and the metrics server")
    threaded_serve(torch, serve_mod, cfg, params, args, decode_phase3)
    del params
    torch.cuda.empty_cache()
    log("[7c] fp32 replay with a safepoint abort against phase 4's serial tokens")
    return counts, replay_fp32_tokens(torch, serve_mod, serial)


# ------------------------------------------------------------------- phase 8
def full_heads(torch, hs):
    """Every head of a ``HeadSharded`` tensor, on its first shard's device."""
    return torch.cat(hs.parts, dim=-2) if hs.sharded else hs.parts[0]


# Phase 8(a)'s shapes: (arch, (H, Hkv, D), tensor-parallel sizes, softcaps).
SHARDED_SHAPES = [("llama-2-7b", (32, 32, 128), (2, 4), (0.0, 30.0)),
                  ("qwen2-0.5b", (14, 2, 64), (2, 4), (0.0, 30.0)),
                  ("gemma-7b", (16, 16, 256), (2,), (0.0,))]


def check_sharded_kernels(torch, rpa, make_mesh, place):
    """Phase 8(a): both sharded functions at tp 2 and 4, fp32 and bf16, at
    the Llama-2-7B (32 / 32 heads) and Qwen2-0.5B (14 / 2) shapes, and at
    tp 2 at gemma-7b's (16 / 16, D = 256), on phase 2's cases, over this
    card named tp times, against the unsharded plain version at TOL.  Each
    call must launch once per shard, except Qwen2-0.5B at tp 4, whose 2 KV
    heads replicate: one unsharded launch (the fallback).  The decode cases
    log their key splits per shard."""
    dev = torch.device("cuda", torch.cuda.current_device())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ragged, decode = rpa.ragged_paged_attention_sharded, rpa.paged_attention_sharded
    for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for arch, (h, hkv, d), tps, caps in SHARDED_SHAPES:
            for tp in tps:
                mesh = make_mesh(tp, devices=[dev] * tp)
                shards = tp if hkv % tp == 0 else 0
                for cap in caps:
                    calls = []
                    for case, kw in RAGGED_CASES.items():
                        q, kp, vp, tb, qp, kvl, cap = attention_case(torch, dtype, h, hkv, d,
                                                                     cap, 1, **kw)
                        got = ragged(q, place(kp, mesh), place(vp, mesh), tb, qp, kvl, mesh,
                                     logit_softcap=cap)
                        want = rpa.ragged_paged_attention_ref(q, kp, vp, tb, qp, kvl,
                                                              logit_softcap=cap)
                        calls.append((f"ragged {case}", got, want, got[-1]))
                    for case, kw in DECODE_CASES.items():
                        q, kp, vp, tb, lens, cap = decode_case(torch, dtype, h, hkv, d, cap, 4,
                                                               **kw)
                        got = decode(q, place(kp, mesh), place(vp, mesh), tb, lens, mesh,
                                     logit_softcap=cap)
                        want = rpa.paged_attention_ref(q, kp, vp, tb, lens, logit_softcap=cap)
                        local = hkv // tp if shards else hkv
                        splits = (rpa.decode_splits(q.shape[0], local, tb.shape[1] * kp.shape[1],
                                                    sms) if dtype == torch.bfloat16 else (1, 0))
                        calls.append((f"decode {case} (splits per shard {splits[0]})", got,
                                      want, got[lens == 0]))
                    torch.cuda.synchronize()
                    for case, got, want, empty in calls:
                        err = (got.float() - want.float()).abs().max().item()
                        zero = empty.float().abs().max().item() if empty.numel() else 0.0
                        log(f"  sharded {dname} {arch} H={h} Hkv={hkv} D={d} tp={tp} "
                            f"{'sharded' if shards else 'fallback'} {case} softcap={cap:g}: "
                            f"max_abs_err={err:.3e} empty rows max={zero:g}")
                        if not torch.allclose(got.float(), want.float(), **TOL[dname]) or zero:
                            raise AssertionError(f"sharded {case} disagrees ({dname}, {arch}, "
                                                 f"tp={tp})")
                for fn in (ragged, decode):
                    n = len(RAGGED_CASES if fn is ragged else DECODE_CASES) * len(caps)
                    want = (n * shards, 0) if shards else (0, n)
                    if (fn.shard_launches, fn.fallbacks) != want:
                        raise AssertionError(f"{fn.__name__} tp={tp} {arch}: shard launches and "
                                             f"fallbacks {(fn.shard_launches, fn.fallbacks)}, "
                                             f"want {want}")
                    fn.shard_launches = fn.fallbacks = 0


def log_pools(torch, eng):
    """Each shard's pool: one leaf's part shape and the bytes of all its
    leaves."""
    for s in range(eng.mesh.tp):
        parts = [layer[kv].parts[s] for layer in eng.pools.values() for kv in ("k", "v")]
        nbytes = sum(p.numel() * p.element_size() for p in parts)
        log(f"  shard {s} on {parts[0].device}: pool leaf {tuple(parts[0].shape)} "
            f"({eng.pools['0']['k'].heads} KV heads over {eng.mesh.tp} shards), "
            f"{len(parts)} leaves, {nbytes / 1e9:.3f} GB")


def tp_serves(torch, ops, serve_mod, tf, mesh, phase3, label="8b"):
    """Phase 8(b): phase 3's workload at bf16 on the fused and the split path
    over ``mesh``, counted as phases 3 and 3b are; each shard's pool, the
    dispatches under sync debug mode "error", and the decode steps profiled
    beside phase 3's and 3b's (``phase3``: path -> text).  Returns per path
    (launch counts, captured arguments)."""
    out = {}
    for path, extra in (("fused", []), ("split", ["--no-fused-batch"])):
        log(f"  [{label}] {path} path, tp={mesh.tp} on {[str(d) for d in mesh.devices]}")
        res, counts, args = run_serve(torch, ops, serve_mod, tf, SERVE_ARGV + extra, mesh=mesh)
        eng = res["engine"]
        log_pools(torch, eng)
        check_reads_nothing_back(torch, tf, eng)
        figures = {"decode": "not measured (no profiler trace)"}
        rows = profile_steps(torch, eng, figures=figures)
        if path == "split":
            check_split_decode_kernel(rows, res["cfg"])
        log(f"  {path} decode steps: tp={mesh.tp} {figures['decode']}")
        log(f"  {path} decode steps: tp=1 (phase {'3' if path == 'fused' else '3b'}) "
            f"{phase3[path]}")
        out[path] = (counts, args)
        del res, eng
        torch.cuda.empty_cache()
    return out


def tp_fp32_tokens(torch, serve_mod, mesh, serial):
    """Phase 8(c): phase 4's preempted workload at fp32, fused and split
    over ``mesh``: every request's tokens against phase 4's tp = 1 fused
    run's up to the first near-tie; every block the ``HostKVStore`` takes
    must hold all the KV heads."""
    from repro_torch.core.checkpoint import HostKVStore

    argv32 = [a if a != "bfloat16" else "float32" for a in SERVE_ARGV]
    put = HostKVStore.put
    for path, extra in (("fused", []), ("split", ["--no-fused-batch"])):
        heads = []

        def counted_put(store, seq, idx, blk):
            heads.extend(leaf.shape[-2] for layer in blk.values() for leaf in layer.values())
            return put(store, seq, idx, blk)

        HostKVStore.put = counted_put
        try:
            res = serve(serve_mod, argv32 + extra, mesh)
        finally:
            HostKVStore.put = put
        eng, cfg = res["engine"], res["cfg"]
        log(f"  tp={mesh.tp} {path} fp32: preemptions={res['preemptions']} steps={eng.steps} "
            f"restored_blocks={eng.restored_blocks}; the HostKVStore took {len(heads)} block "
            f"leaves, KV heads {sorted(set(heads))}")
        if res["preemptions"] == 0 or not heads or set(heads) != {cfg.num_kv_heads}:
            raise AssertionError(f"8(c) {path}: no preemption, or host blocks without all "
                                 f"{cfg.num_kv_heads} KV heads")
        got = [(list(r.output_tokens), eng.margins[r.request_id])
               for r in [h.request for h in res["streams"]] + list(res["job"].requests)]
        compare_runs(f"tp={mesh.tp} {path} vs tp=1 fused (phase 4), every request", got, serial)
        del res, eng
        torch.cuda.empty_cache()


def sharded_entry(torch, rpa, name, args, counts, spec, timer):
    """Phase 8's kernel-line entry of one sharded function at the heaviest
    call captured while 8(b) ran: its error against the unsharded plain
    version, the time of the sharded call and of one shard's launch, the
    plain sharded version's time, and the bound of the bytes of all shards."""
    *call, mesh, cap = args
    q, kp, vp, tb, *rest = call
    dname = "bfloat16" if q.dtype == torch.bfloat16 else "float32"
    ragged = name == "ragged_paged_attention_sharded"
    fn = getattr(rpa, name)
    plain = getattr(rpa, f"{name}_ref")
    one = rpa.ragged_paged_attention if ragged else rpa.paged_attention
    one_ref = rpa.ragged_paged_attention_ref if ragged else rpa.paged_attention_ref
    head_axis = 2 if ragged else 1
    got = fn(q, kp, vp, tb, *rest, mesh, logit_softcap=cap)
    splits_per_shard = one.last_splits[0]  # the plan of this call's (last) shard launch
    want = one_ref(q, full_heads(torch, kp), full_heads(torch, vp), tb, *rest, logit_softcap=cap)
    err = (got.float() - want.float()).abs().max().item()
    if not torch.allclose(got.float(), want.float(), **TOL[dname]):
        raise AssertionError(f"{name} disagrees at {tuple(q.shape)}: max_abs_err={err:.3e}")
    if ragged:
        bound, by = attention_bound(torch, q, kp, tb, rest[0], rest[1], PEAK_FLOPS[dname],
                                    spec.hbm_bw)
    else:
        bound, by = decode_bound(torch, q, kp, tb, rest[0], PEAK_FLOPS[dname], spec.hbm_bw)
    q0 = q.narrow(head_axis, 0, q.shape[head_axis] // mesh.tp).contiguous()
    entry = {
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/csrc/{'ragged_paged_attention' if ragged else 'paged_attention'}.cu",
        "replaces": f"src/repro/kernels/paged_attention.py:{294 if ragged else 341}",
        "launches": counts[name], "shard_launches": counts[f"{name} shard_launches"],
        "max_abs_err": err, "tp": mesh.tp,
        **timed(timer, lambda: fn(q, kp, vp, tb, *rest, mesh, logit_softcap=cap)),
        "shard_ms": timer.ms(lambda: one(q0, kp.parts[0], vp.parts[0], tb, *rest,
                                         logit_softcap=cap)),
        "plain_ms": timer.ms(lambda: plain(q, kp, vp, tb, *rest, mesh, logit_softcap=cap)),
        "bound_ms": bound, "bound_by": by, "library_ms": None,
        "shape": {"q": list(q.shape), "pool": list(kp.shape),
                  "shard_pool": list(kp.parts[0].shape), "tables": list(tb.shape),
                  "lens": rest[-1].tolist(), "dtype": dname},
    }
    entry["splits_per_shard"] = splits_per_shard
    log(f"  {name}, heaviest tp={mesh.tp} call: {entry}")
    if ragged:
        log_previous_ragged(f"tp={mesh.tp} shard launch", entry, "shard_ms")
        log_previous_ragged(f"tp={mesh.tp} sharded call", entry)
    return entry


def tp_phase(torch, ops, rpa, serve_mod, tf, spec, timer, serial, phase3, fused_profile):
    """Phase 8: tensor-parallel paged serving on two shards of this card.
    Returns the kernel line's two sharded entries."""
    from repro_torch.distributed.sharding import place
    from repro_torch.launch.mesh import make_serving_mesh

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_serving_mesh(2, devices=[dev, dev])
    log("[8a] the sharded kernels at tp 2 and 4 against the unsharded plain version")
    check_sharded_kernels(torch, rpa, make_serving_mesh, place)
    log("[8b] phase 3's workload at bf16 on two shards of this card")
    served = tp_serves(torch, ops, serve_mod, tf, mesh, phase3)
    log("[8c] phase 4's preempted workload at fp32 on two shards, against phase 4's tp = 1")
    tp_fp32_tokens(torch, serve_mod, mesh, serial)
    log("[8d] calibration of the tp = 2 fused engine")
    text = calibrated_serve(torch, serve_mod, "fused tp=2", SERVE_ARGV, mesh)
    log(f"  fused tp=1 (phase 6): {fused_profile}")
    log(f"  fused tp=2: {text}")
    log("[8e] tensor parallelism across cards")
    if torch.cuda.device_count() >= 2:
        tp_serves(torch, ops, serve_mod, tf, make_serving_mesh(2), phase3, label="8e")
    else:
        log(f"  not run: {torch.cuda.device_count()} CUDA device visible, and a mesh across "
            "cards needs two")
    entries = []
    for name, path in (("ragged_paged_attention_sharded", "fused"),
                       ("paged_attention_sharded", "split")):
        counts, args = served[path]
        entries.append(sharded_entry(torch, rpa, name, args[name], counts, spec, timer))
    return entries


# ------------------------------------------------------------------- phase 9
# (c): Llama-2-7B's widths at this depth, so one step's launches fit CUDA's
# queue of pending launches behind the spin (a full-depth step launches
# thousands of kernels, and the host would wait at enqueue)
OVERLAP_LAYERS = 4
OVERLAP_SPIN_MS = 200.0
# (e): 7(c)'s replay with the first online arrival 5 ms later.  A pipelined
# engine reads the manual clock at other points than the serial one (it
# plans a step ahead), and 7(c)'s arrivals then land between batches; this
# one lands at a safepoint of a pure-offline iteration at 32 layers and
# aborts it.  As in 7(c), the plans depend on the depth and the lengths.
PIPELINED_ONLINE_AT = (0.045, 0.380, 0.600, 0.900)


class Pipelined:
    """Inside ``with Pipelined(serve_mod):`` ``launch.serve.build_real_engine``
    returns a pipelined engine: ``build_real_engine``'s config, weights and
    settings with ``RealEngineConfig(pipeline=True)``, calibrated (at depth
    4) when ``--calibrate`` is given.  The serve CLI has no pipeline flag, as
    the reference's has none."""

    def __init__(self, serve_mod):
        self.serve_mod = serve_mod
        self.orig = serve_mod.build_real_engine

    def __enter__(self):
        import argparse
        import dataclasses

        from repro_torch.serving.real_engine import RealEngine

        def build(args, mesh=None):
            plain = argparse.Namespace(**dict(vars(args), calibrate=False))
            cfg, serial = self.orig(plain, mesh)
            eng = RealEngine(cfg, serial.params, device=serial.device,
                             eng_cfg=dataclasses.replace(serial.ec, pipeline=True))
            del serial
            if args.calibrate:
                grid = eng._default_grid()
                if grid.pipeline_depth != 4:
                    raise AssertionError(f"pipelined calibration depth {grid.pipeline_depth}")
                eng.calibrate(grid)
            return cfg, eng

        self.serve_mod.build_real_engine = build
        return self

    def __exit__(self, *exc):
        self.serve_mod.build_real_engine = self.orig


def staged_abort_tokens(torch, tf, cfg, params):
    """Phase 9(b)'s staged-batch abort (the reference's
    ``test_pipelined_mid_iteration_abort_discards_staged_batch``): 3 offline
    jobs (64-token prompts, 16 new tokens) on a pipelined fp32 engine; after
    3 steps the preemption flag is set at the first safepoint of the staged
    batch, which must abort before its last segment and stage nothing.
    Every request's tokens must equal those of the same run without the
    abort up to the first near-tie."""
    import numpy as np

    from repro_torch.core.request import Priority, Request
    from repro_torch.serving.real_engine import RealEngine, RealEngineConfig

    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, 64).astype(np.int32) for _ in range(3)]

    def go(abort_at):
        eng = RealEngine(cfg, params, eng_cfg=RealEngineConfig(pipeline=True), device="cuda")
        eng.margins = {}
        reqs = [Request(Priority.OFFLINE, prompt_len=64, max_new_tokens=16, prompt=p)
                for p in prompts]
        for r in reqs:
            eng.submit(r)
        if abort_at is not None:
            for _ in range(abort_at):
                eng.step()
            if eng._staged is None:
                raise AssertionError("9(b): the pipeline staged no batch to abort")
            eng.arrival_poll = eng.flag.set
            before = eng.dispatches["fused_segment"]
            eng.step()
            eng.arrival_poll = None
            ran = eng.dispatches["fused_segment"] - before
            if (eng.safepoints.stats.preemptions != 1 or ran >= len(tf.segment_spans(cfg))
                    or eng._staged is not None):
                raise AssertionError(f"9(b): the staged batch did not abort at a safepoint "
                                     f"({eng.safepoints.stats.preemptions} aborts, {ran} "
                                     f"segments run, staged {eng._staged is not None})")
            log(f"  the staged batch aborted after {ran} of {len(tf.segment_spans(cfg))} "
                "segments and nothing was staged after it")
        eng.run()
        got = [(list(r.output_tokens), eng.margins[r.request_id]) for r in reqs]
        del eng
        torch.cuda.empty_cache()
        return got

    compare_runs("staged batch aborted vs not (pipelined, fp32)", go(3), go(None))


def event_wait_is_flagged(torch) -> bool:
    """Whether ``torch.cuda.Event.synchronize`` raises under sync debug
    mode "error" (an event that has passed, so nothing waits)."""
    ev = torch.cuda.Event()
    ev.record()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ev.synchronize()
        return False
    except RuntimeError:
        return True
    finally:
        torch.cuda.set_sync_debug_mode("default")


def overlap_check(torch, tf, timer):
    """Phase 9(c): Llama-2-7B's widths at OVERLAP_LAYERS layers, bf16, 8
    offline jobs (64-token prompts) in steady decode.  On the pipelined
    engine 4 steps, then a device spin of OVERLAP_SPIN_MS and one more step,
    all under ``torch.cuda.set_sync_debug_mode("error")``: the engine's
    event waits (on the previous iteration's fetch and on landing
    checkpoints, ``RealEngine._wait``) run with the mode at "default" and
    are counted; anything else that synchronises raises.  That step must
    return in under half the spin on the host clock.  The serial engine's
    step behind the same spin must take at least the spin."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.request import Priority, Request
    from repro_torch.serving.real_engine import RealEngine, RealEngineConfig

    cfg = dataclasses.replace(get_config("llama-2-7b"), num_layers=OVERLAP_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tf.init_params(cfg, gen, dtype=torch.bfloat16)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, 64).astype(np.int32) for _ in range(8)]
    spin = int(OVERLAP_SPIN_MS * timer.cycles_per_ms)
    flagged = event_wait_is_flagged(torch)
    log(f"  Event.synchronize under sync debug mode 'error' raises: {flagged}; the engine's "
        "event waits run with the mode at 'default' either way")
    took = {}
    for pipelined in (True, False):
        eng = RealEngine(cfg, params, eng_cfg=RealEngineConfig(pipeline=pipelined), device="cuda")
        for p in prompts:
            eng.submit(Request(Priority.OFFLINE, prompt_len=64, max_new_tokens=96, prompt=p))
        for _ in range(12):  # the prefill, then decode
            eng.step()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        gathers, waits = eng.ckpt_gathers, [0]
        if pipelined:
            staged = eng._staged
            if staged is None or staged.plan.prefill_chunks or len(eng._fetches) != 1:
                raise AssertionError("9(c): the pipelined engine is not in steady decode")

            def wait(ev, real=eng._wait):
                waits[0] += 1
                torch.cuda.set_sync_debug_mode("default")
                try:
                    real(ev)
                finally:
                    torch.cuda.set_sync_debug_mode("error")

            eng._wait = wait
            torch.cuda.set_sync_debug_mode("error")
        try:
            if pipelined:
                for _ in range(4):
                    eng.step()
            a.record()
            torch.cuda._sleep(spin)
            b.record()
            t0 = time.perf_counter()
            eng.step()
            took[pipelined] = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        spin_ms = a.elapsed_time(b)
        name = "pipelined" if pipelined else "serial"
        log(f"  {name}: step() behind a {spin_ms:.1f} ms device spin returned in "
            f"{took[pipelined] * 1e3:.2f} ms (host clock); "
            + (f"{waits[0]} event waits and {eng.ckpt_gathers - gathers} checkpoint gathers in "
               "its 5 steps under sync debug mode 'error'" if pipelined else
               "it reads the sampled tokens back"))
        if pipelined and took[True] * 1e3 >= spin_ms / 2:
            raise AssertionError("9(c): the pipelined step waited for the device")
        if not pipelined and took[False] * 1e3 < spin_ms:
            raise AssertionError("9(c): the serial step returned before the spin ended")
        del eng
    del params
    torch.cuda.empty_cache()


def pipeline_phase(torch, ops, serve_mod, tf, timer, serial, replayed, phase3, fused_profile,
                   line):
    """Phase 9: the async host/device pipeline (DESIGN.md §13).  Adds the
    pipelined serve's launches to the kernel line's ragged attention and
    checkpoint gather entries."""
    log("[9a] phase 3's workload at bf16 on a pipelined engine")
    with Pipelined(serve_mod):
        res, counts, _args = run_serve(torch, ops, serve_mod, tf, SERVE_ARGV)
    eng = res["engine"]
    log(f"  pipeline_discards={eng.pipeline_discards} pipeline_programs="
        f"{eng.pipeline_trace_count}; ragged_paged_attention {counts['ragged_paged_attention']} "
        f"launches in {eng.steps} steps ({eng.safepoints.stats.preemptions} aborted), "
        f"checkpoint_gather {counts['checkpoint_gather']}")
    if eng._fetches or eng._ckpt_pending:
        raise AssertionError("9(a): run() left fetches or checkpoint copies in flight")
    figures = {"decode": "not measured (no profiler trace)"}
    profile_steps(torch, eng, figures=figures)
    log(f"  serial (phase 3): {phase3['decode']}; {phase3.get('gap')}")
    log(f"  pipelined: {figures['decode']}; {figures.get('gap')}")
    for entry in line:
        if entry["name"] in ("ragged_paged_attention", "checkpoint_gather"):
            entry["launches_pipelined"] = counts[entry["name"]]
    del res, eng, _args
    torch.cuda.empty_cache()

    log("[9b] phase 4's preempted workload at fp32, pipelined, against phase 4's serial run")
    argv32 = [a if a != "bfloat16" else "float32" for a in SERVE_ARGV]
    with Pipelined(serve_mod):
        res = serve(serve_mod, argv32)
    eng = res["engine"]
    log(f"  preemptions={res['preemptions']} steps={eng.steps} pipeline_discards="
        f"{eng.pipeline_discards} restored_blocks={eng.restored_blocks}")
    if res["preemptions"] == 0 or eng.pipeline_discards == 0:
        raise AssertionError("9(b): the run did not preempt or discard a staged batch")
    got = [(list(r.output_tokens), eng.margins[r.request_id])
           for r in [h.request for h in res["streams"]] + list(res["job"].requests)]
    compare_runs("pipelined vs serial fused, preempted (fp32, every request)", got, serial)
    cfg, params = res["cfg"], eng.params
    del res, eng
    torch.cuda.empty_cache()
    staged_abort_tokens(torch, tf, cfg, params)
    del params
    torch.cuda.empty_cache()

    log(f"[9c] overlap: a {OVERLAP_SPIN_MS:.0f} ms device spin, then step(), at "
        f"{OVERLAP_LAYERS} layers")
    overlap_check(torch, tf, timer)

    log("[9d] calibration of the pipelined engine (depth 4), then phase 3's workload on it")
    with Pipelined(serve_mod):
        text = calibrated_serve(torch, serve_mod, "fused pipelined", SERVE_ARGV)
    log(f"  fused serial (phase 6): {fused_profile}")
    log(f"  fused pipelined: {text}")

    log("[9e] phase 7(c)'s fp32 replay through CoServingRuntime over a pipelined engine")
    with Pipelined(serve_mod):
        replay_fp32_tokens(torch, serve_mod, replayed, label="9(e)",
                           online_at=PIPELINED_ONLINE_AT, streams=True,
                           against="pipelined runtime vs 7(c)'s serial runtime")


# ------------------------------------------------------------------ phase 10
# The other architectures at full width and depth, random weights from seed
# 0, served with phase 3's workload (``--arch``) on the three paths.
ARCH_SERVES = ("gemma-7b", "olmoe-1b-7b")
PATHS = {"fused": [], "split": ["--no-fused-batch"], "contiguous": ["--backend", "contiguous"]}
GEMMA_SHAPE = (16, 16, 256)  # gemma-7b's H, Hkv, D


def arch_serves(torch, ops, serve_mod, tf, arch):
    """Phase 10(a): phase 3's workload at bf16 with ``--arch`` on the fused,
    split and contiguous paths, counted as phases 3-3c count (``run_serve``:
    every request finishes, launches per layer of every dispatch, the
    gathers run), each path's dispatches reading nothing back, the fused
    decode step profiled (with the MoE experts' ``aten::bmm`` share), and
    peak memory logged.  Returns per path (launch counts, heaviest calls)."""
    out = {}
    for path, extra in PATHS.items():
        log(f"[10a] {arch} bf16, {path} path")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res, counts, args = run_serve(torch, ops, serve_mod, tf,
                                      SERVE_ARGV + ["--arch", arch] + extra)
        eng, cfg = res["engine"], res["cfg"]
        if path == "fused":
            iters = eng.dispatches["fused_segment"] / len(tf.segment_spans(cfg))
            log(f"  ragged launches per fused iteration: "
                f"{counts['ragged_paged_attention'] / iters:.2f} ({cfg.num_layers} layers)")
        check_reads_nothing_back(torch, tf, eng)
        if path == "fused":
            profile_steps(torch, eng, op_names=("aten::bmm",) if cfg.num_experts else ())
        log(f"  peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
            f"(weights {cfg.param_count() * 2 / 1e9:.2f} GB); "
            f"{time.perf_counter() - t0:.1f} s")
        out[path] = (counts, args)
        del res, eng
        torch.cuda.empty_cache()
    return out


def arch_fp32_tokens(torch, serve_mod, arch, moe: bool):
    """Phase 10(b): phase 4's legs at fp32 with ``--arch``: the preempted
    fused run's tokens against an uninterrupted run's, the split path's and
    the contiguous path's, up to the first near-tie.  A MoE arch's
    contiguous path decodes through ``run_segment`` at capacity factor 1.25,
    as the reference's engine does, where every other path routes dropless:
    its tokens are reported against the fused run's, not required equal."""
    argv32 = [a if a != "bfloat16" else "float32" for a in SERVE_ARGV] + ["--arch", arch]
    runs = {}
    for name, extra in (("preempted", []),
                        ("uninterrupted", ["--num-device-blocks", "512"]),
                        ("split preempted", ["--no-fused-batch"]),
                        ("contiguous preempted", ["--backend", "contiguous"])):
        t0 = time.perf_counter()
        res = serve(serve_mod, argv32 + extra)
        reqs = [h.request for h in res["streams"]] + list(res["job"].requests)
        if any(len(r.output_tokens) != MAX_NEW for r in reqs):
            raise AssertionError(f"{arch} fp32 {name}: requests without all their tokens")
        log(f"  {arch} fp32 {name}: preemptions={res['preemptions']} "
            f"steps={res['engine'].steps} {time.perf_counter() - t0:.1f} s")
        runs[name] = (res["preemptions"], offline_tokens(res))
        del res, reqs
        torch.cuda.empty_cache()
    if (runs["preempted"][0] == 0 or runs["split preempted"][0] == 0
            or runs["contiguous preempted"][0] == 0 or runs["uninterrupted"][0] != 0):
        raise AssertionError(f"{arch}: phase 10 did not contrast preempted and "
                             "uninterrupted runs")
    fused = runs["preempted"][1]
    compare_runs(f"{arch} preempted vs uninterrupted", fused, runs["uninterrupted"][1])
    compare_runs(f"{arch} split vs fused, preempted", runs["split preempted"][1], fused)
    contiguous = runs["contiguous preempted"][1]
    if moe:
        same = sum(ta == tb for (ta, _), (tb, _) in zip(contiguous, fused))
        first = [next((j for j, (x, y) in enumerate(zip(ta, tb)) if x != y), None)
                 for (ta, _), (tb, _) in zip(contiguous, fused)]
        log(f"  {arch} contiguous (segmented decode at capacity 1.25) vs fused (dropless): "
            f"{same} of {len(fused)} requests identical; first differing token per request "
            f"{first}")
    else:
        same = compare_runs(f"{arch} contiguous vs fused, preempted", contiguous, fused)
        if same != len(fused):
            raise AssertionError(f"{arch} contiguous vs fused: {same} of {len(fused)} "
                                 "requests identical")


def head_dim_256_entries(torch, rpa, cg, fa, serves, full_launches, spec, timer, line):
    """Phase 5's kernel line at gemma-7b's D = 256: each kernel's launches
    on gemma's serves (10a), its time, host enqueue, plain time, bound and
    library time on the heaviest call of its path, and for attention the
    same at 2-4 thousand-token contexts, under ``head_dim_256`` of its
    entry."""
    by_name = {e["name"]: e for e in line}
    (counts, args), (split_counts, split_args), (contiguous_counts, contiguous_args) = (
        serves[p] for p in PATHS)
    main = attention_entry(torch, rpa, args["ragged_paged_attention"], spec, timer)
    log(f"  ragged_paged_attention D=256, heaviest gemma-7b fused call: {main}")
    log_previous_ragged("gemma-7b fused", main)
    dmain = decode_entry(torch, rpa, split_args["paged_attention"], spec, timer)
    log(f"  paged_attention D=256, heaviest gemma-7b split call: {dmain}")
    long_ragged, long_decode = long_context_entries(torch, rpa, spec, timer, GEMMA_SHAPE,
                                                    qwen=False)
    by_name["ragged_paged_attention"]["head_dim_256"] = {
        "arch": "gemma-7b", "launches": counts["ragged_paged_attention"],
        "merge_launches": counts["ragged_paged_attention merges"], **main,
        "library_ms": None, "long_context": long_ragged}
    by_name["paged_attention"]["head_dim_256"] = {
        "arch": "gemma-7b", "launches": split_counts["paged_attention"],
        "merge_launches": split_counts["paged_attention merges"], **dmain,
        "library_ms": None, "long_context": long_decode}
    fmain = flash_entry(torch, fa, contiguous_args["flash_attention"], spec, timer)
    log(f"  flash_attention D=256, heaviest gemma-7b contiguous call: {fmain}")
    log_previous("gemma-7b contiguous", fmain)
    by_name["flash_attention"]["head_dim_256"] = {
        "arch": "gemma-7b", "launches": contiguous_counts["flash_attention"],
        "launches_forward_full": full_launches, **fmain,
        "long_context": flash_long_entries(torch, fa, spec, timer, GEMMA_SHAPE, "gemma-7b")}
    gather = gather_entry(torch, cg, *args["checkpoint_gather"], spec, timer)
    log(f"  checkpoint_gather, gemma-7b's leaf: {gather}")
    by_name["checkpoint_gather"]["head_dim_256"] = {
        "arch": "gemma-7b", "launches": counts["checkpoint_gather"], **gather}


def arch_phase(torch, ops, rpa, cg, fa, serve_mod, tf, build, builds, spec, timer, line):
    """Phase 10: gemma-7b and olmoe-1b-7b at full width and depth: (a) bf16
    serves on the three paths, (b) fp32 token self-consistency across them,
    (c) gemma's ``forward_full`` on 1024 tokens at fp32 against the flash
    kernel's plain version, (d) the D = 256 kernel entries."""
    gemma = None
    for arch in ARCH_SERVES:
        serves = arch_serves(torch, ops, serve_mod, tf, arch)
        if arch == "gemma-7b":  # only gemma's captured calls are timed
            gemma = serves
        del serves
        log(f"[10b] {arch} at fp32: preempted vs uninterrupted vs split vs contiguous")
        arch_fp32_tokens(torch, serve_mod, arch, moe=arch == "olmoe-1b-7b")
    log("[10c] gemma-7b forward_full at full width, fp32: flash kernel vs its plain version")
    full_launches = forward_full_check(torch, ops, fa, tf, t=1024, arch="gemma-7b")
    log("[10d] kernels at gemma-7b's head dim of 256")
    head_dim_256_entries(torch, rpa, cg, fa, gemma, full_launches, spec, timer, line)
    add_build_reports(build, builds, line, gemma["fused"][1]["ragged_paged_attention"],
                      gemma["split"][1]["paged_attention"], dims=(256,))


# ------------------------------------------------------------------ phase 11
# The archs that resume by recompute, on the contiguous path (the only one
# they have).  mamba2-1.3b at full width and depth takes phase 3's workload;
# mixtral-8x22b at full width and MIXTRAL_LAYERS layers (MIXTRAL_FP32_LAYERS
# at fp32) takes prompts past its 4096-token window, prefilled in chunks of
# 512 that cross it, on a pool that forces a preemption (and a recompute
# across the window); jamba-1.5-large-398b, which does not fit the card at
# one period, at .reduced().
MIXTRAL_LAYERS, MIXTRAL_FP32_LAYERS = 8, 2
MIXTRAL_NEW = 16
MIXTRAL_ARGV = ["--full", "--device", "cuda", "--dtype", "bfloat16", "--arch", "mixtral-8x22b",
                "--layers", str(MIXTRAL_LAYERS), "--online", "1", "--offline", "2",
                "--prompt-len", "18432", "--max-new", str(MIXTRAL_NEW), "--chunk-size", "512",
                "--online-after", "3", "--num-device-blocks", "640"]
JAMBA_ARGV = [a for a in SERVE_ARGV if a != "--full"] + ["--arch", "jamba-1.5-large-398b"]
MAMBA_ARGV = SERVE_ARGV + ["--arch", "mamba2-1.3b"]
# the fp32 legs' depth: the serve is host-bound (at 48 layers the three legs
# take about 40 s on an H100)
MAMBA_FP32_LAYERS = 24
# forward_full at mixtral's window: one sequence of 8192 tokens, window 4096
WINDOW_T = 8192


def fp32_argv(argv):
    return [a if a != "bfloat16" else "float32" for a in argv]


def depth_cuts(torch):
    """The parameter counts behind each depth cut of phase 11, and the
    weights' bytes at the dtype each serve runs."""
    import dataclasses

    from repro_torch.configs import get_config

    lines = []
    for arch, layers in (("mamba2-1.3b", None), ("mixtral-8x22b", None),
                         ("mixtral-8x22b", MIXTRAL_LAYERS),
                         ("mixtral-8x22b", MIXTRAL_FP32_LAYERS),
                         ("jamba-1.5-large-398b", None), ("jamba-1.5-large-398b", 8),
                         ("jamba-1.5-large-398b", "reduced")):
        cfg = get_config(arch)
        if layers == "reduced":
            cfg = cfg.reduced()
        elif layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        n = cfg.param_count()
        lines.append(f"{arch} {layers or 'full'} ({cfg.num_layers} layers): {n / 1e9:.3f} B "
                     f"parameters = {2 * n / 1e9:.1f} GB bf16, {4 * n / 1e9:.1f} GB fp32")
    free, total = torch.cuda.mem_get_info()
    for line in lines:
        log(f"  {line}")
    log(f"  card memory: {free / 1e9:.1f} GB free of {total / 1e9:.1f} GB")


def recurrent_serve(torch, ops, serve_mod, tf, argv, profile=False):
    """One serve of an arch that resumes by recompute (phase 11), on the
    contiguous path: the flash kernel's calls captured and every kernel
    counted (zeroed just before, read just after).  Every request must
    finish with all its tokens, a request must be preempted and resumed by
    recompute (the checkpointer off, nothing stored or restored), every
    prefill dispatch must launch the flash kernel once per attention layer
    and no other kernel may launch; the dispatches must read nothing back.
    ``profile`` profiles the decode step.  Returns (the serve's result,
    the counts, the heaviest flash call's arguments)."""
    cap = Capture(ops.flash_attention, lambda q, k, v: q.shape[1] * k.shape[1], flash_clone)
    ops.flash_attention = cap
    try:
        ops.reset_launch_counts()
        res = serve(serve_mod, argv)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    finally:
        ops.flash_attention = cap.fn
    eng, cfg = res["engine"], res["cfg"]
    d = eng.dispatches
    attn_layers = cfg.num_periods * sum(s.mixer == "attn" for s in cfg.layer_pattern())
    log(f"  {cfg.name}: layers={cfg.num_layers} ({attn_layers} attention) d_model={cfg.d_model} "
        f"window={cfg.sliding_window} experts={cfg.num_experts} ssm_state={cfg.ssm_state_size} "
        f"vocab={cfg.vocab_size} {eng.dtype}, {path_of(eng)} path, max_model_len="
        f"{eng.ec.max_model_len}, cache slots {tf.cache_capacity(cfg, eng.ec.max_model_len)}")
    log(f"  steps={eng.steps} preemptions={res['preemptions']} checkpointer="
        f"{'on' if eng.ckpt.enabled else 'off'} ckpt_blocks={eng.ckpt.stats.blocks_checkpointed} "
        f"restored_blocks={eng.restored_blocks} host_blocks={len(eng.host)} dispatches={d}")
    log(f"  recomputed tokens at each resume (request, tokens): {eng.recomputed}")
    log(f"  generated={res['generated']} tokens in {res['seconds']:.3f} s = "
        f"{res['generated'] / res['seconds']:.1f} tok/s (host clock); {iteration_figures(eng)}")
    log(f"  launches: {counts}")
    max_new = int(argv[argv.index("--max-new") + 1])
    reqs = [h.request for h in res["streams"]] + list(res["job"].requests)
    short = [r.request_id for r in reqs if len(r.output_tokens) != max_new]
    if short:
        raise AssertionError(f"{cfg.name}: requests without all their tokens: {short}")
    if eng.paged or eng.ckpt.enabled or not eng.recompute_only:
        raise AssertionError(f"{cfg.name}: not the contiguous path with recompute resume")
    if (res["preemptions"] == 0 or not eng.recomputed or eng.restored_blocks
            or eng.ckpt.stats.blocks_checkpointed or len(eng.host)):
        raise AssertionError(f"{cfg.name}: the run did not preempt and resume by recompute")
    if counts["flash_attention"] != attn_layers * d["prefill"] or d["prefill"] == 0:
        raise AssertionError(f"{cfg.name}: flash_attention launches {counts['flash_attention']} "
                             f"!= {attn_layers} attention layers x {d['prefill']} prefill "
                             "dispatches")
    if any(n for name, n in counts.items() if name != "flash_attention"):
        raise AssertionError(f"{cfg.name}: a kernel other than flash_attention launched")
    if d["decode"] + d["segment"] == 0:
        raise AssertionError(f"{cfg.name}: no decode dispatch ran")
    check_reads_nothing_back(torch, tf, eng)
    if profile:
        profile_steps(torch, eng, top_ops=True)
    return res, counts, cap.args


def recurrent_fp32_legs(torch, serve_mod, argv, moe: bool):
    """Phase 11's fp32 legs, up to the first near-tie: a preempted run's
    tokens (recompute at each resume) against an uninterrupted run's (a pool
    of 2048 blocks), and the safepoint-segmented decode's against the plain
    decode's (``--no-safepoints``).  A MoE arch's segmented decode routes at
    capacity factor 1.25, as the reference's engine runs it, so its drops
    follow the batch's make-up: its preempted and uninterrupted runs are
    compared on the plain (dropless) decode, and its segmented decode
    against the plain one is reported, not required equal."""
    argv32 = fp32_argv(argv)
    plain = ["--no-safepoints"]
    runs = {}
    for name, extra in (("segmented preempted", []), ("plain preempted", plain),
                        ("uninterrupted", ["--num-device-blocks", "2048"]
                         + (plain if moe else []))):
        t0 = time.perf_counter()
        res = serve(serve_mod, argv32 + extra)
        eng = res["engine"]
        log(f"  {res['cfg'].name} fp32 {name}: preemptions={res['preemptions']} "
            f"steps={eng.steps} segment dispatches={eng.dispatches['segment']} "
            f"recomputed={eng.recomputed} {time.perf_counter() - t0:.1f} s")
        runs[name] = (res["preemptions"], offline_tokens(res), eng.dispatches["segment"])
        del res, eng
        torch.cuda.empty_cache()
    if (runs["segmented preempted"][0] == 0 or runs["plain preempted"][0] == 0
            or runs["uninterrupted"][0] != 0 or runs["segmented preempted"][2] == 0
            or runs["plain preempted"][2] != 0):
        raise AssertionError("phase 11: the fp32 legs did not contrast preempted and "
                             "uninterrupted, segmented and plain decodes")
    name = argv[argv.index("--arch") + 1]
    preempted = runs["plain preempted" if moe else "segmented preempted"][1]
    compare_runs(f"{name} preempted vs uninterrupted", preempted, runs["uninterrupted"][1])
    seg, flat = runs["segmented preempted"][1], runs["plain preempted"][1]
    if moe:
        same = sum(ta == tb for (ta, _), (tb, _) in zip(seg, flat))
        first = [next((j for j, (x, y) in enumerate(zip(ta, tb)) if x != y), None)
                 for (ta, _), (tb, _) in zip(seg, flat)]
        log(f"  {name} segmented (capacity 1.25) vs plain decode (dropless): {same} of "
            f"{len(seg)} requests identical; first differing token per request {first}")
    else:
        compare_runs(f"{name} segmented vs plain decode", seg, flat)


def ring_prefill_check(torch, ops, fa, tf):
    """Phase 11(c) at fp32 and MIXTRAL_FP32_LAYERS layers: one sequence of
    4608 tokens prefilled in chunks of 512 into a ring of 4096 slots
    (``prefill_chunk``, the flash kernel on every chunk), against
    ``forward_full`` (dropless) over the sequence: the last logits within
    FULL_TOL, and the flash kernel launched once per layer per chunk and once
    per layer in the forward."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("mixtral-8x22b"), num_layers=MIXTRAL_FP32_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tf.init_params(cfg, gen, dtype=torch.float32)
    t, chunk = 4608, 512
    toks = torch.randint(0, cfg.vocab_size, (1, t), generator=gen, device="cuda")
    caches = tf.init_caches(cfg, 1, t, torch.float32, "cuda")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for lo in range(0, t, chunk):
        logits, _ = tf.prefill_chunk(cfg, params, toks[:, lo:lo + chunk], caches, [lo])
    torch.cuda.synchronize()
    chunk_launches = ops.launch_counts()["flash_attention"]
    ops.reset_launch_counts()
    full, _, _ = tf.forward_full(cfg, params, toks, capacity_factor=-1.0)
    torch.cuda.synchronize()
    full_launches = ops.launch_counts()["flash_attention"]
    want = full[0, -1]
    err = (logits[0] - want).abs().max().item()
    log(f"  mixtral-8x22b {cfg.num_layers} layers fp32, {t} tokens in chunks of {chunk} into a "
        f"ring of {caches['0']['k'].shape[2]} slots: last logits vs forward_full max_abs_err="
        f"{err:.3e} (|logits| max {want.abs().max().item():.3f}; tolerance {FULL_TOL}); argmax "
        f"{int(logits[0].argmax())} vs {int(want.argmax())}; flash launches {chunk_launches} "
        f"chunked, {full_launches} forward_full")
    if chunk_launches != cfg.num_layers * (t // chunk) or full_launches != cfg.num_layers:
        raise AssertionError("ring prefill: flash_attention not launched once per layer and call")
    if not torch.isfinite(logits).all() or not torch.allclose(logits[0], want, **FULL_TOL):
        raise AssertionError("ring prefill in chunks disagrees with forward_full")
    del params, caches, full, logits
    torch.cuda.empty_cache()
    return chunk_launches, full_launches


def window_entries(torch, fa, spec, timer, ring_args):
    """Kernel 4 with mixtral's window of 4096: ``forward_full``'s call on
    WINDOW_T tokens at mixtral's heads (48 / 8 of 128, bf16), and the
    heaviest ring prefill chunk of the bf16 serve; each against its plain
    version, with its time, bound (kept pairs only) and SDPA time (a boolean
    window mask)."""
    q, k, v = flash_case(torch, torch.bfloat16, 48, 8, 128, 1, WINDOW_T, WINDOW_T, 7, spare=0)
    kw = dict(causal=True, sliding_window=4096, q_offset=0, logit_softcap=0.0)
    full = {"case": f"forward_full T={WINDOW_T} window 4096",
            **flash_entry(torch, fa, (q, k, v, kw), spec, timer)}
    log(f"  flash_attention, {full['case']}: {full}")
    log_previous(full["case"], full)
    del q, k, v
    torch.cuda.empty_cache()
    ring = {"case": "heaviest mixtral ring prefill chunk",
            **flash_entry(torch, fa, ring_args, spec, timer)}
    log(f"  flash_attention, {ring['case']}: {ring}")
    log_previous(ring["case"], ring)
    return [full, ring]


def recurrent_phase(torch, ops, fa, serve_mod, tf, spec, timer, line):
    """Phase 11: (a) mamba2-1.3b at full width and depth, bf16, phase 3's
    workload, its decode step profiled; (b) its fp32 legs; (c) mixtral-8x22b
    at full width and MIXTRAL_LAYERS layers with prompts past the window,
    its fp32 legs at MIXTRAL_FP32_LAYERS layers and the ring prefill against
    ``forward_full``; (d) kernel 4 at the window; (e) jamba reduced, served
    and its fp32 legs.  Adds to the kernel line's flash entry."""
    depth_cuts(torch)
    log("[11a] mamba2-1.3b at full width and depth, bf16, contiguous path")
    recurrent_serve(torch, ops, serve_mod, tf, MAMBA_ARGV, profile=True)
    torch.cuda.empty_cache()
    log(f"[11b] mamba2-1.3b at fp32 and {MAMBA_FP32_LAYERS} layers: preempted vs "
        "uninterrupted, segmented vs plain decode")
    recurrent_fp32_legs(torch, serve_mod, MAMBA_ARGV + ["--layers", str(MAMBA_FP32_LAYERS)],
                        moe=False)

    log(f"[11c] mixtral-8x22b at full width, {MIXTRAL_LAYERS} layers, bf16: prompts of 4608 "
        "tokens past the 4096 window")
    torch.cuda.reset_peak_memory_stats()
    res, counts, ring_args = recurrent_serve(torch, ops, serve_mod, tf, MIXTRAL_ARGV)
    log(f"  peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    serve_launches = counts["flash_attention"]
    del res
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  mixtral-8x22b at fp32 and {MIXTRAL_FP32_LAYERS} layers")
    argv32 = [a if a != str(MIXTRAL_LAYERS) else str(MIXTRAL_FP32_LAYERS) for a in MIXTRAL_ARGV]
    recurrent_fp32_legs(torch, serve_mod, argv32, moe=True)
    chunk_launches, full_launches = ring_prefill_check(torch, ops, fa, tf)

    log("[11d] flash_attention with mixtral's window of 4096")
    windowed = window_entries(torch, fa, spec, timer, ring_args)
    del ring_args
    torch.cuda.empty_cache()

    log("[11e] jamba-1.5-large-398b reduced, bf16 and fp32 legs")
    _res, jcounts, _args = recurrent_serve(torch, ops, serve_mod, tf, JAMBA_ARGV)
    del _res, _args
    recurrent_fp32_legs(torch, serve_mod, JAMBA_ARGV, moe=True)
    entry = next(e for e in line if e["name"] == "flash_attention")
    entry["sliding_window_4096"] = {
        "arch": "mixtral-8x22b", "launches_serve": serve_launches,
        "launches_ring_prefill_fp32": chunk_launches,
        "launches_forward_full_fp32": full_launches,
        "launches_jamba_reduced_serve": jcounts["flash_attention"], "calls": windowed}


# ------------------------------------------------------------------ phase 12
# The last two architecture families at full width and depth, random weights
# from seed 0.  llama-3.2-vision-11b serves phase 3's workload on the
# contiguous path (its only one), each request with its own image embeds,
# submitted to RealEngine directly; its fp32 legs run at VLM_FP32_LAYERS
# layers.  hubert-xlarge, an encoder (no serving path), runs forward_full on
# HUBERT_FRAMES frames per sequence.
VLM_ARGV = SERVE_ARGV + ["--arch", "llama-3.2-vision-11b"]
VLM_FP32_LAYERS = 40
HUBERT_FRAMES = 1500  # 30 s of 20 ms frames


class CrossCapture:
    """Wraps ``ops.flash_attention`` during a VLM serve: delegates every
    call unchanged, counts self-attention (causal) and cross-attention
    (non-causal) calls, the latter split by query rows per sequence: more
    than one (prefill chunks) or one (decode batches, and a prefill chunk
    of one token); keeps a clone of the heaviest cross call of each kind
    (most query-key pairs: the heaviest prefill chunk, the largest decode
    batch)."""

    def __init__(self, fn):
        self.fn = fn
        self.calls = {"self": 0, "cross chunk": 0, "cross one query": 0}
        self.best, self.args = {}, {}

    def __call__(self, q, k, v, **kw):
        if kw.get("causal", True):
            self.calls["self"] += 1
        else:
            kind = "cross one query" if q.shape[1] == 1 else "cross chunk"
            self.calls[kind] += 1
            n = q.shape[0] * q.shape[1] * k.shape[1]
            if n > self.best.get(kind, -1):
                self.best[kind], self.args[kind] = n, flash_clone(q, k, v, **kw)
        return self.fn(q, k, v, **kw)


def vlm_serve(torch, ops, serve_mod, argv):
    """Phase 3's workload on the VLM, each request with its own
    (num_image_tokens, vision_dim) image embeds from the seed, submitted to
    the engine that ``serve --mode real`` builds from ``argv``: the offline
    batch, ``--online-after`` steps, then the online arrivals.  Kernels
    counted (zeroed just before, read just after) and the flash calls
    captured (``CrossCapture``).  Every request must finish with all its
    tokens.  Returns the engine, the requests, the counts, the capture and
    the seconds."""
    import numpy as np

    from repro_torch.core.request import Priority, Request

    args = serve_mod.build_parser().parse_args(argv)
    cfg, eng = serve_mod.build_real_engine(args)
    eng.margins = {}
    online, offline = serve_mod.real_prompts(args, cfg)
    rng = np.random.default_rng(args.seed)
    images = rng.standard_normal((len(online) + len(offline), cfg.num_image_tokens,
                                  cfg.vision_dim), dtype=np.float32)

    def request(prio, prompt, img):
        return Request(prio, prompt_len=len(prompt), max_new_tokens=args.max_new,
                       arrival_time=eng._clock(), prompt=prompt, image_embeds=img)

    cap = CrossCapture(ops.flash_attention)
    ops.flash_attention = cap
    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        reqs = [request(Priority.OFFLINE, p, img) for p, img in zip(offline, images)]
        for r in reqs:
            eng.submit(r)
        eng.run(max_steps=args.online_after)
        arrivals = [request(Priority.ONLINE, p, img)
                    for p, img in zip(online, images[len(offline):])]
        for r in arrivals:
            eng.on_online_arrival(r)
        eng.run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = ops.launch_counts()
    finally:
        ops.flash_attention = cap.fn
    short = [r.request_id for r in reqs + arrivals if len(r.output_tokens) != args.max_new]
    if short:
        raise AssertionError(f"{cfg.name}: requests without all their tokens: {short}")
    generated = sum(len(r.output_tokens) for r in reqs + arrivals)
    preemptions = sum(r.num_preemptions for r in reqs + arrivals)
    log(f"  {cfg.name}: layers={cfg.num_layers} ({cfg.num_periods} periods of "
        f"{[s.mixer for s in cfg.layer_pattern()]}) d_model={cfg.d_model} heads="
        f"{cfg.num_heads}/{cfg.num_kv_heads} head_dim={cfg.resolved_head_dim} image tokens="
        f"{cfg.num_image_tokens} x {cfg.vision_dim} {eng.dtype}, {path_of(eng)} path, "
        f"{eng.ec.num_device_blocks} blocks")
    log(f"  steps={eng.steps} preemptions={preemptions} checkpointer="
        f"{'on' if eng.ckpt.enabled else 'off'} restored_blocks={eng.restored_blocks} "
        f"dispatches={eng.dispatches}; recomputed tokens at each resume (request, tokens): "
        f"{eng.recomputed}")
    log(f"  generated={generated} tokens in {seconds:.3f} s = {generated / seconds:.1f} tok/s "
        f"(host clock); {iteration_figures(eng)}")
    log(f"  launches: {counts}; flash calls by kind: {cap.calls}")
    return {"cfg": cfg, "engine": eng, "reqs": reqs, "arrivals": arrivals, "counts": counts,
            "capture": cap, "seconds": seconds, "preemptions": preemptions}


def check_vlm_serve(torch, tf, res):
    """Phase 12(a)'s checks of a preempted VLM serve: the contiguous path
    with recompute resume (checkpointer off, nothing stored or restored,
    one recompute per preemption); the flash kernel launched
    (self + cross) x prefill dispatches + cross x decode dispatches + (cross
    layers per segment) x segment dispatches, the cross calls being the
    non-causal ones, and no other kernel; the dispatches reading nothing
    back."""
    eng, cfg, counts, cap = res["engine"], res["cfg"], res["counts"], res["capture"]
    d = eng.dispatches
    pattern = [s.mixer for s in cfg.layer_pattern()]
    n_self = cfg.num_periods * pattern.count("attn")
    n_cross = cfg.num_periods * pattern.count("cross_attn")
    spans = tf.segment_spans(cfg)
    if len({pps for _lo, pps in spans}) != 1:
        raise AssertionError(f"segments of unequal periods: {spans}")
    per_segment = spans[0][1] * pattern.count("cross_attn")
    want = (n_self + n_cross) * d["prefill"] + n_cross * d["decode"] + per_segment * d["segment"]
    log(f"  flash launches = ({n_self} self + {n_cross} cross) x {d['prefill']} prefill + "
        f"{n_cross} x {d['decode']} decode + {per_segment} x {d['segment']} segment "
        f"dispatches = {want}; counted {counts['flash_attention']}")
    if counts["flash_attention"] != want or d["prefill"] == 0 or d["segment"] == 0:
        raise AssertionError("llama-3.2-vision: flash_attention launches off the formula")
    if (cap.calls["self"] != n_self * d["prefill"]
            or cap.calls["cross chunk"] + cap.calls["cross one query"]
            != n_cross * (d["prefill"] + d["decode"]) + per_segment * d["segment"]):
        raise AssertionError(f"llama-3.2-vision: flash calls by kind {cap.calls}")
    if any(n for name, n in counts.items() if name != "flash_attention"):
        raise AssertionError("llama-3.2-vision: a kernel other than flash_attention launched")
    if eng.paged or eng.ckpt.enabled or not eng.recompute_only:
        raise AssertionError("llama-3.2-vision: not the contiguous path with recompute resume")
    if (res["preemptions"] == 0 or len(eng.recomputed) != res["preemptions"]
            or eng.restored_blocks or len(eng.host)):
        raise AssertionError("llama-3.2-vision: the serve did not preempt and resume by "
                             "recompute")
    check_reads_nothing_back(torch, tf, eng)


def vlm_tokens(res):
    eng = res["engine"]
    return [(list(r.output_tokens), eng.margins[r.request_id]) for r in res["reqs"]]


def vlm_prefill_check(torch, ops, tf, res, chunk: int = 32):
    """Phase 12(b): the first offline request of a served fp32 engine,
    prefilled again in chunks of ``chunk`` into a fresh cache with its image
    at offset 0, against ``forward_full(image_embeds=...)`` over its prompt:
    the last logits within FULL_TOL, the flash kernel launched once per
    layer per chunk and once per layer in the forward."""
    eng, cfg = res["engine"], res["cfg"]
    r = res["reqs"][0]
    toks = eng._put(r.prompt[None])
    img = eng._put(r.image_embeds[None])
    caches = tf.init_caches(cfg, 1, eng.ec.max_model_len, eng.dtype, eng.device)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for lo in range(0, r.prompt_len, chunk):
        logits, _ = tf.prefill_chunk(cfg, eng.params, toks[:, lo:lo + chunk], caches, [lo],
                                     image_embeds=img if lo == 0 else None)
    torch.cuda.synchronize()
    chunk_launches = ops.launch_counts()["flash_attention"]
    ops.reset_launch_counts()
    full, _, _ = tf.forward_full(cfg, eng.params, toks, image_embeds=img)
    torch.cuda.synchronize()
    full_launches = ops.launch_counts()["flash_attention"]
    want = full[0, -1]
    err = (logits[0] - want).abs().max().item()
    chunks = -(-r.prompt_len // chunk)
    log(f"  {cfg.name} {cfg.num_layers} layers fp32, one request's {r.prompt_len} prompt "
        f"tokens in {chunks} chunks of {chunk}, image at offset 0: last logits vs "
        f"forward_full(image_embeds) max_abs_err={err:.3e} (|logits| max "
        f"{want.abs().max().item():.3f}; tolerance {FULL_TOL}); argmax {int(logits[0].argmax())} "
        f"vs {int(want.argmax())}; flash launches {chunk_launches} chunked, {full_launches} "
        "forward_full")
    if chunk_launches != cfg.num_layers * chunks or full_launches != cfg.num_layers:
        raise AssertionError("VLM prefill: flash_attention not launched once per layer and call")
    if not torch.isfinite(logits).all() or not torch.allclose(logits[0], want, **FULL_TOL):
        raise AssertionError("VLM prefill in chunks disagrees with forward_full")


def vlm_fp32_legs(torch, ops, serve_mod, tf):
    """Phase 12(b): the VLM at fp32 and VLM_FP32_LAYERS layers, phase
    12(a)'s workload and images: a preempted run's tokens (recompute at
    each resume, the cross K/V rebuilt from the image) against an
    uninterrupted run's (a pool of 2048 blocks), and the safepoint-segmented
    decode's against the plain decode's (``--no-safepoints``), up to the
    first near-tie; then ``vlm_prefill_check`` on the uninterrupted
    engine."""
    argv32 = fp32_argv(VLM_ARGV)
    if VLM_FP32_LAYERS != 40:
        argv32 += ["--layers", str(VLM_FP32_LAYERS)]
        log(f"  fp32 legs cut to {VLM_FP32_LAYERS} of 40 layers")
    runs = {}
    for name, extra in (("segmented preempted", []), ("plain preempted", ["--no-safepoints"]),
                        ("uninterrupted", ["--num-device-blocks", "2048"])):
        t0 = time.perf_counter()
        res = vlm_serve(torch, ops, serve_mod, argv32 + extra)
        eng = res["engine"]
        log(f"  fp32 {name}: preemptions={res['preemptions']} steps={eng.steps} segment "
            f"dispatches={eng.dispatches['segment']} {time.perf_counter() - t0:.1f} s")
        runs[name] = (res["preemptions"], vlm_tokens(res), eng.dispatches["segment"])
        if name == "uninterrupted":
            vlm_prefill_check(torch, ops, tf, res)
        del res, eng
        gc.collect()
        torch.cuda.empty_cache()
    if (runs["segmented preempted"][0] == 0 or runs["plain preempted"][0] == 0
            or runs["uninterrupted"][0] != 0 or runs["segmented preempted"][2] == 0
            or runs["plain preempted"][2] != 0):
        raise AssertionError("phase 12: the fp32 legs did not contrast preempted and "
                             "uninterrupted, segmented and plain decodes")
    compare_runs("llama-3.2-vision preempted vs uninterrupted", runs["segmented preempted"][1],
                 runs["uninterrupted"][1])
    compare_runs("llama-3.2-vision segmented vs plain decode", runs["segmented preempted"][1],
                 runs["plain preempted"][1])


def hubert_check(torch, ops, fa, tf):
    """Phase 12(c): hubert-xlarge at full width and depth, ``forward_full``
    on 2 x HUBERT_FRAMES frame embeddings from the seed, bf16 then fp32,
    the flash kernel (non-causal, D = 80) launched once per layer.  At
    fp32: the logits against the same forward through the kernel's plain
    version within FULL_TOL, and flipping the last frame changes the first
    position's logits (bidirectional).  Returns the bf16 forward's flash
    launches and a clone of its first flash call."""
    from repro_torch.configs import get_config

    cfg = get_config("hubert-xlarge")
    log(f"  {cfg.name}: layers={cfg.num_layers} d_model={cfg.d_model} heads={cfg.num_heads}/"
        f"{cfg.num_kv_heads} head_dim={cfg.resolved_head_dim} causal={cfg.causal} "
        f"embed_inputs={cfg.embed_inputs} vocab={cfg.vocab_size}: "
        f"{cfg.param_count() / 1e9:.3f} B parameters (param_count)")
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = tf.init_params(cfg, gen, dtype=dtype)
        x = torch.randn((2, HUBERT_FRAMES, cfg.d_model), generator=gen, device="cuda").to(dtype)
        cap = Capture(ops.flash_attention, lambda q, k, v: 0, flash_clone)
        ops.flash_attention = cap
        try:
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            logits, _, _ = tf.forward_full(cfg, params, x)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = ops.launch_counts()["flash_attention"]
        finally:
            ops.flash_attention = cap.fn
        log(f"  {dtype} forward_full {tuple(x.shape)}: logits {tuple(logits.shape)}, flash "
            f"launches {launches}, {seconds * 1e3:.1f} ms (host clock, first call); flash "
            f"call q{tuple(cap.args[0].shape)} causal={cap.args[3]['causal']}")
        if (launches != cfg.num_layers or logits.shape != (2, HUBERT_FRAMES, cfg.vocab_size)
                or not torch.isfinite(logits).all() or cap.args[3]["causal"]):
            raise AssertionError(f"hubert-xlarge {dtype}: forward_full launches, shape or "
                                 "values wrong")
        if dtype == torch.bfloat16:
            out = {"launches": launches, "args": cap.args}
            del params, x, logits, cap
            torch.cuda.empty_cache()
            continue
        del cap
        kernel = ops.flash_attention
        ops.flash_attention = lambda q, k, v, **kw: fa.flash_attention_ref(q, k, v, **kw)
        try:
            plain, _, _ = tf.forward_full(cfg, params, x)
        finally:
            ops.flash_attention = kernel
        err = (logits - plain).abs().max().item()
        x2 = x.clone()
        x2[:, -1] *= -1.0
        flipped, _, _ = tf.forward_full(cfg, params, x2)
        moved = (logits[:, 0] - flipped[:, 0]).abs().max().item()
        log(f"  fp32 logits kernel vs plain max_abs_err={err:.3e} (|logits| max "
            f"{plain.abs().max().item():.3f}; tolerance {FULL_TOL}); flipping the last frame "
            f"moves the first position's logits by {moved:.3e}")
        if not torch.allclose(logits, plain, **FULL_TOL):
            raise AssertionError("hubert-xlarge: kernel path disagrees with the plain path")
        if not moved > 1e-6:
            raise AssertionError("hubert-xlarge: the encoder is not bidirectional")
        del params, x, x2, logits, plain, flipped
        torch.cuda.empty_cache()
    return out


def vlm_phase(torch, ops, fa, serve_mod, tf, build, builds, spec, timer, line):
    """Phase 12: (a) llama-3.2-vision-11b at full width and depth, bf16, its
    serve checked and its decode step profiled; (b) its fp32 legs;
    (c) hubert-xlarge's ``forward_full``; (d) the flash entry's
    ``head_dim_80`` and ``cross_attention``."""
    from repro_torch.configs import get_config

    for arch in ("llama-3.2-vision-11b", "hubert-xlarge"):
        n = get_config(arch).param_count()
        log(f"  {arch}: {n / 1e9:.3f} B parameters (param_count) = {2 * n / 1e9:.1f} GB bf16, "
            f"{4 * n / 1e9:.1f} GB fp32")
    free, total = torch.cuda.mem_get_info()
    log(f"  card memory: {free / 1e9:.1f} GB free of {total / 1e9:.1f} GB")
    log("[12a] llama-3.2-vision-11b at full width and depth, bf16, contiguous path, "
        "each request with its own image")
    torch.cuda.reset_peak_memory_stats()
    res = vlm_serve(torch, ops, serve_mod, VLM_ARGV)
    check_vlm_serve(torch, tf, res)
    log(f"  peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    eng, cap, serve_counts = res["engine"], res["capture"], res["counts"]
    profile_steps(torch, eng, op_names=("aten::cat",), top_ops=True)
    every = time_decode_stacking(torch, eng, n=8)
    cross = time_decode_stacking(torch, eng, n=8, names=("ck", "cv"))
    log(f"  the cross K/V's share of stacking 8 caches: {cross / every:.1%} (host clock)")
    cross_args, cap_calls = cap.args, dict(cap.calls)
    del res, eng, cap
    gc.collect()
    torch.cuda.empty_cache()

    log(f"[12b] llama-3.2-vision-11b at fp32 and {VLM_FP32_LAYERS} layers: preempted vs "
        "uninterrupted, segmented vs plain decode, chunked prefill vs forward_full")
    vlm_fp32_legs(torch, ops, serve_mod, tf)

    log(f"[12c] hubert-xlarge forward_full at full width and depth on 2 x {HUBERT_FRAMES} frames")
    hubert = hubert_check(torch, ops, fa, tf)

    log("[12d] flash_attention at head dim 80 and at the VLM's cross-attention calls")
    d80 = {"case": f"hubert-xlarge forward_full (2, {HUBERT_FRAMES}) non-causal",
           **flash_entry(torch, fa, hubert["args"], spec, timer)}
    log(f"  flash_attention, {d80['case']}: {d80}")
    log_previous("hubert-xlarge", d80)
    calls = []
    for kind, what in (("cross chunk", "heaviest cross-attention prefill chunk"),
                       ("cross one query", "largest cross-attention decode batch")):
        entry = {"case": f"{what} of the bf16 serve",
                 **flash_entry(torch, fa, cross_args[kind], spec, timer)}
        log(f"  flash_attention, {entry['case']}: {entry}")
        log_previous(what, entry)
        calls.append(entry)
    build80 = {}
    for inst, r in builds.get("flash_attention", {}).items():
        m = re.search(r"(_wg_kernel<|<float, )80>", inst)
        if m:
            r["dynamic_smem"] = smem_bytes(build, "flash_attention", int(m[1] != "<float, "), 80)
            build80[inst] = r
    log(f"  ptxas, D = 80: {build80}")
    entry = next(e for e in line if e["name"] == "flash_attention")
    entry["head_dim_80"] = {"arch": "hubert-xlarge", "launches_forward_full": hubert["launches"],
                            **d80, "build": build80}
    entry["cross_attention"] = {"arch": "llama-3.2-vision-11b",
                                "launches_serve": serve_counts["flash_attention"],
                                "calls_serve": cap_calls, "calls": calls}


def launch_cost_us(torch, n: int = 20000) -> float:
    """Host time per launch of a small elementwise kernel (a chain of ``n``
    adds on a 256 x 256 tensor, then a synchronisation): what the host
    pays per operator, which sets the host-bound step."""
    x = torch.zeros((256, 256), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        x = x + 1.0
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def main() -> int:
    kernels_only = "--kernels-only" in sys.argv[1:]
    # a torch.profiler session leaves CUPTI subscribed and every later launch
    # pays for it unless the profiler tears CUPTI down: phases 3-3c and 7
    # profile, and the phases after them time the host
    os.environ.setdefault("TEARDOWN_CUPTI", "1")
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: the port's sources are not next to this script", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.profiler import h100_spec
    from repro_torch.kernels import build, flash_attention as fa, kv_checkpoint as cg, ops
    from repro_torch.kernels import paged_attention as rpa
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import transformer as tf

    t_start = time.perf_counter()
    smi = nvidia_smi()
    log(f"[1] device: {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"  torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    log(f"  host cost per launch {launch_cost_us(torch):.2f} us (before any profiler; "
        f"TEARDOWN_CUPTI={os.environ['TEARDOWN_CUPTI']})")
    t0 = time.perf_counter()
    build.build_all()
    log(f"  kernels built in {time.perf_counter() - t0:.1f} s into {build.BUILD_DIR}")
    builds = {name: ptxas_report(text) for name, text in build.build_logs.items()}
    for name, report in builds.items():
        for inst, r in report.items():
            log(f"    {name}: {inst}: {r}")
    for name in ("flash_attention", "ragged_paged_attention", "paged_attention"):
        spills = {inst: r for inst, r in builds.get(name, {}).items()
                  if ("_tc_kernel" in inst or "_wg_kernel" in inst or "merge_kernel" in inst)
                  and (r.get("spill_stores") or r.get("spill_loads"))}
        if spills:
            raise AssertionError(f"{name}: bf16 kernels spill registers: {spills}")
    flash_sass = sass_counts(build, "flash_attention")
    for inst, c in flash_sass.items():
        log(f"    flash_attention SASS: {inst}: {c}")
        builds.setdefault("flash_attention", {}).setdefault(inst, {})["sass"] = c
    wg = {inst: c for inst, c in flash_sass.items() if "_wg_kernel<" in inst}
    if len(wg) != 4 or not all(c["HGMMA"] and c["UTMALDG"] for c in wg.values()):
        raise AssertionError(f"flash_attention: the bf16 kernels lack wgmma or TMA loads: {wg}")
    ragged_sass = sass_counts(build, "ragged_paged_attention")
    for inst, c in ragged_sass.items():
        log(f"    ragged_paged_attention SASS: {inst}: {c}")
        builds.setdefault("ragged_paged_attention", {}).setdefault(inst, {})["sass"] = c
    wg = {inst: c for inst, c in ragged_sass.items() if "_wg_kernel<" in inst}
    if len(wg) != 3 or not all(c["HGMMA"] and c["UTMALDG"] for c in wg.values()):
        raise AssertionError(f"ragged_paged_attention: the bf16 kernels lack wgmma or TMA "
                             f"loads: {wg}")

    log("[2] kernels vs their plain versions on the card")
    check_kernels(torch, ops, rpa, cg, fa)
    spec = h100_spec(torch.cuda.get_device_name(0))
    if kernels_only:
        log("[5] attention kernels at 2-4 thousand-token contexts")
        timer = Timer(torch)
        long_context_entries(torch, rpa, spec, timer)
        flash_long_entries(torch, fa, spec, timer)
        flash_long_entries(torch, fa, spec, timer, VLM_SHAPE, "llama-3.2-vision-11b", ts=(4096,))
        long_context_entries(torch, rpa, spec, timer, GEMMA_SHAPE, qwen=False)
        flash_long_entries(torch, fa, spec, timer, GEMMA_SHAPE, "gemma-7b")
        log(f"  Timer: {timer.late} repetitions reached their start event before the host "
            "had queued the call")
        log(f"  card: {smi}; total {time.perf_counter() - t_start:.1f} s")
        return 0

    log("[3] serve Llama-2-7B at full width through repro_torch.launch.serve.run_real")
    res, counts, args = run_serve(torch, ops, serve_mod, tf, SERVE_ARGV)
    uncalibrated = {"fused": iteration_figures(res["engine"])}
    fused_decode = {"decode": "not measured (no profiler trace)"}
    split_decode = dict(fused_decode)
    profile_steps(torch, res["engine"], figures=fused_decode)
    del res
    torch.cuda.empty_cache()

    log("[3b] the same workload on the split path (--no-fused-batch)")
    res, split_counts, split_args = run_serve(torch, ops, serve_mod, tf,
                                              SERVE_ARGV + ["--no-fused-batch"])
    uncalibrated["split"] = iteration_figures(res["engine"])
    check_reads_nothing_back(torch, tf, res["engine"])
    check_split_decode_kernel(profile_steps(torch, res["engine"], figures=split_decode),
                              res["cfg"])
    del res
    torch.cuda.empty_cache()

    log("[3c] the same workload on the contiguous path (--backend contiguous)")
    res, contiguous_counts, contiguous_args = run_serve(
        torch, ops, serve_mod, tf, SERVE_ARGV + ["--backend", "contiguous"])
    uncalibrated["contiguous"] = iteration_figures(res["engine"])
    check_reads_nothing_back(torch, tf, res["engine"])
    profile_steps(torch, res["engine"])
    time_decode_stacking(torch, res["engine"])
    del res
    torch.cuda.empty_cache()

    log("[4] self-consistency at fp32: preempted vs uninterrupted vs prefix cache off "
        "vs split path vs contiguous path")
    argv32 = [a if a != "bfloat16" else "float32" for a in SERVE_ARGV]
    runs = {}
    for name, extra in (("preempted", []),
                        ("uninterrupted", ["--num-device-blocks", "512"]),
                        ("prefix cache off", ["--no-prefix-cache"]),
                        ("split preempted", ["--no-fused-batch"]),
                        ("contiguous preempted", ["--backend", "contiguous"])):
        res = serve(serve_mod, argv32 + extra)
        log(f"  {name}: preemptions={res['preemptions']} steps={res['engine'].steps} "
            f"{res['generated'] / res['seconds']:.1f} tok/s")
        runs[name] = (res["preemptions"], offline_tokens(res))
        if name == "preempted":  # every request's tokens, for phase 7(c)
            eng = res["engine"]
            serial = [(list(r.output_tokens), eng.margins[r.request_id])
                      for r in [h.request for h in res["streams"]] + list(res["job"].requests)]
            del eng
        del res
        torch.cuda.empty_cache()
    if (runs["preempted"][0] == 0 or runs["split preempted"][0] == 0
            or runs["contiguous preempted"][0] == 0 or runs["uninterrupted"][0] != 0):
        raise AssertionError("phase 4 did not contrast preempted and uninterrupted runs")
    compare_runs("preempted vs uninterrupted", runs["preempted"][1], runs["uninterrupted"][1])
    compare_runs("prefix cache on vs off", runs["preempted"][1], runs["prefix cache off"][1])
    compare_runs("split vs fused, preempted", runs["split preempted"][1], runs["preempted"][1])
    same = compare_runs("contiguous vs fused, preempted", runs["contiguous preempted"][1],
                        runs["preempted"][1])
    if same != len(runs["preempted"][1]):
        raise AssertionError(f"contiguous vs fused: {same} of {len(runs['preempted'][1])} "
                             "requests identical")
    del runs

    log("[4b] forward_full at full width, fp32: flash kernel vs its plain version")
    full_launches = forward_full_check(torch, ops, fa, tf)

    log("[5] kernels at their paths' captured inputs")
    timer = Timer(torch)
    line = kernel_line(torch, rpa, cg, fa, counts, split_counts, contiguous_counts,
                       full_launches, args, split_args, contiguous_args, spec, timer)
    log(f"  Timer: device spin of {timer.cycles_per_ms:.0f} cycles per ms; {timer.late} "
        "repetitions reached their start event before the host had queued the call")
    add_build_reports(build, builds, line, args["ragged_paged_attention"],
                      split_args["paged_attention"])
    del args, split_args, contiguous_args
    torch.cuda.empty_cache()

    log("[6] calibration of the three paths, then phase 3's workload on each")
    fused_profile = calibrated_serves(torch, serve_mod, uncalibrated)

    log("[7] wall-clock co-serving: CoServingRuntime on the fused engine")
    log(f"  host cost per launch {launch_cost_us(torch):.2f} us (after phases 3-3c's profiles)")
    t7 = time.perf_counter()
    wall_counts, replayed = wallclock_phase(torch, ops, serve_mod, serial,
                                            fused_decode["decode"])
    for entry in line:
        if entry["name"] in ("ragged_paged_attention", "checkpoint_gather"):
            entry["launches_wallclock"] = wall_counts[entry["name"]]
    log(f"  phase 7 took {time.perf_counter() - t7:.1f} s")

    log("[8] tensor-parallel paged serving: two KV-head shards on this card")
    t8 = time.perf_counter()
    line += tp_phase(torch, ops, rpa, serve_mod, tf, spec, timer, serial,
                     {"fused": fused_decode["decode"], "split": split_decode["decode"]},
                     fused_profile)
    log(f"  phase 8 took {time.perf_counter() - t8:.1f} s")

    log("[9] the async host/device pipeline (RealEngineConfig(pipeline=True))")
    t9 = time.perf_counter()
    pipeline_phase(torch, ops, serve_mod, tf, timer, serial, replayed, fused_decode,
                   fused_profile, line)
    log(f"  phase 9 took {time.perf_counter() - t9:.1f} s")

    log("[10] gemma-7b and olmoe-1b-7b at full width and depth")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  before phase 10: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
        f"peak so far {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    t10 = time.perf_counter()
    arch_phase(torch, ops, rpa, cg, fa, serve_mod, tf, build, builds, spec, timer, line)
    log(f"  phase 10 took {time.perf_counter() - t10:.1f} s")

    log("[11] archs that resume by recompute: mamba2-1.3b, mixtral-8x22b, jamba reduced")
    gc.collect()
    torch.cuda.empty_cache()
    t11 = time.perf_counter()
    recurrent_phase(torch, ops, fa, serve_mod, tf, spec, timer, line)
    log(f"  phase 11 took {time.perf_counter() - t11:.1f} s")

    log("[12] the last two families: llama-3.2-vision-11b (cross-attention), "
        "hubert-xlarge (encoder)")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  before phase 12: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
        f"peak so far {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    t12 = time.perf_counter()
    vlm_phase(torch, ops, fa, serve_mod, tf, build, builds, spec, timer, line)
    log(f"  phase 12 took {time.perf_counter() - t12:.1f} s")
    log(f"  card: {smi}; bound at {spec.name} peaks (hbm {spec.hbm_bw / 1e12:.2f} TB/s)")
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
