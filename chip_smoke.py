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
   fails).
2. Each hand-written kernel against its plain PyTorch version on the card,
   at fp32 and bf16, at the Llama-2-7B and Qwen2-0.5B attention shapes,
   with cases at the tensor-core kernels' 16-row and 64-key edges, and
   decode batches that the bf16 decode kernel cuts into several key splits
   (``DECODE_CASES``; each logs its splits).
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
   4096 tokens), and its ptxas report per instantiation with the bf16
   kernels' dynamic shared memory (``build``).  The decode kernel adds its
   key splits and split-merge launches; the gather, unchanged since it was
   ported, is also timed by the Timer of earlier runs, as the control.
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
Last line: ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import ctypes
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
                   qmax=32):
    """A ragged batch as the engine builds it.  The default is a mixed
    batch: prefill chunks, q_len = 1 decodes, a padded sequence with
    kv_len = 0, padded query slots at q_pos = 0, -1 table entries past each
    sequence's pages."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    page = 16
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
# Rounds of the tensor-core kernel are 64 keys (4 pages of 16).
RAGGED_CASES = {
    "mixed batch": {},
    "Qmax * G off 16 rows": dict(q_lens=(3, 1, 2, 0), kv_lens=(40, 17, 70, 0), qmax=3),
    "kv_len inside a round": dict(q_lens=(1, 5, 1, 0), kv_lens=(101, 101, 64, 0), qmax=5),
    "chunk across two rounds": dict(q_lens=(32, 20, 0), kv_lens=(80, 70, 0), qmax=32),
    "warp tiles of padded slots only": dict(q_lens=(1, 48, 2, 0), kv_lens=(200, 48, 130, 0),
                                            qmax=48),
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


def decode_splits_of(torch, rpa, q, kp, tb):
    """(splits, keys per split) that ``paged_attention`` uses on these
    inputs: the host's choice from shapes for bf16; fp32 does not split."""
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
    # the tensor-core kernel's 16-row warp tiles and key splits: Tq of one,
    # just over one and just under two warp tiles behind a q_offset, Tk one
    # short of and one past a 64-key tile
    *((f"Tq = {tq} behind a q_offset, Tk = {tk}", 2, tq, tk, True, 0, tk - tq)
      for tq in (16, 17, 31) for tk in (63, 65)),
]


def flash_case(torch, dtype, h, hkv, d, b, tq, tk, seed, spare=40):
    """q (B, Tq, H, D) and k, v as the first Tk slots of (B, Tk + spare,
    Hkv, D) caches."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, tq, h, d), generator=g, device="cuda").to(dtype)
    kc = torch.randn((b, tk + spare, hkv, d), generator=g, device="cuda").to(dtype)
    vc = torch.randn((b, tk + spare, hkv, d), generator=g, device="cuda").to(dtype)
    return q, kc[:, :tk], vc[:, :tk]


def check_flash(torch, fa):
    """Phase 2, flash_attention: every FLASH_CASES entry at softcap 0 and 30,
    fp32 and bf16, at the Llama-2-7B and Qwen2-0.5B shapes."""
    for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for arch, (h, hkv, d) in (("llama-2-7b", (32, 32, 128)), ("qwen2-0.5b", (14, 2, 64))):
            for case, b, tq, tk, causal, window, off in FLASH_CASES:
                for cap in (0.0, 30.0):
                    q, k, v = flash_case(torch, dtype, h, hkv, d, b, tq, tk, 5)
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
        for arch, (h, hkv, d) in (("llama-2-7b", (32, 32, 128)), ("qwen2-0.5b", (14, 2, 64))):
            for cap in (0.0, 30.0):
                for case, kw in DECODE_CASES.items():
                    q, kp, vp, tb, lens, cap = decode_case(torch, dtype, h, hkv, d, cap, 4, **kw)
                    merges = rpa.paged_attention.merge_launches
                    got = rpa.paged_attention(q, kp, vp, tb, lens, logit_softcap=cap)
                    merges = rpa.paged_attention.merge_launches - merges
                    want = rpa.paged_attention_ref(q, kp, vp, tb, lens, logit_softcap=cap)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    zero = got[lens == 0].float().abs().max().item()
                    splits, keys = decode_splits_of(torch, rpa, q, kp, tb)
                    log(f"  paged_attention {dname} {arch} H={h} Hkv={hkv} D={d} {case} "
                        f"(seq_lens={lens.tolist()} page={kp.shape[1]} table={tb.shape[1]} "
                        f"splits={splits} of {keys} keys, merges={merges}) softcap={cap:g}: "
                        f"max_abs_err={err:.3e} seq_len=0 rows max={zero:g}")
                    if not torch.allclose(got.float(), want.float(), **TOL[dname]) or zero != 0:
                        raise AssertionError(f"paged_attention disagrees ({dname}, {arch}, {case})")
                    if merges != (splits > 1):
                        raise AssertionError(f"paged_attention: {merges} merges for {splits} splits")
                for case, kw in RAGGED_CASES.items():
                    q, kp, vp, tb, qp, kvl, cap = attention_case(torch, dtype, h, hkv, d, cap,
                                                                 1, **kw)
                    got = rpa.ragged_paged_attention(q, kp, vp, tb, qp, kvl, logit_softcap=cap)
                    want = rpa.ragged_paged_attention_ref(q, kp, vp, tb, qp, kvl,
                                                          logit_softcap=cap)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    zero = got[-1].float().abs().max().item()
                    log(f"  ragged_paged_attention {dname} {arch} H={h} Hkv={hkv} D={d} {case} "
                        f"(Qmax={q.shape[1]}) softcap={cap:g}: max_abs_err={err:.3e} "
                        f"kv_len=0 rows max={zero:g}")
                    if not torch.allclose(got.float(), want.float(), **TOL[dname]) or zero != 0:
                        raise AssertionError(f"ragged_paged_attention disagrees ({dname}, {arch}, "
                                             f"{case})")
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
    sequences of ceil(kv_len / page), from the last argument (``kv_lens``,
    or the decode kernel's ``seq_lens``).  The layers of one dispatch share
    one block-table tensor, so the lengths are read back once per dispatch."""

    def __init__(self):
        self.key, self.pages = None, 0

    def __call__(self, q, kp, vp, tb, *rest):
        if tb is not self.key:
            page, lens = kp.shape[1], rest[-1]
            self.key, self.pages = tb, int(((lens.long() + page - 1) // page).sum())
        return self.pages


def serve(serve_mod, argv):
    args = serve_mod.build_parser().parse_args(argv)
    return serve_mod.run_real(args, record_margins=True)


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


def run_serve(torch, ops, serve_mod, tf, argv):
    """Phases 3-3c: one serve run at full width, every kernel captured and
    counted (counts zeroed just before, read just after)."""
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
    for name, cap in caps.items():
        setattr(ops, name, cap)
    try:
        ops.reset_launch_counts()
        res = serve(serve_mod, argv)
        counts = ops.launch_counts()
        counts["paged_attention merges"] = ops.KERNELS["paged_attention"].merge_launches
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
        if counts["ragged_paged_attention"] != per_segment * d["fused_segment"]:
            raise AssertionError("ragged_paged_attention launches != layers of the segments run")
        if counts["ragged_paged_attention"] < cfg.num_layers * (eng.steps - aborts):
            raise AssertionError("ragged_paged_attention launched fewer than 32 x completed steps")
        if counts["paged_attention"] != 0:
            raise AssertionError("the fused path launched the decode kernel")
    else:
        if counts["paged_attention"] != cfg.num_layers * d["decode"] + per_segment * d["segment"]:
            raise AssertionError("paged_attention launches != 32 x decode dispatches + "
                                 "layers per segment x segment dispatches")
        if counts["paged_attention"] == 0 or d["prefill"] == 0:
            raise AssertionError("the split path ran no decode or no prefill dispatch")
        if counts["ragged_paged_attention"] != 0:
            raise AssertionError("the split path launched the ragged kernel")
    ckpt = counts["checkpoint_gather"] if eng.paged else eng.ckpt.stats.blocks_checkpointed
    if res["preemptions"] == 0 or ckpt == 0 or eng.restored_blocks == 0:
        raise AssertionError("the run did not preempt, checkpoint and restore")
    return res, counts, {name: cap.args for name, cap in caps.items()}


def check_reads_nothing_back(torch, tf, eng):
    """The split and contiguous paths' dispatches read nothing back to the
    host, under ``torch.cuda.set_sync_debug_mode("error")`` (a synchronising
    call raises).  Split: one ``prefill_chunk_paged`` and one
    ``decode_step_paged`` on the served engine's pools, every row on the
    scratch block.  Contiguous: two ``prefill_chunk`` dispatches (the second
    behind the first, so the flash kernel reads a cached prefix) and one
    ``decode_step`` on a fresh cache."""
    import numpy as np

    b, scratch = 8, eng._scratch_block
    toks = eng._put(np.zeros((b, 32), np.int32))
    last = eng._put(np.full((b,), 31, np.int32))
    lens = eng._put(np.full((b,), 100, np.int32))
    if eng.paged:
        tables = eng._put(np.full((b, eng._table_width), scratch, np.int32))
        offs = eng._put(np.zeros((b,), np.int32))
    else:
        caches = tf.init_caches(eng.cfg, b, eng.ec.max_model_len, eng.dtype, eng.device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        if eng.paged:
            tf.prefill_chunk_paged(eng.cfg, eng.params, toks, eng.pools, tables, offs, last)
            tf.decode_step_paged(eng.cfg, eng.params, offs, eng.pools, tables, lens)
        else:
            tf.prefill_chunk(eng.cfg, eng.params, toks, caches, [0] * b)
            tf.prefill_chunk(eng.cfg, eng.params, toks, caches, [32] * b)
            tf.decode_step(eng.cfg, eng.params, last, caches, lens)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log(f"  {path_of(eng)} prefill and decode dispatches ran under sync debug mode 'error': "
        "no host read-back")


def time_decode_stacking(torch, eng, n: int = 12):
    """Host-clock time of the contiguous decode's batching: concatenating
    ``n`` requests' B=1 caches (every leaf) into one batch, as
    ``RealEngine._decode_contiguous`` does each decode step."""
    caches = [eng._fresh_cache(None) for _ in range(n)]
    first = caches[0]

    def stack():
        return {pos: {name: torch.cat([c[pos][name] for c in caches], dim=1)
                      for name in first[pos]} for pos in first}

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
    log(f"  stacking {n} caches of max_model_len {eng.ec.max_model_len} for one decode step "
        f"(torch.cat, every leaf): {ms:.3f} ms for {nbytes / 1e6:.1f} MB read and written "
        f"= {nbytes / ms / 1e9:.2f} TB/s")
    del caches, out


def profile_steps(torch, eng, steps: int = 6, figures=None):
    """Where an iteration's time goes, on the served engine with 8 fresh
    offline requests (64-token prompts) decoding: ``steps`` steps timed
    without the profiler, then ``steps`` more under ``torch.profiler``.
    Prints the device-busy time per step over both step times (the
    profiler stretches a step) and the kernels by device time: the ten
    largest and every kernel of the port.  Returns the rows (device us,
    calls, name) per step, or None where the profiler cannot trace the
    card: that is reported, not fatal.  ``figures`` (a dict) receives the
    step and busy times as text."""
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
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    plain = time.perf_counter() - t0
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                eng.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # kernels only: an operator's row repeats the device time of the
        # kernels it launched
        rows = [(getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0),
                 e.count, e.key) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
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
    want = rpa.ragged_paged_attention_ref(q, kp, vp, tb, qp, kvl, logit_softcap=cap)
    err = (got.float() - want.float()).abs().max().item()
    if not torch.allclose(got.float(), want.float(), **TOL[dname]):
        raise AssertionError(f"ragged_paged_attention disagrees at {tuple(q.shape)} "
                             f"kv_lens={kvl.tolist()}: max_abs_err={err:.3e}")
    bound, by = attention_bound(torch, q, kp, tb, qp, kvl, PEAK_FLOPS[dname], spec.hbm_bw)
    return {
        "max_abs_err": err,
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
    want = rpa.paged_attention_ref(q, kp, vp, tb, lens, logit_softcap=cap)
    err = (got.float() - want.float()).abs().max().item()
    if not torch.allclose(got.float(), want.float(), **TOL[dname]):
        raise AssertionError(f"paged_attention disagrees at {tuple(q.shape)} "
                             f"seq_lens={lens.tolist()}: max_abs_err={err:.3e}")
    bound, by = decode_bound(torch, q, kp, tb, lens, PEAK_FLOPS[dname], spec.hbm_bw)
    splits, keys = decode_splits_of(torch, rpa, q, kp, tb)
    return {
        "max_abs_err": err, "splits": splits, "split_keys": keys,
        **timed(timer, lambda: rpa.paged_attention(q, kp, vp, tb, lens, logit_softcap=cap)),
        "plain_ms": timer.ms(lambda: rpa.paged_attention_ref(q, kp, vp, tb, lens, logit_softcap=cap)),
        "bound_ms": bound, "bound_by": by,
        "shape": {"q": list(q.shape), "pool": list(kp.shape), "tables": list(tb.shape),
                  "seq_lens": lens.tolist(), "dtype": dname},
    }


def long_context_entries(torch, rpa, spec, timer):
    """Both paged attention kernels on the same long-context inputs: the
    ragged kernel on every ``LONG_CASES`` batch at the Llama-2-7B shape and
    on the decode batch at the Qwen2-0.5B shape (14 query heads on 2 KV
    heads, D = 64), the decode kernel on both decode batches recast as
    q (B, H, D) and seq_lens = kv_lens (at Qwen2-0.5B's 32 (sequence, KV
    head) pairs it splits the keys)."""
    ragged, decode = [], []
    cases = [(case, kw, (32, 32, 128)) for case, kw in LONG_CASES.items()]
    cases.append(("qwen2-0.5b decode", LONG_CASES["decode"], (14, 2, 64)))
    for case, kw, (h, hkv, d) in cases:
        args = attention_case(torch, torch.bfloat16, h, hkv, d, 0.0, 3, **kw)
        lens = f"{min(kw['kv_lens'])}..{max(kw['kv_lens'])}"
        entry = {"case": case, **attention_entry(torch, rpa, args, spec, timer)}
        entry["shape"]["kv_lens"] = lens
        log(f"  ragged_paged_attention, {case}: {entry}")
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


def flash_long_entries(torch, fa, spec, timer):
    """The flash kernel at forward_full's shapes: one Llama-2-7B sequence
    of 2048 and of 4096 tokens, causal, bf16."""
    out = []
    for t in (2048, 4096):
        q, k, v = flash_case(torch, torch.bfloat16, 32, 32, 128, 1, t, t, 6, spare=0)
        kw = dict(causal=True, sliding_window=0, q_offset=0, logit_softcap=0.0)
        entry = {"case": f"forward_full T={t}", **flash_entry(torch, fa, (q, k, v, kw),
                                                               spec, timer)}
        log(f"  flash_attention, forward_full T={t}: {entry}")
        out.append(entry)
        del q, k, v
    return out


def forward_full_check(torch, ops, fa, tf, t: int = 2048):
    """Phase 4b: ``forward_full`` of Llama-2-7B at full width, fp32 weights
    from a seed, on one ``t``-token sequence: flash kernel launches counted
    (zeroed just before, read just after), then the same forward with the
    kernel's plain version; the last position's logits must agree within
    FULL_TOL."""
    from repro_torch.configs import get_config

    cfg = get_config("llama-2-7b")
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
    log(f"  forward_full (1, {t}) fp32: flash_attention launches={launches}; last-position "
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
    dmain = decode_entry(torch, rpa, split_args["paged_attention"], spec, timer)
    log(f"  paged_attention, heaviest split-path call: {dmain}")
    long_ragged, long_decode = long_context_entries(torch, rpa, spec, timer)
    shape, dshape = main.pop("shape"), dmain.pop("shape")
    out = [{
        "name": "ragged_paged_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/ragged_paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:217",
        "launches": counts["ragged_paged_attention"], **main,
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
    fshape = fmain.pop("shape")
    out.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:107",
        "launches": contiguous_counts["flash_attention"],
        "launches_forward_full": full_launches, **fmain, "shape": fshape,
        "long_context": flash_long_entries(torch, fa, spec, timer),
    })
    pool, ids = args["checkpoint_gather"]
    got = cg.checkpoint_gather(pool, ids)
    want = cg.checkpoint_gather_ref(pool, ids)
    if not torch.equal(got, want):
        raise AssertionError(f"checkpoint_gather disagrees at pool {tuple(pool.shape)}, "
                             f"{ids.numel()} ids")
    err = (got.float() - want.float()).abs().max().item()
    nbytes = 2 * got.numel() * got.element_size() + ids.numel() * 4
    out.append({
        "name": "checkpoint_gather", "route": "cuda",
        "source": "src/repro_torch/csrc/checkpoint_gather.cu",
        "replaces": "src/repro/kernels/kv_checkpoint.py:30",
        "launches": counts["checkpoint_gather"], "max_abs_err": err,
        **timed(timer, lambda: cg.checkpoint_gather(pool, ids)),
        # the control: the unchanged kernel under the Timer of earlier runs
        "old_timer_ms": Timer(torch, device_wait=False).ms(lambda: cg.checkpoint_gather(pool, ids)),
        "plain_ms": timer.ms(lambda: cg.checkpoint_gather_ref(pool, ids)),
        "bound_ms": nbytes / spec.hbm_bw * 1e3, "bound_by": "bytes",
        "library_ms": timer.ms(lambda: pool.index_select(1, ids)),
        "shape": {"pool": list(pool.shape), "ids": ids.numel(), "dtype": str(pool.dtype)},
    })
    return out


def add_build_reports(build, builds, line, ragged_args, decode_args):
    """Each kernel's ptxas report per instantiation (``build``), with the
    dynamic shared memory of a block of each bf16 tensor-core kernel: the
    flash kernel's is fixed, the ragged and decode kernels' at their paths'
    heaviest calls (Qmax * G rows or G heads, page size, table width)."""
    q, kp, _vp, tb = ragged_args[:4]
    rows, page, m = q.shape[1] * (q.shape[2] // kp.shape[2]), kp.shape[1], tb.shape[1]
    group, split_m = decode_args[0].shape[1] // decode_args[1].shape[2], decode_args[3].shape[1]
    for entry in line:
        name = entry["name"]
        report = builds.get(name)
        entry["build"] = report if report else "not built in this run"
        for inst, r in (report or {}).items():
            d = re.search(r"_tc_kernel<(\d+)>", inst)
            if d and name == "flash_attention":
                r["dynamic_smem"] = smem_bytes(build, name, 1, int(d[1]))
            elif d and name == "ragged_paged_attention":
                r["dynamic_smem"] = smem_bytes(build, name, 1, int(d[1]), rows, page, m)
                r["dynamic_smem_at"] = {"rows": rows, "page": page, "table_width": m}
            elif d and name == "paged_attention":
                r["dynamic_smem"] = smem_bytes(build, name, 1, int(d[1]), group, split_m)
                r["dynamic_smem_at"] = {"group": group, "table_width": split_m}


def calibrated_serves(torch, serve_mod, uncalibrated):
    """Phase 6: calibrate a bf16 engine of each path, print its profile, and
    serve phase 3's workload on it; measured against predicted seconds per
    iteration beside the uncalibrated runs' figures."""
    names = ("c0 (s)", "prefill token", "prefill attention token", "decode token",
             "decode context token")
    for path, extra in (("fused", []), ("split", ["--no-fused-batch"]),
                        ("contiguous", ["--backend", "contiguous"])):
        t0 = time.perf_counter()
        res = serve(serve_mod, SERVE_ARGV + extra + ["--calibrate"])
        eng = res["engine"]
        prof = eng.profile
        if prof is None or eng.sched.model is not prof:
            raise AssertionError(f"{path}: calibrate() installed no measured profile")
        coef = ", ".join(f"{n} {c:.4g}" for n, c in zip(names, prof._coef))
        log(f"  {path}: {len(prof.samples)} probes + {len(prof.swap_samples)} swap probes; "
            f"profile s/iteration = {coef}; swap "
            f"{None if prof._swap_coef is None else prof._swap_coef.tolist()}; "
            f"calibration and serving took {time.perf_counter() - t0:.1f} s")
        reqs = [h.request for h in res["streams"]] + list(res["job"].requests)
        if any(len(r.output_tokens) != MAX_NEW for r in reqs):
            raise AssertionError(f"{path}: a request lacks tokens after calibration")
        phase = {"fused": "3", "split": "3b", "contiguous": "3c"}[path]
        log(f"  {path} uncalibrated (phase {phase}): {uncalibrated[path]}")
        log(f"  {path} calibrated: {iteration_figures(eng)}")
        del res, eng
        torch.cuda.empty_cache()


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


def replay_fp32_tokens(torch, serve_mod, serial):
    """Phase 7(c): phase 4's workload at fp32 (the same engine settings and
    prompts) replayed through the runtime under a ManualClock with TTFT SLO
    0: the offline jobs at t = 0, the online requests at REPLAY_ONLINE_AT.
    At least one online arrival must abort a pure-offline batch at a
    safepoint; every request's tokens must equal those of phase 4's serial
    run up to the first near-tie."""
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
                    prompt=p) for t, p in zip(REPLAY_ONLINE_AT, online)]
    reqs += [Request(Priority.OFFLINE, prompt_len=len(p), max_new_tokens=MAX_NEW, prompt=p)
             for p in offline]
    rt = CoServingRuntime(eng, clock=ManualClock(auto_tick=1e-3))
    probe = AbortProbe(torch, eng)
    t0 = time.perf_counter()
    try:
        m = rt.replay(reqs)
        torch.cuda.synchronize()
    finally:
        probe.close()
    check_served("7(c)", rt, m, reqs)
    log(f"  {len(online)} online at manual t={list(REPLAY_ONLINE_AT)} s + {len(offline)} offline, "
        f"pool {eng.ec.num_device_blocks} blocks: steps={eng.steps} safepoint_aborts="
        f"{rt.stats.safepoint_aborts} preemptions={m.num_preemptions} restored_blocks="
        f"{eng.restored_blocks}; {time.perf_counter() - t0:.1f} s (host clock)")
    probe.report("7(c)")
    if rt.stats.safepoint_aborts < 1:
        raise AssertionError("7(c): no online arrival aborted a pure-offline batch")
    got = [(list(r.output_tokens), eng.margins[r.request_id]) for r in reqs]
    compare_runs("wall-clock runtime vs engine alone (fp32, every request)", got, serial)
    del rt, eng, reqs
    torch.cuda.empty_cache()


def wallclock_phase(torch, ops, serve_mod, serial, decode_phase3):
    """Phase 7: (a) bf16 replay, (b) threaded serving with the gateway,
    (c) fp32 tokens of a replay with a safepoint abort.  Returns (a)'s
    kernel launches."""
    args = serve_mod.build_parser().parse_args(WALL_ARGV)
    log("[7a] replay of a loadgen trace through CoServingRuntime, bf16, host clock")
    cfg, params, counts = replay_bf16(torch, ops, serve_mod, args)
    log("[7b] the threaded runtime behind a Frontend and the metrics server")
    threaded_serve(torch, serve_mod, cfg, params, args, decode_phase3)
    del params
    torch.cuda.empty_cache()
    log("[7c] fp32 replay with a safepoint abort against phase 4's serial tokens")
    replay_fp32_tokens(torch, serve_mod, serial)
    return counts


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
                  if ("_tc_kernel" in inst or "merge_kernel" in inst)
                  and (r.get("spill_stores") or r.get("spill_loads"))}
        if spills:
            raise AssertionError(f"{name}: bf16 kernels spill registers: {spills}")

    log("[2] kernels vs their plain versions on the card")
    check_kernels(torch, ops, rpa, cg, fa)
    spec = h100_spec(torch.cuda.get_device_name(0))
    if kernels_only:
        log("[5] attention kernels at 2-4 thousand-token contexts")
        timer = Timer(torch)
        long_context_entries(torch, rpa, spec, timer)
        flash_long_entries(torch, fa, spec, timer)
        log(f"  Timer: {timer.late} repetitions reached their start event before the host "
            "had queued the call")
        log(f"  card: {smi}; total {time.perf_counter() - t_start:.1f} s")
        return 0

    log("[3] serve Llama-2-7B at full width through repro_torch.launch.serve.run_real")
    res, counts, args = run_serve(torch, ops, serve_mod, tf, SERVE_ARGV)
    uncalibrated = {"fused": iteration_figures(res["engine"])}
    fused_decode = {"decode": "not measured (no profiler trace)"}
    profile_steps(torch, res["engine"], figures=fused_decode)
    del res
    torch.cuda.empty_cache()

    log("[3b] the same workload on the split path (--no-fused-batch)")
    res, split_counts, split_args = run_serve(torch, ops, serve_mod, tf,
                                              SERVE_ARGV + ["--no-fused-batch"])
    uncalibrated["split"] = iteration_figures(res["engine"])
    check_reads_nothing_back(torch, tf, res["engine"])
    check_split_decode_kernel(profile_steps(torch, res["engine"]), res["cfg"])
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
    calibrated_serves(torch, serve_mod, uncalibrated)

    log("[7] wall-clock co-serving: CoServingRuntime on the fused engine")
    log(f"  host cost per launch {launch_cost_us(torch):.2f} us (after phases 3-3c's profiles)")
    t7 = time.perf_counter()
    wall_counts = wallclock_phase(torch, ops, serve_mod, serial, fused_decode["decode"])
    for entry in line:
        if entry["name"] in ("ragged_paged_attention", "checkpoint_gather"):
            entry["launches_wallclock"] = wall_counts[entry["name"]]
    log(f"  phase 7 took {time.perf_counter() - t7:.1f} s")
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
