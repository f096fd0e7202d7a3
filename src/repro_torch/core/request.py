"""Request / sequence lifecycle for co-served online + offline inference."""
from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


class Priority(enum.IntEnum):
    ONLINE = 0  # latency-critical (streaming API) — strictly higher priority
    OFFLINE = 1  # best-effort (batch API)


class Phase(enum.Enum):
    WAITING = "waiting"  # queued, no device state
    PREFILL = "prefill"  # prompt KV being built (possibly chunked)
    DECODE = "decode"  # autoregressive generation
    PREEMPTED = "preempted"  # evicted from device (host ckpt and/or recompute)
    FINISHED = "finished"
    FAILED = "failed"  # request-scoped fault; terminal like FINISHED


_ids = itertools.count()


@dataclass(eq=False)  # identity semantics (prompt arrays are not comparable)
class Request:
    priority: Priority
    prompt_len: int
    max_new_tokens: int
    arrival_time: float = 0.0
    prompt: Optional[np.ndarray] = None  # real-exec mode; sim mode uses lengths
    image_embeds: Optional[np.ndarray] = None  # VLM: stubbed-frontend patches
    request_id: int = field(default_factory=lambda: next(_ids))

    # ---- mutable progress -------------------------------------------------
    phase: Phase = Phase.WAITING
    num_prefilled: int = 0  # prompt tokens whose KV is live on device
    output_tokens: List[int] = field(default_factory=list)  # real-exec mode
    num_generated: int = 0

    # ---- preemption bookkeeping --------------------------------------------
    num_preemptions: int = 0
    # tokens of KV recoverable from host checkpoints (set on preempt)
    host_recoverable: int = 0

    # ---- prefix caching ----------------------------------------------------
    # prompt tokens served from the shared-prefix index at admission
    # (DESIGN.md §14); stays set after preemption as a stats field even
    # though the mapped blocks are gone (resume recomputes from scratch)
    prefix_cached: int = 0

    # ---- metrics -----------------------------------------------------------
    first_scheduled_time: Optional[float] = None
    first_token_time: Optional[float] = None  # TTFT = this - arrival_time
    token_times: List[float] = field(default_factory=list)
    finish_time: Optional[float] = None

    # ---- failure domain (DESIGN.md §16) ------------------------------------
    # set when phase == FAILED: the typed RequestFailed that killed this
    # request; surfaced via StreamHandle.result() / the TokenChannel error-EOS
    error: Optional[BaseException] = None

    # ------------------------------------------------------------------
    @property
    def is_online(self) -> bool:
        return self.priority == Priority.ONLINE

    @property
    def total_len(self) -> int:
        """Tokens currently in the sequence (prompt + generated)."""
        return self.prompt_len + self.num_generated

    @property
    def target_len(self) -> int:
        return self.prompt_len + self.max_new_tokens

    @property
    def prefill_remaining(self) -> int:
        """Tokens still needing KV on device before decode can proceed.

        After a preemption this includes generated tokens that must be
        recomputed (they re-enter as 'prefill' work — the paper's
        resume-by-recompute path)."""
        return max(0, self.kv_target - self.num_prefilled)

    @property
    def kv_target(self) -> int:
        """Device-KV tokens needed before the next decode step.

        Fresh requests: the whole prompt (prefill emits the first token).
        Resumed requests (g>0): tokens 0..p+g-2 — the last generated token
        is fed by the decode step itself, which writes its KV/advances the
        recurrent state.  (Recomputing through p+g and re-feeding the last
        token would be idempotent for attention KV but double-advances SSM
        state — caught by the SSM resume integration test.)"""
        if self.num_generated == 0:
            return self.prompt_len
        return self.prompt_len + self.num_generated - 1

    @property
    def done(self) -> bool:
        return self.num_generated >= self.max_new_tokens

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    def tpots(self) -> List[float]:
        """Inter-token latencies (paper's per-step TPOT definition)."""
        if len(self.token_times) < 2:
            return []
        return [b - a for a, b in zip(self.token_times, self.token_times[1:])]

    # ------------------------------------------------------------------
    def record_token(self, t: float, token: Optional[int] = None) -> None:
        if self.first_token_time is None:
            self.first_token_time = t
        self.token_times.append(t)
        self.num_generated += 1
        if token is not None:
            self.output_tokens.append(int(token))
        if self.done:
            self.phase = Phase.FINISHED
            self.finish_time = t

    def on_preempt(self, recoverable_tokens: int) -> None:
        self.num_preemptions += 1
        self.host_recoverable = recoverable_tokens
        self.num_prefilled = 0  # device KV gone; resume restores/recomputes
        self.phase = Phase.PREEMPTED
