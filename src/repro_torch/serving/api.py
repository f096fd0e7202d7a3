"""Frontends: real-time streaming API (online) + Batch API (offline).

Mirrors the paper's frontend split (§4.1): the streaming API assigns high
priority and returns tokens as they are produced; the Batch API (OpenAI
Batch style) accepts a pool of requests and resolves asynchronously.  Users
never set priorities manually (§5) — the API chooses.

A ``Frontend`` binds to anything exposing the engine submission surface:
``RealEngine`` directly (single-threaded: caller alternates submissions
with ``engine.step()``/``run()``), or a ``serving.runtime.CoServingRuntime``
(wall-clock serving: the engine loop runs on its own thread and this API
may be called from any other thread — DESIGN.md §10, §15).

Streaming: when the bound engine is a ``CoServingRuntime`` the handle gets a
``TokenChannel`` fed from the engine thread at commit time, so ``for tok in
handle`` blocks per token and is **lossless** — the channel is closed only
after every generated token value has been pushed (including pipelined
engines whose token values materialize after the structural commit), and
iteration ends only once the consumer has drained the buffer past the close.
Without a runtime (plain ``RealEngine``) the handle stays in poll mode; see
``StreamHandle.poll`` for the poll-after-finish contract.

Admission and backpressure: submissions that can never fit the serving
configuration raise ``core.scheduler.AdmissionError`` *synchronously*,
before the request enters any queue and before a single KV block is
allocated.  A runtime with a bounded ingress queue (DESIGN.md §15) may
additionally raise ``QueueFull`` (reject-fast policy — HTTP 429 semantics)
or ``QueueTimeout`` (queue-with-timeout policy — HTTP 503 semantics); both
also guarantee zero scheduler/KV state for the rejected request.
``submit_batch`` validates the whole pool before queuing any of it, so a
rejected batch leaves no partial state.
"""
from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass
from typing import Callable, Iterator, List, Optional

import numpy as np

from repro_torch.core.request import Phase, Priority, Request


class BackpressureError(RuntimeError):
    """Base for typed ingress-queue rejections (never raised itself)."""


class QueueFull(BackpressureError):
    """Reject-fast policy: the per-class ingress queue is at capacity.
    Maps to HTTP 429 Too Many Requests — retry with client-side backoff."""


class QueueTimeout(BackpressureError):
    """Queue-with-timeout policy: capacity did not free up within the
    deadline.  Maps to HTTP 503 Service Unavailable + Retry-After."""


class EngineStalled(BackpressureError):
    """Watchdog rejection: the engine thread is alive but its heartbeat is
    older than the watchdog timeout while work is pending (DESIGN.md §16).
    Maps to HTTP 503 Service Unavailable — the stall may clear."""


class TokenChannel:
    """Per-request token event channel: engine thread pushes, API thread
    consumes (DESIGN.md §15).

    Memory/ordering contract: ``push`` appends under the condition lock and
    wakes consumers; tokens are observed in push order; ``close`` is sticky
    and ordered after every push the producer made.  Iteration terminates
    only when the channel is closed *and* the consumer has drained the
    buffer — so close-after-final-push can never drop a tail, which is the
    whole point versus the old poll-then-check-finished idiom.  The buffer
    is bounded by the request's ``max_new_tokens`` (the producer never
    pushes more), so no flow control is needed on this edge.

    Error-EOS (DESIGN.md §16): ``close(error=...)`` is the failure-domain
    sentinel — still sticky, still ordered after every push, and it wakes
    every blocked consumer.  Iteration drains any tokens delivered before
    the fault (losslessly), then raises ``error`` instead of returning;
    ``get`` keeps its value contract (the error is surfaced via ``error``/
    iteration/``StreamHandle.result``, not by poisoning ``get``).
    """

    def __init__(self):
        self._cond = threading.Condition()
        self._buf: List[int] = []
        self._read = 0
        self._closed = False
        self.error: Optional[BaseException] = None  # set by close(error=...)
        # non-empty push batches — a per-token producer makes this approach
        # the token count; a per-request producer would leave it at 1
        self.pushes = 0

    def push(self, tokens: List[int]) -> None:
        if not tokens:
            return
        with self._cond:
            if self._closed:
                raise RuntimeError("push after close on TokenChannel")
            self._buf.extend(tokens)
            self.pushes += 1
            self._cond.notify_all()

    def close(self, error: Optional[BaseException] = None) -> None:
        with self._cond:
            if not self._closed and error is not None:
                self.error = error
            self._closed = True
            self._cond.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed

    def get(self, timeout: Optional[float] = None) -> Optional[List[int]]:
        """Block until tokens arrive, the channel closes, or ``timeout``.

        Returns the newly available tokens (possibly several if the consumer
        lagged), ``[]`` if the channel closed with nothing left, or ``None``
        on timeout with the channel still open.
        """
        with self._cond:
            while self._read >= len(self._buf) and not self._closed:
                if not self._cond.wait(timeout):
                    return None
            new = self._buf[self._read :]
            self._read = len(self._buf)
            return new

    def __iter__(self) -> Iterator[int]:
        while True:
            with self._cond:
                while self._read >= len(self._buf) and not self._closed:
                    self._cond.wait()
                if self._read < len(self._buf):
                    tok = self._buf[self._read]
                    self._read += 1
                else:  # closed and drained
                    if self.error is not None:
                        raise self.error
                    return
            yield tok


@dataclass
class StreamHandle:
    """Consumer half of a streaming request.

    Two modes:

    * **Channel mode** (``Frontend`` bound to a ``CoServingRuntime``):
      ``for tok in handle`` blocks per token and terminates losslessly at
      end-of-stream; ``result()`` blocks until the stream closes and
      returns the full output.  Do not mix ``poll`` with iteration — they
      share no cursor.
    * **Poll mode** (plain engine, caller drives ``step()``): use
      ``poll()``/``finished``.  Contract: tokens may land *between* your
      last ``poll()`` and your ``finished`` check, so the idiom
      ``while not h.finished: h.poll()`` MUST be followed by one final
      ``h.poll()`` after ``finished`` turns true — that final drain is
      guaranteed to return the complete tail.  ``__iter__`` encodes this
      drain for already-finished handles.
    """

    request: Request
    channel: Optional[TokenChannel] = None
    _cursor: int = 0

    def poll(self) -> List[int]:
        """Tokens produced since the last poll (streaming semantics).

        Safe (and required — see class docstring) to call once more after
        ``finished`` becomes true: the final call returns every token
        recorded since the previous poll, including any that landed between
        that poll and the ``finished`` observation.
        """
        new = self.request.output_tokens[self._cursor :]
        self._cursor += len(new)
        return new

    @property
    def finished(self) -> bool:
        return self.request.phase in (Phase.FINISHED, Phase.FAILED)

    def __iter__(self) -> Iterator[int]:
        if self.channel is not None:
            return iter(self.channel)
        return self._poll_iter()

    def _poll_iter(self) -> Iterator[int]:
        while True:
            done = self.finished  # read BEFORE draining (lossless ordering)
            for tok in self.poll():
                yield tok
            if done:
                return
            raise RuntimeError(
                "blocking iteration needs a CoServingRuntime-bound Frontend "
                "(channel mode); with a bare engine, drive engine.step() and "
                "use poll()/finished, or iterate after finished is true"
            )

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Full output tokens; blocks until end-of-stream in channel mode."""
        if self.channel is not None:
            deadline = None if timeout is None else time.monotonic() + timeout
            while not self.channel.closed:
                t = (
                    None
                    if deadline is None
                    else max(0.0, deadline - time.monotonic())
                )
                if self.channel.get(timeout=t) is None and not self.channel.closed:
                    raise TimeoutError("stream still open after timeout")
            if self.channel.error is not None:
                raise self.channel.error
        elif not self.finished:
            raise RuntimeError(
                "stream not finished; drive the engine or use poll()"
            )
        elif self.request.error is not None:  # poll mode, FAILED request
            raise self.request.error
        return list(self.request.output_tokens)


@dataclass
class BatchJob:
    job_id: int
    requests: List[Request]

    @property
    def done(self) -> bool:
        return all(r.phase == Phase.FINISHED for r in self.requests)

    @property
    def progress(self) -> float:
        total = sum(r.max_new_tokens for r in self.requests)
        got = sum(r.num_generated for r in self.requests)
        return got / max(1, total)

    def results(self) -> List[List[int]]:
        if not self.done:
            raise RuntimeError("batch job still running")
        return [r.output_tokens for r in self.requests]


class Frontend:
    """Binds the two APIs to an engine (real or simulated).

    ``engine`` must expose ``submit(request)`` and, for the urgent online
    path, ``on_online_arrival(request)`` (real engine).  If it additionally
    exposes ``register_stream`` (``CoServingRuntime``), streaming handles
    get a ``TokenChannel`` and become blocking per-token iterators.
    """

    def __init__(self, engine, clock: Optional[Callable[[], float]] = None):
        self.engine = engine
        self._clock = clock or (lambda: 0.0)
        self._jobs = itertools.count()

    # ---- real-time streaming API (online) --------------------------------
    def stream(
        self,
        prompt: np.ndarray,
        max_new_tokens: int,
        image_embeds: Optional[np.ndarray] = None,
    ) -> StreamHandle:
        req = Request(
            Priority.ONLINE,
            prompt_len=len(prompt),
            max_new_tokens=max_new_tokens,
            arrival_time=self._clock(),
            prompt=np.asarray(prompt, np.int32),
            image_embeds=image_embeds,
        )
        # register BEFORE submitting so no commit can race past the channel;
        # unregister on any rejection so nothing leaks
        register = getattr(self.engine, "register_stream", None)
        channel = register(req) if register is not None else None
        try:
            if hasattr(self.engine, "on_online_arrival"):
                self.engine.on_online_arrival(req)
            else:
                self.engine.submit(req)
        except BaseException:
            if channel is not None:
                self.engine.unregister_stream(req)
            raise
        return StreamHandle(req, channel=channel)

    # ---- Batch API (offline) ----------------------------------------------
    def submit_batch(
        self,
        prompts: List[np.ndarray],
        max_new_tokens: int,
        image_embeds: Optional[List[np.ndarray]] = None,
    ) -> BatchJob:
        reqs = []
        for i, p in enumerate(prompts):
            reqs.append(
                Request(
                    Priority.OFFLINE,
                    prompt_len=len(p),
                    max_new_tokens=max_new_tokens,
                    arrival_time=self._clock(),
                    prompt=np.asarray(p, np.int32),
                    image_embeds=None if image_embeds is None else image_embeds[i],
                )
            )
        # admission is all-or-nothing: validate the pool before queuing any
        checker = getattr(
            getattr(self.engine, "sched", None), "check_admission", None
        )
        if checker is not None:
            for r in reqs:
                checker(r)
        # a bounded-ingress runtime reserves capacity for the whole pool
        # atomically (QueueFull/QueueTimeout leave no partial state)
        submit_all = getattr(self.engine, "submit_all", None)
        if submit_all is not None:
            submit_all(reqs)
        else:
            for r in reqs:
                self.engine.submit(r)
        return BatchJob(next(self._jobs), reqs)
