"""Latency models: the paper's offline profiler + an analytical roofline model.

ConServe's SLO-aware scheduler needs ``iter_time(batch composition)`` and
``swap_time(bytes)`` estimates (paper §4.5).  Two interchangeable backends:

* ``AnalyticalCostModel`` — roofline terms from hardware constants and the
  model config.  Drives the simulated-time benchmarks (CPU container can't
  measure TPU wall time) and provides the cost surface for ``calc_budget``.
* ``MeasuredProfiler``   — the paper's approach: run a grid of batch shapes
  offline, fit a linear model, save/load locally.

The wall-clock runtime obtains a ``MeasuredProfiler`` from an *on-device
calibration pass* (DESIGN.md §10): ``CalibrationGrid`` + ``calibrate``
time the engine's actual jitted prefill/decode entry points across the
chunk sizes and power-of-two decode buckets it really traces, so
``calc_budget`` token budgets reflect the machine being served
(``RealEngine.calibrate`` wires this up).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Protocol, Tuple

import numpy as np

from repro_torch.models.config import MIXER_ATTN, MIXER_CROSS_ATTN, ModelConfig

# ---------------------------------------------------------------------------
# Batch composition
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BatchShape:
    """What the scheduler decided to run in one iteration."""

    prefill_tokens: int = 0  # sum of prefill-chunk lengths
    prefill_attn_tokens: float = 0.0  # sum_i chunk_i * (offset_i + chunk_i/2)
    prefill_ctx_end: int = 0  # sum_i (offset_i + chunk_i) — KV read volume
    decode_tokens: int = 0  # number of decoding sequences (1 token each)
    decode_ctx: int = 0  # sum of decode context lengths (window-capped)
    num_seqs: int = 0

    @property
    def total_tokens(self) -> int:
        return self.prefill_tokens + self.decode_tokens

    @property
    def empty(self) -> bool:
        return self.total_tokens == 0

    def merge(self, other: "BatchShape") -> "BatchShape":
        return BatchShape(
            prefill_tokens=self.prefill_tokens + other.prefill_tokens,
            prefill_attn_tokens=self.prefill_attn_tokens + other.prefill_attn_tokens,
            prefill_ctx_end=self.prefill_ctx_end + other.prefill_ctx_end,
            decode_tokens=self.decode_tokens + other.decode_tokens,
            decode_ctx=self.decode_ctx + other.decode_ctx,
            num_seqs=self.num_seqs + other.num_seqs,
        )


def prefill_chunk_shape(offset: int, chunk: int, cfg: ModelConfig) -> BatchShape:
    ctx_end = offset + chunk
    if cfg.sliding_window:
        ctx_end = min(ctx_end, cfg.sliding_window)
    return BatchShape(
        prefill_tokens=chunk,
        prefill_attn_tokens=chunk * (offset + chunk / 2.0),
        prefill_ctx_end=ctx_end,
        num_seqs=1,
    )


def decode_shape(context: int, cfg: ModelConfig) -> BatchShape:
    ctx = min(context, cfg.sliding_window) if cfg.sliding_window else context
    return BatchShape(decode_tokens=1, decode_ctx=ctx, num_seqs=1)


# ---------------------------------------------------------------------------
# Hardware
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HardwareSpec:
    name: str
    flops: float  # peak FLOP/s (bf16/fp16) per chip
    hbm_bw: float  # bytes/s per chip
    host_bw: float  # device<->host bytes/s (PCIe / DMA)
    ici_bw: float = 0.0  # per-link bytes/s (interconnect)
    iter_overhead: float = 0.002  # per-iteration dispatch/sync cost (s)


# NVIDIA H100 (NVIDIA's data sheet; dense rates, half the figures it gives
# with sparsity): the SXM5 part 989 TFLOP/s bf16 (1979 with sparsity) and
# HBM3 at 3.35 TB/s; the PCIe part 756 TFLOP/s bf16 (1513 with sparsity)
# and HBM2e at 2.0 TB/s; both PCIe 5.0 x16 to the host.
H100_SXM = HardwareSpec(
    name="h100-sxm", flops=989e12, hbm_bw=3.35e12, host_bw=64e9, ici_bw=450e9
)
H100_PCIE = HardwareSpec(
    name="h100-pcie", flops=756e12, hbm_bw=2.0e12, host_bw=64e9, ici_bw=0.0
)


def h100_spec(device_name: str) -> HardwareSpec:
    """The H100 spec of the SKU ``torch.cuda.get_device_name()`` reports:
    the PCIe part when the name says so, the SXM part otherwise."""
    return H100_PCIE if "pcie" in device_name.lower() else H100_SXM


class LatencyModel(Protocol):
    def iter_time(self, shape: BatchShape) -> float: ...

    def swap_time(self, n_bytes: int) -> float: ...


# ---------------------------------------------------------------------------
# Analytical roofline model
# ---------------------------------------------------------------------------


def kv_bytes_per_token(cfg: ModelConfig, dtype_bytes: int = 2) -> int:
    """KV-cache bytes one token adds (attention layers only; SSM state is
    constant-size and accounted separately)."""
    per_layer = 2 * cfg.num_kv_heads * cfg.resolved_head_dim * dtype_bytes
    n_attn = (
        sum(1 for s in cfg.layer_pattern() if s.mixer == MIXER_ATTN)
        * cfg.num_periods
    )
    return per_layer * n_attn


def ssm_state_bytes(cfg: ModelConfig, dtype_bytes: int = 4) -> int:
    """Constant per-sequence recurrent state (Mamba layers)."""
    n_mamba = (
        sum(1 for s in cfg.layer_pattern() if s.mixer == "mamba") * cfg.num_periods
    )
    if not n_mamba:
        return 0
    per_layer = (
        cfg.ssm_num_heads * cfg.ssm_head_dim * cfg.ssm_state_size * dtype_bytes
        + (cfg.ssm_conv_width - 1) * (cfg.d_inner + 2 * cfg.ssm_state_size) * 2
    )
    return per_layer * n_mamba


def block_bytes(cfg: ModelConfig, block_size: int, dtype_bytes: int = 2) -> int:
    """Bytes of one KV page across all attention layers."""
    return kv_bytes_per_token(cfg, dtype_bytes) * block_size


@dataclass
class AnalyticalCostModel:
    cfg: ModelConfig
    hw: HardwareSpec = H100_SXM
    tp: int = 1  # chips serving the model (tensor-parallel)
    dtype_bytes: int = 2

    def __post_init__(self):
        self.active_params = self.cfg.active_param_count()
        self.kv_per_token = kv_bytes_per_token(self.cfg, self.dtype_bytes)
        n_attn = (
            sum(
                1
                for s in self.cfg.layer_pattern()
                if s.mixer in (MIXER_ATTN, MIXER_CROSS_ATTN)
            )
            * self.cfg.num_periods
        )
        self.attn_flops_coef = 4 * self.cfg.num_heads * self.cfg.resolved_head_dim * n_attn

    def flops(self, shape: BatchShape) -> float:
        lin = 2.0 * self.active_params * shape.total_tokens
        attn = self.attn_flops_coef * (shape.prefill_attn_tokens + shape.decode_ctx)
        return lin + attn

    def bytes_moved(self, shape: BatchShape) -> float:
        weights = self.active_params * self.dtype_bytes
        kv_read = self.kv_per_token * (shape.decode_ctx + shape.prefill_ctx_end)
        act = shape.total_tokens * self.cfg.d_model * self.dtype_bytes * 4
        return weights + kv_read + act

    def iter_time(self, shape: BatchShape) -> float:
        if shape.empty:
            return 0.0
        t_c = self.flops(shape) / (self.tp * self.hw.flops)
        t_m = self.bytes_moved(shape) / (self.tp * self.hw.hbm_bw)
        return max(t_c, t_m) + self.hw.iter_overhead

    def swap_time(self, n_bytes: int) -> float:
        return n_bytes / self.hw.host_bw + 1e-4

    def segment_time(self, shape: BatchShape, frac_layers: float) -> float:
        """Time for a fraction of the layer stack (safepoint granularity)."""
        if shape.empty:
            return 0.0
        t_c = self.flops(shape) / (self.tp * self.hw.flops)
        t_m = self.bytes_moved(shape) / (self.tp * self.hw.hbm_bw)
        return max(t_c, t_m) * frac_layers


# ---------------------------------------------------------------------------
# Measured profiler (the paper's offline profiler)
# ---------------------------------------------------------------------------


@dataclass
class MeasuredProfiler:
    """Fits t ≈ c0 + c1·prefill_tok + c2·prefill_attn + c3·decode_tok
    + c4·decode_ctx from offline measurements, as in §4.5."""

    samples: List[Tuple[BatchShape, float]] = field(default_factory=list)
    swap_samples: List[Tuple[int, float]] = field(default_factory=list)
    _coef: Optional[np.ndarray] = None
    _swap_coef: Optional[np.ndarray] = None

    @staticmethod
    def _features(shape: BatchShape) -> np.ndarray:
        return np.array(
            [
                1.0,
                shape.prefill_tokens,
                shape.prefill_attn_tokens,
                shape.decode_tokens,
                shape.decode_ctx,
            ]
        )

    def record(self, shape: BatchShape, seconds: float) -> None:
        self.samples.append((shape, seconds))
        self._coef = None

    def record_swap(self, n_bytes: int, seconds: float) -> None:
        self.swap_samples.append((n_bytes, seconds))
        self._swap_coef = None

    def fit(self) -> None:
        if self.samples:
            X = np.stack([self._features(s) for s, _ in self.samples])
            y = np.array([t for _, t in self.samples])
            # Non-negative-ish least squares via clipping: latency must rise
            # with load for calc_budget's search to terminate.
            coef, *_ = np.linalg.lstsq(X, y, rcond=None)
            coef[1:] = np.maximum(coef[1:], 0.0)
            coef[0] = max(coef[0], 1e-6)
            self._coef = coef
        if self.swap_samples:
            X = np.stack([[1.0, b] for b, _ in self.swap_samples])
            y = np.array([t for _, t in self.swap_samples])
            sc, *_ = np.linalg.lstsq(X, y, rcond=None)
            self._swap_coef = np.maximum(sc, 0.0)

    def iter_time(self, shape: BatchShape) -> float:
        if shape.empty:
            return 0.0
        if self._coef is None:
            self.fit()
        if self._coef is None:
            raise RuntimeError("profiler has no samples")
        return float(self._features(shape) @ self._coef)

    def swap_time(self, n_bytes: int) -> float:
        if self._swap_coef is None:
            self.fit()
        if self._swap_coef is None:
            return n_bytes / 32e9 + 1e-4
        return float(self._swap_coef[0] + self._swap_coef[1] * n_bytes)

    # ------------------------------------------------------------------ io
    def save(self, path: str) -> None:
        data = {
            "samples": [
                [s.__dict__, t] for s, t in self.samples
            ],
            "swap_samples": self.swap_samples,
        }
        with open(path, "w") as f:
            json.dump(data, f)

    @classmethod
    def load(cls, path: str) -> "MeasuredProfiler":
        with open(path) as f:
            data = json.load(f)
        prof = cls()
        for sd, t in data["samples"]:
            prof.samples.append((BatchShape(**sd), t))
        prof.swap_samples = [tuple(x) for x in data["swap_samples"]]
        prof.fit()
        return prof


@dataclass(frozen=True)
class CalibrationGrid:
    """Shapes the on-device calibration pass measures (DESIGN.md §10).

    The grid mirrors what the real engine actually executes: prefill chunks
    at the scheduler's chunk sizes, decode batches at the power-of-two
    bucket sizes the jit cache is keyed on, each at a few context depths.
    Timing every (bucket, chunk) the engine can trace also pre-compiles
    those programs, so calibration doubles as a jit warm-up pass.
    """

    chunk_sizes: Tuple[int, ...] = (16, 32, 64)
    prefill_batches: Tuple[int, ...] = (1,)  # batched-prefill group sizes
    decode_buckets: Tuple[int, ...] = (1, 2, 4, 8)
    ctx_fractions: Tuple[float, ...] = (0.25, 0.75)  # of max context
    # Fused mixed-batch samples (DESIGN.md §12), keyed on the fused path's
    # own trace key: (token bucket, max KV depth).  Each point times one
    # fused ragged dispatch of `t` total tokens — a prefill chunk plus
    # decode rows at `ctx_fraction * max_ctx` context — so
    # ``MeasuredProfiler`` prices mixed batches from DIRECT measurements
    # instead of extrapolating pure-prefill + pure-decode fits.  Empty on
    # split-path engines (the split dispatches never mix families).
    token_buckets: Tuple[int, ...] = ()
    repeats: int = 3  # timed runs per shape (min is taken)
    warmup: int = 1  # untimed runs per shape (absorbs compilation)
    # Pipelined steady-state timing (DESIGN.md §13): fused probes enqueue
    # this many iterations back-to-back and block once at the end, dividing
    # by the depth — so on a pipelined engine the fitted per-iteration cost
    # reflects host work overlapped with device compute, not the serial
    # enqueue->block->enqueue cadence that engine never runs.  Depth 1
    # (the default, and what split/serial engines use) is plain timing.
    pipeline_depth: int = 1
    # checkpoint-extract timing; power-of-two counts double as warm-up of
    # the bucketed extract gather (RealEngine pads id lists to these)
    swap_block_counts: Tuple[int, ...] = (1, 2, 4, 8)


def calibrate(
    prefill_timer: Callable[[int, int], float],
    decode_timer: Callable[[int, int], float],
    max_ctx: int,
    grid: CalibrationGrid = CalibrationGrid(),
    swap_timer: Optional[Callable[[int], Tuple[int, float]]] = None,
    fused_timer: Optional[
        Callable[[int, int], Tuple[BatchShape, float]]
    ] = None,
) -> MeasuredProfiler:
    """Fit a ``MeasuredProfiler`` from on-device measurements.

    ``prefill_timer(batch, chunk)`` and ``decode_timer(batch, ctx)`` return
    wall seconds for one iteration at that shape; ``swap_timer(n_blocks)``
    returns ``(bytes_moved, seconds)`` for a device→host checkpoint copy;
    ``fused_timer(tokens, kv_len)`` (fused engines, DESIGN.md §12) times
    one mixed ragged dispatch at that token bucket and context depth and
    returns its exact ``BatchShape`` with the measurement, so mixed-batch
    pricing comes from the fused dispatches the engine actually serves.
    The executor callables are supplied by the engine (``RealEngine.
    calibrate``) so this module stays free of serving-layer imports.

    Mesh-transparent by construction (DESIGN.md §11): on a tensor-parallel
    serving mesh the engine's timers dispatch the *sharded* programs and
    block until every shard finishes, so the fitted profile prices the mesh
    actually being served — this module never sees devices at all.
    """
    prof = MeasuredProfiler()
    for b in grid.prefill_batches:
        for c in grid.chunk_sizes:
            c = min(c, max_ctx)
            shape = BatchShape(
                prefill_tokens=b * c,
                prefill_attn_tokens=b * c * c / 2.0,
                prefill_ctx_end=b * c,
                num_seqs=b,
            )
            prof.record(shape, prefill_timer(b, c))
    for b in grid.decode_buckets:
        for f in grid.ctx_fractions:
            ctx = max(1, min(int(f * max_ctx), max_ctx - 1))
            shape = BatchShape(decode_tokens=b, decode_ctx=b * ctx, num_seqs=b)
            prof.record(shape, decode_timer(b, ctx))
    if fused_timer is not None:
        for t in grid.token_buckets:
            for f in grid.ctx_fractions:
                kv = max(1, min(int(f * max_ctx), max_ctx - 1))
                shape, secs = fused_timer(t, kv)
                prof.record(shape, secs)
    if swap_timer is not None:
        for n in grid.swap_block_counts:
            prof.record_swap(*swap_timer(n))
    prof.fit()
    return prof


def run_offline_profiling(
    executor: Callable[[BatchShape], float],
    prefill_grid: List[int] = (16, 64, 256),
    decode_grid: List[int] = (1, 4, 16),
    ctx_grid: List[int] = (64, 256),
) -> MeasuredProfiler:
    """The paper's offline profiling phase: sweep batch shapes, measure."""
    prof = MeasuredProfiler()
    for p in prefill_grid:
        shape = BatchShape(
            prefill_tokens=p, prefill_attn_tokens=p * p / 2.0,
            prefill_ctx_end=p, num_seqs=1,
        )
        prof.record(shape, executor(shape))
    for d in decode_grid:
        for c in ctx_grid:
            shape = BatchShape(decode_tokens=d, decode_ctx=d * c, num_seqs=d)
            prof.record(shape, executor(shape))
    prof.fit()
    return prof
