"""The port's kernel layer against the JAX package's, on the CPU.

The Pallas kernels run as ``tests/test_kernels.py`` runs them
(``interpret=True``); the port's plain versions — what its CUDA kernels are
held against on the card — must agree with them on the same numpy inputs.
The CUDA kernels themselves run only on the card (``chip_smoke.py``).
"""
import importlib.util
import shutil
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.kernels.kv_checkpoint import checkpoint_gather as jax_gather  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.kernels.paged_attention import (  # noqa: E402
    paged_attention as jax_paged,
    ragged_paged_attention as jax_ragged,
)
from repro.kvcache import cache_ops as jco  # noqa: E402
from repro_torch.kernels import flash_attention, kv_checkpoint, ops, paged_attention  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref  # noqa: E402
from repro_torch.kvcache import cache_ops as tco  # noqa: E402

# fp32 on both sides; the sums run in another order (the reference's own
# kernel-vs-oracle tolerance, tests/test_kernels.py)
ATOL = 2e-5


def _rand(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _ragged_inputs(q_lens, h, hkv, d, page, m, seed, kv_zero=False):
    """Queries at the tail of each context; padded slots repeat the last
    real position, as ``tests/test_kernels.py`` builds them."""
    rng = np.random.default_rng(seed)
    s, qmax = len(q_lens), max(q_lens)
    npages = s * m
    q = _rand((s, qmax, h, d), seed + 1)
    kp = _rand((npages, page, hkv, d), seed + 2)
    vp = _rand((npages, page, hkv, d), seed + 3)
    tables = rng.permutation(npages)[: s * m].reshape(s, m).astype(np.int32)
    kv = rng.integers(max(q_lens), m * page + 1, s).astype(np.int32)
    ql = np.asarray(q_lens)
    j = np.arange(qmax)[None, :]
    q_pos = (kv[:, None] - ql[:, None] + np.minimum(j, ql[:, None] - 1)).astype(np.int32)
    if kv_zero:  # a padded sequence, as the engine builds it
        kv[-1], q_pos[-1], tables[-1, 1:] = 0, 0, -1
    return q, kp, vp, tables, q_pos, kv


RAGGED_CASES = [
    # q_lens per sequence, h, hkv, d, page, m
    ([1, 1, 1], 8, 2, 64, 16, 4),  # pure decode (q_len = 1 degenerate case)
    ([8, 1, 4, 1], 4, 2, 32, 8, 6),  # mixed prefill chunks + decodes, GQA
    ([6, 3], 4, 4, 32, 8, 4),  # dense (g = 1) ragged chunks
    ([5, 1], 16, 1, 64, 16, 3),  # MQA
    ([4, 1, 2], 14, 2, 64, 16, 3),  # G = 7, not a power of two
]


@pytest.mark.parametrize("case", RAGGED_CASES)
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_ragged_ref_matches_pallas(case, softcap):
    args = _ragged_inputs(*case, seed=40)
    want = np.asarray(jax_ragged(*map(jnp.asarray, args), logit_softcap=softcap,
                                 interpret=True))
    got = tco.ragged_paged_attention_ref(*map(torch.from_numpy, args),
                                         logit_softcap=softcap)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_ragged_ref_zero_context_rows_are_zero():
    """A padded sequence (kv_len = 0) keeps no key: the Pallas kernel's safe
    divisor makes its rows exactly 0, and so does the port."""
    args = _ragged_inputs([3, 1, 1], 4, 2, 32, 8, 4, seed=60, kv_zero=True)
    want = np.asarray(jax_ragged(*map(jnp.asarray, args), interpret=True))
    got = tco.ragged_paged_attention_ref(*map(torch.from_numpy, args)).numpy()
    assert not got[-1].any() and not want[-1].any()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_ragged_ref_decode_matches_pallas_decode_kernel():
    """At Qmax = 1 the ragged function is decode attention: it agrees with
    the reference's decode kernel, query at position len - 1."""
    b, h, hkv, d, page, m, npages = 2, 8, 2, 64, 16, 3, 8
    q = _rand((b, h, d), 50)
    kp, vp = _rand((npages, page, hkv, d), 51), _rand((npages, page, hkv, d), 52)
    tables = np.random.default_rng(53).permutation(npages)[: b * m].reshape(b, m)
    tables = tables.astype(np.int32)
    lens = np.array([37, 12], np.int32)
    dec = np.asarray(jax_paged(*map(jnp.asarray, (q, kp, vp, tables, lens)),
                               interpret=True))
    rag = tco.ragged_paged_attention_ref(
        *map(torch.from_numpy, (q[:, None], kp, vp, tables, (lens - 1)[:, None], lens))
    )
    np.testing.assert_allclose(rag[:, 0].numpy(), dec, atol=ATOL, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_gather_ref_matches_pallas_exactly(dtype):
    """Period-stacked leaf (P, N, page, Hkv, D) with repeated ids (the engine
    pads id lists with the scratch block): each period equals the Pallas
    gather of that period's pool, bit for bit."""
    pool32 = _rand((3, 32, 16, 2, 64), 20)
    ids = np.array([5, 2, 17, 9, 31, 31, 31, 0], np.int32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.stack([
        np.asarray(jax_gather(jnp.asarray(p, jdt), jnp.asarray(ids), interpret=True)
                   .astype(jnp.float32))
        for p in pool32
    ])
    pool = torch.from_numpy(pool32).to(getattr(torch, dtype))
    got = ops.checkpoint_gather(pool, torch.from_numpy(ids))
    assert got.dtype == pool.dtype and got.shape == (3, 8, 16, 2, 64)
    np.testing.assert_array_equal(got.float().numpy(), want)
    out = torch.empty_like(got)
    assert ops.checkpoint_gather(pool, torch.from_numpy(ids), out=out) is out
    assert torch.equal(out, got)


def test_write_ragged_matches_reference_and_drops():
    """The KV scatter, in place, equals the reference's functional scatter,
    negative rows and rows past the pool dropped."""
    n, page = 6, 4
    k0, v0 = _rand((n, page, 2, 8), 1), _rand((n, page, 2, 8), 2)
    kn, vn = _rand((7, 2, 8), 3), _rand((7, 2, 8), 4)
    rows = np.array([0, 3, -1, 5, 6, 2, 3], np.int32)
    offs = np.array([0, 1, 2, 3, 0, 3, 2], np.int32)
    jk, jv = jco.write_ragged(*map(jnp.asarray, (k0, v0, kn, vn, rows, offs)))
    tk, tv = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
    tco.write_ragged(tk, tv, *map(torch.from_numpy, (kn, vn, rows, offs)))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_copy_blocks_and_gather_paged_match_reference():
    pool = _rand((8, 4, 2, 8), 5)
    src, dst = np.array([1, 4, 6], np.int32), np.array([7, 0, 2], np.int32)
    want = np.asarray(jco.copy_blocks(jnp.asarray(pool), jnp.asarray(src), jnp.asarray(dst)))
    got = tco.copy_blocks(torch.from_numpy(pool.copy()), torch.from_numpy(src),
                          torch.from_numpy(dst))
    np.testing.assert_array_equal(got.numpy(), want)
    # the same copy through the period axis of a stacked (P, N, ...) leaf
    stacked = torch.from_numpy(np.stack([pool, pool + 1]))
    tco.copy_blocks(stacked, torch.from_numpy(src), torch.from_numpy(dst), dim=1)
    np.testing.assert_array_equal(stacked[1].numpy(), want + 1)
    tables = np.array([[3, -1, 5], [0, 1, -1]], np.int32)
    want = np.asarray(jco.gather_paged(jnp.asarray(pool), jnp.asarray(tables), 12))
    got = tco.gather_paged(torch.from_numpy(pool), torch.from_numpy(tables), 12)
    np.testing.assert_array_equal(got.numpy(), want)


def test_ops_dispatch_by_device():
    """CPU tensors take the plain versions; the CUDA wrappers refuse them
    (on a CUDA tensor they launch their kernel or raise, never fall back)."""
    args = [torch.from_numpy(a) for a in _ragged_inputs([2, 1], 4, 2, 64, 8, 3, seed=7)]
    want = tco.ragged_paged_attention_ref(*args)
    assert torch.equal(ops.ragged_paged_attention(*args), want)
    dec = [torch.from_numpy(a) for a in _decode_inputs(*DECODE_CASES[1], seed=8)]
    assert torch.equal(ops.paged_attention(*dec, logit_softcap=30.0),
                       tco.paged_attention_ref(*dec, logit_softcap=30.0))
    q, k, v = (torch.from_numpy(_rand(shape, 20 + i)) for i, shape in
               enumerate([(1, 9, 4, 64), (1, 20, 2, 64), (1, 20, 2, 64)]))
    kw = dict(causal=True, sliding_window=5, q_offset=11, logit_softcap=30.0)
    assert torch.equal(ops.flash_attention(q, k, v, **kw), flash_attention_ref(q, k, v, **kw))
    assert ops.launch_counts() == {
        "ragged_paged_attention": 0, "paged_attention": 0, "checkpoint_gather": 0,
        "flash_attention": 0, "ragged_paged_attention_sharded": 0,
        "paged_attention_sharded": 0,
        **{f"{k}_sharded {c}": 0 for k in ("ragged_paged_attention", "paged_attention")
           for c in ops.SHARD_COUNTS}}
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention.ragged_paged_attention(*args)
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention.paged_attention(*dec)
    with pytest.raises(ValueError, match="CUDA"):
        kv_checkpoint.checkpoint_gather(torch.zeros(1, 4, 16, 2, 64),
                                        torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="device"):
        ops.ragged_paged_attention(*[a.to("meta") for a in args])


# ------------------------------------------------------- paged decode kernel
DECODE_CASES = [
    # b, h, hkv, d, page, m, seq_lens (0 = an empty row; multiples of page)
    (4, 2, 2, 128, 16, 4, [37, 0, 32, 64]),  # G = 1 at the Llama head dim
    (3, 14, 2, 64, 16, 3, [16, 5, 0]),  # G = 7 (Qwen2-0.5B's grouping)
    (3, 4, 4, 64, 8, 5, [40, 9, 1]),  # G = 1, D = 64
    (2, 14, 2, 128, 8, 4, [32, 17]),  # G = 7, D = 128
]


def _decode_inputs(b, h, hkv, d, page, m, seq_lens, seed):
    """Decode batch with distinct pages per sequence; table entries past
    each sequence's pages are -1."""
    rng = np.random.default_rng(seed)
    npages = b * m + 1
    q = _rand((b, h, d), seed + 1)
    kp, vp = _rand((npages, page, hkv, d), seed + 2), _rand((npages, page, hkv, d), seed + 3)
    tables = rng.permutation(npages)[: b * m].reshape(b, m).astype(np.int32)
    lens = np.asarray(seq_lens, np.int32)
    tables[np.arange(m)[None, :] >= -(-lens[:, None] // page)] = -1
    return q, kp, vp, tables, lens


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_paged_attention_ref_matches_pallas_and_oracle(case, softcap):
    """The decode kernel's plain version against the Pallas kernel in
    interpret mode (every row, an empty one included: both write 0) and
    against the reference's jnp oracle (rows with seq_len > 0: for an empty
    row the oracle's uniform softmax over masked keys gives the mean of the
    gathered V, where the kernels give 0)."""
    args = _decode_inputs(*case, seed=70)
    lens = args[-1]
    pallas = np.asarray(jax_paged(*map(jnp.asarray, args), logit_softcap=softcap,
                                  interpret=True))
    oracle = np.asarray(jco.paged_attention_ref(*map(jnp.asarray, args),
                                                logit_softcap=softcap))
    got = tco.paged_attention_ref(*map(torch.from_numpy, args), logit_softcap=softcap)
    got = got.numpy()
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=0)
    live = lens > 0
    np.testing.assert_allclose(got[live], oracle[live], atol=ATOL, rtol=0)
    assert not got[~live].any()


def test_paged_attention_ref_masks_a_negative_entry_inside_the_context():
    """A -1 entry below seq_len (the engine never builds one) is masked: the
    row attends to its other pages only, so it equals the same keys laid out
    with the hole at the end."""
    q, kp, vp, tables, _ = _decode_inputs(2, 4, 2, 64, 8, 3, [24, 24], seed=80)
    holed = tables.copy()
    holed[0] = [-1, tables[0, 1], tables[0, 2]]
    packed = tables.copy()
    packed[0] = [tables[0, 1], tables[0, 2], -1]
    a = tco.paged_attention_ref(*map(torch.from_numpy, (q, kp, vp, holed, np.array([24, 24], np.int32))))
    b = tco.paged_attention_ref(*map(torch.from_numpy, (q, kp, vp, packed, np.array([16, 24], np.int32))))
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)


def test_append_paged_matches_reference_and_drops():
    """One token per sequence into its tail block, in place, bit for bit the
    reference's functional scatter: a -1 entry and a position past the table
    width drop the write."""
    n, page, m = 8, 4, 3
    k0, v0 = _rand((n, page, 2, 8), 11), _rand((n, page, 2, 8), 12)
    kn, vn = _rand((5, 2, 8), 13), _rand((5, 2, 8), 14)
    tables = np.array([[0, 1, 2], [3, -1, -1], [4, 5, 6], [7, -1, -1], [2, 2, 2]], np.int32)
    lens = np.array([9, 5, 12, 3, 12], np.int32)  # row 1: -1 entry; rows 2, 4: past the width
    jk, jv = jco.append_paged(*map(jnp.asarray, (k0, v0, kn, vn, tables, lens)))
    tk, tv = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
    tco.append_paged(tk, tv, *map(torch.from_numpy, (kn, vn, tables, lens)))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert not np.array_equal(tk.numpy(), k0)  # rows 0 and 3 landed
    # every write dropped: the pool is unchanged
    tco.append_paged(tk, tv, *map(torch.from_numpy, (kn[1:2], vn[1:2], tables[1:2], lens[1:2])))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


def test_write_paged_chunk_matches_reference_and_drops():
    """A padded prefill chunk per sequence, in place, bit for bit the
    reference: positions on -1 entries or past the table width drop."""
    n, page, m = 10, 4, 3
    k0, v0 = _rand((n, page, 2, 8), 21), _rand((n, page, 2, 8), 22)
    kn, vn = _rand((3, 6, 2, 8), 23), _rand((3, 6, 2, 8), 24)
    tables = np.array([[0, 1, 2], [3, 4, -1], [5, 6, 7]], np.int32)
    offs = np.array([0, 5, 9], np.int32)  # row 1 reaches a -1 entry, row 2 past the width
    positions = (offs[:, None] + np.arange(6)[None, :]).astype(np.int32)
    jk, jv = jco.write_paged_chunk(*map(jnp.asarray, (k0, v0, kn, vn, tables, positions)))
    tk, tv = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
    tco.write_paged_chunk(tk, tv, *map(torch.from_numpy, (kn, vn, tables, positions)))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# ------------------------------------------------------------ flash attention
# The six cases of tests/test_kernels.py (FLASH_CASES), run the same way:
# b, tq, tk, h, hkv, d, causal, window, q_offset, dtype
FLASH_CASES = [
    (2, 64, 64, 4, 2, 64, True, 0, 0, "float32"),
    (1, 96, 224, 4, 4, 32, True, 0, 128, "float32"),  # chunked prefill
    (2, 64, 64, 8, 2, 64, True, 48, 0, "float32"),  # sliding window
    (1, 80, 80, 2, 2, 128, False, 0, 0, "float32"),  # encoder
    (1, 70, 70, 4, 1, 64, True, 0, 0, "float32"),  # MQA + ragged tail
    (1, 64, 64, 4, 2, 64, True, 0, 0, "bfloat16"),
]
# the reference's own kernel-vs-oracle tolerances (tests/test_kernels.py)
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _flash_inputs(b, tq, tk, h, hkv, d, seed):
    return _rand((b, tq, h, d), seed), _rand((b, tk, hkv, d), seed + 1), \
        _rand((b, tk, hkv, d), seed + 2)


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_ref_matches_pallas_and_oracle(case):
    """The port's plain version against the Pallas kernel (interpret mode,
    32-wide blocks as the reference's test runs it) and the jnp oracle."""
    b, tq, tk, h, hkv, d, causal, sw, qo, dname = case
    arrs = _flash_inputs(b, tq, tk, h, hkv, d, 30)
    jq, jk, jv = (jnp.asarray(a).astype(dname) for a in arrs)
    tq_, tk_, tv_ = (torch.from_numpy(a).to(getattr(torch, dname)) for a in arrs)
    kw = dict(causal=causal, sliding_window=sw, q_offset=qo)
    got = flash_attention_ref(tq_, tk_, tv_, **kw)
    assert got.dtype == tq_.dtype and got.shape == (b, tq, h, d)
    got = got.float().numpy()
    pallas = jax_flash(jq, jk, jv, block_q=32, block_k=32, interpret=True, **kw)
    oracle = jref.flash_attention_ref(jq, jk, jv, **kw)
    for want in (pallas, oracle):
        np.testing.assert_allclose(got, np.asarray(want.astype(jnp.float32)),
                                   atol=FLASH_TOL[dname], rtol=0)


# (b, tq, tk, h, hkv, d, causal, window, q_offset): softcap cases against the
# reference's blockwise attention, which has the softcap the Pallas kernel
# lacks (positions: q_offset + t for queries, s for keys)
SOFTCAP_CASES = [
    (2, 40, 72, 4, 2, 64, True, 0, 32),  # chunk behind a cached prefix
    (1, 50, 50, 4, 4, 32, True, 16, 0),  # sliding window
    (1, 24, 40, 2, 1, 64, False, 0, 0),  # non-causal
]


@pytest.mark.parametrize("case", SOFTCAP_CASES)
def test_flash_attention_ref_softcap_matches_blockwise_attention(case):
    b, tq, tk, h, hkv, d, causal, sw, qo = case
    q, k, v = _flash_inputs(b, tq, tk, h, hkv, d, 40)
    qpos = np.broadcast_to(qo + np.arange(tq, dtype=np.int32), (b, tq))
    kpos = np.broadcast_to(np.arange(tk, dtype=np.int32), (b, tk))
    want = jl.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qpos),
        jnp.asarray(kpos), causal=causal, sliding_window=sw, logit_softcap=30.0,
        block_q=16, block_k=32,
    )
    got = flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              causal=causal, sliding_window=sw, q_offset=qo,
                              logit_softcap=30.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_flash_attention_ref_rows_that_keep_no_key_are_zero():
    """A row with no kept key writes 0 (the kernel's safe divisor)."""
    q, k, v = (torch.from_numpy(a) for a in _flash_inputs(1, 8, 64, 4, 2, 64, 50))
    out = flash_attention_ref(q, k, v, causal=False, sliding_window=16, q_offset=100)
    assert torch.equal(out, torch.zeros_like(out))
    # rows at 75..78 keep keys 60..63 of their window; rows at 79..82 none
    out = flash_attention_ref(q, k, v, causal=False, sliding_window=16, q_offset=75)
    assert out[0, :4].abs().amax(dim=(1, 2)).min() > 0
    assert torch.equal(out[0, 4:], torch.zeros_like(out[0, 4:]))


# ------------------------------------------------------- kernel build cache
def test_build_hash_follows_every_header(tmp_path, monkeypatch):
    """A library is named by a hash of its source, of every ``csrc/*.cuh``
    and of the flags: editing a shared header, or adding one, moves every
    library, so no stale build is loaded; editing one source moves only its
    own.  Needs no nvcc: only the names are computed."""
    from repro_torch.kernels import build

    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)

    def paths():
        return {name: build._lib_path(name) for name in build.SOURCES}

    before = paths()
    assert all(p.parent == build.BUILD_DIR for p in before.values())
    header = csrc / "attention_tile.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    edited = paths()
    assert all(edited[n] != before[n] for n in build.SOURCES)
    source = csrc / "checkpoint_gather.cu"
    source.write_bytes(source.read_bytes() + b"\n")
    again = paths()
    assert again["checkpoint_gather"] != edited["checkpoint_gather"]
    assert all(again[n] == edited[n] for n in build.SOURCES if n != "checkpoint_gather")
    (csrc / "another.cuh").write_text("#pragma once\n")
    assert all(p != again[n] for n, p in paths().items())


# ------------------------------------- the tensor-core kernels' arithmetic
def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHIP_SMOKE = _chip_smoke()
# what chip_smoke.py holds the bf16 kernels to on the card
BF16_TOL = CHIP_SMOKE.TOL["bfloat16"]


def _tensor_core_partials(q, k, v, keep, softcap=0.0, tile=64):
    """Test-only emulation of the bf16 tensor-core kernels' arithmetic
    (csrc/attention_tile.cuh) before the division: bf16 q, k, v; fp32
    scores with the scale, softcap and mask; an online softmax over tiles
    of 64 keys with fp32 max and sum; the probabilities rounded to bf16
    before P V; fp32 sums.  q (B, Tq, H, D), k and v (B, Tk, Hkv, D), keep
    (B, Tq, Tk).  Returns the unnormalised O (B, Hkv, G, Tq, D), the row
    max m and the row sum l (B, Hkv, G, Tq); a row that keeps no key has
    m = -inf and l = 0."""
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, tq, hkv, h // hkv, d)
    kf, vf = k.float(), v.float()
    m = torch.full((b, hkv, h // hkv, tq), float("-inf"))
    l = torch.zeros_like(m)
    o = torch.zeros((b, hkv, h // hkv, tq, d))
    for k0 in range(0, tk, tile):
        s = torch.einsum("bthgd,bshd->bhgts", qg, kf[:, k0:k0 + tile]) * d**-0.5
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        s = s.masked_fill(~keep[:, None, None, :, k0:k0 + tile], float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        mu = torch.where(m_new == float("-inf"), torch.zeros_like(m_new), m_new)
        alpha = torch.exp(m - mu)
        p = torch.exp(s - mu[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + torch.einsum(
            "bhgts,bshd->bhgtd", p.bfloat16().float(), vf[:, k0:k0 + tile])
        m = m_new
    return o, m, l


def _tensor_core_attention(q, k, v, keep, softcap=0.0, tile=64):
    """The tensor-core kernels' output: O / l with a safe l (a row that
    keeps no key is 0), rounded to bf16, as (B, Tq, H, D)."""
    b, tq, h, d = q.shape
    o, _m, l = _tensor_core_partials(q, k, v, keep, softcap, tile)
    out = torch.where(l[..., None] > 0, o / l.clamp(min=1e-30)[..., None], 0.0)
    return out.permute(0, 3, 1, 2, 4).reshape(b, tq, h, d).bfloat16()


def _bf16(shape, seed):
    return torch.from_numpy(_rand(shape, seed)).bfloat16()


# keys per K/V tile of the bf16 flash kernel (WgTile::kN)
WG_KEYS = 64


def _row_tiles(tq, group, d):
    """The bf16 flash kernel's row tiles of one (batch, KV head): for row
    tile x and row r the (query position, head of the group) pair it serves,
    or None for a spare row, as the kernel maps them: ceil(tq / positions)
    tiles, r -> (x * positions + r // group, r % group) with the wrapper's
    ``block_positions``."""
    pos = flash_attention.block_positions(group, d)
    return [[(x * pos + r // group, r % group)
             if r < pos * group and x * pos + r // group < tq else None
             for r in range(flash_attention.block_rows(d))]
            for x in range(-(-tq // pos))]


def _wgmma_attention(q, k, v, causal, window, q_offset, softcap=0.0):
    """Test-only emulation of the bf16 flash kernel (csrc/flash_attention.cu,
    flash_wg_kernel) as it walks its blocks: the wrapper's row tiles of
    (position, head of the group) pairs, warpgroups of 64 of those rows,
    each over its own live K/V tiles of WG_KEYS keys (K/V zero past Tk),
    masks only on a tile some row of the warpgroup keeps in part, the
    online softmax with fp32 max and sum, P rounded to bf16 before P V,
    fp32 sums, O / l with a safe l, rounded to bf16.  Spare rows hold zero
    q and are not stored.  q (B, Tq, H, D), k and v (B, Tk, Hkv, D) bf16.
    Returns (B, Tq, H, D) bf16."""
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    group, kn = h // hkv, WG_KEYS
    pos = flash_attention.block_positions(group, d)
    pad = -(-max(tk, 1) // kn) * kn - tk
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad))
    qf = q.float().reshape(b, tq, hkv, group, d)
    out = torch.zeros((b, tq, hkv, group, d))

    def lo_of(p):
        return max(0, q_offset + p - window + 1) if window else 0

    def hi_of(p):
        return min(tk, q_offset + p + 1) if causal else tk

    for x, pairs in enumerate(_row_tiles(tq, group, d)):
        q0, npos = x * pos, min(pos, tq - x * pos)
        k_lo, k_hi = lo_of(q0), hi_of(q0 + npos - 1)
        t_lo = k_lo // kn
        t_hi = -(-k_hi // kn) if k_hi > k_lo else t_lo
        for w0 in range(0, len(pairs), 64):
            rows = [pr for pr in pairs[w0:w0 + 64] if pr is not None]
            if not rows:
                continue
            ta = min(t_hi, max(t_lo, lo_of(rows[0][0]) // kn))
            tb = max(ta, min(t_hi, -(-hi_of(rows[-1][0]) // kn)))
            lo_max, hi_min = lo_of(rows[-1][0]), hi_of(rows[0][0])
            ts, gs = (torch.tensor(x) for x in zip(*rows))
            qw = qf[:, ts, :, gs].permute(1, 2, 0, 3)  # (B, Hkv, R, D)
            lo = torch.tensor([lo_of(t) for t, _ in rows])[:, None]
            hi = torch.tensor([hi_of(t) for t, _ in rows])[:, None]
            m = torch.full(qw.shape[:3], float("-inf"))
            l = torch.zeros(qw.shape[:3])
            o = torch.zeros(qw.shape)
            for t in range(ta, tb):
                k0 = t * kn
                s = torch.einsum("bhrd,bshd->bhrs", qw, kf[:, k0:k0 + kn]) * d**-0.5
                if softcap:
                    s = torch.tanh(s / softcap) * softcap
                if k0 < lo_max or k0 + kn > hi_min:
                    key = torch.arange(k0, k0 + kn)[None, :]
                    s = s.masked_fill((key < lo) | (key >= hi), float("-inf"))
                m_new = torch.maximum(m, s.amax(-1))
                mu = torch.where(m_new == float("-inf"), torch.zeros_like(m_new), m_new)
                alpha = torch.exp(m - mu)
                p = torch.exp(s - mu[..., None])
                l = l * alpha + p.sum(-1)
                o = o * alpha[..., None] + torch.einsum(
                    "bhrs,bshd->bhrd", p.bfloat16().float(), vf[:, k0:k0 + kn])
                m = m_new
            res = torch.where(l[..., None] > 0, o / l.clamp(min=1e-30)[..., None], 0.0)
            out[:, ts, :, gs] = res.permute(2, 0, 1, 3)
    return out.reshape(b, tq, h, d).bfloat16()


@pytest.mark.parametrize("case", CHIP_SMOKE.FLASH_CASES, ids=lambda c: c[0])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_tensor_core_rounding_stays_inside_bf16_tol_flash(case, softcap):
    """The bf16 flash kernel's arithmetic and tile walk (_wgmma_attention)
    against its plain version on chip_smoke.py's phase-2 flash cases, at
    narrow heads: inside the bf16 tolerance the card holds it to."""
    _, b, tq, tk, causal, window, q_offset = case
    h, hkv, d = 4, 2, 64
    q, k, v = _bf16((b, tq, h, d), 70), _bf16((b, tk, hkv, d), 71), _bf16((b, tk, hkv, d), 72)
    got = _wgmma_attention(q, k, v, causal, window, q_offset, softcap)
    want = flash_attention_ref(q, k, v, causal=causal, sliding_window=window,
                               q_offset=q_offset, logit_softcap=softcap)
    print(f"max_abs_err={(got.float() - want.float()).abs().max().item():.3e}")
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)


@pytest.mark.parametrize("case", CHIP_SMOKE.FLASH_CASES, ids=lambda c: c[0])
def test_tensor_core_rounding_stays_inside_bf16_tol_flash_d256(case):
    """As above at gemma-7b's head dim of 256 (fewer heads), where the
    scores' scale is 1/16, each row's P V sums 256 columns and a block has
    one consumer warpgroup of 64 rows."""
    _, b, tq, tk, causal, window, q_offset = case
    h, hkv, d = 2, 2, 256
    q, k, v = _bf16((b, tq, h, d), 73), _bf16((b, tk, hkv, d), 74), _bf16((b, tk, hkv, d), 75)
    got = _wgmma_attention(q, k, v, causal, window, q_offset)
    want = flash_attention_ref(q, k, v, causal=causal, sliding_window=window,
                               q_offset=q_offset)
    print(f"max_abs_err={(got.float() - want.float()).abs().max().item():.3e}")
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)


@pytest.mark.parametrize("case", CHIP_SMOKE.FLASH_CASES + CHIP_SMOKE.CROSS_CASES,
                         ids=lambda c: c[0])
def test_tensor_core_rounding_stays_inside_bf16_tol_flash_d80(case):
    """As above at hubert-xlarge's head dim of 80 (5 16-deep steps, scale
    80**-0.5), causal and non-causal, and at the VLM's cross-attention
    calls: non-causal over 576 keys, a decode batch of 12 single queries and
    a 32-query chunk."""
    _, b, tq, tk, causal, window, q_offset = case
    h, hkv, d = 2, 2, 80
    q, k, v = _bf16((b, tq, h, d), 76), _bf16((b, tk, hkv, d), 77), _bf16((b, tk, hkv, d), 78)
    got = _wgmma_attention(q, k, v, causal, window, q_offset)
    want = flash_attention_ref(q, k, v, causal=causal, sliding_window=window,
                               q_offset=q_offset)
    print(f"max_abs_err={(got.float() - want.float()).abs().max().item():.3e}")
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)


@pytest.mark.parametrize("group", [1, 4, 6, 12])
@pytest.mark.parametrize("case", CHIP_SMOKE.FLASH_CASES + CHIP_SMOKE.CROSS_CASES,
                         ids=lambda c: c[0])
def test_tensor_core_rounding_stays_inside_bf16_tol_flash_group_packed(case, group):
    """The bf16 flash kernel with a KV head's G query heads packed into one
    block's rows (G = 4: the VLM's cross decode; 6: mixtral; 12:
    command-r-plus, where 128 / G leaves spare rows), one KV head, at
    narrow heads: inside the bf16 tolerance."""
    _, b, tq, tk, causal, window, q_offset = case
    h, hkv, d = group, 1, 64
    q, k, v = _bf16((b, tq, h, d), 79), _bf16((b, tk, hkv, d), 80), _bf16((b, tk, hkv, d), 81)
    got = _wgmma_attention(q, k, v, causal, window, q_offset)
    want = flash_attention_ref(q, k, v, causal=causal, sliding_window=window,
                               q_offset=q_offset)
    print(f"max_abs_err={(got.float() - want.float()).abs().max().item():.3e}")
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)


@pytest.mark.parametrize("d", [64, 80, 128, 256])
@pytest.mark.parametrize("group", [1, 4, 6, 7, 12, 64])
def test_flash_block_positions_pack_whole_groups(group, d):
    """The wrapper's row plan for the bf16 kernel: a block has two
    warpgroups of 64 rows (one at D = 256) and takes as many whole query
    positions of a KV head's group of G heads as fit, leaving fewer than G
    rows spare."""
    rows = flash_attention.block_rows(d)
    assert rows == (64 if d == 256 else 128)
    pos = flash_attention.block_positions(group, d)
    assert pos * group <= rows < (pos + 1) * group


@pytest.mark.parametrize("group, d", [(0, 128), (129, 128), (65, 256)])
def test_flash_block_positions_refuse_a_group_past_the_rows(group, d):
    """A group of no head, or of more query heads than a block has rows,
    is refused with a ValueError: the kernel would serve no position."""
    with pytest.raises(ValueError, match="does not fit"):
        flash_attention.block_positions(group, d)


def test_flash_wrapper_refuses_other_head_dims():
    """The kernel is built for D = 64, 80, 128 and 256; any other D (96
    here) is refused with a ValueError before anything else is looked at,
    never sent to the plain version.  D = 80 passes that check and stops at
    the device (no card here)."""
    assert flash_attention.HEAD_DIMS == (64, 80, 128, 256)
    q = torch.zeros((1, 4, 2, 96), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 96 not in"):
        flash_attention.flash_attention(q, q, q)
    q = torch.zeros((1, 4, 2, 80), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention(q, q, q, causal=False)


def _attention_case_cpu(h, hkv, d, seed, q_lens=(32, 1, 9, 1, 1, 0),
                        kv_lens=(32 + 131, 50, 9, 300, 1, 0), qmax=32, page=16):
    """chip_smoke.attention_case's ragged batch, built on the CPU from
    numpy: chunks at the tail of each context, padded slots at q_pos = 0,
    -1 table entries past each sequence's pages."""
    rng = np.random.default_rng(seed)
    s = len(q_lens)
    m = max(-(-kv // page) for kv in kv_lens) + 2
    n = s * m + 1
    q = _bf16((s, qmax, h, d), seed + 1)
    kp, vp = _bf16((n, page, hkv, d), seed + 2), _bf16((n, page, hkv, d), seed + 3)
    tables = rng.permutation(n - 1)[: s * m].reshape(s, m).astype(np.int32)
    q_pos = np.zeros((s, qmax), np.int32)
    for i, (ql, kv) in enumerate(zip(q_lens, kv_lens)):
        tables[i, -(-kv // page):] = -1
        q_pos[i, :ql] = np.arange(kv - ql, kv)
    return (q, kp, vp, torch.from_numpy(tables), torch.from_numpy(q_pos),
            torch.tensor(kv_lens, dtype=torch.int32))


@pytest.mark.parametrize("case", sorted(CHIP_SMOKE.RAGGED_CASES))
@pytest.mark.parametrize("shape", [(4, 4, 128), (14, 2, 64), (2, 2, 256)],
                         ids=["G1", "G7", "D256"])
def test_tensor_core_rounding_stays_inside_bf16_tol_ragged(case, shape):
    """The ragged kernel's bf16 arithmetic against its plain version on
    chip_smoke.py's phase-2 ragged batches (rounds of 64 keys over the
    sequence's gathered pages), at the Llama-2-7B (G = 1, D = 128, fewer
    heads), Qwen2-0.5B (G = 7, D = 64) and gemma-7b (G = 1, D = 256, fewer
    heads) groupings."""
    h, hkv, d = shape
    q, kp, vp, tables, q_pos, kv_lens = _attention_case_cpu(
        h, hkv, d, 80, **CHIP_SMOKE.RAGGED_CASES[case])
    max_ctx = tables.shape[1] * kp.shape[1]
    k, v = (tco.gather_paged(p, tables, max_ctx) for p in (kp, vp))
    t = torch.arange(max_ctx)
    keep = (t[None, None] <= q_pos[..., None]) & (t[None, None] < kv_lens[:, None, None])
    got = _tensor_core_attention(q, k, v, keep)
    want = tco.ragged_paged_attention_ref(q, kp, vp, tables, q_pos, kv_lens)
    print(f"max_abs_err={(got.float() - want.float()).abs().max().item():.3e}")
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
    assert torch.equal(got[-1], torch.zeros_like(got[-1]))


# ------------------------------------------------ the bf16 decode kernel
def _decode_case_cpu(h, hkv, d, seed, seq_lens=(163, 50, 16, 300, 1, 0, 64, 33),
                     hole=(6, 0), page=16):
    """chip_smoke.decode_case's decode batch, built on the CPU from numpy:
    -1 table entries past each sequence's pages, and one inside a context
    at ``hole`` (row, page)."""
    rng = np.random.default_rng(seed)
    b = len(seq_lens)
    m = max(-(-n // page) for n in seq_lens) + 2
    n = b * m + 1
    q = _bf16((b, h, d), seed + 1)
    kp, vp = _bf16((n, page, hkv, d), seed + 2), _bf16((n, page, hkv, d), seed + 3)
    tables = rng.permutation(n - 1)[: b * m].reshape(b, m).astype(np.int32)
    for i, sl in enumerate(seq_lens):
        tables[i, -(-sl // page):] = -1
    if hole is not None:
        tables[hole] = -1
    return q, kp, vp, torch.from_numpy(tables), torch.tensor(seq_lens, dtype=torch.int32)


def _tensor_core_decode(q, kp, vp, tables, seq_lens, splits, split_keys, softcap=0.0):
    """Test-only emulation of the bf16 decode kernel (csrc/paged_attention.cu):
    per key split, paged_tc_kernel's tensor-core arithmetic over the split's
    keys (fp32 partials O, m, l), then merge_kernel's log-sum-exp merge: the
    splits with l > 0 weighted by exp(m - M), M their largest m; a row with
    no such split is 0.  Returns the bf16 output (B, H, D) and l per split
    (splits, B, Hkv, G)."""
    b, h, d = q.shape
    page = kp.shape[1]
    max_ctx = tables.shape[1] * page
    k, v = (tco.gather_paged(p, tables, max_ctx) for p in (kp, vp))
    t = torch.arange(max_ctx)
    keep = (t[None] < seq_lens[:, None]) & (tables.repeat_interleave(page, dim=1) >= 0)
    parts = [_tensor_core_partials(q[:, None], k[:, lo:lo + split_keys],
                                   v[:, lo:lo + split_keys],
                                   keep[:, None, lo:lo + split_keys], softcap)
             for lo in range(0, splits * split_keys, split_keys)]
    ms = torch.stack([m for _o, m, _l in parts])
    ls = torch.stack([l for _o, _m, l in parts])
    top = ms.masked_fill(ls == 0, float("-inf")).amax(0)
    top = torch.where(top == float("-inf"), torch.zeros_like(top), top)
    w = torch.where(ls > 0, torch.exp(ms - top), torch.zeros_like(ms))
    o = sum(wi[..., None] * oi for wi, (oi, _m, _l) in zip(w, parts))
    l = (w * ls).sum(0)
    out = torch.where(l[..., None] > 0, o / l.clamp(min=1e-30)[..., None], 0.0)
    return out.reshape(b, h, d).bfloat16(), ls[..., 0]


# the H100's SM count, which the host's split choice reads on the card
H100_SMS = 132


@pytest.mark.parametrize("case", sorted(CHIP_SMOKE.DECODE_CASES))
@pytest.mark.parametrize("shape", [(2, 2, 128), (14, 2, 64), (2, 2, 256)],
                         ids=["G1", "G7", "D256"])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_tensor_core_rounding_stays_inside_bf16_tol_decode(case, shape, softcap):
    """The bf16 decode kernel's arithmetic, split by the host's choice for
    these shapes, against its plain version on chip_smoke.py's phase-2
    decode batches, at the Llama-2-7B (G = 1, D = 128, fewer heads),
    Qwen2-0.5B (G = 7, D = 64) and gemma-7b (G = 1, D = 256, fewer heads)
    groupings: inside the bf16 tolerance the card holds it to, and
    seq_len = 0 rows exactly 0."""
    h, hkv, d = shape
    q, kp, vp, tables, lens = _decode_case_cpu(h, hkv, d, 90, **CHIP_SMOKE.DECODE_CASES[case])
    splits, keys = paged_attention.decode_splits(q.shape[0], hkv, tables.shape[1] * kp.shape[1],
                                                 H100_SMS)
    got, _ = _tensor_core_decode(q, kp, vp, tables, lens, splits, keys, softcap)
    want = tco.paged_attention_ref(q, kp, vp, tables, lens, logit_softcap=softcap)
    print(f"splits={splits} of {keys} keys, "
          f"max_abs_err={(got.float() - want.float()).abs().max().item():.3e}")
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
    assert torch.equal(got[lens == 0], torch.zeros_like(got[lens == 0]))


def test_tensor_core_decode_empty_splits_take_no_part():
    """chip_smoke's long contexts at 4 splits of 320 keys: the splits at or
    past a row's seq_len have l = 0 and the merge skips them, so the row
    equals the merge of its other splits alone; the seq_len = 0 row has
    l = 0 in every split and comes out exactly 0."""
    kw = CHIP_SMOKE.DECODE_CASES["long contexts"]
    q, kp, vp, tables, lens = _decode_case_cpu(14, 2, 64, 91, **kw)
    splits, keys = paged_attention.decode_splits(3, 2, tables.shape[1] * kp.shape[1], H100_SMS)
    assert (splits, keys) == (4, 320) and lens.tolist() == [384, 1000, 0]
    got, ls = _tensor_core_decode(q, kp, vp, tables, lens, splits, keys)
    assert (ls[2:, 0] == 0).all() and (ls[:2, 0] > 0).all()  # row 0 keeps keys 0..383
    assert (ls[:, 2] == 0).all() and torch.equal(got[2], torch.zeros_like(got[2]))
    alone, _ = _tensor_core_decode(q[:1], kp, vp, tables[:1], lens[:1], 2, keys)
    assert torch.equal(got[0], alone[0])


@pytest.mark.parametrize("batch,kv_heads,max_keys,sms", [
    (8, 32, 256, 132),  # the split serve's heaviest call at Llama-2-7B: one split
    (16, 32, 4000, 132),  # 2-4 k contexts at Llama-2-7B: 512 pairs fill the card
    (16, 2, 4000, 132),  # 2-4 k contexts at Qwen2-0.5B: 32 pairs
    (3, 32, 1040, 132), (3, 2, 1040, 132), (4, 2, 768, 132),  # phase 2's long cases
    (1, 1, 100_000, 132), (1, 1, 64, 132), (1, 1, 1, 132), (5, 3, 1000, 7), (2, 8, 792, 132),
])
def test_decode_splits_cover_every_key_once(batch, kv_heads, max_keys, sms):
    """The host's split choice, a function of shapes alone: whole rounds of
    64 keys, at least 256 keys a split where it splits, one split where the
    (sequence, KV head) pairs fill 2 blocks per SM, and every key of the
    table in exactly one split."""
    n, keys = paged_attention.decode_splits(batch, kv_heads, max_keys, sms)
    assert keys % paged_attention.SPLIT_ROUND == 0 and keys >= 64
    assert 1 <= n <= paged_attention.MAX_SPLITS
    covered = np.zeros(max_keys, np.int64)
    for i in range(n):
        covered[i * keys:(i + 1) * keys] += 1
    assert (covered == 1).all() and (n - 1) * keys < max_keys <= n * keys
    if n > 1:
        assert keys >= paged_attention.MIN_SPLIT_KEYS
        assert batch * kv_heads * (n - 1) < 2 * sms
    if batch * kv_heads >= 2 * sms:
        assert n == 1


def test_decode_cases_split_at_both_shapes():
    """chip_smoke.py's phase-2 long contexts run several splits on the card
    at both model shapes, the serving batch one."""
    def splits(hkv, seq_lens, page=16, **_):
        m = max(-(-n // page) for n in seq_lens) + 2
        return paged_attention.decode_splits(len(seq_lens), hkv, m * page, H100_SMS)[0]

    long = CHIP_SMOKE.DECODE_CASES["long contexts"]
    assert (splits(32, **long), splits(2, **long)) == (3, 4)
    assert splits(32, **CHIP_SMOKE.DECODE_CASES["page 24"]) == 3
    assert splits(2, seq_lens=(163, 50, 16, 300, 1, 0, 64, 33)) == 1


def test_decode_cases_split_at_the_new_shapes():
    """Phase 2's long contexts split at gemma-7b's 16 KV heads (D = 256) and
    at yi-34b's and command-r-plus-104b's 8, as at the Llama shape."""
    long = CHIP_SMOKE.DECODE_CASES["long contexts"]
    m = max(-(-n // 16) for n in long["seq_lens"]) + 2
    for arch in ("gemma-7b", "yi-34b", "command-r-plus-104b"):
        _h, hkv, _d = CHIP_SMOKE.ATTN_SHAPES[arch]
        n, _keys = paged_attention.decode_splits(len(long["seq_lens"]), hkv, m * 16, H100_SMS)
        assert n == 4, (arch, n)


def test_table_width_limit_follows_the_sources_smem_export(monkeypatch):
    """The wrappers' page and table-width limits come from each source's
    ``<name>_smem_bytes`` export (emulated here by the bf16 ragged kernel's
    and the fp32 decode kernel's formulas at D = 256): the widest table
    whose block fits 232,448 bytes, none where the page alone does not fit,
    no limit where the block does not hold the table."""
    import types

    def ragged_bytes(dtype, d, rows, page, m):  # tc_smem_bytes<256>, 4 row groups
        return (4 * 64 + 16 * 4) * (d + 8) * 2 + (m + 4) * 4

    def decode_bytes(dtype, d, g, page, m):  # smem_bytes<float, 256>: 2 stages
        return 2 * 2 * page * (d + 4) * 4 + (g * d + g * page + 3 * g) * 4

    lib = types.SimpleNamespace(ragged_paged_attention_smem_bytes=ragged_bytes,
                                paged_attention_smem_bytes=decode_bytes)
    monkeypatch.setattr(paged_attention.build, "load", lambda name: lib)
    paged_attention._table_limit.cache_clear()
    try:
        assert paged_attention._table_limit("ragged_paged_attention", 1, 256, 64, 16) == (
            (232448 - ragged_bytes(1, 256, 64, 16, 0)) // 4) == 15868
        paged_attention._check_smem("ragged_paged_attention", 1, 256, 64, 16, 15868)
        with pytest.raises(ValueError, match="at most 15868 entries"):
            paged_attention._check_smem("ragged_paged_attention", 1, 256, 64, 16, 15869)
        paged_attention._check_smem("paged_attention", 0, 256, 16, 32, 10**6)
        with pytest.raises(ValueError, match="at most 0 entries"):
            paged_attention._check_smem("paged_attention", 0, 256, 16, 64, 1)
    finally:
        paged_attention._table_limit.cache_clear()


# ------------------------------------ the bf16 ragged kernel (ragged_wg_kernel)
def _ragged_plan(q, kp, tables):
    """The host's plan for the bf16 ragged kernel on the H100, from shapes:
    (slots per row tile, row tiles, splits, keys per split)."""
    s, qmax, h, d = q.shape
    hkv = kp.shape[2]
    pos, tiles = paged_attention.ragged_row_tiles(h // hkv, qmax)
    n, keys = paged_attention.ragged_splits(s, hkv, tiles, tables.shape[1] * kp.shape[1],
                                            H100_SMS * paged_attention.ragged_pipes(d))
    return pos, tiles, n, keys


def _wgmma_ragged(q, kp, vp, tables, q_pos, kv_lens, softcap=0.0, splits=None):
    """Test-only emulation of the bf16 ragged kernel
    (csrc/ragged_paged_attention.cu, ragged_wg_kernel, then merge_kernel) as
    it walks its jobs: per (sequence, row tile, split), for every KV head at
    once, the row tile's 64 rows of (slot, head of the group) pairs, P slots
    of G heads; the split's 64-key tiles up to min(kv_len, the tile's
    largest q_pos + 1), each key read from the page its table entry names
    (page 0 for a -1 entry or one past the table); masks only on a tile that
    some real row keeps in part; the online softmax with fp32 max and sum, P
    rounded to bf16 before P V, fp32 sums.  Unsplit, O / l with a safe l;
    split, the partials (O, m, l) merged by their log-sum-exp, splits with
    l = 0 skipped.  ``splits`` = (n, keys) overrides the host's choice.
    Returns the bf16 output (S, Qmax, H, D) and l per split (n, S, Qmax, H),
    0 where a row keeps none of the split's keys."""
    s, qmax, h, d = q.shape
    page, hkv = kp.shape[1], kp.shape[2]
    group, m, kn = h // hkv, tables.shape[1], WG_KEYS
    pos, tiles, n, keys = _ragged_plan(q, kp, tables)
    if splits is not None:
        n, keys = splits
    qf = q.float().reshape(s, qmax, hkv, group, d)
    kf, vf = kp.float(), vp.float()
    o_part = torch.zeros((n, s, qmax, hkv, group, d))
    m_part = torch.full((n, s, qmax, hkv, group), float("-inf"))
    l_part = torch.zeros((n, s, qmax, hkv, group))
    for b in range(s):
        kv_len = min(int(kv_lens[b]), m * page)
        for x in range(tiles):
            slots = range(x * pos, min(qmax, (x + 1) * pos))
            rows = [(j, g) for j in slots for g in range(group)]
            qp = q_pos[b, list(slots)].long()
            kv_end = min(kv_len, int(qp.max()) + 1)
            hi_min = min(kv_len, int(qp.min()) + 1)
            js, gs = (torch.tensor(v) for v in zip(*rows))
            hi = torch.clamp(q_pos[b, js].long() + 1, max=kv_len)[:, None]
            qw = qf[b, js, :, gs].permute(1, 0, 2)  # (Hkv, R, D)
            for sp in range(n):
                k_beg = sp * keys
                k_end = min(kv_end, k_beg + keys)
                if k_end <= k_beg:
                    continue
                mm = torch.full(qw.shape[:2], float("-inf"))
                ll = torch.zeros(qw.shape[:2])
                oo = torch.zeros(qw.shape)
                for t in range(k_beg // kn, -(-k_end // kn)):
                    key = torch.arange(t * kn, (t + 1) * kn)
                    pi = key // page
                    blk = torch.where(pi < m, tables[b, pi.clamp(max=m - 1)], 0).clamp(min=0)
                    kt = kf[blk, key % page].permute(1, 0, 2)  # (Hkv, 64, D)
                    vt = vf[blk, key % page].permute(1, 0, 2)
                    sc = torch.einsum("hrd,hkd->hrk", qw, kt) * d**-0.5
                    if softcap:
                        sc = torch.tanh(sc / softcap) * softcap
                    if (t + 1) * kn > hi_min:  # an edge tile: some real row keeps part
                        sc = sc.masked_fill(key[None, None, :] >= hi[None], float("-inf"))
                    m_new = torch.maximum(mm, sc.amax(-1))
                    mu = torch.where(m_new == float("-inf"), torch.zeros_like(m_new), m_new)
                    alpha = torch.exp(mm - mu)
                    p = torch.exp(sc - mu[..., None])
                    ll = ll * alpha + p.sum(-1)
                    oo = oo * alpha[..., None] + torch.einsum(
                        "hrk,hkd->hrd", p.bfloat16().float(), vt)
                    mm = m_new
                o_part[sp, b, js, :, gs] = oo.permute(1, 0, 2)
                m_part[sp, b, js, :, gs] = mm.permute(1, 0)
                l_part[sp, b, js, :, gs] = ll.permute(1, 0)
    if n == 1:
        o, l = o_part[0], l_part[0]
    else:  # merge_kernel
        top = m_part.masked_fill(l_part == 0, float("-inf")).amax(0)
        top = torch.where(top == float("-inf"), torch.zeros_like(top), top)
        w = torch.where(l_part > 0, torch.exp(m_part - top), torch.zeros_like(m_part))
        o = (w[..., None] * o_part).sum(0)
        l = (w * l_part).sum(0)
    out = torch.where(l[..., None] > 0, o / l.clamp(min=1e-30)[..., None], 0.0)
    return out.reshape(s, qmax, h, d).bfloat16(), l_part.reshape(n, s, qmax, h)


@pytest.mark.parametrize("case", sorted(CHIP_SMOKE.RAGGED_CASES))
@pytest.mark.parametrize("shape", [(4, 4, 128), (14, 2, 64), (2, 2, 256)],
                         ids=["G1", "G7", "D256"])
def test_wgmma_ragged_stays_inside_bf16_tol(case, shape):
    """The bf16 ragged kernel's arithmetic and job walk, split by the host's
    choice for these shapes, against its plain version on chip_smoke.py's
    phase-2 ragged batches at the Llama-2-7B (G = 1, D = 128, fewer heads),
    Qwen2-0.5B (G = 7, D = 64: 9 slots a row tile) and gemma-7b (G = 1,
    D = 256, fewer heads) groupings: inside the bf16 tolerance the card
    holds it to, and the padded sequence's rows exactly 0."""
    h, hkv, d = shape
    q, kp, vp, tables, q_pos, kv_lens = _attention_case_cpu(
        h, hkv, d, 81, **CHIP_SMOKE.RAGGED_CASES[case])
    got, _ = _wgmma_ragged(q, kp, vp, tables, q_pos, kv_lens)
    want = tco.ragged_paged_attention_ref(q, kp, vp, tables, q_pos, kv_lens)
    print(f"plan={_ragged_plan(q, kp, tables)} "
          f"max_abs_err={(got.float() - want.float()).abs().max().item():.3e}")
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
    assert torch.equal(got[-1], torch.zeros_like(got[-1]))


@pytest.mark.parametrize("case", sorted(CHIP_SMOKE.RAGGED_PAGE_CASES))
@pytest.mark.parametrize("shape", [(4, 4, 128), (14, 2, 64), (2, 2, 256)],
                         ids=["G1", "G7", "D256"])
def test_wgmma_ragged_pages_stay_inside_bf16_tol(case, shape):
    """The same on chip_smoke.py's bf16 batches at pages of 8, 24, 64 and
    256 tokens (64-key tiles that take 8, 3 or 1 page, or a quarter of
    one), two of them split by the host's choice."""
    h, hkv, d = shape
    q, kp, vp, tables, q_pos, kv_lens = _attention_case_cpu(
        h, hkv, d, 84, **CHIP_SMOKE.RAGGED_PAGE_CASES[case])
    assert kp.shape[1] == CHIP_SMOKE.RAGGED_PAGE_CASES[case]["page"]
    got, _ = _wgmma_ragged(q, kp, vp, tables, q_pos, kv_lens)
    want = tco.ragged_paged_attention_ref(q, kp, vp, tables, q_pos, kv_lens)
    plan = _ragged_plan(q, kp, tables)
    print(f"plan={plan} max_abs_err={(got.float() - want.float()).abs().max().item():.3e}")
    assert (plan[2] > 1) == ("split" in case)
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
    assert torch.equal(got[-1], torch.zeros_like(got[-1]))


@pytest.mark.parametrize("page,takes", [(8, True), (16, True), (24, True), (32, True),
                                        (64, True), (128, True), (256, True), (4, False),
                                        (12, False), (20, False)])
def test_ragged_wrapper_refuses_pages_its_boxes_cannot_tile(page, takes):
    """The bf16 ragged kernel reads K/V in boxes of gcd(page, 64) rows, which
    the 8-row swizzle group needs at least 8 of: its wrapper refuses a bf16
    page that is not a multiple of 8 with a ValueError before it looks at
    the device, and passes every other page on to the device check (these
    tensors lie on the CPU); fp32 takes any page."""
    q, kp, vp, tables, q_pos, kv_lens = _attention_case_cpu(
        4, 4, 64, 85, q_lens=(3, 0), kv_lens=(40, 0), qmax=3, page=page)
    with pytest.raises(ValueError, match="CUDA" if takes else "multiple of 8"):
        paged_attention.ragged_paged_attention(q, kp, vp, tables, q_pos, kv_lens)
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention.ragged_paged_attention(q.float(), kp.float(), vp.float(), tables,
                                               q_pos, kv_lens)


@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_wgmma_ragged_qwen_long_decode_splits(softcap):
    """chip_smoke's 2-4 k decode batch at Qwen2-0.5B's shape (14 / 2 heads of
    64, G = 7), cut as the card cuts it: 16 sequences x 2 KV heads are 32
    jobs for 264 pipelines, so 8 splits of 512 keys, each sequence's later
    splits past its kv_len keep no key; against the plain version at the
    bf16 tolerance."""
    kw = dict(CHIP_SMOKE.LONG_CASES["decode"])
    kw["kv_lens"] = kw["kv_lens"][::4]  # 4 of the 16 lengths keep the test short
    kw["q_lens"] = kw["q_lens"][::4]
    q, kp, vp, tables, q_pos, kv_lens = _attention_case_cpu(14, 2, 64, 82, **kw)
    plan = _ragged_plan(q, kp, tables)
    full = paged_attention.ragged_splits(16, 2, 1, 250 * 16, H100_SMS * 2)
    assert full == (8, 512) and plan[2] > 1
    got, ls = _wgmma_ragged(q, kp, vp, tables, q_pos, kv_lens, softcap, splits=full)
    want = tco.ragged_paged_attention_ref(q, kp, vp, tables, q_pos, kv_lens,
                                          logit_softcap=softcap)
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
    for b, kv in enumerate(kv_lens.tolist()):  # splits at or past kv_len keep nothing
        assert (ls[-(-kv // 512):, b] == 0).all() and (ls[:-(-kv // 512), b, 0] > 0).all()


def test_wgmma_ragged_splits_that_keep_no_key_take_no_part():
    """chip_smoke's 'splits that keep no key' batch at the Llama shape cut
    into 4 splits of 320 keys: a sequence of 40 keys keeps none of splits
    1-3 (l = 0, so the merge skips them and its rows equal its unsplit
    output), the padded sequence keeps none of any and comes out exactly
    0, and the 1000-key sequence keeps keys of all four."""
    kw = CHIP_SMOKE.RAGGED_CASES["splits that keep no key"]
    q, kp, vp, tables, q_pos, kv_lens = _attention_case_cpu(4, 4, 128, 83, **kw)
    assert kv_lens.tolist() == [1000, 40, 0] and tables.shape[1] * 16 == 1040
    got, ls = _wgmma_ragged(q, kp, vp, tables, q_pos, kv_lens, splits=(4, 320))
    assert (ls[:, 0] > 0).all() and (ls[0, 1] > 0).all() and (ls[1:, 1] == 0).all()
    assert (ls[:, 2] == 0).all() and torch.equal(got[2], torch.zeros_like(got[2]))
    alone, _ = _wgmma_ragged(q, kp, vp, tables, q_pos, kv_lens, splits=(1, 1088))
    assert torch.equal(got[1], alone[1])
    want = tco.ragged_paged_attention_ref(q, kp, vp, tables, q_pos, kv_lens)
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)


@pytest.mark.parametrize("seqs,kv_heads,row_tiles,max_keys,slots", [
    (8, 32, 1, 256, 264),  # the fused serve's heaviest call at Llama-2-7B: one split
    (16, 32, 1, 4000, 264),  # 2-4 k contexts at Llama-2-7B: 512 jobs fill the card
    (16, 16, 1, 4000, 132),  # ... at gemma-7b's D = 256, one pipeline a block
    (16, 2, 1, 4000, 264),  # 2-4 k decodes at Qwen2-0.5B: 32 jobs, 8 splits
    (4, 2, 3, 1040, 264), (3, 32, 1, 1040, 264), (4, 8, 4, 1040, 264),  # phase 2's splits
    (1, 1, 1, 100_000, 264), (1, 1, 1, 64, 264), (1, 1, 1, 1, 264), (5, 3, 2, 1000, 7),
])
def test_ragged_splits_cover_every_key_once(seqs, kv_heads, row_tiles, max_keys, slots):
    """The host's split choice for the bf16 ragged kernel, a function of
    shapes alone (its arguments are the call's shapes and the card's
    pipelines): whole tiles of 64 keys, at least 256 keys a split where it
    splits, no more jobs than the card's pipelines take in one round, and
    every key of the table in exactly one split."""
    n, keys = paged_attention.ragged_splits(seqs, kv_heads, row_tiles, max_keys, slots)
    assert keys % 64 == 0 and keys >= 64
    assert 1 <= n <= paged_attention.MAX_SPLITS
    covered = np.zeros(max_keys, np.int64)
    for i in range(n):
        covered[i * keys:(i + 1) * keys] += 1
    assert (covered == 1).all() and (n - 1) * keys < max_keys <= n * keys
    if n > 1:
        assert keys >= paged_attention.MIN_SPLIT_KEYS
        assert seqs * kv_heads * row_tiles * n <= slots
    if seqs * kv_heads * row_tiles * 2 > slots:
        assert n == 1


@pytest.mark.parametrize("group,qmax,want", [
    (1, 1, (64, 1)), (1, 32, (64, 1)), (1, 65, (64, 2)), (7, 1, (9, 1)), (7, 20, (9, 3)),
    (12, 20, (5, 4)), (64, 3, (1, 3)),
])
def test_ragged_row_tiles_pack_whole_groups(group, qmax, want):
    """A row tile of the bf16 ragged kernel holds 64 // G whole query slots
    of G heads (the q box's slots x heads), enough tiles to cover Qmax; a
    group past 64 heads is refused."""
    assert paged_attention.ragged_row_tiles(group, qmax) == want
    with pytest.raises(ValueError, match="does not fit"):
        paged_attention.ragged_row_tiles(65, qmax)
