"""The port's layers and model against the JAX package's, on the CPU.

Both packages compute with the same weights (the reference's
``init_params(cfg, PRNGKey(0))`` carried over by ``repro_torch.bridge``)
and the same numpy inputs, at fp32, on ``.reduced()`` Llama-2-7B (MHA) and
Qwen2-0.5B (GQA, qkv bias, tied embeddings).
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import sampling as js  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as get_config_t  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import sampling as ts  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

ARCHS = ["llama-2-7b", "qwen2-0.5b"]
# fp32 on both sides; XLA and PyTorch's CPU matmuls sum in other orders.
# Layer outputs are O(1): measured differences are a few 1e-7; logits after
# the whole reduced stack a few 1e-6.
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=5e-5, rtol=1e-5)


@functools.lru_cache(maxsize=None)
def _model(arch):
    cfg = get_config(arch).reduced()
    params = jtf.init_params(cfg, jax.random.PRNGKey(0))
    tparams = bridge.to_torch(jax.tree.map(np.asarray, params))
    return cfg, get_config_t(arch).reduced(), params, tparams


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_init_params_and_bridge_keep_the_reference_layout():
    """The port's own init has the reference's tree, shapes and stacking; the
    bridge carries the reference weights over exactly and back."""
    for arch in ARCHS:
        cfg, cfgt, params, tparams = _model(arch)
        own = ttf.init_params(cfgt, torch.Generator().manual_seed(0))
        want = jax.tree_util.tree_map_with_path(
            lambda p, a: (jax.tree_util.keystr(p), a.shape), params
        )
        got = {}

        def walk(tree, path=""):
            for k, v in tree.items():
                if isinstance(v, dict):
                    walk(v, f"{path}['{k}']")
                else:
                    got[f"{path}['{k}']"] = tuple(v.shape)

        walk(own)
        assert got == dict(jax.tree_util.tree_leaves(want, is_leaf=lambda x: isinstance(x, tuple)))
        back = bridge.to_numpy(tparams)
        jax.tree.map(np.testing.assert_array_equal, jax.tree.map(np.asarray, params), back)


def test_rmsnorm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    w = rng.standard_normal((64,)).astype(np.float32)
    np.testing.assert_allclose(
        tl.rmsnorm(_t(x), _t(w)).numpy(), np.asarray(jl.rmsnorm(x, w)), **LAYER_TOL
    )
    q = rng.standard_normal((2, 5, 4, 64)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 5)).astype(np.int32)
    for theta in (10000.0, 1000000.0):
        np.testing.assert_allclose(
            tl.apply_rope(_t(q), _t(pos), theta).numpy(),
            np.asarray(jl.apply_rope(q, pos, theta)), atol=1e-4, rtol=1e-5,
        )  # angles up to 4000 rad: cos/sin of fp32 arguments differ by ~1e-5


def _ragged_batch(cfg, items, n_blocks, bs, seed):
    """One fused batch as the engine lays it out: (q_len, ctx, table) per
    sequence, pow2-padded T / S / Qmax, padded tokens to the scratch row."""
    from repro_torch.core.budget import pow2_bucket

    scratch = n_blocks - 1
    t = pow2_bucket(sum(q for q, _, _ in items))
    s, qmax = pow2_bucket(len(items)), pow2_bucket(max(q for q, _, _ in items))
    width = len(items[0][2])
    a = dict(
        tokens=np.random.default_rng(seed).integers(0, cfg.vocab_size, t).astype(np.int32),
        positions=np.zeros(t, np.int32), dst_row=np.full(t, scratch, np.int32),
        dst_off=np.zeros(t, np.int32), tables=np.full((s, width), scratch, np.int32),
        qpad=np.full((s, qmax), t - 1, np.int32), q_pos=np.zeros((s, qmax), np.int32),
        kv_lens=np.zeros(s, np.int32), unpad_seq=np.full(t, s - 1, np.int32),
        unpad_j=np.zeros(t, np.int32), logit_idx=np.full(s, t - 1, np.int32),
    )
    st = 0
    for i, (ql, ctx, table) in enumerate(items):
        pos = ctx + np.arange(ql)
        sl = slice(st, st + ql)
        a["positions"][sl], a["tables"][i] = pos, table
        a["dst_row"][sl], a["dst_off"][sl] = table[pos // bs], pos % bs
        a["qpad"][i, :ql], a["q_pos"][i, :ql] = st + np.arange(ql), pos
        a["kv_lens"][i], a["unpad_seq"][sl] = ctx + ql, i
        a["unpad_j"][sl], a["logit_idx"][i] = np.arange(ql), st + ql - 1
        st += ql
    return a


FIELDS = ("dst_row", "dst_off", "qpad", "q_pos", "kv_lens", "unpad_seq", "unpad_j")
# a prefill chunk at ctx 0, a chunk continuing at ctx 16, two decodes
ITEMS = [(5, 0, np.array([0, 9, 9, 9], np.int32)),
         (3, 16, np.array([1, 2, 9, 9], np.int32)),
         (1, 20, np.array([3, 4, 9, 9], np.int32)),
         (1, 40, np.array([5, 6, 7, 9], np.int32))]


def _pools(cfg, n, bs, seed):
    pools = jtf.init_paged_pools(cfg, n, bs)
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), pools)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_ragged_attention_matches_reference(arch):
    cfg, cfgt, params, tparams = _model(arch)
    n, bs = 10, 16
    a = _ragged_batch(cfg, ITEMS, n, bs, seed=3)
    pool = jax.tree.map(lambda x: x[0], _pools(cfg, n, bs, 4)["0"])
    x = np.random.default_rng(5).standard_normal((1, len(a["tokens"]), cfg.d_model))
    x = x.astype(np.float32)
    lp = jax.tree.map(lambda p: p[0], params["layers"]["0"]["mixer"])
    meta = jl.RaggedMeta(*(jnp.asarray(a[f]) for f in FIELDS))
    want, wpool = jl.paged_ragged_attention(
        cfg, lp, jnp.asarray(x), jax.tree.map(jnp.asarray, pool),
        jnp.asarray(a["tables"]), jnp.asarray(a["positions"][None]), meta,
    )
    tpool = bridge.to_torch(pool)
    got, gpool = tl.paged_ragged_attention(
        cfgt, jax.tree.map(lambda p: p[0], tparams["layers"]["0"]["mixer"]), _t(x), tpool,
        _t(a["tables"]), _t(a["positions"][None]), tl.RaggedMeta(*(_t(a[f]) for f in FIELDS)),
    )
    # padded tokens' output rows read garbage on both sides: compare real ones
    real = sum(q for q, _, _ in ITEMS)
    np.testing.assert_allclose(got.numpy()[:, :real], np.asarray(want)[:, :real], **LAYER_TOL)
    for kv in ("k", "v"):  # all rows but the scratch one (padded tokens)
        np.testing.assert_allclose(gpool[kv].numpy()[:-1], np.asarray(wpool[kv])[:-1],
                                   **LAYER_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_run_tokens_paged_logits_and_pools_match_reference(arch):
    cfg, cfgt, params, tparams = _model(arch)
    n, bs = 10, 16
    a = _ragged_batch(cfg, ITEMS, n, bs, seed=6)
    pools = _pools(cfg, n, bs, 7)
    meta = jl.RaggedMeta(*(jnp.asarray(a[f]) for f in FIELDS))
    want, wpools = jtf.run_tokens_paged(
        cfg, params, jnp.asarray(a["tokens"]), jax.tree.map(jnp.asarray, pools),
        jnp.asarray(a["tables"]), jnp.asarray(a["positions"]), meta,
        jnp.asarray(a["logit_idx"]),
    )
    tpools = bridge.to_torch(pools)
    got, gpools = ttf.run_tokens_paged(
        cfgt, tparams, _t(a["tokens"]), tpools, _t(a["tables"]), _t(a["positions"]),
        tl.RaggedMeta(*(_t(a[f]) for f in FIELDS)), _t(a["logit_idx"]),
    )
    assert gpools is tpools  # updated in place
    assert got.dtype == torch.float32
    s = len(ITEMS)
    np.testing.assert_allclose(got.numpy()[:s], np.asarray(want)[:s], **MODEL_TOL)
    for pos in wpools:
        for kv in ("k", "v"):
            np.testing.assert_allclose(gpools[pos][kv].numpy()[:, :-1],
                                       np.asarray(wpools[pos][kv])[:, :-1], **MODEL_TOL)
    # the segmented form gives the same pools and activations
    tpools2 = bridge.to_torch(pools)
    x = ttf.embed(cfgt, tparams, _t(a["tokens"])[None])
    meta_t = tl.RaggedMeta(*(_t(a[f]) for f in FIELDS))
    for lo, pps in ttf.segment_spans(cfgt):
        x, _ = ttf.run_tokens_paged_at(cfgt, tparams, pps, lo, x, tpools2, _t(a["tables"]),
                                       _t(a["positions"][None]), meta_t)
    seg = ttf.ragged_lm_head(cfgt, tparams, x, _t(a["logit_idx"]))
    assert torch.equal(seg, got)
    assert ttf.segment_spans(cfgt) == jtf.segment_spans(cfg)


def test_greedy_sampling_matches_reference():
    logits = np.random.default_rng(8).standard_normal((6, 50)).astype(np.float32)
    logits[2, [3, 7]] = 9.0  # a tie: both take the first maximum
    rows = np.array([4, 2, 2, 0], np.int32)
    want = np.asarray(js.sample_rows(jnp.asarray(logits), jnp.asarray(rows),
                                     js.SamplingParams(), jax.random.PRNGKey(0)))
    got = ts.sample_rows(_t(logits), _t(rows), ts.SamplingParams())
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_stochastic_sampling_distribution():
    """Temperature / top-k draws come from a torch.Generator, so they are
    held to the distribution the reference samples from, not to its bits."""
    logits = torch.tensor([[2.0, 1.0, 0.5, -1.0, 0.0]]).repeat(20000, 1)
    params = ts.SamplingParams(temperature=0.7, top_k=3)
    draws = ts.sample(logits, params, torch.Generator().manual_seed(0)).numpy()
    want = np.exp(np.array([2.0, 1.0, 0.5]) / 0.7)
    want /= want.sum()
    freq = np.bincount(draws, minlength=5) / len(draws)
    assert freq[3] == 0 and freq[4] == 0  # outside the top 3
    np.testing.assert_allclose(freq[:3], want, atol=0.015)  # ~4 sigma at n=20000


# --------------------------------------------------- split per-family paths
N_BLOCKS, BS = 10, 16  # pool rows; the last is the scratch row
SCRATCH = N_BLOCKS - 1
# A padded prefill wave as the engine builds it: (offset, real length, table)
# per row, chunks padded to L = 16.  Row 2 is a padded batch row (all scratch);
# row 3 runs to the end of its table, so its padded positions fall past the
# width and drop.
PREFILL_ROWS = [(0, 5, [0, 1, SCRATCH, SCRATCH]), (16, 3, [2, 3, SCRATCH, SCRATCH]),
                (0, 1, [SCRATCH] * 4), (56, 8, [4, 5, 6, 7])]
# decode rows: (seq_len before the token, table); the last is a padded row
DECODE_ROWS = [(20, [0, 1, SCRATCH, SCRATCH]), (47, [2, 3, 4, SCRATCH]),
               (63, [5, 6, 7, 8]), (0, [SCRATCH] * 4)]


def _prefill_batch(vocab, seed):
    toks = np.random.default_rng(seed).integers(0, vocab, (len(PREFILL_ROWS), 16))
    offs = np.array([o for o, _, _ in PREFILL_ROWS], np.int32)
    last = np.array([n - 1 for _, n, _ in PREFILL_ROWS], np.int32)
    tables = np.array([t for _, _, t in PREFILL_ROWS], np.int32)
    return toks.astype(np.int32), tables, offs, last


def _decode_batch(vocab, seed):
    last = np.random.default_rng(seed).integers(0, vocab, len(DECODE_ROWS)).astype(np.int32)
    tables = np.array([t for _, t in DECODE_ROWS], np.int32)
    lens = np.array([n for n, _ in DECODE_ROWS], np.int32)
    return last, tables, lens


def _assert_pools_close(gpools, wpools, tol):
    """Every pool row but the scratch one, which padded rows write in any
    order on both sides."""
    for pos in wpools:
        for kv in ("k", "v"):
            np.testing.assert_allclose(gpools[pos][kv].numpy()[:, :SCRATCH],
                                       np.asarray(wpools[pos][kv])[:, :SCRATCH], **tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_prefill_and_decode_attention_match_reference(arch):
    """The split path's two attention layers: outputs of the real rows and
    the pools after their scatters (drops included)."""
    cfg, cfgt, params, tparams = _model(arch)
    lp = jax.tree.map(lambda p: p[0], params["layers"]["0"]["mixer"])
    tlp = jax.tree.map(lambda p: p[0], tparams["layers"]["0"]["mixer"])
    pool = jax.tree.map(lambda x: x[0], _pools(cfg, N_BLOCKS, BS, 9)["0"])
    rng = np.random.default_rng(10)
    _, tables, offs, _ = _prefill_batch(cfg.vocab_size, 11)
    positions = (offs[:, None] + np.arange(16)[None, :]).astype(np.int32)
    x = rng.standard_normal((len(PREFILL_ROWS), 16, cfg.d_model)).astype(np.float32)
    want, wpool = jl.paged_prefill_attention(
        cfg, lp, jnp.asarray(x), jax.tree.map(jnp.asarray, pool), jnp.asarray(tables),
        jnp.asarray(positions))
    tpool = bridge.to_torch(pool)
    got, gpool = tl.paged_prefill_attention(cfgt, tlp, _t(x), tpool, _t(tables), _t(positions))
    assert gpool is tpool
    for i, (_, n, _) in enumerate(PREFILL_ROWS):
        if i != 2:  # the padded row reads the scratch row
            np.testing.assert_allclose(got.numpy()[i, :n], np.asarray(want)[i, :n], **LAYER_TOL)
    _assert_pools_close({"0": gpool}, {"0": wpool}, LAYER_TOL)

    _, tables, lens = _decode_batch(cfg.vocab_size, 12)
    x = rng.standard_normal((len(DECODE_ROWS), 1, cfg.d_model)).astype(np.float32)
    want, wpool = jl.paged_decode_attention(
        cfg, lp, jnp.asarray(x), wpool, jnp.asarray(tables), jnp.asarray(lens[:, None]))
    got, gpool = tl.paged_decode_attention(cfgt, tlp, _t(x), gpool, _t(tables), _t(lens[:, None]))
    np.testing.assert_allclose(got.numpy()[:3], np.asarray(want)[:3], **LAYER_TOL)
    _assert_pools_close({"0": gpool}, {"0": wpool}, LAYER_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_split_entry_points_match_reference(arch):
    """``prefill_chunk_paged`` (padded chunks, ``last_index``), then
    ``decode_step_paged`` and its segmented form ``run_segment_paged_at``
    on the pools it left: logits of the real rows and the pools."""
    cfg, cfgt, params, tparams = _model(arch)
    pools = _pools(cfg, N_BLOCKS, BS, 13)
    toks, tables, offs, last = _prefill_batch(cfg.vocab_size, 14)
    want, wpools = jtf.prefill_chunk_paged(
        cfg, params, jnp.asarray(toks), jax.tree.map(jnp.asarray, pools),
        jnp.asarray(tables), jnp.asarray(offs), last_index=jnp.asarray(last))
    tpools = bridge.to_torch(pools)
    got, gpools = ttf.prefill_chunk_paged(cfgt, tparams, _t(toks), tpools, _t(tables),
                                          _t(offs), _t(last))
    assert gpools is tpools and got.dtype == torch.float32
    real = [0, 1, 3]
    np.testing.assert_allclose(got.numpy()[real], np.asarray(want)[real], **MODEL_TOL)
    _assert_pools_close(gpools, wpools, MODEL_TOL)

    dlast, dtables, lens = _decode_batch(cfg.vocab_size, 15)
    seg_pools, wseg = bridge.to_torch(bridge.to_numpy(gpools)), wpools
    want, wpools = jtf.decode_step_paged(cfg, params, jnp.asarray(dlast), wpools,
                                         jnp.asarray(dtables), jnp.asarray(lens))
    got, gpools = ttf.decode_step_paged(cfgt, tparams, _t(dlast), gpools, _t(dtables), _t(lens))
    np.testing.assert_allclose(got.numpy()[:3], np.asarray(want)[:3], **MODEL_TOL)
    _assert_pools_close(gpools, wpools, MODEL_TOL)

    # the segmented decode, segment by segment on both sides
    wx = jtf.embed(cfg, params, jnp.asarray(dlast)[:, None])
    x = ttf.embed(cfgt, tparams, _t(dlast)[:, None])
    assert ttf.segment_spans(cfgt) == jtf.segment_spans(cfg)
    for lo, pps in ttf.segment_spans(cfgt):
        wx, wseg = jtf.run_segment_paged_at(cfg, params, pps, jnp.int32(lo), wx, wseg,
                                            jnp.asarray(dtables), jnp.asarray(lens[:, None]))
        x, _ = ttf.run_segment_paged_at(cfgt, tparams, pps, lo, x, seg_pools, _t(dtables),
                                        _t(lens)[:, None])
        np.testing.assert_allclose(x.numpy()[:3], np.asarray(wx)[:3], **MODEL_TOL)
    _assert_pools_close(seg_pools, wseg, MODEL_TOL)
    # addressed by segment index, the same segments give the same result
    x2 = ttf.embed(cfgt, tparams, _t(dlast)[:, None])
    for seg in range(ttf.num_segments(cfgt)):
        x2, _ = ttf.run_segment_paged(cfgt, tparams, seg, x2, seg_pools, _t(dtables),
                                      _t(lens)[:, None])
    assert torch.equal(x2, x)
    np.testing.assert_allclose(ttf.lm_head(cfgt, tparams, x)[:3, 0].numpy(),
                               np.asarray(want)[:3], **MODEL_TOL)
    with pytest.raises(ValueError, match="mode"):
        ttf.run_periods(cfgt, tparams["layers"], 0, 1, x, seg_pools, _t(dtables),
                        _t(lens)[:, None], mode="full")


# ------------------------- contiguous caches (Queue 1: the contiguous fallback)
def _filled_cache(cfg, b, cap, fill, seed):
    """A reference cache whose slots 0..fill[i]-1 of row i hold random K/V at
    positions 0..fill[i]-1 (a full cache filled chunk by chunk), the rest
    empty (-1)."""
    hd = cfg.resolved_head_dim
    c = jax.tree.map(np.asarray, jl.KVCache.init(b, cap, cfg.num_kv_heads, hd, jnp.float32))
    rng = np.random.default_rng(seed)
    c = {k: np.array(v) for k, v in c.items()}
    for i, n in enumerate(fill):
        c["k"][i, :n] = rng.standard_normal((n, cfg.num_kv_heads, hd))
        c["v"][i, :n] = rng.standard_normal((n, cfg.num_kv_heads, hd))
        c["pos"][i, :n] = np.arange(n)
    return c


def _assert_cache(got, want, tol=None):
    """``pos`` exactly; K/V exactly, or within ``tol`` when they come out of
    projections computed by both frameworks."""
    np.testing.assert_array_equal(got["pos"].numpy(), np.asarray(want["pos"]))
    for kv in ("k", "v"):
        if tol is None:
            np.testing.assert_array_equal(got[kv].numpy(), np.asarray(want[kv]))
        else:
            np.testing.assert_allclose(got[kv].numpy(), np.asarray(want[kv]), **tol)


def test_write_kv_matches_reference_exactly():
    """Full-cache and ring slots, with and without the padding mask."""
    cfg = get_config("llama-2-7b").reduced()
    rng = np.random.default_rng(20)
    cache = _filled_cache(cfg, 2, 16, [3, 9], 21)
    shape = (2, 5, cfg.num_kv_heads, cfg.resolved_head_dim)
    k, v = rng.standard_normal(shape).astype(np.float32), rng.standard_normal(shape).astype(np.float32)
    pos = np.array([[3, 4, 5, 6, 7], [20, 21, 22, 23, 24]], np.int32)  # row 1 wraps
    valid = np.array([[1, 1, 0, 1, 1], [1, 0, 1, 1, 0]], bool)
    for vm in (None, valid):
        want = jl.write_kv(jax.tree.map(jnp.asarray, cache), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(pos), None if vm is None else jnp.asarray(vm))
        tc = bridge.to_torch(cache)
        got = tl.write_kv(tc, _t(k), _t(v), _t(pos), None if vm is None else _t(vm))
        assert got is tc
        _assert_cache(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_cached_attention_matches_reference(arch):
    """Prefill chunks through the flash attention (its plain version here)
    and through the masked ``attend_cache``, shared and per-row offsets, a
    padded row, then a decode step: outputs and caches."""
    cfg, cfgt, params, tparams = _model(arch)
    lp = jax.tree.map(lambda p: p[0], params["layers"]["0"]["mixer"])
    tlp = jax.tree.map(lambda p: p[0], tparams["layers"]["0"]["mixer"])
    rng = np.random.default_rng(22)
    length = 16
    for offs, lens in (([24, 24], None), ([24, 10], [16, 9])):
        cache = _filled_cache(cfg, 2, 64, offs, 23)
        x = rng.standard_normal((2, length, cfg.d_model)).astype(np.float32)
        pos = (np.asarray(offs)[:, None] + np.arange(length)).astype(np.int32)
        valid = None if lens is None else np.arange(length)[None, :] < np.asarray(lens)[:, None]
        want, wcache = jl.cached_attention(
            cfg, lp, jnp.asarray(x), jax.tree.map(jnp.asarray, cache), jnp.asarray(pos),
            None if valid is None else jnp.asarray(valid))
        real = np.ones_like(pos, bool) if valid is None else valid
        for q_offsets in (offs, None):  # flash form, then the masked form
            got, gcache = tl.cached_attention(
                cfgt, tlp, _t(x), bridge.to_torch(cache), _t(pos),
                None if valid is None else _t(valid), q_offsets)
            np.testing.assert_allclose(got.numpy()[real], np.asarray(want)[real], **LAYER_TOL)
            _assert_cache(gcache, wcache, LAYER_TOL)
        # the flash form's precondition: slots 0 .. off + L - 1 hold positions
        # 0 .. off + L - 1 (the padded row's tail is never read by a real row)
        for i, o in enumerate(offs):
            n = o + (length if lens is None else lens[i])
            np.testing.assert_array_equal(gcache["pos"].numpy()[i, :n], np.arange(n))
    xd = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    dpos = np.array([[offs[0] + length], [offs[1] + 3]], np.int32)
    want, wcache = jl.cached_attention(cfg, lp, jnp.asarray(xd), wcache, jnp.asarray(dpos))
    got, gcache = tl.cached_attention(cfgt, tlp, _t(xd), gcache, _t(dpos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    _assert_cache(gcache, wcache, LAYER_TOL)
    # attend_cache alone, with a sliding window and holes in the cache
    wcfg = dataclasses.replace(cfg, sliding_window=8)
    wcfgt = dataclasses.replace(cfgt, sliding_window=8)
    holed = _filled_cache(cfg, 2, 32, [20, 12], 24)
    holed["pos"][0, 5] = -1
    q = rng.standard_normal((2, 3, cfg.num_heads, cfg.resolved_head_dim)).astype(np.float32)
    qp = np.array([[17, 18, 19], [9, 10, 11]], np.int32)
    want = jl.attend_cache(wcfg, jnp.asarray(q), jax.tree.map(jnp.asarray, holed), jnp.asarray(qp))
    got = tl.attend_cache(wcfgt, _t(q), bridge.to_torch(holed), _t(qp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


def _assert_caches(got, want, tol):
    for pos in want:
        _assert_cache({kv: got[pos][kv] for kv in ("k", "v", "pos")}, want[pos], tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_contiguous_entry_points_match_reference(arch):
    """``forward_full`` with emitted caches, ``prefill_chunk`` chunk by chunk
    (and a padded chunk), ``decode_step`` and ``run_segment``, against the
    JAX model: logits and caches."""
    cfg, cfgt, params, tparams = _model(arch)
    toks = np.random.default_rng(25).integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    want, wfull, _ = jtf.forward_full(cfg, params, jnp.asarray(toks), emit_caches=True,
                                      max_seq=64)
    got, gfull, aux = ttf.forward_full(cfgt, tparams, _t(toks), emit_caches=True, max_seq=64)
    assert got.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    _assert_caches(gfull, wfull, MODEL_TOL)

    wc = jtf.init_caches(cfg, 2, 64)
    gc = ttf.init_caches(cfgt, 2, 64)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), b.numpy()), wc, gc)
    for lo, hi in ((0, 16), (16, 40)):
        want, wc = jtf.prefill_chunk(cfg, params, jnp.asarray(toks[:, lo:hi]), wc,
                                     jnp.asarray([lo, lo], jnp.int32))
        got, gc = ttf.prefill_chunk(cfgt, tparams, _t(toks[:, lo:hi]), gc, [lo, lo])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
        for c in gc.values():
            assert torch.equal(c["pos"][:, :, :hi], torch.arange(hi, dtype=torch.int32).expand(
                c["pos"].shape[0], 2, hi))
    _assert_caches(gc, wc, MODEL_TOL)
    # chunked prefill ends where the whole-sequence forward does
    np.testing.assert_allclose(got.numpy(), ttf.forward_full(cfgt, tparams, _t(toks))[0][:, -1]
                               .numpy(), **MODEL_TOL)

    last = toks[:, -1]
    lens = np.array([40, 40], np.int32)
    seg_caches = bridge.to_torch(bridge.to_numpy(gc))
    want, wc2 = jtf.decode_step(cfg, params, jnp.asarray(last), wc, jnp.asarray(lens))
    got, gc = ttf.decode_step(cfgt, tparams, _t(last), gc, _t(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    _assert_caches(gc, wc2, MODEL_TOL)
    # the same decode, segment by segment, on both sides
    wx = jtf.embed(cfg, params, jnp.asarray(last)[:, None])
    x = ttf.embed(cfgt, tparams, _t(last)[:, None])
    for seg in range(ttf.num_segments(cfgt)):
        wx, wc = jtf.run_segment(cfg, params, seg, wx, wc, mode="decode",
                                 positions=jnp.asarray(lens[:, None]))
        x, out = ttf.run_segment(cfgt, tparams, seg, x, seg_caches, mode="decode",
                                 positions=_t(lens)[:, None])
        assert out is seg_caches
        np.testing.assert_allclose(x.numpy(), np.asarray(wx), **MODEL_TOL)
    _assert_caches(seg_caches, wc, MODEL_TOL)
    assert torch.equal(ttf.lm_head(cfgt, tparams, x)[:, 0], got)

    # a padded chunk: row 1 has 5 real tokens of 8
    wp = jtf.init_caches(cfg, 2, 64)
    gp = ttf.init_caches(cfgt, 2, 64)
    n = np.array([8, 5], np.int32)
    want, wp = jtf.prefill_chunk(cfg, params, jnp.asarray(toks[:, :8]), wp,
                                 jnp.asarray([0, 0], jnp.int32), lengths=jnp.asarray(n))
    got, gp = ttf.prefill_chunk(cfgt, tparams, _t(toks[:, :8]), gp, [0, 0], lengths=_t(n))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    _assert_caches(gp, wp, MODEL_TOL)


def test_forward_full_beyond_the_blockwise_threshold_matches_reference():
    """T = 1100 > 1024: the reference switches to its blockwise attention;
    the port runs the same flash attention at every length."""
    cfg, cfgt, params, tparams = _model("llama-2-7b")
    assert 1100 > jl.BLOCKWISE_THRESHOLD
    toks = np.random.default_rng(26).integers(0, cfg.vocab_size, (1, 1100)).astype(np.int32)
    want, wc, _ = jtf.forward_full(cfg, params, jnp.asarray(toks), emit_caches=True)
    got, gc, _ = ttf.forward_full(cfgt, tparams, _t(toks), emit_caches=True)
    np.testing.assert_allclose(got.numpy()[:, -64:], np.asarray(want)[:, -64:], **MODEL_TOL)
    # keys roped at angles up to 1100 rad: fp32 cos/sin differ by ~1e-5 per
    # unit of magnitude between the frameworks (as in the RoPE test above)
    _assert_caches(gc, wc, dict(atol=2e-4, rtol=1e-5))
