"""The port's tensor-parallel layout and sharded attention against the JAX
package's, on the CPU (DESIGN.md §11).

* The layout rule (``distributed.sharding.pool_pspec``) equals the
  reference's on an abstract ("data", "model") mesh.
* The sharded plain versions (per-shard plain calls, gathered) equal the
  unsharded plain versions at tp 1, 2 and 4 on the ``.reduced()`` Llama and
  Qwen2 attention shapes, the replicated fallback included.
* The reference's own sharded kernels run in one subprocess on a real
  2-device JAX mesh (virtual CPU devices, Pallas in interpret mode); the
  port's tp = 2 plain versions must match them.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.distributed.sharding import pool_pspec as ref_pool_pspec  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.kernels import ops, paged_attention  # noqa: E402
from repro_torch.kvcache import cache_ops  # noqa: E402
from repro_torch.launch.mesh import make_serving_mesh  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# fp32; a shard computes its heads exactly as the unsharded call does, only
# its einsums batch fewer heads (MKL may block them otherwise)
ATOL = 1e-6
# the reference's Pallas kernels in interpret mode against the port's plain
# versions: sums in another order (tests/test_torch_kernels.py's bound)
REF_ATOL = 2e-5


def cpu_mesh(tp):
    return make_serving_mesh(tp, devices=["cpu"] * tp)


@pytest.mark.parametrize("hkv", [1, 2, 4, 32])
@pytest.mark.parametrize("tp", [1, 2, 3, 4])
def test_pool_layout_rule_matches_reference(hkv, tp):
    shape = (3, 9, 16, hkv, 64)
    ref = jax.sharding.AbstractMesh((1, tp), ("data", "model"))
    mesh = cpu_mesh(tp)
    assert sharding.pool_pspec(shape, mesh) == tuple(ref_pool_pspec(shape, ref))
    pool = sharding.zeros(shape, torch.float32, mesh)
    sharded = sharding.pool_pspec(shape, mesh)[3] == "model"
    assert pool.sharded == sharded and pool.shape == torch.Size(shape)
    assert [p.shape[3] for p in pool.parts] == [hkv // tp if sharded else hkv] * tp
    # replicas of shards on one device are one tensor: one write each
    assert pool.writers() == (list(range(tp)) if sharded else [0])


def _inputs(arch, seed):
    """A mixed ragged batch at the arch's reduced attention shape: chunks
    and decodes at the tail of their contexts, a padded sequence with
    kv_len 0, -1 table entries past each context."""
    cfg = get_config(arch).reduced()
    h, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    rng = np.random.default_rng(seed)
    q_lens, kv = np.array([5, 1, 3, 1]), np.array([37, 20, 3, 0], np.int32)
    s, qmax, page, m = len(q_lens), 5, 8, 6
    n = s * m + 1
    q = rng.standard_normal((s, qmax, h, d)).astype(np.float32)
    kp = rng.standard_normal((n, page, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((n, page, hkv, d)).astype(np.float32)
    tables = rng.permutation(n - 1)[: s * m].reshape(s, m).astype(np.int32)
    tables[np.arange(m)[None, :] >= -(-kv[:, None] // page)] = -1
    j = np.arange(qmax)[None, :]
    q_pos = np.maximum(kv[:, None] - q_lens[:, None] + np.minimum(j, q_lens[:, None] - 1),
                       0).astype(np.int32)
    return q, kp, vp, tables, q_pos, kv


def _sharded(fn, q, kp, vp, rest, mesh, cap):
    return fn(q, sharding.place(kp, mesh), sharding.place(vp, mesh), *rest, mesh,
              logit_softcap=cap)


@pytest.mark.parametrize("arch", ["llama-2-7b", "qwen2-0.5b"])
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_sharded_plain_versions_match_unsharded(arch, tp):
    q, kp, vp, tb, qp, kv = map(torch.from_numpy, _inputs(arch, seed=3))
    mesh = cpu_mesh(tp)
    hkv = kp.shape[2]
    for cap in (0.0, 30.0):
        want = cache_ops.ragged_paged_attention_ref(q, kp, vp, tb, qp, kv, logit_softcap=cap)
        got = _sharded(ops.ragged_paged_attention_sharded, q, kp, vp, (tb, qp, kv), mesh, cap)
        torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
        qd = q[:, 0].contiguous()
        want = cache_ops.paged_attention_ref(qd, kp, vp, tb, kv, logit_softcap=cap)
        got = _sharded(ops.paged_attention_sharded, qd, kp, vp, (tb, kv), mesh, cap)
        torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
    # the shards really split the heads where tp divides them (Qwen2's 2 KV
    # heads replicate at tp = 4)
    assert sharding.place(kp, mesh).sharded == (tp > 1 and hkv % tp == 0)


def test_mesh_and_sharded_wrappers_refuse_what_they_cannot_run():
    """No card here: ``make_serving_mesh(2)`` raises unless devices are
    named, and the CUDA sharded wrappers refuse CPU tensors (they launch
    the kernels or raise)."""
    if torch.cuda.device_count() < 2:
        with pytest.raises((ValueError, RuntimeError)):
            make_serving_mesh(2)
    with pytest.raises(ValueError):
        make_serving_mesh(2, devices=["cpu"])
    mesh = cpu_mesh(2)
    q, kp, vp, tb, qp, kv = map(torch.from_numpy, _inputs("llama-2-7b", seed=4))
    with pytest.raises(ValueError, match="CUDA"):
        _sharded(paged_attention.ragged_paged_attention_sharded, q, kp, vp, (tb, qp, kv),
                 mesh, 0.0)
    with pytest.raises(ValueError, match="CUDA"):
        _sharded(paged_attention.paged_attention_sharded, q[:, 0].contiguous(), kp, vp,
                 (tb, kv), mesh, 0.0)
    placed = sharding.place(kp, mesh)
    assert torch.equal(torch.cat(placed.parts, dim=-2), kp) and placed[2].shape == kp[2].shape


# The reference's sharded kernels on a real 2-device mesh, in a subprocess
# (the device count is fixed when JAX starts).  It writes each output as a
# nested list, in a JSON object keyed by "<arch> <kernel> <softcap>".
_REF_SCRIPT = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.launch.mesh import make_serving_mesh
from repro.kernels.paged_attention import (
    paged_attention_sharded, ragged_paged_attention_sharded)
assert len(jax.devices()) == 2, jax.devices()
mesh = make_serving_mesh(2)
inputs = {k: [np.asarray(a, dtype=np.float32 if i < 3 else np.int32)
              for i, a in enumerate(v)] for k, v in json.load(sys.stdin).items()}
out = {}
for arch, (q, kp, vp, tb, qp, kv) in inputs.items():
    for cap in (0.0, 30.0):
        out[f"{arch} ragged {cap}"] = np.asarray(ragged_paged_attention_sharded(
            *map(jnp.asarray, (q, kp, vp, tb, qp, kv)), mesh, logit_softcap=cap,
            interpret=True)).tolist()
        out[f"{arch} decode {cap}"] = np.asarray(paged_attention_sharded(
            *map(jnp.asarray, (q[:, 0], kp, vp, tb, kv)), mesh, logit_softcap=cap,
            interpret=True)).tolist()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_on_two_devices():
    inputs = {arch: _inputs(arch, seed=5) for arch in ("llama-2-7b", "qwen2-0.5b")}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    proc = subprocess.run(
        [sys.executable, "-c", _REF_SCRIPT], env=env, capture_output=True, text=True,
        timeout=300,
        input=json.dumps({k: [a.tolist() for a in v] for k, v in inputs.items()}),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return inputs, json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("kernel", ["ragged", "decode"])
def test_port_matches_reference_sharded_kernels_on_two_devices(reference_on_two_devices,
                                                               kernel):
    inputs, ref = reference_on_two_devices
    mesh = cpu_mesh(2)
    for arch, arrays in inputs.items():
        q, kp, vp, tb, qp, kv = map(torch.from_numpy, arrays)
        for cap in (0.0, 30.0):
            if kernel == "ragged":
                got = _sharded(ops.ragged_paged_attention_sharded, q, kp, vp, (tb, qp, kv),
                               mesh, cap)
            else:
                got = _sharded(ops.paged_attention_sharded, q[:, 0].contiguous(), kp, vp,
                               (tb, kv), mesh, cap)
            want = np.asarray(ref[f"{arch} {kernel} {cap}"], np.float32)
            np.testing.assert_allclose(got.numpy(), want, atol=REF_ATOL, rtol=0,
                                       err_msg=f"{arch} {kernel} softcap={cap}")
