"""The port's H100 specs (``core/profiler.py``), by the device name that
``torch.cuda.get_device_name`` reports, against NVIDIA's data sheet (dense
bf16 rates, device memory bandwidth)."""
import pytest

from repro_torch.core.profiler import h100_spec


@pytest.mark.parametrize("name,flops,hbm_bw", [
    ("NVIDIA H100 PCIe", 756e12, 2.0e12),
    ("NVIDIA H100 80GB HBM3", 989e12, 3.35e12),
])
def test_h100_spec_follows_the_part(name, flops, hbm_bw):
    spec = h100_spec(name)
    assert (spec.flops, spec.hbm_bw) == (flops, hbm_bw)
