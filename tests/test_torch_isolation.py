"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor any module of the JAX package ``repro``."""
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def test_port_imports_with_jax_and_repro_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch.serving.real_engine, repro_torch.launch.serve\n"
        "import repro_torch.serving.runtime, repro_torch.serving.metrics\n"
        "import repro_torch.serving.loadgen\n"
        "import repro_torch.bridge, repro_torch.kernels.ops\n"
        "import repro_torch.launch.mesh, repro_torch.distributed.sharding\n"
        "import repro_torch.models.moe, repro_torch.configs\n"
        "repro_torch.configs.all_configs()\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and "
        "(m.split('.')[0] in ('jax', 'jaxlib', 'repro'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_no_jax_or_reference_imports_in_port_sources():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders, offenders
