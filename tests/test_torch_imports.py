"""catseg_tpu_torch imports neither jax nor PIL (the GPU machine has neither),
and importing it starts no kernel build or triton import."""

import subprocess
import sys

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None   # any "import jax" now raises ImportError
sys.modules["PIL"] = None
import catseg_tpu_torch
names = [m.name for m in pkgutil.walk_packages(catseg_tpu_torch.__path__, "catseg_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert "catseg_tpu_torch.infer.pipeline" in names, names
assert "triton" not in sys.modules
print(len(names))
"""


def test_port_imports_without_jax_or_pil():
    res = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 15
