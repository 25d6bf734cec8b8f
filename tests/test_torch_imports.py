"""Import hygiene of the port: ``muax_tpu_torch`` (every module of it) and
``chip_smoke`` import neither JAX nor the JAX package."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import muax_tpu_torch
names = [m.name for m in pkgutil.walk_packages(muax_tpu_torch.__path__,
                                                "muax_tpu_torch.")]
for name in names:
  importlib.import_module(name)
import chip_smoke
banned = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "haiku", "flax",
                                       "optax", "muax_tpu"))
print(len(names), banned)
"""


def test_port_imports_no_jax():
  out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
  assert out.returncode == 0, out.stderr
  count, banned = out.stdout.strip().split(" ", 1)
  assert int(count) >= 15, out.stdout  # every module of the slice was loaded
  assert banned == "[]", banned
