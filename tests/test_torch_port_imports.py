"""The port imports on a machine without JAX: importing `cerebra_torch` and
every one of its modules pulls in neither `jax` nor the `cerebra` package."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHECK = """
import importlib, pkgutil, sys
import cerebra_torch
names = [m.name for m in pkgutil.walk_packages(cerebra_torch.__path__, "cerebra_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "cerebra"))
assert not bad, bad
assert "cerebra_torch.cli.lstm_distill_from_dinov2_train" in names
assert "cerebra_torch.cli.main_dino" in names
assert "cerebra_torch.models.autoencoders" in names
assert "cerebra_torch.models.lstm_scan" in names
print(len(names))
"""


def test_port_imports_without_jax_or_cerebra():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", CHECK], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 30
