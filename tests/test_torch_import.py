"""The PyTorch port never imports JAX, the JAX package or ``ml_dtypes``
(it must run where none of them is installed). Checked in a fresh
interpreter: tests/conftest.py imports jax into the pytest process, so an
in-process check would prove nothing."""

import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import scann_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(scann_tpu_torch.__path__,
                                              "scann_tpu_torch.")]
for name in mods:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "ml_dtypes")
             or m.startswith(("jax.", "jaxlib", "scann_tpu.", "ml_dtypes.")))
bad += ["scann_tpu"] if "scann_tpu" in sys.modules else []
print(len(mods), bad)
sys.exit(1 if bad or len(mods) < 10 else 0)
"""


def test_port_imports_no_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=_REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_sources_name_no_jax():
    """No module of the port even mentions an import of jax."""
    pkg = os.path.join(_REPO, "scann_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    src = fh.read()
                for bad in ("import jax", "from jax", "import scann_tpu.",
                            "from scann_tpu.", "import ml_dtypes",
                            "from ml_dtypes"):
                    assert bad not in src, (f, bad)
