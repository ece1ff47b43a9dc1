"""Torch port: importing every module of sav_tpu_torch, and chip_smoke,
loads neither JAX nor anything of sav_tpu (the card's host has no JAX)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r'''
import importlib, pkgutil, sys
for name in ('jax', 'jaxlib', 'flax'):
    sys.modules[name] = None          # any import of them raises
import sav_tpu_torch
names = [m.name for m in pkgutil.walk_packages(sav_tpu_torch.__path__,
                                               'sav_tpu_torch.')]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules
                if m == 'sav_tpu' or m.startswith('sav_tpu.'))
assert not leaked, leaked
print(len(names))
'''


def test_port_imports_without_jax_or_sav_tpu():
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    out = subprocess.run([sys.executable, '-c', PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15      # every module was reached
