"""The port's import boundary: ``repro_torch`` and ``chip_smoke.py`` import
neither jax nor anything of the reference package ``repro``."""
import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print(len(names), " ".join(names), bad)
"""

# the modules of each slice, which the walk must reach
SLICES = ("repro_torch.kernels.flash_attention", "repro_torch.launch.serve",
          "repro_torch.optim.adamw", "repro_torch.train.steps",
          "repro_torch.train.trainer", "repro_torch.data.pipeline",
          "repro_torch.ckpt.checkpoint", "repro_torch.launch.train")


def test_importing_every_module_leaves_jax_and_repro_out():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, rest = out.stdout.split(" ", 1)
    names, bad = rest.rsplit(" ", 1)
    assert int(count) >= 20, out.stdout          # every subpackage walked
    assert set(SLICES) <= set(names.split()), out.stdout
    assert bad.strip() == "[]", out.stdout


_IMPORT = re.compile(r"^\s*(?:from|import)\s+(jax|repro)(?:[.\s]|$)", re.M)


def test_sources_name_no_jax_or_repro_import():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = [(str(f.relative_to(ROOT)), m.group(0).strip())
            for f in files for m in _IMPORT.finditer(f.read_text())]
    assert not hits, hits
