"""No module of the port, and not chip_smoke.py, imports jax or the JAX
package: a grep over their sources, and every module imported in a fresh
interpreter."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "hdsdp_tpu_torch"
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|hdsdp_tpu)(\.|\s|,|$)", re.M)
SOURCES = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _module(path: Path) -> str:
    rel = path.relative_to(REPO).with_suffix("")
    parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
    return ".".join(parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax(path):
    hits = [m.group(0).strip() for m in FORBIDDEN.finditer(path.read_text())]
    assert not hits, f"{path.name}: {hits}"


def test_every_module_imports_without_jax():
    mods = [_module(p) for p in SOURCES if p.name != "chip_smoke.py"]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'hdsdp_tpu')]\n"
        "print(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "[]"
    assert "hdsdp_tpu_torch.solver.lpsolve" in mods and "hdsdp_tpu_torch.native.sdpa_native" in mods
