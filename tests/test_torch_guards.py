"""The port stands alone: importing any `repro_torch` module (and
`chip_smoke.py`) loads neither jax nor the JAX package, and no source
file of the port names them."""
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import repro_torch

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) \
    + [REPO / "chip_smoke.py"]


def test_importing_the_port_loads_no_jax_and_no_repro():
    mods = sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))
    assert "repro_torch.serve.engine" in mods and len(mods) > 20
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'repro'\n"
        "             or m.startswith('repro.'))\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(REPO / "src"),
                                         "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stdout + res.stderr


FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)"
    r"|from\s+repro(\.|\s))", re.M)


def test_port_sources_name_neither_jax_nor_repro():
    offenders = [f"{p.relative_to(REPO)}: {m.group(0).strip()}"
                 for p in PORT_FILES
                 for m in FORBIDDEN.finditer(p.read_text())]
    assert not offenders, offenders


def test_the_scan_catches_what_it_should():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import x",
                 "from repro.models import layers", "import repro.serve",
                 "  import repro"):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.models import x",
                 "import jaxlib_free_name_ok as j", "# import jax"):
        assert not FORBIDDEN.search(line), line
