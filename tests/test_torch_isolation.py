"""The port stands alone: no JAX, nothing of the JAX package, and no quiet
move to the CPU when the card is missing."""

import json
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def test_importing_the_port_and_chip_smoke_loads_no_jax_and_no_repro():
    # a subprocess: this test process has JAX loaded already (conftest)
    code = textwrap.dedent(f"""
        import importlib, json, pkgutil, sys
        sys.path[:0] = [{str(ROOT / "src")!r}, {str(ROOT)!r}]
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        bad = sorted(n for n in sys.modules
                     if n.split(".")[0] in ("jax", "jaxlib", "repro"))
        print(json.dumps({{"modules": names, "bad": bad}}))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    assert "repro_torch.core.ferret" in got["modules"]  # the walk really imported the port


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax|from\s+jax[\s.]|import\s+repro(\.|\s|$)|from\s+repro(\.|\s))",
    re.MULTILINE,
)


def test_no_source_of_the_port_imports_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    offenders = [str(f) for f in files if _FORBIDDEN.search(f.read_text())]
    assert offenders == []


def test_entry_points_default_to_the_card_and_refuse_without_one():
    from repro_torch.core.ferret import FerretConfig, FerretTrainer
    from repro_torch.models.registry import get_config

    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA device"):
        FerretTrainer(get_config("h2o-danube-1.8b", smoke=True), FerretConfig(), 2, 16)


def test_unported_algorithms_raise():
    from repro_torch.ocl.registry import Vanilla, get_algorithm

    assert isinstance(get_algorithm("vanilla"), Vanilla)
    for name in ("er", "mir", "lwf", "mas"):
        with pytest.raises(ValueError, match="not ported"):
            get_algorithm(name)


def test_chip_smoke_fails_without_a_card_and_alone(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour without a CUDA device")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", alone):
        out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                             timeout=120, cwd=script.parent)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
