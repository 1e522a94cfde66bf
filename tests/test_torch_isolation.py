"""The port stands alone: nothing under src/repro_torch/, nor chip_smoke.py,
nor the example twins (examples/torch_*.py), imports JAX, the JAX package
or the benchmarks; importing the port loads
no JAX; entry points refuse to run without a CUDA device unless the caller
asks for the CPU; chip_smoke.py fails without a card or without the repo."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro", "benchmarks"}


def _port_files():
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "examples").glob("torch_*.py")))


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_importing_the_port_loads_no_jax():
    mods = sorted("repro_torch." + ".".join(p.relative_to(PORT).with_suffix("")
                                            .parts).replace(".__init__", "")
                  for p in PORT.rglob("*.py"))
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m.rstrip('.'))\n"
            "sys.path.insert(0, %r)\n" % str(ROOT)
            + "import chip_smoke\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'benchmarks')]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("clean")


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    from repro_torch.core.table import Table
    from repro_torch.kernels import ops
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = {"a": np.arange(10, dtype=np.int32)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Table.from_arrays(data)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.bucketize(np.arange(4, dtype=np.int32), np.arange(3, dtype=np.int32))
    t = Table.from_arrays(data, device="cpu")
    assert t.device.type == "cpu"


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                          "--sf", "0.001"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py", "--sf", "0.001"],
                         cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_every_cuda_source_is_built_with_a_plain_c_interface():
    """Every ``.cu`` under ``csrc/`` is one of ``_build.SOURCES`` and every
    header one of ``_build.headers()`` (all of them, hashed into the build
    directory's name); none includes PyTorch's headers (the
    libraries are plain ``extern "C"`` loaded with ctypes), and each
    source names the TPU kernel it replaces."""
    from repro_torch.kernels import _build
    csrc = PORT / "kernels" / "csrc"
    assert sorted(p.name for p in csrc.glob("*.cu")) == sorted(_build.SOURCES)
    assert sorted(p.name for p in csrc.glob("*.cuh")) == list(_build.headers())
    assert "packed.cuh" in _build.headers()
    for path in sorted(csrc.iterdir()):
        text = path.read_text()
        assert "torch/" not in text and "ATen/" not in text, path.name
        if path.suffix == ".cu":
            assert 'extern "C"' in text and "src/repro/kernels/" in text, \
                path.name
    assert {"unpack_kernel", "bucketize_packed_kernel",
            "rle_decode_packed_kernel"} <= set(_build.KERNELS)
    assert set(_build.LAUNCHES) == set(_build.KERNELS)


def test_kernel_build_hash_covers_the_shared_header(tmp_path, monkeypatch):
    """A change to ``bisect.cuh`` alone must give a new build directory, or
    a stale library of ``bucketize.cu`` / ``unpack.cu`` would load."""
    from repro_torch.kernels import _build
    before = _build.source_digest()
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    (copy / "bisect.cuh").write_text((copy / "bisect.cuh").read_text() + "\n")
    monkeypatch.setattr(_build, "CSRC", copy)
    assert _build.source_digest() != before


@pytest.mark.parametrize("edit", ["packed.cuh", "rle_tile.cuh", "new.cuh"])
def test_kernel_build_hash_covers_every_header(tmp_path, monkeypatch, edit):
    """An edit to any header, or a new one, gives a new build directory:
    the digest hashes every ``csrc/*.cuh``, not a hand-kept list."""
    from repro_torch.kernels import _build
    before = _build.source_digest()
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    path = copy / edit
    path.write_text((path.read_text() if path.exists() else "") + "\n")
    monkeypatch.setattr(_build, "CSRC", copy)
    assert _build.source_digest() != before
