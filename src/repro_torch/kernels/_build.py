"""Build, load and count the port's CUDA kernels.

The sources in ``csrc/`` are compiled at first use with ``nvcc`` for
``sm_90a`` into plain shared libraries with an ``extern "C"`` interface,
loaded with ``ctypes`` (pointers and the stream as ``c_void_p``). One
``nvcc`` runs per source, all started together; every header in
``csrc/`` (``*.cuh``) is hashed with the sources, so an edit to any of
them rebuilds. The libraries land in
``build/repro_torch_kernels/<hash>/`` at the checkout root, keyed by a
hash of the sources and flags, so a fresh checkout builds them on its
first kernel call and a changed source never loads a stale library.
Nothing here runs at import: the tests import every module on machines
without ``nvcc``.

Every wrapper adds one to ``LAUNCHES[name]`` where it launches its kernel
and nowhere else, and one to ``SHAPES[name][cls]``, a tally by shape
class: rows, queries and boundaries rounded up to a power of two, G and
bit widths exact (``pow2``). It passes the launch's bytes, the least it
must move (each input read once, each output written once), which
telemetry records as a ``kernel`` instant while it records. With
``capture(True)``, each wrapper also keeps the inputs of its largest
launch (``LARGEST``), so a caller can replay the main path's real shapes
against the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().with_name("csrc")
SOURCES = ("bucketize.cu", "rle_decode.cu", "segment_reduce.cu", "unpack.cu",
           "topk.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

KERNELS = ("bucketize_kernel", "bucketize_count_kernel", "rle_decode_kernel",
           "segment_sum_kernel", "unpack_kernel", "bucketize_packed_kernel",
           "rle_decode_packed_kernel", "topk_kernel")
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
SHAPES: Dict[str, Dict[str, int]] = {name: {} for name in KERNELS}
LARGEST: Dict[str, dict] = {}
BUILD_INFO: Dict[str, object] = {}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_CAPTURE = False


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0
        SHAPES[name] = {}


def pow2(n: int) -> str:
    """``n`` rounded up to a power of two, as ``"2^k"``."""
    return f"2^{max(int(n) - 1, 0).bit_length()}"


def capture(on: bool) -> None:
    """Keep (``True``) or stop keeping the largest launch's inputs."""
    global _CAPTURE
    _CAPTURE = on
    if not on:
        LARGEST.clear()


def count_launch(name: str, work: int, cls: str, nbytes: int,
                 **inputs) -> None:
    """Book one launch of kernel ``name`` of shape class ``cls`` that must
    move ``nbytes`` (called right after the launch)."""
    # lazy: core.telemetry's package imports the kernels
    from repro_torch.core import telemetry
    LAUNCHES[name] += 1
    tally = SHAPES[name]
    tally[cls] = tally.get(cls, 0) + 1
    if _CAPTURE and work >= LARGEST.get(name, {}).get("work", -1):
        LARGEST[name] = dict(inputs, work=work)
    telemetry.record_kernel(name, nbytes)


def nvcc_path() -> str:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        home = os.environ.get(var)
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def headers() -> tuple:
    """Every header in ``csrc/``, by name."""
    return tuple(sorted(p.name for p in CSRC.glob("*.cuh")))


def source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + headers():
        h.update(src.encode())
        h.update((CSRC / src).read_bytes())
    return h.hexdigest()[:16]


def build() -> Dict[str, Path]:
    """Compile every source (in parallel) unless this hash is built."""
    out_dir = BUILD_ROOT / source_digest()
    libs = {src: out_dir / (Path(src).stem + ".so") for src in SOURCES}
    if all(p.exists() for p in libs.values()):
        BUILD_INFO.setdefault("seconds", 0.0)
        BUILD_INFO.setdefault("dir", str(out_dir))
        return libs
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    jobs = []
    for src, lib in libs.items():
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        jobs.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = {}, []
    for src, lib, tmp, proc in jobs:
        out, _ = proc.communicate()
        logs[src] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {src}:\n{out}")
            continue
        (out_dir / (Path(src).stem + ".log")).write_text(out)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    BUILD_INFO.update(seconds=time.perf_counter() - t0, dir=str(out_dir),
                      logs=logs)
    return libs


def library(source: str) -> ctypes.CDLL:
    """The loaded library of ``source`` (building on first use)."""
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build()[source]))
            _LIBS[source] = lib
        return lib


def run_on(index: int, fn, *args) -> int:
    """Call the C entry ``fn(*args, stream)`` for the card ``index`` on its
    current stream, read raw, without entering a device context unless
    ``index`` is not the current card (the launch path of every wrapper:
    the entries are bound once, at first use)."""
    import torch
    if index == torch._C._cuda_getDevice():
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))


def check(lib: ctypes.CDLL, err: int, name: str, error_string: str) -> None:
    """Raise if a kernel entry returned a CUDA error; ``error_string`` names
    the library's ``cudaGetErrorString`` export."""
    if err != 0:
        fn = getattr(lib, error_string)
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_char_p
        raise RuntimeError(f"{name}: CUDA error {err} {fn(err).decode()}")
