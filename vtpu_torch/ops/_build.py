"""Build and load the hand-written Hopper kernels in ``vtpu_torch/csrc``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C entry point (bound through ctypes: no PyTorch headers, so a
build takes seconds, not minutes). Libraries land in ``build/vtpu_torch/``
at the repo root, keyed by a hash of the source, every ``csrc/*.cuh``
header (a source may include any of them) and the flags, and are reused
while that hash is unchanged. Nothing here runs at import: the first call
of a kernel wrapper on a CUDA tensor builds what it needs, and
``build_all`` starts one ``nvcc`` per source at once.

Launch counts live here too: each wrapper bumps its kernel's count where it
launches the kernel and nowhere else, so a run can show which kernels its
main path went through.
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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vtpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# kernel name -> launches since the last reset_launches(); the _tp names
# count the paged kernels' head-local calls under a tensor-parallel mesh
LAUNCHES: dict[str, int] = {
    "flash_attention": 0, "paged_decode_attention": 0,
    "paged_decode_attention_int8kv": 0, "decode_attention": 0,
    "decode_attention_int8kv": 0, "paged_decode_attention_tp": 0,
    "paged_decode_attention_int8kv_tp": 0,
}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# per-source build record: seconds spent in nvcc (0.0 when reused) and the
# compiler's resource report (-Xptxas -v: registers, shared memory, spills)
BUILD_LOG: dict[str, dict] = {}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def launches() -> dict[str, int]:
    return dict(LAUNCHES)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source unless its library is already built.
    Returns (target, process or None, start time)."""
    out = _target(name)
    if out.exists():
        return out, None, time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, proc, time.perf_counter()


def _finish(name: str, out: Path, proc, t0: float) -> None:
    if proc is None:
        BUILD_LOG.setdefault(name, {"seconds": 0.0, "ptxas": ""})
        return
    log, _ = proc.communicate()
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    BUILD_LOG[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}


def build_all() -> dict[str, dict]:
    """Compile every csrc source in parallel (one nvcc each) and load them."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with _lock:
        started = [(n, *_start(n)) for n in names if n not in _libs]
        for name, out, proc, t0 in started:
            _finish(name, out, proc, t0)
            _libs[name] = ctypes.CDLL(str(out))
    return dict(BUILD_LOG)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            out, proc, t0 = _start(name)
            _finish(name, out, proc, t0)
            _libs[name] = ctypes.CDLL(str(out))
        return _libs[name]


def check(err: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
