"""Lazy build and ctypes binding of the port's CUDA kernels.

``sweep.cu`` is compiled by ``nvcc`` for ``sm_90a`` at first use into
``reporter_tpu_torch/_build/`` (a shared library with a plain C
interface, loaded with ctypes: seconds to build, no PyTorch headers).
The library is named by a hash of its source and flags, so an edited
source rebuilds. A missing ``nvcc``, a failed build or a failed launch
raises; nothing falls back to the plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
_BUILD_DIR = _HERE.parent / "_build"
SWEEP_SOURCE = _HERE / "sweep.cu"

# exact f32 geometry: no FMA contraction, IEEE division and square root
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
               "-prec-div=true", "-prec-sqrt=true", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: "dict[str, ctypes.CDLL]" = {}
BUILD_LOG: "dict[str, dict]" = {}   # source name → {"seconds", "ptxas"}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
                       "the CUDA kernels are built from source at first use")


def build(source: Path) -> Path:
    """Compile ``source`` into the build directory (if not already there)
    and return the library's path."""
    flags_key = " ".join(_NVCC_FLAGS).encode()
    digest = hashlib.sha256(source.read_bytes() + flags_key).hexdigest()[:16]
    out = _BUILD_DIR / f"lib{source.stem}_{digest}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", tmp, str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {source.name} "
                           f"(rc {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    BUILD_LOG[source.name] = {"seconds": time.perf_counter() - t0,
                              "ptxas": proc.stderr.strip()}
    return out


def _sweep_lib() -> ctypes.CDLL:
    with _lock:
        lib = _loaded.get("sweep")
        if lib is None:
            lib = ctypes.CDLL(str(build(SWEEP_SOURCE)))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.rtt_sweep_topk.argtypes = [p, p, p, p, p, p, i, i, i, i,
                                           f, f, f, p, p, p, p, p]
            lib.rtt_sweep_topk.restype = ctypes.c_int
            _loaded["sweep"] = lib
        return lib


def load_sweep() -> None:
    """Build (if needed) and load the sweep library now."""
    _sweep_lib()


def launch_sweep(pts, ids, nhits, pack, sub, feat, arm: int, nchunks: int,
                 nblocks: int, spad: int, r2: float, rc2: float,
                 radius: float, edge, off, dist, gate_log=None) -> None:
    """One launch of the sweep's arm ``arm`` on PyTorch's current stream.
    The tensors are checked by the caller (ops.dense_candidates.sweep_topk);
    ``sub``, ``feat`` and ``gate_log`` may be None where the arm reads none."""
    import torch

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _sweep_lib()
    stream = torch.cuda.current_stream(pts.device).cuda_stream
    rc = lib.rtt_sweep_topk(
        pts.data_ptr(), ids.data_ptr(), nhits.data_ptr(), pack.data_ptr(),
        ptr(sub), ptr(feat), arm, nchunks, nblocks, spad, r2, rc2, radius,
        edge.data_ptr(), off.data_ptr(), dist.data_ptr(), ptr(gate_log),
        stream)
    if rc != 0:
        raise RuntimeError(f"sweep_topk launch failed (arm {arm}): "
                           f"cudaError {rc}")
