"""Lazy build and ctypes binding of the port's CUDA kernels.

Each source (``sweep.cu``: the sweep's bf16 filter arm;
``sweep_exact.cu``: its four ring-fed arms, the exact ``block`` and
``sub`` and the tensor-core ``mxu`` and ``mxu_bf16``) is compiled by
``nvcc`` for
``sm_90a`` at first use into ``reporter_tpu_torch/_build/``: one shared
library per source with a plain C interface, loaded with ctypes (seconds
to build, no PyTorch headers). ``load_sweep`` starts one ``nvcc`` per
source, all at once. A library is named by a hash of its source, the
headers beside it and the flags, so an edited source rebuilds. A missing
``nvcc``, a failed build or a failed launch raises; nothing falls back to
the plain version.
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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_HERE = Path(__file__).resolve().parent
_BUILD_DIR = _HERE.parent / "_build"
SWEEP_SOURCE = _HERE / "sweep.cu"
EXACT_SOURCE = _HERE / "sweep_exact.cu"

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
    and return the library's path. The name hashes the source, every
    header of its directory (``*.cuh``) and the flags."""
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for f in [source, *sorted(source.parent.glob("*.cuh"))]:
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    out = _BUILD_DIR / f"lib{source.stem}_{h.hexdigest()[:16]}.so"
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


def _bind_sweep(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rtt_sweep_bf16.argtypes = [p, p, p, p, p, i, i, i, f, f, f,
                                   p, p, p, p, p]
    lib.rtt_sweep_bf16.restype = ctypes.c_int


def _bind_exact(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rtt_sweep_exact.argtypes = [p, p, p, p, p, p, p, i, i, i, f, f, f,
                                    p, p, p, p, p]
    lib.rtt_sweep_exact.restype = ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    lib.rtt_sweep_exact_shape.argtypes = [i, ip, ip, ip, ip, ip]
    lib.rtt_sweep_exact_shape.restype = ctypes.c_int


_LIBS = {"sweep": (SWEEP_SOURCE, _bind_sweep),
         "sweep_exact": (EXACT_SOURCE, _bind_exact)}


def _lib(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            source, bind = _LIBS[name]
            lib = ctypes.CDLL(str(build(source)))
            bind(lib)
            _loaded[name] = lib
        return lib


def load_sweep() -> None:
    """Build (if needed) and load every kernel library now, one nvcc per
    source, all started together."""
    with ThreadPoolExecutor(len(_LIBS)) as pool:
        list(pool.map(build, [src for src, _ in _LIBS.values()]))
    for name in _LIBS:
        _lib(name)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def launch_sweep_bf16(pts, ids, nhits, pack, sub, nchunks: int,
                      nblocks: int, spad: int, r2: float, rc2: float,
                      radius: float, edge, off, dist, gate_log=None) -> None:
    """One launch of the bf16 filter arm on PyTorch's current stream. The
    tensors are checked by the caller (ops.dense_candidates.sweep_topk);
    ``gate_log`` may be None."""
    rc = _lib("sweep").rtt_sweep_bf16(
        pts.data_ptr(), ids.data_ptr(), nhits.data_ptr(), pack.data_ptr(),
        sub.data_ptr(), nchunks, nblocks, spad, r2, rc2, radius,
        edge.data_ptr(), off.data_ptr(), dist.data_ptr(), _ptr(gate_log),
        _stream(pts))
    if rc != 0:
        raise RuntimeError(f"sweep_bf16 launch failed: cudaError {rc}")


def launch_sweep_exact(pts, ids, nhits, order, table, sub, coarse,
                       arm: int, nchunks: int, nblocks: int, r2: float,
                       rc2: float, radius: float, edge, off, dist,
                       gate_log=None) -> None:
    """One call of the ring-fed sweep (arm 0 block, 1 sub, 3 mxu, 4
    mxu_bf16) on PyTorch's current stream: the chunk order kernel writes
    ``order`` (i32 scratch [nchunks + 1]: the chunks heaviest first, then
    the CTAs' chunk counter), then the sweep runs. The caller checks the
    tensors. ``sub`` and ``gate_log`` may be None for the block arm,
    ``coarse`` for every arm but the mxu ones."""
    rc = _lib("sweep_exact").rtt_sweep_exact(
        pts.data_ptr(), ids.data_ptr(), nhits.data_ptr(), order.data_ptr(),
        table.data_ptr(), _ptr(sub), _ptr(coarse), arm, nchunks, nblocks,
        r2, rc2, radius, edge.data_ptr(), off.data_ptr(), dist.data_ptr(),
        _ptr(gate_log), _stream(pts))
    if rc != 0:
        raise RuntimeError(f"sweep_exact launch failed (arm {arm}): "
                           f"error {rc}")


def exact_shape(arm: int) -> dict:
    """The ring-fed sweep's launch shape on the current device: threads
    per CTA, dynamic shared memory (bytes), resident CTAs per SM, SMs and
    the ring's depth (stages)."""
    vals = [ctypes.c_int(0) for _ in range(5)]
    rc = _lib("sweep_exact").rtt_sweep_exact_shape(
        arm, *(ctypes.byref(v) for v in vals))
    if rc != 0:
        raise RuntimeError(f"sweep_exact shape query failed (arm {arm}): "
                           f"error {rc}")
    return dict(zip(("threads", "smem_bytes", "ctas_per_sm", "sms", "depth"),
                    (v.value for v in vals)))
