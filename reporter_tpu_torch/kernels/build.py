"""Lazy build and ctypes binding of the port's CUDA kernel.

``sweep_exact.cu`` holds the sweep's five arms (the exact ``block`` and
``sub``, the bf16 filter ``sub_bf16`` and the tensor-core ``mxu`` and
``mxu_bf16``), each an instance of one kernel template over the arm and
the top-K width K. ``nvcc`` compiles it for ``sm_90a`` once per K of
``SWEEP_KS`` (``-DRTT_SWEEP_K=K``: the five arms at that K), at the first
use of that K, into ``reporter_tpu_torch/_build/``: one shared library per
K with a plain C interface, loaded with ctypes (seconds to build, no
PyTorch headers). ``build_all`` starts every K's ``nvcc`` at once. A
library is named by its K and a hash of its source, the headers beside it
and the flags, so an edited source rebuilds. A missing ``nvcc``, a failed
build or a failed launch raises; nothing falls back to the plain version.
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

# the top-K widths the sweep is built for: sweep_exact.cu is compiled once
# per K here, each library holding the five arms at that K
SWEEP_KS = (4, 6, 8, 12, 16)

_HERE = Path(__file__).resolve().parent
_BUILD_DIR = _HERE.parent / "_build"
EXACT_SOURCE = _HERE / "sweep_exact.cu"

# exact f32 geometry: no FMA contraction, IEEE division and square root
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
               "-prec-div=true", "-prec-sqrt=true", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: "dict[int, ctypes.CDLL]" = {}
BUILD_LOG: "dict[str, dict]" = {}   # library name → {"seconds", "ptxas"}


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


def build(source: Path, k: int) -> Path:
    """Compile ``source`` at top-K width ``k`` into the build directory, if
    not already there, and return the library's path. The name holds k and
    a hash of the source, every header of its directory (``*.cuh``) and the
    flags."""
    flags = (*_NVCC_FLAGS, f"-DRTT_SWEEP_K={int(k)}")
    h = hashlib.sha256(" ".join(flags).encode())
    for f in [source, *sorted(source.parent.glob("*.cuh"))]:
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    name = f"lib{source.stem}_k{k}_{h.hexdigest()[:16]}.so"
    out = _BUILD_DIR / name
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *flags, "-o", tmp, str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {source.name} at K={k} "
                           f"(rc {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    BUILD_LOG[f"{source.name} K={k}"] = {
        "seconds": time.perf_counter() - t0, "ptxas": proc.stderr.strip()}
    return out


def build_all() -> None:
    """Build every K's library now, one ``nvcc`` each, all started
    together."""
    with ThreadPoolExecutor(max_workers=len(SWEEP_KS)) as pool:
        list(pool.map(lambda k: build(EXACT_SOURCE, k), SWEEP_KS))


def _lib(k: int) -> ctypes.CDLL:
    with _lock:
        if k not in _loaded:
            lib = ctypes.CDLL(str(build(EXACT_SOURCE, k)))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.rtt_sweep_exact.argtypes = [p, p, p, p, p, p, p, i, i, i, i,
                                            f, f, f, p, p, p, p, i, p]
            lib.rtt_sweep_exact.restype = ctypes.c_int
            ip = ctypes.POINTER(ctypes.c_int)
            lib.rtt_sweep_exact_shape.argtypes = [i, i, ip, ip, ip, ip, ip,
                                                  ip]
            lib.rtt_sweep_exact_shape.restype = ctypes.c_int
            _loaded[k] = lib
        return _loaded[k]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def _on_device(device):
    """The CUDA device guard of ``device`` (a tensor's): the library reads
    ``cudaGetDevice`` for its launch shape and its ``<<<>>>`` launches go
    to the current device, so every call into it runs with the device of
    its tensors current, whatever the calling thread's current device."""
    import torch

    return torch.cuda.device(device)


def launch_sweep_exact(pts, ids, nhits, order, table, sub, coarse,
                       arm: int, nchunks: int, nblocks: int, r2: float,
                       rc2: float, radius: float, edge, off, dist,
                       gate_log=None, squared: bool = False) -> None:
    """One call of the ring-fed sweep (arm 0 block, 1 sub, 2 sub_bf16, 3
    mxu, 4 mxu_bf16) on the current stream of the tensors' device, with
    that device current (``_on_device``), at the top-K width of
    the outputs (``edge``'s [nchunks * 256, K]): the chunk order kernel
    writes ``order`` (i32 scratch [nchunks + 1]: the chunks heaviest
    first, then the CTAs' chunk counter), then the sweep runs. The caller
    checks the tensors. ``sub`` and ``gate_log`` may be None for the block
    arm, ``coarse`` for block and sub. ``squared``: ``dist`` receives the
    squared distances."""
    k = int(edge.shape[1])
    lib = _lib(k)
    with _on_device(pts.device):
        rc = lib.rtt_sweep_exact(
            pts.data_ptr(), ids.data_ptr(), nhits.data_ptr(),
            order.data_ptr(), table.data_ptr(), _ptr(sub), _ptr(coarse), arm,
            k, nchunks, nblocks, r2, rc2, radius, edge.data_ptr(),
            off.data_ptr(), dist.data_ptr(), _ptr(gate_log), int(squared),
            _stream(pts))
    if rc != 0:
        raise RuntimeError(f"sweep_exact launch failed (arm {arm}, K={k}): "
                           f"error {rc}")


def exact_shape(arm: int, k: int, device="cuda") -> dict:
    """The ring-fed sweep's launch shape at top-K width k on ``device``
    (``cuda``: the current one): threads per CTA, dynamic shared memory
    (bytes), resident CTAs per SM, SMs, the ring's depth (stages) and the
    columns per early-exit test of the arm's gate (0 for block and
    sub)."""
    vals = [ctypes.c_int(0) for _ in range(6)]
    lib = _lib(k)
    with _on_device(device):
        rc = lib.rtt_sweep_exact_shape(
            arm, k, *(ctypes.byref(v) for v in vals))
    if rc != 0:
        raise RuntimeError(f"sweep_exact shape query failed (arm {arm}, "
                           f"K={k}): error {rc}")
    return dict(zip(("threads", "smem_bytes", "ctas_per_sm", "sms", "depth",
                     "gate_group"),
                    (v.value for v in vals)))
