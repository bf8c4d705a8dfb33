"""Lazy build and ctypes binding of the port's CUDA kernel.

``sweep_exact.cu`` holds the sweep's five arms (the exact ``block`` and
``sub``, the bf16 filter ``sub_bf16`` and the tensor-core ``mxu`` and
``mxu_bf16``), each an instance of one kernel template over the arm and
the top-K width K. ``nvcc`` compiles it for ``sm_90a`` once per K of
``SWEEP_KS`` (``-DRTT_SWEEP_K=K``: the five arms at that K, their running
list in registers) and once as the wide library (``-DRTT_SWEEP_K=0``,
library key ``WIDE``: the five arms with the list in a global scratch and
K given at run time, which serves every K past ``SWEEP_KS[-1]``), each at
its first use, into ``reporter_tpu_torch/_build/``: one shared library
per K and ``libsweep_exact_kwide_<hash>.so``, with a plain C interface,
loaded with ctypes (seconds to build, no PyTorch headers). ``build_all``
starts every library's ``nvcc`` at once. A library is named by its K (or
``wide``) and a hash of its source, the headers beside it and the flags,
so an edited source rebuilds; its ``ptxas -v`` report is kept beside it
(``ptxas_log``). A missing ``nvcc``, a failed build or a failed launch
raises; nothing falls back to the plain version or to another K.
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
# the key of the wide library (-DRTT_SWEEP_K=0): the five arms at a top-K
# width given at run time, their list in a scratch the caller allocates
WIDE = 0

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


def library_key(k: int) -> int:
    """The library that serves top-K width ``k``: k itself where it is one
    of SWEEP_KS, else the wide library (WIDE)."""
    return k if k in SWEEP_KS else WIDE


def library_tag(key: int) -> str:
    """A library's K as its name and the manifest print it: ``wide`` for
    WIDE."""
    return "wide" if key == WIDE else str(key)


def build(source: Path, k: int) -> Path:
    """Compile ``source`` at top-K width ``k`` (a K of SWEEP_KS, or WIDE)
    into the build directory, if not already there, and return the
    library's path. The name holds k (``wide`` for WIDE) and a hash of the
    source, every header of its directory (``*.cuh``) and the flags."""
    flags = (*_NVCC_FLAGS, f"-DRTT_SWEEP_K={int(k)}")
    h = hashlib.sha256(" ".join(flags).encode())
    for f in [source, *sorted(source.parent.glob("*.cuh"))]:
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    name = f"lib{source.stem}_k{library_tag(k)}_{h.hexdigest()[:16]}.so"
    out = _BUILD_DIR / name
    # a library without its ptxas report (built before the report was
    # kept) is not built: the manifest reads the report of every library
    if out.exists() and _ptxas_path(out).exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *flags, "-o", tmp, str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {source.name} at "
                           f"K={library_tag(k)} (rc {proc.returncode}):\n"
                           f"{proc.stderr}")
    # the ptxas report beside the library, in place first: a library that
    # exists has its report (analysis/compile_manifest reads it on a warm
    # build too); both land whole (a replace), whoever builds at once
    fd, rep = tempfile.mkstemp(suffix=".txt", dir=_BUILD_DIR)
    with os.fdopen(fd, "w") as f:
        f.write(proc.stderr.strip() + "\n")
    os.replace(rep, _ptxas_path(out))
    os.replace(tmp, out)
    BUILD_LOG[f"{source.name} K={library_tag(k)}"] = {
        "seconds": time.perf_counter() - t0, "ptxas": proc.stderr.strip()}
    return out


def _ptxas_path(lib: Path) -> Path:
    return lib.with_name(lib.name + ".ptxas.txt")


def ptxas_log(k: int) -> str:
    """The ``ptxas -v`` report of the K library (WIDE: the wide one; built
    now if it is not yet), kept beside it in the build directory."""
    return _ptxas_path(build(EXACT_SOURCE, k)).read_text()


LIBRARIES = (*SWEEP_KS, WIDE)   # every library build_all builds


def build_all() -> None:
    """Build every library now (each K of SWEEP_KS and the wide one), one
    ``nvcc`` each, all started together."""
    with ThreadPoolExecutor(max_workers=len(LIBRARIES)) as pool:
        list(pool.map(lambda k: build(EXACT_SOURCE, k), LIBRARIES))


def _lib(k: int) -> ctypes.CDLL:
    with _lock:
        if k not in _loaded:
            lib = ctypes.CDLL(str(build(EXACT_SOURCE, k)))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.rtt_sweep_exact.argtypes = [p, p, p, p, p, p, p, i, i, i, i,
                                            f, f, f, p, p, p, p, i, p, p]
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
                       gate_log=None, squared: bool = False,
                       scratch=None) -> None:
    """One call of the ring-fed sweep (arm 0 block, 1 sub, 2 sub_bf16, 3
    mxu, 4 mxu_bf16) on the current stream of the tensors' device, with
    that device current (``_on_device``), at the top-K width of
    the outputs (``edge``'s [nchunks * 256, K]), in the library
    ``library_key(K)``: the chunk order kernel
    writes ``order`` (i32 scratch [nchunks + 1]: the chunks heaviest
    first, then the CTAs' chunk counter), then the sweep runs. The caller
    checks the tensors. ``sub`` and ``gate_log`` may be None for the block
    arm, ``coarse`` for block and sub. ``squared``: ``dist`` receives the
    squared distances. ``scratch`` (f32 [3, K, nchunks * 256]) holds the
    wide library's running lists and is required there; the register
    libraries take None."""
    k = int(edge.shape[1])
    lib = _lib(library_key(k))
    with _on_device(pts.device):
        rc = lib.rtt_sweep_exact(
            pts.data_ptr(), ids.data_ptr(), nhits.data_ptr(),
            order.data_ptr(), table.data_ptr(), _ptr(sub), _ptr(coarse), arm,
            k, nchunks, nblocks, r2, rc2, radius, edge.data_ptr(),
            off.data_ptr(), dist.data_ptr(), _ptr(gate_log), int(squared),
            _ptr(scratch), _stream(pts))
    if rc != 0:
        raise RuntimeError(f"sweep_exact launch failed (arm {arm}, K={k}): "
                           f"error {rc}")


def exact_shape(arm: int, k: int, device="cuda") -> dict:
    """The ring-fed sweep's launch shape at top-K width k (WIDE or any k
    past SWEEP_KS: the wide instance's, the same at every such k) on
    ``device`` (``cuda``: the current one): threads per CTA, dynamic
    shared memory (bytes), resident CTAs per SM, SMs, the ring's depth
    (stages) and the columns per early-exit test of the arm's gate (0 for
    block and sub)."""
    vals = [ctypes.c_int(0) for _ in range(6)]
    lib = _lib(library_key(k))
    with _on_device(device):
        rc = lib.rtt_sweep_exact_shape(
            arm, k, *(ctypes.byref(v) for v in vals))
    if rc != 0:
        raise RuntimeError(f"sweep_exact shape query failed (arm {arm}, "
                           f"K={k}): error {rc}")
    return dict(zip(("threads", "smem_bytes", "ctas_per_sm", "sms", "depth",
                     "gate_group"),
                    (v.value for v in vals)))
