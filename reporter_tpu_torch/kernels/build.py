"""Lazy build and ctypes binding of the port's CUDA kernel.

``sweep_exact.cu`` holds the sweep's five arms (the exact ``block`` and
``sub``, the bf16 filter ``sub_bf16`` and the tensor-core ``mxu`` and
``mxu_bf16``), each an instance of one kernel template over the arm and
the top-K width K. ``nvcc`` compiles it for ``sm_90a`` once per K of
``SWEEP_KS`` (``-DRTT_SWEEP_K=K``: the five arms at that K, their running
list in registers) and once as the wide library (``-DRTT_SWEEP_K=0``,
library key ``WIDE``: the five arms with K given at run time, which serve
every K past ``SWEEP_KS[-1]``, each arm's lists in shared memory beside
its ring up to the K whose lists fit there and in a global scratch past
it: ``ops/dense_candidates.list_plan``), each at
its first use, into ``reporter_tpu_torch/_build/``: one shared library
per K and ``libsweep_exact_kwide_<hash>.so``, with a plain C interface,
loaded with ctypes (seconds to build, no PyTorch headers). ``build_all``
starts every library's ``nvcc`` at once. A library is named by its K (or
``wide``) and a hash of its source, the headers beside it and the flags,
so an edited source rebuilds; its ``ptxas -v`` report is kept beside it
(``ptxas_log``). ``viterbi.cu`` holds the batched Viterbi decode
(``ops/hmm.py::viterbi_decode_batched`` on a card): one library, K a
run-time argument, built beside the sweep's (``build_all`` starts its
``nvcc`` with theirs). ``lattice.cu`` holds the ranked-path lattice's
three kernels (``ops/hmm.py``'s keep mask, list-Viterbi forward pass and
R-path backtrack on a card) and ``grid.cu`` the grid candidate backend's
kernel (``ops/candidates.py::find_candidates`` on a card): one library
each, built beside the others. Each ``launch_*`` checks its tensors'
dtypes, shapes and device before it builds or launches. A missing
``nvcc``, a failed build or a failed launch raises; nothing falls back to
the plain version or to another K.
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
# width given at run time, their lists in shared memory or, past the K that
# fits there, in a scratch the caller allocates
WIDE = 0

_HERE = Path(__file__).resolve().parent
_BUILD_DIR = _HERE.parent / "_build"
EXACT_SOURCE = _HERE / "sweep_exact.cu"
VITERBI_SOURCE = _HERE / "viterbi.cu"
LATTICE_SOURCE = _HERE / "lattice.cu"
GRID_SOURCE = _HERE / "grid.cu"

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


def build(source: Path, k: "int | None") -> Path:
    """Compile ``source`` at top-K width ``k`` (a K of SWEEP_KS, or WIDE;
    None for a source that takes no -DRTT_SWEEP_K, as viterbi.cu) into the
    build directory, if not already there, and return the library's path.
    The name holds k (``wide`` for WIDE, nothing for None) and a hash of
    the source, every header of its directory (``*.cuh``) and the flags."""
    flags = _NVCC_FLAGS if k is None else (*_NVCC_FLAGS,
                                           f"-DRTT_SWEEP_K={int(k)}")
    h = hashlib.sha256(" ".join(flags).encode())
    for f in [source, *sorted(source.parent.glob("*.cuh"))]:
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    tag = "" if k is None else f"_k{library_tag(k)}"
    name = f"lib{source.stem}{tag}_{h.hexdigest()[:16]}.so"
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
        at = "" if k is None else f" at K={library_tag(k)}"
        raise RuntimeError(f"nvcc failed on {source.name}{at} (rc "
                           f"{proc.returncode}):\n{proc.stderr}")
    # the ptxas report beside the library, in place first: a library that
    # exists has its report (analysis/compile_manifest reads it on a warm
    # build too); both land whole (a replace), whoever builds at once
    fd, rep = tempfile.mkstemp(suffix=".txt", dir=_BUILD_DIR)
    with os.fdopen(fd, "w") as f:
        f.write(proc.stderr.strip() + "\n")
    os.replace(rep, _ptxas_path(out))
    os.replace(tmp, out)
    key = source.name if k is None else f"{source.name} K={library_tag(k)}"
    BUILD_LOG[key] = {
        "seconds": time.perf_counter() - t0, "ptxas": proc.stderr.strip()}
    return out


def _ptxas_path(lib: Path) -> Path:
    return lib.with_name(lib.name + ".ptxas.txt")


def ptxas_log(k: int) -> str:
    """The ``ptxas -v`` report of the K library (WIDE: the wide one; built
    now if it is not yet), kept beside it in the build directory."""
    return _ptxas_path(build(EXACT_SOURCE, k)).read_text()


def single_ptxas_log(source: Path) -> str:
    """The ``ptxas -v`` report of the library of ``source``, one of
    SINGLE_SOURCES (built now if it is not yet)."""
    return _ptxas_path(build(source, None)).read_text()


LIBRARIES = (*SWEEP_KS, WIDE)   # the sweep's libraries build_all builds
# the libraries of one source each (no -DRTT_SWEEP_K), beside the sweep's
SINGLE_SOURCES = (VITERBI_SOURCE, LATTICE_SOURCE, GRID_SOURCE)


def build_all() -> None:
    """Build every library now (each K of SWEEP_KS, the wide one, the
    Viterbi's, the lattice's and the grid's), one ``nvcc`` each, all
    started together."""
    jobs = [(EXACT_SOURCE, k) for k in LIBRARIES] + \
        [(src, None) for src in SINGLE_SOURCES]
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        list(pool.map(lambda job: build(*job), jobs))


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
    running lists of the wide library's scratch instance (past the arm's
    shared-memory K, ``dense_candidates.list_plan``) and is required
    there; every other instance takes None."""
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
    """The ring-fed sweep's launch shape at top-K width k (a K of
    SWEEP_KS, or any k past them: the shape of the wide instance that
    serves k, whose shared memory and CTAs per SM follow k) on ``device``
    (``cuda``: the current one): threads per CTA, dynamic shared memory
    (bytes), resident CTAs per SM, SMs, the ring's depth (stages) and the
    columns per early-exit test of the arm's gate (0 for block and
    sub)."""
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


_single: "dict[str, ctypes.CDLL]" = {}


def _single_lib(source: Path, signatures: dict) -> ctypes.CDLL:
    """The library of ``source`` (built at first use), its functions'
    ctypes signatures set from ``signatures`` (name → argtypes; each
    returns an int)."""
    with _lock:
        if source.name not in _single:
            lib = ctypes.CDLL(str(build(source, None)))
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _single[source.name] = lib
        return _single[source.name]


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_VITERBI_SIGNATURES = {
    "rtt_viterbi_decode": [_P] * 10 + [_I] * 10 + [_F] * 5 + [_I, _F]
                          + [_P] * 6 + [_P],
}
_LATTICE_SIGNATURES = {
    "rtt_lattice_keep": [_P, _P, _I, _I, _F, _P, _P],
    "rtt_lattice_forward_smem": [_I, _I],
    "rtt_lattice_forward": [_P] * 4 + [_I] * 5 + [_P] * 4 + [_P],
    "rtt_lattice_backtrack": [_P] * 5 + [_I] * 4 + [_P, _P],
}
_GRID_SIGNATURES = {
    "rtt_grid_candidates": [_P, _P] + [_I] * 5 + [_F] * 4 + [_P] * 4 + [_P],
}


def _viterbi_lib() -> ctypes.CDLL:
    # VITERBI_SOURCE read at the call: scripts/viterbi_profile.py points it
    # at an instrumented copy
    return _single_lib(VITERBI_SOURCE, _VITERBI_SIGNATURES)


def launch_viterbi(ce, co, cd, cv, pts, vp, edge_len, reach_row, reach_to,
                   reach_dist, plan: dict, em_denom: float, beta: float,
                   factor: float, breakage: float, slack: float,
                   use_keep: bool, interp: float, scratch, choice, edge,
                   offset, start, matched) -> None:
    """One launch of viterbi.cu's decode over the batch (cands ``ce``
    [B, T, K]) on the current stream of the tensors' device, with that
    device current, as ``plan`` (``ops/hmm.viterbi_plan``) lays it out:
    ``traces_per_cta`` traces of ``threads_per_trace`` threads a CTA, the
    recurrence on ``recurrence_threads`` of them, chunks of ``chunk``
    steps, the levels in shared memory or in ``scratch``, ``smem_bytes``
    a CTA (the kernel refuses a figure that is not its layout's, and the
    wrapper raises). The float arguments are Python floats, rounded once to
    f32 as the plain version's 0-d tensors are (``em_denom`` is 2
    sigma_z^2 in double, ``interp`` the interpolation distance, squared
    here in f32). The caller checks the tensors and allocates ``scratch``
    (u8 [plan's scratch_bytes], None where the levels stay in shared
    memory) and the five outputs."""
    B, T, K = (int(x) for x in ce.shape)
    lib = _viterbi_lib()
    with _on_device(ce.device):
        rc = lib.rtt_viterbi_decode(
            ce.data_ptr(), co.data_ptr(), cd.data_ptr(), cv.data_ptr(),
            pts.data_ptr(), vp.data_ptr(), edge_len.data_ptr(),
            reach_row.data_ptr(), reach_to.data_ptr(), reach_dist.data_ptr(),
            B, T, K, int(reach_to.shape[1]), int(plan["threads_per_trace"]),
            int(plan["traces_per_cta"]), int(plan["recurrence_threads"]),
            int(plan["chunk"]), int(plan["levels"] == "shared"),
            int(plan["smem_bytes"]),
            *(float(x) for x in (em_denom, beta, factor, breakage, slack)),
            int(use_keep), _f32_square(float(interp)), _ptr(scratch),
            choice.data_ptr(), edge.data_ptr(), offset.data_ptr(),
            start.data_ptr(), matched.data_ptr(), _stream(ce))
    if rc != 0:
        raise RuntimeError(f"viterbi_decode launch failed (B={B}, T={T}, "
                           f"K={K}): error {rc}")


def _f32_square(x: float) -> float:
    """f32(x) squared in f32, as the plain version's 0-d tensor ** 2."""
    import struct

    f = struct.unpack("f", struct.pack("f", x))[0]
    return struct.unpack("f", struct.pack("f", f * f))[0]


def _expect(what: str, checks) -> None:
    """Raise ValueError unless each (name, tensor, dtype, shape) has that
    dtype and shape and is contiguous, then unless all lie on one card."""
    for name, t, dtype, shape in checks:
        if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
                or not t.is_contiguous():
            raise ValueError(f"{what}: expected {name} as a contiguous "
                             f"{dtype} {tuple(shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    dev = checks[0][1].device
    for name, t, _, _ in checks:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{what}: expected {name} on the card of "
                             f"{checks[0][0]} ({dev}), got {t.device}")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: error {rc}")


def launch_lattice_keep(pts, vp, interp: float, keep) -> None:
    """One launch of lattice.cu's keep-mask kernel (a thread a trace) on
    the current stream of the tensors' card: pts f32 [B, T, 2], vp bool
    [B, T] → keep bool [B, T]; ``interp`` the interpolation distance,
    squared here in f32."""
    import torch

    if pts.dim() != 3:
        raise ValueError(f"the keep-mask kernel: expected pts [B, T, 2], "
                         f"got {tuple(pts.shape)}")
    B, T = int(pts.shape[0]), int(pts.shape[1])
    _expect("the keep-mask kernel",
            [("pts", pts, torch.float32, (B, T, 2)),
             ("valid_pt", vp, torch.bool, (B, T)),
             ("keep", keep, torch.bool, (B, T))])
    if B == 0 or T == 0:
        return
    lib = _single_lib(LATTICE_SOURCE, _LATTICE_SIGNATURES)
    with _on_device(pts.device):
        rc = lib.rtt_lattice_keep(pts.data_ptr(), vp.data_ptr(), B, T,
                                  _f32_square(float(interp)),
                                  keep.data_ptr(), _stream(pts))
    _raise_on(rc, f"lattice keep mask (B={B}, T={T})")


def lattice_forward_smem(K: int, R: int, device="cuda") -> int:
    """The forward kernel's own shared bytes at (K, R) (-1 for a shape it
    does not take): what ``ops/hmm.lattice_smem_bytes`` is held to."""
    lib = _single_lib(LATTICE_SOURCE, _LATTICE_SIGNATURES)
    with _on_device(device):
        return int(lib.rtt_lattice_forward_smem(int(K), int(R)))


def launch_lattice_forward(em, active, prev_any, trans, R: int, plan: dict,
                           scores, backptrs, started, own) -> None:
    """One launch of lattice.cu's forward kernel (one CTA of the plan's
    ``threads`` with its ``smem_bytes``; ``ops/hmm.lattice_plan``) on the
    current stream of the tensors' card: em f32 [T, K], active and
    prev_any bool [T], trans f32 [T, K, K] → scores f32 [T, K * R],
    backptrs i32 [T, K * R], started bool [T], own i32 [T]. The kernel
    refuses shared bytes that are not its layout's (the wrapper raises)."""
    import torch

    if em.dim() != 2:
        raise ValueError(f"the lattice forward kernel: expected em [T, K], "
                         f"got {tuple(em.shape)}")
    T, K = (int(x) for x in em.shape)
    R = int(R)
    _expect("the lattice forward kernel",
            [("em", em, torch.float32, (T, K)),
             ("active", active, torch.bool, (T,)),
             ("prev_any", prev_any, torch.bool, (T,)),
             ("trans", trans, torch.float32, (T, K, K)),
             ("scores", scores, torch.float32, (T, K * R)),
             ("backptrs", backptrs, torch.int32, (T, K * R)),
             ("started", started, torch.bool, (T,)),
             ("own", own, torch.int32, (T,))])
    lib = _single_lib(LATTICE_SOURCE, _LATTICE_SIGNATURES)
    with _on_device(em.device):
        rc = lib.rtt_lattice_forward(
            em.data_ptr(), active.data_ptr(), prev_any.data_ptr(),
            trans.data_ptr(), T, K, R, int(plan["threads"]),
            int(plan["smem_bytes"]), scores.data_ptr(), backptrs.data_ptr(),
            started.data_ptr(), own.data_ptr(), _stream(em))
    _raise_on(rc, f"lattice forward (T={T}, K={K}, R={R})")


def launch_lattice_backtrack(backptrs, started, active, own, seed, threads,
                             out) -> None:
    """One launch of lattice.cu's backtrack kernel (a path a thread, CTAs
    of ``threads``) on the current stream of the tensors' card: backptrs
    i32 [T, S], started and active bool [T], own i32 [T], seed i32 [P]
    (each path's state at the last level, in [-1, S)) → out i32 [P, T]."""
    import torch

    if backptrs.dim() != 2 or seed.dim() != 1:
        raise ValueError(f"the lattice backtrack kernel: expected backptrs "
                         f"[T, S] and seed [P], got {tuple(backptrs.shape)} "
                         f"and {tuple(seed.shape)}")
    T, S = (int(x) for x in backptrs.shape)
    P = int(seed.shape[0])
    _expect("the lattice backtrack kernel",
            [("backptrs", backptrs, torch.int32, (T, S)),
             ("started", started, torch.bool, (T,)),
             ("active", active, torch.bool, (T,)),
             ("own", own, torch.int32, (T,)),
             ("seed", seed, torch.int32, (P,)),
             ("out", out, torch.int32, (P, T))])
    if P == 0 or T == 0:
        return
    lib = _single_lib(LATTICE_SOURCE, _LATTICE_SIGNATURES)
    with _on_device(backptrs.device):
        rc = lib.rtt_lattice_backtrack(
            backptrs.data_ptr(), started.data_ptr(), active.data_ptr(),
            own.data_ptr(), seed.data_ptr(), T, S, P, int(threads),
            out.data_ptr(), _stream(backptrs))
    _raise_on(rc, f"lattice backtrack (T={T}, S={S}, P={P})")


def launch_grid(pts, pack, ox: float, oy: float, cell: float, gw: int,
                gh: int, radius: float, edge, offset, dist, valid) -> None:
    """One launch of grid.cu's kernel (a warp a point) on the current
    stream of the tensors' card: pts f32 [N, 2] and the grid's cell_pack
    f32 [gw * gh, 8 * C] → edge i32, offset f32, dist f32, valid bool,
    each [N, K]. The float arguments are Python floats, rounded once to
    f32 as the plain version's 0-d tensors are."""
    import torch

    if pack.dim() != 2 or pack.shape[1] % 8 or edge.dim() != 2:
        raise ValueError(f"the grid kernel: expected cell_pack [cells, 8 * "
                         f"C] and edge [N, K], got {tuple(pack.shape)} and "
                         f"{tuple(edge.shape)}")
    N, K = (int(x) for x in edge.shape)
    C = int(pack.shape[1]) // 8
    if K < 1 or C < 1:
        raise ValueError(f"the grid kernel takes K >= 1 and C >= 1, got "
                         f"K={K}, C={C}")
    _expect("the grid kernel",
            [("pts", pts, torch.float32, (N, 2)),
             ("cell_pack", pack, torch.float32, (int(gw) * int(gh), 8 * C)),
             ("edge", edge, torch.int32, (N, K)),
             ("offset", offset, torch.float32, (N, K)),
             ("dist", dist, torch.float32, (N, K)),
             ("valid", valid, torch.bool, (N, K))])
    if N == 0:
        return
    lib = _single_lib(GRID_SOURCE, _GRID_SIGNATURES)
    with _on_device(pts.device):
        rc = lib.rtt_grid_candidates(
            pts.data_ptr(), pack.data_ptr(), N, C, K, int(gw), int(gh),
            float(ox), float(oy), float(cell), float(radius),
            edge.data_ptr(), offset.data_ptr(), dist.data_ptr(),
            valid.data_ptr(), _stream(pts))
    _raise_on(rc, f"grid candidates (N={N}, C={C}, K={K})")
