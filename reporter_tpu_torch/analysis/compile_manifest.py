"""The port's pinned compile universe: the CUDA sweep's instances, their
launch shapes and ptxas budgets, and the static HBM bound.

Counterpart: reporter_tpu/analysis/compile_manifest.py, which pins the
JAX package's jit shapes and its Pallas kernel's SMEM. The port compiles
``kernels/sweep_exact.cu`` once per K of ``kernels/build.SWEEP_KS`` and
once as the wide library (``build.WIDE``, named ``wide``: its K a run-time
argument), the five arms of ``ops.dense_candidates.SWEEP_ARMS`` in each
library, and this module pins, per instance (arm, K or ``wide``):

- the launch shape ``build.exact_shape`` reports (threads, dynamic
  shared memory, CTAs per SM, ring depth, gate group; the SM count is the
  card's and is left out), the wide library's at ``WIDE_PIN_K``, since
  its shared memory follows K;
- from the ``ptxas -v`` report kept beside each library
  (``build.ptxas_log``): each kernel's registers and static shared
  memory, and 0 spill bytes (``SPILL_WAIVERS``: the dated exceptions);

and the libraries of one source each (``SINGLE_LIBRARIES``): the batched
Viterbi decode's (``kernels/viterbi.cu``, K a run-time argument:
``viterbi_decode_kernel`` up to ``ops/hmm.VITERBI_MAX_K``, past it the
wide kernel's instances 1 and 2), the ranked-path lattice's (``kernels/lattice.cu``: its
keep-mask kernel, the forward kernel's seven shared instances by tree
depth up to ``ops/hmm.LATTICE_MAX_K`` and its wide instance past it, the
backtrack's ring kernel and its in-place one) and the grid
candidates' (``kernels/grid.cu``): each kernel's ptxas figures under
``ptxas.<the library>``, 0 spill bytes unless waived (keyed by (kernel,
the library)), and the source and the shared instances' K ceiling in the
host half;

beside the host constants the instances depend on (the K set, the arms,
the nvcc flags, the staged layout version and keys) and the HBM half:
``hbm_findings(ts)`` holds ``tiles/capacity.dense_staged_bytes`` to the
bytes ``tables_from_numpy`` stages (on a real tiny tileset), and bounds
the envelope metro by the capacity budget and the budget by the H100's
80 GB.

``compute_manifest(device)`` derives the universe; ``GOLDEN`` is the
committed copy. Both run on ``cuda`` unless the caller asks for the CPU
(without a card ``cuda`` raises). On the CPU ``check`` compares the host
half and the golden block's self-consistency (every instance has its
launch shape and its ptxas figures, no spill); on a card (chip_smoke.py's
``[analysis:manifest]``) the whole of it. Intentional changes regenerate
the block on a card with::

    python -m reporter_tpu_torch.analysis --update-manifest
"""

from __future__ import annotations

import re
from typing import Any

__all__ = ["compute_manifest", "GOLDEN", "check", "diff", "hbm_findings",
           "update_golden", "ptxas_figures", "kernel_name", "CARD_SECTIONS",
           "H100_HBM_BYTES", "SINGLE_LIBRARIES"]

# the size envelope the HBM bound holds: the JAX package's (generous
# multiples of the largest benched metro)
ENVELOPE = {
    "line_segments": 2_000_000,
    "directed_edges": 1_000_000,
    "nodes": 500_000,
    "reach_max": 128,
}
H100_HBM_BYTES = 80 * 10**9
# the wide library's launch shape follows K (its shared-memory lists): its
# rows are pinned at the K that chip_smoke.py's main path runs it at
WIDE_PIN_K = 32
# the Viterbi library's key in the ptxas section and in SPILL_WAIVERS
VITERBI_LIBRARY = "viterbi"
# the Viterbi's instance 0 (K up to 64); the wide kernel's <1> and <2>
# past it
VITERBI_KERNEL = "viterbi_decode_kernel"
LATTICE_LIBRARY = "lattice"
GRID_LIBRARY = "grid"
# the libraries of one source each: key → the kernels each must hold
SINGLE_LIBRARIES = {
    VITERBI_LIBRARY: (VITERBI_KERNEL, "viterbi_decode_wide_kernel<1>",
                      "viterbi_decode_wide_kernel<2>"),
    LATTICE_LIBRARY: ("lattice_keep_kernel",
                      # the forward's instances: <0> at R = 1, <L> the
                      # loser tree of 2^L leaves at R > 1, <-1> the wide
                      # one past K = 64
                      *(f"lattice_forward_kernel<{lg}>"
                        for lg in range(-1, 7)),
                      # the backtrack's ring and its levels read in
                      # place
                      "lattice_backtrack_kernel",
                      "lattice_backtrack_global_kernel"),
    GRID_LIBRARY: ("grid_candidates_kernel",),
}
# sections only a card can compute (nvcc's report, the launch shape query)
CARD_SECTIONS = ("launch", "ptxas")

# (kernel, K) → dated reason: the instances whose ptxas report has spill
# bytes, pinned here at the golden block's figures (any change is drift);
# K is the library's key (build.WIDE, 0, for the wide library)
_SPILL_WHY = ("2026-10-17 ptxas caps this instance at 72 or 96 registers "
              "for its occupancy (3 or 2 CTAs of 288 threads per SM) and "
              "spills a few bytes; the served K = 8 instances do not. "
              "Open in ROADMAP queue 3 (sweep spills at K = 4, 6, 12); its "
              "cost is not measured")
SPILL_WAIVERS = {
    ("lattice_forward_kernel<-1>", LATTICE_LIBRARY): (
        "2026-10-19 the wide forward (K > 64), 512 threads a CTA, so at "
        "most 128 registers: with its merge a code path a tree depth "
        "(wide_column<LOG>, reached through one call) ptxas spills 640 / "
        "1,492 bytes, and its R = 1 path ran slower than before that "
        "change (PERF.md); a kernel a path (R = 1 apart from the "
        "trees) is ROADMAP queue 2's item 15"),
    ("sweep_exact_kernel<2,4>", 4): _SPILL_WHY,
    ("sweep_exact_kernel<3,4>", 4): _SPILL_WHY,
    ("sweep_exact_kernel<1,6>", 6): _SPILL_WHY,
    ("sweep_exact_kernel<4,6>", 6): _SPILL_WHY,
    ("sweep_exact_kernel<2,12>", 12): _SPILL_WHY,
    ("sweep_exact_kernel<3,12>", 12): _SPILL_WHY,
    ("sweep_exact_kernel<3,0>", 0): (
        "2026-10-18 the wide shared-memory instance's mxu arm: ptxas "
        "holds it to 72 registers (room for 3 CTAs of 288 threads per SM, "
        "though its shared memory admits 1) and spills 16 / 20 bytes, "
        "down from PR 19's global-list instance's 24 / 32; its cost is "
        "not measured (ROADMAP queue 3, the sweep's spills)"),
}


def kernel_name(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled name: the
    innermost length-prefixed identifier that ends in "_kernel" (a hash's
    digits may run into its length), then its ILi..E arguments (e.g.
    sweep_exact_kernel<3,8>, or sweep_exact_kernel<3,-1> for Lin1E)."""
    found = None
    for m in re.finditer(r"\d+", mangled):
        for i in range(len(m.group())):
            ident = mangled[m.end():m.end() + int(m.group()[i:])]
            if ident.endswith("_kernel") and ident[:1].isalpha() \
                    and (found is None or len(ident) < len(found)):
                found = ident
    if found is None:
        return mangled
    rest = mangled[mangled.rindex(found) + len(found):]
    args = re.findall(r"L[ib](n?\d+)E", rest.split("EEv")[0]) \
        if rest.startswith("I") else []
    # a negative literal mangles with an "n" (the scratch instance, K = -1)
    args = [a.replace("n", "-") for a in args]
    return found + (f"<{','.join(args)}>" if args else "")


def ptxas_figures(log: str) -> list:
    """Per kernel of a ptxas -v log: its name and template arguments,
    registers, static shared memory and spill bytes."""
    out = []
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            out.append({"kernel": kernel_name(m.group(1))})
            continue
        if not out:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out[-1].update(spill_stores=int(m.group(1)),
                           spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[-1]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            out[-1]["static_smem"] = int(sm.group(1)) if sm else 0
    return out


def _ptxas_section(logs: "dict[int | str, str]") -> dict:
    """{"k<K>": {kernel: {registers, static_smem, spill_stores,
    spill_loads}}} from each library's ptxas report (keyed by K of
    SWEEP_KS, or WIDE: "kwide"; a library keyed by name, as "viterbi",
    under its name)."""
    from reporter_tpu_torch.kernels.build import library_tag

    out = {}
    for k, log in sorted(logs.items(), key=lambda kv: str(kv[0])):
        per = {}
        for fig in ptxas_figures(log):
            name = fig.pop("kernel")
            per[name] = {key: fig.get(key, 0) for key in (
                "registers", "static_smem", "spill_stores", "spill_loads")}
        out[k if isinstance(k, str) else f"k{library_tag(k)}"] = per
    return out


def compute_manifest(device="cuda") -> "dict[str, Any]":
    """The compile universe from the live constants; on a card (``cuda``,
    the default; raises without one) also its CARD_SECTIONS (builds every
    K library); on ``cpu`` the host half alone."""
    from reporter_tpu_torch.device import resolve_device
    from reporter_tpu_torch.kernels import build
    from reporter_tpu_torch.ops.dense_candidates import SWEEP_ARMS
    from reporter_tpu_torch.ops.hmm import LATTICE_MAX_K, VITERBI_MAX_K
    from reporter_tpu_torch.tiles import capacity, tileset

    out: "dict[str, Any]" = {
        "manifest_version": 1,
        "sweep_ks": list(build.SWEEP_KS),
        "arms": list(SWEEP_ARMS),
        "instances": [f"{a}@k{build.library_tag(k)}"
                      for k in build.LIBRARIES for a in SWEEP_ARMS],
        "nvcc_flags": list(build._NVCC_FLAGS),
        "viterbi": {"source": build.VITERBI_SOURCE.name,
                    "max_k": VITERBI_MAX_K},
        "lattice": {"source": build.LATTICE_SOURCE.name,
                    "max_k": LATTICE_MAX_K},
        "grid": {"source": build.GRID_SOURCE.name},
        "staged_tables": {
            "layout_version": tileset.STAGED_LAYOUT_VERSION,
            "dense_layout_keys": list(tileset._DENSE_LAYOUT_KEYS),
            "hbm_budget_bytes": capacity.DEFAULT_HBM_BUDGET,
            "card_hbm_bytes": H100_HBM_BYTES,
        },
        "envelope": dict(ENVELOPE),
    }
    if resolve_device(device).type != "cuda":
        return out
    build.build_all()
    out["ptxas"] = _ptxas_section({
        **{k: build.ptxas_log(k) for k in build.LIBRARIES},
        **{lib: build.single_ptxas_log(src) for lib, src in (
            (VITERBI_LIBRARY, build.VITERBI_SOURCE),
            (LATTICE_LIBRARY, build.LATTICE_SOURCE),
            (GRID_LIBRARY, build.GRID_SOURCE))}})
    launch = {}
    for k in build.LIBRARIES:
        for code, arm in enumerate(SWEEP_ARMS):
            sh = build.exact_shape(code, WIDE_PIN_K if k == build.WIDE else k,
                                   device)
            sh.pop("sms")
            launch[f"{arm}@k{build.library_tag(k)}"] = sh
    out["launch"] = launch
    return out


# --- BEGIN GOLDEN MANIFEST (generated; do not hand-edit: run
#     `python -m reporter_tpu_torch.analysis --update-manifest` on a card) ---
GOLDEN: "dict[str, Any]" = \
{'arms': ['block', 'sub', 'sub_bf16', 'mxu', 'mxu_bf16'],
 'envelope': {'directed_edges': 1000000,
              'line_segments': 2000000,
              'nodes': 500000,
              'reach_max': 128},
 'grid': {'source': 'grid.cu'},
 'instances': ['block@k4',
               'sub@k4',
               'sub_bf16@k4',
               'mxu@k4',
               'mxu_bf16@k4',
               'block@k6',
               'sub@k6',
               'sub_bf16@k6',
               'mxu@k6',
               'mxu_bf16@k6',
               'block@k8',
               'sub@k8',
               'sub_bf16@k8',
               'mxu@k8',
               'mxu_bf16@k8',
               'block@k12',
               'sub@k12',
               'sub_bf16@k12',
               'mxu@k12',
               'mxu_bf16@k12',
               'block@k16',
               'sub@k16',
               'sub_bf16@k16',
               'mxu@k16',
               'mxu_bf16@k16',
               'block@kwide',
               'sub@kwide',
               'sub_bf16@kwide',
               'mxu@kwide',
               'mxu_bf16@kwide'],
 'lattice': {'max_k': 64, 'source': 'lattice.cu'},
 'launch': {'block@k12': {'ctas_per_sm': 2,
                          'depth': 4,
                          'gate_group': 0,
                          'smem_bytes': 65920,
                          'threads': 288},
            'block@k16': {'ctas_per_sm': 1,
                          'depth': 4,
                          'gate_group': 0,
                          'smem_bytes': 65920,
                          'threads': 288},
            'block@k4': {'ctas_per_sm': 3,
                         'depth': 4,
                         'gate_group': 0,
                         'smem_bytes': 65920,
                         'threads': 288},
            'block@k6': {'ctas_per_sm': 3,
                         'depth': 4,
                         'gate_group': 0,
                         'smem_bytes': 65920,
                         'threads': 288},
            'block@k8': {'ctas_per_sm': 2,
                         'depth': 4,
                         'gate_group': 0,
                         'smem_bytes': 65920,
                         'threads': 288},
            'block@kwide': {'ctas_per_sm': 1,
                            'depth': 4,
                            'gate_group': 0,
                            'smem_bytes': 164224,
                            'threads': 288},
            'mxu@k12': {'ctas_per_sm': 2,
                        'depth': 3,
                        'gate_group': 32,
                        'smem_bytes': 98688,
                        'threads': 288},
            'mxu@k16': {'ctas_per_sm': 1,
                        'depth': 3,
                        'gate_group': 32,
                        'smem_bytes': 98688,
                        'threads': 288},
            'mxu@k4': {'ctas_per_sm': 2,
                       'depth': 3,
                       'gate_group': 32,
                       'smem_bytes': 98688,
                       'threads': 288},
            'mxu@k6': {'ctas_per_sm': 2,
                       'depth': 3,
                       'gate_group': 32,
                       'smem_bytes': 98688,
                       'threads': 288},
            'mxu@k8': {'ctas_per_sm': 2,
                       'depth': 3,
                       'gate_group': 32,
                       'smem_bytes': 98688,
                       'threads': 288},
            'mxu@kwide': {'ctas_per_sm': 1,
                          'depth': 3,
                          'gate_group': 32,
                          'smem_bytes': 196992,
                          'threads': 288},
            'mxu_bf16@k12': {'ctas_per_sm': 2,
                             'depth': 4,
                             'gate_group': 32,
                             'smem_bytes': 98816,
                             'threads': 288},
            'mxu_bf16@k16': {'ctas_per_sm': 1,
                             'depth': 4,
                             'gate_group': 32,
                             'smem_bytes': 98816,
                             'threads': 288},
            'mxu_bf16@k4': {'ctas_per_sm': 2,
                            'depth': 4,
                            'gate_group': 32,
                            'smem_bytes': 98816,
                            'threads': 288},
            'mxu_bf16@k6': {'ctas_per_sm': 2,
                            'depth': 4,
                            'gate_group': 32,
                            'smem_bytes': 98816,
                            'threads': 288},
            'mxu_bf16@k8': {'ctas_per_sm': 2,
                            'depth': 4,
                            'gate_group': 32,
                            'smem_bytes': 98816,
                            'threads': 288},
            'mxu_bf16@kwide': {'ctas_per_sm': 1,
                               'depth': 4,
                               'gate_group': 32,
                               'smem_bytes': 197120,
                               'threads': 288},
            'sub@k12': {'ctas_per_sm': 2,
                        'depth': 4,
                        'gate_group': 0,
                        'smem_bytes': 65920,
                        'threads': 288},
            'sub@k16': {'ctas_per_sm': 1,
                        'depth': 4,
                        'gate_group': 0,
                        'smem_bytes': 65920,
                        'threads': 288},
            'sub@k4': {'ctas_per_sm': 3,
                       'depth': 4,
                       'gate_group': 0,
                       'smem_bytes': 65920,
                       'threads': 288},
            'sub@k6': {'ctas_per_sm': 3,
                       'depth': 4,
                       'gate_group': 0,
                       'smem_bytes': 65920,
                       'threads': 288},
            'sub@k8': {'ctas_per_sm': 2,
                       'depth': 4,
                       'gate_group': 0,
                       'smem_bytes': 65920,
                       'threads': 288},
            'sub@kwide': {'ctas_per_sm': 1,
                          'depth': 4,
                          'gate_group': 0,
                          'smem_bytes': 164224,
                          'threads': 288},
            'sub_bf16@k12': {'ctas_per_sm': 2,
                             'depth': 4,
                             'gate_group': 8,
                             'smem_bytes': 86464,
                             'threads': 288},
            'sub_bf16@k16': {'ctas_per_sm': 1,
                             'depth': 4,
                             'gate_group': 8,
                             'smem_bytes': 86464,
                             'threads': 288},
            'sub_bf16@k4': {'ctas_per_sm': 2,
                            'depth': 4,
                            'gate_group': 8,
                            'smem_bytes': 86464,
                            'threads': 288},
            'sub_bf16@k6': {'ctas_per_sm': 2,
                            'depth': 4,
                            'gate_group': 8,
                            'smem_bytes': 86464,
                            'threads': 288},
            'sub_bf16@k8': {'ctas_per_sm': 2,
                            'depth': 4,
                            'gate_group': 8,
                            'smem_bytes': 86464,
                            'threads': 288},
            'sub_bf16@kwide': {'ctas_per_sm': 1,
                               'depth': 4,
                               'gate_group': 8,
                               'smem_bytes': 184768,
                               'threads': 288}},
 'manifest_version': 1,
 'nvcc_flags': ['-gencode',
                'arch=compute_90a,code=sm_90a',
                '-std=c++17',
                '-O3',
                '-shared',
                '-Xcompiler',
                '-fPIC',
                '-fmad=false',
                '-prec-div=true',
                '-prec-sqrt=true',
                '-Xptxas',
                '-v'],
 'ptxas': {'grid': {'grid_candidates_kernel': {'registers': 40,
                                               'spill_loads': 0,
                                               'spill_stores': 0,
                                               'static_smem': 0}},
           'k12': {'chunk_order_kernel': {'registers': 16,
                                          'spill_loads': 0,
                                          'spill_stores': 0,
                                          'static_smem': 1024},
                   'sweep_exact_kernel<0,12>': {'registers': 90,
                                                'spill_loads': 0,
                                                'spill_stores': 0,
                                                'static_smem': 0},
                   'sweep_exact_kernel<1,12>': {'registers': 96,
                                                'spill_loads': 0,
                                                'spill_stores': 0,
                                                'static_smem': 0},
                   'sweep_exact_kernel<2,12>': {'registers': 96,
                                                'spill_loads': 88,
                                                'spill_stores': 40,
                                                'static_smem': 0},
                   'sweep_exact_kernel<3,12>': {'registers': 96,
                                                'spill_loads': 20,
                                                'spill_stores': 16,
                                                'static_smem': 0},
                   'sweep_exact_kernel<4,12>': {'registers': 96,
                                                'spill_loads': 0,
                                                'spill_stores': 0,
                                                'static_smem': 0}},
           'k16': {'chunk_order_kernel': {'registers': 16,
                                          'spill_loads': 0,
                                          'spill_stores': 0,
                                          'static_smem': 1024},
                   'sweep_exact_kernel<0,16>': {'registers': 108,
                                                'spill_loads': 0,
                                                'spill_stores': 0,
                                                'static_smem': 0},
                   'sweep_exact_kernel<1,16>': {'registers': 114,
                                                'spill_loads': 0,
                                                'spill_stores': 0,
                                                'static_smem': 0},
                   'sweep_exact_kernel<2,16>': {'registers': 122,
                                                'spill_loads': 0,
                                                'spill_stores': 0,
                                                'static_smem': 0},
                   'sweep_exact_kernel<3,16>': {'registers': 117,
                                                'spill_loads': 0,
                                                'spill_stores': 0,
                                                'static_smem': 0},
                   'sweep_exact_kernel<4,16>': {'registers': 117,
                                                'spill_loads': 0,
                                                'spill_stores': 0,
                                                'static_smem': 0}},
           'k4': {'chunk_order_kernel': {'registers': 16,
                                         'spill_loads': 0,
                                         'spill_stores': 0,
                                         'static_smem': 1024},
                  'sweep_exact_kernel<0,4>': {'registers': 66,
                                              'spill_loads': 0,
                                              'spill_stores': 0,
                                              'static_smem': 0},
                  'sweep_exact_kernel<1,4>': {'registers': 72,
                                              'spill_loads': 0,
                                              'spill_stores': 0,
                                              'static_smem': 0},
                  'sweep_exact_kernel<2,4>': {'registers': 72,
                                              'spill_loads': 64,
                                              'spill_stores': 32,
                                              'static_smem': 0},
                  'sweep_exact_kernel<3,4>': {'registers': 72,
                                              'spill_loads': 20,
                                              'spill_stores': 16,
                                              'static_smem': 0},
                  'sweep_exact_kernel<4,4>': {'registers': 72,
                                              'spill_loads': 0,
                                              'spill_stores': 0,
                                              'static_smem': 0}},
           'k6': {'chunk_order_kernel': {'registers': 16,
                                         'spill_loads': 0,
                                         'spill_stores': 0,
                                         'static_smem': 1024},
                  'sweep_exact_kernel<0,6>': {'registers': 72,
                                              'spill_loads': 0,
                                              'spill_stores': 0,
                                              'static_smem': 0},
                  'sweep_exact_kernel<1,6>': {'registers': 72,
                                              'spill_loads': 44,
                                              'spill_stores': 16,
                                              'static_smem': 0},
                  'sweep_exact_kernel<2,6>': {'registers': 92,
                                              'spill_loads': 0,
                                              'spill_stores': 0,
                                              'static_smem': 0},
                  'sweep_exact_kernel<3,6>': {'registers': 84,
                                              'spill_loads': 0,
                                              'spill_stores': 0,
                                              'static_smem': 0},
                  'sweep_exact_kernel<4,6>': {'registers': 72,
                                              'spill_loads': 32,
                                              'spill_stores': 24,
                                              'static_smem': 0}},
           'k8': {'chunk_order_kernel': {'registers': 16,
                                         'spill_loads': 0,
                                         'spill_stores': 0,
                                         'static_smem': 1024},
                  'sweep_exact_kernel<0,8>': {'registers': 79,
                                              'spill_loads': 0,
                                              'spill_stores': 0,
                                              'static_smem': 0},
                  'sweep_exact_kernel<1,8>': {'registers': 85,
                                              'spill_loads': 0,
                                              'spill_stores': 0,
                                              'static_smem': 0},
                  'sweep_exact_kernel<2,8>': {'registers': 96,
                                              'spill_loads': 0,
                                              'spill_stores': 0,
                                              'static_smem': 0},
                  'sweep_exact_kernel<3,8>': {'registers': 90,
                                              'spill_loads': 0,
                                              'spill_stores': 0,
                                              'static_smem': 0},
                  'sweep_exact_kernel<4,8>': {'registers': 87,
                                              'spill_loads': 0,
                                              'spill_stores': 0,
                                              'static_smem': 0}},
           'kwide': {'chunk_order_kernel': {'registers': 16,
                                            'spill_loads': 0,
                                            'spill_stores': 0,
                                            'static_smem': 1024},
                     'sweep_exact_kernel<0,-1>': {'registers': 72,
                                                  'spill_loads': 0,
                                                  'spill_stores': 0,
                                                  'static_smem': 0},
                     'sweep_exact_kernel<0,0>': {'registers': 65,
                                                 'spill_loads': 0,
                                                 'spill_stores': 0,
                                                 'static_smem': 0},
                     'sweep_exact_kernel<1,-1>': {'registers': 86,
                                                  'spill_loads': 0,
                                                  'spill_stores': 0,
                                                  'static_smem': 0},
                     'sweep_exact_kernel<1,0>': {'registers': 69,
                                                 'spill_loads': 0,
                                                 'spill_stores': 0,
                                                 'static_smem': 0},
                     'sweep_exact_kernel<2,-1>': {'registers': 90,
                                                  'spill_loads': 0,
                                                  'spill_stores': 0,
                                                  'static_smem': 0},
                     'sweep_exact_kernel<2,0>': {'registers': 72,
                                                 'spill_loads': 0,
                                                 'spill_stores': 0,
                                                 'static_smem': 0},
                     'sweep_exact_kernel<3,-1>': {'registers': 94,
                                                  'spill_loads': 0,
                                                  'spill_stores': 0,
                                                  'static_smem': 0},
                     'sweep_exact_kernel<3,0>': {'registers': 71,
                                                 'spill_loads': 20,
                                                 'spill_stores': 16,
                                                 'static_smem': 0},
                     'sweep_exact_kernel<4,-1>': {'registers': 90,
                                                  'spill_loads': 0,
                                                  'spill_stores': 0,
                                                  'static_smem': 0},
                     'sweep_exact_kernel<4,0>': {'registers': 72,
                                                 'spill_loads': 0,
                                                 'spill_stores': 0,
                                                 'static_smem': 0}},
           'lattice': {'lattice_backtrack_global_kernel': {'registers': 32,
                                                           'spill_loads': 0,
                                                           'spill_stores': 0,
                                                           'static_smem': 0},
                       'lattice_backtrack_kernel': {'registers': 64,
                                                    'spill_loads': 0,
                                                    'spill_stores': 0,
                                                    'static_smem': 0},
                       'lattice_forward_kernel<-1>': {'registers': 128,
                                                      'spill_loads': 1492,
                                                      'spill_stores': 640,
                                                      'static_smem': 0},
                       'lattice_forward_kernel<0>': {'registers': 107,
                                                     'spill_loads': 0,
                                                     'spill_stores': 0,
                                                     'static_smem': 0},
                       'lattice_forward_kernel<1>': {'registers': 107,
                                                     'spill_loads': 0,
                                                     'spill_stores': 0,
                                                     'static_smem': 0},
                       'lattice_forward_kernel<2>': {'registers': 107,
                                                     'spill_loads': 0,
                                                     'spill_stores': 0,
                                                     'static_smem': 0},
                       'lattice_forward_kernel<3>': {'registers': 107,
                                                     'spill_loads': 0,
                                                     'spill_stores': 0,
                                                     'static_smem': 0},
                       'lattice_forward_kernel<4>': {'registers': 107,
                                                     'spill_loads': 0,
                                                     'spill_stores': 0,
                                                     'static_smem': 0},
                       'lattice_forward_kernel<5>': {'registers': 150,
                                                     'spill_loads': 0,
                                                     'spill_stores': 0,
                                                     'static_smem': 0},
                       'lattice_forward_kernel<6>': {'registers': 126,
                                                     'spill_loads': 0,
                                                     'spill_stores': 0,
                                                     'static_smem': 0},
                       'lattice_keep_kernel': {'registers': 28,
                                               'spill_loads': 0,
                                               'spill_stores': 0,
                                               'static_smem': 36880}},
           'viterbi': {'viterbi_decode_kernel': {'registers': 109,
                                                 'spill_loads': 0,
                                                 'spill_stores': 0,
                                                 'static_smem': 0},
                       'viterbi_decode_wide_kernel<1>': {'registers': 128,
                                                         'spill_loads': 0,
                                                         'spill_stores': 0,
                                                         'static_smem': 0},
                       'viterbi_decode_wide_kernel<2>': {'registers': 128,
                                                         'spill_loads': 0,
                                                         'spill_stores': 0,
                                                         'static_smem': 0}}},
 'staged_tables': {'card_hbm_bytes': 80000000000,
                   'dense_layout_keys': ['seg_pack',
                                         'seg_bbox',
                                         'seg_sub',
                                         'seg_feat',
                                         'seg_sweep',
                                         'seg_coarse'],
                   'hbm_budget_bytes': 64424509440,
                   'layout_version': 3},
 'sweep_ks': [4, 6, 8, 12, 16],
 'viterbi': {'max_k': 64, 'source': 'viterbi.cu'}}
# --- END GOLDEN MANIFEST ---


def diff(golden: "dict | Any", computed: "dict | Any",
         path: str = "") -> "list[str]":
    """Flat list of drift descriptions (empty: pinned). Dropped keys and
    changed values both count."""
    out: "list[str]" = []
    if isinstance(golden, dict) and isinstance(computed, dict):
        for k in sorted(set(golden) | set(computed)):
            p = f"{path}.{k}" if path else str(k)
            if k not in computed:
                out.append(f"{p}: dropped from the computed universe "
                           f"(golden: {golden[k]!r})")
            elif k not in golden:
                out.append(f"{p}: new in the computed universe "
                           f"({computed[k]!r}), not in the golden manifest")
            else:
                out.extend(diff(golden[k], computed[k], p))
        return out
    if golden != computed:
        out.append(f"{path}: golden {golden!r} != computed {computed!r}")
    return out


def golden_findings(golden: "dict | None" = None) -> "list[str]":
    """The golden block's self-consistency: every instance has a launch
    shape, every K library and the wide one its ptxas figures with the
    sweep kernel at each arm, each of SINGLE_LIBRARIES its kernels', and
    no kernel spills outside SPILL_WAIVERS (keyed by K, build.WIDE or the
    library's key)."""
    from reporter_tpu_torch.kernels.build import WIDE, library_tag

    g = GOLDEN if golden is None else golden
    out: "list[str]" = []
    for sec in CARD_SECTIONS:
        if sec not in g:
            return [f"golden: no {sec!r} section (regenerate on a card)"]
    for inst in g.get("instances", ()):
        if inst not in g["launch"]:
            out.append(f"golden: instance {inst} has no launch shape")
    if sorted(g["launch"]) != sorted(g.get("instances", ())):
        out.append("golden: launch shapes and instances differ")
    for k in (*g.get("sweep_ks", ()), WIDE):
        per = g["ptxas"].get(f"k{library_tag(k)}")
        if not per:
            out.append(f"golden: no ptxas figures for K={library_tag(k)}")
            continue
        for code in range(len(g.get("arms", ()))):
            if not any(name.startswith("sweep_exact_kernel<")
                       and name.split("<")[1].split(",")[0].rstrip(">")
                       == str(code) for name in per):
                out.append(f"golden: K={library_tag(k)} has no "
                           f"sweep_exact_kernel of arm {code}")
        out.extend(_spill_findings(per, k, f"K={library_tag(k)}"))
    for lib, kernels in SINGLE_LIBRARIES.items():
        per = g["ptxas"].get(lib) or {}
        for kernel in kernels:
            if kernel not in per:
                out.append(f"golden: no ptxas figures for {kernel}")
        out.extend(_spill_findings(per, lib, lib))
    return out


def _spill_findings(per: dict, key, where: str) -> "list[str]":
    """A library's kernels that spill without a SPILL_WAIVERS entry
    (keyed by (kernel, the library's key))."""
    return [f"golden: {name} at {where} spills {fig['spill_stores']} / "
            f"{fig['spill_loads']} bytes"
            for name, fig in per.items()
            if (fig.get("spill_stores") or fig.get("spill_loads"))
            and (name, key) not in SPILL_WAIVERS]


def check(device="cuda", computed: "dict | None" = None) -> "list[str]":
    """Drift and budget problems, one string each: the host half of the
    manifest, the golden block's self-consistency and the HBM half; on a
    card (``cuda``, the default; raises without one) the whole manifest
    too. ``computed`` may be given (a manifest computed on that device)."""
    from reporter_tpu_torch.analysis.device_contract import _tiny_tileset
    from reporter_tpu_torch.device import resolve_device

    on_card = resolve_device(device).type == "cuda"
    if computed is None:
        computed = compute_manifest(device)
    golden = GOLDEN if on_card else {
        k: v for k, v in GOLDEN.items() if k not in CARD_SECTIONS}
    out = diff(golden, computed)
    out.extend(golden_findings())
    out.extend(hbm_findings(_tiny_tileset()))
    return out


def hbm_findings(ts) -> "list[str]":
    """capacity.dense_staged_bytes against the bytes the dense staging
    builds for ``ts``, then the envelope metro against the budget and the
    budget against the card."""
    import numpy as np

    from reporter_tpu_torch.ops import dense_candidates as dc
    from reporter_tpu_torch.tiles import capacity
    from reporter_tpu_torch.tiles.tileset import tables_from_numpy

    out: "list[str]" = []
    shardable, fixed = capacity.dense_staged_bytes(ts)
    tables = tables_from_numpy(ts.arrays(), "cpu")
    shard_keys = ("seg_pack", "seg_bbox", "seg_sub", "seg_feat",
                  "seg_sweep", "seg_coarse")
    fixed_keys = ("edge_len", "reach_row", "reach_to", "reach_dist")
    actual_shardable = sum(tables[k].nbytes for k in shard_keys)
    actual_fixed = sum(tables[k].nbytes for k in fixed_keys)
    if shardable != actual_shardable:
        out.append(f"hbm: capacity.dense_staged_bytes shardable formula "
                   f"({shardable} B) != bytes staged ({actual_shardable} "
                   f"B) for {ts.name!r}")
    if fixed != actual_fixed:
        out.append(f"hbm: capacity.dense_staged_bytes fixed formula "
                   f"({fixed} B) != bytes staged ({actual_fixed} B) for "
                   f"{ts.name!r}")
    extra = set(tables) - set(shard_keys) - set(fixed_keys)
    if extra:
        out.append(f"hbm: staged members {sorted(extra)} are in neither "
                   "share of capacity.dense_staged_bytes")
    # the envelope metro, by the same shape math (licensed by the
    # cross-check above)
    env = ENVELOPE
    spad = dc.packed_columns(np.full(env["line_segments"], 50.0, np.float32))
    nblocks = spad // dc._SBLK
    nsub = dc._SBLK // dc._SUB
    env_shardable = ((dc.SP_NCOMP + dc.SF_NCOMP + dc.SW_NCOMP) * spad
                     + nblocks * 4 * (1 + nsub) + nblocks * dc.CO_WORDS) * 4
    env_fixed = (env["directed_edges"] * (4 + 4)
                 + env["nodes"] * env["reach_max"] * (4 + 4))
    total = env_shardable + env_fixed
    if total > capacity.DEFAULT_HBM_BUDGET:
        out.append(f"hbm: the envelope metro stages {total} B replicated > "
                   f"the budget {capacity.DEFAULT_HBM_BUDGET} B")
    if capacity.DEFAULT_HBM_BUDGET > H100_HBM_BYTES:
        out.append(f"hbm: the budget {capacity.DEFAULT_HBM_BUDGET} B is "
                   f"past the card's {H100_HBM_BYTES} B")
    return out


_BEGIN = ("# --- BEGIN GOLDEN MANIFEST (generated; do not hand-edit: run\n"
          "#     `python -m reporter_tpu_torch.analysis --update-manifest` "
          "on a card) ---")
_END = "# --- END GOLDEN MANIFEST ---"


def render_golden(manifest: dict) -> str:
    import pprint

    body = pprint.pformat(manifest, width=72, sort_dicts=True)
    return f"{_BEGIN}\nGOLDEN: \"dict[str, Any]\" = \\\n{body}\n{_END}"


def update_golden(path: "str | None" = None, device: str = "cuda") -> str:
    """Rewrite this module's GOLDEN block from the live constants and the
    card's figures → the path written."""
    path = path or __file__
    with open(path) as f:
        src = f.read()
    lo = src.index(_BEGIN)
    hi = src.index(_END) + len(_END)
    block = render_golden(compute_manifest(device))
    with open(path, "w") as f:
        f.write(src[:lo] + block + src[hi:])
    return path
