"""The port's compile manifest (reporter_tpu_torch/analysis/
compile_manifest.py): the golden block is whole and self-consistent, its
host half equals the live constants, a synthetic ``ptxas -v`` report
parses to its figures, and a spill, an extra register or a changed
launch shape is caught against its clean twin. The card half (nvcc's
report and the launch query) is held on the card by chip_smoke.py's
[analysis:manifest]."""

import ast
import copy
import re

import pytest

from _torch_support import (  # noqa: F401  (the port's gate: first)
    _torch_gate, _torch_module_gate)
from reporter_tpu_torch.analysis import compile_manifest as cm
from reporter_tpu_torch.kernels.build import LIBRARIES, SWEEP_KS, library_tag
from reporter_tpu_torch.ops.dense_candidates import SWEEP_ARMS

_MANGLED = ("_ZN47_GLOBAL__N__7083e19d_14_sweep_exact_cu_fd8671dd18sweep_"
            "exact_kernelILi{arm}ELi{k}EEEvPK6float2PKiS5_S5_PiPK6float4S9_"
            "S5_iifffS6_PfSA_S6_i")
_ORDER = "_ZN47_GLOBAL__N__7083e19d_14_sweep_exact_cu_fd8671dd18chunk_order_" \
    "kernelEPKiiPi"
_VITERBI = "_ZN43_GLOBAL__N__c03b14fe_10_viterbi_cu_feaf2d0321viterbi_decode_" \
    "kernelENS_6ParamsE"
_NAMED = "_ZN43_GLOBAL__N__946154ed_10_lattice_cu_76bfdfbc{n}{name}EPKiPKhS3_"
_NAMED_T = ("_ZN43_GLOBAL__N__946154ed_10_lattice_cu_76bfdfbc{n}{name}I{args}E"
            "EvNS_9FwdParamsE")


def _named(kernel: str) -> str:
    """A kernel of SINGLE_LIBRARIES' mangled name as nvcc writes it: a
    template instance (``name<0>``) with its int arguments."""
    if "<" not in kernel:
        return _NAMED.format(n=len(kernel), name=kernel)
    name, args = kernel.rstrip(">").split("<")
    return _NAMED_T.format(n=len(name), name=name, args="".join(
        f"Li{a.replace('-', 'n')}E" for a in args.split(",")))


def _log(figures: dict, k: int) -> str:
    """A ptxas -v report in nvcc's format for the K library's figures."""
    out = ["ptxas info    : 0 bytes gmem"]
    for name, f in figures.items():
        if name.startswith("sweep_exact_kernel<"):
            # the instance's own K: the library's, or -1 (mangled "n1")
            # for the wide library's scratch instance
            arm, kk = name.split("<")[1].rstrip(">").split(",")
            mangled = _MANGLED.format(arm=arm, k=kk.replace("-", "n"))
        elif name == "chunk_order_kernel":
            mangled = _ORDER
        else:                      # a kernel of lattice.cu or grid.cu
            mangled = _named(name)
        out += [
            f"ptxas info    : Compiling entry function '{mangled}' for "
            "'sm_90a'",
            f"ptxas info    : Function properties for {mangled}",
            f"    0 bytes stack frame, {f['spill_stores']} bytes spill "
            f"stores, {f['spill_loads']} bytes spill loads",
            f"ptxas info    : Used {f['registers']} registers, used 1 "
            "barriers" + (f", {f['static_smem']} bytes smem"
                          if f["static_smem"] else ""),
            "ptxas info    : Compile time = 200.0 ms"]
    return "\n".join(out)


def _card_manifest(golden=None):
    """The manifest a card would compute, rebuilt from the golden block's
    figures through the parser (the clean twin)."""
    g = cm.GOLDEN if golden is None else golden
    man = cm.compute_manifest("cpu")
    man["ptxas"] = cm._ptxas_section(
        {**{k: _log(g["ptxas"][f"k{library_tag(k)}"], k) for k in LIBRARIES},
         **{lib: _log(g["ptxas"][lib], 0) for lib in cm.SINGLE_LIBRARIES}})
    man["launch"] = copy.deepcopy(g["launch"])
    return man


def test_the_golden_block_is_whole_and_self_consistent():
    assert cm.golden_findings() == []
    assert cm.GOLDEN["sweep_ks"] == list(SWEEP_KS)
    assert cm.GOLDEN["arms"] == list(SWEEP_ARMS)
    assert sorted(cm.GOLDEN["launch"]) == sorted(cm.GOLDEN["instances"])
    # every K of SWEEP_KS and the wide library (K = 0 in its names)
    assert len(cm.GOLDEN["instances"]) == len(LIBRARIES) * len(SWEEP_ARMS)
    for k in LIBRARIES:
        names = set(cm.GOLDEN["ptxas"][f"k{library_tag(k)}"])
        assert {f"sweep_exact_kernel<{a},{k}>"
                for a in range(len(SWEEP_ARMS))} <= names
    # the wide library's scratch instances (K = -1 in their names)
    assert {f"sweep_exact_kernel<{a},-1>" for a in range(len(SWEEP_ARMS))} \
        <= set(cm.GOLDEN["ptxas"]["kwide"])


def test_the_host_half_is_pinned_on_the_cpu():
    assert cm.check("cpu") == []


def test_spill_waivers_are_dated_and_name_golden_spills():
    for (name, k), why in cm.SPILL_WAIVERS.items():
        assert re.search(r"20\d\d-\d\d-\d\d", why)
        # a sweep library by its K, a library of one source by its name
        lib = k if isinstance(k, str) else f"k{library_tag(k)}"
        fig = cm.GOLDEN["ptxas"][lib][name]
        assert fig["spill_stores"] or fig["spill_loads"], (name, k)
    for k in (8,):                    # the served width spills nothing
        assert not any(f["spill_stores"] or f["spill_loads"]
                       for f in cm.GOLDEN["ptxas"][f"k{k}"].values())


def test_the_viterbi_kernel_is_pinned_without_spills():
    from reporter_tpu_torch.ops.hmm import VITERBI_MAX_K

    fig = cm.GOLDEN["ptxas"][cm.VITERBI_LIBRARY][cm.VITERBI_KERNEL]
    assert fig["registers"] > 0
    assert not (fig["spill_stores"] or fig["spill_loads"])
    assert cm.GOLDEN["viterbi"] == {"source": "viterbi.cu",
                                    "max_k": VITERBI_MAX_K}
    g = copy.deepcopy(cm.GOLDEN)
    g["ptxas"][cm.VITERBI_LIBRARY][cm.VITERBI_KERNEL]["spill_stores"] = 8
    assert any(cm.VITERBI_KERNEL in p and "spills" in p
               for p in cm.golden_findings(g))
    g["ptxas"][cm.VITERBI_LIBRARY][cm.VITERBI_KERNEL]["registers"] += 1
    assert any(cm.VITERBI_KERNEL in d
               for d in cm.diff(cm.GOLDEN, _card_manifest(g)))
    del g["ptxas"][cm.VITERBI_LIBRARY]
    assert any("no ptxas figures for viterbi" in p
               for p in cm.golden_findings(g))


@pytest.mark.parametrize("lib", [cm.LATTICE_LIBRARY, cm.GRID_LIBRARY])
def test_the_lattice_and_grid_kernels_are_pinned_without_spills(lib):
    """Each kernel of lattice.cu and grid.cu has its figures and no spill
    but where SPILL_WAIVERS names it (then its spill is pinned); a spill,
    an extra register and a missing library are caught."""
    from reporter_tpu_torch.ops.hmm import LATTICE_MAX_K

    assert cm.GOLDEN["lattice"] == {"source": "lattice.cu",
                                    "max_k": LATTICE_MAX_K}
    assert cm.GOLDEN["grid"] == {"source": "grid.cu"}
    kernels = cm.SINGLE_LIBRARIES[lib]
    for kernel in kernels:
        fig = cm.GOLDEN["ptxas"][lib][kernel]
        assert fig["registers"] > 0
        spills = bool(fig["spill_stores"] or fig["spill_loads"])
        assert spills == ((kernel, lib) in cm.SPILL_WAIVERS), kernel
        assert cm.kernel_name(_named(kernel)) == kernel
    g = copy.deepcopy(cm.GOLDEN)
    g["ptxas"][lib][kernels[0]]["spill_loads"] = 4
    assert any(kernels[0] in p and "spills" in p
               for p in cm.golden_findings(g))
    g["ptxas"][lib][kernels[-1]]["registers"] += 1
    assert any(kernels[-1] in d
               for d in cm.diff(cm.GOLDEN, _card_manifest(g)))
    del g["ptxas"][lib]
    assert {f"golden: no ptxas figures for {k}" for k in kernels} \
        <= set(cm.golden_findings(g))


def test_kernel_names_parse_from_nvcc_mangling():
    assert cm.kernel_name(_MANGLED.format(arm=3, k=12)) == \
        "sweep_exact_kernel<3,12>"
    assert cm.kernel_name(_MANGLED.format(arm=2, k="n1")) == \
        "sweep_exact_kernel<2,-1>"
    assert cm.kernel_name(_ORDER) == "chunk_order_kernel"
    assert cm.kernel_name(_VITERBI) == "viterbi_decode_kernel"


def test_a_synthetic_ptxas_report_parses_to_its_figures():
    figs = cm.ptxas_figures(_log(cm.GOLDEN["ptxas"]["k8"], 8))
    assert {f["kernel"] for f in figs} == set(cm.GOLDEN["ptxas"]["k8"])
    for f in figs:
        want = cm.GOLDEN["ptxas"]["k8"][f["kernel"]]
        assert {k: f[k] for k in want} == want


def test_the_card_twin_is_pinned():
    assert cm.diff(cm.GOLDEN, _card_manifest()) == []


@pytest.mark.parametrize("field,delta", [("registers", 1),
                                         ("spill_stores", 8),
                                         ("static_smem", 1024)])
def test_a_ptxas_drift_is_caught(field, delta):
    g = copy.deepcopy(cm.GOLDEN)
    g["ptxas"]["k8"]["sweep_exact_kernel<1,8>"][field] += delta
    drift = cm.diff(cm.GOLDEN, _card_manifest(g))
    assert drift and all("sweep_exact_kernel<1,8>" in d for d in drift)


def test_an_unwaived_spill_in_the_golden_block_is_caught():
    g = copy.deepcopy(cm.GOLDEN)
    g["ptxas"]["k8"]["sweep_exact_kernel<0,8>"]["spill_loads"] = 4
    assert any("sweep_exact_kernel<0,8>" in p and "spills" in p
               for p in cm.golden_findings(g))


def test_a_launch_shape_drift_and_a_missing_instance_are_caught():
    g = copy.deepcopy(cm.GOLDEN)
    g["launch"]["mxu@k8"]["ctas_per_sm"] += 1
    assert any("mxu@k8" in d for d in cm.diff(cm.GOLDEN, _card_manifest(g)))
    del g["launch"]["mxu@k8"]
    assert any("mxu@k8" in p for p in cm.golden_findings(g))


def test_a_new_k_is_a_drift():
    man = cm.compute_manifest("cpu")
    man["sweep_ks"] = [*man["sweep_ks"], 32]
    golden = {k: v for k, v in cm.GOLDEN.items()
              if k not in cm.CARD_SECTIONS}
    assert any(d.startswith("sweep_ks") for d in cm.diff(golden, man))


def test_the_hbm_half_holds_and_catches_a_formula_drift(monkeypatch):
    from reporter_tpu_torch.analysis.device_contract import _tiny_tileset
    from reporter_tpu_torch.tiles import capacity

    ts = _tiny_tileset()
    assert cm.hbm_findings(ts) == []
    real = capacity.dense_staged_bytes
    monkeypatch.setattr(capacity, "dense_staged_bytes",
                        lambda t: (real(t)[0] + 4, real(t)[1]))
    assert any("shardable" in p for p in cm.hbm_findings(ts))
    monkeypatch.setattr(capacity, "DEFAULT_HBM_BUDGET", 90 * 10**9)
    assert any("past the card" in p for p in cm.hbm_findings(ts))


def test_update_golden_rewrites_only_the_block(tmp_path, monkeypatch):
    src = open(cm.__file__).read()
    path = tmp_path / "compile_manifest.py"
    path.write_text(src)
    card = _card_manifest()
    monkeypatch.setattr(cm, "compute_manifest", lambda device="cuda": card)
    cm.update_golden(str(path))
    new = path.read_text()
    assert new == src                 # the committed block is the render
    body = new.split('GOLDEN: "dict[str, Any]" = \\\n')[1].split(
        "# --- END")[0]
    assert ast.literal_eval(body) == cm.GOLDEN


def test_a_library_without_its_ptxas_report_is_rebuilt(tmp_path,
                                                      monkeypatch):
    """A library built before its report was kept has none beside it: it
    counts as not built, so ptxas_log rebuilds it and never finds the
    report missing. nvcc is a stand-in script that writes an empty
    library and a one-line report."""
    import os
    import stat

    from reporter_tpu_torch.kernels import build

    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        "while [ $# -gt 0 ]; do\n"
        "  if [ \"$1\" = -o ]; then out=$2; fi; shift\n"
        "done\n"
        f"echo x >> {calls}\n"
        ": > \"$out\"\n"
        "echo 'ptxas info    : Used 40 registers' >&2\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build, "_BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "BUILD_LOG", {})

    def n_calls():
        return len(calls.read_text().split()) if calls.exists() else 0

    lib = build.build(build.EXACT_SOURCE, 8)
    report = build._ptxas_path(lib)
    assert n_calls() == 1 and lib.exists() and report.exists()
    assert build.build(build.EXACT_SOURCE, 8) == lib and n_calls() == 1
    os.unlink(report)
    assert "Used 40 registers" in build.ptxas_log(8)
    assert n_calls() == 2 and lib.exists() and report.exists()
