"""The port's public surface against the JAX package's, name by name.

Both trees are read with ``ast``; neither package's modules are imported
here (the port's test gate, imported first as in every port test, loads
only its lockdep and leak detector). For every ``.py`` path of
``reporter_tpu/`` the port has the module of the same path below
``reporter_tpu_torch/``, or the path is in ``ABSENT_MODULES``. For every
path in both trees, each public name of the JAX module is a name of the
port's module, or ``ABSENT`` holds it with the port's counterpart
(``"renamed: <path>::<name>"``) or the one-sentence reason the port does
without it.

The JAX module's public names: its top-level ``def``s, ``class``es and
assignments, the entries of ``__all__``, every name an ``__init__.py``
imports, and the public methods of its public classes (``Class.method``).
Outside an ``__init__.py`` a name the module imports is not its own, even
where an ``except ImportError`` assigns it a stand-in (``pl = None``).
The port's module has a name if it defines, assigns or imports it at top
level, lists it in ``__all__``, serves it from a module ``__getattr__``
(a lazy name), or, for ``Class.method``, defines or assigns it in the
class body.

An ``ABSENT`` entry is stale once the JAX module no longer has the name or
the port's module has it; a stale entry fails, as does a renamed
counterpart the port does not have.
"""

import ast
import os

import pytest

from _torch_support import (  # noqa: F401  (the port's gate: first)
    _torch_gate, _torch_module_gate)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DIR = os.path.join(ROOT, "reporter_tpu")
PORT_DIR = os.path.join(ROOT, "reporter_tpu_torch")

_SHARD_MAP = ("the port's mesh has neither shard_map nor PartitionSpec "
              "(ROADMAP.md queue 3).")
_SMEM = ("Pallas scalar-prefetch sizing in TPU scalar memory; the port's "
         "ring is sized by ops/dense_candidates.py's list_plan and checked "
         "by the compile manifest's shared-memory rows.")
_BENCH = ("part of bench.py's JSON; it waits for the port's benchmark, which "
          "ROADMAP.md names as its owner.")

ABSENT_MODULES = {
    "parallel/compat.py":
        "The JAX package's shard_map import shim across JAX versions; "
        + _SHARD_MAP,
    "utils/compile_cache.py":
        "XLA's persistent compilation cache; the port's kernels and host "
        "library are content-hashed files under _build/ (kernels/build.py, "
        "native/build.py).",
}

ABSENT = {
    # bench.py's JSON
    ("analysis/bench_delta.py", "compact"):
        "The bounded delta bench.py embeds in its detail file is " + _BENCH,
    ("analysis/bench_delta.py", "summary_token"):
        "The delta token of bench.py's summary line is " + _BENCH,
    ("analysis/bench_delta.py", "schema_coverage"):
        "renamed: analysis/bench_delta.py::coverage_findings",
    # TPU scalar memory and Pallas only
    ("analysis/compile_manifest.py", "SMEM_BOUND_BYTES"): _SMEM,
    ("analysis/compile_manifest.py", "smem_findings"): _SMEM,
    ("ops/dense_candidates.py", "SMEM_LANE_PAD"): _SMEM,
    ("ops/dense_candidates.py", "SMEM_PREFETCH_BUDGET"): _SMEM,
    ("ops/dense_candidates.py", "prefetch_group_cap"): _SMEM,
    ("ops/dense_candidates.py", "prefetch_smem_bytes"): _SMEM,
    ("ops/dense_candidates.py", "pallas_trace_override"):
        "It makes jax.make_jaxpr trace the Pallas kernel on a CPU host; the "
        "port's device audit records aten calls and needs no such hook.",
    # shard_map and PartitionSpec
    ("parallel/dp_e2e.py", "data_pspec"):
        "The data-parallel PartitionSpec; " + _SHARD_MAP,
    ("parallel/dp_e2e.py", "mesh_wire_fn"):
        "It builds jit(shard_map(wire_from_<kind>)); " + _SHARD_MAP,
    ("ops/aggregate.py", "mesh_scatter_fn"):
        "It builds jit(shard_map(scatter)); " + _SHARD_MAP,
    # the jaxpr audit: the port records aten calls instead
    ("analysis/device_contract.py", "audit_jaxpr"):
        "renamed: analysis/device_contract.py::audit",
    ("analysis/device_contract.py", "check_wire_avals"):
        "renamed: analysis/device_contract.py::check_wire",
    # Python fallbacks, which the port's no-fallback rule forbids
    ("matcher/native_prepare.py", "available"):
        "It says whether the C prepare or its Python fallback serves; the "
        "port has no fallback, and a failed build raises.",
    ("matcher/native_walk.py", "make_native_walker"):
        "It returns None when the library is missing so that a Python walk "
        "takes over; the port builds NativeWalker, and a failed build "
        "raises.",
    ("native/build.py", "log"):
        "The logger of the JAX build's fall-back warnings; the port's build "
        "raises where that one warns, so it has no logger.",
    # documented divergences
    ("config.py", "SWEEP_NJ_CAP_RUNGS"):
        "The Pallas sweep's launch-width rungs; the CUDA sweep has no "
        "sweep_nj_cap, and RTPU_NJ_CAP raises (config.py).",
    ("tiles/tileset.py", "TileSet.device_tables"):
        "renamed: tiles/tileset.py::place_tables",
    ("tiles/tileset.py", "TileSet.hbm_bytes"):
        "renamed: tiles/tileset.py::staged_nbytes",
    # renamed
    ("native/build.py", "build_native_lib"): "renamed: native/build.py::build",
    ("native/build.py", "load_native_lib"): "renamed: native/build.py::load",
    ("ops/match.py", "match_batch_wire"): "renamed: ops/match.py::wire_from_f32",
    ("ops/match.py", "match_batch_wire_q"):
        "renamed: ops/match.py::wire_from_q16",
    ("ops/match.py", "match_batch_wire_q8"):
        "renamed: ops/match.py::wire_from_q8",
}


def _paths(top: str) -> "list[str]":
    out = []
    for d, _, names in os.walk(top):
        out += [os.path.relpath(os.path.join(d, n), top).replace(os.sep, "/")
                for n in names if n.endswith(".py")]
    return sorted(out)


def _top_level(body):
    """The module's top-level statements, those under a top-level ``if`` or
    ``try`` included."""
    for node in body:
        if isinstance(node, ast.If):
            yield from _top_level(node.body + node.orelse)
        elif isinstance(node, ast.Try):
            yield from _top_level(node.body + node.orelse + node.finalbody
                                  + [s for h in node.handlers for s in h.body])
        else:
            yield node


def _targets(node) -> "list[str]":
    targets = (node.targets if isinstance(node, ast.Assign)
               else [node.target])
    return [n.id for t in targets for n in ast.walk(t)
            if isinstance(n, ast.Name)]


def _literal_strings(node) -> "set[str]":
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return {node.value}
    if isinstance(node, ast.Dict):
        return {s for k in node.keys if k is not None
                for s in _literal_strings(k)}
    if isinstance(node, (ast.Set, ast.Tuple, ast.List)):
        return {s for e in node.elts for s in _literal_strings(e)}
    return set()


def _lazy_names(fn: ast.FunctionDef, values: dict) -> "set[str]":
    """The names a module ``__getattr__(name)`` serves: the string
    literals (or the literals of a module-level dict, set or tuple) its
    argument is compared with."""
    arg = fn.args.args[0].arg if fn.args.args else None
    out = set()
    for node in ast.walk(fn):
        if not (isinstance(node, ast.Compare)
                and isinstance(node.left, ast.Name) and node.left.id == arg):
            continue
        for comp in node.comparators:
            if isinstance(comp, ast.Name) and comp.id in values:
                comp = values[comp.id]
            out |= _literal_strings(comp)
    return out


def surface(path: str, port: bool) -> "set[str]":
    """The module's names as the module docstring defines them: the
    JAX side's public names (``port=False``), or every name the port's
    module has (``port=True``)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    init = os.path.basename(path) == "__init__.py"
    names, values, imported = set(), {}, set()
    for node in _top_level(tree.body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
        elif isinstance(node, ast.ClassDef):
            names.add(node.name)
            if port or not node.name.startswith("_"):
                for b in node.body:
                    if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        names.add(f"{node.name}.{b.name}")
                    elif port and isinstance(b, (ast.Assign, ast.AnnAssign)):
                        names |= {f"{node.name}.{t}" for t in _targets(b)}
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for t in _targets(node):
                names.add(t)
                if node.value is not None:
                    values[t] = node.value
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            imported |= {a.asname or a.name.split(".")[0] for a in node.names}
    if port or init:
        names |= imported
    if "__all__" in values:
        names |= _literal_strings(values["__all__"])
    if port:
        for node in _top_level(tree.body):
            if isinstance(node, ast.FunctionDef) and node.name == "__getattr__":
                names |= _lazy_names(node, values)
        return names
    return {n for n in names - (set() if init else imported)
            if not n.split(".")[-1].startswith("_")}


JAX_PATHS = _paths(JAX_DIR)
PORT_PATHS = set(_paths(PORT_DIR))
SHARED = [p for p in JAX_PATHS if p in PORT_PATHS]


def _jax(path):
    return surface(os.path.join(JAX_DIR, path), port=False)


def _port(path):
    return surface(os.path.join(PORT_DIR, path), port=True)


def test_the_trees_are_read():
    """The walk is not vacuous: both trees and a known name on each
    side of every kind are found."""
    assert len(JAX_PATHS) > 90 and len(SHARED) > 90
    assert {"match_trace", "CandidateSet"} <= _jax("ops/__init__.py")
    assert "PartialTraceCache.drop" in _jax("service/cache.py")
    assert {"SegmentMatcher", "SegmentMatcher.match_many"} <= _jax(
        "matcher/api.py")
    assert "TileSet.host_tables" in _port("tiles/tileset.py")
    assert {"lib", "load_native_lib"} <= _port("native/__init__.py")
    assert {"Config", "SegmentMatcher"} <= _port("__init__.py")


def test_every_module_has_its_counterpart():
    missing = [p for p in JAX_PATHS
               if p not in PORT_PATHS and p not in ABSENT_MODULES]
    assert not missing, f"JAX modules with no port module: {missing}"
    stale = [p for p in ABSENT_MODULES
             if p in PORT_PATHS or p not in JAX_PATHS]
    assert not stale, f"stale ABSENT_MODULES entries: {stale}"
    for path, reason in ABSENT_MODULES.items():
        assert reason.endswith("."), path


@pytest.mark.parametrize("path", SHARED)
def test_module_surface(path):
    """Every public name of the JAX module at ``path`` is a name of the
    port's module, or ABSENT holds it."""
    missing = sorted(n for n in _jax(path) - _port(path)
                     if (path, n) not in ABSENT)
    assert not missing, (f"{path}: JAX names with no port counterpart and "
                         f"no ABSENT entry: {missing}")


@pytest.mark.parametrize("entry", sorted(ABSENT),
                         ids=lambda e: f"{e[0]}::{e[1]}")
def test_absent_entry(entry):
    """Not stale (the JAX module has the name, the port's does not), and
    either a renamed counterpart the port has, or a reason."""
    path, name = entry
    assert path in SHARED, f"{path} is not a module of both trees"
    assert name in _jax(path), f"stale: the JAX {path} has no {name}"
    assert name not in _port(path), f"stale: the port's {path} has {name}"
    value = ABSENT[entry]
    if value.startswith("renamed: "):
        other, _, other_name = value[len("renamed: "):].partition("::")
        assert other in PORT_PATHS, value
        assert other_name in _port(other), f"{value}: not in the port"
    else:
        assert value[0].isupper() and value.endswith("."), value


@pytest.mark.parametrize("src,names", [
    ("def f(): pass\nclass C:\n    def m(self): pass\n"
     "    def _h(self): pass\nX = 1\n_y = 2\n",
     {"f", "C", "C.m", "X"}),
    ("try:\n    from a import b\nexcept ImportError:\n    b = None\n"
     "__all__ = ['z']\nif b:\n    W = 3\n", {"W", "z"}),
])
def test_the_walk_reads_each_form(tmp_path, src, names):
    p = tmp_path / "m.py"
    p.write_text(src)
    assert surface(str(p), port=False) == names


def test_the_walk_reads_lazy_names(tmp_path):
    """A port module's ``__getattr__`` serves names compared as literals
    or through a module-level dict's keys."""
    p = tmp_path / "__init__.py"
    p.write_text("_LAZY = {'A': ('m', 'A')}\n"
                 "def __getattr__(name):\n"
                 "    if name == 'lib':\n        return 1\n"
                 "    if name in _LAZY:\n        return 2\n"
                 "    raise AttributeError(name)\n")
    assert {"lib", "A"} <= surface(str(p), port=True)
    assert not {"lib", "A"} & surface(str(p), port=False)
