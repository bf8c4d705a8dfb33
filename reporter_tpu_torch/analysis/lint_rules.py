"""The port's AST lints: the repo's written contracts, checked over
``reporter_tpu_torch/`` and ``chip_smoke.py`` (the port's end-to-end
script on the card, as ``bench.py`` is the JAX package's).

Counterpart: reporter_tpu/analysis/lint_rules.py. Each rule is a pure
function over one parsed module (or, for the cross-file rules, over the
whole target set) returning ``Finding``s. A finding is WAIVED by a
comment on its line or in the comment block directly above it:

    # lint: allow[rule-id] 2026-10-17 why this one site is legal

The gate (tests/test_torch_static_analysis.py) requires zero UNWAIVED
findings, and every waiver to carry a justification: an empty
``allow[...]`` is itself a finding. Rules:

  env-flag        RTPU_* / REPORTER_* boolean env values must be parsed
                  by the port's ``utils/tracing.env_flag`` (strict=True
                  where a typo must raise): ad-hoc ``== "1"`` /
                  ``.lower() in (...)`` / bare-truthiness parses drift.
  env-table       every RTPU_* / REPORTER_* env read must have a row in
                  README's port env block (``<!-- torch-env-table:begin
                  -->`` ... ``end``), and every row must name a real read
                  (drift both ways).
  metric-inventory  every metric name literally registered through a
                  utils.metrics registry (count / gauge / observe / stage
                  first argument, also through ``labeled(...)``) must
                  appear in README's port metric block
                  (``<!-- torch-metric-inventory:begin -->``), and every
                  token there must name a real registration.
  lock-blocking   no blocking call (sleep, urlopen, fsync, subprocess,
                  create_connection, the port's device waits
                  ``synchronize`` / ``.cpu()`` / ``.item()``, a foreign
                  ``.wait``) lexically inside a ``with <lock>:`` body.
                  The runtime twin (utils/locks.py) catches the
                  non-lexical cases.
  wire-fork       ``wire_from_*`` bodies are defined ONLY in ops/match.py
                  (every front end and the mesh's DpWireMatcher run the
                  one set of wire programs).
  staged-layout   a module that references ANY dense staged-table member
                  (tiles/tileset._DENSE_LAYOUT_KEYS at
                  STAGED_LAYOUT_VERSION, seg_sweep and seg_coarse
                  included) must reference ALL of them.
  dead-import     unused imports.
  dead-private    private module-level functions, classes and constants
                  referenced nowhere (word occurrence across the targets
                  and tests/, outside the definition's own lines).
  bench-coverage  every field chip_smoke.py's ``phase(...)`` calls print
                  that may be a number classifies for analysis/
                  bench_delta.py or is on its neutral list, and every
                  neutral entry names a field still written (drift both
                  ways); a ``**`` argument whose keys the AST cannot read
                  is a finding (the runtime twin: chip_smoke.py's
                  ``[bench_delta]``). The JAX rule reads the committed
                  BENCH_DETAIL captures; the port commits none.

Not ported, with the reason:

  jit-shape-len   the JAX rule bounds next-power-of-two shapes fed to
                  ``jax.jit`` (each new shape is a fresh trace). The port
                  has no jit: a new shape costs PyTorch nothing, and the
                  CUDA sweep has no launch-width rung. No torch meaning.

The device-side twin, the aten-level audit of every wire entry, is
analysis/device_contract.py (``python -m reporter_tpu_torch.analysis
--device``).
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field

__all__ = ["Finding", "run_lint", "lint_source", "iter_targets",
           "RULES", "REPO_ROOT", "ABSENT_RULES"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(_PKG_DIR)

# the JAX rules the port does not run, and why (listed, not faked)
ABSENT_RULES = {
    "jit-shape-len": "no jax.jit in the port: a new tensor shape is not a "
                     "new trace, and the CUDA sweep has no launch-width "
                     "rung",
}

_ENV_NAME = re.compile(r"^(RTPU|REPORTER)_[A-Z0-9_]+$")
_README_TOKEN = re.compile(r"`((?:RTPU|REPORTER)_[A-Z0-9_]+)`")
_WAIVE = re.compile(r"lint:\s*allow\[([a-z0-9-]+)\]\s*(.*)")

# boolean-ish literal sets an ad-hoc env truthiness parse compares with
_TRUTHY_TOKENS = {"1", "0", "true", "false", "on", "off", "yes", "no", ""}

# calls that block (must never run while a lock is held); dotted suffixes
# are matched against the call's rendered qualname
_BLOCKING_SUFFIXES = (
    "time.sleep", "os.fsync", "subprocess.run", "subprocess.check_call",
    "subprocess.check_output", "subprocess.Popen",
    "urllib.request.urlopen", "request.urlopen",
    "socket.create_connection", "torch.cuda.synchronize",
)
_BLOCKING_ATTRS = {"sleep", "urlopen", "fsync", "create_connection",
                   "synchronize", "cpu", "item"}

_LOCKISH = re.compile(r"lock|_cv\b|\bcv\b|cond", re.IGNORECASE)
# with-targets that merely LOOK lockish but aren't locks
_LOCKISH_NOT = re.compile(r"stage|span|tracer|use\(|open\(")

_ENV_BEGIN = "<!-- torch-env-table:begin -->"
_ENV_END = "<!-- torch-env-table:end -->"
_INVENTORY_BEGIN = "<!-- torch-metric-inventory:begin -->"
_INVENTORY_END = "<!-- torch-metric-inventory:end -->"


@dataclass
class Finding:
    rule: str
    path: str          # repo-relative
    line: int
    message: str
    waived: bool = False
    justification: str = ""

    def __str__(self) -> str:
        tag = " (waived: %s)" % self.justification if self.waived else ""
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}{tag}"


@dataclass
class _Module:
    path: str                     # repo-relative
    source: str
    tree: ast.AST
    lines: "list[str]" = field(default_factory=list)

    def seg(self, node: ast.AST) -> str:
        return ast.get_source_segment(self.source, node) or ""


def _apply_waivers(mod: _Module, findings: "list[Finding]") -> None:
    """Waiver = ``lint: allow[rule]`` on the finding's line, or anywhere
    in the contiguous comment block directly above it."""
    for f in findings:
        candidates = []
        if 1 <= f.line <= len(mod.lines):
            candidates.append(mod.lines[f.line - 1])
        ln = f.line - 1
        while ln >= 1 and mod.lines[ln - 1].lstrip().startswith("#"):
            candidates.append(mod.lines[ln - 1])
            ln -= 1
        for text in candidates:
            m = _WAIVE.search(text)
            if m and m.group(1) == f.rule:
                f.waived = True
                f.justification = m.group(2).strip()
                if not f.justification:
                    f.waived = False
                    f.message += (" (waiver present but carries no "
                                  "justification)")
                break


# ---------------------------------------------------------------------------
# env helpers

def _env_read_name(node: ast.AST) -> "str | None":
    """Env var name when ``node`` is an env read, ``X.get("NAME"[, d])``
    or ``X["NAME"]`` with X an environ mapping, possibly wrapped in
    chained str methods (``.strip().lower()``)."""
    while isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        if node.func.attr in ("strip", "lower", "upper", "casefold"):
            node = node.func.value
            continue
        break
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr == "get" and node.args:
        key = node.args[0]
        holder = node.func.value
    elif isinstance(node, ast.Subscript):
        key = node.slice
        holder = node.value
    else:
        return None
    if not (isinstance(key, ast.Constant) and isinstance(key.value, str)
            and _ENV_NAME.match(key.value)):
        return None
    h = ast.unparse(holder)
    if "environ" in h or h in ("e", "env", "_e"):
        return key.value
    return None


def _env_reads(mod: _Module) -> "list[tuple[str, int]]":
    """(name, line) for every env read and env-name constant
    (``_ENV_VAR = "RTPU_FAULTS"`` counts: the read goes through it)."""
    out = []
    for node in ast.walk(mod.tree):
        n = _env_read_name(node)
        if n is not None:
            out.append((n, node.lineno))
        elif isinstance(node, ast.Compare) and len(node.ops) == 1 \
                and isinstance(node.ops[0], (ast.In, ast.NotIn)) \
                and isinstance(node.left, ast.Constant) \
                and isinstance(node.left.value, str) \
                and _ENV_NAME.match(node.left.value):
            out.append((node.left.value, node.lineno))
        elif isinstance(node, ast.Assign) and isinstance(node.value,
                                                         ast.Constant) \
                and isinstance(node.value.value, str) \
                and _ENV_NAME.match(node.value.value):
            out.append((node.value.value, node.lineno))
    return out


# ---------------------------------------------------------------------------
# rule: env-flag

def _rule_env_flag(mod: _Module) -> "list[Finding]":
    out: "list[Finding]" = []

    def flag(node, name, how):
        out.append(Finding(
            "env-flag", mod.path, node.lineno,
            f"{name} parsed by {how}: boolean env values go through "
            "utils/tracing.env_flag (strict=True where a typo must "
            "raise), the ONE truthiness parser"))

    # names also read as VALUES in this module: a bare truthiness test on
    # those is a presence gate ("is it set"), not a boolean parse
    bare_atoms: "set[int]" = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.If, ast.While, ast.IfExp)):
            for t in _test_atoms(node.test):
                bare_atoms.add(id(t))
    value_read: "set[str]" = set()
    for node in ast.walk(mod.tree):
        n = _env_read_name(node)
        if n is not None and id(node) not in bare_atoms:
            value_read.add(n)

    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Compare):
            name = _env_read_name(node.left)
            if name is None:
                continue
            for comp in node.comparators:
                toks = _literal_strings(comp)
                if toks is not None and toks <= _TRUTHY_TOKENS:
                    flag(node, name, "an ad-hoc literal comparison")
                    break
        elif isinstance(node, (ast.If, ast.While, ast.IfExp)):
            for t in _test_atoms(node.test):
                name = _env_read_name(t)
                if name is not None and name not in value_read:
                    flag(t, name, "bare string truthiness")
    # taint pass: x = <env read>[.strip().lower()]; if x in ("1", ...)
    for fn in ast.walk(mod.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        tainted: "dict[str, str]" = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                n = _env_read_name(node.value)
                if n is not None:
                    tainted[node.targets[0].id] = n
            elif isinstance(node, ast.Compare) \
                    and isinstance(node.left, ast.Name) \
                    and node.left.id in tainted:
                for comp in node.comparators:
                    toks = _literal_strings(comp)
                    if toks is not None and toks <= _TRUTHY_TOKENS:
                        flag(node, tainted[node.left.id],
                             "an ad-hoc literal comparison")
                        break
    return out


def _literal_strings(node: ast.AST) -> "set[str] | None":
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return {node.value}
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        vals = set()
        for el in node.elts:
            if not (isinstance(el, ast.Constant)
                    and isinstance(el.value, str)):
                return None
            vals.add(el.value)
        return vals
    return None


def _test_atoms(test: ast.AST):
    """The atomic truthiness operands of a test expression (BoolOp and
    ``not`` unwrapped)."""
    if isinstance(test, ast.BoolOp):
        for v in test.values:
            yield from _test_atoms(v)
    elif isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        yield from _test_atoms(test.operand)
    else:
        yield test


# ---------------------------------------------------------------------------
# rule: lock-blocking

def _rule_lock_blocking(mod: _Module) -> "list[Finding]":
    out: "list[Finding]" = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, (ast.With, ast.AsyncWith)):
            continue
        lockish = []
        for item in node.items:
            txt = mod.seg(item.context_expr)
            if _LOCKISH.search(txt) and not _LOCKISH_NOT.search(txt):
                lockish.append(txt)
        if not lockish:
            continue
        for body_stmt in node.body:
            for call in ast.walk(body_stmt):
                if not isinstance(call, ast.Call):
                    continue
                qn = ast.unparse(call.func) if not isinstance(
                    call.func, ast.Lambda) else ""
                blocked = (qn.endswith(_BLOCKING_SUFFIXES)
                           or qn.split(".")[-1] in _BLOCKING_ATTRS)
                if not blocked \
                        and (qn.endswith(".wait")
                             or qn.endswith(".wait_for")) \
                        and not any(qn[:qn.rfind(".")] == lk
                                    for lk in lockish):
                    # a foreign condvar / event wait; the with-target's own
                    # wait is the condvar idiom and exempt
                    blocked = True
                if blocked:
                    out.append(Finding(
                        "lock-blocking", mod.path, call.lineno,
                        f"blocking call {qn}() inside `with "
                        f"{lockish[0]}:`: move it outside the lock or "
                        "waive with a dated justification"))
    return out


# ---------------------------------------------------------------------------
# rule: wire-fork

def _rule_wire_fork(mod: _Module) -> "list[Finding]":
    out: "list[Finding]" = []
    is_match_py = mod.path.replace(os.sep, "/").endswith(
        "reporter_tpu_torch/ops/match.py")
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name.startswith("wire_from_") and not is_match_py:
            out.append(Finding(
                "wire-fork", mod.path, node.lineno,
                f"wire body {node.name}() defined outside ops/match.py: "
                "every front end and the mesh's DpWireMatcher run the ONE "
                "set of wire programs; don't fork them"))
    return out


# ---------------------------------------------------------------------------
# rule: staged-layout

def _dense_layout() -> "tuple[tuple[str, ...], int]":
    from reporter_tpu_torch.tiles.tileset import (_DENSE_LAYOUT_KEYS,
                                                  STAGED_LAYOUT_VERSION)

    return _DENSE_LAYOUT_KEYS, STAGED_LAYOUT_VERSION


def _rule_staged_layout(mod: _Module) -> "list[Finding]":
    keys, version = _dense_layout()
    keys = set(keys)
    seen: "dict[str, int]" = {}
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and node.value in keys and node.value not in seen:
            seen[node.value] = node.lineno
    if not seen or set(seen) == keys:
        return []
    missing = sorted(keys - set(seen))
    line = min(seen.values())
    return [Finding(
        "staged-layout", mod.path, line,
        f"references staged dense members {sorted(seen)} but not "
        f"{missing}: every member of tiles/tileset._DENSE_LAYOUT_KEYS "
        f"(layout v{version}) stages together; handle the missing "
        "members or bump STAGED_LAYOUT_VERSION")]


# ---------------------------------------------------------------------------
# rule: dead-import

def _rule_dead_import(mod: _Module) -> "list[Finding]":
    out: "list[Finding]" = []
    imports: "list[tuple[str, int, str]]" = []   # (bound name, line, shown)
    import_lines = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                bound = a.asname or a.name.split(".")[0]
                imports.append((bound, node.lineno, a.name))
        elif isinstance(node, ast.ImportFrom):
            if node.module == "__future__":
                continue
            for a in node.names:
                if a.name == "*":
                    continue
                imports.append((a.asname or a.name, node.lineno, a.name))
        else:
            continue
        import_lines.update(range(node.lineno,
                                  (node.end_lineno or node.lineno) + 1))
    if not imports:
        return out
    # use = word occurrence outside the import statements' own lines
    # (string annotations and __all__ count: never flag a live import)
    body = "\n".join(ln for i, ln in enumerate(mod.lines, 1)
                     if i not in import_lines)
    for bound, line, shown in imports:
        if not re.search(rf"\b{re.escape(bound)}\b", body):
            out.append(Finding(
                "dead-import", mod.path, line,
                f"import {shown!r} (bound as {bound!r}) is never used"))
    return out


# ---------------------------------------------------------------------------
# cross-file rule: dead-private

_IDENT = re.compile(r"\b[A-Za-z_][A-Za-z0-9_]*\b")


def _private_defs(mod: _Module):
    """(name, first line incl. decorators, end line) of every private
    (single-underscore, non-dunder) module-LEVEL definition."""
    for node in getattr(mod.tree, "body", ()):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            name = node.name
            lo = min([node.lineno]
                     + [d.lineno for d in node.decorator_list])
        elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            name, lo = node.targets[0].id, node.lineno
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name):
            name, lo = node.target.id, node.lineno
        else:
            continue
        if not name.startswith("_") or name.startswith("__"):
            continue
        yield name, lo, (node.end_lineno or node.lineno)


def _token_counts(source: str) -> "dict[str, int]":
    counts: "dict[str, int]" = {}
    for tok in _IDENT.findall(source):
        counts[tok] = counts.get(tok, 0) + 1
    return counts


def _usage_sources(root: str) -> "list[str]":
    """Sources consulted for liveness beyond the lint targets: the tests
    reach into private names."""
    out = []
    d = os.path.join(root, "tests")
    for dirpath, dirnames, filenames in os.walk(d):
        dirnames[:] = [x for x in dirnames if x != "__pycache__"]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                out.append(os.path.join(dirpath, fn))
    return out


def _rule_dead_private(mods: "list[_Module]",
                       extra_sources: "list[str]") -> "list[Finding]":
    """A private module-level definition no source references. Liveness
    is word occurrence outside the definition's own lines: strings,
    comments and docstrings count, so a live symbol is never flagged."""
    total = _token_counts("\n".join(m.source for m in mods))
    for path in extra_sources:
        try:
            with open(path) as f:
                extra = f.read()
        except OSError:
            continue
        for tok, n in _token_counts(extra).items():
            total[tok] = total.get(tok, 0) + n
    out: "list[Finding]" = []
    for mod in mods:
        for name, lo, hi in _private_defs(mod):
            own = "\n".join(mod.lines[lo - 1:hi])
            if total.get(name, 0) <= _token_counts(own).get(name, 0):
                out.append(Finding(
                    "dead-private", mod.path, lo,
                    f"private module-level {name!r} is never referenced "
                    "outside its own definition (lint targets and tests "
                    "scanned): delete it, or waive with why it must "
                    "stay"))
    return out


# ---------------------------------------------------------------------------
# README blocks: the port's env table and metric inventory

_METRIC_TOKEN = re.compile(r"`([a-z][a-z0-9_]*)`")
# names the registry itself derives (no literal call site)
_REGISTRY_INTRINSIC = {"uptime_seconds", "probes_per_sec_busy"}
_METRIC_RECEIVER = re.compile(r"(^(m|reg|registry)$|metrics$|registry$)")


def _block_tokens(readme_lines: "list[str]", begin: str, end: str,
                  token: "re.Pattern") -> "tuple[dict[str, int], bool]":
    """(token → first line) inside a marker-delimited README block, and
    whether the markers were found (absent markers are a finding: the
    contract must not pass vacuously)."""
    found_tokens: "dict[str, int]" = {}
    inside = found = False
    for i, ln in enumerate(readme_lines, 1):
        if begin in ln:
            inside = found = True
            continue
        if end in ln:
            inside = False
            continue
        if inside:
            for tok in token.findall(ln):
                found_tokens.setdefault(tok, i)
    return found_tokens, found


def inventory_tokens(readme_lines: "list[str]",
                     ) -> "tuple[dict[str, int], bool]":
    """The port's metric inventory block (also read by slo_contract)."""
    return _block_tokens(readme_lines, _INVENTORY_BEGIN, _INVENTORY_END,
                         _METRIC_TOKEN)


def _read_readme(readme_path: str) -> "list[str] | None":
    try:
        with open(readme_path) as f:
            return f.readlines()
    except OSError:
        return None


def _metric_registrations(mod: _Module) -> "dict[str, tuple[str, int]]":
    """name → (path, line) for every metric name LITERALLY registered in
    this module: the first string argument of a
    ``<registry>.count/gauge/observe/stage(...)`` call (the receiver must
    smell like a registry) or of any ``labeled(...)`` call. ``stage``
    registers ``<name>_seconds``. utils/metrics.py itself is excluded."""
    out: "dict[str, tuple[str, int]]" = {}
    if mod.path.replace(os.sep, "/").endswith(
            "reporter_tpu_torch/utils/metrics.py"):
        return out

    def is_labeled(f: "ast.AST") -> bool:
        return ((isinstance(f, ast.Name) and f.id == "labeled")
                or (isinstance(f, ast.Attribute) and f.attr == "labeled"))

    def lit(node: "ast.AST") -> "str | None":
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        if isinstance(node, ast.Call) and is_labeled(node.func) \
                and node.args:
            return lit(node.args[0])
        return None

    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        f = node.func
        if is_labeled(f):
            name = lit(node.args[0])
            if name:
                out.setdefault(name, (mod.path, node.lineno))
        elif isinstance(f, ast.Attribute) \
                and f.attr in ("count", "gauge", "observe", "stage") \
                and _METRIC_RECEIVER.search(ast.unparse(f.value)):
            name = lit(node.args[0])
            if name:
                if f.attr == "stage":
                    name += "_seconds"
                out.setdefault(name, (mod.path, node.lineno))
    return out


def _rule_metric_inventory(mods: "list[_Module]",
                           readme_path: str) -> "list[Finding]":
    out: "list[Finding]" = []
    registered: "dict[str, tuple[str, int]]" = {}
    for mod in mods:
        for name, where in _metric_registrations(mod).items():
            registered.setdefault(name, where)
    readme = _read_readme(readme_path)
    if readme is None:
        return [Finding("metric-inventory", "README.md", 1,
                        "README.md not found: the port's metric inventory "
                        "is the documentation contract")]
    documented, found = inventory_tokens(readme)
    if not found:
        return [Finding(
            "metric-inventory", "README.md", 1,
            f"no {_INVENTORY_BEGIN} ... {_INVENTORY_END} block in README: "
            "the port's metric inventory has nothing to check against")]
    for name, (path, line) in sorted(registered.items()):
        if name not in documented:
            out.append(Finding(
                "metric-inventory", path, line,
                f"metric {name!r} is registered here but has no row in "
                "README's port metric inventory block"))
    for name, line in sorted(documented.items()):
        if name not in registered and name not in _REGISTRY_INTRINSIC:
            out.append(Finding(
                "metric-inventory", "README.md", line,
                f"README's port metric inventory documents {name!r} but "
                "nothing in the lint targets registers it: dead row"))
    return out


def _rule_env_table(mods: "list[_Module]",
                    readme_path: str) -> "list[Finding]":
    out: "list[Finding]" = []
    reads: "dict[str, tuple[str, int]]" = {}
    for mod in mods:
        for name, line in _env_reads(mod):
            reads.setdefault(name, (mod.path, line))
    readme = _read_readme(readme_path)
    if readme is None:
        return [Finding("env-table", "README.md", 1,
                        "README.md not found: the port's env table is the "
                        "documentation contract")]
    documented, found = _block_tokens(readme, _ENV_BEGIN, _ENV_END,
                                      _README_TOKEN)
    if not found:
        return [Finding(
            "env-table", "README.md", 1,
            f"no {_ENV_BEGIN} ... {_ENV_END} block in README: the port's "
            "env table has nothing to check against")]
    for name, (path, line) in sorted(reads.items()):
        if name not in documented:
            out.append(Finding(
                "env-table", path, line,
                f"env var {name} is read here but has no row in README's "
                "port env table"))
    for name, line in sorted(documented.items()):
        if name not in reads:
            out.append(Finding(
                "env-table", "README.md", line,
                f"README's port env table documents {name} but nothing "
                "in the lint targets reads it: dead row"))
    return out


def _rule_bench_coverage(root: str) -> "list[Finding]":
    # imported here: the package imports this module, and ``python -m
    # reporter_tpu_torch.analysis.bench_delta`` must find bench_delta not
    # yet loaded
    from reporter_tpu_torch.analysis.bench_delta import coverage_findings

    return coverage_findings(root)


# ---------------------------------------------------------------------------
# runner

RULES = {
    "env-flag": _rule_env_flag,
    "lock-blocking": _rule_lock_blocking,
    "wire-fork": _rule_wire_fork,
    "staged-layout": _rule_staged_layout,
    "dead-import": _rule_dead_import,
}
# the cross-file rules, run by run_lint over the whole target set
CROSS_RULES = ("dead-private", "metric-inventory", "env-table",
               "bench-coverage")


def iter_targets(root: str = REPO_ROOT) -> "list[str]":
    """Lint scope: the port's package and its end-to-end card script."""
    out = []
    pkg = os.path.join(root, "reporter_tpu_torch")
    for dirpath, dirnames, filenames in os.walk(pkg):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                out.append(os.path.join(dirpath, fn))
    p = os.path.join(root, "chip_smoke.py")
    if os.path.exists(p):
        out.append(p)
    return out


def _load(path: str, root: str) -> "_Module | None":
    with open(path) as f:
        source = f.read()
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return None
    return _Module(os.path.relpath(path, root), source, tree,
                   source.splitlines())


def _dedupe(findings: "list[Finding]") -> "list[Finding]":
    seen = set()
    out = []
    for f in findings:
        key = (f.rule, f.path, f.line, f.message)
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out


def lint_source(source: str, path: str = "<synthetic>",
                rules: "list[str] | None" = None) -> "list[Finding]":
    """Lint one source string (the seeded-violation tests' entry)."""
    mod = _Module(path, source, ast.parse(source), source.splitlines())
    out: "list[Finding]" = []
    for rid, fn in RULES.items():
        if rules is None or rid in rules:
            out.extend(fn(mod))
    if rules is None or "dead-private" in rules:
        out.extend(_rule_dead_private([mod], []))
    out = _dedupe(out)
    _apply_waivers(mod, out)
    return out


def run_lint(root: str = REPO_ROOT,
             rules: "list[str] | None" = None) -> "list[Finding]":
    mods = [m for m in (_load(p, root) for p in iter_targets(root))
            if m is not None]
    out: "list[Finding]" = []
    for mod in mods:
        per_mod: "list[Finding]" = []
        for rid, fn in RULES.items():
            if rules is None or rid in rules:
                per_mod.extend(fn(mod))
        per_mod = _dedupe(per_mod)
        _apply_waivers(mod, per_mod)
        out.extend(per_mod)
    by_path = {m.path: m for m in mods}
    readme = os.path.join(root, "README.md")
    cross = {
        "dead-private": lambda: _rule_dead_private(mods,
                                                   _usage_sources(root)),
        "metric-inventory": lambda: _rule_metric_inventory(mods, readme),
        "env-table": lambda: _rule_env_table(mods, readme),
        "bench-coverage": lambda: _rule_bench_coverage(root),
    }
    for rid in CROSS_RULES:
        if rules is not None and rid not in rules:
            continue
        found = cross[rid]()
        for f in found:
            m = by_path.get(f.path)
            if m is not None:
                _apply_waivers(m, [f])
        out.extend(found)
    return out


def main() -> int:
    findings = run_lint()
    unwaived = [f for f in findings if not f.waived]
    for f in findings:
        print(f)
    print(f"lint: {len(findings)} finding(s), {len(unwaived)} unwaived "
          f"({', '.join(RULES)}, {', '.join(CROSS_RULES)}; absent: "
          f"{', '.join(ABSENT_RULES)})")
    return 1 if unwaived else 0
