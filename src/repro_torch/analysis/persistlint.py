"""PersistLint static pass: AST lint of the flush/fence/publish discipline.
(the port's own copy of ``repro.analysis.persistlint``)

Four rules over ``src/repro_torch`` (rule ids are what waivers name):

* ``raw-durable-io`` — a module that imports
  :class:`~repro_torch.persistence.manifest.StagedIO` is a *durable layer*;
  inside one, every byte bound for disk must go through StagedIO's
  write→flush→fence→publish path.  Raw mutations (``os.replace`` /
  ``os.rename`` / ``os.open`` / ``Path.write_*`` / ``.unlink`` /
  ``shutil.*`` / ``open(..., "w")``) bypass the staged crash model —
  they are flagged unless the receiver is the ``io`` object itself.
  ``persistence/manifest.py`` is exempt: it *is* the blessed
  implementation.
* ``publish-needs-fence`` — every ``.publish(...)`` call site must be
  preceded, in the same function, by a ``.fence()`` with no intervening
  durable ``.write(...)``: the rename must never make unfenced bytes
  visible.  ``.cas(...)`` publishes are exempt inside traversal-DS
  classes (ones defining ``critical``/``traverse``/``find_entry``),
  where the fence is issued by the policy driver
  (:meth:`repro_torch.core.policies.NVTraversePolicy.before_mod`), and inside
  ``core/instr.py``/``core/pmem.py`` (the instrumented instruction
  itself); anywhere else a cas needs a lexically preceding fence.
* ``traverse-phase-persistence`` — the journey persists nothing:
  methods named ``traverse``/``find_entry`` must contain no
  flush/fence/write/cas calls, and in any function the statements
  between ``ctx.enter(Phase.TRAVERSE)`` and ``ctx.enter(Phase.
  CRITICAL)`` must not flush or fence.
* ``crash-site-kinds`` — every literal kind passed to ``.on_site(...)``
  or ``CrashSite(...)`` must come from the shared registry
  :data:`repro_torch.robustness.KINDS`.

A finding is waived by annotating the flagged line (or the line above)
with ``# persistlint: waive(<rule>) — <why>``; waivers are counted and
reported, never silent.

>>> [v.rule for v in lint_source("x.py", "from repro_torch.persistence."
...     "manifest import StagedIO\\nimport os\\nos.replace('a', 'b')\\n")]
['raw-durable-io']
>>> sorted(_waivers_in("x = 1  # persistlint: waive(raw-durable-io) — ok")
...        .items())
[(1, {'raw-durable-io'})]
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from ..robustness import KINDS

RULES = ("raw-durable-io", "publish-needs-fence",
         "traverse-phase-persistence", "crash-site-kinds")

#: raw filesystem mutations that bypass the staged crash model
_RAW_OS = {"replace", "rename", "remove", "unlink", "rmdir", "truncate",
           "open"}
_RAW_SHUTIL = {"move", "rmtree", "copy", "copyfile", "copy2", "copytree"}
_RAW_METHODS = {"write_text", "write_bytes", "touch", "unlink", "rename",
                "replace", "rmdir"}
#: persistence-relevant instructions banned in traversal phases
_PERSIST_CALLS = {"flush", "fence", "write", "write_local", "cas"}
#: modules that ARE the blessed IO implementation / instruction set
_RAW_IO_EXEMPT = ("persistence/manifest.py",)
_CAS_EXEMPT_FILES = ("core/instr.py", "core/pmem.py")

_WAIVE_RE = re.compile(r"#\s*persistlint:\s*waive\(([a-z-]+)\)")


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str
    file: str
    line: int
    msg: str
    waived: bool = False

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class StaticReport:
    n_files: int
    violations: List[Violation]          # unwaived: fatal
    waived: List[Violation]              # annotated, counted

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_dict(self) -> dict:
        return {"n_files": self.n_files, "ok": self.ok,
                "n_waived": len(self.waived),
                "violations": [v.to_dict() for v in self.violations],
                "waived": [v.to_dict() for v in self.waived]}


def _waivers_in(source: str) -> Dict[int, Set[str]]:
    """Map line number -> rule ids waived on that line."""
    out: Dict[int, Set[str]] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        for m in _WAIVE_RE.finditer(text):
            out.setdefault(i, set()).add(m.group(1))
    return out


def _call_name(call: ast.Call) -> str:
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


def _receiver_is_io(call: ast.Call) -> bool:
    """True for ``io.x(...)`` / ``self.io.x(...)`` / ``m.io.x(...)``."""
    f = call.func
    if not isinstance(f, ast.Attribute):
        return False
    v = f.value
    if isinstance(v, ast.Name):
        return v.id == "io"
    if isinstance(v, ast.Attribute):
        return v.attr == "io"
    return False


def _module_receiver(call: ast.Call) -> Optional[str]:
    """``os.replace(...)`` -> "os"; None for anything else."""
    f = call.func
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
        return f.value.id
    return None


def _open_mode(call: ast.Call) -> Optional[str]:
    """Literal mode of a builtin ``open`` call, if recoverable."""
    if len(call.args) >= 2 and isinstance(call.args[1], ast.Constant) \
            and isinstance(call.args[1].value, str):
        return call.args[1].value
    for kw in call.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant) \
                and isinstance(kw.value.value, str):
            return kw.value.value
    return None


def _calls_in(node: ast.AST) -> List[ast.Call]:
    """Call nodes lexically inside ``node``, source order, excluding
    nested function/class/lambda bodies (they run elsewhere)."""
    calls: List[ast.Call] = []

    def visit(n: ast.AST) -> None:
        for child in ast.iter_child_nodes(n):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef, ast.Lambda)):
                continue
            if isinstance(child, ast.Call):
                calls.append(child)
            visit(child)

    visit(node)
    calls.sort(key=lambda c: (c.lineno, c.col_offset))
    return calls


def _imports_staged_io(tree: ast.Module) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            if any(a.name == "StagedIO" for a in node.names):
                return True
    return False


def _enter_phase(call: ast.Call) -> Optional[str]:
    """``ctx.enter(Phase.TRAVERSE)`` -> "TRAVERSE"."""
    if _call_name(call) != "enter" or not call.args:
        return None
    a = call.args[0]
    if isinstance(a, ast.Attribute):
        return a.attr
    return None


def _literal_kind(node: ast.AST) -> Tuple[bool, Optional[str]]:
    """(is_literal, value) of a candidate kind argument."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return True, node.value
    return False, None


def lint_source(rel: str, source: str) -> List[Violation]:
    """Lint one module's source; ``rel`` is its repo-relative path
    (used for display and for the per-module exemptions)."""
    tree = ast.parse(source, filename=rel)
    waivers = _waivers_in(source)
    out: List[Violation] = []

    def emit(rule: str, line: int, msg: str) -> None:
        waived = rule in waivers.get(line, ()) \
            or rule in waivers.get(line - 1, ())
        out.append(Violation(rule, rel, line, msg, waived))

    durable = _imports_staged_io(tree) and not rel.endswith(_RAW_IO_EXEMPT)
    cas_exempt_file = rel.endswith(_CAS_EXEMPT_FILES)

    # ---- global walk: raw-durable-io + crash-site-kinds ---------------- #
    for call in ast.walk(tree):
        if not isinstance(call, ast.Call):
            continue
        name = _call_name(call)
        mod = _module_receiver(call)
        if durable:
            if mod == "os" and name in _RAW_OS:
                emit("raw-durable-io", call.lineno,
                     f"os.{name} in a durable layer bypasses StagedIO")
            elif mod == "shutil" and name in _RAW_SHUTIL:
                emit("raw-durable-io", call.lineno,
                     f"shutil.{name} in a durable layer bypasses StagedIO")
            elif isinstance(call.func, ast.Name) and name == "open":
                mode = _open_mode(call)
                if mode and any(c in mode for c in "wax+"):
                    emit("raw-durable-io", call.lineno,
                         f"bare open(..., {mode!r}) in a durable layer "
                         f"bypasses StagedIO")
            elif name in _RAW_METHODS and mod not in ("os", "shutil") \
                    and not _receiver_is_io(call) \
                    and not (name in ("replace", "rename")
                             and len(call.args) != 1):
                # Path.replace/rename take exactly one arg; two args is
                # str.replace, which is not filesystem IO at all
                emit("raw-durable-io", call.lineno,
                     f".{name}() on a non-StagedIO receiver in a "
                     f"durable layer bypasses the staged crash model")
        if name == "on_site" and call.args:
            lit, kind = _literal_kind(call.args[0])
            if lit and kind not in KINDS:
                emit("crash-site-kinds", call.lineno,
                     f"on_site kind {kind!r} not in the shared "
                     f"registry {KINDS}")
        if name == "CrashSite" and len(call.args) >= 2:
            lit, kind = _literal_kind(call.args[1])
            if lit and kind not in KINDS:
                emit("crash-site-kinds", call.lineno,
                     f"CrashSite kind {kind!r} not in the shared "
                     f"registry {KINDS}")

    # ---- scoped walk: publish domination + traversal purity ------------ #
    # map each method to its enclosing class, and each class to whether
    # it is a traversal DS (policy driver supplies the cas fences)
    method_class: Dict[ast.FunctionDef, Optional[ast.ClassDef]] = {}
    traversal_classes: Set[ast.ClassDef] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            methods = [c for c in node.body
                       if isinstance(c, ast.FunctionDef)]
            if any(m.name in ("critical", "traverse", "find_entry")
                   for m in methods):
                traversal_classes.add(node)
            for m in methods:
                method_class[m] = node

    for fn in [n for n in ast.walk(tree)
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]:
        cls = method_class.get(fn)
        in_traverse_method = fn.name in ("traverse", "find_entry") \
            and cls is not None
        calls = _calls_in(fn)
        last_fence: Optional[int] = None          # index into calls
        window = False                            # inside TRAVERSE..CRITICAL
        for i, call in enumerate(calls):
            name = _call_name(call)
            phase = _enter_phase(call)
            if phase is not None:
                window = phase == "TRAVERSE"
                continue
            if name == "fence":
                last_fence = i
            if (window or in_traverse_method) and name in _PERSIST_CALLS:
                where = (f"method {fn.name!r}" if in_traverse_method
                         else "the TRAVERSE phase window")
                emit("traverse-phase-persistence", call.lineno,
                     f"{name}() inside {where} — the journey must "
                     f"persist nothing")
            if name == "publish":
                if last_fence is None:
                    emit("publish-needs-fence", call.lineno,
                         "publish with no preceding fence() in this "
                         "function — unfenced bytes would become visible")
                elif any(_call_name(c) in ("write", "write_text",
                                           "write_bytes")
                         for c in calls[last_fence + 1:i]):
                    emit("publish-needs-fence", call.lineno,
                         "durable write between the last fence() and "
                         "this publish — the rename may expose it")
            if name == "cas" and not cas_exempt_file \
                    and (cls is None or cls not in traversal_classes) \
                    and last_fence is None:
                emit("publish-needs-fence", call.lineno,
                     "cas publish outside a traversal-DS class with no "
                     "preceding fence()")
    return out


def iter_lint_files(root: Path) -> List[Path]:
    return sorted(p for p in Path(root).rglob("*.py"))


def run_static(root: Optional[Path] = None,
               files: Optional[List[Path]] = None) -> StaticReport:
    """Lint ``files``, or every ``*.py`` under ``root`` (default: the
    installed ``src/repro_torch`` tree this module lives in)."""
    if files is None:
        root = Path(root) if root else Path(__file__).resolve().parents[1]
        files = iter_lint_files(root)
        rel_of = {p: str(p.relative_to(root)) for p in files}
    else:
        files = [Path(p) for p in files]
        rel_of = {p: p.name for p in files}
    violations: List[Violation] = []
    waived: List[Violation] = []
    for p in files:
        for v in lint_source(rel_of[p], p.read_text()):
            (waived if v.waived else violations).append(v)
    return StaticReport(n_files=len(files), violations=violations,
                        waived=waived)
