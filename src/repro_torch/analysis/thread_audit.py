"""Concurrency lint: which threads touch which attributes (the port's
counterpart of ``repro.analysis.thread_audit``).

An AST pass over the port's thread-crossing modules (``prefetch.py``,
``engine.py`` with its staged sources, ``serving.py``, ``featcache.py``,
``inference.py``, ``embedding_store.py``).  Per class it derives:

- **thread-entry methods**: targets of ``threading.Thread(target=
  self.m)`` plus methods handed to a ``Prefetcher`` as ``payload_fn=`` /
  ``sample_fn=`` (those run on the prefetch worker), closed over the
  intra-class ``self.m()`` call graph;
- per method, the ``self.<attr>`` **reads**, **writes** (assign /
  augassign / subscript store) and **mutating calls** (``.append`` /
  ``.pop`` / ``move_to_end`` / ...), each tagged with whether it sits
  inside a ``with self.<lock>:`` block;
- **discipline attributes**: ``queue.Queue`` / ``threading.Event`` /
  ``Lock`` / ``HostStagingRing`` instances assigned in ``__init__`` or
  ``bind`` — calls on these are the designated thread-safe handoff and
  are never flagged (rebinding them still counts as a write).

The port hands its callbacks over in ways the reference's keyword match
does not see, so the class model resolves three more routes (none of
them changes a rule below):

- **forwarding methods**: a method that passes one of its parameters on
  as ``payload_fn=`` / ``sample_fn=`` / ``target=`` (``_StagedSource.
  _prefetched``) is a forwarder; a ``self.m`` given to it, by position
  or keyword, is a worker entry.  A ``self.m`` given to any other call
  is a call edge from the caller (``_timed_stage(self._stage, ...)``
  runs ``_stage``);
- **lambdas** handed over as a callback: the lambda's body becomes a
  worker-side method of its own (``<lambda:LINE>``), whose accesses and
  calls (``self._timed_stage(self._assemble, ...)``) count on the worker;
- **bases in the same module**: a class's methods include those it
  inherits from classes defined in the audited module, so the worker and
  main sides of ``_StagedSource`` count for every staged source.  An
  overridden base method is kept as ``Base.m`` and reached through
  ``super().m(...)``.

Findings:

- ``error`` — an attribute written (unlocked, non-discipline) from BOTH
  a worker-side and a main-side method: a data race unless some
  external protocol orders it.  This is the gate; intentional cases go
  in ``allowlist.toml`` with a reason.
- ``warning`` — a worker-side unlocked write to an attribute that a
  main-side method also MUTATES through method calls (list/dict
  mutation races that assignment-tracking alone would miss).
- ``info`` — single-writer, cross-thread reader without a lock: the
  deliberate lock-free handoffs (``Prefetcher._err`` is written before
  the sentinel ``put`` whose matching ``get`` orders the read).
  Report-only, so the committed allowlist stays near-empty.

``__init__`` / ``bind`` writes are pre-thread setup and exempt.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.findings import Finding

#: method names that mutate their receiver in place
MUTATORS = frozenset({
    "append", "extend", "insert", "remove", "pop", "popitem", "clear",
    "add", "discard", "update", "setdefault", "move_to_end", "sort",
    "reverse", "appendleft", "popleft", "fill",
})

#: constructor names whose instances ARE the designated cross-thread
#: discipline (their methods synchronize internally)
DISCIPLINE_TYPES = frozenset({
    "Queue", "LifoQueue", "PriorityQueue", "SimpleQueue", "Event",
    "Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore",
    "Barrier", "HostStagingRing",
})

#: methods whose writes happen before any worker thread exists
SETUP_METHODS = frozenset({"__init__", "bind"})

#: keyword names that hand a bound method to the Prefetcher worker
WORKER_CALLBACK_KWARGS = frozenset({"payload_fn", "sample_fn"})

#: every keyword that hands a callable to another thread
_HANDOFF_KWARGS = WORKER_CALLBACK_KWARGS | {"target"}

#: the thread-crossing modules this audit covers (relative to the
#: ``repro_torch`` package root)
AUDITED_MODULES = (
    "core/prefetch.py",
    "core/engine.py",
    "core/serving.py",
    "core/featcache.py",
    "core/inference.py",
    "core/embedding_store.py",
)


class _Access:
    __slots__ = ("kind", "attr", "method", "locked", "line")

    def __init__(self, kind: str, attr: str, method: str, locked: bool,
                 line: int):
        self.kind = kind          # read | write | mutcall
        self.attr = attr
        self.method = method
        self.locked = locked
        self.line = line


def _params(fn) -> List[str]:
    """Positional parameter names of a def or lambda, ``self`` first."""
    a = fn.args
    return [p.arg for p in a.posonlyargs + a.args]


def _forwarded_params(fn: ast.FunctionDef,
                      forwarders: Dict[str, Dict[str, str]]
                      ) -> Dict[str, str]:
    """-> {param: handoff kind} for the parameters ``fn`` hands to another
    thread: as a handoff keyword's value, or as an argument of a known
    forwarder ``self.f(...)`` in that forwarder's forwarded slot."""
    params = _params(fn)
    self_name = params[0] if params else "self"
    out: Dict[str, str] = {}
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        for kw in node.keywords:
            if kw.arg in _HANDOFF_KWARGS and isinstance(kw.value, ast.Name) \
                    and kw.value.id in params[1:]:
                out[kw.value.id] = kw.arg
        f = node.func
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                and f.value.id == self_name and f.attr in forwarders:
            for slot, arg in _slots(node, forwarders[f.attr]):
                if isinstance(arg, ast.Name) and arg.id in params[1:]:
                    out[arg.id] = forwarders[f.attr][slot]
    return out


def _slots(call: ast.Call, forwarded: Dict[str, str]):
    """(param, argument) pairs of ``call`` that land in a forwarded
    parameter of the callee; ``forwarded`` keys carry the callee's
    positional index as ``"#i"`` beside the name."""
    for i, arg in enumerate(call.args):
        key = f"#{i}"
        if key in forwarded:
            yield key, arg
    for kw in call.keywords:
        if kw.arg in forwarded:
            yield kw.arg, kw.value


class _MethodVisitor(ast.NodeVisitor):
    """Collect self.<attr> accesses in one method, tracking ``with
    self.<attr>:`` nesting as lock protection.  ``forwarders`` maps the
    class's forwarding methods to their forwarded parameters; lambdas
    handed to another thread are queued in ``handoff_lambdas`` instead
    of being visited as part of this method."""

    def __init__(self, method: str, self_name: str = "self",
                 forwarders: Optional[Dict[str, Dict[str, str]]] = None,
                 defining: str = ""):
        self.method = method
        self.self_name = self_name
        self.forwarders = forwarders or {}
        self.defining = defining               # class that defines it
        self.accesses: List[_Access] = []
        self.calls: Set[str] = set()          # self.m() intra-class calls
        self.super_calls: Set[str] = set()    # super().m() calls
        self.callbacks: Set[str] = set()      # self.m passed as worker cb
        self.thread_targets: Set[str] = set()  # Thread(target=self.m)
        self.handoff_lambdas: List[ast.Lambda] = []
        self._lock_depth = 0

    # -- helpers -------------------------------------------------------
    def _self_attr(self, node) -> Optional[str]:
        if isinstance(node, ast.Attribute) \
                and isinstance(node.value, ast.Name) \
                and node.value.id == self.self_name:
            return node.attr
        return None

    def _rec(self, kind: str, attr: str, line: int) -> None:
        self.accesses.append(_Access(kind, attr, self.method,
                                     self._lock_depth > 0, line))

    def _handoff(self, value, kind: str) -> bool:
        """``value`` goes to another thread: a ``self.m`` becomes an
        entry, a lambda a worker-side method of its own.  -> handled."""
        tgt = self._self_attr(value)
        if tgt is not None:
            (self.thread_targets if kind == "target"
             else self.callbacks).add(tgt)
            return True
        if isinstance(value, ast.Lambda):
            self.handoff_lambdas.append(value)
            return True
        return False

    # -- visitors ------------------------------------------------------
    def visit_With(self, node: ast.With) -> None:
        held = any(self._self_attr(item.context_expr) is not None
                   for item in node.items)
        for item in node.items:
            self.visit(item.context_expr)
        if held:
            self._lock_depth += 1
        for stmt in node.body:
            self.visit(stmt)
        if held:
            self._lock_depth -= 1

    def visit_Attribute(self, node: ast.Attribute) -> None:
        attr = self._self_attr(node)
        if attr is not None:
            if isinstance(node.ctx, (ast.Store, ast.Del)):
                self._rec("write", attr, node.lineno)
            else:
                self._rec("read", attr, node.lineno)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        attr = self._self_attr(node.target)
        if attr is not None:
            self._rec("write", attr, node.lineno)
        elif isinstance(node.target, ast.Subscript):
            base = self._self_attr(node.target.value)
            if base is not None:
                self._rec("mutcall", base, node.lineno)
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        if isinstance(node.ctx, (ast.Store, ast.Del)):
            base = self._self_attr(node.value)
            if base is not None:       # self.x[k] = v mutates x in place
                self._rec("mutcall", base, node.lineno)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        handed: Set[int] = set()        # ids of argument nodes handed off
        if isinstance(func, ast.Attribute):
            recv = func.value
            m = self._self_attr(recv)
            if isinstance(recv, ast.Name) and recv.id == self.self_name:
                # self.m(...) — intra-class call edge
                self.calls.add(func.attr)
                fwd = self.forwarders.get(func.attr)
                if fwd:
                    for slot, arg in _slots(node, fwd):
                        if self._handoff(arg, fwd[slot]):
                            handed.add(id(arg))
            elif m is not None and func.attr in MUTATORS:
                self._rec("mutcall", m, node.lineno)
            elif isinstance(recv, ast.Call) \
                    and isinstance(recv.func, ast.Name) \
                    and recv.func.id == "super":
                self.super_calls.add(func.attr)
        # Thread(target=self.m) / Prefetcher(payload_fn=self.m, ...)
        for kw in node.keywords:
            if kw.arg in _HANDOFF_KWARGS and self._handoff(kw.value, kw.arg):
                handed.add(id(kw.value))
        # a bound method given to any other call may be run by it
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            tgt = self._self_attr(arg)
            if tgt is not None and id(arg) not in handed:
                self.calls.add(tgt)
        self.visit(func)
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            if id(arg) not in handed or not isinstance(arg, ast.Lambda):
                self.visit(arg)


def _call_name(node) -> Optional[str]:
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Name):
            return f.id
        if isinstance(f, ast.Attribute):
            return f.attr
    return None


def _mro(name: str, classes: Dict[str, ast.ClassDef]) -> List[str]:
    """The class and its bases defined in the same module, depth first,
    left to right, each once (the C3 order for single inheritance)."""
    out: List[str] = []
    todo = [name]
    while todo:
        c = todo.pop(0)
        if c in out or c not in classes:
            continue
        out.append(c)
        todo = [b.id for b in classes[c].bases
                if isinstance(b, ast.Name)] + todo
    return out


class _ClassInfo:
    def __init__(self, node: ast.ClassDef, modname: str,
                 classes: Optional[Dict[str, ast.ClassDef]] = None):
        self.name = node.name
        self.modname = modname
        classes = dict(classes or {})
        classes.setdefault(node.name, node)
        mro = _mro(node.name, classes)
        # method key -> (def, defining class): the visible definition of
        # each name under its name; overridden base ones as "Base.m"
        defs: Dict[str, Tuple[ast.FunctionDef, str]] = {}
        for cname in mro:
            for item in classes[cname].body:
                if isinstance(item, ast.FunctionDef):
                    key = item.name if item.name not in defs \
                        else f"{cname}.{item.name}"
                    if key not in defs:
                        defs[key] = (item, cname)
        self._mro = mro
        self._defs = defs
        forwarders: Dict[str, Dict[str, str]] = {}
        changed = True
        while changed:                    # forwarders through forwarders
            changed = False
            for key, (fn, _) in defs.items():
                fwd = _forwarded_params(fn, forwarders)
                if not fwd:
                    continue
                params = _params(fn)[1:]
                slots = dict(fwd)
                slots.update({f"#{params.index(p)}": k
                              for p, k in fwd.items()})
                if forwarders.get(key) != slots:
                    forwarders[key] = slots
                    changed = True
        self.methods: Dict[str, _MethodVisitor] = {}
        self.lambdas: Set[str] = set()     # handed-off lambda bodies
        self.discipline: Set[str] = set()
        for key, (item, cname) in defs.items():
            args = item.args.posonlyargs + item.args.args
            self_name = args[0].arg if args else "self"
            mv = _MethodVisitor(key, self_name, forwarders, cname)
            for stmt in item.body:
                mv.visit(stmt)
            self.methods[key] = mv
            self._add_lambdas(mv, forwarders)
            if item.name in SETUP_METHODS:
                for stmt in ast.walk(item):
                    if isinstance(stmt, ast.Assign):
                        cname_ = _call_name(stmt.value)
                        if cname_ in DISCIPLINE_TYPES:
                            for tgt in stmt.targets:
                                a = mv._self_attr(tgt)
                                if a is not None:
                                    self.discipline.add(a)

    def _add_lambdas(self, mv: _MethodVisitor, forwarders) -> None:
        """Each lambda ``mv`` hands to another thread, as a worker-side
        method of its own (its body is its one statement)."""
        todo = list(mv.handoff_lambdas)
        while todo:
            lam = todo.pop(0)
            key = f"<lambda:{lam.lineno}>"
            lv = _MethodVisitor(key, mv.self_name, forwarders, mv.defining)
            lv.visit(lam.body)
            self.methods[key] = lv
            self.lambdas.add(key)
            todo += lv.handoff_lambdas

    def _super_key(self, mv: _MethodVisitor, name: str) -> Optional[str]:
        """The method key ``super().name`` reaches from ``mv``."""
        after = self._mro[self._mro.index(mv.defining) + 1:] \
            if mv.defining in self._mro else []
        for cname in after:
            for key in (name, f"{cname}.{name}"):
                d = self._defs.get(key)
                if d is not None and d[1] == cname:
                    return key
        return None

    def _edges(self, mv: _MethodVisitor) -> Set[str]:
        out = set(mv.calls)
        for name in mv.super_calls:
            key = self._super_key(mv, name)
            if key is not None:
                out.add(key)
        return out

    # -- thread-side closure -------------------------------------------
    def entries(self) -> Set[str]:
        out: Set[str] = set(self.lambdas)
        for mv in self.methods.values():
            out |= mv.thread_targets & self.methods.keys()
            out |= mv.callbacks & self.methods.keys()
        return out

    def worker_side(self) -> Set[str]:
        seen = set()
        todo = list(self.entries())
        while todo:
            m = todo.pop()
            if m in seen or m not in self.methods:
                continue
            seen.add(m)
            todo += [c for c in self._edges(self.methods[m])
                     if c not in seen]
        return seen

    def audit(self) -> List[Finding]:
        worker = self.worker_side()
        if not worker:
            return []
        site_base = f"{self.modname}.{self.name}"
        # attr -> {(side, kind, locked): [methods]}
        per_attr: Dict[str, Dict[Tuple[str, str, bool], Set[str]]] = {}
        for mname, mv in self.methods.items():
            if mname.rpartition(".")[2] in SETUP_METHODS:
                continue
            sides = set()
            if mname in worker:
                sides.add("worker")
                # a worker-side method also invoked inline by a main-side
                # method (the non-prefetch path) runs on BOTH threads
                if self._also_called_from_main(mname, worker):
                    sides.add("main")
            else:
                sides.add("main")
            for acc in mv.accesses:
                d = per_attr.setdefault(acc.attr, {})
                for side in sides:
                    d.setdefault((side, acc.kind, acc.locked),
                                 set()).add(mname)
        findings: List[Finding] = []
        for attr, d in sorted(per_attr.items()):
            if attr in self.discipline:
                # calls on the discipline object are the handoff; only a
                # REBIND from two sides would race, fold into writes
                w_w = d.get(("worker", "write", False), set())
                m_w = d.get(("main", "write", False), set())
            else:
                w_w = (d.get(("worker", "write", False), set())
                       | d.get(("worker", "mutcall", False), set()))
                m_w = (d.get(("main", "write", False), set())
                       | d.get(("main", "mutcall", False), set()))
            site = f"{site_base}.{attr}"
            if w_w and m_w:
                findings.append(Finding(
                    "thread", "error", site,
                    f"written without a lock from the worker side "
                    f"({sorted(w_w)}) AND the main side ({sorted(m_w)}) "
                    "— no queue/ring/lock discipline orders these "
                    "writes"))
                continue
            if attr in self.discipline:
                continue
            m_mut = d.get(("main", "mutcall", False), set())
            w_mut = d.get(("worker", "mutcall", False), set())
            if (w_w and m_mut) or (m_w and w_mut):
                findings.append(Finding(
                    "thread", "warning", site,
                    f"rebound on one thread ({sorted(w_w or m_w)}) while "
                    f"mutated in place on the other "
                    f"({sorted(m_mut or w_mut)})"))
                continue
            readers = (d.get(("main", "read", False), set())
                       if w_w else d.get(("worker", "read", False), set())
                       if m_w else set())
            writers = w_w or m_w
            readers -= writers
            if writers and readers:
                findings.append(Finding(
                    "thread", "info", site,
                    f"lock-free handoff: written by {sorted(writers)} on "
                    f"one thread, read by {sorted(readers)} on the other "
                    "— safe only if an existing queue put/get or join "
                    "orders the access"))
        return findings

    def _also_called_from_main(self, mname: str, worker: Set[str]) -> bool:
        """A worker-side method also invoked by a main-side method runs
        on BOTH threads (e.g. the non-prefetch path calling the staging
        callback inline)."""
        if mname not in worker:
            return False
        return any(mname in self._edges(mv)
                   for other, mv in self.methods.items()
                   if other not in worker
                   and other.rpartition(".")[2] not in SETUP_METHODS)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _classes(tree) -> Dict[str, ast.ClassDef]:
    return {n.name: n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)}


def class_info(src: str, cls: str, modname: str = "mod") -> _ClassInfo:
    """The thread model of class ``cls`` in module source ``src``."""
    classes = _classes(ast.parse(src))
    return _ClassInfo(classes[cls], modname, classes)


def analyze_source(src: str, modname: str) -> List[Finding]:
    tree = ast.parse(src)
    classes = _classes(tree)
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            findings += _ClassInfo(node, modname, classes).audit()
    return findings


def analyze_file(path: str, modname: Optional[str] = None
                 ) -> List[Finding]:
    with open(path) as f:
        src = f.read()
    if modname is None:
        modname = os.path.splitext(os.path.basename(path))[0]
    return analyze_source(src, modname)


def package_root() -> str:
    import repro_torch
    return os.path.dirname(os.path.abspath(repro_torch.__file__))


def audit_threads() -> List[Finding]:
    """The repo sweep over ``AUDITED_MODULES``."""
    root = package_root()
    findings: List[Finding] = []
    for rel in AUDITED_MODULES:
        path = os.path.join(root, rel)
        modname = "repro_torch." + rel[:-3].replace("/", ".")
        findings += analyze_file(path, modname)
    return findings
