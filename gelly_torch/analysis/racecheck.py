"""Concurrency race detector + protocol-invariant checker.

PRs 4-6 turned the runtime into a genuinely concurrent system — K codec
worker threads, a dedicated H2D double-buffer thread, single-flight
async checkpoint writers, a background lease-beat thread, a 2PC barrier
protocol — and every concurrency bug so far (the SpanTracer
deque-mutated-during-iteration, prefetch cancel-while-queue-full, the
StageTimer lock-wait misattribution) was found by review or by luck.
This module is the static floor under that class of bug, in the style
of :mod:`gelly_torch.analysis.astutil`'s shared suppression gate:

**Thread-root discovery.** Every thread entry point is found by AST:
``threading.Thread(target=...)`` (daemon flag recorded),
``<pool>.submit(fn, ...)``, ``weakref.finalize(obj, cb, ...)``
callbacks, the worker bodies handed to ``utils.prefetch.prefetch`` /
``prefetch_map`` (including a generator whose body runs on the worker
thread), and EventBus ``subscribe(fn)`` callbacks (fan-out runs on
whatever thread emits). For roots that are methods — or nested
functions closing over ``self`` — the analyzer computes the root's
CLOSURE: the entry function plus the same-class methods it reaches
transitively, crossing into a sibling class when the receiver's type is
known (``self.board = LeaseBoard(...)`` in ``__init__`` types
``self.board``, so ``self.board.beat()`` descends into
``LeaseBoard.beat``). Per class, an attribute is SHARED when a thread
root touches it and a different root (or any main-thread method — every
ordinary method is assumed main-callable) writes it outside
``__init__`` (construction happens-before thread start).

**Race rules** (suppress with ``# graphlint: disable=RCxxx`` on the
flagged line, the shared ``astutil.suppressed`` gate):

- ``RC001`` plain write to a shared attribute with no class/module lock
  held. Lock inference understands ``with self._lock:`` scopes, locks
  held across same-class helper descent, and the one-level helper
  discipline: a private (``_``-prefixed) method whose every intra-class
  call site holds a common lock is treated as running under it.
- ``RC002`` compound read-modify-write on a shared attribute with no
  lock held (``self.x += 1``, ``self.x = self.x + ...``,
  ``self.d[k] = self.d.get(k) + 1``) — the lost-update class. Single
  GIL-atomic mutator calls (``.append``/``.add``) are NOT flagged (they
  mark the attribute as written for sharedness, but a lone append is
  atomic under the GIL — the deque-based tracers rely on that).
- ``RC003`` iteration over a shared container without snapshotting —
  the exact SpanTracer bug class: ``for r in self._ring`` (or a
  comprehension) raises "mutated during iteration" under in-flight
  writers; ``list(self._ring)`` first, or hold the lock.
- ``RC004`` blocking call while holding a lock: ``queue.get/put`` (on
  receivers typed ``queue.Queue``), ``Event.wait``/``wait_for``,
  ``future.result``, ``thread.join``, ``time.sleep``, ``open()``,
  ``os.fsync`` inside a with-lock scope (one-level helper descent).
  Waiting on the HELD object itself (``with self._cv:
  self._cv.wait_for(...)``) is the correct condition idiom and exempt.
- ``RC005`` lock-acquisition-order cycle across the whole package:
  acquiring lock B while holding lock A adds edge A->B; a cycle in the
  graph is deadlock potential. Lock nodes are ``module.Class.attr`` (or
  ``module.NAME`` for module-level locks).
- ``RC006`` daemon-thread write to checkpoint/2PC-manifest state:
  ``save_checkpoint`` / ``write_shard`` / ``write_intent`` /
  ``write_prepared`` / ``store.commit`` / a manifest-path
  ``write_json_atomic`` reachable from a ``daemon=True`` root. A daemon
  thread can be killed mid-write at interpreter exit, so fsync'd 2PC
  state must never be touched from one; the vetted exception (the
  single-flight async checkpoint writer, whose atomic tmp+rename plus
  post-write validation make a torn write recoverable) carries an
  inline suppression where it is safe.

**Protocol-invariant checker** (rule ids ``PI0xx``): a declarative
table (:data:`INVARIANTS`) verified against the AST of any linted file
named ``coordination.py``, so a refactor that breaks the 2PC protocol
fails CI even if no test notices:

- ``PI001`` MANIFEST.json is written only by ``CheckpointStore.commit``,
  and every ``store.commit(...)`` call happens only after reading the
  2PC votes (``read_prepared``) behind a guard that can abort
  (an ``if`` containing ``return``/``raise`` between the read and the
  commit) — the all-votes-in branch.
- ``PI002`` epoch numbering derives from committed state only: every
  assignment to ``_next_epoch`` is ``<committed...> + 1`` or
  ``_next_epoch += 1`` — never recomputed from live directory listings
  (the fork-the-epoch-sequence bug class).
- ``PI003`` every ``write_intent`` / ``write_prepared`` call outside
  ``CheckpointStore`` itself stamps ``run_id=`` — unstamped rendezvous
  records resurrect crashed-incarnation leftovers.
- ``PI004`` lease files are written only by ``LeaseBoard.beat`` (the
  rate-limited path): a lease write anywhere else breaks the
  lease == process-liveness semantics the expiry checks rely on.

Findings carry ``path:line`` anchors and render like every other
analysis finding; ``python -m gelly_torch.analysis racecheck [paths]``
runs this tool alone and exits non-zero on any unsuppressed finding.

Conservative by construction: only ``self.<attr>`` state of classes
with a discoverable in-class thread root is analyzed (closure-variable
sharing between nested workers is out of scope), receivers are typed
only by same-module ``self.x = ClassName(...)`` assignments, and main
reachability is over-approximated (any ordinary method may be called
from the main thread). A missed race is possible; a finding is real
unless the line carries a reviewed suppression.
"""

from __future__ import annotations

import ast
import dataclasses
import os

from . import Finding, collect_python_files
from .astutil import _attr_chain, suppressed as _line_suppressed

RULES: dict[str, tuple[str, str]] = {
    "RC001": (
        "shared attribute written without a held lock",
        "the attribute is reachable from more than one thread: guard the "
        "write with the owning lock (with self._lock:) or confine the "
        "attribute to one thread",
    ),
    "RC002": (
        "unlocked read-modify-write on a shared attribute",
        "x += 1 / x = x + ... is a read and a write with a window between "
        "them — concurrent bumps lose updates; take the lock around the "
        "whole read-modify-write",
    ),
    "RC003": (
        "iteration over a shared container without a snapshot",
        "a live deque/list/dict mutated by another thread raises 'mutated "
        "during iteration' mid-loop: iterate list(container) (a GIL-atomic "
        "copy) or hold the lock for the loop",
    ),
    "RC004": (
        "blocking call while holding a lock",
        "queue.get/put, Event.wait, future.result, file I/O or sleep "
        "under a lock stalls every thread contending for it (and can "
        "deadlock if the unblock needs the same lock): move the blocking "
        "call outside the critical section",
    ),
    "RC005": (
        "lock-acquisition-order cycle (deadlock potential)",
        "two code paths acquire the same locks in opposite orders; impose "
        "a global order (always take A before B) or collapse to one lock",
    ),
    "RC006": (
        "daemon thread writes checkpoint/2PC state",
        "a daemon thread is killed mid-write at interpreter exit, so "
        "durable protocol state (shards, votes, MANIFEST) written from "
        "one can tear: write from a joined thread, or suppress only "
        "where atomic tmp+rename plus post-write validation make the "
        "torn write recoverable",
    ),
    "PI001": (
        "manifest commit outside the all-votes-in branch",
        "MANIFEST.json is THE 2PC commit point: it may only be written "
        "by CheckpointStore.commit, called after read_prepared behind a "
        "guard that can abort — committing without every vote resurrects "
        "the mixed-epoch store the protocol exists to prevent",
    ),
    "PI002": (
        "epoch number not derived from committed+1",
        "epoch numbering must be committed_manifest_epoch + 1 (or a "
        "+= 1 bump): deriving it from live directory state races a slow "
        "host's construction and forks the epoch sequence",
    ),
    "PI003": (
        "rendezvous record written without a run_id stamp",
        "write_intent/write_prepared must pass run_id=: unstamped "
        "records make a crashed incarnation's leftovers "
        "indistinguishable from live votes",
    ),
    "PI004": (
        "lease file written outside LeaseBoard.beat",
        "lease freshness means PROCESS liveness only because every write "
        "goes through the rate-limited beat(); a side-channel lease "
        "write fakes liveness and breaks peer-death detection",
    ),
}

# threading constructors that create a lock-like object (with-able).
_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}
# queue constructors — receivers of .get/.put typed from these block.
_QUEUE_CTORS = {"Queue", "LifoQueue", "PriorityQueue", "SimpleQueue"}
# Single-call container mutators: atomic under the GIL — they mark an
# attribute as WRITTEN for shared-attribute discovery but are not
# themselves RC001 findings.
_MUTATORS = {"append", "appendleft", "extend", "add", "insert", "remove",
             "discard", "pop", "popleft", "popitem", "clear", "update",
             "setdefault", "sort", "reverse"}
# Iteration wrappers that take a GIL-atomic snapshot.
_SNAPSHOTTERS = {"list", "tuple", "sorted", "set", "frozenset", "sum",
                 "max", "min", "len", "any", "all"}
# Attribute calls that block regardless of receiver type. (``.join`` is
# deliberately absent: os.path.join / str.join would swamp the rule with
# false positives, and a Thread.join under a lock shows up as the
# .wait()/.result() of whatever the joined thread signals.)
_BLOCKING_METHODS = {"wait", "wait_for", "result"}
# Durable checkpoint/2PC writers a daemon thread must not reach (RC006).
_DURABLE_CALLEES = {"save_checkpoint", "write_shard", "write_intent",
                    "write_prepared"}

_READ, _WRITE, _RMW, _MUTATE, _ITER = "read", "write", "rmw", "mutate", "iter"


@dataclasses.dataclass
class _Access:
    """One touch of ``<class>.<attr>`` attributed to an origin thread."""

    origin: str            # "main" or a root id
    kind: str              # read | write | rmw | mutate | iter
    node: ast.AST
    module: "_Mod"
    fn: str                # enclosing function name (lock-floor keys)
    locks: frozenset       # lock ids held at the access
    in_init: bool
    snapshotted: bool = False  # iter only: wrapped in list()/sorted()/...


@dataclasses.dataclass
class _Root:
    """A discovered thread entry point."""

    rid: str
    module: "_Mod"
    cls: "_Cls | None"
    entry: ast.FunctionDef
    daemon: bool
    kind: str              # thread | submit | finalize | prefetch | subscribe
    node: ast.AST
    # The name binding ``self`` inside the entry: its own first parameter
    # for a method root, the ENCLOSING method's for a nested def closing
    # over self (``def writer(): self._write(...)`` inside ``save``).
    selfname: str | None = None


@dataclasses.dataclass
class _Cls:
    name: str
    node: ast.ClassDef
    module: "_Mod"
    methods: dict = dataclasses.field(default_factory=dict)
    lock_attrs: set = dataclasses.field(default_factory=set)
    queue_attrs: set = dataclasses.field(default_factory=set)
    attr_types: dict = dataclasses.field(default_factory=dict)  # attr -> cls

    @property
    def key(self):
        return (self.module.path, self.name)


@dataclasses.dataclass
class _Mod:
    path: str
    base: str              # dotted module name (root-relative), for the
    #   root/lock ids shown in messages — path-qualified so same-named
    #   modules (the package's many __init__.py) can never collide into
    #   one lock-graph node or dedupe away each other's roots
    tree: ast.Module
    lines: list
    classes: dict = dataclasses.field(default_factory=dict)
    functions: dict = dataclasses.field(default_factory=dict)
    module_locks: set = dataclasses.field(default_factory=set)


def _is_lock_ctor(call: ast.AST) -> bool:
    if not isinstance(call, ast.Call):
        return False
    chain = _attr_chain(call.func)
    return bool(chain) and chain[-1] in _LOCK_CTORS


def _is_queue_ctor(call: ast.AST) -> bool:
    if not isinstance(call, ast.Call):
        return False
    chain = _attr_chain(call.func)
    return bool(chain) and chain[-1] in _QUEUE_CTORS


def _self_attr(node: ast.AST, selfname: str):
    """``attr`` when node is ``<self>.<attr>``, else None."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == selfname):
        return node.attr
    return None


def _walk_same_scope(node: ast.AST):
    """ast.walk pruned at nested function/class scopes (a closure body
    runs later, on whatever thread calls it — not at this statement)."""
    stack = [node]
    while stack:
        cur = stack.pop()
        yield cur
        for child in ast.iter_child_nodes(cur):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda, ast.ClassDef)):
                continue
            stack.append(child)


def _local_defs(fn: ast.AST):
    """FunctionDefs nested anywhere under ``fn``'s own scope — yielded
    but not descended into (their own nested defs belong to them)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        cur = stack.pop()
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield cur
            continue
        if isinstance(cur, (ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(cur))


class RaceChecker:
    """Whole-package concurrency analysis over a set of Python files."""

    def __init__(self, package_root: str, cache=None):
        from .loader import SourceCache

        self.package_root = os.path.abspath(package_root)
        self.findings: list[Finding] = []
        self._modules: dict[str, _Mod] = {}
        self._cache = cache or SourceCache()
        self.roots: list[_Root] = []
        # (cls_key, attr) -> [_Access]
        self.accesses: dict = {}
        # (cls_key, method) -> [frozenset(lock ids)] per intra-class call
        self.call_locks: dict = {}
        # lock-order edges: (lock_a, lock_b) -> (node, module)
        self.lock_edges: dict = {}
        # RC004 candidates: (module, node, lockids, what)
        self._blocking: list = []
        self._root_entries: set = set()  # (path, lineno) of entry fns

    # ------------------------------------------------------------ loading

    def _dotted(self, path: str) -> str:
        """Root-relative dotted module name (``gelly_torch.obs.bus``);
        outside the root (test fixtures) the stem alone."""
        rel = os.path.relpath(os.path.abspath(path), self.package_root)
        if rel.startswith(".."):
            rel = os.path.basename(path)
        rel = rel[:-3] if rel.endswith(".py") else rel
        return ".".join(p for p in rel.split(os.sep) if p != ".")

    def load(self, path: str) -> _Mod | None:
        path = os.path.abspath(path)
        if path in self._modules:
            return self._modules[path]
        ms = self._cache.get(path)
        if ms is None:
            return None
        tree = ms.tree
        m = _Mod(path=path, base=self._dotted(path),
                 tree=tree, lines=ms.lines)
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                m.functions[node.name] = node
            elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and _is_lock_ctor(node.value):
                m.module_locks.add(node.targets[0].id)
            elif isinstance(node, ast.ClassDef):
                m.classes[node.name] = self._load_class(m, node)
        self._modules[path] = m
        return m

    def _load_class(self, m: _Mod, node: ast.ClassDef) -> _Cls:
        c = _Cls(name=node.name, node=node, module=m)
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                c.methods[item.name] = item
        # Attribute classification from every `self.X = ...` in the class
        # body (any method — __init__ is the common site).
        for fn in c.methods.values():
            selfname = self._selfname(fn)
            if selfname is None:
                continue
            for sub in ast.walk(fn):
                if not (isinstance(sub, ast.Assign)
                        and len(sub.targets) == 1):
                    continue
                attr = _self_attr(sub.targets[0], selfname)
                if attr is None:
                    continue
                if _is_lock_ctor(sub.value):
                    c.lock_attrs.add(attr)
                elif _is_queue_ctor(sub.value):
                    c.queue_attrs.add(attr)
                elif isinstance(sub.value, ast.Call):
                    chain = _attr_chain(sub.value.func)
                    if chain and chain[-1] in m.classes:
                        c.attr_types[attr] = chain[-1]
        return c

    @staticmethod
    def _selfname(fn) -> str | None:
        args = fn.args.posonlyargs + fn.args.args
        for dec in fn.decorator_list:
            if isinstance(dec, ast.Name) and dec.id == "staticmethod":
                return None
        return args[0].arg if args else None

    # ----------------------------------------------------- root discovery

    def _discover_roots(self, m: _Mod) -> None:
        def visit(node, cls: _Cls | None, fn_stack: list):
            if isinstance(node, ast.ClassDef):
                c = m.classes.get(node.name) if not fn_stack else None
                for child in ast.iter_child_nodes(node):
                    visit(child, c if c is not None else cls, fn_stack)
                return
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for child in ast.iter_child_nodes(node):
                    visit(child, cls, fn_stack + [node])
                return
            if isinstance(node, ast.Call):
                self._maybe_root(m, cls, fn_stack, node)
            for child in ast.iter_child_nodes(node):
                visit(child, cls, fn_stack)

        for top in m.tree.body:
            visit(top, None, [])

    def _maybe_root(self, m, cls, fn_stack, call: ast.Call) -> None:
        chain = _attr_chain(call.func)
        last = chain[-1] if chain else None
        targets: list[tuple[ast.AST, bool, str]] = []  # (expr, daemon, kind)
        if last == "Thread":
            daemon = any(
                kw.arg == "daemon" and isinstance(kw.value, ast.Constant)
                and kw.value.value is True for kw in call.keywords
            )
            for kw in call.keywords:
                if kw.arg == "target":
                    targets.append((kw.value, daemon, "thread"))
        elif last == "submit" and isinstance(call.func, ast.Attribute) \
                and call.args:
            targets.append((call.args[0], False, "submit"))
        elif last == "finalize" and len(call.args) >= 2:
            targets.append((call.args[1], False, "finalize"))
        elif last == "subscribe" and isinstance(call.func, ast.Attribute) \
                and call.args:
            targets.append((call.args[0], False, "subscribe"))
        elif last == "prefetch_map" and call.args:
            targets.append((call.args[0], False, "prefetch"))
            if len(call.args) >= 2:
                gen = self._producer_fn(call.args[1], fn_stack)
                if gen is not None:
                    targets.append((gen, False, "prefetch"))
        elif last == "prefetch" and call.args:
            gen = self._producer_fn(call.args[0], fn_stack)
            if gen is not None:
                targets.append((gen, False, "prefetch"))
        for expr, daemon, kind in targets:
            self._register_root(m, cls, fn_stack, expr, daemon, kind, call)

    @staticmethod
    def _producer_fn(expr: ast.AST, fn_stack):
        """The local callable whose body runs on a prefetch worker:
        ``prefetch(gen(), ...)`` or a name assigned ``map(f, ...)`` /
        ``gen()`` earlier in the enclosing function."""
        if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Name):
            return expr.func  # resolved (or not) by _register_root
        if isinstance(expr, ast.Name) and fn_stack:
            candidates = []
            for sub in _walk_same_scope(fn_stack[-1]):
                if (isinstance(sub, ast.Assign) and len(sub.targets) == 1
                        and isinstance(sub.targets[0], ast.Name)
                        and sub.targets[0].id == expr.id
                        and isinstance(sub.value, ast.Call)):
                    v = sub.value
                    if (isinstance(v.func, ast.Name)
                            and v.func.id == "map" and v.args):
                        return v.args[0]  # map(f, ...): f runs per item
                    if isinstance(v.func, ast.Name):
                        candidates.append(v.func)
            if candidates:
                return candidates[0]
        return None

    def _register_root(self, m, cls, fn_stack, expr, daemon, kind,
                       node) -> None:
        entry = owner = selfname = None
        if isinstance(expr, ast.Attribute) and fn_stack:
            outer_self = self._selfname(fn_stack[0]) if cls else None
            attr = _self_attr(expr, outer_self) if outer_self else None
            if attr and cls is not None and attr in cls.methods:
                entry, owner = cls.methods[attr], cls
                selfname = self._selfname(entry)
        elif isinstance(expr, ast.Name):
            for fn in reversed(fn_stack):
                for sub in _local_defs(fn):
                    if sub.name == expr.id:
                        entry, owner = sub, cls
                        # A nested def closes over the enclosing
                        # method's self — that binding, not a (usually
                        # absent) own parameter, reaches class state.
                        selfname = (self._selfname(fn_stack[0])
                                    if cls is not None else None)
                        break
                if entry is not None:
                    break
            if entry is None and expr.id in m.functions:
                entry, owner, selfname = m.functions[expr.id], None, None
        if entry is None:
            return
        rid = f"root:{m.base}:{entry.name}:{entry.lineno}"
        if any(r.rid == rid for r in self.roots):
            return
        self.roots.append(_Root(rid, m, owner, entry, daemon, kind, node,
                                selfname=selfname))
        self._root_entries.add((m.path, entry.lineno))

    # ------------------------------------------------------------ walking

    def _record(self, cls: _Cls, attr: str, access: _Access) -> None:
        self.accesses.setdefault((cls.key, attr), []).append(access)

    def _lock_id(self, m: _Mod, cls: _Cls | None, expr: ast.AST,
                 selfname: str | None):
        """Lock id for a with-context expression, or None."""
        if isinstance(expr, ast.Name) and expr.id in m.module_locks:
            return f"{m.base}.{expr.id}"
        if cls is not None and selfname is not None:
            attr = _self_attr(expr, selfname)
            if attr is not None and attr in cls.lock_attrs:
                return f"{m.base}.{cls.name}.{attr}"
        return None

    def _walk_fn(self, m: _Mod, cls: _Cls | None, fn, origin: str,
                 daemon: bool, held: frozenset, depth: int,
                 visited: set, descend: bool,
                 selfname: str | None = None) -> None:
        """Collect accesses / lock edges / blocking-call and RC006
        candidates from one function body. ``descend`` (root closures)
        follows same-class and typed-attr calls transitively; the main
        walk sets it False (every method is walked in place) but still
        descends ONE level while a lock is held, so RC004 and the lock
        graph honor the helper discipline. ``selfname`` overrides the
        first-parameter self binding (nested-def roots close over the
        enclosing method's self)."""
        key = (id(fn), origin, held)
        if key in visited or depth > 8:
            return
        visited.add(key)
        if selfname is None:
            selfname = self._selfname(fn) if cls is not None else None
        in_init = cls is not None and fn.name == "__init__"
        self._walk_body(fn.body, m, cls, fn, origin, daemon, held,
                        depth, visited, descend, selfname, in_init)

    def _walk_body(self, body, m, cls, fn, origin, daemon, held, depth,
                   visited, descend, selfname, in_init) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # Nested def: runs when called. Thread-target nested defs
                # are walked as their own root; any other nested def is
                # treated as part of this origin (it can only be called
                # from code this walk covers).
                if (m.path, stmt.lineno) not in self._root_entries:
                    self._walk_body(stmt.body, m, cls, fn, origin, daemon,
                                    held, depth, visited, descend,
                                    selfname, in_init)
                continue
            if isinstance(stmt, ast.ClassDef):
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                new = set()
                for item in stmt.items:
                    self._scan_expr(item.context_expr, m, cls, fn, origin,
                                    daemon, held, depth, visited, descend,
                                    selfname, in_init)
                    lid = self._lock_id(m, cls, item.context_expr, selfname)
                    if lid is not None:
                        for h in held | new:
                            if h != lid:
                                self.lock_edges.setdefault(
                                    (h, lid), (item.context_expr, m))
                        new.add(lid)
                self._walk_body(stmt.body, m, cls, fn, origin, daemon,
                                frozenset(held | new), depth, visited,
                                descend, selfname, in_init)
                continue
            # Generic statement: scan expressions, recurse into blocks.
            handled_exprs = []
            if isinstance(stmt, ast.Assign):
                handled_exprs = [stmt.value]
                self._scan_store(stmt.targets, stmt.value, False, m, cls,
                                 fn, origin, held, selfname, in_init)
            elif isinstance(stmt, ast.AugAssign):
                handled_exprs = [stmt.value]
                self._scan_store([stmt.target], stmt.value, True, m, cls,
                                 fn, origin, held, selfname, in_init)
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                handled_exprs = [stmt.value]
                self._scan_store([stmt.target], stmt.value, False, m, cls,
                                 fn, origin, held, selfname, in_init)
            elif isinstance(stmt, ast.For):
                self._scan_iter(stmt.iter, m, cls, fn, origin, held,
                                selfname, in_init)
            for expr in handled_exprs or [
                c for c in ast.iter_child_nodes(stmt)
                if isinstance(c, ast.expr)
            ]:
                self._scan_expr(expr, m, cls, fn, origin, daemon, held,
                                depth, visited, descend, selfname, in_init)
            if isinstance(stmt, ast.For):
                self._scan_expr(stmt.iter, m, cls, fn, origin, daemon,
                                held, depth, visited, descend, selfname,
                                in_init)
            for blk in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, blk, None)
                if sub:
                    self._walk_body(sub, m, cls, fn, origin, daemon, held,
                                    depth, visited, descend, selfname,
                                    in_init)
            for h in getattr(stmt, "handlers", []) or []:
                self._walk_body(h.body, m, cls, fn, origin, daemon, held,
                                depth, visited, descend, selfname, in_init)

    # -------------------------------------------------- expression scans

    def _scan_store(self, targets, value, is_aug, m, cls, fn, origin,
                    held, selfname, in_init) -> None:
        if cls is None or selfname is None:
            return
        for tgt in targets:
            attr = _self_attr(tgt, selfname)
            sub_attr = None
            if attr is None and isinstance(tgt, ast.Subscript):
                sub_attr = _self_attr(tgt.value, selfname)
            name = attr or sub_attr
            if name is None:
                continue
            reads_self = any(
                _self_attr(n, selfname) == name
                for n in ast.walk(value)
                if isinstance(n, ast.Attribute)
                and isinstance(n.ctx, ast.Load)
            )
            kind = _RMW if (is_aug or reads_self) else _WRITE
            self._record(cls, name, _Access(
                origin, kind, tgt, m, fn.name, held, in_init))

    def _scan_iter(self, expr, m, cls, fn, origin, held, selfname,
                   in_init) -> None:
        """Iteration source of a for/comprehension: a bare shared
        container is the live-mutation hazard; list()/sorted() wrappers
        snapshot first."""
        if cls is None or selfname is None:
            return
        target = expr
        snapshotted = False
        if isinstance(expr, ast.Call):
            chain = _attr_chain(expr.func)
            if chain and chain[-1] in _SNAPSHOTTERS and expr.args:
                target, snapshotted = expr.args[0], True
            elif (isinstance(expr.func, ast.Attribute)
                  and expr.func.attr in ("values", "keys", "items")):
                target = expr.func.value  # dict view: still live
        attr = _self_attr(target, selfname)
        if attr is not None:
            self._record(cls, attr, _Access(
                origin, _ITER, expr, m, fn.name, held, in_init,
                snapshotted=snapshotted))

    def _scan_expr(self, expr, m, cls, fn, origin, daemon, held, depth,
                   visited, descend, selfname, in_init) -> None:
        for sub in _walk_same_scope(expr):
            if isinstance(sub, ast.comprehension):
                self._scan_iter(sub.iter, m, cls, fn, origin, held,
                                selfname, in_init)
            if isinstance(sub, ast.Attribute) and isinstance(sub.ctx,
                                                             ast.Load):
                attr = _self_attr(sub, selfname) if selfname else None
                if attr is not None and cls is not None:
                    self._record(cls, attr, _Access(
                        origin, _READ, sub, m, fn.name, held, in_init))
            if isinstance(sub, ast.Call):
                self._scan_call(sub, m, cls, fn, origin, daemon, held,
                                depth, visited, descend, selfname, in_init)

    def _scan_call(self, call, m, cls, fn, origin, daemon, held, depth,
                   visited, descend, selfname, in_init) -> None:
        chain = _attr_chain(call.func)
        last = chain[-1] if chain else None
        # Mutator calls on self attrs: a write for sharedness.
        if (last in _MUTATORS and isinstance(call.func, ast.Attribute)
                and cls is not None and selfname is not None):
            attr = _self_attr(call.func.value, selfname)
            if attr is not None:
                self._record(cls, attr, _Access(
                    origin, _MUTATE, call, m, fn.name, held, in_init))
        # RC004 candidates while a lock is held.
        if held:
            self._check_blocking(call, m, cls, fn, held, selfname)
        # RC006 candidates from daemon roots.
        if daemon:
            self._check_durable(call, m, chain)
        # Descent.
        if cls is not None and selfname is not None \
                and isinstance(call.func, ast.Attribute):
            attr = _self_attr(call.func, selfname)
            if attr is not None and attr in cls.methods:
                self.call_locks.setdefault(
                    (cls.key, attr), []).append(held)
                if descend or held:
                    self._walk_fn(m, cls, cls.methods[attr], origin,
                                  daemon, held, depth + 1, visited,
                                  descend)
                return
            # typed sibling: self.<x>.<method>(...)
            recv = call.func.value
            if isinstance(recv, ast.Attribute):
                owner_attr = _self_attr(recv, selfname)
                tname = cls.attr_types.get(owner_attr) \
                    if owner_attr is not None else None
                if tname is not None:
                    target_cls = m.classes.get(tname)
                    if target_cls is not None \
                            and call.func.attr in target_cls.methods:
                        self.call_locks.setdefault(
                            (target_cls.key, call.func.attr), []
                        ).append(held)
                        if descend or held:
                            self._walk_fn(
                                m, target_cls,
                                target_cls.methods[call.func.attr],
                                origin, daemon, held, depth + 1,
                                visited, descend)
                return
        if descend and isinstance(call.func, ast.Name) \
                and call.func.id in m.functions \
                and (m.path, m.functions[call.func.id].lineno) \
                not in self._root_entries:
            self._walk_fn(m, None, m.functions[call.func.id], origin,
                          daemon, held, depth + 1, visited, descend)

    def _check_blocking(self, call, m, cls, fn, held, selfname) -> None:
        chain = _attr_chain(call.func)
        last = chain[-1] if chain else None
        what = None
        if chain == ("time", "sleep"):
            what = "time.sleep"
        elif isinstance(call.func, ast.Name) and call.func.id == "open":
            what = "open()"
        elif chain == ("os", "fsync"):
            what = "os.fsync"
        elif last in _BLOCKING_METHODS \
                and isinstance(call.func, ast.Attribute):
            # Waiting on the HELD object itself is the condition idiom.
            lid = self._lock_id(m, cls, call.func.value, selfname)
            if lid is None or lid not in held:
                what = f".{last}()"
        elif last in ("get", "put") and isinstance(call.func,
                                                   ast.Attribute):
            recv_attr = _self_attr(call.func.value, selfname) \
                if selfname else None
            if (cls is not None and recv_attr is not None
                    and recv_attr in cls.queue_attrs):
                what = f"queue.{last}()"
        if what is not None:
            self._blocking.append((m, call, held, what, fn.name))

    def _check_durable(self, call, m, chain) -> None:
        last = chain[-1] if chain else None
        hit = None
        if last in _DURABLE_CALLEES:
            hit = last
        elif last == "commit" and chain and any(
                "store" in part for part in chain[:-1]):
            hit = "store.commit"
        elif last == "write_json_atomic" and call.args:
            try:
                path_src = ast.unparse(call.args[0]).lower()
            except Exception:  # noqa: BLE001 — unparse of odd nodes
                path_src = ""
            if "manifest" in path_src:
                hit = "write_json_atomic(<manifest>)"
        if hit is not None:
            self._rc006.append((m, call, hit))

    # ----------------------------------------------------------- linting

    def lint_paths(self, paths) -> list[Finding]:
        mods = []
        for f in collect_python_files(paths):
            if self._cache.get_or_finding(f, self.findings) is None:
                continue
            mods.append(self.load(f))
        for m in mods:
            self._discover_roots(m)
        self._rc006: list = []
        # Root closures (transitive descent, accesses attributed per root).
        for r in self.roots:
            self._walk_fn(r.module, r.cls, r.entry, r.rid, r.daemon,
                          frozenset(), 0, set(), descend=True,
                          selfname=r.selfname)
        # Main walk: every method/function in place.
        for m in mods:
            for c in m.classes.values():
                for fn in c.methods.values():
                    if (m.path, fn.lineno) in self._root_entries:
                        continue
                    self._walk_fn(m, c, fn, "main", False, frozenset(),
                                  0, set(), descend=False)
            for fn in m.functions.values():
                if (m.path, fn.lineno) in self._root_entries:
                    continue
                self._walk_fn(m, None, fn, "main", False, frozenset(),
                              0, set(), descend=False)
        self._emit_shared_findings()
        self._emit_blocking_findings()
        self._emit_lock_cycles()
        self._emit_daemon_findings()
        for m in mods:
            if os.path.basename(m.path) == "coordination.py":
                for f in check_invariants(m.path, tree=m.tree,
                                          lines=m.lines):
                    self._append(f)
        self.findings.sort(key=lambda f: (f.path, f.line, f.rule))
        return self.findings

    # ----------------------------------------------------- finding emits

    def _suppressed(self, m: _Mod, line: int, rule: str) -> bool:
        return _line_suppressed(m.lines, line, rule)

    def _append(self, f: Finding) -> None:
        if f not in self.findings:
            self.findings.append(f)

    def _emit(self, m: _Mod, node: ast.AST, rule: str, detail: str) -> None:
        line = getattr(node, "lineno", 0)
        if self._suppressed(m, line, rule):
            return
        summary, hint = RULES[rule]
        self._append(Finding(m.path, line, rule,
                             f"{summary}: {detail}", hint=hint))

    def _lock_floor(self, cls_key, method: str) -> frozenset:
        """Locks provably held at EVERY intra-class call site of a
        private helper — the one-level 'lock held via helper'
        discipline. Public (non-underscore) methods get no floor: an
        external caller may hold nothing."""
        if not method.startswith("_") or method == "__init__":
            return frozenset()
        sites = self.call_locks.get((cls_key, method))
        if not sites:
            return frozenset()
        floor = frozenset(sites[0])
        for s in sites[1:]:
            floor &= s
        return floor

    def _shared_attrs(self) -> dict:
        """(cls_key, attr) -> accesses, for attributes shared across
        thread origins with at least one non-construction write."""
        out = {}
        for (cls_key, attr), acc in self.accesses.items():
            origins = {a.origin for a in acc}
            if len(origins) < 2 or not any(
                    o != "main" for o in origins):
                continue
            if not any(a.kind in (_WRITE, _RMW, _MUTATE)
                       and not a.in_init for a in acc):
                continue
            out[(cls_key, attr)] = acc
        return out

    def _emit_shared_findings(self) -> None:
        for (cls_key, attr), acc in self._shared_attrs().items():
            cname = cls_key[1]
            roots = sorted({a.origin for a in acc if a.origin != "main"})
            seen: set = set()
            for a in acc:
                line = getattr(a.node, "lineno", 0)
                held = a.locks | self._lock_floor(cls_key, a.fn)
                if a.kind in (_WRITE, _RMW) and not a.in_init and not held:
                    rule = "RC002" if a.kind == _RMW else "RC001"
                    k = (rule, a.module.path, line)
                    if k in seen:
                        continue
                    seen.add(k)
                    self._emit(
                        a.module, a.node, rule,
                        f"{cname}.{attr} is reachable from "
                        f"{len(roots)} thread root(s) "
                        f"({', '.join(roots)}) and written in "
                        f"{a.fn!r} with no lock held",
                    )
                elif a.kind == _ITER and not a.snapshotted and not held:
                    k = ("RC003", a.module.path, line)
                    if k in seen:
                        continue
                    seen.add(k)
                    self._emit(
                        a.module, a.node, "RC003",
                        f"{cname}.{attr} is mutated by "
                        f"{', '.join(roots)} and iterated live in "
                        f"{a.fn!r} — wrap in list(...) or hold the "
                        "lock",
                    )

    def _emit_blocking_findings(self) -> None:
        seen: set = set()
        for m, call, held, what, fname in self._blocking:
            line = getattr(call, "lineno", 0)
            k = (m.path, line)
            if k in seen:
                continue
            seen.add(k)
            self._emit(
                m, call, "RC004",
                f"{what} called in {fname!r} while holding "
                f"{', '.join(sorted(held))}",
            )

    def _emit_lock_cycles(self) -> None:
        adj: dict = {}
        for (a, b) in self.lock_edges:
            adj.setdefault(a, set()).add(b)
        emitted: set = set()
        for start in sorted(adj):
            stack = [(start, [start])]
            while stack:
                node, path = stack.pop()
                for nxt in sorted(adj.get(node, ())):
                    if nxt == start:
                        cyc = path + [start]
                        canon = frozenset(cyc)
                        if canon in emitted:
                            continue
                        emitted.add(canon)
                        edge_node, m = self.lock_edges[(node, start)]
                        self._emit(
                            m, edge_node, "RC005",
                            "acquisition-order cycle "
                            + " -> ".join(cyc),
                        )
                    elif nxt not in path:
                        stack.append((nxt, path + [nxt]))

    def _emit_daemon_findings(self) -> None:
        seen: set = set()
        for m, call, hit in self._rc006:
            line = getattr(call, "lineno", 0)
            k = (m.path, line)
            if k in seen:
                continue
            seen.add(k)
            self._emit(
                m, call, "RC006",
                f"{hit} reachable from a daemon thread root",
            )


# ---------------------------------------------------------------------- #
# protocol invariants (declarative table, checked on coordination.py)


@dataclasses.dataclass(frozen=True)
class Invariant:
    """One statically-checkable protocol invariant. ``kind`` selects the
    checker; ``params`` parameterize it — the table IS the spec, so a
    protocol change edits a row here, not checker code."""

    rule: str
    kind: str
    params: tuple = ()


INVARIANTS: tuple[Invariant, ...] = (
    # MANIFEST.json written only by CheckpointStore.commit; store.commit
    # called only after read_prepared behind an abortable guard.
    Invariant("PI001", "guarded_commit",
              ("read_prepared", "CheckpointStore", "commit", "manifest")),
    # _next_epoch derives from committed+1 (or += 1).
    Invariant("PI002", "epoch_derivation", ("_next_epoch", "committed")),
    # write_intent / write_prepared stamped with run_id= outside the
    # store class itself.
    Invariant("PI003", "stamped_kwarg",
              (("write_intent", "write_prepared"), "run_id",
               "CheckpointStore")),
    # lease files written only by LeaseBoard.beat.
    Invariant("PI004", "confined_lease_write",
              ("write_json_atomic", ("members", "_path("),
               "LeaseBoard", "beat")),
)


def _enclosing_index(tree: ast.Module):
    """[(node, class_name or None, fn_name or None)] for every Call /
    Assign / AugAssign, with its innermost enclosing class + function."""
    out = []

    def visit(node, cls, fnname):
        if isinstance(node, ast.ClassDef):
            for c in ast.iter_child_nodes(node):
                visit(c, node.name if fnname is None else cls, fnname)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for c in ast.iter_child_nodes(node):
                visit(c, cls, node.name)
            return
        if isinstance(node, (ast.Call, ast.Assign, ast.AugAssign)):
            out.append((node, cls, fnname))
        for c in ast.iter_child_nodes(node):
            visit(c, cls, fnname)

    for top in tree.body:
        visit(top, None, None)
    return out


def _fn_containing(tree: ast.Module, node: ast.AST):
    """Innermost FunctionDef whose span contains ``node``."""
    best = None
    for fn in ast.walk(tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            end = getattr(fn, "end_lineno", fn.lineno)
            if fn.lineno <= node.lineno <= end:
                if best is None or fn.lineno > best.lineno:
                    best = fn
    return best


def check_invariants(path: str, tree: ast.Module | None = None,
                     lines: list | None = None) -> list[Finding]:
    """Verify :data:`INVARIANTS` against one ``coordination.py`` AST."""
    if tree is None:
        with open(path, "r", encoding="utf-8") as f:
            src = f.read()
        tree = ast.parse(src, filename=path)
        lines = src.splitlines()
    lines = lines or []
    findings: list[Finding] = []
    index = _enclosing_index(tree)

    def emit(node, rule, detail):
        line = getattr(node, "lineno", 0)
        if _line_suppressed(lines, line, rule):
            return
        summary, hint = RULES[rule]
        findings.append(Finding(path, line, rule,
                                f"{summary}: {detail}", hint=hint))

    for inv in INVARIANTS:
        if inv.kind == "guarded_commit":
            _ck_guarded_commit(tree, index, inv, emit)
        elif inv.kind == "epoch_derivation":
            _ck_epoch_derivation(index, inv, emit)
        elif inv.kind == "stamped_kwarg":
            _ck_stamped_kwarg(index, inv, emit)
        elif inv.kind == "confined_lease_write":
            _ck_confined_lease_write(index, inv, emit)
    return findings


def _ck_guarded_commit(tree, index, inv, emit) -> None:
    read_votes, store_cls, commit_fn, manifest_marker = inv.params
    for node, cls, fnname in index:
        if not isinstance(node, ast.Call):
            continue
        chain = _attr_chain(node.func)
        if not chain:
            continue
        # (a) manifest write_json_atomic only inside the store's commit.
        if chain[-1] == "write_json_atomic" and node.args:
            try:
                psrc = ast.unparse(node.args[0]).lower()
            except Exception:  # noqa: BLE001
                psrc = ""
            if manifest_marker in psrc and not (
                    cls == store_cls and fnname == commit_fn):
                emit(node, inv.rule,
                     f"manifest write in {cls or '<module>'}."
                     f"{fnname or '<module>'} — only "
                     f"{store_cls}.{commit_fn} may write it")
        # (b) store.commit calls guarded by the vote read + abort branch.
        if chain[-1] == "commit" and len(chain) >= 2 \
                and any("store" in p for p in chain[:-1]):
            fn = _fn_containing(tree, node)
            ok = False
            if fn is not None:
                votes_line = None
                for sub in ast.walk(fn):
                    if isinstance(sub, ast.Call):
                        c2 = _attr_chain(sub.func)
                        if c2 and c2[-1] == read_votes \
                                and sub.lineno < node.lineno:
                            votes_line = sub.lineno \
                                if votes_line is None \
                                else min(votes_line, sub.lineno)
                if votes_line is not None:
                    for sub in ast.walk(fn):
                        if isinstance(sub, ast.If) \
                                and votes_line <= sub.lineno < node.lineno \
                                and any(isinstance(x, (ast.Return,
                                                       ast.Raise))
                                        for x in ast.walk(sub)):
                            ok = True
                            break
            if not ok:
                emit(node, inv.rule,
                     f"store.commit in {fnname or '<module>'!r} without "
                     f"a preceding {read_votes} + abortable "
                     "missing-votes guard")


def _ck_epoch_derivation(index, inv, emit) -> None:
    attr, marker = inv.params
    for node, _cls, fnname in index:
        if isinstance(node, ast.Assign):
            tgts = node.targets
        elif isinstance(node, ast.AugAssign):
            tgts = [node.target]
        else:
            continue
        hit = any(
            isinstance(t, ast.Attribute) and t.attr == attr for t in tgts
        )
        if not hit:
            continue
        if isinstance(node, ast.AugAssign):
            if isinstance(node.op, ast.Add) \
                    and isinstance(node.value, ast.Constant) \
                    and node.value.value == 1:
                continue
        else:
            v = node.value
            if isinstance(v, ast.BinOp) and isinstance(v.op, ast.Add) \
                    and isinstance(v.right, ast.Constant) \
                    and v.right.value == 1:
                try:
                    lsrc = ast.unparse(v.left).lower()
                except Exception:  # noqa: BLE001
                    lsrc = ""
                if marker in lsrc:
                    continue
        emit(node, inv.rule,
             f"{attr} assigned in {fnname or '<module>'!r} from "
             f"something other than <{marker}> + 1")


def _ck_stamped_kwarg(index, inv, emit) -> None:
    callees, kwarg, exempt_cls = inv.params
    for node, cls, fnname in index:
        if not isinstance(node, ast.Call):
            continue
        chain = _attr_chain(node.func)
        if not chain or chain[-1] not in callees:
            continue
        if cls == exempt_cls:
            continue  # the definition/store internals
        if not any(kw.arg == kwarg for kw in node.keywords):
            emit(node, inv.rule,
                 f"{chain[-1]} in {fnname or '<module>'!r} without "
                 f"{kwarg}=")


def _ck_confined_lease_write(index, inv, emit) -> None:
    writer, markers, owner_cls, owner_fn = inv.params
    for node, cls, fnname in index:
        if not isinstance(node, ast.Call):
            continue
        chain = _attr_chain(node.func)
        if not chain or chain[-1] != writer or not node.args:
            continue
        try:
            psrc = ast.unparse(node.args[0]).lower()
        except Exception:  # noqa: BLE001
            psrc = ""
        if not any(mk in psrc for mk in markers):
            continue
        if cls == owner_cls and fnname == owner_fn:
            continue
        emit(node, inv.rule,
             f"lease-path write in {cls or '<module>'}."
             f"{fnname or '<module>'} — only {owner_cls}.{owner_fn} "
             "writes lease files")


def lint_paths(package_root: str, paths, cache=None) -> list[Finding]:
    """Convenience wrapper of the CLI's per-tool lane: run a
    fresh :class:`RaceChecker` (race rules + protocol invariants for any
    ``coordination.py`` in the set) over ``paths``, optionally sharing a
    parsed :class:`~gelly_torch.analysis.loader.SourceCache`."""
    return RaceChecker(package_root, cache=cache).lint_paths(paths)
