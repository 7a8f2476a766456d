"""Liveness & progress checker: the static floor under "does it keep
moving and does it finish".

The reference delegates progress guarantees to Flink's runtime —
backpressure, checkpoint barriers, task lifecycle. Our re-owned
threaded serving plane has to prove them itself, and review history
shows the dominant escaped-bug class is liveness, not safety: the
batched-ack tail that was never flushed (an idle client's ``flush()``
hung forever), the ``pipeline.staged_depth`` gauge that was only
re-published on the submit path (a PAUSEd client's RESUME poll spun
forever once submission stopped), and the coordinated-checkpoint path
that never retired the watermark ledger (one stamp leaked per chunk,
without bound, on exactly one of two sibling checkpoint branches).
Each was found by human review only. This module is the sixth
whole-package analyzer in the :mod:`gelly_torch.analysis` house style —
shared :mod:`loader` parse cache, ``# graphlint: disable=LVxxx``
suppression, ``python -m gelly_torch.analysis liveness`` CLI lane — and
encodes those bug classes as rules, grouped in four families:

**LV1xx loop liveness** (thread roots reused from
:mod:`~gelly_torch.analysis.racecheck`'s root discovery):

- ``LV101`` a ``while True:`` loop reachable from a thread root with
  no exit path in its own scope — no ``break`` belonging to the loop,
  no ``return``/``raise``/``yield`` — can never terminate, so the
  thread can never observe a stop flag and never joins.
- ``LV102`` an untimed blocking call (``q.get()`` / ``sock.recv(n)`` /
  ``ev.wait()`` / ``listener.accept()`` with no timeout) inside a
  root-reachable loop parks the thread unconditionally: even a
  stop-flag test in the loop header is dead code, because the header
  is never re-evaluated. Exempt when the call sits under an
  ``except socket.timeout`` / ``queue.Empty`` handler (the
  timeout-poll idiom) or the owning component configures
  ``settimeout``.

**LV2xx pairing & flush** (the backpressure / batched-ack classes):

- ``LV201`` a component that emits a PAUSE frame must reference a
  RESUME somewhere — a pause with no reachable resume wedges the
  client forever.
- ``LV202`` a gauge polled inside a wait loop (the RESUME condition)
  must have at least one publisher on a background/drain path — a
  root-reachable function or an enqueue-hook closure. A gauge only
  re-published on the submit path strands the poll the moment
  submission stops: the historical ``pipeline.staged_depth`` bug.
- ``LV203`` a loop accumulator (ack batch, resend buffer, pending
  payloads) whose every flush site sits under its own threshold guard
  (``if len(buf) >= N:``) never flushes the tail: there must be at
  least one unguarded flush — idle tick, exit path, close handler.

**LV3xx ledger retirement** (the watermark-leak class), driven by the
declarative :data:`LEDGERS` table:

- ``LV301`` a ledger enter (``watermarks.stamp``) in a component with
  no matching exit (``retire_durable``/``drop``/``rekey``) anywhere in
  that component leaks one obligation per call — backlog age grows
  forever and the QoS headline reads a healthy stream as stuck.
- ``LV302`` an ``if``/``else`` whose branches BOTH reach a
  checkpoint-style durability call but where only ONE reaches a ledger
  exit: the coordinated/alternate branch silently leaks (the
  ``_checkpoint_coordinated`` class).
- ``LV303`` an insert into a pending/in-flight map
  (``self._pending[k] = v``) with no pop/del/clear for that attribute
  anywhere in the owning class (nor a decrement, for counters).

**LV4xx shutdown completeness**:

- ``LV401`` a thread started by a component that has no join, no
  stop-event ``set()``, and no stop-flag write anywhere — nothing can
  ever ask the thread to exit. A spawn whose completion is awaited
  in the spawning function (``done.wait(timeout)`` / ``t.join()``)
  is the bounded-handoff idiom and exempt.
- ``LV402`` a socket/file opened into a ``self`` attribute with no
  close path in the class (a ``.close()`` on the attribute, or the
  attribute passed to a ``*close*``-named helper).

Conservative by construction, like racecheck: root reachability
follows same-module call edges only (same-class methods, typed
``self.x = ClassName(...)`` attributes, module functions), components
are top-level classes or functions, and every heuristic errs toward
silence. A finding is real unless the line carries a reviewed
suppression — run ``python -m gelly_torch.analysis suppressions`` to
audit those.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re

from . import Finding, collect_python_files
from .astutil import suppressed as _line_suppressed
from .racecheck import RaceChecker, _self_attr, _walk_same_scope

RULES: dict[str, tuple[str, str]] = {
    "LV101": (
        "root-reachable while-True loop with no exit path",
        "a loop a thread runs forever can never observe a stop flag: "
        "give the header a termination condition (while not "
        "stop.is_set():) or an in-scope break/return on the shutdown "
        "path",
    ),
    "LV102": (
        "untimed blocking call in a root-reachable loop",
        "a bare get()/recv()/wait()/accept() parks the thread "
        "unconditionally — the loop's stop test is dead code; use a "
        "timeout= (polling the stop flag per tick) or settimeout + "
        "except socket.timeout",
    ),
    "LV201": (
        "PAUSE emitted without a reachable RESUME in the component",
        "a paused client waits for a RESUME frame that nothing sends: "
        "pair every PAUSE emit with a RESUME on the drained path "
        "(finally: is the idiomatic place)",
    ),
    "LV202": (
        "polled gauge has no background (drain-side) publisher",
        "the wait loop re-reads a gauge only the submit path "
        "publishes: once submission stops the value is frozen and the "
        "poll spins forever — publish it from the draining side too "
        "(the scheduler loop or an enqueue hook)",
    ),
    "LV203": (
        "loop accumulator flushed only under its threshold guard",
        "a batch below the threshold when the stream goes idle or "
        "closes is never flushed (the batched-ack-tail class): add an "
        "unguarded flush on idle ticks and on every exit path",
    ),
    "LV301": (
        "ledger enter with no matching exit in the owning component",
        "every stamp must have a retire/drop/rekey reachable in the "
        "same component, or the ledger leaks one obligation per call "
        "and backlog age grows without bound; teardown paths (stop/"
        "close) should drop() the stream",
    ),
    "LV302": (
        "ledger exit missing on one of two sibling durability branches",
        "both branches publish a checkpoint but only one retires the "
        "ledger — the alternate (coordinated) path leaks a stamp per "
        "chunk; retire at the shared durability point instead of "
        "inside one branch",
    ),
    "LV303": (
        "pending-map insert with no removal in the owning class",
        "an entry added to a pending/in-flight map that nothing ever "
        "pops survives its obligation: add the pop/del on the "
        "completion AND failure paths (or .clear() on teardown)",
    ),
    "LV401": (
        "thread started without a reachable join or stop flag",
        "nothing can ever ask this thread to exit: give the owning "
        "component a stop Event the loop polls and set()/join() it "
        "from stop()/close(); a spawn awaited in-function "
        "(done.wait(t)) is the bounded-handoff idiom and exempt",
    ),
    "LV402": (
        "socket/file stored on self with no close path in the class",
        "a long-lived component that opens a socket/file must close "
        "it on every terminal path: call .close() (or pass it to a "
        "*close* helper) from stop()/close()/__exit__",
    ),
}


@dataclasses.dataclass(frozen=True)
class Ledger:
    """One enter/exit obligation pair the LV3xx family tracks.

    ``obj`` is the attribute naming the ledger object in a call chain
    (``bus.watermarks.stamp`` -> obj ``watermarks``); local aliases
    (``wm = bus.watermarks``) are resolved per component. ``enters``
    add an obligation, ``exits`` discharge it, ``neutral`` are
    bookkeeping (observed but never flagged)."""

    obj: str
    enters: tuple
    exits: tuple
    neutral: tuple = ()


#: Declarative ledger table (the racecheck INVARIANTS pattern): adding
#: a row gates a new obligation pair with zero new traversal code.
LEDGERS: tuple[Ledger, ...] = (
    Ledger(
        obj="watermarks",
        enters=("stamp",),
        # retire_fold observes latency but keeps the stamps, so it is
        # neutral: only durable retirement / drop / rekey discharge.
        exits=("retire_durable", "drop", "rekey"),
        neutral=("seed", "retire_fold", "backlog_age", "snapshot",
                 "oldest_position", "max_backlog_age"),
    ),
)

# Attribute names that mark a dict/counter as an obligation map (LV303).
_PENDING_ATTR_RE = re.compile(r"pending|in_?flight|outstanding|unacked",
                              re.IGNORECASE)
# Stop-flag-ish attribute names a True/False write can control (LV401).
_STOP_FLAG_RE = re.compile(r"stop|shut|running|done|closed|cancel|alive",
                           re.IGNORECASE)
# Exception names whose handler marks a blocking call as timeout-polled.
_TIMEOUT_EXCS = {"timeout", "Empty", "Full", "TimeoutError"}
# Untimed blocking methods LV102 watches (zero-arg unless noted).
_BLOCKING_ZERO_ARG = {"get", "wait", "accept"}
# Callee-name fragment that marks a call as a durability point (LV302).
_DURABILITY_FRAGMENT = "checkpoint"


def _tail_chain(node: ast.AST) -> tuple[list, str | None]:
    """Attribute names along the spine of ``node`` plus the base name.

    Unlike :func:`astutil._attr_chain` this tolerates a Call (or any
    expression) at the base, so ``obs_bus.get_bus().watermarks.stamp``
    still yields ``["watermarks", "stamp"]`` (base None)."""
    parts: list = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    parts.reverse()
    base = node.id if isinstance(node, ast.Name) else None
    return parts, base


def _call_name(call: ast.Call) -> str | None:
    """Last name of the callee (``pack_frame`` / ``stamp`` / ``open``)."""
    if isinstance(call.func, ast.Name):
        return call.func.id
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    return None


def _is_true_const(test: ast.AST) -> bool:
    return isinstance(test, ast.Constant) and bool(test.value)


def _has_own_break(stmts) -> bool:
    """A ``break`` belonging to THIS loop: nested loops swallow theirs
    (only their ``orelse`` still belongs to us); nested defs are other
    scopes entirely."""
    for s in stmts:
        if isinstance(s, ast.Break):
            return True
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            continue
        if isinstance(s, (ast.For, ast.While)):
            if _has_own_break(s.orelse):
                return True
            continue
        for blk in ("body", "orelse", "finalbody"):
            if _has_own_break(getattr(s, blk, []) or []):
                return True
        for h in getattr(s, "handlers", []) or []:
            if _has_own_break(h.body):
                return True
    return False


def _loop_can_exit(loop: ast.While) -> bool:
    """Termination witness: a non-constant header test, a break of this
    loop, or a return/raise/yield in the loop's own scope (a generator
    loop is driven — and closeable — by its consumer)."""
    if not _is_true_const(loop.test):
        return True
    if _has_own_break(loop.body):
        return True
    for stmt in loop.body:
        for sub in _walk_same_scope(stmt):
            if isinstance(sub, (ast.Return, ast.Raise, ast.Yield,
                                ast.YieldFrom)):
                return True
    return False


def _handler_is_timeoutish(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    names = []
    if isinstance(t, ast.Tuple):
        names = list(t.elts)
    elif t is not None:
        names = [t]
    for n in names:
        parts, base = _tail_chain(n)
        last = parts[-1] if parts else base
        if last in _TIMEOUT_EXCS:
            return True
    return False


def _walk_component(node: ast.AST):
    """Every node under a component (class/function), nested defs and
    lambdas included (they execute as part of the component)."""
    return ast.walk(node)


class LivenessChecker:
    """Whole-package liveness/progress analysis (see module doc)."""

    def __init__(self, package_root: str, cache=None):
        from .loader import SourceCache

        self.package_root = os.path.abspath(package_root)
        self.findings: list[Finding] = []
        self._cache = cache or SourceCache()
        # Reuse racecheck's loader + thread-root discovery wholesale:
        # one root model for both tools, so a new spawn idiom taught
        # there (prefetch producers, subscribe callbacks) is covered
        # here for free.
        self._rc = RaceChecker(self.package_root, cache=self._cache)
        #: id(fn node) -> (mod, cls, fn, selfname, root id)
        self._reach: dict = {}

    # ------------------------------------------------------------ plumbing

    def _emit(self, m, line: int, rule: str, detail: str) -> None:
        if _line_suppressed(m.lines, line, rule):
            return
        summary, hint = RULES[rule]
        f = Finding(m.path, line, rule, f"{summary}: {detail}", hint=hint)
        if f not in self.findings:
            self.findings.append(f)

    def _fn_nodes(self, m, fn: ast.AST):
        """Every node under ``fn`` excluding nested defs that are thread
        roots themselves (they get their own closure) and class bodies."""
        stack = list(ast.iter_child_nodes(fn))
        while stack:
            cur = stack.pop()
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if (m.path, cur.lineno) in self._rc._root_entries:
                    continue
            elif isinstance(cur, ast.ClassDef):
                continue
            yield cur
            stack.extend(ast.iter_child_nodes(cur))

    # ------------------------------------------------------- reachability

    def _root_closure(self) -> None:
        """BFS over same-module call edges from every discovered thread
        root: same-class ``self.m()`` descent, typed-attribute sibling
        descent (``self.board.beat()``), and module-function calls —
        racecheck's closure rules, re-walked here to tag entire
        functions (not accesses) as background-reachable."""
        work = [(r.module, r.cls, r.entry, r.selfname, r.rid)
                for r in self._rc.roots]
        while work:
            m, cls, fn, selfname, rid = work.pop()
            if id(fn) in self._reach:
                continue
            self._reach[id(fn)] = (m, cls, fn, selfname, rid)
            if selfname is None and cls is not None:
                selfname = self._rc._selfname(fn)
            for node in self._fn_nodes(m, fn):
                if not isinstance(node, ast.Call):
                    continue
                if cls is not None and selfname is not None \
                        and isinstance(node.func, ast.Attribute):
                    attr = _self_attr(node.func, selfname)
                    if attr is not None and attr in cls.methods:
                        work.append((m, cls, cls.methods[attr],
                                     None, rid))
                        continue
                    recv = node.func.value
                    if isinstance(recv, ast.Attribute):
                        owner = _self_attr(recv, selfname)
                        tname = cls.attr_types.get(owner) \
                            if owner is not None else None
                        tcls = m.classes.get(tname) if tname else None
                        if tcls is not None \
                                and node.func.attr in tcls.methods:
                            work.append((m, tcls,
                                         tcls.methods[node.func.attr],
                                         None, rid))
                        continue
                if isinstance(node.func, ast.Name) \
                        and node.func.id in m.functions:
                    tgt = m.functions[node.func.id]
                    if (m.path, tgt.lineno) not in self._rc._root_entries:
                        work.append((m, None, tgt, None, rid))

    # ------------------------------------------------- LV101/LV102: loops

    def _check_loops(self) -> None:
        for m, cls, fn, selfname, rid in self._reach.values():
            if selfname is None and cls is not None:
                selfname = self._rc._selfname(fn)
            comp = cls.node if cls is not None else fn
            has_settimeout = any(
                isinstance(n, ast.Call)
                and _call_name(n) in ("settimeout", "setdefaulttimeout")
                for n in _walk_component(comp)
            )
            for node in self._fn_nodes(m, fn):
                if not isinstance(node, ast.While):
                    continue
                if not _loop_can_exit(node):
                    self._emit(m, node.lineno, "LV101",
                               f"loop in {fn.name!r} runs on {rid} with "
                               "no break/return in scope and a constant "
                               "header")
                self._scan_loop_blocking(m, fn, node.body, rid,
                                         guarded=False,
                                         settimeout=has_settimeout)

    def _scan_loop_blocking(self, m, fn, stmts, rid, guarded: bool,
                            settimeout: bool) -> None:
        """LV102 over one loop body: recursion carries whether a
        timeout-ish except handler guards the current block."""
        for s in stmts:
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                continue
            if isinstance(s, (ast.Try, getattr(ast, "TryStar", ast.Try))):
                covered = guarded or any(
                    _handler_is_timeoutish(h) for h in s.handlers)
                self._scan_loop_blocking(m, fn, s.body, rid, covered,
                                         settimeout)
                for h in s.handlers:
                    self._scan_loop_blocking(m, fn, h.body, rid, guarded,
                                             settimeout)
                for blk in (s.orelse, s.finalbody):
                    self._scan_loop_blocking(m, fn, blk, rid, guarded,
                                             settimeout)
                continue
            for sub in _walk_same_scope(s):
                if isinstance(sub, ast.Call):
                    self._maybe_untimed(m, fn, sub, rid, guarded,
                                        settimeout)
            for blk in ("body", "orelse", "finalbody"):
                inner = getattr(s, blk, None)
                if inner:
                    self._scan_loop_blocking(m, fn, inner, rid, guarded,
                                             settimeout)
            for h in getattr(s, "handlers", []) or []:
                self._scan_loop_blocking(m, fn, h.body, rid, guarded,
                                         settimeout)

    def _maybe_untimed(self, m, fn, call: ast.Call, rid, guarded: bool,
                       settimeout: bool) -> None:
        if guarded or not isinstance(call.func, ast.Attribute):
            return
        name = call.func.attr
        has_kw_timeout = any(kw.arg == "timeout" for kw in call.keywords)
        if name in _BLOCKING_ZERO_ARG and not call.args \
                and not call.keywords:
            if name == "accept" and settimeout:
                return
            self._emit(m, call.lineno, "LV102",
                       f".{name}() with no timeout in a loop of "
                       f"{fn.name!r} (runs on {rid})")
        elif name == "recv" and not has_kw_timeout and not settimeout:
            self._emit(m, call.lineno, "LV102",
                       f".recv() outside a timeout guard in a loop of "
                       f"{fn.name!r} (runs on {rid})")

    # -------------------------------------------- LV203: accumulator flush

    def _check_accumulators(self) -> None:
        for m, cls, fn, selfname, rid in self._reach.values():
            accs = {}
            for node in self._fn_nodes(m, fn):
                if isinstance(node, ast.Assign) \
                        and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name) \
                        and isinstance(node.value, ast.List):
                    # _fn_nodes order is not source order — the
                    # accumulator's anchor is the EARLIEST list assign;
                    # later ones are resets (flush sites).
                    tid = node.targets[0].id
                    if tid not in accs or node.lineno < accs[tid].lineno:
                        accs[tid] = node
            if not accs:
                continue
            for name, init in accs.items():
                self._check_one_accumulator(m, fn, name, init, rid)

    @staticmethod
    def _refs_name(expr: ast.AST, name: str) -> bool:
        return any(isinstance(n, ast.Name) and n.id == name
                   for n in ast.walk(expr))

    def _check_one_accumulator(self, m, fn, name: str, init, rid) -> None:
        mutated_in_while = False
        guarded_flush = None
        unguarded_flush = False

        def is_threshold_guard(tests) -> bool:
            return any(
                self._refs_name(t, name)
                and any(isinstance(n, ast.Compare) for n in ast.walk(t))
                for t in tests
            )

        def visit(stmts, guards, in_while):
            nonlocal mutated_in_while, guarded_flush, unguarded_flush
            for s in stmts:
                if isinstance(s, ast.ClassDef):
                    continue
                if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if (m.path, s.lineno) in self._rc._root_entries:
                        continue
                    # A nested def (idle hook, exit helper) runs outside
                    # the loop's guard context.
                    visit(s.body, [], False)
                    continue
                # Compound statements recurse with the right guard
                # stack; scanning them whole here would re-see their
                # inner flushes with the guards stripped.
                if isinstance(s, ast.While):
                    visit(s.body, guards + [s.test], True)
                    visit(s.orelse, guards, in_while)
                    continue
                if isinstance(s, ast.If):
                    visit(s.body, guards + [s.test], in_while)
                    visit(s.orelse, guards, in_while)
                    continue
                if isinstance(s, (ast.For, ast.AsyncFor, ast.With,
                                  ast.AsyncWith, ast.Try)):
                    for blk in ("body", "orelse", "finalbody"):
                        inner = getattr(s, blk, None)
                        if inner:
                            visit(inner, guards, in_while)
                    for h in getattr(s, "handlers", []) or []:
                        visit(h.body, guards, in_while)
                    continue
                flush_here = False
                if isinstance(s, ast.Assign) and s is not init:
                    for tgt in s.targets:
                        if isinstance(tgt, ast.Name) and tgt.id == name:
                            flush_here = True
                        elif isinstance(tgt, ast.Subscript) \
                                and self._refs_name(tgt.value, name):
                            flush_here = True
                elif isinstance(s, ast.Delete):
                    flush_here = any(self._refs_name(t, name)
                                     for t in s.targets)
                elif isinstance(s, ast.AugAssign) and in_while \
                        and self._refs_name(s.target, name):
                    mutated_in_while = True
                for sub in _walk_same_scope(s):
                    if not isinstance(sub, ast.Call):
                        continue
                    cn = _call_name(sub)
                    if cn in ("append", "extend", "appendleft", "add") \
                            and isinstance(sub.func, ast.Attribute) \
                            and self._refs_name(sub.func.value, name):
                        if in_while:
                            mutated_in_while = True
                        continue
                    if cn == "clear" and isinstance(sub.func,
                                                    ast.Attribute) \
                            and self._refs_name(sub.func.value, name):
                        flush_here = True
                    elif any(self._refs_name(a, name) for a in sub.args):
                        flush_here = True
                if flush_here:
                    if is_threshold_guard(guards):
                        if guarded_flush is None:
                            guarded_flush = s
                    else:
                        unguarded_flush = True

        visit(fn.body, [], False)
        if mutated_in_while and guarded_flush is not None \
                and not unguarded_flush:
            self._emit(m, init.lineno, "LV203",
                       f"accumulator {name!r} in {fn.name!r} (runs on "
                       f"{rid}) only flushes when its threshold is met "
                       f"(line {guarded_flush.lineno}); an idle or "
                       "closing stream strands the tail")

    # --------------------------------------------- LV201: PAUSE <-> RESUME

    @staticmethod
    def _mentions_token(node: ast.AST, token: str) -> bool:
        for n in ast.walk(node):
            if isinstance(n, ast.Name) and n.id == token \
                    and isinstance(n.ctx, ast.Load):
                return True
            if isinstance(n, ast.Attribute) and n.attr == token:
                return True
            if isinstance(n, ast.Constant) and n.value == token:
                return True
        return False

    def _components(self, m):
        """Top-level classes and functions — the pairing scope for
        LV201/LV3xx (module-level leftovers pair against the module)."""
        for node in m.tree.body:
            if isinstance(node, (ast.ClassDef, ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                yield node

    def _check_pause_resume(self, mods) -> None:
        for m in mods:
            for comp in self._components(m):
                pauses = [
                    n for n in _walk_component(comp)
                    if isinstance(n, ast.Call)
                    and any(self._mentions_token(a, "PAUSE")
                            for a in list(n.args)
                            + [kw.value for kw in n.keywords])
                ]
                if not pauses:
                    continue
                if any(self._mentions_token(n, "RESUME")
                       for n in _walk_component(comp)):
                    continue
                for call in pauses:
                    self._emit(m, call.lineno, "LV201",
                               f"component {comp.name!r} sends PAUSE "
                               "but never references RESUME")

    # ----------------------------------------------- LV202: polled gauges

    def _check_gauges(self, mods) -> None:
        # Publishers: every .gauge("<name>", ...) call, tagged
        # background when its enclosing function is root-reachable or
        # it lives in a closure (lambda / nested def — the enqueue-hook
        # idiom runs on the worker that enqueues).
        background: set = set()
        published: set = set()

        def scan_fn(m, fn, depth):
            for node in ast.iter_child_nodes(fn):
                walk_pub(m, node, fn, depth)

        def walk_pub(m, node, fn, depth):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                scan_fn(m, node, depth + 1)
                return
            if isinstance(node, ast.Call):
                parts, _base = _tail_chain(node.func)
                if parts and parts[-1] == "gauge" and node.args \
                        and isinstance(node.args[0], ast.Constant) \
                        and isinstance(node.args[0].value, str):
                    gname = node.args[0].value
                    published.add(gname)
                    if depth > 0 or id(fn) in self._reach:
                        background.add(gname)
            for child in ast.iter_child_nodes(node):
                walk_pub(m, child, fn, depth)

        for m in mods:
            for comp in self._components(m):
                if isinstance(comp, ast.ClassDef):
                    for item in comp.body:
                        if isinstance(item, (ast.FunctionDef,
                                             ast.AsyncFunctionDef)):
                            scan_fn(m, item, 0)
                else:
                    scan_fn(m, comp, 0)

        # Reads: .gauges.get("<name>", ...) inside a while loop's own
        # scope — the poll that must eventually observe a drain.
        for m in mods:
            for loop in [n for n in ast.walk(m.tree)
                         if isinstance(n, ast.While)]:
                region = [loop.test] + loop.body
                for stmt in region:
                    for sub in _walk_same_scope(stmt):
                        if not isinstance(sub, ast.Call):
                            continue
                        parts, _base = _tail_chain(sub.func)
                        if len(parts) < 2 or parts[-2:] != ["gauges",
                                                            "get"]:
                            continue
                        if not (sub.args
                                and isinstance(sub.args[0], ast.Constant)
                                and isinstance(sub.args[0].value, str)):
                            continue
                        gname = sub.args[0].value
                        if gname in background:
                            continue
                        detail = (
                            f"gauge {gname!r} is polled here but "
                            "published only from the submit path"
                            if gname in published else
                            f"gauge {gname!r} is polled here but "
                            "never published anywhere in the package"
                        )
                        self._emit(m, sub.lineno, "LV202", detail)

    # ------------------------------------------------ LV301/LV302: ledgers

    def _ledger_calls(self, comp):
        """(ledger, method, call) triples in a component, alias-aware."""
        aliases: dict = {}  # name -> ledger obj
        for n in _walk_component(comp):
            if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                    and isinstance(n.targets[0], ast.Name):
                parts, _base = _tail_chain(n.value)
                for led in LEDGERS:
                    if parts and parts[-1] == led.obj:
                        aliases[n.targets[0].id] = led.obj
        out = []
        for n in _walk_component(comp):
            if not isinstance(n, ast.Call):
                continue
            parts, base = _tail_chain(n.func)
            if not parts:
                continue
            meth = parts[-1]
            for led in LEDGERS:
                known = led.enters + led.exits + led.neutral
                if meth not in known:
                    continue
                if len(parts) >= 2 and parts[-2] == led.obj:
                    out.append((led, meth, n))
                elif len(parts) == 1 and base is not None \
                        and aliases.get(base) == led.obj:
                    out.append((led, meth, n))
        return out

    def _check_ledgers(self, mods) -> None:
        for m in mods:
            for comp in self._components(m):
                calls = self._ledger_calls(comp)
                if not calls:
                    continue
                for led in LEDGERS:
                    enters = [c for l, meth, c in calls
                              if l is led and meth in led.enters]
                    exits = [c for l, meth, c in calls
                             if l is led and meth in led.exits]
                    if enters and not exits:
                        for call in enters:
                            self._emit(
                                m, call.lineno, "LV301",
                                f"{led.obj}.{_call_name(call)} in "
                                f"{comp.name!r} has no "
                                f"{'/'.join(led.exits)} anywhere in the "
                                "component")
                    if enters or exits:
                        self._check_sibling_branches(m, comp, led)

    def _branch_reach(self, m, comp, stmts, depth: int = 0):
        """(reaches_durability, reaches_exit) for one branch, descending
        into same-class methods (the sibling-checkpoint-helper shape)."""
        durable = reaches_exit = False
        cls = m.classes.get(comp.name) \
            if isinstance(comp, ast.ClassDef) else None
        exit_names = {x for led in LEDGERS for x in led.exits}
        for s in stmts:
            for sub in ast.walk(s):
                if not isinstance(sub, ast.Call):
                    continue
                cn = _call_name(sub) or ""
                parts, _base = _tail_chain(sub.func)
                if _DURABILITY_FRAGMENT in cn.lower():
                    durable = True
                if cn in exit_names:
                    reaches_exit = True
                if cls is not None and depth < 5 \
                        and isinstance(sub.func, ast.Attribute) \
                        and isinstance(sub.func.value, ast.Name) \
                        and sub.func.attr in cls.methods:
                    d2, e2 = self._branch_reach(
                        m, comp, cls.methods[sub.func.attr].body,
                        depth + 1)
                    durable = durable or d2
                    reaches_exit = reaches_exit or e2
        return durable, reaches_exit

    def _check_sibling_branches(self, m, comp, led) -> None:
        for n in _walk_component(comp):
            if not isinstance(n, ast.If) or not n.orelse:
                continue
            d_a, e_a = self._branch_reach(m, comp, n.body)
            d_b, e_b = self._branch_reach(m, comp, n.orelse)
            if d_a and d_b and e_a != e_b:
                missing = n.orelse if e_a else n.body
                line = missing[0].lineno if missing else n.lineno
                self._emit(
                    m, line, "LV302",
                    f"both branches of the dispatch at line {n.lineno} "
                    f"in {comp.name!r} publish a checkpoint but only "
                    f"one reaches a {led.obj} exit "
                    f"({'/'.join(led.exits)})")

    # ------------------------------------------- LV303: pending-map inserts

    def _check_pending_maps(self, mods) -> None:
        for m in mods:
            for cls in m.classes.values():
                inserts: dict = {}
                removals: set = set()
                for fname, fn in cls.methods.items():
                    selfname = self._rc._selfname(fn)
                    if selfname is None:
                        continue
                    for n in ast.walk(fn):
                        self._scan_pending(n, selfname, fname, inserts,
                                           removals)
                for attr, node in inserts.items():
                    if attr in removals:
                        continue
                    self._emit(m, node.lineno, "LV303",
                               f"self.{attr} gains entries in "
                               f"{cls.name!r} but nothing ever "
                               "pops/deletes/clears them")

    @staticmethod
    def _scan_pending(n, selfname, fname, inserts, removals) -> None:
        def pending_attr(node):
            attr = _self_attr(node, selfname)
            if attr is not None and _PENDING_ATTR_RE.search(attr):
                return attr
            return None

        if isinstance(n, ast.Assign):
            for tgt in n.targets:
                if isinstance(tgt, ast.Subscript):
                    attr = pending_attr(tgt.value)
                    if attr is not None:
                        inserts.setdefault(attr, n)
                elif fname != "__init__":
                    attr = pending_attr(tgt)
                    # A whole-map reassign outside __init__ resets the
                    # obligation set: counts as a removal path.
                    if attr is not None:
                        removals.add(attr)
        elif isinstance(n, ast.AugAssign):
            attr = pending_attr(n.target)
            if attr is not None:
                if isinstance(n.op, ast.Add):
                    inserts.setdefault(attr, n)
                else:
                    removals.add(attr)
        elif isinstance(n, ast.Delete):
            for tgt in n.targets:
                if isinstance(tgt, ast.Subscript):
                    attr = pending_attr(tgt.value)
                    if attr is not None:
                        removals.add(attr)
        elif isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute):
            if n.func.attr in ("pop", "popitem", "clear", "discard",
                               "remove"):
                attr = pending_attr(n.func.value)
                if attr is not None:
                    removals.add(attr)

    # --------------------------------------------- LV401: thread shutdown

    @staticmethod
    def _has_shutdown_signal(scope: ast.AST) -> bool:
        for n in ast.walk(scope):
            if isinstance(n, ast.Call) \
                    and isinstance(n.func, ast.Attribute):
                if n.func.attr == "join":
                    return True
                if n.func.attr in ("set", "cancel") and not n.args \
                        and not n.keywords:
                    return True
            if isinstance(n, ast.Assign) \
                    and isinstance(n.value, ast.Constant) \
                    and isinstance(n.value.value, bool):
                for tgt in n.targets:
                    name = tgt.attr if isinstance(tgt, ast.Attribute) \
                        else getattr(tgt, "id", None)
                    if name and _STOP_FLAG_RE.search(name):
                        return True
        return False

    @staticmethod
    def _awaits_inline(fn: ast.AST) -> bool:
        """The bounded-handoff idiom: the spawning function itself waits
        for the worker (``done.wait(t)`` / ``t.join()``)."""
        return any(
            isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr in ("wait", "join")
            for n in ast.walk(fn)
        )

    def _check_threads(self, mods) -> None:
        for m in mods:
            for comp in self._components(m):
                spawns = [
                    n for n in _walk_component(comp)
                    if isinstance(n, ast.Call)
                    and (lambda p: p and p[-1] == "Thread")(
                        _tail_chain(n.func)[0])
                    and any(kw.arg == "target" for kw in n.keywords)
                ]
                if not spawns:
                    continue
                if self._has_shutdown_signal(comp):
                    continue
                for call in spawns:
                    # Class scope failed: a method-local bounded
                    # handoff (watchdog style) is still fine.
                    encl = self._enclosing_def(comp, call)
                    if encl is not None and self._awaits_inline(encl):
                        continue
                    self._emit(m, call.lineno, "LV401",
                               f"thread started in {comp.name!r}; no "
                               "join()/Event.set()/stop-flag write "
                               "anywhere in the component")

    @staticmethod
    def _enclosing_def(comp, call):
        """Innermost def of ``comp`` containing ``call`` (by walk)."""
        best = None
        for n in ast.walk(comp):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and any(sub is call for sub in ast.walk(n)):
                if best is None or (n.lineno >= best.lineno
                                    and n is not best):
                    best = n
        return best

    # ------------------------------------------- LV402: socket/file close

    @staticmethod
    def _opens_resource(value: ast.AST) -> bool:
        if not isinstance(value, ast.Call):
            return False
        parts, base = _tail_chain(value.func)
        last = parts[-1] if parts else base
        return last in ("create_connection", "open") \
            or (len(parts) >= 2 and parts[-2:] == ["socket", "socket"]) \
            or (last == "socket" and base == "socket" and len(parts) == 1)

    def _check_resources(self, mods) -> None:
        for m in mods:
            for cls in m.classes.values():
                opens: dict = {}
                closed: set = set()
                for fname, fn in cls.methods.items():
                    selfname = self._rc._selfname(fn)
                    if selfname is None:
                        continue
                    local_opened: set = set()
                    # Locals aliased FROM a self attribute, including
                    # the swap-to-local teardown idiom
                    # (``sock, self._sock = self._sock, None``): a
                    # close on the alias closes the attribute.
                    aliases: dict = {}
                    for n in ast.walk(fn):
                        if isinstance(n, ast.Assign) \
                                and len(n.targets) == 1:
                            tgt = n.targets[0]
                            if isinstance(tgt, ast.Name):
                                if self._opens_resource(n.value):
                                    local_opened.add(tgt.id)
                                attr = _self_attr(n.value, selfname)
                                if attr is not None:
                                    aliases[tgt.id] = attr
                            elif isinstance(tgt, ast.Tuple) \
                                    and isinstance(n.value, ast.Tuple) \
                                    and len(tgt.elts) == len(
                                        n.value.elts):
                                for te, ve in zip(tgt.elts,
                                                  n.value.elts):
                                    if isinstance(te, ast.Name):
                                        attr = _self_attr(ve, selfname)
                                        if attr is not None:
                                            aliases[te.id] = attr
                            attr = _self_attr(tgt, selfname)
                            if attr is None:
                                continue
                            if self._opens_resource(n.value) or (
                                    isinstance(n.value, ast.Name)
                                    and n.value.id in local_opened):
                                opens.setdefault(attr, n)

                    def attr_of(node):
                        attr = _self_attr(node, selfname)
                        if attr is not None:
                            return attr
                        if isinstance(node, ast.Name):
                            return aliases.get(node.id)
                        return None

                    for n in ast.walk(fn):
                        if not isinstance(n, ast.Call):
                            continue
                        if isinstance(n.func, ast.Attribute) \
                                and n.func.attr in ("close", "shutdown"):
                            attr = attr_of(n.func.value)
                            if attr is not None:
                                closed.add(attr)
                        cn = _call_name(n) or ""
                        if "close" in cn.lower():
                            for a in n.args:
                                attr = attr_of(a)
                                if attr is not None:
                                    closed.add(attr)
                for attr, node in opens.items():
                    if attr in closed:
                        continue
                    self._emit(m, node.lineno, "LV402",
                               f"self.{attr} opened in {cls.name!r} but "
                               "no close path touches it")

    # ------------------------------------------------------------- driver

    def lint_paths(self, paths) -> list[Finding]:
        mods = []
        for f in collect_python_files(paths):
            if self._cache.get_or_finding(f, self.findings) is None:
                continue
            m = self._rc.load(f)
            if m is not None:
                mods.append(m)
        for m in mods:
            self._rc._discover_roots(m)
        self._root_closure()
        self._check_loops()
        self._check_accumulators()
        self._check_pause_resume(mods)
        self._check_gauges(mods)
        self._check_ledgers(mods)
        self._check_pending_maps(mods)
        self._check_threads(mods)
        self._check_resources(mods)
        self.findings.sort(key=lambda f: (f.path, f.line, f.rule))
        return self.findings


def lint_paths(package_root: str, paths, cache=None) -> list[Finding]:
    """Convenience wrapper mirroring the other tools: run a fresh
    :class:`LivenessChecker` over ``paths``, optionally sharing a
    parsed :class:`~gelly_torch.analysis.loader.SourceCache`."""
    return LivenessChecker(package_root, cache=cache).lint_paths(paths)
