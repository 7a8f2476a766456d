"""Durability-contract checker: exactly-once / wire-protocol / obs lint.

The system's correctness story rests on a handful of cross-module
disciplines that no single test file owns: acks follow durability, not
receipt (``ingest/server.py``); checkpoint positions are last-RETIRED-
chunk counters, never in-flight sequence numbers (``engine/
aggregation.py``); every persistent write under a checkpoint/manifest
directory goes through the tmp+fsync+rename helpers (``engine/
checkpoint.py`` v2, ``engine/coordination.py``); rotation prunes only
after validating the newest file; receivers never advance a sequence
past bytes whose CRC they could not verify (``ingest/wire.py``). Each
is enforced today by tests that must anticipate the regression. This
module is the declarative floor under them, in the style of
:mod:`gelly_torch.analysis.racecheck`'s PI-invariant table: AST checks
that fail CI when a refactor breaks the contract even if no test
notices. Same ``# graphlint: disable=`` suppression machinery, same
Finding/line-anchor shape, unified under ``python -m
gelly_torch.analysis contracts [paths]``.

**EO — exactly-once / durability rules**

- ``EO001`` ack-after-durability: a ``<server>.ack(...)`` call must be
  dominated (an earlier statement in the same scope) by a durability
  write — ``save_checkpoint``, ``maybe_checkpoint``, or
  ``<manager>.save/flush`` on a checkpoint-ish receiver. An ack with no
  durability point in sight acknowledges RECEIPT, which un-does the
  exactly-once wire resume (a crash between ack and checkpoint loses
  acked chunks forever). The ``auto_ack=True`` half: passing a literal
  ``auto_ack=True`` from a scope that also checkpoints is the same bug
  spelled as configuration. Consumers whose durability point is
  established elsewhere carry a vetted suppression.
- ``EO002`` position provenance: a value passed as the checkpoint
  ``position`` (the ``position=`` keyword or positional slot of
  ``save_checkpoint`` / ``write_shard`` / a checkpoint-manager
  ``.save``) must never derive — through simple assignment chains, the
  GL006 alias discipline — from an in-flight/staged sequence variable
  (``*next_seq*``, ``*staged*``, ``*pending*``, ``*in_flight*``,
  ``*unacked*``, ``*enqueued*``). Checkpointing a staging-side counter
  records chunks the fold never retired; resume then SKIPS them.
  Conservative: only negative evidence flags — retired-counter names
  the walk cannot prove are never findings.
- ``EO003`` atomic-write discipline: a direct ``open(path, "w"/"wb"/
  "a"/...)`` (or ``Path.write_text``/``write_bytes``) whose path
  expression names a durable store (``checkpoint``/``ckpt``/
  ``manifest``/``lease``/``.npz``) bypasses the tmp+fsync+rename
  helpers — a crash mid-write leaves a TORN file where readers expect
  all-or-nothing. Route through ``save_checkpoint`` /
  ``write_json_atomic``.
- ``EO004`` rotation ordering: inside a function whose name contains
  ``rotate``/``prune``, every file deletion (``os.unlink``/
  ``os.remove``/``shutil.rmtree``/``.unlink()``) must be preceded by a
  validation of the newest artifact (``read_checkpoint_header``,
  ``load_checkpoint``, or any ``*validate*`` callee) with an abort
  path (``return``/``raise``/``continue``) between the validation and
  the delete. Pruning fallbacks before the newest file is proven
  readable can leave a rotation with ZERO valid checkpoints after a
  torn final write.

**WP — wire-protocol rules** (order-of-operations over any module that
consumes :func:`gelly_torch.ingest.wire.read_frame_checked`):

- ``WP001`` CRC before advance: in a scope that unpacks
  ``read_frame_checked``'s ``(type, seq, payload, crc_ok)``, any
  expected-sequence advance (a store to a ``*next_seq*``/``*expect*``
  attribute) or staging call (``_enqueue``/``put``/``put_nowait``)
  must be dominated by an ``if`` on the CRC flag whose body aborts
  (``continue``/``return``/``raise``). Advancing past unverifiable
  bytes converts a transient corruption into a permanent gap. (Callers
  of the raising :func:`~gelly_torch.ingest.wire.read_frame` variant are
  exempt — the CRC check happens before they see the frame.)
- ``WP002`` reject/truncation paths are read-only: an ``except``
  handler for ``TruncatedFrame``/``CrcMismatch``/``FrameError``, and
  any ``if`` branch that sends a REJECT frame (``pack_frame(REJECT,
  ...)``), must not store to sequence/ack attributes or stage
  payloads. A refused frame that still mutates protocol state breaks
  the retransmit contract from both ends.
- ``WP003`` resend-buffer trim discipline: deletions from a client
  resend buffer (an attribute matching ``*unacked*``/``*resend*``)
  must be contiguous-prefix trims — a ``del`` inside a ``for`` whose
  iteration filters ``< bound`` against an ack-derived bound
  (``*acked*``, ``server_next``, ``upto``, a frame ``seq``).
  ``.pop``/``.clear``/``.popitem`` on the buffer are flagged
  unconditionally: dropping an un-acked frame makes the
  crash-resume retransmit impossible.

**AL — alert-plane isolation rules** (the push-alert channel is
best-effort BY CONTRACT — ``ingest/wire.py`` documents ALERT delivery
as outside the exactly-once data seq space):

- ``AL001`` alert sends must be stateless w.r.t. the data protocol: a
  scope that sends an ALERT frame (``pack_frame(ALERT, ...)``) must
  not store to sequence/ack attributes (``*next_seq*``/``*expect*``/
  ``*acked*``), register frames into a resend buffer
  (``*unacked*``/``*resend*``), or stage payloads
  (``_enqueue``/``put``/``put_nowait``). An alert push that touches
  seq/ack/resend state silently couples the lossy channel to the
  exactly-once one — a dropped alert would then corrupt data-stream
  bookkeeping.

**OB — observability drift rules** (OB001/OB002 activate only when the
lint set includes the glossary module — a ``bus.py`` whose docstring
carries the ``\\`\\`subsystem.name\\`\\`` table; OB002 additionally
requires the set to span the glossary's whole top-level package, since
"no emitting call site" on a partial subset is under-collection, not
dead docs. OB003 is glossary-free — the collision is a property of the
call sites alone):

- ``OB001`` undocumented name: every string-literal name passed to a
  bus ``inc``/``gauge``/``emit``/``observe`` anywhere in the linted
  set must appear in the glossary (histograms — ``observe`` sites —
  have their own glossary section in ``obs/bus.py``, covered by the
  same rule). Prefixed f-string names (``f"{prefix}.checkpoints"``)
  are matched as ``*.suffix`` wildcards — documented when any glossary
  entry ends with the suffix, flagged when none does; fully dynamic
  names are skipped (documented limitation).
- ``OB002`` dead glossary entry: a documented name no call site emits
  (exact or wildcard, histograms included) — stale docs that misdirect
  an operator mid-incident. Anchored at the glossary line in
  ``bus.py``.
- ``OB003`` metric-kind collision: one name published through more
  than one of counter (``inc``/``emit``), gauge (``gauge``) and
  histogram (``observe``) — exporters and dashboards treat the kinds
  as different metric types, so a collision silently shadows one of
  them. Flagged at every site except the lowest-precedence kind's
  (counter < gauge < histogram).

Findings carry ``path:line`` anchors and render like every other
analysis finding; the CLI exit code is non-zero iff any unsuppressed
finding exists. Conservative by construction: domination is statement
order within one scope (helpers that ack/checkpoint across function
boundaries need a suppression, with the justification comment the
RC006 precedent set), taint follows simple ``name = expr`` rebinds
only, and the OB family resolves constant and single-prefix names
only. A missed violation is possible; a finding is real unless the
line carries a reviewed suppression.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re

from . import Finding, collect_python_files
from .astutil import _attr_chain, suppressed as _line_suppressed
from .racecheck import _walk_same_scope

RULES: dict[str, tuple[str, str]] = {
    "EO001": (
        "ack without a dominating durability write",
        "acks must follow the consumer's durability point, not receipt: "
        "checkpoint (save_checkpoint / manager.save) BEFORE acking the "
        "covered sequences, or use auto_ack=False and ack from the "
        "checkpoint path — a crash between ack and checkpoint loses "
        "acked chunks forever",
    ),
    "EO002": (
        "checkpoint position derives from an in-flight sequence",
        "the recorded position must count RETIRED chunks only (folds "
        "dispatched into the summary): a staged/next-seq value records "
        "chunks the fold never consumed and resume silently skips them",
    ),
    "EO003": (
        "direct write into a durable store path",
        "persistent checkpoint/manifest/lease files must go through the "
        "atomic helpers (save_checkpoint, write_json_atomic): a bare "
        "open(.., 'w') can tear mid-write and readers expect "
        "all-or-nothing",
    ),
    "EO004": (
        "rotation prunes before validating the newest file",
        "validate the just-written newest artifact (read_checkpoint_"
        "header / load_checkpoint) with an abort path BEFORE deleting "
        "fallbacks — otherwise a torn final write leaves the rotation "
        "with zero valid checkpoints",
    ),
    "WP001": (
        "sequence advanced or payload staged before the CRC check",
        "never advance the expected seq (or stage a payload) past bytes "
        "the CRC did not vouch for: test the read_frame_checked flag "
        "first and reject/abort on mismatch",
    ),
    "WP002": (
        "REJECT/truncation path mutates protocol state",
        "a refused or torn frame must leave seq/ack state and the "
        "staging queue untouched — the sender retransmits against the "
        "state the receiver advertised, so a mutation here desyncs the "
        "stream",
    ),
    "WP003": (
        "resend buffer trimmed outside an ack-covered prefix",
        "the resend buffer is exactly the chunks a server crash could "
        "lose: trim only frames below an ack-derived bound "
        "(for s in [s for s in buf if s < acked]); a clear() or "
        "arbitrary pop() makes crash-resume retransmit impossible",
    ),
    "OB001": (
        "bus name missing from the obs/bus.py glossary",
        "every counter/gauge/event name must be documented in the "
        "module-docstring table — the glossary is the operator's map "
        "from a dashboard line to the code that publishes it",
    ),
    "OB002": (
        "glossary entry no call site emits",
        "dead docs misdirect an operator mid-incident: delete the "
        "entry or re-point it at the name the code actually publishes",
    ),
    "AL001": (
        "alert-sending scope mutates exactly-once protocol state",
        "ALERT delivery is best-effort by contract: a scope that packs "
        "an ALERT frame must not store to seq/ack attributes, register "
        "into a resend buffer, or stage payloads — keep the push "
        "closure read-only w.r.t. the data protocol so a dropped alert "
        "can never corrupt data-stream bookkeeping",
    ),
    "OB003": (
        "one name published under more than one metric kind",
        "exporters treat counters, gauges and histograms as different "
        "metric types — publishing one name through more than one of "
        "inc/emit, gauge() and observe() silently shadows one of them; "
        "split the names",
    ),
}

# EO001: callees that establish a durability point. ``save``/``flush``
# count only on a checkpoint-ish receiver (see _CKPT_RECV).
_DURABILITY_CALLEES = {"save_checkpoint", "maybe_checkpoint"}
_CKPT_RECV_METHODS = {"save", "flush"}
_CKPT_RECV = ("manager", "ckpt", "checkpoint")
# EO002: identifier fragments that mean "not yet retired".
_BAD_POSITION = re.compile(
    r"next_?seq|staged|pending|in_?flight|unacked|enqueued")
# EO002: position-carrying checkpoint writers -> positional slot of the
# position argument (None = keyword-only resolution).
_POSITION_CALLEES = {"save_checkpoint": 2, "write_shard": 3, "save": 1}
# EO003: path-source fragments that mark a durable store.
_DURABLE_PATH_MARKERS = ("checkpoint", "ckpt", "manifest", "lease", ".npz")
# EO004 scope + vocabulary.
_ROTATION_FN = re.compile(r"rotate|prune")
_DELETERS = {"unlink", "remove", "rmtree"}
_VALIDATORS = {"read_checkpoint_header", "load_checkpoint"}
# WP vocabulary.
_SEQ_ATTR = re.compile(r"next_seq|expect")
_WP2_ATTR = re.compile(r"next_seq|expect|acked")
_STAGERS = {"_enqueue", "put", "put_nowait"}
_WIRE_EXCS = {"TruncatedFrame", "CrcMismatch", "FrameError"}
_RESEND_BUF = re.compile(r"unacked|resend")
# WP003 trim bounds: ack-derived names bless a prefix trim — but never
# when the bound is itself an in-flight counter (_BAD_POSITION): a trim
# below self._next_seq is clear() spelled as a filter.
_ACK_BOUND = re.compile(r"acked|server_next|upto|(^|[^a-z])seq$")
# OB: a glossary table row — a DOTTED ``subsystem.name`` at column 0 of
# the bus module (prose backtick spans are mid-line or undotted).
_GLOSSARY_RE = re.compile(r"^``([a-z_][a-z0-9_]*(?:\.[a-z0-9_]+)+)``")
_BUS_METHODS = {"inc": "counter", "emit": "counter", "gauge": "gauge",
                "observe": "histogram"}
# OB003: when one name is published through several kinds, the sites of
# every kind except the LOWEST-precedence one are flagged (deterministic
# single-side anchoring, so the tip never double-reports a collision).
_KIND_ORDER = {"counter": 0, "gauge": 1, "histogram": 2}


@dataclasses.dataclass
class _Mod:
    path: str
    tree: ast.Module
    lines: list


@dataclasses.dataclass
class _EmitSite:
    """One ``bus.inc/gauge/emit`` call with a resolvable name."""

    name: str              # exact dotted name, or ".suffix" for wildcard
    wildcard: bool         # f"{prefix}.suffix" form
    kind: str              # counter | gauge
    node: ast.AST
    module: _Mod


def _same_scope(nodes) -> list:
    """Every AST node under a statement suite, pruned at nested
    function/class/lambda scopes (their bodies run later, under their
    own contracts). One pruning rule for the whole analysis package:
    delegates to :func:`racecheck._walk_same_scope` per statement."""
    out: list = []
    for b in nodes:
        if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda, ast.ClassDef)):
            continue
        out.extend(_walk_same_scope(b))
    return out


def _scope_nodes(scope: ast.AST) -> list:
    """:func:`_same_scope` over ``scope``'s own body, sorted in source
    order."""
    out = _same_scope(scope.body)
    out.sort(key=lambda n: (getattr(n, "lineno", 0),
                            getattr(n, "col_offset", 0)))
    return out


def _unparse(node: ast.AST) -> str:
    try:
        return ast.unparse(node).lower()
    except Exception:  # noqa: BLE001 — unparse of synthetic nodes
        return ""


def _ident_roots(expr: ast.AST) -> set:
    """Plain names and attribute tails an expression reads — the
    identifiers the EO002 taint walk reasons about."""
    ids: set = set()
    for n in ast.walk(expr):
        if isinstance(n, ast.Name):
            ids.add(n.id)
        elif isinstance(n, ast.Attribute):
            ids.add(n.attr)
    return ids


def _iter_scopes(tree: ast.Module):
    """The module itself plus every (async) function def, each analyzed
    as its own scope."""
    yield tree
    for n in ast.walk(tree):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield n


class ContractChecker:
    """Whole-package durability/wire/observability contract lint."""

    def __init__(self, package_root: str, cache=None):
        from .loader import SourceCache

        self.package_root = os.path.abspath(package_root)
        self.findings: list[Finding] = []
        self._modules: dict[str, _Mod] = {}
        self._cache = cache or SourceCache()
        # OB state, accumulated across every linted module.
        self._glossary: dict[str, tuple[int, _Mod]] = {}  # name -> line
        self._emits: list[_EmitSite] = []

    # ------------------------------------------------------------ loading

    def load(self, path: str) -> _Mod | None:
        path = os.path.abspath(path)
        if path in self._modules:
            return self._modules[path]
        ms = self._cache.get(path)
        if ms is None:
            return None
        m = _Mod(path=path, tree=ms.tree, lines=ms.lines)
        self._modules[path] = m
        return m

    def lint_paths(self, paths) -> list[Finding]:
        mods = []
        for f in collect_python_files(paths):
            if self._cache.get_or_finding(f, self.findings) is None:
                continue
            mods.append(self.load(f))
        for m in mods:
            if os.path.basename(m.path) == "bus.py":
                self._load_glossary(m)
        for m in mods:
            for scope in _iter_scopes(m.tree):
                self._check_scope(m, scope)
            self._collect_emits(m)
        self._emit_ob_findings()
        self.findings.sort(key=lambda f: (f.path, f.line, f.rule))
        return self.findings

    # ----------------------------------------------------- finding emits

    def _emit(self, m: _Mod, node: ast.AST, rule: str, detail: str) -> None:
        line = getattr(node, "lineno", 0)
        if _line_suppressed(m.lines, line, rule):
            return
        summary, hint = RULES[rule]
        f = Finding(m.path, line, rule, f"{summary}: {detail}", hint=hint)
        if f not in self.findings:
            self.findings.append(f)

    # -------------------------------------------------------- EO family

    def _check_scope(self, m: _Mod, scope: ast.AST) -> None:
        nodes = _scope_nodes(scope)
        calls = [n for n in nodes if isinstance(n, ast.Call)]
        fname = getattr(scope, "name", "<module>")
        # Simple-assignment index shared by the EO002/EO003 taint chase.
        assigns_by_name: dict = {}
        for n in nodes:
            if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                    and isinstance(n.targets[0], ast.Name):
                assigns_by_name.setdefault(n.targets[0].id, []).append(n)
        self._eo001(m, nodes, calls, fname)
        self._eo002(m, assigns_by_name, calls, fname)
        self._eo003(m, assigns_by_name, calls, fname)
        self._eo004(m, nodes, calls, fname)
        self._wp001(m, nodes, calls, fname)
        self._wp002(m, nodes, fname)
        self._wp003(m, nodes, fname)
        self._al001(m, nodes, calls, fname)

    def _durability_lines(self, calls) -> list:
        out = []
        for c in calls:
            chain = _attr_chain(c.func)
            last = chain[-1] if chain else None
            if last in _DURABILITY_CALLEES:
                out.append(c.lineno)
            elif (last in _CKPT_RECV_METHODS
                    and isinstance(c.func, ast.Attribute)
                    and any(mk in _unparse(c.func.value)
                            for mk in _CKPT_RECV)):
                out.append(c.lineno)
        return out

    def _eo001(self, m, nodes, calls, fname) -> None:
        durable = self._durability_lines(calls)
        for c in calls:
            if isinstance(c.func, ast.Attribute) and c.func.attr == "ack":
                if not any(d < c.lineno for d in durable):
                    self._emit(
                        m, c, "EO001",
                        f"{_unparse(c.func)}() in {fname!r} with no "
                        "earlier durability write in scope",
                    )
            for kw in c.keywords:
                if (kw.arg == "auto_ack"
                        and isinstance(kw.value, ast.Constant)
                        and kw.value.value is True and durable):
                    self._emit(
                        m, kw.value, "EO001",
                        f"auto_ack=True in {fname!r}, a scope that also "
                        "checkpoints — receipt-acks undo the "
                        "exactly-once resume",
                    )

    @staticmethod
    def _position_exprs(call):
        chain = _attr_chain(call.func)
        last = chain[-1] if chain else None
        if last not in _POSITION_CALLEES:
            return []
        if last == "save" and not (
                isinstance(call.func, ast.Attribute)
                and any(mk in _unparse(call.func.value)
                        for mk in _CKPT_RECV)):
            return []
        out = [kw.value for kw in call.keywords if kw.arg == "position"]
        slot = _POSITION_CALLEES[last]
        if not out and len(call.args) > slot:
            out.append(call.args[slot])
        return out

    @staticmethod
    def _chase_bindings(assigns_by_name, expr, at_line) -> tuple:
        """``(ids, bindings)``: names/attr-tails reaching ``expr``
        (read at ``at_line``) through simple assignment chains, plus
        the Assign nodes traversed. Flow-sensitive per EDGE: a name
        referenced at line L resolves through its latest binding
        strictly BEFORE L — never a later rebind — so tentative values
        overwritten before the read stay clean ("a finding is real"
        beats taint recall). Terminates: lines strictly decrease along
        every chain edge."""
        ids: set = set()
        bindings: list = []
        work = [(nm, at_line) for nm in _ident_roots(expr)]
        seen: set = set()
        while work:
            nm, line = work.pop()
            if (nm, line) in seen:
                continue
            seen.add((nm, line))
            ids.add(nm)
            best = None
            for a in assigns_by_name.get(nm, ()):
                if a.lineno < line and (best is None
                                        or a.lineno > best.lineno):
                    best = a
            if best is not None:
                bindings.append(best)
                for sub in _ident_roots(best.value):
                    work.append((sub, best.lineno))
        return ids, bindings

    def _eo002(self, m, assigns_by_name, calls, fname) -> None:
        # Assignment-chain taint (the GL006 alias discipline):
        # `pos = self._next_seq; save(..., position=pos)` is the same
        # bug one rebind later.
        for c in calls:
            for expr in self._position_exprs(c):
                ids, _bindings = self._chase_bindings(
                    assigns_by_name, expr, c.lineno)
                bad = sorted(i for i in ids
                             if _BAD_POSITION.search(i.lower()))
                if bad:
                    self._emit(
                        m, c, "EO002",
                        f"position {_unparse(expr)!r} in {fname!r} "
                        f"derives from in-flight value(s) "
                        f"{', '.join(bad)}",
                    )

    @staticmethod
    def _open_mode(call) -> str | None:
        """The mode string of an ``open``-style call: the ``mode=``
        keyword, or the first short positional string that looks like a
        mode (covers both ``open(path, "w")`` and ``Path(p).open("w")``
        arg orders). None when unresolvable (defaults to "r": skip)."""
        for kw in call.keywords:
            if kw.arg == "mode" and isinstance(kw.value, ast.Constant) \
                    and isinstance(kw.value.value, str):
                return kw.value.value
        for a in call.args[:2]:
            if isinstance(a, ast.Constant) and isinstance(a.value, str) \
                    and 0 < len(a.value) <= 3 \
                    and set(a.value) <= set("rwxab+tU"):
                return a.value
        return None

    def _eo003(self, m, assigns_by_name, calls, fname) -> None:
        for c in calls:
            chain = _attr_chain(c.func)
            path_exprs: list = []
            mode = None
            if isinstance(c.func, ast.Name) and c.func.id == "open":
                mode = self._open_mode(c)
                if c.args:
                    path_exprs.append(c.args[0])
            elif isinstance(c.func, ast.Attribute) and c.func.attr == "open" \
                    and not (chain and chain[0] == "os"):
                # Path(p).open("w") (receiver IS the path) and
                # module-style io/gzip.open(p, "w") (args[0] is) — scan
                # both sources; os.open's flag ints never parse as a
                # mode, and os is excluded outright.
                mode = self._open_mode(c)
                path_exprs.append(c.func.value)
                if c.args and not (
                        isinstance(c.args[0], ast.Constant)
                        and isinstance(c.args[0].value, str)
                        and c.args[0].value == mode):
                    path_exprs.append(c.args[0])
            elif (isinstance(c.func, ast.Attribute)
                    and c.func.attr in ("write_text", "write_bytes")):
                mode = "w"
                path_exprs.append(c.func.value)
            if mode is None or not any(ch in mode for ch in "wax+"):
                continue
            # Marker scan covers the expression AND the bindings it
            # reads through (the same chase EO002 uses): hoisting the
            # path into a local (`target = dir + "/MANIFEST.json";
            # open(target, "w")`) must not launder the marker.
            path_srcs: list = []
            for e in path_exprs:
                path_srcs.append(_unparse(e))
                _ids, bindings = self._chase_bindings(
                    assigns_by_name, e, c.lineno)
                path_srcs.extend(_unparse(b.value) for b in bindings)
            for psrc in path_srcs:
                hit = [mk for mk in _DURABLE_PATH_MARKERS if mk in psrc]
                if hit:
                    self._emit(
                        m, c, "EO003",
                        f"direct write to {psrc!r} in {fname!r} (marker "
                        f"{hit[0]!r}) — use the tmp+fsync+rename helpers",
                    )
                    break

    def _eo004(self, m, nodes, calls, fname) -> None:
        if not _ROTATION_FN.search(fname.lower()):
            return
        validators = [
            c.lineno for c in calls
            if (chain := _attr_chain(c.func))
            and (chain[-1] in _VALIDATORS or "validate" in chain[-1].lower())
        ]
        aborts = [n.lineno for n in nodes
                  if isinstance(n, (ast.Return, ast.Raise, ast.Continue))]
        # A delete nested inside an `if` that FOLLOWS the validation is
        # the positive-guard spelling of the same abort path (`if header
        # is not None: <prune>`): the fall-through is the abort.
        if_spans = [
            (n.lineno,
             n.body[0].lineno if n.body else n.lineno,
             getattr(n.body[-1], "end_lineno", n.lineno) if n.body
             else n.lineno)
            for n in nodes if isinstance(n, ast.If)
        ]
        for c in calls:
            chain = _attr_chain(c.func)
            if not chain or chain[-1] not in _DELETERS:
                continue
            ok = any(
                v < c.lineno and (
                    any(v <= a < c.lineno for a in aborts)
                    or any(v <= if_line and lo <= c.lineno <= hi
                           for if_line, lo, hi in if_spans)
                )
                for v in validators
            )
            if not ok:
                self._emit(
                    m, c, "EO004",
                    f"{'.'.join(chain)}() in {fname!r} with no earlier "
                    "newest-file validation + abort path",
                )

    # -------------------------------------------------------- WP family

    @staticmethod
    def _crc_negated(test, crc_names) -> bool:
        """True when the CRC NAME ITSELF is negated in ``test`` —
        ``not crc_ok`` / ``crc_ok == False`` / ``crc_ok is False``. A
        ``not`` over some OTHER operand (``crc_ok and not seen``) must
        not flip the guard's polarity."""
        def refs_crc(node):
            return any(isinstance(y, ast.Name) and y.id in crc_names
                       for y in ast.walk(node))

        for x in ast.walk(test):
            if isinstance(x, ast.UnaryOp) and isinstance(x.op, ast.Not) \
                    and refs_crc(x.operand):
                return True
            if isinstance(x, ast.Compare) and refs_crc(x.left) \
                    and any(isinstance(op, (ast.Eq, ast.Is))
                            for op in x.ops) \
                    and any(isinstance(c, ast.Constant)
                            and c.value is False
                            for c in x.comparators):
                return True
        return False

    def _wp001(self, m, nodes, calls, fname) -> None:
        unpack_line = None
        crc_names: set = set()
        for n in nodes:
            if not (isinstance(n, ast.Assign) and len(n.targets) == 1
                    and isinstance(n.targets[0], ast.Tuple)
                    and len(n.targets[0].elts) == 4
                    and isinstance(n.value, ast.Call)):
                continue
            chain = _attr_chain(n.value.func)
            if chain and chain[-1] == "read_frame_checked" and all(
                    isinstance(e, ast.Name) for e in n.targets[0].elts):
                crc_names.add(n.targets[0].elts[3].id)
                if unpack_line is None or n.lineno < unpack_line:
                    unpack_line = n.lineno
        if unpack_line is None:
            return
        # Two guard shapes dominate a mutation: an abort-style
        # `if not crc_ok: continue/return/raise` at an earlier line, or
        # the mutation sitting INSIDE the body of a positive
        # `if crc_ok:` branch (no `not` in the test). A mutation inside
        # the NEGATED branch's own body is the canonical violation
        # (advancing on the reject path) — the guard must never bless
        # the statements it is supposed to be aborting around.
        def _span(suite):
            if not suite:
                return None
            return (suite[0].lineno,
                    getattr(suite[-1], "end_lineno", suite[-1].lineno))

        guards = []
        blessed_spans = []
        abort_spans = []
        for n in nodes:
            if not (isinstance(n, ast.If)
                    and any(isinstance(x, ast.Name) and x.id in crc_names
                            for x in ast.walk(n.test))):
                continue
            negated = self._crc_negated(n.test, crc_names)
            body_span, else_span = _span(n.body), _span(n.orelse)
            if negated:
                # `if not crc_ok:` — the BODY is the reject path (its
                # mutations are the canonical violation); only an abort
                # IN THAT BODY dominates what follows — a return on the
                # success path (the else) proves nothing about the
                # fall-through, which still runs on CRC failure. The
                # else branch is the verified path, blessed like a
                # positive body.
                if any(isinstance(x, (ast.Continue, ast.Return,
                                      ast.Raise))
                       for stmt in n.body for x in ast.walk(stmt)):
                    guards.append(n.lineno)
                if body_span is not None:
                    abort_spans.append(body_span)
                if else_span is not None:
                    blessed_spans.append(else_span)
            else:
                # `if crc_ok:` — the body is the verified path; the
                # else (and any fall-through, which gets no blessing)
                # runs only on failure. A positive guard's line must
                # NEVER bless later statements: `if crc_ok: return x`
                # followed by a seq advance is the reject path too.
                if body_span is not None:
                    blessed_spans.append(body_span)
                if else_span is not None:
                    abort_spans.append(else_span)

        def flag(node, what):
            in_abort_body = any(lo <= node.lineno <= hi
                                for lo, hi in abort_spans)
            if not in_abort_body and (
                    node.lineno <= unpack_line
                    or any(g < node.lineno for g in guards)
                    or any(lo <= node.lineno <= hi
                           for lo, hi in blessed_spans)):
                return
            self._emit(
                m, node, "WP001",
                f"{what} in {fname!r} not dominated by a CRC-flag "
                "guard with an abort",
            )

        for n in nodes:
            tgts = []
            if isinstance(n, ast.Assign):
                tgts = n.targets
            elif isinstance(n, ast.AugAssign):
                tgts = [n.target]
            for t in tgts:
                if isinstance(t, ast.Attribute) \
                        and _SEQ_ATTR.search(t.attr):
                    flag(n, f"store to {t.attr!r}")
        for c in calls:
            chain = _attr_chain(c.func)
            if chain and chain[-1] in _STAGERS:
                flag(c, f"staging call {chain[-1]}()")

    def _wp2_mutations(self, body):
        """(node, what) protocol-state mutations in a statement suite
        (same-scope walk: a nested def's body runs later, under its own
        contract, so it neither mutates nor rejects HERE)."""
        out = []
        for n in _same_scope(body):
            tgts = []
            if isinstance(n, ast.Assign):
                tgts = n.targets
            elif isinstance(n, ast.AugAssign):
                tgts = [n.target]
            for t in tgts:
                if isinstance(t, ast.Attribute) \
                        and _WP2_ATTR.search(t.attr):
                    out.append((n, f"store to {t.attr!r}"))
            if isinstance(n, ast.Call):
                chain = _attr_chain(n.func)
                if chain and chain[-1] in _STAGERS:
                    out.append((n, f"staging call {chain[-1]}()"))
        out.sort(key=lambda p: getattr(p[0], "lineno", 0))
        return out

    @staticmethod
    def _sends_reject(body) -> bool:
        for n in _same_scope(body):
            if isinstance(n, ast.Call):
                chain = _attr_chain(n.func)
                if chain and chain[-1] == "pack_frame" and n.args \
                        and "reject" in _unparse(n.args[0]):
                    return True
        return False

    def _wp002(self, m, nodes, fname) -> None:
        for n in nodes:
            if isinstance(n, ast.Try):
                for h in n.handlers:
                    if h.type is None:
                        continue
                    excs = {x.attr for x in ast.walk(h.type)
                            if isinstance(x, ast.Attribute)}
                    excs |= {x.id for x in ast.walk(h.type)
                             if isinstance(x, ast.Name)}
                    if not excs & _WIRE_EXCS:
                        continue
                    for node, what in self._wp2_mutations(h.body):
                        self._emit(
                            m, node, "WP002",
                            f"{what} inside the "
                            f"{'/'.join(sorted(excs & _WIRE_EXCS))} "
                            f"handler in {fname!r}",
                        )
            elif isinstance(n, ast.If):
                for branch in (n.body, n.orelse):
                    if branch and self._sends_reject(branch):
                        for node, what in self._wp2_mutations(branch):
                            self._emit(
                                m, node, "WP002",
                                f"{what} in a REJECT-sending branch of "
                                f"{fname!r}",
                            )

    def _wp003(self, m, nodes, fname) -> None:
        # Guarded spans: for-loops whose iteration source filters the
        # buffer with `< ack_bound` — the contiguous-prefix trim idiom.
        spans = []
        for n in nodes:
            if not isinstance(n, ast.For):
                continue
            bounded = any(
                isinstance(cmp, ast.Compare)
                and any(isinstance(op, (ast.Lt, ast.LtE))
                        for op in cmp.ops)
                and any(_ACK_BOUND.search(_unparse(c))
                        and not _BAD_POSITION.search(_unparse(c))
                        for c in cmp.comparators)
                for cmp in ast.walk(n.iter)
            )
            if bounded:
                spans.append((n.lineno, getattr(n, "end_lineno", n.lineno)))
        for n in nodes:
            if isinstance(n, ast.Delete):
                for t in n.targets:
                    if not (isinstance(t, ast.Subscript)
                            and isinstance(t.value, ast.Attribute)
                            and _RESEND_BUF.search(t.value.attr)):
                        continue
                    if not any(lo <= n.lineno <= hi for lo, hi in spans):
                        self._emit(
                            m, n, "WP003",
                            f"del {t.value.attr}[...] in {fname!r} "
                            "outside an ack-bounded prefix trim",
                        )
            elif isinstance(n, ast.Call) \
                    and isinstance(n.func, ast.Attribute) \
                    and n.func.attr in ("pop", "clear", "popitem") \
                    and isinstance(n.func.value, ast.Attribute) \
                    and _RESEND_BUF.search(n.func.value.attr):
                self._emit(
                    m, n, "WP003",
                    f"{n.func.value.attr}.{n.func.attr}() in {fname!r} "
                    "— resend frames may only be dropped below an "
                    "ack-derived bound",
                )

    # -------------------------------------------------------- AL family

    def _al001(self, m, nodes, calls, fname) -> None:
        # Scope sends ALERT frames? Then the whole scope must be
        # read-only w.r.t. the exactly-once protocol: no seq/ack
        # stores, no resend-buffer registration, no staging.
        sends_alert = any(
            (chain := _attr_chain(c.func)) and chain[-1] == "pack_frame"
            and c.args and "alert" in _unparse(c.args[0])
            for c in calls
        )
        if not sends_alert:
            return
        for node, what in self._wp2_mutations(nodes):
            self._emit(
                m, node, "AL001",
                f"{what} in the ALERT-sending scope {fname!r}",
            )
        for n in nodes:
            tgts = []
            if isinstance(n, ast.Assign):
                tgts = n.targets
            elif isinstance(n, ast.AugAssign):
                tgts = [n.target]
            for t in tgts:
                if isinstance(t, ast.Subscript) \
                        and isinstance(t.value, ast.Attribute) \
                        and _RESEND_BUF.search(t.value.attr):
                    self._emit(
                        m, n, "AL001",
                        f"resend-buffer registration into "
                        f"{t.value.attr!r} in the ALERT-sending scope "
                        f"{fname!r}",
                    )

    # -------------------------------------------------------- OB family

    def _covers_package_of(self, gm: _Mod) -> bool:
        """True when the linted file set spans the glossary module's
        whole top-level package (every .py under it was loaded) — the
        precondition for OB002's "no emitting call site" to mean dead
        docs rather than an under-collected subset."""
        d = os.path.dirname(gm.path)
        while os.path.exists(os.path.join(d, "__init__.py")) \
                and os.path.exists(os.path.join(
                    os.path.dirname(d), "__init__.py")):
            d = os.path.dirname(d)
        for dirpath, _dirs, files in os.walk(d):
            if "__pycache__" in dirpath:
                continue
            for f in files:
                if f.endswith(".py") \
                        and os.path.join(dirpath, f) not in self._modules:
                    return False
        return True

    def _load_glossary(self, m: _Mod) -> None:
        for i, line in enumerate(m.lines, 1):
            gm = _GLOSSARY_RE.match(line)
            if gm:
                self._glossary.setdefault(gm.group(1), (i, m))

    def _collect_emits(self, m: _Mod) -> None:
        for n in ast.walk(m.tree):
            if not (isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and n.func.attr in _BUS_METHODS and n.args):
                continue
            recv = n.func.value
            # The receiver must BE a bus: a name/attr whose tail is
            # `bus`/`*_bus`, or a get_bus() call — substring matching
            # would collect busy_tracker.gauge(...) and fail CI on a
            # call that never touches the bus.
            rchain = _attr_chain(recv)
            busish = (
                rchain is not None
                and (rchain[-1] == "bus" or rchain[-1].endswith("_bus"))
            ) or (
                isinstance(recv, ast.Call)
                and (chain := _attr_chain(recv.func)) is not None
                and chain[-1] == "get_bus"
            )
            if not busish:
                continue
            kind = _BUS_METHODS[n.func.attr]
            arg = n.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                self._emits.append(_EmitSite(arg.value, False, kind, n, m))
            elif isinstance(arg, ast.JoinedStr) and arg.values:
                last = arg.values[-1]
                if (isinstance(last, ast.Constant)
                        and isinstance(last.value, str)
                        and last.value.startswith(".")):
                    self._emits.append(
                        _EmitSite(last.value, True, kind, n, m))
            # Fully dynamic names (a bare variable) are unresolvable —
            # skipped, per the module contract.

    def _emit_ob_findings(self) -> None:
        exact = {s.name for s in self._emits if not s.wildcard}
        suffixes = {s.name for s in self._emits if s.wildcard}
        if self._glossary:
            for s in self._emits:
                if s.wildcard:
                    # A prefixed family is documented when ANY glossary
                    # entry carries its suffix (one representative name
                    # per family).
                    if not any(g.endswith(s.name) for g in self._glossary):
                        self._emit(
                            s.module, s.node, "OB001",
                            f"prefixed name '*{s.name}' ({s.kind}) "
                            "matches no glossary entry",
                        )
                elif s.name not in self._glossary:
                    self._emit(
                        s.module, s.node, "OB001",
                        f"{s.name!r} ({s.kind}) is not documented in "
                        "the glossary table",
                    )
            covered_pkgs: dict = {}
            for gname, (line, gm) in sorted(self._glossary.items()):
                # Dead-entry detection needs the WHOLE package's emit
                # surface: on a partial lint set (a single subdir),
                # every entry emitted elsewhere would false-flag. Per
                # glossary MODULE (cached — other modules' entries are
                # still checked).
                if gm.path not in covered_pkgs:
                    covered_pkgs[gm.path] = self._covers_package_of(gm)
                if not covered_pkgs[gm.path]:
                    continue
                covered = gname in exact or any(
                    gname.endswith(sfx) for sfx in suffixes)
                if not covered:
                    anchor = ast.Constant(gname)
                    anchor.lineno = line
                    self._emit(
                        gm, anchor, "OB002",
                        f"glossary entry {gname!r} has no emitting "
                        "call site",
                    )
        kinds: dict[str, set] = {}
        for s in self._emits:
            if not s.wildcard:
                kinds.setdefault(s.name, set()).add(s.kind)
        for s in self._emits:
            if s.wildcard:
                continue
            seen = kinds.get(s.name, set())
            if len(seen) < 2:
                continue
            # Anchor at every site except the lowest-precedence kind's
            # (counter < gauge < histogram): a counter+histogram clash
            # flags the observe() sites, counter+gauge the gauge()
            # sites — one deterministic side per collision.
            lowest = min(seen, key=_KIND_ORDER.__getitem__)
            if s.kind != lowest:
                others = ", ".join(sorted(seen - {s.kind}))
                self._emit(
                    s.module, s.node, "OB003",
                    f"{s.name!r} is published as a {s.kind} here and "
                    f"as a {others} elsewhere",
                )


def lint_paths(package_root: str, paths, cache=None) -> list[Finding]:
    """Convenience wrapper mirroring
    :func:`racecheck.lint_paths`: run a fresh :class:`ContractChecker`
    over ``paths``, optionally sharing a parsed
    :class:`~gelly_torch.analysis.loader.SourceCache`."""
    return ContractChecker(package_root, cache=cache).lint_paths(paths)
