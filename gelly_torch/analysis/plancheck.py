"""Compiled-plan contract checker: cache keys, donation, masked lanes.

``gelly_tpu``'s plancheck, in two vocabularies chosen per module by its
imports (as in :mod:`gelly_torch.analysis.jitlint`). A module that
imports ``jax`` (or neither package, outside the port) is read exactly
as ``gelly_tpu``'s tool reads it, against :data:`JAX_REFUSAL_MATRIX`, so
pointed at ``gelly_tpu/`` or its fixtures this tool gives its findings.
A module of the port (it imports ``torch`` or ``gelly_torch``, or lives
under ``gelly_torch/``) is read in the PyTorch vocabulary described
after the rules.

The engine's correctness rests on the contract between a
``SummaryAggregation`` declaration and the plans built from it: in
``gelly_tpu`` the memoized ``_compiled_plan`` and
``_compiled_tenant_plan`` and ``fuse()``; in the port
``_compiled_tenant_plan``, ``fuse()`` and ``run_aggregation``'s
refusals. Three bug classes show what happens when the contract drifts
by convention alone: a typo'd ``merge_mode`` silently ran the wrong
merge, a snapshot aliased a donated buffer, and a masked-lane flag
raced readiness. Same :class:`~gelly_torch.analysis.Finding` shape,
same ``# graphlint: disable=PCxxx`` suppression, same CLI
(``python -m gelly_torch.analysis plancheck [paths]``).

**PC1xx — cache-key completeness** (the merge_mode bug class):

- ``PC101`` knob missing from the plan-cache key: inside a memoizing
  plan builder (a function whose ``key = (...)`` tuple gates a
  ``key in cache`` lookup), every SCALAR field of the
  ``SummaryAggregation`` dataclass the builder reads — anywhere in its
  body or the jit-compiled closures it defines — must appear in the
  key tuple. A knob read but not keyed means mutating it on a live
  instance silently returns the STALE compiled plan. Callable fields
  are exempt (the per-instance cache ties executables to the closure
  identities; ``fold_backend`` is their keyed proxy), as are reads
  that only feed a refusal (``raise`` bodies and ``if``-tests guarding
  nothing but a ``raise``) and the documented label field ``name``.
- ``PC102`` unvalidated string key component: a ``str``-typed knob that
  participates in a cache key must be validated against an allowed set
  (a ``<knob> in/not in ("...", ...)`` membership test in a raising
  scope) SOMEWHERE in the linted package — an unvalidated mode string
  is the typo'd-``merge_mode`` bug waiting to silently select the
  wrong physical plan. Whole-package rule (like OB002, it only fires
  when the lint set spans the builder module's top-level package).
- ``PC103`` builder parameter unreachable from the key: every non-agg
  parameter the builder reads (mesh, lane width, ...) must flow into
  the key tuple through at most a chain of simple assignments
  (``mesh_key = (ids, mesh.axis_names)``) — an unkeyed mesh returns a
  plan compiled for different devices.

**PC2xx — donation/aliasing discipline** (the snapshot-aliases-donated-
buffer bug class; extends jitlint's caller-side GL006 across the
vmapped tenant stack and the fused executor):

- ``PC201`` snapshot without a copy: in a builder scope that
  constructs donation-jitted folds (``donate_argnums`` present), a
  locally-defined ``*snapshot*`` function must route through an eager
  ``jnp.copy`` (or the plan's ``transform``) — returning the live
  state hands a consumer a reference the next donated fold deletes out
  from under it.
- ``PC202`` donated fold without the rebind idiom: a call to a
  compiled plan's donated fold — ``<plan-ish>.fold(...)`` /
  ``.fold_codec(...)``, a local bound from one, or the ``fold_*``
  entries tuple-unpacked from a ``_compiled*plan(...)`` result — must
  rebind its state argument in the same statement
  (``state = fold(state, ...)``). Any other shape leaves a poisoned
  reference live (the donation contract the engine docs promise).
- ``PC203`` snapshot publication aliases the live state: a store to a
  ``*snapshot*``/``*latest*`` attribute whose value chases (through
  simple assignments) to the bare expression that is elsewhere passed
  as the donated fold's state must pass through a call
  (``plan.snapshot(...)``, ``jnp.copy``) first — publishing the live
  pytree lets queries read buffers the next dispatch invalidates.

**PC3xx — masked-lane bit-invariance** (the tenant engine's no-op
lanes and the multiquery ``every=k`` masked sub-folds; the per-tenant
bit-identity contract):

- ``PC301`` false branch is not the identity carry: in a masked-lane
  select — ``jnp.where(mask, new, old)`` inside a ``jax.tree.map``
  lambda of two or more leaves — the false branch must be the original
  state leaf ITSELF (a bare lambda parameter). Any arithmetic there
  (``old + 1``, ``jnp.zeros_like(old)``) drifts masked lanes' bits,
  breaking per-tenant bit-identity and checkpoint resume.
- ``PC302`` mask not derived from the lane axis: the select's
  condition must derive from the lane data — a parameter of the
  enclosing function/lambda (chased through simple assignments) or an
  axis-identity primitive (``axis_index``/``program_id``). A mask
  rebuilt from module constants or a hard-coded ``jnp.arange(k)``
  width silently desynchronizes from the real lane width when tiers
  grow.

**PC4xx — eligibility refusal matrix**: :data:`REFUSAL_MATRIX` is the
declarative table of eligibility predicates x plan entry points — each
``(module, function)`` entry point must statically REACH a ``raise``
for every predicate combination the table marks unsupported (the raise
must sit under ``if``-tests whose identifiers — chased through simple
assignments, and through same-module callees like
``resolve_fold_backend`` — cover the predicate's tokens). A new entry
path that forgets one refusal fails the lane:

- ``PC401`` entry point lost a required refusal.
- ``PC402`` a matrix entry point is missing from its module — a rename
  must update the table, never silently skip the check.

**The PyTorch vocabulary.** A builder may probe its cache with
``cache.get(key)`` as well as ``key in cache``; a parameter the hit's
guard compares (``if hit is not None and hit.device == dev: return
hit``) counts as keyed for PC103, since a hit is returned only when its
recorded value equals the call's and a mismatch rebuilds and replaces
the cached plan (the port's tenant plan guards ``device`` and
``chunk_capacity`` so, under ``gelly_tpu``'s key). PC201 is active where
the builder's folds write state in place (``_write_rows``,
``_select_rows``, ``copy_``), which stands for donation, and an eager
copy is ``.clone()``, ``_clone_tree`` or ``copy``. PC202/PC203 also
track ``fold = plan.fold_codec if ... else plan.fold``. PC301/PC302
also read the in-place masked select ``dst.copy_(torch.where(mask, new,
dst))``, whose false branch must be ``dst`` itself. The port's
:data:`REFUSAL_MATRIX` holds every row of ``gelly_tpu``'s on the port's
entry points, each scoped to its home package (:data:`_MATRIX_DIRS`);
its guards may be early returns (``if ttl_panes is None: return``) and
``getattr(agg, "name", None)`` reads.

Conservative by construction: builder discovery keys on the
memoization idiom, taint follows simple assignment chains, and the
matrix resolves same-module callees only (depth-bounded). A missed
violation is possible; a finding is real unless the line carries a
reviewed suppression with a justification comment (the RC006/EO001
precedent).
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re

from . import Finding, collect_python_files
from .astutil import _attr_chain, suppressed as _line_suppressed
from .loader import SourceCache
from .racecheck import _local_defs, _walk_same_scope

RULES: dict[str, tuple[str, str]] = {
    "PC101": (
        "plan knob read by the builder but missing from its cache key",
        "every scalar SummaryAggregation field the builder reads must "
        "appear in the plan-cache key tuple — mutating an unkeyed knob "
        "on a live instance silently returns the stale compiled plan "
        "(the merge_mode bug class)",
    ),
    "PC102": (
        "string-typed cache-key knob validated nowhere in the package",
        "add a membership check against the allowed set with a raise "
        "(the resolve_merge_mode pattern): an unvalidated mode string "
        "lets a typo silently select the wrong physical plan",
    ),
    "PC103": (
        "builder parameter read by the plan but unreachable from the "
        "cache key",
        "thread the parameter (mesh, lane width, ...) into the key "
        "tuple, directly or through a simple assignment chain — an "
        "unkeyed input returns a plan compiled for a different "
        "mesh/width",
    ),
    "PC201": (
        "snapshot path in a donating plan builder lacks a copy",
        "a donated fold deletes its input buffers at the next dispatch: "
        "snapshots must be an EAGER jnp.copy (or the plan transform's "
        "fresh output), never the live state pytree",
    ),
    "PC202": (
        "donated plan fold called without rebinding the state argument",
        "use the rebind idiom `state = fold(state, ...)` at EVERY call "
        "site of a donated fold — any other shape keeps a poisoned "
        "reference that raises 'Array has been deleted' on backends "
        "that implement donation (TPU, not the CPU test tier)",
    ),
    "PC203": (
        "snapshot publication aliases the live donated state",
        "publish `plan.snapshot(state)` (or an eager copy), never the "
        "state object itself: queries holding the live pytree read "
        "buffers the next donated dispatch invalidates",
    ),
    "PC301": (
        "masked-lane false branch is not the identity carry",
        "a masked no-op lane must select the ORIGINAL state leaf back "
        "bit-unchanged: jnp.where(mask, new, old) with `old` the bare "
        "tree.map lambda parameter — arithmetic on the false branch "
        "drifts masked lanes and breaks per-tenant bit-identity",
    ),
    "PC302": (
        "masked-lane condition not derived from the lane axis",
        "derive the mask from the lane inputs (a parameter of the "
        "enclosing scope, or axis_index/program_id) — a mask rebuilt "
        "from constants or a hard-coded width desynchronizes from the "
        "real lane width when tiers grow",
    ),
    "PC401": (
        "entry point lost a refusal the eligibility matrix requires",
        "every unsupported predicate must be refused LOUDLY at plan "
        "time (see plancheck.REFUSAL_MATRIX): restore the raise, or — "
        "if the combination became supported — update the matrix in "
        "the same change that adds the support and its tests",
    ),
    "PC402": (
        "refusal-matrix entry point missing from its module",
        "a rename/move of a plan entry point must update "
        "plancheck.REFUSAL_MATRIX in the same change — a dangling "
        "entry would silently skip the whole refusal check",
    ),
}

# The plugin-contract dataclass whose fields are the knob universe.
_AGG_CLASS = "SummaryAggregation"
# Documentation labels: read freely (error messages), never keyed.
_LABEL_FIELDS = {"name"}

# PC2xx vocabulary.
_DONATED_FOLD_ATTRS = {"fold", "fold_codec"}
_PLAN_RECV = re.compile(r"(^|[._])plan($|[._])")
_COMPILED_PLAN_FN = re.compile(r"_compiled\w*plan")
_SNAPSHOT_ATTR = re.compile(r"snapshot|latest")
# PC302: axis-identity primitives that ARE the lane axis.
_AXIS_IDENT = {"axis_index", "program_id", "iota"}

# ---------------------------------------------------------------------
# PC4xx: the declarative eligibility matrix.
#
# {(module basename, entry function): {predicate label: required
# identifier tokens}}. An entry point satisfies a row when SOME `raise`
# in its body (or in a same-module callee, depth-bounded) sits under
# ``if``-tests whose identifiers — including the identifiers of simple
# assignments feeding them, e.g. ``use_codec`` chasing to
# ``host_compress``/``fold_compressed`` — cover every token. Rows
# mirror the engine's documented eligibility rules; editing an entry
# point's refusals and this table together is the contract.
#: ``gelly_tpu``'s matrix, applied to the modules read in the JAX
#: vocabulary (its entry points, rows and tokens unchanged).
JAX_REFUSAL_MATRIX: dict[tuple[str, str], dict[str, frozenset]] = {
    ("multiquery.py", "fuse"): {
        "stack_ordered codec (global-order id session)":
            frozenset({"stack_ordered"}),
        "transient sub-plan (needs the Merger reset path)":
            frozenset({"transient"}),
        "host-side transform (jit_transform=False)":
            frozenset({"jit_transform"}),
        "nested fusion (MultiQueryPlan as a sub-query)":
            frozenset({"MultiQueryPlan"}),
        "codec-only sub-query without the shared codec":
            frozenset({"requires_codec"}),
        "windowed pane-ring sub-plan (single-stream ring)":
            frozenset({"windowed_panes"}),
    },
    ("aggregation.py", "run_aggregation"): {
        "source_provider x window_ms":
            frozenset({"source_provider", "window_ms"}),
        "source_provider x stack_ordered":
            frozenset({"source_provider", "stack_ordered"}),
        "precompressed x window_ms":
            frozenset({"precompressed", "window_ms"}),
        "precompressed x host_precombine":
            frozenset({"precompressed", "host_precombine"}),
        "precompressed x source_provider":
            frozenset({"precompressed", "source_provider"}),
        "precompressed x stack_ordered":
            frozenset({"precompressed", "stack_ordered"}),
        "precompressed without an engageable codec":
            frozenset({"precompressed", "use_codec"}),
        "requires_codec without an engageable codec":
            frozenset({"requires_codec", "use_codec"}),
        "fused plan x window_ms":
            frozenset({"fused", "window_ms"}),
        "fused plan x host_precombine":
            frozenset({"fused", "host_precombine"}),
        "fused plan x mesh with a non-accumulating query":
            frozenset({"fused", "accum"}),
        "windowed x window_ms":
            frozenset({"windowed", "window_ms"}),
        "windowed x fused plan":
            frozenset({"windowed", "fused"}),
        "windowed x transient":
            frozenset({"windowed", "transient"}),
        "windowed x source_provider":
            frozenset({"windowed", "source_provider"}),
        "windowed x precompressed":
            frozenset({"windowed", "precompressed"}),
        "windowed x dirty-delta merge":
            frozenset({"windowed", "merge_delta"}),
        "ttl without a windowed pane ring":
            frozenset({"ttl_panes", "windowed"}),
        "ttl without the eviction hooks":
            frozenset({"ttl_panes", "windowed_evict"}),
        "ttl x pipeline lookahead":
            frozenset({"ttl_panes", "prefetch_depth"}),
    },
    ("aggregation.py", "_compiled_tenant_plan"): {
        "stack_ordered codec (global-order id session)":
            frozenset({"stack_ordered"}),
        "requires_codec without fold_compressed":
            frozenset({"requires_codec", "fold_compressed"}),
        "host-side transform (jit_transform=False)":
            frozenset({"jit_transform"}),
        "windowed pane-ring plan in a tenant tier":
            frozenset({"windowed_panes"}),
    },
    ("aggregation.py", "_compiled_plan"): {
        "unknown merge_mode": frozenset({"merge_mode"}),
        "merge_mode='delta' without a merge_delta":
            frozenset({"merge_mode", "merge_delta"}),
    },
    ("tenants.py", "add_tier"): {
        "compressed tier without a codec fold":
            frozenset({"compressed", "fold_compressed"}),
        "requires_codec plan on a raw tier":
            frozenset({"requires_codec", "compressed"}),
    },
    ("connected_components.py", "connected_components"): {
        "unknown fold_backend": frozenset({"fold_backend"}),
        "unknown merge_mode": frozenset({"merge_mode"}),
    },
    ("connected_components.py", "cc_tenant_tier"): {
        "unknown fold_backend": frozenset({"fold_backend"}),
    },
}
#: The same rows on the port's entry points, applied to the modules
#: read in the PyTorch vocabulary. A row that moved says so.
REFUSAL_MATRIX: dict[tuple[str, str], dict[str, frozenset]] = {
    ("multiquery.py", "fuse"): {
        "stack_ordered codec (global-order id session)":
            frozenset({"stack_ordered"}),
        "transient sub-plan (needs the Merger reset path)":
            frozenset({"transient"}),
        "host-side transform (jit_transform=False)":
            frozenset({"jit_transform"}),
        "nested fusion (MultiQueryPlan as a sub-query)":
            frozenset({"MultiQueryPlan"}),
        "codec-only sub-query without the shared codec":
            frozenset({"requires_codec"}),
        "windowed pane-ring sub-plan (single-stream ring)":
            frozenset({"windowed_panes"}),
    },
    ("aggregation.py", "run_aggregation"): {
        "source_provider x window_ms":
            frozenset({"source_provider", "window_ms"}),
        "source_provider x stack_ordered":
            frozenset({"source_provider", "stack_ordered"}),
        "precompressed x window_ms":
            frozenset({"precompressed", "window_ms"}),
        "precompressed x host_precombine":
            frozenset({"precompressed", "host_precombine"}),
        "precompressed x source_provider":
            frozenset({"precompressed", "source_provider"}),
        "precompressed x stack_ordered":
            frozenset({"precompressed", "stack_ordered"}),
        "precompressed without an engageable codec":
            frozenset({"precompressed", "use_codec"}),
        "requires_codec without an engageable codec":
            frozenset({"requires_codec", "use_codec"}),
        "fused plan x window_ms":
            frozenset({"fused", "window_ms"}),
        "fused plan x host_precombine":
            frozenset({"fused", "host_precombine"}),
        "fused plan x mesh with a non-accumulating query":
            frozenset({"fused", "accum"}),
        "windowed x window_ms":
            frozenset({"windowed", "window_ms"}),
        "windowed x fused plan":
            frozenset({"windowed", "fused"}),
        "windowed x transient":
            frozenset({"windowed", "transient"}),
        "windowed x source_provider":
            frozenset({"windowed", "source_provider"}),
        "windowed x precompressed":
            frozenset({"windowed", "precompressed"}),
        "windowed x dirty-delta merge":
            frozenset({"windowed", "merge_delta"}),
        "ttl without a windowed pane ring":
            frozenset({"ttl_panes", "windowed"}),
        "ttl without the eviction hooks":
            frozenset({"ttl_panes", "windowed_evict"}),
        "ttl x pipeline lookahead":
            frozenset({"ttl_panes", "prefetch_depth"}),
    },
    ("aggregation.py", "_compiled_tenant_plan"): {
        "stack_ordered codec (global-order id session)":
            frozenset({"stack_ordered"}),
        "requires_codec without fold_compressed":
            frozenset({"requires_codec", "fold_compressed"}),
        "host-side transform (jit_transform=False)":
            frozenset({"jit_transform"}),
        "windowed pane-ring plan in a tenant tier":
            frozenset({"windowed_panes"}),
    },
    # gelly_tpu's _compiled_plan rows: the port has no single-stream
    # compiled plan; its merge knobs are refused in _check_merge_knobs.
    ("aggregation.py", "_check_merge_knobs"): {
        "unknown merge_mode": frozenset({"merge_mode"}),
        "merge_mode='delta' without a merge_delta":
            frozenset({"merge_mode", "merge_delta"}),
    },
    ("tenants.py", "add_tier"): {
        "compressed tier without a codec fold":
            frozenset({"compressed", "fold_compressed"}),
        "requires_codec plan on a raw tier":
            frozenset({"requires_codec", "compressed"}),
    },
    ("connected_components.py", "connected_components"): {
        "unknown fold_backend": frozenset({"fold_backend"}),
        "unknown merge_mode": frozenset({"merge_mode"}),
    },
    ("connected_components.py", "cc_tenant_tier"): {
        "unknown fold_backend": frozenset({"fold_backend"}),
    },
}
# How deep the same-module callee expansion follows plain-name calls
# (cc_tenant_tier -> connected_components -> resolve_fold_backend).
_MATRIX_CALL_DEPTH = 3

# Home package (parent-directory basename) of each matrix module: when
# a whole-package lint set contains that directory but the module file
# is GONE, the rename must update the matrix (PC402) — without this, a
# `git mv multiquery.py mq.py` silently drops fuse()'s entire refusal
# check. Fixture dirs never match these names, so rule-fixture lint
# sets stay out of scope.
_MATRIX_DIRS = {
    "multiquery.py": "engine",
    "aggregation.py": "engine",
    "tenants.py": "engine",
    "connected_components.py": "library",
}


@dataclasses.dataclass
class _Mod:
    path: str
    tree: ast.Module
    lines: list
    torch: bool = False  # read in the PyTorch vocabulary


def _imports_of(tree: ast.Module) -> set:
    """Top-level package names a module imports (anywhere in it)."""
    out: set = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            out.add(node.module.split(".")[0])
    return out


# The PyTorch vocabulary: the in-place writes that stand in for donation
# (a builder whose folds use them is "donating"), and the eager copies a
# snapshot takes.
_IN_PLACE_WRITES = {"_write_rows", "_select_rows", "copy_"}
_EAGER_COPIES = {"copy", "clone", "_clone_tree"}


@dataclasses.dataclass
class _Builder:
    fn: ast.FunctionDef
    key_assign: ast.Assign     # key = ( ... )
    agg_param: str
    params: list               # non-self parameter names, in order


def _unparse(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # noqa: BLE001 — synthetic nodes
        return ""


def _name_tokens(expr: ast.AST) -> set:
    """Every plain Name id and Attribute attr an expression mentions."""
    out: set = set()
    for n in ast.walk(expr):
        if isinstance(n, ast.Name):
            out.add(n.id)
        elif isinstance(n, ast.Attribute):
            out.add(n.attr)
    return out


def _target_names(node: ast.AST) -> set:
    out: set = set()
    if isinstance(node, ast.Name):
        out.add(node.id)
    elif isinstance(node, (ast.Tuple, ast.List)):
        for e in node.elts:
            out |= _target_names(e)
    elif isinstance(node, ast.Starred):
        out |= _target_names(node.value)
    return out


def _collect_assigns(fn: ast.AST) -> dict:
    """name -> [Assign, ...] for every simple/tuple-target assignment in
    ``fn``'s own scope (nested defs excluded — their bindings are not
    this scope's)."""
    out: dict = {}
    for n in _walk_same_scope(fn):
        if isinstance(n, ast.Assign):
            for t in n.targets:
                for nm in _target_names(t):
                    out.setdefault(nm, []).append(n)
    return out


def _fn_params(fn) -> list:
    if isinstance(fn, ast.Lambda):
        a = fn.args
    elif isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        a = fn.args
    else:
        return []
    out = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    for v in (a.vararg, a.kwarg):
        if v is not None:
            out.append(v.arg)
    return [p for p in out if p not in ("self", "cls")]


class PlanChecker:
    """Whole-package compiled-plan contract lint."""

    def __init__(self, package_root: str, cache: SourceCache | None = None):
        self.package_root = os.path.abspath(package_root)
        self.findings: list[Finding] = []
        self._cache = cache or SourceCache()
        self._modules: dict[str, _Mod] = {}
        # Knob universe, resolved once per lint set.
        self._scalar_knobs: set = set()
        self._callable_fields: set = set()
        self._str_knobs: set = set()
        self._torch_scan = False  # the module being scanned is torch

    # ------------------------------------------------------------ loading

    def lint_paths(self, paths) -> list[Finding]:
        mods: list[_Mod] = []
        for f in collect_python_files(paths):
            ms = self._cache.get_or_finding(f, self.findings)
            if ms is None:
                continue
            imports = _imports_of(ms.tree)
            rel = os.path.relpath(ms.path, self.package_root)
            if rel.split(os.sep)[0] == "gelly_torch":
                imports.add("gelly_torch")  # a module of the port
            m = _Mod(path=ms.path, tree=ms.tree, lines=ms.lines,
                     torch=bool(imports & {"torch", "gelly_torch"})
                     and "jax" not in imports)
            self._modules[ms.path] = m
            mods.append(m)
        self._load_knob_universe(mods)
        for m in mods:
            for b in self._find_builders(m):
                self._check_cache_key(m, b)
                self._check_snapshot_defs(m, b)
            self._check_donation_calls(m)
            self._check_snapshot_publication(m)
            self._check_masked_lanes(m)
        self._check_refusal_matrix(
            [m for m in mods if not m.torch], JAX_REFUSAL_MATRIX, mods)
        self._check_refusal_matrix(
            [m for m in mods if m.torch], REFUSAL_MATRIX, mods)
        self.findings.sort(key=lambda f: (f.path, f.line, f.rule))
        return self.findings

    def _emit(self, m: _Mod, node, rule: str, detail: str) -> None:
        line = getattr(node, "lineno", 0)
        if _line_suppressed(m.lines, line, rule):
            return
        summary, hint = RULES[rule]
        f = Finding(m.path, line, rule, f"{summary}: {detail}", hint=hint)
        if f not in self.findings:
            self.findings.append(f)

    # --------------------------------------------------- knob universe

    def _load_knob_universe(self, mods) -> None:
        """Field classification from the ``SummaryAggregation``-style
        dataclass (and its subclasses) in the linted set: annotation
        mentioning ``Callable`` -> closure field (identity-cached,
        exempt from keying); everything else -> scalar knob; ``str``
        annotations additionally feed PC102."""
        for m in mods:
            for node in ast.walk(m.tree):
                if not isinstance(node, ast.ClassDef):
                    continue
                is_agg = node.name == _AGG_CLASS or any(
                    isinstance(b, ast.Name) and b.id == _AGG_CLASS
                    for b in node.bases)
                if not is_agg:
                    continue
                for stmt in node.body:
                    if not (isinstance(stmt, ast.AnnAssign)
                            and isinstance(stmt.target, ast.Name)):
                        continue
                    field = stmt.target.id
                    ann = _unparse(stmt.annotation)
                    if "Callable" in ann:
                        self._callable_fields.add(field)
                    else:
                        self._scalar_knobs.add(field)
                        if re.search(r"\bstr\b", ann):
                            self._str_knobs.add(field)
        self._scalar_knobs -= _LABEL_FIELDS | self._callable_fields
        self._str_knobs &= self._scalar_knobs

    # ------------------------------------------------ builder discovery

    def _find_builders(self, m: _Mod):
        """Functions using the memoization idiom: a ``key = (...)``
        tuple later tested with ``key in cache`` or used as a cache
        subscript, plus a parameter whose knob-field reads mark it as
        the aggregation."""
        universe = self._scalar_knobs | self._callable_fields
        out = []
        for fn in ast.walk(m.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            candidates: dict = {}
            used: set = set()
            for n in _walk_same_scope(fn):
                if (isinstance(n, ast.Assign) and len(n.targets) == 1
                        and isinstance(n.targets[0], ast.Name)
                        and isinstance(n.value, ast.Tuple)
                        and len(n.value.elts) >= 2):
                    candidates.setdefault(n.targets[0].id, n)
                elif isinstance(n, ast.Compare) and any(
                        isinstance(op, (ast.In, ast.NotIn))
                        for op in n.ops) and isinstance(n.left, ast.Name):
                    used.add(n.left.id)
                elif isinstance(n, ast.Subscript) and isinstance(
                        n.slice, ast.Name):
                    used.add(n.slice.id)
                elif m.torch and isinstance(n, ast.Call) \
                        and isinstance(n.func, ast.Attribute) \
                        and n.func.attr == "get" and n.args \
                        and isinstance(n.args[0], ast.Name):
                    used.add(n.args[0].id)  # the port's `cache.get(key)`
            key_assign = next(
                (candidates[nm] for nm in candidates if nm in used), None)
            if key_assign is None:
                continue
            params = _fn_params(fn)
            best, best_score = None, 0
            for p in params:
                if universe:
                    fields = {
                        n.attr for n in ast.walk(fn)
                        if isinstance(n, ast.Attribute)
                        and isinstance(n.value, ast.Name)
                        and n.value.id == p and n.attr in universe
                    }
                else:
                    fields = {
                        n.attr for n in ast.walk(fn)
                        if isinstance(n, ast.Attribute)
                        and isinstance(n.value, ast.Name)
                        and n.value.id == p
                    }
                if len(fields) > best_score:
                    best, best_score = p, len(fields)
            if best is None:
                continue
            out.append(_Builder(fn=fn, key_assign=key_assign,
                                agg_param=best, params=params))
        return out

    # --------------------------------------------------- PC101/102/103

    @staticmethod
    def _key_coverage(b: _Builder, assigns: dict) -> tuple:
        """(agg fields, root names) reachable from the key tuple,
        chasing simple assignment chains (``mesh_key = (ids,
        mesh.axis_names)``)."""
        fields: set = set()
        roots: set = set()
        work = list(b.key_assign.value.elts)
        seen_names: set = set()
        depth = 0
        while work and depth < 10000:
            depth += 1
            e = work.pop()
            for n in ast.walk(e):
                if isinstance(n, ast.Attribute) \
                        and isinstance(n.value, ast.Name) \
                        and n.value.id == b.agg_param:
                    fields.add(n.attr)
                if isinstance(n, ast.Name):
                    roots.add(n.id)
                    if n.id not in seen_names:
                        seen_names.add(n.id)
                        for a in assigns.get(n.id, ()):
                            work.append(a.value)
        return fields, roots

    @staticmethod
    def _refusal_spans(fn) -> list:
        """(lo, hi) line spans whose knob reads only feed a refusal:
        ``raise`` statements, and the tests of ``if``s whose body is
        nothing but a raise."""
        spans = []
        for n in ast.walk(fn):
            if isinstance(n, ast.Raise):
                spans.append((n.lineno, getattr(n, "end_lineno", n.lineno)))
            elif isinstance(n, ast.If) and n.body and not n.orelse \
                    and all(isinstance(s, ast.Raise) for s in n.body):
                spans.append((n.test.lineno,
                              getattr(n.test, "end_lineno",
                                      n.test.lineno)))
        return spans

    def _check_cache_key(self, m: _Mod, b: _Builder) -> None:
        if not self._scalar_knobs:
            return  # no knob dataclass in the lint set: nothing to key
        assigns = _collect_assigns(b.fn)
        key_fields, key_roots = self._key_coverage(b, assigns)
        refusal = self._refusal_spans(b.fn)

        def exempt(line: int) -> bool:
            return any(lo <= line <= hi for lo, hi in refusal)

        # PC101: scalar-knob reads anywhere under the builder (the
        # nested defs ARE the compiled closures) not covered by the key.
        flagged: set = set()
        for n in ast.walk(b.fn):
            if not (isinstance(n, ast.Attribute)
                    and isinstance(n.value, ast.Name)
                    and n.value.id == b.agg_param
                    and isinstance(n.ctx, ast.Load)
                    and n.attr in self._scalar_knobs):
                continue
            if n.attr in key_fields or n.attr in flagged \
                    or exempt(n.lineno):
                continue
            flagged.add(n.attr)
            self._emit(
                m, n, "PC101",
                f"{b.agg_param}.{n.attr} is read by plan builder "
                f"{b.fn.name!r} (line {n.lineno}) but absent from its "
                f"cache-key tuple (line {b.key_assign.lineno})",
            )
        # PC102: str-typed key knobs need a package-level validation.
        if self._covers_package_of(m):
            for f in sorted(key_fields & self._str_knobs):
                if not self._has_str_validation(f):
                    self._emit(
                        m, b.key_assign, "PC102",
                        f"cache-key knob {b.agg_param}.{f} of builder "
                        f"{b.fn.name!r} has no allowed-set membership "
                        "check (with a raise) anywhere in the package",
                    )
        # PC103: non-agg parameters the builder reads must reach the
        # key — reads that only feed a refusal are exempt, like PC101's.
        read_names = {
            n.id for n in ast.walk(b.fn)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)
            and not exempt(n.lineno)
        }
        guarded = self._hit_guard_roots(b, assigns) if m.torch else set()
        for p in b.params:
            if p == b.agg_param or p not in read_names:
                continue
            if p not in key_roots and p not in guarded:
                self._emit(
                    m, b.key_assign, "PC103",
                    f"parameter {p!r} of plan builder {b.fn.name!r} is "
                    "read but unreachable from the cache-key tuple",
                )

    @staticmethod
    def _hit_guard_roots(b: _Builder, assigns: dict) -> set:
        """Names a cache hit's guard compares (chased through simple
        assignments): in ``hit = cache.get(key)`` then ``if hit is not
        None and hit.device == dev ...: return hit``, the guard's
        operands. A parameter the guard compares is part of the hit's
        identity as surely as a key member: a plan is returned only when
        its recorded value equals the call's, and a mismatch rebuilds
        (and replaces) the cached plan."""
        hits = {nm for nm, asg in assigns.items()
                for a in asg if isinstance(a.value, ast.Call)
                and isinstance(a.value.func, ast.Attribute)
                and a.value.func.attr == "get"}
        roots: set = set()
        for n in _walk_same_scope(b.fn):
            if not (isinstance(n, ast.If) and len(n.body) == 1
                    and isinstance(n.body[0], ast.Return)
                    and isinstance(n.body[0].value, ast.Name)
                    and n.body[0].value.id in hits):
                continue
            work = [n.test]
            seen: set = set()
            while work:
                e = work.pop()
                for x in ast.walk(e):
                    if isinstance(x, ast.Name) and x.id not in seen:
                        seen.add(x.id)
                        roots.add(x.id)
                        for a in assigns.get(x.id, ()):
                            work.append(a.value)
        return roots

    def _covers_package_of(self, m: _Mod) -> bool:
        """Lint set spans the module's whole top-level package — the
        precondition for PC102's "validated nowhere" to mean missing,
        not under-collected (the OB002 precedent)."""
        d = os.path.dirname(m.path)
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

    def _has_str_validation(self, field: str) -> bool:
        for m in self._modules.values():
            for fn in ast.walk(m.tree):
                if not isinstance(fn, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    continue
                raises = any(isinstance(x, ast.Raise) for x in ast.walk(fn))
                if not raises:
                    continue
                for n in ast.walk(fn):
                    if not (isinstance(n, ast.Compare) and any(
                            isinstance(op, (ast.In, ast.NotIn))
                            for op in n.ops)):
                        continue
                    left = n.left
                    tail = None
                    if isinstance(left, ast.Name):
                        tail = left.id
                    elif isinstance(left, ast.Attribute):
                        tail = left.attr
                    if tail != field:
                        continue
                    for comp in n.comparators:
                        if isinstance(comp, (ast.Tuple, ast.List,
                                             ast.Set)) and comp.elts \
                                and all(isinstance(e, ast.Constant)
                                        and isinstance(e.value, str)
                                        for e in comp.elts):
                            return True
        return False

    # --------------------------------------------------------- PC201

    def _check_snapshot_defs(self, m: _Mod, b: _Builder) -> None:
        donating = any(
            isinstance(n, ast.Call)
            and any(kw.arg == "donate_argnums" for kw in n.keywords)
            for n in ast.walk(b.fn)
        )
        if m.torch:
            # The port's folds write the stack in place: that is its
            # donation (the next fold overwrites what a snapshot holds).
            donating = any(
                isinstance(n, ast.Call) and (_attr_chain(n.func) or ("",))[
                    -1] in _IN_PLACE_WRITES
                for n in ast.walk(b.fn))
        if not donating:
            return
        copy_names = _EAGER_COPIES if m.torch else {"copy"}
        for fn in _local_defs(b.fn):
            if "snapshot" not in fn.name.lower():
                continue
            copies = any(
                (isinstance(n, ast.Name) and n.id in copy_names)
                or (isinstance(n, ast.Attribute) and n.attr in copy_names)
                or (isinstance(n, ast.Call)
                    and "transform" in _unparse(n.func))
                for n in ast.walk(fn)
            )
            if not copies:
                self._emit(
                    m, fn, "PC201",
                    f"{fn.name!r} in donating builder {b.fn.name!r} "
                    "returns state without an eager jnp.copy or a "
                    "transform",
                )

    # --------------------------------------------------------- PC202

    def _donated_names_from_stmt(self, stmt, donated: dict) -> None:
        """Track bindings that make a plain name a donated fold:
        ``fold = batch.plan.fold`` and the ``fold_*`` entries of a
        ``(...) = plan`` unpack where ``plan = _compiled*plan(...)``."""
        if not isinstance(stmt, ast.Assign):
            return
        # Any rebind first clears (shadowing: `fold = other_thing`).
        for t in stmt.targets:
            for nm in _target_names(t):
                donated.pop(nm, None)
        if len(stmt.targets) != 1:
            return
        tgt = stmt.targets[0]
        v = stmt.value
        if isinstance(tgt, ast.Name) and isinstance(v, ast.Attribute) \
                and v.attr in _DONATED_FOLD_ATTRS \
                and _PLAN_RECV.search(_unparse(v.value).lower()):
            donated[tgt.id] = _unparse(v)
            return
        if isinstance(tgt, ast.Name) and isinstance(v, ast.IfExp) \
                and self._torch_scan and all(
                    isinstance(x, ast.Attribute)
                    and x.attr in _DONATED_FOLD_ATTRS
                    and _PLAN_RECV.search(_unparse(x.value).lower())
                    for x in (v.body, v.orelse)):
            # The port's `fold = plan.fold_codec if ... else plan.fold`.
            donated[tgt.id] = _unparse(v)
            return
        if isinstance(tgt, ast.Tuple) and isinstance(v, ast.Call):
            chain = _attr_chain(v.func)
            if chain and _COMPILED_PLAN_FN.search(chain[-1]):
                for e in tgt.elts:
                    if isinstance(e, ast.Name) and "fold" in e.id:
                        donated[e.id] = f"{chain[-1]}(...)::{e.id}"
            return
        if isinstance(tgt, ast.Tuple) and isinstance(v, ast.Name):
            # `(...) = plan` one hop after `plan = _compiled*plan(...)`
            # is resolved by the caller passing the live binding map —
            # handled below via _plan_tuple_names.
            pass

    def _check_donation_calls(self, m: _Mod) -> None:
        self._torch_scan = m.torch
        # Pre-pass: names holding a _compiled*plan(...) result, module
        # wide (the `plan = _compiled_plan(...)` / `(...) = plan` pair
        # may span statements).
        plan_results: set = set()
        for n in ast.walk(m.tree):
            if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                    and isinstance(n.targets[0], ast.Name) \
                    and isinstance(n.value, ast.Call):
                chain = _attr_chain(n.value.func)
                if chain and _COMPILED_PLAN_FN.search(chain[-1]):
                    plan_results.add(n.targets[0].id)
        self._plan_result_names = plan_results

        def scan(scope, inherited: dict) -> None:
            donated = dict(inherited)
            for p in _fn_params(scope) if not isinstance(
                    scope, ast.Module) else []:
                donated.pop(p, None)
            body = scope.body
            self._scan_suite(m, body, donated)

        scan(m.tree, {})

    def _scan_suite(self, m: _Mod, stmts, donated: dict) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                inner = dict(donated)
                for p in _fn_params(stmt):
                    inner.pop(p, None)
                self._scan_suite(m, stmt.body, inner)
                continue
            if isinstance(stmt, ast.ClassDef):
                self._scan_suite(m, stmt.body, dict(donated))
                continue
            # Tuple unpack of a known plan result.
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Tuple) \
                    and isinstance(stmt.value, ast.Name) \
                    and stmt.value.id in getattr(
                        self, "_plan_result_names", ()):
                for e in stmt.targets[0].elts:
                    if isinstance(e, ast.Name) and "fold" in e.id:
                        donated[e.id] = f"{stmt.value.id}::{e.id}"
            else:
                self._donated_names_from_stmt(stmt, donated)
            # Check donated-fold calls in this statement.
            self._check_stmt_calls(m, stmt, donated)
            # Recurse into compound-statement suites.
            for attr in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, attr, None)
                if sub and not isinstance(stmt, (ast.FunctionDef,
                                                 ast.AsyncFunctionDef,
                                                 ast.ClassDef)):
                    self._scan_suite(m, sub, donated)
            for h in getattr(stmt, "handlers", []) or []:
                self._scan_suite(m, h.body, donated)

    def _is_donated_fold_call(self, call: ast.Call, donated: dict):
        if isinstance(call.func, ast.Name) and call.func.id in donated:
            return donated[call.func.id]
        if isinstance(call.func, ast.Attribute) \
                and call.func.attr in _DONATED_FOLD_ATTRS \
                and _PLAN_RECV.search(_unparse(call.func.value).lower()):
            return _unparse(call.func)
        return None

    def _check_stmt_calls(self, m: _Mod, stmt, donated: dict) -> None:
        # Only this statement's own expressions: compound suites are
        # recursed by _scan_suite with the evolving binding map.
        exprs = []
        if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign,
                             ast.Return, ast.Expr)):
            if getattr(stmt, "value", None) is not None:
                exprs.append(stmt.value)
        elif isinstance(stmt, (ast.If, ast.While)):
            exprs.append(stmt.test)
        elif isinstance(stmt, ast.For):
            exprs.append(stmt.iter)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            exprs.extend(i.context_expr for i in stmt.items)
        for e in exprs:
            for call in ast.walk(e):
                if not isinstance(call, ast.Call):
                    continue
                why = self._is_donated_fold_call(call, donated)
                if why is None:
                    continue
                ok = (
                    isinstance(stmt, ast.Assign)
                    and len(stmt.targets) == 1
                    and stmt.value is call
                    and call.args
                    and isinstance(call.args[0], (ast.Name, ast.Attribute))
                    and _unparse(stmt.targets[0])
                    == _unparse(call.args[0])
                )
                if not ok:
                    arg0 = _unparse(call.args[0]) if call.args else "<none>"
                    self._emit(
                        m, call, "PC202",
                        f"donated fold {why} called with state "
                        f"{arg0!r} outside the rebind idiom "
                        f"`{arg0} = fold({arg0}, ...)`",
                    )

    # --------------------------------------------------------- PC203

    def _check_snapshot_publication(self, m: _Mod) -> None:
        self._torch_scan = m.torch
        # Live-state expressions: arg0 of every donated-fold call in
        # the module (collected against the same binding discipline).
        live: set = set()

        def collect(stmts, donated):
            for stmt in stmts:
                if isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    inner = dict(donated)
                    for p in _fn_params(stmt):
                        inner.pop(p, None)
                    collect(stmt.body, inner)
                    continue
                if isinstance(stmt, ast.ClassDef):
                    collect(stmt.body, dict(donated))
                    continue
                if isinstance(stmt, ast.Assign) \
                        and len(stmt.targets) == 1 \
                        and isinstance(stmt.targets[0], ast.Tuple) \
                        and isinstance(stmt.value, ast.Name) \
                        and stmt.value.id in getattr(
                            self, "_plan_result_names", ()):
                    for e in stmt.targets[0].elts:
                        if isinstance(e, ast.Name) and "fold" in e.id:
                            donated[e.id] = e.id
                else:
                    self._donated_names_from_stmt(stmt, donated)
                for n in _walk_same_scope(stmt):
                    if isinstance(n, ast.Call) and n.args \
                            and self._is_donated_fold_call(n, donated):
                        live.add(_unparse(n.args[0]))
                for attr in ("body", "orelse", "finalbody"):
                    sub = getattr(stmt, attr, None)
                    if sub:
                        collect(sub, donated)
                for h in getattr(stmt, "handlers", []) or []:
                    collect(h.body, donated)

        collect(m.tree.body, {})
        if not live:
            return
        for fn in ast.walk(m.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            assigns = _collect_assigns(fn)
            for n in _walk_same_scope(fn):
                if not (isinstance(n, ast.Assign)
                        and len(n.targets) == 1
                        and isinstance(n.targets[0], ast.Attribute)
                        and _SNAPSHOT_ATTR.search(
                            n.targets[0].attr.lower())):
                    continue
                v = n.value
                for _ in range(4):
                    if not isinstance(v, ast.Name):
                        break
                    best = None
                    for a in assigns.get(v.id, ()):
                        if a.lineno < n.lineno and (
                                best is None or a.lineno > best.lineno):
                            best = a
                    if best is None or not isinstance(best, ast.Assign) \
                            or len(best.targets) != 1 \
                            or not isinstance(best.targets[0], ast.Name):
                        break
                    v = best.value
                if isinstance(v, ast.Call):
                    continue  # routed through snapshot()/copy/transform
                if _unparse(v) in live:
                    self._emit(
                        m, n, "PC203",
                        f"{_unparse(n.targets[0])} published from the "
                        f"live donated state {_unparse(v)!r} without a "
                        "snapshot/copy call",
                    )

    # --------------------------------------------------------- PC3xx

    @staticmethod
    def _is_tree_map(call: ast.Call) -> bool:
        chain = _attr_chain(call.func)
        if not chain:
            return False
        return (len(chain) >= 2 and chain[-2:] == ("tree", "map")) \
            or chain[-1] == "tree_map"

    def _check_masked_lanes(self, m: _Mod) -> None:
        def visit(fn, frames):
            frame = (fn, _collect_assigns(fn))
            stack = frames + [frame]
            for n in _walk_same_scope(fn):
                if isinstance(n, ast.Call) and self._is_tree_map(n) \
                        and n.args and isinstance(n.args[0], ast.Lambda):
                    lam = n.args[0]
                    params = _fn_params(lam)
                    if len(params) < 2:
                        continue
                    for w in ast.walk(lam.body):
                        if isinstance(w, ast.Call) and len(w.args) == 3:
                            chain = _attr_chain(w.func)
                            if chain and chain[-1] == "where":
                                self._check_where(m, w, params, stack)
                if m.torch and isinstance(n, ast.Call) \
                        and isinstance(n.func, ast.Attribute) \
                        and n.func.attr == "copy_" and len(n.args) == 1 \
                        and isinstance(n.args[0], ast.Call) \
                        and len(n.args[0].args) == 3 \
                        and (_attr_chain(n.args[0].func) or ("",))[-1] \
                        == "where":
                    # The port's in-place masked select:
                    # `dst.copy_(torch.where(mask, new, dst))`.
                    self._check_where(m, n.args[0], (), stack,
                                      carry=_unparse(n.func.value))
            for nested in _local_defs(fn):
                visit(nested, stack)

        for node in m.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visit(node, [])
            elif isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        visit(sub, [])

    def _check_where(self, m: _Mod, w: ast.Call, lam_params,
                     frames, carry: str | None = None) -> None:
        cond, _new, old = w.args
        # PC301: identity carry — the false branch must be a bare
        # lambda parameter (the original leaf, bit-unchanged), or in the
        # port's in-place form the very tensor the select writes into.
        if carry is not None:
            ok = _unparse(old) == carry
        else:
            ok = isinstance(old, ast.Name) and old.id in lam_params
        if not ok:
            self._emit(
                m, w, "PC301",
                f"false branch {_unparse(old)!r} of the masked select "
                "is not the original state leaf",
            )
        # PC302: the mask must derive from the lane inputs.
        all_params: set = set(lam_params)
        for fn, _assigns in frames:
            all_params |= set(_fn_params(fn))

        blessed = False
        work = [cond]
        seen: set = set()
        depth = 0
        while work and not blessed and depth < 10000:
            depth += 1
            e = work.pop()
            toks = _name_tokens(e)
            if toks & all_params or toks & _AXIS_IDENT:
                blessed = True
                break
            for n in ast.walk(e):
                if isinstance(n, ast.Name) and n.id not in seen:
                    seen.add(n.id)
                    for _fn, assigns in reversed(frames):
                        for a in assigns.get(n.id, ()):
                            work.append(a.value)
        if not blessed:
            self._emit(
                m, w, "PC302",
                f"mask {_unparse(cond)!r} derives from no parameter of "
                "the enclosing scope (nor axis_index/program_id)",
            )

    # --------------------------------------------------------- PC4xx

    def _check_refusal_matrix(self, mods, matrix, every) -> None:
        """``matrix`` over ``mods`` (one vocabulary's); a matrix module
        counts as missing only when no module of ``every`` has its
        basename."""
        by_base: dict = {}
        by_dir: dict = {}
        for m in mods:
            by_base.setdefault(os.path.basename(m.path), []).append(m)
            by_dir.setdefault(
                os.path.basename(os.path.dirname(m.path)), []).append(m)
        present = {os.path.basename(m.path) for m in every}
        for (base, fname), rows in sorted(matrix.items()):
            if not by_base.get(base):
                if base not in present:
                    self._missing_matrix_module(base, by_dir)
                continue
            for m in by_base.get(base, []):
                if matrix is REFUSAL_MATRIX and os.path.basename(
                        os.path.dirname(m.path)) != _MATRIX_DIRS[base]:
                    # The port's examples/connected_components.py is a
                    # CLI, not the library module of the same name.
                    continue
                fn = None
                for n in ast.walk(m.tree):
                    if isinstance(n, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)) \
                            and n.name == fname:
                        fn = n
                        break
                if fn is None:
                    anchor = ast.Constant(fname)
                    anchor.lineno = 1
                    self._emit(
                        m, anchor, "PC402",
                        f"matrix entry point {fname!r} not found in "
                        f"{base} — update plancheck.REFUSAL_MATRIX with "
                        "the rename",
                    )
                    continue
                tokensets = self._raise_token_sets(
                    m, fn, depth=0, seen=frozenset())
                for label, required in sorted(rows.items()):
                    if not any(required <= ts for ts in tokensets):
                        self._emit(
                            m, fn, "PC401",
                            f"{fname!r} reaches no refusal for "
                            f"unsupported predicate [{label}] "
                            f"(required guard tokens: "
                            f"{sorted(required)})",
                        )

    def _missing_matrix_module(self, base: str, by_dir: dict) -> None:
        """PC402 for a matrix module whose FILE is gone: fires only
        when the module's home package directory is in a whole-package
        lint set (so fixture/partial runs stay out of scope) — the
        silent skip this rule exists to prevent."""
        home = _MATRIX_DIRS.get(base)
        neighbors = by_dir.get(home, [])
        if not neighbors or not self._covers_package_of(neighbors[0]):
            return
        anchor_mod = sorted(neighbors, key=lambda m: m.path)[0]
        anchor = ast.Constant(base)
        anchor.lineno = 1
        self._emit(
            anchor_mod, anchor, "PC402",
            f"matrix module {base!r} is absent from the linted "
            f"{home!r} package (checked from "
            f"{os.path.basename(anchor_mod.path)}) — a rename/move "
            "must update plancheck.REFUSAL_MATRIX",
        )

    def _raise_token_sets(self, m: _Mod, fn, depth: int,
                          seen: frozenset) -> list:
        """Token sets of every ``raise`` reachable from ``fn``: each set
        is the union of identifiers in the raise's enclosing ``if``
        tests (with one chase through simple assignments feeding them),
        plus the sets of same-module callees, depth-bounded."""
        assigns = _collect_assigns(fn)
        out: list = []

        def tokens_of(expr, d=0) -> set:
            toks = _name_tokens(expr)
            if m.torch:
                # The port reads optional plan attributes with
                # getattr(agg, "name", None): the name is the token.
                toks |= {c.args[1].value for c in ast.walk(expr)
                         if isinstance(c, ast.Call)
                         and isinstance(c.func, ast.Name)
                         and c.func.id == "getattr" and len(c.args) >= 2
                         and isinstance(c.args[1], ast.Constant)
                         and isinstance(c.args[1].value, str)}
            if d < 2:
                for nm in list(toks):
                    for a in assigns.get(nm, ()):
                        toks |= tokens_of(a.value, d + 1)
            return toks

        def walk(stmts, ctx: frozenset) -> None:
            for s in stmts:
                if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                    continue
                if isinstance(s, ast.Raise):
                    out.append(ctx)
                elif isinstance(s, ast.If):
                    t = ctx | frozenset(tokens_of(s.test))
                    walk(s.body, t)
                    walk(s.orelse, t)
                    if m.torch and not s.orelse and s.body and isinstance(
                            s.body[-1], ast.Return):
                        # The port's early return (`if ttl_panes is None:
                        # return`): what follows runs under the test's
                        # negation, so its raises carry its tokens.
                        ctx = t
                elif isinstance(s, (ast.For, ast.AsyncFor)):
                    walk(s.body, ctx)
                    walk(s.orelse, ctx)
                elif isinstance(s, ast.While):
                    walk(s.body, ctx | frozenset(tokens_of(s.test)))
                    walk(s.orelse, ctx)
                elif isinstance(s, (ast.With, ast.AsyncWith)):
                    walk(s.body, ctx)
                elif isinstance(s, ast.Try):
                    walk(s.body, ctx)
                    walk(s.orelse, ctx)
                    walk(s.finalbody, ctx)
                    for h in s.handlers:
                        walk(h.body, ctx)

        walk(fn.body, frozenset())

        if depth < _MATRIX_CALL_DEPTH:
            # Same-module plain-name callees (functions, or classes via
            # their __init__ — add_tier -> TenantBatch(...)).
            top: dict = {}
            for n in m.tree.body:
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    top[n.name] = n
                elif isinstance(n, ast.ClassDef):
                    for sub in n.body:
                        if isinstance(sub, ast.FunctionDef) \
                                and sub.name == "__init__":
                            top[n.name] = sub
            for n in _walk_same_scope(fn):
                if isinstance(n, ast.Call) \
                        and isinstance(n.func, ast.Name) \
                        and n.func.id in top and n.func.id not in seen:
                    out.extend(self._raise_token_sets(
                        m, top[n.func.id], depth + 1,
                        seen | {n.func.id}))
        return out


def lint_paths(package_root: str, paths,
               cache: SourceCache | None = None) -> list[Finding]:
    """Convenience wrapper mirroring the other tools: run a fresh
    :class:`PlanChecker` over ``paths`` (optionally sharing a parsed
    :class:`~gelly_tpu.analysis.loader.SourceCache`)."""
    return PlanChecker(package_root, cache=cache).lint_paths(paths)
