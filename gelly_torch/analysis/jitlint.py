"""Device-scope hazard linter: ``gelly_tpu``'s jitlint, in two vocabularies.

Each module is read in the vocabulary of what it imports (no flag):

**A module that imports ``jax``** is read exactly as ``gelly_tpu``'s
jitlint reads it, so pointed at ``gelly_tpu/`` or its fixtures this tool
gives that package's findings: functions compiled with ``jax.jit`` (bare
decorator, ``partial(jax.jit, ...)``, or a ``jax.jit(fn)`` call naming a
local function) and the local functions they call one level deep, Pallas
kernels reached from ``pl.pallas_call``, ``donate_argnums`` callers
(GL006), and host clocks inside jit (GL007).

**A module that imports ``torch``** (and not ``jax``) is read in the
PyTorch vocabulary. The counterpart of a jitted function is a **device
scope**, a function that is one of:

(a) bound to a device field of a ``SummaryAggregation(...)`` or
    ``LaneForm(...)`` construction in the module (:data:`DEVICE_FIELDS`,
    the fields ``gelly_tpu``'s engine jits; ``transform`` unless the
    construction passes ``jit_transform=False``). The value may be a
    name, ``partial(name, ...)``, a lambda, or a conditional of those.
    Host fields (``host_compress``, ``stack_payloads``,
    ``codec_payload_check``, ``on_*``) are not scopes;
(b) listed in :data:`DEVICE_SCOPES` by ``(module basename, function)``:
    the port's counterpart of each ``jax.jit`` site of ``gelly_tpu``, and
    the entries of ``ops/kernels.py`` (the Pallas wrappers' counterparts);
(c) a same-module function a scope calls, one level deep. The sync
    helpers (:data:`SYNC_HELPERS`) and the ``*_plain`` versions (which run
    only on CPU tensors, the wrappers' CPU branch) are not expanded.

A scope's parameters are tensors unless annotated with host types only
(``int``, ``bool``, ``str``, ``float``, tuples, ``Callable``, devices,
...) or defaulted to a constant other than None. Inside a scope:

- ``GL001`` an ``np.*`` call, or ``to_numpy``, on a tensor: a blocking
  device-to-host copy on the card (a ``TypeError`` for ``np.*`` on some
  paths), which works on the CPU;
- ``GL002`` a Python ``if``, ``while``, ``assert``, ternary, or ``and`` /
  ``or`` operand on a tensor: an implicit ``bool()`` sync;
- ``GL003`` ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, or
  ``int()`` / ``float()`` / ``bool()`` of a tensor, unless it goes
  through ``host_sync`` / ``_any`` (``ops/unionfind.py``), the counted
  syncs. GL003 also flags the ops whose output shape depends on the data
  (``nonzero``, ``unique``, ``unique_consecutive``, ``masked_select``,
  ``argwhere``, ``bincount``, ``repeat_interleave`` without
  ``output_size=``, one-argument ``torch.where``, and indexing with a
  boolean mask): each reads its size back to the host, and on one H100
  ``torch.cuda.set_sync_debug_mode`` reports each as a synchronizing
  operation (``chip_smoke.py`` phase R);
- ``GL004`` dict iteration feeding ``torch.stack`` / ``torch.cat`` /
  ``_stack_tree``;
- ``GL005`` a float literal in ``torch.tensor`` / ``as_tensor`` /
  ``full`` / ``full_like`` / ``arange`` / ``linspace`` with no
  ``dtype=``: float32 here where ``gelly_tpu`` under x64 gives float64;
- ``GL006`` (every function, caller side) a state argument read after a
  call to an in-place plan entry (:data:`IN_PLACE_ENTRIES`) without the
  ``state = f(state, ...)`` rebind;
- ``GL007`` a host clock read inside a scope, or, in any function of a
  torch module, two host clock reads that enclose a call into a scope
  (a scope function, an ``ops/kernels`` entry, or a plan's device field
  such as ``agg.fold(...)``) with no synchronizing call
  (:data:`SYNC_CALLS`) between that call and the second read: the
  interval times the enqueue, not the work.

The sync helpers' results and ``.item()``'s are host values, so nothing
downstream of them is flagged again. Shape reads (``.shape``, ``.dtype``,
``.device``, ``.numel()``, ``.size()``, ``len()``) and ``is None`` tests
are never flagged.

:func:`device_scopes` returns every scope's line span; ``chip_smoke.py``
phase R holds the syncs the card reports inside those spans to the
``host_sync`` sites and the justified suppressions.

Suppress a finding by appending ``# graphlint: disable=GL00x`` (comma
list or ``all``) to the flagged line, with `` -- <reason>`` for the
audit.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re

from . import Finding, collect_python_files
from .astutil import _attr_chain, suppressed

RULES: dict[str, tuple[str, str]] = {
    "GL001": (
        "numpy call on a traced value inside jit",
        "use the jnp equivalent, or hoist the host-side numpy work out "
        "of the jitted function",
    ),
    "GL002": (
        "Python control flow on a traced value inside jit",
        "data-dependent branches fail at trace time: use jnp.where / "
        "jax.lax.cond / jax.lax.while_loop, or mark the argument in "
        "static_argnames",
    ),
    "GL003": (
        "host coercion of a traced value inside jit",
        ".item()/int()/float() force a concrete value during tracing: "
        "return the array and coerce outside the jitted function",
    ),
    "GL004": (
        "dict iteration feeding a stacked array inside jit",
        "iterate sorted(d.items()) (or another explicit order) so the "
        "trace does not depend on dict insertion order",
    ),
    "GL005": (
        "untyped float literal in a dtype-sensitive constructor",
        "pass dtype= explicitly; weak-typed literals resolve differently "
        "with and without x64, splitting the jit cache",
    ),
    "GL006": (
        "donated argument referenced after the jitted call",
        "donate_argnums invalidates the caller's buffer at dispatch: "
        "rebind the result to the same name (state = f(state, x)) or "
        "drop the reference — reading a donated array afterwards raises "
        "'Array has been deleted' at runtime (and only on backends that "
        "implement donation, so CPU tests may pass while TPU crashes)",
    ),
    "GL007": (
        "host clock call inside jit",
        "host clocks execute once at TRACE time and are baked into the "
        "compiled program as constants — the timing silently measures "
        "nothing; time on the host around the jitted call (after "
        "block_until_ready) or capture a profiler trace instead",
    ),
}

# Host clock callables flagged by GL007. Keyed by how they are reached:
# attribute calls off a `time` import, off a `datetime` import (module or
# the datetime class — both expose .now-style constructors), or bare
# names bound by `from time import ...`.
_TIME_CLOCK_FNS = {
    "time", "time_ns", "perf_counter", "perf_counter_ns", "monotonic",
    "monotonic_ns", "process_time", "process_time_ns", "clock_gettime",
}
_DATETIME_CLOCK_FNS = {"now", "utcnow", "today"}

# Attribute reads that are concrete (static) under tracing. `capacity`
# is the repo convention for a shape read (EdgeChunk.capacity is
# src.shape[0]).
_STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "aval", "sharding",
                 "weak_type", "capacity"}
# Builtins whose results are concrete under tracing.
_STATIC_CALLS = {"len", "isinstance", "hasattr", "getattr", "type", "range"}
# jnp constructors with a dtype parameter: name -> index of the dtype
# positional slot (args at or past it mean dtype was passed).
_DTYPE_SENSITIVE = {"array": 1, "asarray": 1, "full": 2, "full_like": 2,
                    "arange": 3}
_STACKERS = {"stack", "concatenate", "vstack", "hstack", "column_stack"}
_COERCERS = {"int", "float", "bool", "complex"}
_SYNC_METHODS = {"item", "tolist"}

# Pallas-alias calls that yield TRACED values (everything else reached
# through a pallas alias — pl.ds, pl.cdiv, pl.BlockSpec, pltpu.VMEM,
# grid-spec constructors — is meta/concrete plumbing).
_PALLAS_TRACED_CALLS = {"pallas_call", "load", "program_id"}

# ---------------------------------------------------------------------
# The PyTorch vocabulary (modules that import torch and not jax).

#: The summaries of the rules as the PyTorch vocabulary words them (the
#: hints are :data:`RULES`'; the ids and hazards are the same).
TORCH_RULES: dict[str, str] = {
    "GL001": "numpy call on a tensor inside a device scope",
    "GL002": "Python control flow on a tensor inside a device scope",
    "GL003": "uncounted host sync inside a device scope",
    "GL004": "dict iteration feeding a stacked tensor inside a device "
             "scope",
    "GL005": "untyped float literal in a dtype-sensitive constructor",
    "GL006": "state read after an in-place plan entry without the rebind",
    "GL007": "host clock around or inside a device scope without a sync",
}
_TORCH_HINTS: dict[str, str] = {
    "GL001": "keep the work on the device (torch ops), or route the one "
             "sync the fold needs through ops.unionfind.host_sync",
    "GL002": "a Python branch on a tensor is an implicit bool() sync: "
             "branch on a host_sync()/_any() value, or keep it on the "
             "device (torch.where)",
    "GL003": "route a sync the fold needs through ops.unionfind.host_sync "
             "(counted), or keep the value on the device",
    "GL004": RULES["GL004"][1],
    "GL005": "pass dtype= explicitly: a float literal gives float32 here "
             "where gelly_tpu under x64 gives float64",
    "GL006": "the entry updates its state argument in place: rebind the "
             "result to the same name (state = f(state, x)) and read "
             "that",
    "GL007": "synchronize (torch.cuda.synchronize, an Event, host_sync, "
             ".item()) after the device work and before the second clock "
             "read, or time with CUDA events; a clock inside a scope "
             "times the host only",
}

#: The device fields of ``SummaryAggregation``/``LaneForm``: the ones
#: ``gelly_tpu``'s engine jits (``transform`` unless ``jit_transform`` is
#: False). ``host_compress``, ``stack_payloads``, ``codec_payload_check``
#: and the ``on_*`` hooks run on the host.
DEVICE_FIELDS = ("init", "fold", "fold_compressed", "combine", "transform",
                 "flatten", "merge_stacked", "merge_delta",
                 "merge_dirty_count")

#: Constructions whose device-field arguments are scopes: the callable's
#: name -> its positional parameters, in order.
_SCOPE_CONSTRUCTORS: dict[str, tuple] = {
    "SummaryAggregation": (
        "init", "fold", "combine", "transform", "transient",
        "jit_transform", "merge_stacked", "host_compress",
        "fold_compressed"),
    "LaneForm": ("slots", "fold", "fold_compressed", "combine",
                 "transform", "flatten"),
    "lane_form_of": ("agg", "fold", "fold_compressed", "combine",
                     "transform", "flatten"),
}

#: ``(port module basename, function)`` -> the ``gelly_tpu`` jit site
#: (``relpath:function``, under ``gelly_tpu/``) it stands for, or the
#: Pallas wrapper / XLA device loop an ``ops/kernels.py`` entry replaces.
#: Every def of that name in a module of that basename is a scope.
DEVICE_SCOPES: dict[tuple[str, str], str] = {
    ("hashset.py", "insert_chunk"): "ops/hashset.py:insert_chunk",
    ("hashset.py", "contains_chunk"): "ops/hashset.py:contains_chunk",
    ("neighborhood.py", "_adj_step"): "core/neighborhood.py:_adj_step",
    ("snapshot.py", "_sorted_view"): "core/snapshot.py:_sorted_view",
    ("snapshot.py", "_segmented_scan"): "core/snapshot.py:close",
    ("snapshot.py", "fold_view"): "core/snapshot.py:close",
    ("stream.py", "_vertices_step"): "core/stream.py:_vertices_step",
    ("stream.py", "_edge_count_step"): "core/stream.py:_edge_count_step",
    ("stream.py", "_vertex_count_step"):
        "core/stream.py:_vertex_count_step",
    ("stream.py", "dedup_device"): "core/stream.py:_pair_keys",
    ("stream.py", "_degree_step"): "core/stream.py:_degree_step",
    ("stream.py", "scatter_degrees"): "core/stream.py:_degree_step",
    ("aggregation.py", "fold_many"): "engine/aggregation.py:fold_many",
    ("aggregation.py", "fold_shards"): "engine/aggregation.py:fold_step",
    ("aggregation.py", "merge_locals"):
        "engine/aggregation.py:merge_locals",
    ("aggregation.py", "fresh_locals"):
        "engine/aggregation.py:locals0_fn",
    ("aggregation.py", "batch_init"): "engine/aggregation.py:batch_init",
    ("degrees.py", "_broadcast_step"): "library/degrees.py:step",
    ("degrees.py", "_exchange_step"): "library/degrees.py:step",
    ("iterative_cc.py", "_propagate"): "library/iterative_cc.py:_propagate",
    ("matching.py", "_matching_step"): "library/matching.py:_matching_step",
    ("sharded_triangles.py", "_sharded_exact_chunk"):
        "library/sharded_triangles.py:step",
    ("triangles.py", "_window_triangle_count"):
        "library/triangles.py:_window_triangle_count",
    ("triangles.py", "_rebase_dense"): "library/triangles.py:_rebase_dense",
    ("triangles.py", "_rebase_sparse"):
        "library/triangles.py:_rebase_sparse",
    ("triangles.py", "_window_triangle_count_packed"):
        "library/triangles.py:_window_triangle_count_packed",
    ("triangles.py", "_window_triangle_count_sparse"):
        "library/triangles.py:_window_triangle_count_sparse",
    ("triangles.py", "_window_triangle_count_bucketed_group"):
        "library/triangles.py:_window_triangle_count_bucketed_group",
    ("triangles.py", "_window_triangle_count_packed_group"):
        "library/triangles.py:_window_triangle_count_packed_group",
    ("triangles.py", "_window_triangle_count_sparse_group"):
        "library/triangles.py:_window_triangle_count_sparse_group",
    ("triangles.py", "_exact_step_scan"):
        "library/triangles.py:_exact_step_scan",
    ("triangles.py", "_exact_step"): "library/triangles.py:_exact_step",
    ("triangles.py", "_sparse_exact_step"):
        "library/triangles.py:_sparse_exact_step",
    ("triangles.py", "_sampler_step"): "library/triangles.py:_sampler_step",
    ("triangles.py", "_wedge_count_slabbed"): "library/triangles.py:close",
    ("sharded_cc.py", "_fold_pairs"): "parallel/sharded_cc.py:fold_fn",
    ("sharded_cc.py", "_pull_delta"): "parallel/sharded_cc.py:fn",
    ("sharded_cc.py", "labels"): "parallel/sharded_cc.py:count_dirty",
    ("sharded_cc.py", "__init__"): "parallel/sharded_cc.py:init",
    ("sharded_triangles.py", "__init__"):
        "library/sharded_triangles.py:init",
    # The tenant plan's stacked folds and maps (stacked_fold/lane_fold,
    # stacked_map/lane_map closures).
    ("aggregation.py", "fold"): "engine/aggregation.py:851",
    ("aggregation.py", "fn"): "engine/aggregation.py:869",
    ("sharded_window.py", "_append"): "parallel/sharded_window.py:append",
    ("sharded_window.py", "_views"):
        "parallel/sharded_window.py:make_views",
    ("sharded_window.py", "_gather"): "parallel/sharded_window.py:close",
    # ops/kernels.py: the hand kernels' wrappers.
    ("kernels.py", "wedge_count_matrix"):
        "ops/pallas_kernels.py:wedge_count_matrix",
    ("kernels.py", "sorted_window_gather"):
        "ops/pallas_kernels.py:sorted_window_gather",
    ("kernels.py", "blocked_gather"): "ops/pallas_kernels.py:blocked_gather",
    ("kernels.py", "sparse_insert_edges"):
        "library/spanner.py:_sparse_insert_edges",
    ("kernels.py", "sparse_insert_edges_batched"):
        "library/spanner.py:_sparse_insert_edges_batched",
    ("kernels.py", "matching_step"): "library/matching.py:_matching_step",
    ("kernels.py", "hashset_insert"): "ops/hashset.py:insert_chunk",
    ("kernels.py", "hashset_contains"): "ops/hashset.py:contains_chunk",
    ("kernels.py", "row_insert_chunk"): "core/neighborhood.py:_row_step",
    ("kernels.py", "sampler_step"): "library/triangles.py:_sampler_step",
}

#: ``gelly_tpu`` jit sites that are not one def of the same name in the
#: port (``relpath:function`` of a jitted def, ``relpath:line`` of a
#: ``jax.jit(...)`` call on a lambda, an attribute or a ``vmap``) -> what
#: stands for them: ``"field <name>"``, a device field of every plan (a
#: scope by way (a)); ``"attribute <name>"``, a plan attribute of
#: :data:`DEVICE_ATTRIBUTES`; ``"<basename>:<function>"``, a
#: :data:`DEVICE_SCOPES` def; ``"user function"``, a function the caller
#: passes (``map_edges``, ``global_aggregate``, ``apply_on_neighbors``),
#: which is not the package's to lint.
OTHER_JIT_SITES: dict[str, str] = {
    "engine/aggregation.py:merger_step": "field combine",
    "engine/aggregation.py:delta_count_fn": "field merge_dirty_count",
    "engine/aggregation.py:fn": "field merge_delta",
    "engine/aggregation.py:fold_codec": "field fold_compressed",
    "engine/aggregation.py:526": "field init",
    "engine/aggregation.py:528": "field fold",
    "engine/aggregation.py:529": "aggregation.py:merge_locals",
    "engine/aggregation.py:543": "field fold_compressed",
    "engine/aggregation.py:716": "field transform",
    "engine/aggregation.py:724": "field flatten",
    "engine/aggregation.py:865": "aggregation.py:fold",
    "engine/aggregation.py:872": "aggregation.py:fn",
    "engine/aggregation.py:886": "aggregation.py:fn",
    "library/connected_components.py:693":
        "attribute windowed_persist_update",
    "core/stream.py:fn": "user function",
    "core/stream.py:update_fn": "user function",
    "core/snapshot.py:apply_fn": "user function",
}

#: Plan attributes set after construction whose function is a scope
#: (``agg.<name> = <function>``), as ``gelly_tpu`` jits them.
DEVICE_ATTRIBUTES = ("windowed_persist_update",)

#: The in-place plan entries of GL006 (ROADMAP, "Divergences kept by
#: design"): ``(module basename, function)`` of the functions that update
#: their first argument in place (the spanner's gates and folds), and
#: ``("*", attribute)`` of the calls ``<...plan>.<attribute>(state, ...)``
#: (the tenant plan's folds and merger) and ``<agg>.<attribute>(...)``
#: (a plan's fold and combine under the Merger, which may work in place).
IN_PLACE_ENTRIES: frozenset = frozenset({
    ("spanner.py", "_insert_edges"),
    ("spanner.py", "_insert_edges_batched"),
    ("spanner.py", "_sparse_insert_edges"),
    ("spanner.py", "_sparse_fold_chunk_k2"),
    ("spanner.py", "_sparse_insert_edges_batched"),
    ("kernels.py", "sparse_insert_edges"),
    ("kernels.py", "sparse_insert_edges_batched"),
    ("*", "plan.fold"),
    ("*", "plan.fold_codec"),
    ("*", "plan.merger"),
    ("*", "agg.fold"),
    ("*", "agg.fold_compressed"),
    ("*", "agg.combine"),
})

_IN_PLACE_NAMES = frozenset(name.split(".")[-1]
                            for _base, name in IN_PLACE_ENTRIES)

#: The counted syncs: their results are host values, and they are never
#: expanded as callees (``ops/unionfind.py``).
SYNC_HELPERS = frozenset({"host_sync", "_any"})

#: GL007's synchronizing calls: a method or function of these names.
SYNC_CALLS = frozenset({"synchronize", "host_sync", "_any", "item",
                        "tolist", "to_numpy", "numpy"})

_TORCH_STATIC_ATTRS = _STATIC_ATTRS | {"device", "is_cuda", "layout",
                                       "requires_grad", "is_sparse",
                                       "itemsize"}
_TORCH_STATIC_METHODS = {"numel", "size", "dim", "element_size",
                         "nelement", "stride", "is_contiguous", "data_ptr",
                         "get_device", "storage_offset",
                         "is_floating_point", "is_complex"}
# torch.* attributes that are not tensor-valued calls.
_TORCH_HOST_NAMESPACES = {"cuda", "device", "Size", "is_tensor", "dtype",
                          "get_default_dtype", "no_grad", "inference_mode",
                          "backends", "distributed", "Generator", "iinfo",
                          "finfo", "profiler", "utils", "autograd",
                          "set_grad_enabled", "manual_seed", "Stream",
                          "Event", "testing", "library", "ops",
                          "from_numpy"}
_TORCH_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_TORCH_DATA_DEPENDENT = {"nonzero", "unique", "unique_consecutive",
                         "masked_select", "argwhere", "bincount"}
# torch constructors with a dtype: name -> positional index of dtype
# (None: keyword-only).
_TORCH_DTYPE_SENSITIVE = {"tensor": None, "as_tensor": 1, "full": None,
                          "full_like": None, "arange": None,
                          "linspace": None}
_TORCH_STACKERS = _STACKERS | {"cat"}
# Host-only annotation tokens: a parameter annotated with nothing else is
# not a tensor.
_HOST_ANNOTATIONS = {"int", "bool", "str", "float", "complex", "bytes",
                     "tuple", "list", "dict", "set", "frozenset", "None",
                     "Callable", "callable", "type", "slice", "device",
                     "dtype", "torch", "Optional", "Iterator", "Iterable",
                     "Sequence", "Mapping", "np", "ndarray", "numpy",
                     "ctypes", "CDLL"}
# Parameters that hold host objects by the port's naming.
_HOST_PARAMS = {"mesh", "mesh_", "lib", "device", "dev", "devices", "ctx",
                "tracer", "bus"}
_MASK_NAMES = re.compile(r"(^|_)(mask|valid|keep|live|ok)$")


def _scope_bound_names(fn: ast.FunctionDef) -> set:
    """Names BOUND inside ``fn``'s own scope: parameters, assignment /
    for / with targets, local imports, and the names of nested
    defs/classes (whose bodies are separate scopes and bind nothing
    here). GL007 consults this so a local that shadows a module-level
    ``time``/``perf_counter`` import is never mistaken for the stdlib
    clock (the same shadowing class GL006's donation lint handles)."""
    a = fn.args
    out = {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs}
    for v in (a.vararg, a.kwarg):
        if v is not None:
            out.add(v.arg)
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
            continue  # nested scope — do not descend
        if isinstance(node, ast.Lambda):
            continue
        if isinstance(node, ast.Name) and isinstance(node.ctx,
                                                     (ast.Store, ast.Del)):
            out.add(node.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for al in node.names:
                out.add(al.asname or al.name.split(".")[0])
        stack.extend(ast.iter_child_nodes(node))
    return out


def _unparse(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # noqa: BLE001 — synthetic nodes
        return ""


def _same_scope_nodes(fn):
    """Every node of ``fn``'s own scope (nested defs, classes and
    lambdas are other scopes)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


@dataclasses.dataclass
class _Module:
    path: str
    dotted: str                      # gelly_tpu.core.stream
    tree: ast.Module
    lines: list[str]
    numpy_aliases: set
    jnp_aliases: set                 # names bound to jax.numpy
    jax_aliases: set                 # names bound to jax itself
    time_aliases: set                # names bound to the time module
    datetime_aliases: set            # names bound to datetime (module or
    #   the datetime class via from-import) — both expose .now etc.
    clock_names: set                 # bare names from `from time import …`
    pallas_aliases: set              # names bound to jax.experimental.pallas
    #   (or .tpu) — pl / pltpu under any local alias
    pallas_call_names: set           # names bound to pallas_call itself
    jit_names: set                   # names bound to jax.jit via from-import
    module_aliases: dict             # local name -> module path on disk
    from_functions: dict             # local name -> (module path, def name)
    functions: dict                  # def name -> ast.FunctionDef, for call
    #   resolution (module-level defs win over same-named nested ones)
    all_functions: list              # EVERY def node — lint iterates this,
    #   so a jitted function shadowed by a later same-named def still runs
    jit_called: dict                 # def name -> statics (jax.jit(f) form)
    torch_aliases: set = dataclasses.field(default_factory=set)
    #   names bound to torch itself
    reads_torch: bool = False        # imports torch or gelly_torch
    scopes: dict | None = None       # torch: id(scope node) -> (node, via)
    parents: dict | None = None      # id(node) -> its parent node

    @property
    def is_torch(self) -> bool:
        """Read in the PyTorch vocabulary: imports torch (or the port,
        ``gelly_torch``), not jax."""
        return self.reads_torch and not (
            self.jax_aliases or self.jnp_aliases or self.jit_names
            or self.pallas_aliases or self.pallas_call_names)


# The packages whose imports resolve to modules on disk.
_PACKAGES = ("gelly_tpu", "gelly_torch")


class JitLinter:
    """Lints a set of Python files; loads cross-module callees lazily."""

    def __init__(self, package_root: str, cache=None):
        # package_root is the directory CONTAINING the gelly_tpu package.
        from .loader import SourceCache

        self.package_root = os.path.abspath(package_root)
        self._modules: dict[str, _Module] = {}
        self._cache = cache or SourceCache()
        self._visited: set = set()
        self.findings: list[Finding] = []
        self._defs_memo: dict = {}   # id(def) -> its local defs
        self._sync_memo: dict = {}   # id(def) -> it calls a sync

    # ---------------------------------------------------------- loading

    def _dotted_name(self, path: str) -> str:
        rel = os.path.relpath(os.path.abspath(path), self.package_root)
        rel = rel[:-3] if rel.endswith(".py") else rel
        parts = [p for p in rel.split(os.sep) if p != "."]
        if parts and parts[-1] == "__init__":
            parts = parts[:-1]
        return ".".join(parts)

    def _module_path(self, dotted: str):
        base = os.path.join(self.package_root, *dotted.split("."))
        for cand in (base + ".py", os.path.join(base, "__init__.py")):
            if os.path.exists(cand):
                return cand
        return None

    def load(self, path: str):
        """The derived module info, or None when the source is
        unparseable (recorded in the shared cache; ``lint_file``
        surfaces it as a SRC001 finding for in-set files)."""
        path = os.path.abspath(path)
        if path in self._modules:
            return self._modules[path]
        ms = self._cache.get(path)
        if ms is None:
            return None
        tree = ms.tree
        m = _Module(
            path=path, dotted=self._dotted_name(path), tree=tree,
            lines=ms.lines, numpy_aliases=set(), jnp_aliases=set(),
            jax_aliases=set(), time_aliases=set(), datetime_aliases=set(),
            clock_names=set(),
            pallas_aliases=set(), pallas_call_names=set(),
            jit_names=set(), module_aliases={}, from_functions={},
            functions={}, all_functions=[], jit_called={},
        )
        self._collect_imports(m)
        if m.dotted.split(".")[0] == "gelly_torch":
            m.reads_torch = True  # a module of the port
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                m.functions[node.name] = node
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                m.all_functions.append(node)
                m.functions.setdefault(node.name, node)
        self._collect_jit_calls(m)
        self._modules[path] = m
        return m

    def _collect_imports(self, m: _Module) -> None:
        for node in ast.walk(m.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    local = alias.asname or alias.name.split(".")[0]
                    if alias.name == "numpy":
                        m.numpy_aliases.add(local)
                    elif alias.name == "jax.numpy":
                        m.jnp_aliases.add(alias.asname or "jax")
                    elif alias.name.startswith("jax.experimental.pallas"):
                        # Only an EXPLICIT asname is a pallas alias: the
                        # plain form binds the name "jax", and marking
                        # "jax" as pallas would make _concrete_refs
                        # treat every jax.* call as meta plumbing —
                        # silently suppressing real findings module-wide.
                        if alias.asname:
                            m.pallas_aliases.add(alias.asname)
                    elif alias.name == "jax":
                        m.jax_aliases.add(local)
                    elif alias.name == "time":
                        m.time_aliases.add(local)
                    elif alias.name == "datetime":
                        m.datetime_aliases.add(local)
                    elif alias.name.split(".")[0] == "torch":
                        if alias.name == "torch" or alias.asname is None:
                            m.torch_aliases.add(local)
                        m.reads_torch = True
                    elif alias.name.split(".")[0] in _PACKAGES:
                        if alias.name.split(".")[0] == "gelly_torch":
                            m.reads_torch = True
                        p = self._module_path(alias.name)
                        if p:
                            m.module_aliases[alias.asname
                                             or alias.name.split(".")[-1]] = p
            elif isinstance(node, ast.ImportFrom):
                self._collect_import_from(m, node)

    def _collect_import_from(self, m: _Module, node: ast.ImportFrom) -> None:
        if node.level == 0 and node.module == "time":
            for alias in node.names:
                if alias.name in _TIME_CLOCK_FNS:
                    m.clock_names.add(alias.asname or alias.name)
            return
        if node.level == 0 and node.module == "datetime":
            for alias in node.names:
                if alias.name == "datetime":
                    m.datetime_aliases.add(alias.asname or "datetime")
            return
        if node.level == 0 and node.module == "jax":
            for alias in node.names:
                if alias.name == "numpy":
                    m.jnp_aliases.add(alias.asname or "numpy")
                elif alias.name == "jit":
                    m.jit_names.add(alias.asname or "jit")
            return
        if node.level == 0 and (node.module or "").split(".")[0] in (
                "torch", "gelly_torch"):
            m.reads_torch = True
            if node.module.split(".")[0] == "torch":
                return
        if node.level == 0 and node.module == "jax.numpy":
            return  # from jax.numpy import x — per-symbol, not linted
        if node.level == 0 and node.module == "jax.experimental":
            for alias in node.names:
                if alias.name == "pallas":
                    m.pallas_aliases.add(alias.asname or "pallas")
            return
        if node.level == 0 and node.module == "jax.experimental.pallas":
            for alias in node.names:
                if alias.name == "tpu":
                    m.pallas_aliases.add(alias.asname or "tpu")
                elif alias.name == "pallas_call":
                    m.pallas_call_names.add(alias.asname or "pallas_call")
            return
        # Resolve the source module (absolute gelly_tpu.* or relative).
        if node.level == 0:
            if (node.module or "").split(".")[0] not in _PACKAGES:
                return
            base = node.module
        else:
            pkg = m.dotted.split(".")
            # level=1 strips the module name itself; each extra level one
            # package more.
            pkg = pkg[: len(pkg) - node.level]
            base = ".".join(pkg + ([node.module] if node.module else []))
        for alias in node.names:
            local = alias.asname or alias.name
            sub = self._module_path(f"{base}.{alias.name}")
            if sub:
                m.module_aliases[local] = sub
                continue
            src = self._module_path(base)
            if src:
                m.from_functions[local] = (src, alias.name)

    def _is_jax_jit(self, m: _Module, node: ast.AST) -> bool:
        chain = _attr_chain(node)
        if chain is None:
            return False
        if len(chain) == 1:
            return chain[0] in m.jit_names
        return len(chain) == 2 and chain[0] in m.jax_aliases \
            and chain[1] == "jit"

    def _jit_statics(self, m: _Module, call: ast.Call):
        """static param names/positions from a jax.jit(...) call node."""
        names: set = set()
        nums: list[int] = []
        for kw in call.keywords:
            if kw.arg == "static_argnames":
                v = kw.value
                if isinstance(v, ast.Constant) and isinstance(v.value, str):
                    names.add(v.value)
                elif isinstance(v, (ast.Tuple, ast.List)):
                    names.update(e.value for e in v.elts
                                 if isinstance(e, ast.Constant))
            elif kw.arg == "static_argnums":
                v = kw.value
                if isinstance(v, ast.Constant) and isinstance(v.value, int):
                    nums.append(v.value)
                elif isinstance(v, (ast.Tuple, ast.List)):
                    nums.extend(e.value for e in v.elts
                                if isinstance(e, ast.Constant))
        return names, nums

    def _jit_decoration(self, m: _Module, fn: ast.FunctionDef):
        """(is_jitted, static names, static positions) from decorators."""
        for dec in fn.decorator_list:
            if self._is_jax_jit(m, dec):
                return True, set(), []
            if isinstance(dec, ast.Call):
                if self._is_jax_jit(m, dec.func):
                    names, nums = self._jit_statics(m, dec)
                    return True, names, nums
                if dec.args and self._is_jax_jit(m, dec.args[0]):
                    # partial(jax.jit, ...) under any partial spelling
                    names, nums = self._jit_statics(m, dec)
                    return True, names, nums
        return False, set(), []

    def _collect_jit_calls(self, m: _Module) -> None:
        """Record ``jax.jit(fn)`` calls that name a local function."""
        for node in ast.walk(m.tree):
            if (isinstance(node, ast.Call) and self._is_jax_jit(m, node.func)
                    and node.args and isinstance(node.args[0], ast.Name)):
                names, nums = self._jit_statics(m, node)
                m.jit_called[node.args[0].id] = (names, nums)

    # ---------------------------------------------------------- linting

    def lint_paths(self, paths) -> list[Finding]:
        for path in collect_python_files(paths):
            self.lint_file(path)
        return self.findings

    def lint_file(self, path: str) -> None:
        if self._cache.get_or_finding(path, self.findings) is None:
            return
        m = self.load(path)
        if m.is_torch:
            self._lint_torch_module(m)
            return
        for fn in m.all_functions:
            jitted, statics, nums = self._jit_decoration(m, fn)
            if not jitted and fn.name in m.jit_called:
                jitted = True
                statics, nums = m.jit_called[fn.name]
            if jitted:
                traced = self._traced_params(fn, statics, nums)
                self._lint_function(m, fn, traced,
                                    via=f"jitted {fn.name!r}", expand=True)
        # Every pallas_call site in the module descends into its kernel,
        # jitted context or not — kernels always compile (Mosaic), so the
        # same hazards apply. (_visited dedups kernels reached both ways.)
        for node in ast.walk(m.tree):
            if isinstance(node, ast.Call) and self._is_pallas_call(m, node):
                self.expand_pallas_kernel(m, node, via="pallas_call")
        # GL006 is a CALLER-side rule (donation use-after-free), so it
        # scans every function — not just jitted ones.
        donated = self._module_donations(m)
        for fn in m.all_functions:
            _DonationLint(self, m, donated).run(fn)

    # ------------------------------------------------ torch modules

    def _lint_torch_module(self, m: _Module) -> None:
        for node, via, mod in list(self.scopes_of(m).values()):
            self._lint_function(mod, node, self._torch_params(node),
                                via=via, expand=True)
        scope_ids = set(self.scopes_of(m))
        clocks = [fn for fn in m.all_functions if id(fn) not in scope_ids
                  and any(isinstance(n, ast.Call)
                          and self._is_clock(m, n, set()) is not None
                          for n in _same_scope_nodes(fn))]
        for fn in clocks:
            self._clock_intervals(m, fn)
        # GL006 only where an in-place entry is reachable at all.
        if any((isinstance(n, ast.Call)
                and self._in_place_call(m, n, {}) is not None)
               or (isinstance(n, ast.Attribute)
                   and self._in_place_attr(m, n) is not None)
               for n in ast.walk(m.tree)):
            for fn in m.all_functions:
                _DonationLint(self, m, {}).run(fn)

    @staticmethod
    def _parents(m: _Module) -> dict:
        if m.parents is None:
            m.parents = {id(child): node for node in ast.walk(m.tree)
                         for child in ast.iter_child_nodes(node)}
        return m.parents

    def _enclosing_function(self, m: _Module, node: ast.AST):
        par = self._parents(m)
        cur = par.get(id(node))
        while cur is not None and not isinstance(
                cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            cur = par.get(id(cur))
        return cur

    def _local_defs(self, fn) -> dict:
        """name -> def for the defs directly in ``fn``'s own scope."""
        hit = self._defs_memo.get(id(fn))
        if hit is not None:
            return hit
        out: dict = {}
        self._defs_memo[id(fn)] = out
        stack = list(ast.iter_child_nodes(fn))
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.setdefault(node.name, node)
                continue
            if isinstance(node, (ast.Lambda, ast.ClassDef)):
                continue
            stack.extend(ast.iter_child_nodes(node))
        return out

    def _lookup(self, m: _Module, name: str, encl):
        """The def ``name`` names at a point inside ``encl`` (None: module
        level): ``(module, def)`` or None. Enclosing functions' local defs
        first, then the module's top-level defs, then from-imports. A
        parameter of an enclosing function shadows everything."""
        cur = encl
        while cur is not None:
            a = cur.args
            if name in {p.arg for p in a.posonlyargs + a.args
                        + a.kwonlyargs}:
                return None
            local = self._local_defs(cur).get(name)
            if local is not None:
                return m, local
            cur = self._enclosing_function(m, cur)
        for node in m.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name == name:
                return m, node
        if name in m.from_functions:
            path, fname = m.from_functions[name]
            mod = self.load(path)
            if mod is not None:
                fn = mod.functions.get(fname)
                if fn is not None:
                    return mod, fn
        return None

    def _function_refs(self, m: _Module, expr: ast.AST, encl) -> list:
        """``[(module, def or lambda)]`` a device-field value names."""
        if isinstance(expr, ast.Lambda):
            return [(m, expr)]
        if isinstance(expr, ast.IfExp):
            return (self._function_refs(m, expr.body, encl)
                    + self._function_refs(m, expr.orelse, encl))
        if isinstance(expr, ast.Call):
            chain = _attr_chain(expr.func)
            if chain and chain[-1] == "partial" and expr.args:
                return self._function_refs(m, expr.args[0], encl)
            return []
        if isinstance(expr, ast.Name):
            hit = self._lookup(m, expr.id, encl)
            return [hit] if hit is not None else []
        chain = _attr_chain(expr)
        if chain and len(chain) == 2 and chain[0] in m.module_aliases:
            mod = self.load(m.module_aliases[chain[0]])
            fn = mod.functions.get(chain[1]) if mod is not None else None
            return [(mod, fn)] if fn is not None else []
        return []

    def scopes_of(self, m: _Module) -> dict:
        """The device scopes a torch module declares: ``id(node) ->
        (node, via, module holding the node)`` — the ``DEVICE_SCOPES``
        defs of its basename and the functions its constructions bind to
        device fields (possibly in other modules)."""
        if m.scopes is not None:
            return m.scopes
        m.scopes = {}
        if not m.is_torch:
            return m.scopes
        base = os.path.basename(m.path)
        for fn in m.all_functions:
            if (base, fn.name) in DEVICE_SCOPES:
                m.scopes[id(fn)] = (fn, f"device scope {fn.name!r}", m)
        for node in ast.walk(m.tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Attribute) \
                    and node.targets[0].attr in DEVICE_ATTRIBUTES:
                encl = self._enclosing_function(m, node)
                for mod, fn in self._function_refs(m, node.value, encl):
                    m.scopes.setdefault(id(fn), (
                        fn, f"{node.targets[0].attr} "
                        f"{getattr(fn, 'name', '<lambda>')!r}", mod))
        for call in ast.walk(m.tree):
            if not isinstance(call, ast.Call):
                continue
            chain = _attr_chain(call.func)
            if not chain or chain[-1] not in _SCOPE_CONSTRUCTORS:
                continue
            ctor = chain[-1]
            names = _SCOPE_CONSTRUCTORS[ctor]
            fields = {names[i]: a for i, a in enumerate(call.args)
                      if i < len(names)}
            fields.update({kw.arg: kw.value for kw in call.keywords
                           if kw.arg})
            jt = fields.get("jit_transform")
            host_transform = isinstance(jt, ast.Constant) \
                and jt.value is False
            encl = self._enclosing_function(m, call)
            for field in DEVICE_FIELDS:
                if field not in fields or (field == "transform"
                                           and host_transform):
                    continue
                for mod, node in self._function_refs(m, fields[field],
                                                     encl):
                    label = getattr(node, "name", "<lambda>")
                    m.scopes.setdefault(id(node), (
                        node, f"{ctor}.{field} {label!r}", mod))
        return m.scopes

    def device_scopes(self, paths) -> dict:
        """``{path: [(first line, last line, scope name)]}`` of every
        device scope the torch modules under ``paths`` declare, with the
        same-module callees the lint expands into (one level)."""
        out: dict = {}
        for path in collect_python_files(paths):
            if self._cache.get(path) is None:
                continue
            m = self.load(path)
            if not m.is_torch:
                continue
            for node, via, mod in self.scopes_of(m).values():
                out.setdefault(mod.path, set()).add(
                    (node.lineno, node.end_lineno,
                     getattr(node, "name", "<lambda>")))
                for callee in self._torch_callees(mod, node):
                    out[mod.path].add((callee.lineno, callee.end_lineno,
                                       callee.name))
        return {p: sorted(v) for p, v in out.items()}

    def _torch_callees(self, m: _Module, fn) -> list:
        """The same-module defs a scope calls by name (expansion (c))."""
        encl = fn if not isinstance(fn, ast.Lambda) else \
            self._enclosing_function(m, fn)
        out = []
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and isinstance(node.func,
                                                         ast.Name):
                hit = self._lookup(m, node.func.id, encl)
                if hit is not None and hit[0] is m \
                        and self._expandable(hit[1]):
                    out.append(hit[1])
        return out

    @staticmethod
    def _expandable(fn) -> bool:
        return (fn.name not in SYNC_HELPERS
                and not fn.name.endswith("_plain"))

    @staticmethod
    def _torch_params(fn) -> set:
        """A scope's tensor parameters: all but ``self``/``cls``, those
        annotated with host types only, and those defaulted to a constant
        other than None."""
        a = fn.args
        pos = a.posonlyargs + a.args
        defaults = dict(zip([p.arg for p in pos][len(pos) - len(a.defaults):],
                            a.defaults))
        defaults.update({p.arg: d for p, d in zip(a.kwonlyargs,
                                                  a.kw_defaults)
                         if d is not None})
        out = set()
        for p in pos + a.kwonlyargs:
            if p.arg in ("self", "cls") or p.arg in _HOST_PARAMS:
                continue
            if p.annotation is not None:
                toks = set(re.findall(r"[A-Za-z_]\w*",
                                      _unparse(p.annotation)))
                if toks and toks <= _HOST_ANNOTATIONS:
                    continue
            d = defaults.get(p.arg)
            if isinstance(d, ast.Constant) and d.value is not None:
                continue
            out.add(p.arg)
        return out

    def _in_place_call(self, m: _Module, call: ast.Call, bound: dict):
        """Positions an in-place plan entry updates, or None: a def of
        :data:`IN_PLACE_ENTRIES` called by name or through a module
        alias, a ``<...plan>.fold``-style attribute call, or a local
        ``bound`` to one of those."""
        func = call.func
        if isinstance(func, ast.Name):
            if func.id in bound:
                return bound[func.id]
            if func.id not in _IN_PLACE_NAMES:
                return None
            hit = self._lookup(m, func.id, self._enclosing_function(m, call))
            if hit is not None and (os.path.basename(hit[0].path),
                                    hit[1].name) in IN_PLACE_ENTRIES:
                return (0,)
            return None
        return self._in_place_attr(m, func)

    def _in_place_attr(self, m: _Module, func: ast.AST):
        if not isinstance(func, ast.Attribute) \
                or func.attr not in _IN_PLACE_NAMES:
            return None
        chain = _attr_chain(func)
        if not chain or len(chain) < 2:
            return None
        if chain[0] in m.module_aliases:
            base = os.path.basename(m.module_aliases[chain[0]])
            return (0,) if (base, chain[-1]) in IN_PLACE_ENTRIES else None
        tail = f"{chain[-2]}.{chain[-1]}"
        return (0,) if ("*", tail) in IN_PLACE_ENTRIES else None

    # ------------------------------------------- GL007 host intervals

    def _is_clock(self, m: _Module, call: ast.Call, shadowed: set):
        chain = _attr_chain(call.func)
        if not chain or chain[0] in shadowed:
            return None
        if len(chain) == 1 and chain[0] in m.clock_names:
            return chain[0]
        if len(chain) >= 2 and chain[0] in m.time_aliases \
                and chain[-1] in _TIME_CLOCK_FNS:
            return ".".join(chain)
        if len(chain) >= 2 and chain[0] in m.datetime_aliases \
                and chain[-1] in _DATETIME_CLOCK_FNS:
            return ".".join(chain)
        return None

    def _scope_call(self, m: _Module, call: ast.Call, encl,
                    bound: set):
        """A label when ``call`` goes into a device scope: a scope def
        (this module's or a resolved import's, ``ops/kernels`` entries
        included), a plan's device field (``agg.fold(...)``,
        ``batch.plan.fold(...)``), or a local bound to one."""
        func = call.func
        if isinstance(func, ast.Name):
            if func.id in bound:
                return func.id
            hit = self._lookup(m, func.id, encl)
            if hit is not None and id(hit[1]) in self._all_scope_ids(
                    hit[0]):
                return func.id
            return None
        chain = _attr_chain(func)
        if not chain or len(chain) < 2:
            return None
        if len(chain) == 2 and chain[0] in m.module_aliases:
            mod = self.load(m.module_aliases[chain[0]])
            fn = mod.functions.get(chain[1]) if mod is not None else None
            if fn is not None and id(fn) in self._all_scope_ids(mod):
                return ".".join(chain)
            return None
        if self._device_field_attr(chain):
            return ".".join(chain)
        return None

    def _syncs_inside(self, m: _Module, call: ast.Call, encl) -> bool:
        """A call of a same-module def that itself calls a synchronizing
        function (``emit`` ends in a stream sync)."""
        if not isinstance(call.func, ast.Name):
            return False
        hit = self._lookup(m, call.func.id, encl)
        if hit is None or hit[0] is not m:
            return False
        memo = self._sync_memo.get(id(hit[1]))
        if memo is None:
            memo = self._sync_memo[id(hit[1])] = any(
                isinstance(node, ast.Call) and (
                    node.func.attr if isinstance(node.func, ast.Attribute)
                    else getattr(node.func, "id", None)) in SYNC_CALLS
                for node in _same_scope_nodes(hit[1]))
        return memo

    @staticmethod
    def _device_field_attr(chain) -> bool:
        return (chain[-1] in DEVICE_FIELDS + ("fold_codec", "merger")
                and re.search(r"(agg|plan|form)\w*$", chain[-2] or "")
                is not None)

    def _all_scope_ids(self, m: _Module) -> set:
        return {id(node) for node, _v, mod in self.scopes_of(m).values()
                if mod is m}

    def _clock_intervals(self, m: _Module, fn) -> None:
        """GL007's interval form over one function (nested defs are
        their own functions): a clock read, a call into a scope, and a
        second clock read with no synchronizing call between that call
        and the read, in execution order (the branches of an ``if`` are
        exclusive; a branch that returns or raises does not flow on)."""
        shadowed = _scope_bound_names(fn)
        bound: set = set()
        fname = getattr(fn, "name", "<lambda>")
        # A closing read: a clock call subtracted from (`clock() - t0`),
        # or assigned to a name that is.
        minuends = {id(n.left) for n in _same_scope_nodes(fn)
                    if isinstance(n, ast.BinOp) and isinstance(n.op, ast.Sub)}
        minuend_names = {n.left.id for n in _same_scope_nodes(fn)
                         if isinstance(n, ast.BinOp)
                         and isinstance(n.op, ast.Sub)
                         and isinstance(n.left, ast.Name)}
        closing = set(minuends)
        for n in _same_scope_nodes(fn):
            if isinstance(n, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id in minuend_names
                    for t in n.targets):
                closing.add(id(n.value))

        def on_call(call, state):
            clock = self._is_clock(m, call, shadowed)
            if clock is not None:
                if state["pending"] is not None and id(call) in closing:
                    label, line = state["pending"]
                    self._emit(
                        m, call, "GL007",
                        f"{clock}() closes an interval around {label}(...) "
                        f"(line {line}) with no synchronizing call after "
                        "it: it times the enqueue",
                        f"host timing in {fname!r}")
                    state["pending"] = None
                state["clock"] = True
                return
            func = call.func
            name = func.attr if isinstance(func, ast.Attribute) else (
                func.id if isinstance(func, ast.Name) else None)
            if name in SYNC_CALLS or self._syncs_inside(m, call, fn):
                state["pending"] = None
            elif state["clock"] and state["pending"] is None:
                label = self._scope_call(m, call, fn, bound)
                if label is not None:
                    state["pending"] = (label, call.lineno)

        def expr(node, state):
            # Post-order: a call's operands run before the call.
            if node is None or isinstance(node, ast.Lambda):
                return
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.expr):
                    expr(child, state)
                elif isinstance(child, ast.keyword):
                    expr(child.value, state)
                elif isinstance(child, ast.comprehension):
                    expr(child.iter, state)
                    for c in child.ifs:
                        expr(c, state)
            if isinstance(node, ast.Call):
                on_call(node, state)

        def block(stmts, state):
            for st in stmts:
                if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.ClassDef)):
                    continue
                if isinstance(st, ast.If):
                    expr(st.test, state)
                    outs = []
                    for branch in (st.body, st.orelse):
                        sub = dict(state)
                        block(branch, sub)
                        if not (branch and isinstance(
                                branch[-1], (ast.Return, ast.Raise))):
                            outs.append(sub)
                    if outs:
                        state["clock"] = any(o["clock"] for o in outs)
                        state["pending"] = next(
                            (o["pending"] for o in outs if o["pending"]),
                            None)
                    continue
                if isinstance(st, (ast.For, ast.AsyncFor)):
                    expr(st.iter, state)
                    block(st.body, state)
                    block(st.orelse, state)
                    continue
                if isinstance(st, ast.While):
                    expr(st.test, state)
                    block(st.body, state)
                    block(st.orelse, state)
                    continue
                if isinstance(st, (ast.With, ast.AsyncWith)):
                    for item in st.items:
                        expr(item.context_expr, state)
                    block(st.body, state)
                    continue
                if isinstance(st, ast.Try):
                    block(st.body, state)
                    for h in st.handlers:
                        block(h.body, dict(state))
                    block(st.orelse, state)
                    block(st.finalbody, state)
                    continue
                if isinstance(st, ast.Assign) and len(st.targets) == 1 \
                        and isinstance(st.targets[0], ast.Name):
                    v = st.value
                    vals = [v.body, v.orelse] if isinstance(v, ast.IfExp) \
                        else [v]
                    chains = [_attr_chain(x) for x in vals]
                    if all(c and len(c) >= 2 and self._device_field_attr(c)
                           for c in chains):
                        bound.add(st.targets[0].id)
                for child in ast.iter_child_nodes(st):
                    if isinstance(child, ast.expr):
                        expr(child, state)

        body = fn.body if not isinstance(fn, ast.Lambda) else []
        block(body, {"clock": False, "pending": None})

    # ------------------------------------------------ donation (GL006)

    def _jit_donated(self, m: _Module, call: ast.Call) -> list[int]:
        """Donated positional indices from a ``jax.jit(...)`` call node
        (``donate_argnums`` int or tuple/list of ints; ``donate_argnames``
        is not resolvable at the call site and is skipped)."""
        out: list[int] = []
        for kw in call.keywords:
            if kw.arg == "donate_argnums":
                v = kw.value
                if isinstance(v, ast.Constant) and isinstance(v.value, int):
                    out.append(v.value)
                elif isinstance(v, (ast.Tuple, ast.List)):
                    out.extend(e.value for e in v.elts
                               if isinstance(e, ast.Constant)
                               and isinstance(e.value, int))
        return out

    def _donation_from_value(self, m: _Module, node: ast.AST):
        """Donated positions if ``node`` evaluates to a donation-jitted
        callable: ``jax.jit(fn, donate_argnums=...)`` or
        ``partial(jax.jit, donate_argnums=...)``."""
        if not isinstance(node, ast.Call):
            return None
        if self._is_jax_jit(m, node.func):
            nums = self._jit_donated(m, node)
            return nums or None
        chain = _attr_chain(node.func)
        if (chain and chain[-1] == "partial" and node.args
                and self._is_jax_jit(m, node.args[0])):
            nums = self._jit_donated(m, node)
            return nums or None
        return None

    def _decorated_donation(self, m: _Module, fn) -> list[int]:
        """Donated positions from a def's ``@jax.jit(donate_argnums=...)``
        (or partial-form) decorator; empty when not donation-decorated."""
        for dec in fn.decorator_list:
            if isinstance(dec, ast.Call):
                nums = None
                if self._is_jax_jit(m, dec.func):
                    nums = self._jit_donated(m, dec)
                elif (dec.args and self._is_jax_jit(m, dec.args[0])):
                    nums = self._jit_donated(m, dec)  # partial form
                if nums:
                    return nums
        return []

    def _module_donations(self, m: _Module) -> dict:
        """name -> donated positions, for MODULE-LEVEL bindings only:
        assigned ``jax.jit(..., donate_argnums=...)`` results and
        decorated defs in ``m.tree.body``. Nested defs are scoped to
        their defining function by :class:`_DonationLint` instead — a
        module-wide bare-name registry falsely flagged unrelated
        same-named locals in other functions."""
        donated: dict = {}
        for node in m.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                nums = self._donation_from_value(m, node.value)
                if nums:
                    donated[node.targets[0].id] = nums
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                nums = self._decorated_donation(m, node)
                if nums:
                    donated[node.name] = nums
        return donated

    @staticmethod
    def _traced_params(fn: ast.FunctionDef, statics, nums) -> set:
        pos = [a.arg for a in fn.args.posonlyargs + fn.args.args]
        static = set(statics) | {pos[i] for i in nums if i < len(pos)}
        params = pos + [a.arg for a in fn.args.kwonlyargs]
        return {p for p in params
                if p not in static and p not in ("self", "cls")}

    def _suppressed(self, m: _Module, line: int, rule: str) -> bool:
        return suppressed(m.lines, line, rule)

    def _emit(self, m: _Module, node: ast.AST, rule: str, detail: str,
              via: str) -> None:
        line = getattr(node, "lineno", 0)
        if self._suppressed(m, line, rule):
            return
        summary, hint = RULES[rule]
        if m.is_torch:
            summary, hint = TORCH_RULES[rule], _TORCH_HINTS[rule]
        f = Finding(m.path, line, rule, f"{summary}: {detail} [{via}]",
                    hint=hint)
        if f not in self.findings:
            self.findings.append(f)

    def _lint_function(self, m: _Module, fn: ast.FunctionDef, traced: set,
                       via: str, expand: bool) -> None:
        key = (m.path, fn.lineno, frozenset(traced))
        if key in self._visited:
            return
        self._visited.add(key)
        _FunctionLint(self, m, traced, via, expand).run(fn)

    # ------------------------------------------------- callee expansion

    def _is_pallas_call(self, m: _Module, call: ast.Call) -> bool:
        if (isinstance(call.func, ast.Name)
                and call.func.id in m.pallas_call_names):
            return True  # from jax.experimental.pallas import pallas_call
        chain = _attr_chain(call.func)
        if chain is None or chain[-1] != "pallas_call":
            return False
        # pl.pallas_call under any alias, or the fully-dotted
        # jax.experimental.pallas.pallas_call spelling (whose root "jax"
        # is deliberately NOT a pallas alias — see _collect_imports).
        return (chain[0] in m.pallas_aliases
                or chain[:3] == ("jax", "experimental", "pallas"))

    @staticmethod
    def _kernel_name_node(node: ast.AST):
        """The kernel-function Name of a pallas_call first argument —
        unwrapping ``functools.partial(kernel, ...)`` under any partial
        spelling."""
        if isinstance(node, ast.Call):
            chain = _attr_chain(node.func)
            if chain and chain[-1] == "partial" and node.args:
                return JitLinter._kernel_name_node(node.args[0])
            return None
        return node if isinstance(node, ast.Name) else None

    def expand_pallas_kernel(self, m: _Module, call: ast.Call,
                             via: str) -> None:
        """Lint the kernel function of a ``pl.pallas_call(kernel, ...)``
        site with every parameter traced (refs ARE traced values; the
        ints a partial() binds are harmless to overapproximate)."""
        if not call.args:
            return
        name = self._kernel_name_node(call.args[0])
        if name is None:
            return
        target = self._resolve_callee(m, name)
        if target is None:
            return
        kernel_module, kernel = target
        params = [a.arg for a in (kernel.args.posonlyargs + kernel.args.args
                                  + kernel.args.kwonlyargs)]
        traced = {p for p in params if p not in ("self", "cls")}
        self._lint_function(
            kernel_module, kernel, traced,
            via=f"{via} -> pallas kernel {kernel.name!r}", expand=False,
        )

    def expand_call(self, m: _Module, call: ast.Call, traced_args: list,
                    via: str) -> None:
        """Lint a called local/sibling-module function one level deep.

        ``traced_args`` is ``[(argname_or_None, is_traced), ...]`` in call
        order (None argname = positional).
        """
        if m.is_torch:
            # Same-module callees only; scopes are linted on their own.
            if not isinstance(call.func, ast.Name):
                return
            target = self._lookup(m, call.func.id,
                                  self._enclosing_function(m, call))
            if target is None or target[0] is not m \
                    or not self._expandable(target[1]) \
                    or id(target[1]) in self.scopes_of(m):
                return
        else:
            target = self._resolve_callee(m, call.func)
        if target is None:
            return
        callee_module, callee = target
        jitted, _s, _n = self._jit_decoration(callee_module, callee)
        if jitted or callee.name in callee_module.jit_called:
            return  # linted in its own right
        pos = [a.arg for a in callee.args.posonlyargs + callee.args.args]
        if pos and pos[0] in ("self", "cls"):
            return
        tensor_params = self._torch_params(callee) if m.is_torch else None
        traced: set = set()
        i = 0
        for argname, is_traced in traced_args:
            if argname is None:
                if i < len(pos) and is_traced:
                    traced.add(pos[i])
                i += 1
            elif is_traced:
                traced.add(argname)
        if tensor_params is not None:
            traced &= tensor_params
        if not traced:
            return
        self._lint_function(
            callee_module, callee, traced,
            via=f"{via} -> {callee.name!r}", expand=False,
        )

    def _resolve_callee(self, m: _Module, func: ast.AST):
        if isinstance(func, ast.Name):
            if func.id in m.from_functions:
                path, name = m.from_functions[func.id]
                mod = self.load(path)
                if mod is None:
                    return None
                fn = mod.functions.get(name)
                return (mod, fn) if fn is not None else None
            fn = m.functions.get(func.id)
            return (m, fn) if fn is not None else None
        chain = _attr_chain(func)
        if chain and len(chain) == 2 and chain[0] in m.module_aliases:
            mod = self.load(m.module_aliases[chain[0]])
            if mod is None:
                return None
            fn = mod.functions.get(chain[1])
            return (mod, fn) if fn is not None else None
        return None


class _FunctionLint:
    """One pass over a single function body, statement order, tracking
    which locals hold traced values (tensors, in a torch module)."""

    def __init__(self, linter: JitLinter, m: _Module, traced: set,
                 via: str, expand: bool):
        self.linter = linter
        self.m = m
        self.tr = set(traced)
        self.via = via
        self.expand = expand
        self.shadowed: set = set()
        self.torch = m.is_torch

    def run(self, fn) -> None:
        self.shadowed = _scope_bound_names(fn)
        if isinstance(fn, ast.Lambda):
            self._expr(fn.body)
            return
        for stmt in fn.body:
            self._stmt(stmt)

    # ------------------------------------------------------- statements

    def _test(self, node, test, kind: str) -> None:
        refs = self._concrete_refs(test)
        if refs:
            self.linter._emit(
                self.m, node, "GL002",
                f"`{kind}` tests traced value(s) "
                f"{', '.join(sorted(refs))}", self.via)
        self._expr(test, test_root=test if self.torch else None)

    def _stmt(self, node: ast.stmt) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # nested defs are linted on their own if jitted
        if isinstance(node, (ast.If, ast.While)):
            self._test(node, node.test,
                       "if" if isinstance(node, ast.If) else "while")
            for s in node.body:
                self._stmt(s)
            for s in getattr(node, "orelse", []):
                self._stmt(s)
            return
        if self.torch and isinstance(node, ast.Assert):
            self._test(node, node.test, "assert")
            return
        if isinstance(node, ast.For):
            self._expr(node.iter)
            if self.torch and isinstance(node.target, ast.Name) \
                    and self._concrete_refs(node.iter):
                self._mark_traced(node.target)
            for s in node.body + node.orelse:
                self._stmt(s)
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                self._expr(item.context_expr)
            for s in node.body:
                self._stmt(s)
            return
        if isinstance(node, ast.Try):
            for s in node.body + node.orelse + node.finalbody:
                self._stmt(s)
            for h in node.handlers:
                for s in h.body:
                    self._stmt(s)
            return
        if isinstance(node, ast.Assign):
            self._expr(node.value)
            if self._concrete_refs(node.value):
                for tgt in node.targets:
                    self._mark_traced(tgt)
            return
        if isinstance(node, ast.AugAssign):
            self._expr(node.value)
            if self._concrete_refs(node.value):
                self._mark_traced(node.target)
            return
        if isinstance(node, ast.AnnAssign):
            if node.value is not None:
                self._expr(node.value)
                if self._concrete_refs(node.value):
                    self._mark_traced(node.target)
            return
        if isinstance(node, (ast.Return, ast.Expr)) and node.value is not None:
            self._expr(node.value)
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self._expr(child)
            elif isinstance(child, ast.stmt):
                self._stmt(child)

    def _mark_traced(self, target: ast.AST) -> None:
        if isinstance(target, ast.Name):
            self.tr.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._mark_traced(elt)

    # ------------------------------------------------------ expressions

    def _expr(self, node: ast.expr, test_root=None) -> None:
        # The nodes a statement's test already answered for (its BoolOps
        # and `not`s): their bool() is the statement's finding.
        tested: set = set()
        stack = [test_root] if test_root is not None else []
        while stack:
            t = stack.pop()
            tested.add(id(t))
            if isinstance(t, ast.BoolOp):
                stack.extend(t.values)
            elif isinstance(t, ast.UnaryOp) and isinstance(t.op, ast.Not):
                stack.append(t.operand)
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                self._call(sub)
            elif not self.torch:
                continue
            elif isinstance(sub, ast.IfExp) and id(sub) not in tested:
                refs = self._concrete_refs(sub.test)
                if refs:
                    self.linter._emit(
                        self.m, sub, "GL002",
                        f"ternary tests traced value(s) "
                        f"{', '.join(sorted(refs))}", self.via)
            elif isinstance(sub, ast.BoolOp) and id(sub) not in tested:
                refs = set().union(*(self._concrete_refs(v)
                                     for v in sub.values[:-1]))
                if refs:
                    op = "and" if isinstance(sub.op, ast.And) else "or"
                    self.linter._emit(
                        self.m, sub, "GL002",
                        f"`{op}` tests traced value(s) "
                        f"{', '.join(sorted(refs))}", self.via)
            elif isinstance(sub, ast.Subscript) \
                    and isinstance(sub.ctx, ast.Load) \
                    and self._is_mask(sub.slice) \
                    and self._concrete_refs(sub.value):
                self.linter._emit(
                    self.m, sub, "GL003",
                    f"boolean-mask index {_unparse(sub.slice)!r} of traced "
                    f"{', '.join(sorted(self._concrete_refs(sub.value)))} "
                    "reads its size back", self.via)

    def _is_mask(self, node: ast.AST) -> bool:
        """A boolean-mask index: a comparison, ``~``/``&``/``|``/``^`` of
        masks, or a name or attribute named like one (``valid``,
        ``mask``, ``keep``, ``live``, ``ok``), traced."""
        if isinstance(node, ast.Tuple):
            return any(self._is_mask(e) for e in node.elts)
        if isinstance(node, ast.Compare):
            return bool(self._concrete_refs(node))
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
            return self._is_mask(node.operand)
        if isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
            return self._is_mask(node.left) or self._is_mask(node.right)
        name = node.id if isinstance(node, ast.Name) else (
            node.attr if isinstance(node, ast.Attribute) else None)
        return (name is not None and _MASK_NAMES.search(name) is not None
                and bool(self._concrete_refs(node)))

    def _call(self, call: ast.Call) -> None:
        if self.torch:
            self._call_torch(call)
            return
        m, via = self.m, self.via
        chain = _attr_chain(call.func)
        arg_exprs = list(call.args) + [kw.value for kw in call.keywords]

        # GL007 — host clocks: flagged regardless of arguments (the call
        # itself is the hazard; it runs once at trace time). A root name
        # bound in THIS function's scope (parameter, local, local import)
        # shadows the module-level clock import and is never flagged.
        if chain and chain[0] not in self.shadowed:
            clock = None
            if len(chain) == 1 and chain[0] in m.clock_names:
                clock = chain[0]
            elif (len(chain) >= 2 and chain[0] in m.time_aliases
                    and chain[-1] in _TIME_CLOCK_FNS):
                clock = ".".join(chain)
            elif (len(chain) >= 2 and chain[0] in m.datetime_aliases
                    and chain[-1] in _DATETIME_CLOCK_FNS):
                clock = ".".join(chain)
            if clock is not None:
                self.linter._emit(
                    m, call, "GL007",
                    f"{clock}() executes at trace time, not per step", via)

        if chain and chain[0] in m.numpy_aliases:
            traced = sorted(set().union(
                *(self._concrete_refs(a) for a in arg_exprs), set()))
            if traced:
                self.linter._emit(
                    m, call, "GL001",
                    f"np.{'.'.join(chain[1:])} applied to traced "
                    f"{', '.join(traced)}", via)

        is_jnp = chain is not None and (
            chain[0] in m.jnp_aliases
            or (len(chain) > 2 and chain[0] in m.jax_aliases
                and chain[1] == "numpy"))
        if is_jnp:
            name = chain[-1]
            if name in _STACKERS:
                for sub in ast.walk(call):
                    if (isinstance(sub, ast.Call)
                            and isinstance(sub.func, ast.Attribute)
                            and sub.func.attr in ("values", "keys", "items")
                            and not sub.args):
                        self.linter._emit(
                            m, call, "GL004",
                            f"jnp.{name} consumes dict .{sub.func.attr}() "
                            "iteration", via)
                        break
            if name in _DTYPE_SENSITIVE:
                dtype_pos = _DTYPE_SENSITIVE[name]
                has_dtype = len(call.args) > dtype_pos or any(
                    kw.arg == "dtype" for kw in call.keywords)
                if not has_dtype:
                    lit = next(
                        (a for a in call.args
                         if isinstance(a, ast.Constant)
                         and isinstance(a.value, float)), None)
                    if lit is not None:
                        self.linter._emit(
                            m, call, "GL005",
                            f"jnp.{name}(... {lit.value} ...) without "
                            "dtype=", via)

        if (isinstance(call.func, ast.Name) and call.func.id in _COERCERS
                and call.args):
            refs = self._concrete_refs(call.args[0])
            if refs:
                self.linter._emit(
                    m, call, "GL003",
                    f"{call.func.id}() applied to traced "
                    f"{', '.join(sorted(refs))}", via)
        if (isinstance(call.func, ast.Attribute)
                and call.func.attr in _SYNC_METHODS):
            refs = self._concrete_refs(call.func.value)
            if refs:
                self.linter._emit(
                    m, call, "GL003",
                    f".{call.func.attr}() applied to traced "
                    f"{', '.join(sorted(refs))}", via)

        if self.expand and chain is not None and len(chain) <= 2:
            traced_args = [(None, bool(self._concrete_refs(a)))
                           for a in call.args]
            traced_args += [(kw.arg, bool(self._concrete_refs(kw.value)))
                            for kw in call.keywords if kw.arg]
            self.linter.expand_call(m, call, traced_args, via)

    def _call_torch(self, call: ast.Call) -> None:
        m, via = self.m, self.via
        chain = _attr_chain(call.func)
        arg_exprs = list(call.args) + [kw.value for kw in call.keywords]
        arg_refs = sorted(set().union(
            *(self._concrete_refs(a) for a in arg_exprs), set()))

        clock = self.linter._is_clock(m, call, self.shadowed)
        if clock is not None:
            self.linter._emit(
                m, call, "GL007",
                f"{clock}() inside a device scope times the host, not the "
                "device work", via)

        # GL001: host numpy on a tensor.
        if chain and arg_refs and (chain[0] in m.numpy_aliases
                                   or chain[-1] == "to_numpy"):
            name = ("np." + ".".join(chain[1:])
                    if chain[0] in m.numpy_aliases else ".".join(chain))
            self.linter._emit(
                m, call, "GL001",
                f"{name} applied to traced {', '.join(arg_refs)}", via)

        is_torch_fn = chain is not None and len(chain) >= 2 \
            and chain[0] in m.torch_aliases
        name = chain[-1] if chain else None
        # GL004: dict order into a stacked tensor.
        if (is_torch_fn and name in _TORCH_STACKERS) or name == "_stack_tree":
            for sub in _unsorted_nodes(call):
                if (isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Attribute)
                        and sub.func.attr in ("values", "keys", "items")
                        and not sub.args):
                    self.linter._emit(
                        m, call, "GL004",
                        f"{'.'.join(chain)} consumes dict "
                        f".{sub.func.attr}() iteration", via)
                    break
        # GL005: a float literal without dtype=.
        if is_torch_fn and name in _TORCH_DTYPE_SENSITIVE:
            pos = _TORCH_DTYPE_SENSITIVE[name]
            has_dtype = (pos is not None and len(call.args) > pos) or any(
                kw.arg == "dtype" for kw in call.keywords)
            if not has_dtype:
                lit = next((v for v in _float_literals(call.args)), None)
                if lit is not None:
                    self.linter._emit(
                        m, call, "GL005",
                        f"torch.{name}(... {lit} ...) without dtype=", via)
        # GL003: syncs that do not go through host_sync.
        if (isinstance(call.func, ast.Name) and call.func.id in _COERCERS
                and call.args):
            refs = self._concrete_refs(call.args[0])
            if refs:
                self.linter._emit(
                    m, call, "GL003",
                    f"{call.func.id}() applied to traced "
                    f"{', '.join(sorted(refs))}", via)
        if isinstance(call.func, ast.Attribute):
            attr = call.func.attr
            recv = self._concrete_refs(call.func.value)
            if attr in _TORCH_SYNC_METHODS and recv:
                self.linter._emit(
                    m, call, "GL003",
                    f".{attr}() applied to traced "
                    f"{', '.join(sorted(recv))}", via)
            data_dep = attr in _TORCH_DATA_DEPENDENT or (
                attr == "repeat_interleave"
                and not any(kw.arg == "output_size"
                            for kw in call.keywords)) or (
                is_torch_fn and attr == "where" and len(call.args) == 1
                and not call.keywords)
            refs = arg_refs if is_torch_fn else sorted(recv)
            if data_dep and refs:
                self.linter._emit(
                    m, call, "GL003",
                    f"{'.'.join(chain) if chain else attr}() has a "
                    f"data-dependent shape on traced {', '.join(refs)}",
                    via)

        if self.expand and isinstance(call.func, ast.Name):
            traced_args = [(None, bool(self._concrete_refs(a)))
                           for a in call.args]
            traced_args += [(kw.arg, bool(self._concrete_refs(kw.value)))
                            for kw in call.keywords if kw.arg]
            self.linter.expand_call(m, call, traced_args, via)

    # ------------------------------------------------------- trace-ness

    def _concrete_refs(self, node: ast.expr) -> set:
        """Traced names an expression uses CONCRETELY (i.e. in a way that
        needs a concrete value or produces a traced one), ignoring
        shape/dtype reads, len(), isinstance(), and `is None` tests."""
        if self.torch:
            return self._tensor_refs(node)
        if isinstance(node, ast.Name):
            return {node.id} if node.id in self.tr else set()
        if isinstance(node, ast.Attribute):
            if node.attr in _STATIC_ATTRS:
                return set()
            return self._concrete_refs(node.value)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return set()
        if isinstance(node, ast.Call):
            if (isinstance(node.func, ast.Name)
                    and node.func.id in _STATIC_CALLS):
                return set()
            chain = _attr_chain(node.func)
            if chain is not None and chain[0] in self.m.pallas_aliases:
                if chain[-1] not in _PALLAS_TRACED_CALLS:
                    # pl.ds / pl.cdiv / pl.BlockSpec / pltpu.VMEM ... —
                    # grid and meta plumbing, concrete at trace time.
                    return set()
                # program_id / load / pallas_call yield traced values
                # even with no traced-name operands: surface a pseudo-ref
                # so `if pl.program_id(0) == 0:` still flags GL002 (the
                # fix is pl.when) and assignments from them mark their
                # targets traced.
                return {f"{chain[0]}.{chain[-1]}(...)"}
        out: set = set()
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                out |= self._concrete_refs(child)
            elif isinstance(child, ast.comprehension):
                out |= self._concrete_refs(child.iter)
        return out

    def _host_result(self, call: ast.Call) -> bool:
        """A call whose result is a host value: a def (this module's, or
        a module alias's) annotated to return host types, or a method of
        an object that is no tensor (``lib.launch(...)``) called with no
        tensor argument."""
        func = call.func
        target = None
        if isinstance(func, ast.Name):
            target = self.linter._lookup(
                self.m, func.id, self.linter._enclosing_function(self.m,
                                                                 call))
        else:
            chain = _attr_chain(func)
            if chain and len(chain) == 2 \
                    and chain[0] in self.m.module_aliases:
                mod = self.linter.load(self.m.module_aliases[chain[0]])
                fn = mod.functions.get(chain[1]) if mod is not None \
                    else None
                target = (mod, fn) if fn is not None else None
            elif isinstance(func, ast.Attribute) \
                    and not self._tensor_refs(func.value):
                return not any(self._tensor_refs(a) for a in call.args) \
                    and not any(self._tensor_refs(k.value)
                                for k in call.keywords)
        return target is not None and _returns_host(target[1])

    def _tensor_refs(self, node: ast.expr) -> set:
        """The torch form of :meth:`_concrete_refs`: tensor names an
        expression reads as a device value. Host results (the sync
        helpers', ``.item()``'s, coercions, numpy calls, shape reads) are
        concrete; a ``torch.*`` call is a tensor even with no tensor
        operand."""
        if isinstance(node, ast.Name):
            return {node.id} if node.id in self.tr else set()
        if isinstance(node, ast.Attribute):
            if node.attr in _TORCH_STATIC_ATTRS:
                return set()
            return self._tensor_refs(node.value)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return set()
        if isinstance(node, ast.Lambda):
            return set()
        if isinstance(node, ast.Call):
            chain = _attr_chain(node.func)
            fname = chain[-1] if chain else None
            if isinstance(node.func, ast.Name) and (
                    node.func.id in _STATIC_CALLS
                    or node.func.id in _COERCERS):
                return set()
            if fname in SYNC_HELPERS or fname == "to_numpy" or (
                    chain and chain[0] in self.m.numpy_aliases):
                return set()
            if isinstance(node.func, ast.Attribute) and (
                    node.func.attr in _TORCH_STATIC_METHODS
                    or node.func.attr in _TORCH_SYNC_METHODS):
                return set()
            if chain and len(chain) >= 2 and chain[0] in self.m.torch_aliases:
                if chain[1] in _TORCH_HOST_NAMESPACES:
                    return set()
                return {f"torch.{'.'.join(chain[1:])}(...)"}
            if self._host_result(node):
                return set()
        out: set = set()
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                out |= self._tensor_refs(child)
            # A comprehension's iteration over a container of tensors
            # reads none of them: only its element expression counts.
        return out


def _unsorted_nodes(node: ast.AST):
    """ast.walk that does not enter ``sorted(...)``: an explicit order."""
    stack = [node]
    while stack:
        cur = stack.pop()
        if isinstance(cur, ast.Call) and isinstance(cur.func, ast.Name) \
                and cur.func.id == "sorted":
            continue
        yield cur
        stack.extend(ast.iter_child_nodes(cur))


def _returns_host(fn) -> bool:
    """A def whose return annotation names host types only."""
    ann = getattr(fn, "returns", None)
    if ann is None:
        return False
    toks = set(re.findall(r"[A-Za-z_]\w*", _unparse(ann)))
    return bool(toks) and toks <= _HOST_ANNOTATIONS


def _float_literals(args):
    """Float literals among ``args`` (and inside list/tuple literals),
    as written."""
    for a in args:
        if isinstance(a, ast.Constant) and isinstance(a.value, float):
            yield a.value
        elif isinstance(a, ast.UnaryOp) and isinstance(a.op, ast.USub) \
                and isinstance(a.operand, ast.Constant) \
                and isinstance(a.operand.value, float):
            yield -a.operand.value
        elif isinstance(a, (ast.List, ast.Tuple)):
            yield from _float_literals(a.elts)


class _DonationLint:
    """GL006: donated-argument use-after-free, one function at a time.

    Tracks, in statement order, names passed in a donated position of a
    donation-jitted callable. The idiomatic ``state = f(state, x)``
    (rebinding the name in the same statement) is safe; reading the name
    afterwards is flagged. Loop bodies are walked TWICE (a simulated
    second iteration) so back-edge hazards fall out of the same rule: a
    name donated in the body is flagged only if the next iteration reads
    it before a rebind — a rebind later in the body, or by the ``for``
    target itself, stays clean. Branches of an ``if``/``try`` are
    scanned with independent poison sets (they are exclusive at runtime)
    and re-merged after. Conservative: only plain ``Name`` arguments at
    statically-resolvable donated positions are tracked, so a miss is
    possible but a finding is real.
    """

    def __init__(self, linter: JitLinter, m: _Module, donated: dict):
        self.linter = linter
        self.m = m
        self.module_donated = donated
        self._emitted: set = set()  # (lineno, name): second-pass dedup
        self.torch = m.is_torch
        if self.torch:
            # In a torch module the tracked names are dotted too
            # (`batch.state`): an in-place entry updates the object.
            self._target_names = _dotted_targets
            self._reads = _dotted_reads

    def run(self, fn) -> None:
        donated = dict(self.module_donated)
        # Parameters shadow module-level donation bindings for this
        # scope: `def g(step, ...)` makes `step` an unknown callable
        # here, whatever a module-level `step` was jitted with.
        a = fn.args
        for arg in (a.posonlyargs + a.args + a.kwonlyargs
                    + ([a.vararg] if a.vararg else [])
                    + ([a.kwarg] if a.kwarg else [])):
            donated.pop(arg.arg, None)
        self._walk(fn.body, donated, {}, fname=fn.name)

    # ------------------------------------------------------------------

    @staticmethod
    def _target_names(node: ast.AST) -> set:
        out: set = set()
        if isinstance(node, ast.Name):
            out.add(node.id)
        elif isinstance(node, (ast.Tuple, ast.List)):
            for e in node.elts:
                out |= _DonationLint._target_names(e)
        elif isinstance(node, ast.Starred):
            out |= _DonationLint._target_names(node.value)
        return out

    @staticmethod
    def _walk_same_scope(node: ast.AST):
        """ast.walk that does NOT descend into nested scopes (lambdas,
        defs, classes) — a donating call inside a deferred closure does
        not execute at this statement, so it must not poison the
        enclosing scope (mirrors the scope rule in :meth:`_reads`)."""
        stack = [node]
        while stack:
            cur = stack.pop()
            yield cur
            for child in ast.iter_child_nodes(cur):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.Lambda, ast.ClassDef)):
                    continue
                stack.append(child)

    def _donating_args(self, stmt: ast.stmt, donated: dict):
        """[(call node, arg Name id), ...] for donated positions filled
        with plain names anywhere in the statement (same-scope only)."""
        out = []
        for node in self._walk_same_scope(stmt):
            if self.torch and isinstance(node, ast.Call):
                nums = self.linter._in_place_call(self.m, node, donated)
                for i in nums or ():
                    if i < len(node.args) and isinstance(
                            node.args[i], (ast.Name, ast.Attribute)):
                        key = _unparse(node.args[i])
                        if _attr_chain(node.args[i]) is not None:
                            out.append((node, key))
                continue
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
                nums = donated.get(node.func.id)
                if not nums:
                    continue
                for i in nums:
                    if i < len(node.args) and isinstance(node.args[i],
                                                         ast.Name):
                        out.append((node, node.args[i].id))
        return out

    @staticmethod
    def _reads(stmt: ast.stmt) -> set:
        """Names read at THIS statement's execution time. Nested scopes
        (lambdas, defs, classes) are pruned: a closure body runs later,
        possibly after the donated name is rebound, so counting its reads
        would break the "a finding is real" guarantee."""
        reads: set = set()
        for node in _DonationLint._walk_same_scope(stmt):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
                reads.add(node.id)
        return reads

    def _emit(self, node: ast.AST, name: str, detail: str, fname: str):
        key = (getattr(node, "lineno", 0), name)
        if key in self._emitted:
            return  # the simulated second loop iteration repeats reads
        self._emitted.add(key)
        self.linter._emit(
            self.m, node, "GL006", f"{name!r} {detail}",
            via=f"donating call in {fname!r}",
        )

    def _walk(self, stmts, donated: dict, poisoned: dict,
              fname: str) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                # A local def/class BINDS its name in this scope: it
                # shadows any outer donation binding (an unrelated local
                # callable must not inherit module-level donation), and a
                # donation-decorated local def becomes trackable from
                # here on. Its body is a nested scope — never walked.
                donated.pop(stmt.name, None)
                poisoned.pop(stmt.name, None)
                if not isinstance(stmt, ast.ClassDef):
                    nums = self.linter._decorated_donation(self.m, stmt)
                    if nums:
                        donated[stmt.name] = nums
                continue
            if isinstance(stmt, ast.If):
                self._stmt(stmt, donated, poisoned, fname,
                           reads_only=True)
                merged: dict = {}
                for branch in (stmt.body, stmt.orelse):
                    p = dict(poisoned)
                    self._walk(branch, donated, p, fname)
                    if self.torch and branch and isinstance(
                            branch[-1], (ast.Return, ast.Raise)):
                        continue  # the branch leaves: nothing flows on
                    merged.update(p)
                poisoned.clear()
                poisoned.update(merged)
                continue
            if isinstance(stmt, (ast.For, ast.While)):
                self._stmt(stmt, donated, poisoned, fname,
                           reads_only=True)
                # Two symbolic iterations: the second pass carries the
                # first's poison over the back edge, so "donated in a
                # loop and read by the next iteration" is just the
                # ordinary read-after-donation rule — and a rebind later
                # in the body (or by the for target) clears it.
                for it in (0, 1):
                    if isinstance(stmt, ast.For):
                        for nm in self._target_names(stmt.target):
                            poisoned.pop(nm, None)
                            donated.pop(nm, None)  # target shadows
                    elif it:  # while TEST is re-evaluated per iteration
                        self._stmt(stmt, donated, poisoned, fname,
                                   reads_only=True)
                    self._walk(stmt.body, donated, poisoned, fname)
                self._walk(stmt.orelse, donated, poisoned, fname)
                continue
            if isinstance(stmt, ast.Try):
                merged = {}
                for branch in ([stmt.body + stmt.orelse]
                               + [h.body for h in stmt.handlers]):
                    p = dict(poisoned)
                    self._walk(branch, donated, p, fname)
                    merged.update(p)
                poisoned.clear()
                poisoned.update(merged)
                self._walk(stmt.finalbody, donated, poisoned, fname)
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                self._stmt(stmt, donated, poisoned, fname,
                           reads_only=True)
                for item in stmt.items:  # `as name` binds/shadows
                    if item.optional_vars is not None:
                        for nm in self._target_names(item.optional_vars):
                            poisoned.pop(nm, None)
                            donated.pop(nm, None)
                self._walk(stmt.body, donated, poisoned, fname)
                continue
            self._stmt(stmt, donated, poisoned, fname)

    def _stmt(self, stmt, donated: dict, poisoned: dict,
              fname: str, reads_only: bool = False) -> None:
        # 1. Reads of already-poisoned names — the use-after-free.
        check = stmt if not reads_only else getattr(
            stmt, "test", None) or getattr(stmt, "iter", None) or stmt
        if reads_only and isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                for nm in self._reads(item.context_expr) & set(poisoned):
                    self._emit(item.context_expr, nm,
                               "read after being donated", fname)
            return
        for nm in self._reads(check) & set(poisoned):
            self._emit(check, nm, "read after being donated", fname)
            poisoned.pop(nm, None)  # one finding per donation site
        if reads_only:
            return
        # 2. Rebinds clear poison (and define the safe idiom below).
        rebound: set = set()
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                rebound |= self._target_names(t)
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            rebound |= self._target_names(stmt.target)
        elif isinstance(stmt, ast.Delete):
            for t in stmt.targets:
                for nm in self._target_names(t):
                    poisoned.pop(nm, None)
        for nm in rebound:
            poisoned.pop(nm, None)
        # 3. New poisons from donating calls in this statement. Loop
        # hazards need no special case: the back-edge pass in _walk
        # re-reads the body with this poison still set.
        for call, nm in self._donating_args(stmt, donated):
            if nm in rebound:
                continue  # state = f(state, ...) — the safe idiom
            poisoned[nm] = call.lineno
        # 4. Local donation bindings and aliases. ANY rebind first clears
        # the name from the donated map (after step 3, which reads the
        # pre-assignment mapping — the RHS evaluates before the bind): a
        # plain `step = lambda a, b: a` shadowing a module-level donated
        # `step` must not keep poisoning its callers' arguments. A
        # donation value or an alias of a donated name then re-adds it.
        for nm in rebound:
            donated.pop(nm, None)
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name):
            tgt = stmt.targets[0].id
            if self.torch:
                vals = [stmt.value.body, stmt.value.orelse] \
                    if isinstance(stmt.value, ast.IfExp) else [stmt.value]
                if all(self.linter._in_place_attr(self.m, v) for v in vals):
                    donated[tgt] = (0,)
                return
            nums = self.linter._donation_from_value(self.m, stmt.value)
            if nums:
                donated[tgt] = nums
            elif isinstance(stmt.value, ast.Name) \
                    and stmt.value.id in donated:
                donated[tgt] = donated[stmt.value.id]


def _dotted_targets(node: ast.AST) -> set:
    """Assignment targets as names and dotted chains (``batch.state``)."""
    out: set = set()
    if isinstance(node, (ast.Name, ast.Attribute)):
        if _attr_chain(node) is not None:
            out.add(_unparse(node))
    elif isinstance(node, (ast.Tuple, ast.List)):
        for e in node.elts:
            out |= _dotted_targets(e)
    elif isinstance(node, ast.Starred):
        out |= _dotted_targets(node.value)
    return out


def _dotted_reads(stmt: ast.AST) -> set:
    """Names and dotted chains a statement reads (same scope only)."""
    reads: set = set()
    for node in _DonationLint._walk_same_scope(stmt):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            reads.add(node.id)
        elif isinstance(node, ast.Attribute) \
                and isinstance(node.ctx, ast.Load) \
                and _attr_chain(node) is not None:
            reads.add(_unparse(node))
    return reads


def device_scopes(package_root: str, paths, cache=None) -> dict:
    """``{path: [(first line, last line, name)]}`` of the device scopes
    of the torch modules under ``paths`` (see :class:`JitLinter`)."""
    return JitLinter(package_root, cache=cache).device_scopes(paths)


def lint_paths(package_root: str, paths, cache=None) -> list[Finding]:
    """Convenience wrapper: lint ``paths`` with a fresh :class:`JitLinter`
    rooted at ``package_root`` (the directory containing the package),
    optionally sharing a parsed
    :class:`~gelly_torch.analysis.loader.SourceCache`."""
    return JitLinter(package_root, cache=cache).lint_paths(paths)
