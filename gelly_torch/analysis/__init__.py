"""Repo-specific static analysis of the port, ``gelly_torch``.

The port re-owns the runtime that ``gelly_tpu`` built for the TPU: a
ctypes-bound C++ host layer (``native/*.cc`` + ``utils/native.py``),
hand-written CUDA kernels bound the same way (``csrc/*.cu`` +
``ops/_build.SIGNATURES``), and a threaded engine (codec workers, H2D
threads, checkpoint writers, lease beats, ingest servers). Each fails
silently: an ``argtypes`` declaration drifting from its ``extern "C"``
signature corrupts memory instead of raising, a lock missed on a
shared attribute races without failing a test, and a host sync or an
unsynchronized timing in a plan's fold passes the CPU tests and only
shows on the card. This package is the correctness floor under all
three, with ``gelly_tpu``'s tool and rule ids and no JAX import:

- :mod:`gelly_torch.analysis.abi` — every ``extern "C"`` declaration in
  ``native/*.cc`` against ``utils/native.py``'s bindings, and in
  ``csrc/*.cu`` against ``ops/_build.SIGNATURES`` (``AB0xx``);
- :mod:`gelly_torch.analysis.jitlint` — hazards inside ``jax.jit``
  functions (a JAX module) or inside the port's device scopes (host
  syncs outside ``host_sync``, Python branches on tensors, in-place plan
  entries, unsynchronized host timings) (``GL0xx``);
- :mod:`gelly_torch.analysis.plancheck` — plan-cache keys, donation and
  in-place aliasing, masked-lane selects and the refusal matrix
  (``PCxxx``);
- :mod:`gelly_torch.analysis.racecheck` — thread roots, shared-attribute
  and lock-discipline rules (``RC0xx``), lock-order cycles, and the
  protocol invariants of ``engine/coordination.py`` (``PI0xx``);
- :mod:`gelly_torch.analysis.contracts` — exactly-once/durability
  (``EO0xx``), wire-protocol order (``WP0xx``) and the ``obs/bus.py``
  glossary against the emitted names (``OB0xx``);
- :mod:`gelly_torch.analysis.liveness` — loop liveness and progress
  (``LVxxx``);
- :mod:`gelly_torch.analysis.suppressions` — the audit of every
  ``# graphlint: disable=`` directive (``SUPxxx``);
- :mod:`gelly_torch.analysis.loader` — the shared single-parse AST
  cache (unparseable files are ``SRC001``), and
  :mod:`gelly_torch.analysis.astutil` the helpers and suppression gate
  every tool shares;
- :mod:`gelly_torch.analysis.sanitize` — ASan/UBSan builds of
  ``native/*.cc`` and a smoke run of every host codec fold.

Run everything with ``python -m gelly_torch.analysis`` (or one tool:
``abi|jitlint|racecheck|contracts|plancheck|liveness|suppressions
[paths]``); the exit code is non-zero iff any unsuppressed finding
exists. The package root is a parameter: every tool defaults to
``gelly_torch/`` and, pointed at ``gelly_tpu/``, reproduces that
package's own findings (jitlint and plancheck read a JAX module as
``gelly_tpu``'s tools do, a module of the port in the PyTorch
vocabulary).
"""

from __future__ import annotations

import dataclasses
import os


def collect_python_files(paths) -> list:
    """Expand files/dirs into the sorted, de-duplicated absolute ``.py``
    path list every lint tool walks (``__pycache__`` skipped) — ONE
    collection rule for every lint tool, so a future
    fix (symlink cycles, encoding filters) lands in one place."""
    files: list = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, _dirs, filenames in os.walk(p):
                if "__pycache__" in dirpath:
                    continue
                files.extend(os.path.join(dirpath, f)
                             for f in sorted(filenames)
                             if f.endswith(".py"))
        else:
            files.append(p)
    return sorted(set(os.path.abspath(f) for f in files))


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analysis finding, printable as ``path:line: RULE message``."""

    path: str
    line: int
    rule: str
    message: str
    hint: str = ""

    def render(self) -> str:
        s = f"{self.path}:{self.line}: {self.rule} {self.message}"
        if self.hint:
            s += f"\n    hint: {self.hint}"
        return s


__all__ = ["Finding", "collect_python_files"]
