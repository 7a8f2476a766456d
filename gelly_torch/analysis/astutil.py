"""AST helpers and the suppression gate shared by every analysis tool.

``_attr_chain`` reduces a dotted expression to its name tuple;
:func:`suppressed` is THE ``# graphlint: disable=`` check that racecheck,
contracts and liveness all consult, so one syntax rule applies to every
rule family at once. The suppression audit
(:func:`gelly_torch.analysis.suppressions.ignoring_suppressions`) flips
``_IGNORE_SUPPRESSIONS`` while it re-runs the tools to find stale
directives.
"""

from __future__ import annotations

import ast
import re

_SUPPRESS_RE = re.compile(r"#\s*graphlint:\s*disable=([A-Za-z0-9,\s]+)")

#: When True, :func:`suppressed` reports every line as unsuppressed.
#: Never set directly — use
#: :func:`gelly_torch.analysis.suppressions.ignoring_suppressions`.
_IGNORE_SUPPRESSIONS = False


def suppressed(lines: list, line: int, rule: str) -> bool:
    """Rule in the comma list, or ``all``, of a ``# graphlint:
    disable=`` comment on the flagged line suppresses the finding."""
    if _IGNORE_SUPPRESSIONS:
        return False
    if 1 <= line <= len(lines):
        sm = _SUPPRESS_RE.search(lines[line - 1])
        if sm:
            ids = {s.strip().upper() for s in sm.group(1).split(",")}
            return rule.upper() in ids or "ALL" in ids
    return False


def _attr_chain(node: ast.AST):
    """``('torch', 'cuda', 'synchronize')`` for
    ``torch.cuda.synchronize``; None if not a plain dotted name."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None
