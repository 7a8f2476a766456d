"""Shared single-parse AST cache for the analysis package.

Every analysis tool (abi's bindings parse, racecheck, contracts,
liveness, the suppression audit) walks the same package tree.
:class:`SourceCache` parses each file ONCE and hands the same
``(tree, lines)`` pair to every tool — the CLI creates one cache per
invocation and threads it through each tool's ``lint_paths(...,
cache=)``. Tools still build their own derived per-module structures
(import maps, class tables) around the shared tree; only the read +
parse is deduplicated, so the tools stay independent.

Unreadable sources are a LOUD per-file diagnostic, never a crash and
never a silent skip: a syntax error, a non-UTF8 byte, or a zero-byte
file (a truncated checkout/write — ``__init__.py`` package markers are
exempt, an empty one is idiomatic) is recorded once here and surfaced
by EVERY tool that covers the file as a ``SRC001`` finding, so the CLI
exit code flips even when no rule could run over the file. ``SRC001``
is deliberately not suppressible — a suppression comment lives on a
source line the parser could not deliver.
"""

from __future__ import annotations

import ast
import dataclasses
import os

from . import Finding

#: Rule id shared by every tool for an unparseable source file.
SRC_RULE = "SRC001"
SRC_SUMMARY = "source file could not be parsed"
SRC_HINT = (
    "every analysis tool skips rule checks for this file, so the lint "
    "result is NOT a clean bill — fix the file (or remove it from the "
    "tree) before trusting the lane"
)


@dataclasses.dataclass
class ModuleSource:
    """One successfully parsed file, shared by every tool."""

    path: str
    src: str
    tree: ast.Module
    lines: list


@dataclasses.dataclass(frozen=True)
class SourceError:
    """Why a file could not be parsed (kind: syntax|encoding|empty|io)."""

    path: str
    line: int
    kind: str
    detail: str

    def finding(self) -> Finding:
        return Finding(self.path, self.line, SRC_RULE,
                       f"{SRC_SUMMARY}: {self.detail}", hint=SRC_HINT)


class SourceCache:
    """Parse-once cache: path -> :class:`ModuleSource` | recorded error."""

    def __init__(self):
        self._mods: dict[str, ModuleSource] = {}
        self._errors: dict[str, SourceError] = {}
        #: path -> (st_mtime_ns, st_size) at parse/record time. A hit
        #: is served only while the stat signature still matches, so a
        #: long-lived process (watch mode, an LSP, a test editing temp
        #: files between loads) re-parses edited files instead of
        #: serving stale trees.
        self._stat: dict[str, tuple] = {}

    @staticmethod
    def _signature(path: str) -> tuple | None:
        try:
            st = os.stat(path)
        except OSError:
            return None
        return (st.st_mtime_ns, st.st_size)

    def get(self, path: str) -> ModuleSource | None:
        """The parsed module, or None with the failure recorded (read it
        back via :meth:`error`). Cached entries are invalidated when the
        file's (mtime_ns, size) changes on disk."""
        path = os.path.abspath(path)
        if path in self._mods or path in self._errors:
            if self._signature(path) == self._stat.get(path):
                return self._mods.get(path)
            self._mods.pop(path, None)
            self._errors.pop(path, None)
            self._stat.pop(path, None)
        err = None
        self._stat[path] = self._signature(path)
        try:
            with open(path, "rb") as f:
                raw = f.read()
            if not raw and os.path.basename(path) != "__init__.py":
                err = SourceError(
                    path, 1, "empty",
                    "zero-byte source file (truncated write/checkout?)")
            else:
                src = raw.decode("utf-8")
                tree = ast.parse(src, filename=path)
                m = ModuleSource(path=path, src=src, tree=tree,
                                 lines=src.splitlines())
                self._mods[path] = m
                return m
        except UnicodeDecodeError as e:
            err = SourceError(path, 1, "encoding",
                              f"not valid UTF-8 ({e.reason} at byte "
                              f"{e.start})")
        except SyntaxError as e:
            err = SourceError(path, e.lineno or 1, "syntax",
                              f"syntax error: {e.msg}")
        except ValueError as e:
            # ast.parse rejects NUL bytes with a bare ValueError (a
            # truncated/partial binary write) — same contract: loud
            # per-file diagnostic, never a crash.
            err = SourceError(path, 1, "syntax", f"unparseable: {e}")
        except OSError as e:
            err = SourceError(path, 1, "io", f"unreadable: {e}")
        self._errors[path] = err
        return None

    def error(self, path: str) -> SourceError | None:
        return self._errors.get(os.path.abspath(path))

    def get_or_finding(self, path: str,
                       findings: list) -> ModuleSource | None:
        """The parsed module, or None after dedup-appending the file's
        ``SRC001`` finding to ``findings`` — the one surfacing sequence
        every tool shares."""
        ms = self.get(path)
        if ms is None:
            err = self.error(path)
            if err is not None:
                f = err.finding()
                if f not in findings:
                    findings.append(f)
        return ms
