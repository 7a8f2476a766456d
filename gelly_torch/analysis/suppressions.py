"""Suppression audit: vetted exceptions must stay vetted.

Every ``# graphlint: disable=RULE`` directive in the package is a
reviewed exception to an analysis rule — the line where a human decided
the checker's conservative model was wrong and wrote down why. That
decision rots in two ways: the justification was never written down
(the next reader cannot re-review it), or the code under the directive
changed and the rule no longer fires there at all (the directive now
silently masks FUTURE findings on that line). This module audits both::

    python -m gelly_torch.analysis suppressions

- ``SUP001`` a directive with no justification: neither trailing text
  after the rule list on the same line nor a contiguous comment block
  immediately above explains the exception (three words minimum — "ok"
  is not a review).
- ``SUP002`` a stale directive: the named rule no longer fires at the
  anchor line. Detected by re-running every suppression-aware tool
  with directives ignored (:func:`ignoring_suppressions` flips the
  shared :func:`astutil.suppressed` gate) and diffing the directive
  inventory against the raw findings.
- ``SUP003`` a directive naming a rule id no tool defines (typo'd
  ``RC09`` keeps the real finding alive AND reads as vetted).

The audit is its own CLI lane with the standard exit-code contract
(non-zero iff findings) — CI gates on it — and rides along in
``--all`` as warnings that do NOT flip the exit code there, so the
finding tools' gate and the hygiene gate stay independently readable.
SUP findings are themselves deliberately not suppressible.
"""

from __future__ import annotations

import contextlib
import io
import os
import re
import tokenize

from . import Finding, collect_python_files
from . import astutil as astutil_mod

RULES: dict[str, tuple[str, str]] = {
    "SUP001": (
        "suppression has no justification",
        "write why the rule's model is wrong here: trailing text on "
        "the directive line (`# graphlint: disable=RC001 -- lock held "
        "by caller`) or a comment block immediately above",
    ),
    "SUP002": (
        "stale suppression: the rule no longer fires at this anchor",
        "the code under the directive changed — remove the directive "
        "so it cannot silently mask a future finding on this line",
    ),
    "SUP003": (
        "suppression names an unknown rule id",
        "check --list-rules for the spelling; an unknown id suppresses "
        "nothing while reading as a vetted exception",
    ),
}

_MIN_JUSTIFICATION_WORDS = 3

#: Rule-id prefixes whose tools honor ``# graphlint: disable=`` — the
#: families SUP002 can verify by re-running the owning tool. (AB/SRC
#: findings ignore suppression comments entirely, so a directive naming
#: them is caught by SUP003/SUP001 but never staleness-checked.)
_SUPPRESSIBLE_PREFIXES = ("GL", "RC", "PI", "EO", "WP", "OB", "PC", "LV")


@contextlib.contextmanager
def ignoring_suppressions():
    """Run the analysis tools with every ``graphlint: disable`` comment
    ignored (the stale-detection mode). Restores the shared gate on
    exit, exceptions included."""
    prev = astutil_mod._IGNORE_SUPPRESSIONS
    astutil_mod._IGNORE_SUPPRESSIONS = True
    try:
        yield
    finally:
        astutil_mod._IGNORE_SUPPRESSIONS = prev


def _known_rules() -> set:
    from . import contracts, jitlint, liveness, loader, plancheck, racecheck

    known = {"ALL"}
    for mod in (jitlint, racecheck, contracts, plancheck, liveness):
        known |= set(mod.RULES)
    known |= set(RULES)
    known |= {f"AB00{i}" for i in range(1, 7)}
    known.add(loader.SRC_RULE)
    return known


def _is_comment_line(line: str) -> bool:
    s = line.strip()
    return s.startswith("#") and not astutil_mod._SUPPRESS_RE.search(s)


_WORD_RE = re.compile(r"[A-Za-z0-9']+")


def _justification(lines: list, idx: int, match: re.Match) -> bool:
    """True when the directive at ``lines[idx]`` carries a review note:
    trailing text after the rule list, or a contiguous plain-comment
    block immediately above."""
    trailing = lines[idx][match.end():]
    trailing = trailing.lstrip(" \t#:;-–—")
    if len(_WORD_RE.findall(trailing)) >= _MIN_JUSTIFICATION_WORDS:
        return True
    words: list = []
    j = idx - 1
    while j >= 0 and _is_comment_line(lines[j]):
        words.extend(_WORD_RE.findall(lines[j].lstrip(" \t#")))
        j -= 1
    return len(words) >= _MIN_JUSTIFICATION_WORDS


def inventory(paths) -> list:
    """Every directive in ``paths``: (path, line, rules, match, lines)
    tuples, in file/line order. Tokenized, not grepped: a docstring or
    string literal QUOTING the directive syntax (every tool's module
    doc does) is not a directive."""
    out = []
    for path in collect_python_files(paths):
        try:
            with open(path, "r", encoding="utf-8") as f:
                src = f.read()
            toks = list(tokenize.generate_tokens(
                io.StringIO(src).readline))
        except (OSError, UnicodeDecodeError, tokenize.TokenError,
                SyntaxError):
            continue  # the loader's SRC001 owns unreadable files
        lines = src.splitlines()
        for tok in toks:
            if tok.type != tokenize.COMMENT:
                continue
            sm = astutil_mod._SUPPRESS_RE.search(tok.string)
            if not sm:
                continue
            lineno = tok.start[0]
            # Re-anchor the match on the full line so justification
            # scanning sees the directive's true column.
            lm = astutil_mod._SUPPRESS_RE.search(lines[lineno - 1])
            rules = [s.strip().upper() for s in sm.group(1).split(",")
                     if s.strip()]
            out.append((path, lineno, rules, lm or sm, lines))
    return out


def _raw_findings(package_root: str, paths, cache) -> set:
    """(abspath, line, rule) of every finding the suppression-aware
    tools report when directives are ignored — the live-anchor set
    SUP002 diffs the inventory against."""
    from . import contracts, jitlint, liveness, plancheck, racecheck

    raw: set = set()
    with ignoring_suppressions():
        for mod in (jitlint, racecheck, contracts, plancheck, liveness):
            for f in mod.lint_paths(package_root, paths, cache=cache):
                raw.add((os.path.abspath(f.path), f.line, f.rule))
    return raw


def audit(package_root: str, paths, cache=None) -> list[Finding]:
    """The full audit: SUP001/SUP002/SUP003 findings for every
    directive under ``paths`` (see module doc)."""
    from .loader import SourceCache

    cache = cache or SourceCache()
    directives = inventory(paths)
    findings: list[Finding] = []
    if not directives:
        return findings
    known = _known_rules()
    raw = _raw_findings(package_root, paths, cache)
    live_lines = {(p, ln) for p, ln, _r in raw}
    for path, line, rules, sm, lines in directives:
        apath = os.path.abspath(path)
        if not _justification(lines, line - 1, sm):
            findings.append(Finding(
                path, line, "SUP001",
                f"{RULES['SUP001'][0]}: disable={','.join(rules)} with "
                "no review note on the line or in a comment block "
                "above", hint=RULES["SUP001"][1]))
        for rule in rules:
            if rule not in known:
                findings.append(Finding(
                    path, line, "SUP003",
                    f"{RULES['SUP003'][0]}: {rule!r} is not a rule any "
                    "tool defines", hint=RULES["SUP003"][1]))
                continue
            if rule == "ALL":
                if (apath, line) not in live_lines:
                    findings.append(Finding(
                        path, line, "SUP002",
                        f"{RULES['SUP002'][0]}: disable=ALL but no "
                        "rule fires on this line any more",
                        hint=RULES["SUP002"][1]))
                continue
            if not rule.startswith(_SUPPRESSIBLE_PREFIXES):
                continue
            if (apath, line, rule) not in raw:
                findings.append(Finding(
                    path, line, "SUP002",
                    f"{RULES['SUP002'][0]}: {rule} no longer fires "
                    "here", hint=RULES["SUP002"][1]))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
