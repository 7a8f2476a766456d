"""CLI: ``python -m gelly_torch.analysis``.

Unified exit-code contract for every analysis tool of the port:

    python -m gelly_torch.analysis                  # all tools
    python -m gelly_torch.analysis --all            # same, explicit
    python -m gelly_torch.analysis racecheck PATH…  # one tool, optional paths
    python -m gelly_torch.analysis contracts PATH…
    python -m gelly_torch.analysis plancheck PATH…
    python -m gelly_torch.analysis liveness PATH…
    python -m gelly_torch.analysis jitlint PATH…
    python -m gelly_torch.analysis abi
    python -m gelly_torch.analysis suppressions   # audit the disables

Findings print as ``path:line: RULE message``; a per-tool finding-count
summary follows, and the exit code is non-zero **iff any unsuppressed
finding exists** (suppressed lines never reach the output).

The package is a parameter: ``--package DIR`` (default the first path
argument when it is a package with ``utils/native.py``, else
``gelly_torch/``) sets the default lint path, the ctypes bindings
(``DIR/utils/native.py``) and, where the package has them, the kernel
bindings (``DIR/ops/_build.py`` against ``DIR/csrc/*.cu``). Pointed at
``gelly_tpu/`` the tools reproduce that package's own findings.
``jitlint`` and ``plancheck`` read each module in the vocabulary of its
imports: a module that imports ``jax`` as ``gelly_tpu``'s tools read it,
one that imports ``torch`` in the PyTorch vocabulary (device scopes,
host syncs, in-place plan entries; see ``jitlint.py`` and
``plancheck.py``). Nothing here imports JAX.

Every tool shares ONE parsed-AST cache per invocation
(``analysis/loader.py``): an unparseable file is a loud per-file
``SRC001`` finding from every covering tool.

``--changed[=REF]`` lints only files that differ vs a git ref (default
``HEAD``) plus untracked files. Tools whose rules are whole-package
(racecheck lock cycles, the OB glossary, the plancheck PC4xx matrix)
still LOAD the full lint set but only REPORT findings anchored in changed
files; jitlint's rules are per-file, so it lints only the changed ones.

``--format=json`` emits one machine-readable object for CI,
``--format=github`` one workflow annotation per finding, and
``--format=sarif`` one SARIF 2.1.0 document; the exit-code contract is
unchanged.

The ``suppressions`` subcommand audits every ``# graphlint: disable=``
directive (justification present, rule id known, rule still firing at
the anchor — see analysis/suppressions.py) with the standard exit-code
contract; under ``--all`` the same audit rides along as warnings that
never flip the exit code.

The sanitizer smoke lane rides along via ``--sanitize asan|ubsan|both``
(its failures also drive the exit code).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from . import Finding, collect_python_files
from . import abi as abi_mod
from . import contracts as contracts_mod
from . import jitlint as jitlint_mod
from . import liveness as liveness_mod
from . import loader as loader_mod
from . import plancheck as plancheck_mod
from . import racecheck as racecheck_mod
from . import sanitize as sanitize_mod
from . import suppressions as suppressions_mod

_REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", ".."))

TOOLS = ("abi", "jitlint", "racecheck", "contracts", "plancheck",
         "liveness")

# "suppressions" is a subcommand but NOT a member of TOOLS: in --all it
# rides along as warnings that never flip the exit code, so the finding
# gate and the hygiene gate stay independently readable (CI gates on
# the dedicated lane).
SUBCOMMANDS = TOOLS + ("all", "suppressions")

_AB_RULES = (
    ("AB001", "native function has no ctypes binding"),
    ("AB002", "binding names a symbol no extern \"C\" block declares"),
    ("AB003", "parameter-count (arity) mismatch"),
    ("AB004", "parameter type/width mismatch"),
    ("AB005", "return type mismatch / missing restype or argtypes"),
    ("AB006", "declaration or binding the checker cannot resolve"),
)


def _list_rules() -> str:
    lines = ["ABI cross-checker (analysis/abi.py):"]
    for rid, desc in _AB_RULES:
        lines.append(f"  {rid}  {desc}")
    lines.append("jit-hazard / device-scope linter (analysis/jitlint.py), "
                 "suppress with `# graphlint: disable=GLxxx`:")
    for rid, (summary, _hint) in sorted(jitlint_mod.RULES.items()):
        lines.append(f"  {rid}  {summary} "
                     f"(torch: {jitlint_mod.TORCH_RULES[rid]})")
    lines.append("race detector + protocol invariants "
                 "(analysis/racecheck.py), suppress with "
                 "`# graphlint: disable=RCxxx` / `PIxxx`:")
    for rid, (summary, _hint) in sorted(racecheck_mod.RULES.items()):
        lines.append(f"  {rid}  {summary}")
    lines.append("durability-contract checker (analysis/contracts.py), "
                 "suppress with `# graphlint: disable=EOxxx` / `WPxxx` / "
                 "`OBxxx`:")
    for rid, (summary, _hint) in sorted(contracts_mod.RULES.items()):
        lines.append(f"  {rid}  {summary}")
    lines.append("compiled-plan contract checker (analysis/plancheck.py), "
                 "suppress with `# graphlint: disable=PCxxx`:")
    for rid, (summary, _hint) in sorted(plancheck_mod.RULES.items()):
        lines.append(f"  {rid}  {summary}")
    lines.append("liveness & progress checker (analysis/liveness.py), "
                 "suppress with `# graphlint: disable=LVxxx`:")
    for rid, (summary, _hint) in sorted(liveness_mod.RULES.items()):
        lines.append(f"  {rid}  {summary}")
    lines.append("suppression audit (analysis/suppressions.py), "
                 "dedicated `suppressions` subcommand; SUP findings are "
                 "not suppressible:")
    for rid, (summary, _hint) in sorted(suppressions_mod.RULES.items()):
        lines.append(f"  {rid}  {summary}")
    lines.append("shared source loader (analysis/loader.py):")
    lines.append(f"  {loader_mod.SRC_RULE}  {loader_mod.SRC_SUMMARY} "
                 "(syntax error / non-UTF8 / zero-byte; emitted by every "
                 "covering tool, not suppressible)")
    lines.append("sanitizer lane (analysis/sanitize.py): "
                 "--sanitize asan|ubsan, env GELLY_NATIVE_SANITIZE")
    return "\n".join(lines)


def _rule_metadata() -> list:
    """Every rule id across every tool with its summary/hint — the
    SARIF ``tool.driver.rules`` array (and the machine-readable twin of
    ``--list-rules``)."""
    rules: dict = {rid: (desc, "") for rid, desc in _AB_RULES}
    for mod in (jitlint_mod, racecheck_mod, contracts_mod,
                plancheck_mod, liveness_mod, suppressions_mod):
        rules.update(mod.RULES)
    rules[loader_mod.SRC_RULE] = (loader_mod.SRC_SUMMARY,
                                  loader_mod.SRC_HINT)
    out = []
    for rid in sorted(rules):
        summary, hint = rules[rid]
        entry = {"id": rid,
                 "shortDescription": {"text": summary}}
        if hint:
            entry["help"] = {"text": hint}
        out.append(entry)
    return out


def _sarif(per_tool: dict, warnings: list, root: str) -> dict:
    """One SARIF 2.1.0 run over every tool's findings (level error)
    plus the suppression-audit warnings (level warning), with full rule
    metadata, for ``github/codeql-action/upload-sarif``."""
    def result(f: Finding, level: str) -> dict:
        path = os.path.relpath(f.path, root)
        if path.startswith(".."):
            path = f.path
        msg = f.message + (f" | hint: {f.hint}" if f.hint else "")
        return {
            "ruleId": f.rule,
            "level": level,
            "message": {"text": msg},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {
                        "uri": path.replace(os.sep, "/"),
                        "uriBaseId": "SRCROOT",
                    },
                    "region": {"startLine": max(1, f.line)},
                },
            }],
        }

    results = [result(f, "error")
               for fs in per_tool.values() for f in fs]
    results += [result(f, "warning") for f in warnings]
    return {
        "$schema": "https://json.schemastore.org/sarif-2.1.0.json",
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "gelly-analysis",
                "informationUri":
                    "https://example.invalid/gelly_torch/analysis",
                "rules": _rule_metadata(),
            }},
            "originalUriBaseIds": {
                "SRCROOT": {"uri": "file://" + root.rstrip("/") + "/"},
            },
            "results": results,
        }],
    }


def _github_annotation(f: Finding, root: str,
                       level: str = "error") -> str:
    """One ``::error`` (or ``::warning``) workflow command per finding.
    GitHub parses the message up to the first newline; data is
    %-escaped per the workflow-command spec — property values
    (``file=``/``title=``) additionally escape ``:`` and ``,``, the
    property delimiters."""
    def esc(s: str) -> str:
        return (s.replace("%", "%25").replace("\r", "%0D")
                .replace("\n", "%0A"))

    def esc_prop(s: str) -> str:
        return esc(s).replace(":", "%3A").replace(",", "%2C")

    path = os.path.relpath(f.path, root)
    if path.startswith(".."):
        path = f.path
    msg = f.message + (f" | hint: {f.hint}" if f.hint else "")
    return (f"::{level} file={esc_prop(path)},line={f.line},"
            f"title={esc_prop(f.rule)}::{esc(msg)}")


def _changed_files(root: str, ref: str) -> set:
    """Absolute paths of files differing from ``ref`` (worktree diff)
    plus untracked files — the ``--changed`` lint scope."""
    def run(*args):
        p = subprocess.run(["git", "-C", root, *args],
                           capture_output=True, text=True)
        if p.returncode != 0:
            raise SystemExit(
                f"--changed: git {' '.join(args)} failed: "
                f"{p.stderr.strip() or p.stdout.strip()}")
        return [ln for ln in p.stdout.splitlines() if ln.strip()]

    # `git diff --name-only` prints TOPLEVEL-relative paths while
    # `ls-files --others` prints cwd-relative ones — join each against
    # its own base or a --root below the toplevel resolves tracked
    # changes to nonexistent paths (and silently reports clean).
    top = run("rev-parse", "--show-toplevel")
    diff_base = top[0] if top else root
    out = {os.path.abspath(os.path.join(diff_base, n))
           for n in run("diff", "--name-only", ref, "--")}
    out |= {os.path.abspath(os.path.join(root, n))
            for n in run("ls-files", "--others", "--exclude-standard")}
    return out


def _finding_dict(f: Finding) -> dict:
    return {"path": f.path, "line": f.line, "rule": f.rule,
            "message": f.message, "hint": f.hint}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # `--changed [REF]` normalizes to `--changed=REF` BEFORE argparse so
    # an nargs="?" flag can never swallow a following tool/path token:
    # the next token is taken as the REF only when it cannot be a tool
    # name, a flag, or an existing lint path (prefer the unambiguous
    # `--changed=REF` spelling when a ref shadows a path).
    norm = []
    i = 0
    while i < len(argv):
        tok = argv[i]
        if tok == "--changed":
            nxt = argv[i + 1] if i + 1 < len(argv) else None
            if nxt is not None and not nxt.startswith("-") \
                    and nxt not in SUBCOMMANDS \
                    and not os.path.exists(nxt):
                norm.append(f"--changed={nxt}")
                i += 2
                continue
            tok = "--changed=HEAD"
        norm.append(tok)
        i += 1
    argv = norm
    # Subcommand form: the FIRST positional token naming a tool (or
    # "all") selects it — flags may come before it (`--format=json
    # racecheck gelly_torch/` works like `racecheck --format=json ...`).
    # Tokens that are the VALUE of a preceding flag are not positionals,
    # so a path literally named "racecheck" after --lint-path stays a
    # path.
    value_flags = {"--root", "--native-dir", "--bindings", "--lint-path",
                   "--format", "--sanitize", "--package"}
    tool = None
    expecting_value = False
    for i, tok in enumerate(argv):
        if expecting_value:
            expecting_value = False
            continue
        if tok.startswith("-"):
            expecting_value = tok in value_flags  # "--flag value" form
            continue
        if tok in SUBCOMMANDS:
            tool = tok
            argv.pop(i)
        break  # first positional decides either way

    ap = argparse.ArgumentParser(
        prog="python -m gelly_torch.analysis",
        description="static analysis of the port: ABI cross-check of "
                    "native/*.cc and csrc/*.cu against their ctypes "
                    "bindings, jit-hazard / device-scope lint, "
                    "concurrency race/protocol-invariant check, "
                    "durability/wire/observability contract check, "
                    "compiled-plan contract check, liveness/progress "
                    "check, suppression audit, optional native sanitizer "
                    "smoke lane. Subcommands: abi | jitlint | racecheck "
                    "| contracts | plancheck | liveness | suppressions | "
                    "all (default all).",
    )
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to lint (jitlint + racecheck + "
                         "contracts + plancheck + liveness; default the "
                         "package)")
    ap.add_argument("--all", action="store_true",
                    help="run every tool (abi+jitlint+racecheck+"
                         "contracts+plancheck+liveness) — the default when "
                         "no subcommand is given")
    ap.add_argument("--root", default=_REPO_ROOT,
                    help="repo root (default: the checkout this package "
                         "lives in)")
    ap.add_argument("--package", default=None,
                    help="package directory whose bindings abi checks "
                         "and whose tree is the default lint path "
                         "(default: the first path argument when it is "
                         "a package with utils/native.py, else "
                         "ROOT/gelly_torch)")
    ap.add_argument("--native-dir", default=None,
                    help="directory of *.cc sources (default ROOT/native)")
    ap.add_argument("--bindings", default=None,
                    help="ctypes bindings module (default "
                         "PACKAGE/utils/native.py)")
    ap.add_argument("--lint-path", action="append", default=None,
                    metavar="PATH",
                    help="file/dir to lint (repeatable; alias of the "
                         "positional paths)")
    ap.add_argument("--skip-abi", action="store_true",
                    help="skip the ABI cross-checker")
    ap.add_argument("--skip-jitlint", action="store_true",
                    help="skip the jit-hazard / device-scope linter")
    ap.add_argument("--skip-racecheck", action="store_true",
                    help="skip the concurrency race detector")
    ap.add_argument("--skip-contracts", action="store_true",
                    help="skip the durability-contract checker")
    ap.add_argument("--skip-plancheck", action="store_true",
                    help="skip the compiled-plan contract checker")
    ap.add_argument("--skip-liveness", action="store_true",
                    help="skip the liveness & progress checker")
    ap.add_argument("--changed", nargs="?", const="HEAD", default=None,
                    metavar="REF",
                    help="lint only files that differ vs the given git "
                         "ref (default HEAD) plus untracked files; "
                         "whole-package rules still load the full set "
                         "but report only changed-file findings")
    ap.add_argument("--format",
                    choices=("text", "json", "github", "sarif"),
                    default="text",
                    help="output format (json: one machine-readable "
                         "object on stdout, for CI; github: workflow "
                         "::error annotations for inline PR display; "
                         "sarif: one SARIF 2.1.0 document on stdout)")
    ap.add_argument("--sanitize", choices=("asan", "ubsan", "both"),
                    default=None,
                    help="also run the native smoke workload under the "
                         "given sanitizer(s) in an LD_PRELOAD subprocess")
    ap.add_argument("--list-rules", action="store_true",
                    help="print every rule id and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        print(_list_rules())
        return 0

    root = os.path.abspath(args.root)
    native_dir = args.native_dir or os.path.join(root, "native")
    given = args.paths or args.lint_path
    package = args.package
    if package is None and given and os.path.isfile(
            os.path.join(given[0], "utils", "native.py")):
        package = given[0]
    package = os.path.abspath(package or os.path.join(root, "gelly_torch"))
    bindings = args.bindings or os.path.join(package, "utils", "native.py")
    kernel_build = os.path.join(package, "ops", "_build.py")
    csrc_dir = os.path.join(package, "csrc")
    lint_paths = given or [package]

    run = {t: True for t in TOOLS}
    if tool in TOOLS:
        run = {t: t == tool for t in TOOLS}
    elif tool == "suppressions":
        run = {t: False for t in TOOLS}
    if args.skip_abi:
        run["abi"] = False
    if args.skip_jitlint:
        run["jitlint"] = False
    if args.skip_racecheck:
        run["racecheck"] = False
    if args.skip_contracts:
        run["contracts"] = False
    if args.skip_plancheck:
        run["plancheck"] = False
    if args.skip_liveness:
        run["liveness"] = False

    changed = None
    if args.changed is not None:
        changed = _changed_files(root, args.changed)

    # One parsed-AST cache per invocation: every tool below reads the
    # same tree objects, so --all parses each file once.
    cache = loader_mod.SourceCache()
    # jitlint's rules are per-file, so --changed narrows its INPUT; the
    # whole-package tools keep the full lint set and are post-filtered.
    jit_inputs = lint_paths
    if changed is not None:
        jit_inputs = [f for f in collect_python_files(lint_paths)
                      if f in changed]

    per_tool: dict[str, list[Finding]] = {}
    if run["abi"]:
        per_tool["abi"] = abi_mod.cross_check(native_dir, bindings,
                                              cache=cache)
        if os.path.isfile(kernel_build) and os.path.isdir(csrc_dir):
            per_tool["abi"] += abi_mod.cross_check_kernels(
                csrc_dir, kernel_build, cache=cache)
    if run["jitlint"]:
        per_tool["jitlint"] = jitlint_mod.lint_paths(root, jit_inputs,
                                                     cache=cache)
    if run["racecheck"]:
        per_tool["racecheck"] = racecheck_mod.lint_paths(root, lint_paths,
                                                         cache=cache)
    if run["contracts"]:
        per_tool["contracts"] = contracts_mod.lint_paths(root, lint_paths,
                                                         cache=cache)
    if run["plancheck"]:
        per_tool["plancheck"] = plancheck_mod.lint_paths(root, lint_paths,
                                                         cache=cache)
    if run["liveness"]:
        per_tool["liveness"] = liveness_mod.lint_paths(root, lint_paths,
                                                       cache=cache)

    if changed is not None:
        # SRC001 is exempt from the changed-file scope: an unparseable
        # file ANYWHERE in the set means the whole-package rules ran
        # blind, so the fast path must not report "clean" over it.
        per_tool = {
            t: [f for f in fs
                if f.rule == loader_mod.SRC_RULE
                or os.path.abspath(f.path) in changed]
            for t, fs in per_tool.items()
        }

    # Suppression audit: THE GATE under the dedicated subcommand; a
    # rides-along warning lane under --all (never flips rc there, so
    # the finding gate and the hygiene gate read independently). The
    # --changed fast path skips it — staleness needs full-package runs.
    sup_gate = tool == "suppressions"
    sup_findings: list[Finding] = []
    if sup_gate or (tool in (None, "all") and changed is None):
        sup_findings = suppressions_mod.audit(root, lint_paths,
                                              cache=cache)
    if sup_gate:
        per_tool = {"suppressions": sup_findings}
        sup_findings = []

    findings = [f for fs in per_tool.values() for f in fs]
    rc = 1 if findings else 0

    sanitize_lines: list[str] = []
    if args.sanitize:
        modes = ("asan", "ubsan") if args.sanitize == "both" \
            else (args.sanitize,)
        for mode in modes:
            if not sanitize_mod.sanitizer_available(mode):
                sanitize_lines.append(
                    f"sanitize[{mode}]: runtime unavailable "
                    "(g++ or lib{a,ub}san missing) — skipped")
                continue
            proc = sanitize_mod.run_smoke(mode)
            if proc.returncode != 0:
                sanitize_lines.append(
                    f"sanitize[{mode}]: FAILED (rc={proc.returncode})")
                sanitize_lines.append(proc.stdout[-2000:])
                sanitize_lines.append(proc.stderr[-4000:])
                rc = 1
            else:
                sanitize_lines.append(
                    proc.stdout.strip() or f"sanitize[{mode}]: clean")

    if args.format == "sarif":
        print(json.dumps(_sarif(per_tool, sup_findings, root), indent=1))
        return rc

    if args.format == "github":
        for f in findings:
            print(_github_annotation(f, root))
        for f in sup_findings:
            print(_github_annotation(f, root, level="warning"))
        for t, fs in per_tool.items():
            print(f"{t}: {len(fs)} finding(s)",
                  file=sys.stderr if fs else sys.stdout)
        if sup_findings:
            print(f"suppressions: {len(sup_findings)} warning(s)")
        for line in sanitize_lines:
            print(line, file=sys.stderr if rc else sys.stdout)
        return rc

    if args.format == "json":
        print(json.dumps({
            "tools": {
                t: {"count": len(fs),
                    "findings": [_finding_dict(f) for f in fs]}
                for t, fs in per_tool.items()
            },
            "suppressions": {
                "count": len(sup_findings),
                "findings": [_finding_dict(f) for f in sup_findings],
            } if (sup_findings or tool in (None, "all")) else None,
            "sanitize": sanitize_lines or None,
            "total": len(findings),
            "ok": rc == 0,
        }, indent=1))
        return rc

    for f in findings:
        print(f.render())
    # Suppression-audit warnings (the --all ride-along): visible, never
    # part of the exit code here — the dedicated subcommand is the gate.
    for f in sup_findings:
        print(f"warning: {f.render()}")
    # Per-tool summary — the exit-code contract made visible: non-zero
    # iff any count below is non-zero (or a sanitizer lane failed).
    for t, fs in per_tool.items():
        print(f"{t}: {len(fs)} finding(s)",
              file=sys.stderr if fs else sys.stdout)
    if sup_findings:
        print(f"suppressions: {len(sup_findings)} warning(s)")
    for line in sanitize_lines:
        print(line, file=sys.stderr if rc else sys.stdout)
    if rc == 0:
        checks = list(per_tool)
        if args.sanitize:
            checks.append(f"sanitize:{args.sanitize}")
        if tool in (None, "all") and changed is None:
            checks.append("suppressions-audit"
                          if not sup_findings else
                          f"suppressions:{len(sup_findings)} warning(s)")
        print(f"analysis clean ({', '.join(checks)})")
    return rc


if __name__ == "__main__":
    sys.exit(main())
