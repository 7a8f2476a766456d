"""ABI cross-checker: ``extern "C"`` declarations vs ctypes bindings.

The port binds two native layers by hand-written ctypes declarations:
the host codecs (``native/*.cc``, bound in ``gelly_torch/utils/native.py``
by ``<lib>.<name>.argtypes/.restype`` assignments and the ``_bind(lib,
flag, name, restype, argtypes)`` helper) and the CUDA kernels
(``gelly_torch/csrc/*.cu``, bound by the ``SIGNATURES`` table of
``gelly_torch/ops/_build.py``: ``{library: {symbol: (argtypes,
restype)}}``, each library loaded from ``csrc/<library>.cu``). ctypes
never verifies either against the compiled symbols, so a drifted binding
(an added parameter, a ``long long`` bound as ``c_int``) silently
corrupts memory instead of raising. This module parses both sides — a
small C declaration parser over ``extern "C"`` blocks and single
``extern "C"`` declarations (no libclang dependency) and an ``ast`` walk
over the Python bindings — reduces each type to a canonical width string
(``i32``, ``i64*``, ``char*``, ``void``), and diffs them. Both layers
are the same check under the same rule ids:

- ``AB001`` native function has no ctypes binding
- ``AB002`` binding names a symbol no ``extern "C"`` block declares (for
  a kernel: or its library's ``.cu`` file does not)
- ``AB003`` parameter-count (arity) mismatch
- ``AB004`` parameter type/width mismatch
- ``AB005`` return type mismatch (or binding missing restype/argtypes)
- ``AB006`` declaration or binding the checker cannot resolve

Width canonicalization assumes the LP64 convention every supported
platform (x86-64 / aarch64 Linux) uses: C ``int`` is 32-bit, so
``ctypes.c_int`` and ``int32_t`` are the same wire type.
"""

from __future__ import annotations

import ast
import dataclasses
import glob
import os
import re

from . import Finding

# ------------------------------------------------------------------ #
# C side: comment stripping, extern "C" extraction, declaration parsing

_C_QUALIFIERS = {"const", "volatile", "restrict", "struct", "enum", "inline",
                 "static", "extern", "register"}

# Canonical width of a C base type, keyed by the sorted tuple of its
# tokens (so "unsigned char" and "char unsigned" agree).
_C_BASE = {
    ("char",): "char",
    ("char", "signed"): "i8",
    ("int8_t",): "i8",
    ("char", "unsigned"): "u8",
    ("uint8_t",): "u8",
    ("short",): "i16",
    ("int", "short"): "i16",
    ("int16_t",): "i16",
    ("uint16_t",): "u16",
    ("int",): "i32",
    ("signed",): "i32",
    ("int32_t",): "i32",
    ("unsigned",): "u32",
    ("int", "unsigned"): "u32",
    ("uint32_t",): "u32",
    ("int64_t",): "i64",
    ("long", "long"): "i64",
    ("int", "long", "long"): "i64",
    ("uint64_t",): "u64",
    ("long",): "long",      # platform-width: bind as c_long or not at all
    ("int", "long"): "long",
    ("long", "unsigned"): "ulong",
    ("size_t",): "usize",
    ("ssize_t",): "isize",
    ("float",): "f32",
    ("double",): "f64",
    ("bool",): "bool",
    ("void",): "void",
}


@dataclasses.dataclass
class CDecl:
    """One ``extern "C"`` function: canonical return + parameter types."""

    name: str
    ret: str
    params: list  # list[str] canonical types
    path: str
    line: int


def strip_comments(text: str) -> str:
    """Blank out ``//`` and ``/* */`` comments (length-preserving, so
    offsets map back to the raw file), leaving string/char literals in
    place — a ``/*`` inside a literal is not a comment."""
    out = list(text)
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c == "/" and i + 1 < n and text[i + 1] == "/":
            while i < n and text[i] != "\n":
                out[i] = " "
                i += 1
        elif c == "/" and i + 1 < n and text[i + 1] == "*":
            j = text.find("*/", i + 2)
            j = n if j < 0 else j + 2
            while i < j:
                if text[i] != "\n":
                    out[i] = " "
                i += 1
        elif c in "\"'":
            i = _skip_literal(text, i)
        else:
            i += 1
    return "".join(out)


def _skip_literal(text: str, i: int) -> int:
    """Index just past the string/char literal starting at ``text[i]``."""
    quote = text[i]
    i += 1
    n = len(text)
    while i < n and text[i] != quote:
        i += 2 if text[i] == "\\" else 1
    return min(i + 1, n)


def _line_of(text: str, pos: int) -> int:
    return text.count("\n", 0, pos) + 1


_TOKEN_RE = re.compile(r"[A-Za-z_]\w*|\*")


def _canon_c_type(tokens: list[str], where: str):
    """Canonical string of a C type token list, or None if unknown."""
    stars = sum(1 for t in tokens if t == "*")
    base = tuple(sorted(t for t in tokens
                        if t != "*" and t not in _C_QUALIFIERS))
    canon = _C_BASE.get(base)
    if canon is None:
        return None
    return canon + "*" * stars


def _parse_c_params(params_text: str, path: str, line: int):
    """Canonical param types of one declaration; Findings for unknowns."""
    params, findings = [], []
    text = params_text.strip()
    if text in ("", "void"):
        return params, findings
    depth = 0
    parts, cur = [], []
    for ch in text:
        if ch in "([":
            depth += 1
        elif ch in ")]":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    for part in parts:
        tokens = _TOKEN_RE.findall(part)
        tokens = [t for t in tokens if t not in _C_QUALIFIERS]
        # Trailing identifier that is not a type keyword = parameter name.
        if (len(tokens) >= 2 and tokens[-1] != "*"
                and (tokens[-1],) not in _C_BASE
                and tokens[-1] not in ("long", "unsigned", "signed", "int")):
            tokens = tokens[:-1]
        canon = _canon_c_type(tokens, part)
        if canon is None:
            findings.append(Finding(
                path, line, "AB006",
                f"cannot canonicalize C parameter type {part.strip()!r}",
            ))
            canon = "?"
        params.append(canon)
    return params, findings


def parse_extern_c(path: str):
    """All ``extern "C"`` function declarations in one C++ source file.

    Returns ``(decls, findings)``. Handles both prototypes (``...);``) and
    definitions (``...) { body }``, bodies brace-matched and skipped).
    """
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        raw = f.read()
    text = strip_comments(raw)
    decls: list[CDecl] = []
    findings: list[Finding] = []
    # Single declarations: ``extern "C" int f(...) { body }`` or ``...;``
    # (the CUDA sources' form); the head runs to the first brace or
    # semicolon outside the parameter list.
    for m in re.finditer(r'extern\s+"C"(?!\s*\{)\s+', text):
        i, depth = m.end(), 0
        while i < len(text):
            ch = text[i]
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
            elif ch in "{;" and depth == 0:
                break
            i += 1
        d, fs = _parse_c_decl(text[m.end():i], path,
                              _line_of(text, m.end()))
        findings.extend(fs)
        if d:
            decls.append(d)
    for m in re.finditer(r'extern\s+"C"\s*\{', text):
        i = m.end()
        depth = 1  # inside the extern block's brace
        head_start = i
        while i < len(text) and depth > 0:
            ch = text[i]
            if ch == "{":
                # Function body (or aggregate): the accumulated head is a
                # complete declarator. Parse it, then skip the body.
                header = text[head_start:i]
                d, fs = _parse_c_decl(header, path,
                                      _line_of(text, head_start))
                findings.extend(fs)
                if d:
                    decls.append(d)
                body_depth = 1
                i += 1
                while i < len(text) and body_depth > 0:
                    if text[i] in "\"'":
                        i = _skip_literal(text, i)
                        continue
                    if text[i] == "{":
                        body_depth += 1
                    elif text[i] == "}":
                        body_depth -= 1
                    i += 1
                head_start = i
            elif ch == ";":
                header = text[head_start:i]
                d, fs = _parse_c_decl(header, path,
                                      _line_of(text, head_start))
                findings.extend(fs)
                if d:
                    decls.append(d)
                i += 1
                head_start = i
            elif ch == "}":
                depth -= 1
                i += 1
            else:
                i += 1
    return decls, findings


def _parse_c_decl(header: str, path: str, line: int):
    """Parse one declaration chunk; returns (CDecl | None, findings)."""
    # Point the finding at the declaration's own first line: the chunk
    # starts right after the previous declaration's terminator, so it
    # leads with that line's remainder plus blank lines.
    lead = len(header) - len(header.lstrip())
    line += header[:lead].count("\n")
    header = header.strip()
    if "(" not in header or not header:
        return None, []
    # Skip the keyword soup of non-function statements (typedefs, using).
    if header.startswith(("typedef", "using", "namespace", "#")):
        return None, []
    lp = header.index("(")
    rp = header.rindex(")")
    head_tokens = _TOKEN_RE.findall(header[:lp])
    if len(head_tokens) < 2:
        return None, []
    name = head_tokens[-1]
    findings: list[Finding] = []
    ret = _canon_c_type(head_tokens[:-1], header)
    if ret is None:
        findings.append(Finding(
            path, line, "AB006",
            f"cannot canonicalize return type of {name!r}",
        ))
        ret = "?"
    params, fs = _parse_c_params(header[lp + 1:rp], path, line)
    findings.extend(fs)
    return CDecl(name, ret, params, path, line), findings


# ------------------------------------------------------------------ #
# Python side: ast walk over the ctypes bindings

_CTYPES_BASE = {
    "c_int8": "i8", "c_byte": "i8",
    "c_uint8": "u8", "c_ubyte": "u8",
    "c_int16": "i16", "c_short": "i16",
    "c_uint16": "u16", "c_ushort": "u16",
    "c_int32": "i32", "c_int": "i32",       # LP64: int is 32-bit
    "c_uint32": "u32", "c_uint": "u32",
    "c_int64": "i64", "c_longlong": "i64",
    "c_uint64": "u64", "c_ulonglong": "u64",
    "c_long": "long", "c_ulong": "ulong",
    "c_size_t": "usize", "c_ssize_t": "isize",
    "c_float": "f32", "c_double": "f64",
    "c_bool": "bool", "c_char": "char",
    "c_char_p": "char*", "c_void_p": "void*",
}


@dataclasses.dataclass
class Binding:
    """ctypes declarations of one symbol found in the bindings module."""

    name: str
    restype: str | None = None
    argtypes: list | None = None
    line: int = 0


def _resolve_ctype(node: ast.AST, env: dict):
    """Canonical width string of a ctypes type expression, or None."""
    if isinstance(node, ast.Constant) and node.value is None:
        return "void"
    if isinstance(node, ast.Name):
        return env.get(node.id) or _CTYPES_BASE.get(node.id)
    if isinstance(node, ast.Attribute):
        return _CTYPES_BASE.get(node.attr)
    if isinstance(node, ast.Call):
        fn = node.func
        fname = fn.attr if isinstance(fn, ast.Attribute) else (
            fn.id if isinstance(fn, ast.Name) else None)
        if fname == "POINTER" and len(node.args) == 1:
            inner = _resolve_ctype(node.args[0], env)
            return None if inner is None else inner + "*"
    return None


def _argtypes_elts(node: ast.AST):
    """The element expressions of an argtypes list: a literal list or
    tuple, or sums and integer repeats of them (``[_P] * 10 + [c_int]``);
    None for anything else."""
    if isinstance(node, (ast.List, ast.Tuple)):
        return list(node.elts)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        left, right = _argtypes_elts(node.left), _argtypes_elts(node.right)
        return None if left is None or right is None else left + right
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
        for seq, n in ((node.left, node.right), (node.right, node.left)):
            if isinstance(n, ast.Constant) and type(n.value) is int:
                elts = _argtypes_elts(seq)
                return None if elts is None else elts * max(n.value, 0)
    return None


def _bind_signature(b: Binding, restype: ast.AST | None,
                    argtypes: ast.AST | None, env: dict, path: str,
                    line: int, findings: list) -> None:
    """Resolve one symbol's restype and/or argtypes expressions into
    ``b`` (AB006 for what cannot be resolved)."""
    symbol = b.name
    if restype is not None:
        t = _resolve_ctype(restype, env)
        if t is None:
            findings.append(Finding(
                path, line, "AB006",
                f"cannot resolve restype expression for {symbol!r}",
            ))
            t = "?"
        b.restype = t
    if argtypes is None:
        return
    elts = _argtypes_elts(argtypes)
    if elts is None:
        findings.append(Finding(
            path, line, "AB006",
            f"argtypes of {symbol!r} is not a literal list",
        ))
        return
    args = []
    for elt in elts:
        t = _resolve_ctype(elt, env)
        if t is None:
            findings.append(Finding(
                path, line, "AB006",
                f"cannot resolve argtypes entry "
                f"{ast.unparse(elt)!r} for {symbol!r}",
            ))
            t = "?"
        args.append(t)
    b.argtypes = args
    b.line = line


def _module_env(tree: ast.Module) -> dict:
    """Module-level ctypes aliases (``_i32p = ctypes.POINTER(...)``)."""
    env: dict = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            t = _resolve_ctype(node.value, env)
            if t is not None:
                env[node.targets[0].id] = t
    return env


def _binder_helpers(tree: ast.Module) -> dict:
    """Module-level helpers that declare a symbol's signature from their
    parameters — ``fn = getattr(lib, name)`` then ``fn.restype =
    restype`` and ``fn.argtypes = argtypes`` — as ``{helper: (params,
    name index, restype index, argtypes index)}``."""
    out = {}
    for node in tree.body:
        if not isinstance(node, ast.FunctionDef):
            continue
        params = [a.arg for a in node.args.args]
        fn_of: dict = {}
        roles: dict = {}
        for sub in ast.walk(node):
            if not (isinstance(sub, ast.Assign) and len(sub.targets) == 1):
                continue
            tgt, v = sub.targets[0], sub.value
            if (isinstance(tgt, ast.Name) and isinstance(v, ast.Call)
                    and isinstance(v.func, ast.Name)
                    and v.func.id == "getattr" and len(v.args) == 2
                    and isinstance(v.args[1], ast.Name)
                    and v.args[1].id in params):
                fn_of[tgt.id] = params.index(v.args[1].id)
            elif (isinstance(tgt, ast.Attribute)
                  and tgt.attr in ("restype", "argtypes")
                  and isinstance(tgt.value, ast.Name)
                  and isinstance(v, ast.Name) and v.id in params):
                roles[(tgt.value.id, tgt.attr)] = params.index(v.id)
        for var, ni in fn_of.items():
            if (var, "restype") in roles and (var, "argtypes") in roles:
                out[node.name] = (params, ni, roles[(var, "restype")],
                                  roles[(var, "argtypes")])
    return out


def _call_arg(call: ast.Call, params: list, idx: int):
    if idx < len(call.args):
        return call.args[idx]
    for kw in call.keywords:
        if kw.arg == params[idx]:
            return kw.value
    return None


def _parsed(path: str, cache):
    from .loader import SourceCache

    cache = cache or SourceCache()
    ms = cache.get(path)
    if ms is None:
        err = cache.error(path)
        f = err.finding() if err is not None else Finding(
            path, 1, "SRC001", "bindings module could not be parsed")
        return None, [f]
    return ms.tree, []


def parse_ctypes_bindings(path: str, cache=None):
    """All ``<lib>.<name>.argtypes/.restype`` assignments in a module,
    and every call of a binder helper (see :func:`_binder_helpers`; the
    port's ``_bind(lib, flag, name, restype, argtypes)``).

    Returns ``(bindings, findings)`` where bindings maps symbol name →
    :class:`Binding`. Module-level aliases (``_i32p = ctypes.POINTER(...)``)
    are resolved first so binding lists can use them. An unparseable
    bindings module is a loud SRC001 finding, never a crash (the
    shared :class:`~gelly_torch.analysis.loader.SourceCache` contract).
    """
    tree, findings = _parsed(path, cache)
    if tree is None:
        return {}, findings
    env = _module_env(tree)
    helpers = _binder_helpers(tree)
    bindings: dict[str, Binding] = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id in helpers):
            params, ni, ri, ai = helpers[node.func.id]
            name = _call_arg(node, params, ni)
            if not (isinstance(name, ast.Constant)
                    and isinstance(name.value, str)):
                findings.append(Finding(
                    path, node.lineno, "AB006",
                    f"{node.func.id}() call binds a symbol name that is "
                    "not a string literal",
                ))
                continue
            b = bindings.setdefault(name.value,
                                    Binding(name.value, line=node.lineno))
            _bind_signature(b, _call_arg(node, params, ri),
                            _call_arg(node, params, ai), env, path,
                            node.lineno, findings)
            continue
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        tgt = node.targets[0]
        if not (isinstance(tgt, ast.Attribute)
                and tgt.attr in ("restype", "argtypes")
                and isinstance(tgt.value, ast.Attribute)):
            continue
        symbol = tgt.value.attr
        b = bindings.setdefault(symbol, Binding(symbol, line=node.lineno))
        if tgt.attr == "restype":
            _bind_signature(b, node.value, None, env, path, node.lineno,
                            findings)
        else:
            _bind_signature(b, None, node.value, env, path, node.lineno,
                            findings)
    return bindings, findings


def parse_kernel_signatures(path: str, cache=None):
    """The ``SIGNATURES`` table of the kernel build module:
    ``{library: {symbol: (argtypes, restype)}}``.

    Returns ``(bindings, libraries, findings)``: bindings maps symbol →
    :class:`Binding` (anchored at the symbol's key), libraries maps
    symbol → the library it is loaded from."""
    tree, findings = _parsed(path, cache)
    if tree is None:
        return {}, {}, findings
    env = _module_env(tree)
    table = None
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "SIGNATURES"):
            table = node.value
    bindings: dict[str, Binding] = {}
    libraries: dict[str, str] = {}
    if not isinstance(table, ast.Dict):
        findings.append(Finding(
            path, 1, "AB006",
            "no literal SIGNATURES = {library: {symbol: (argtypes, "
            "restype)}} table",
        ))
        return bindings, libraries, findings
    for lk, lv in zip(table.keys, table.values):
        if not (isinstance(lk, ast.Constant) and isinstance(lk.value, str)
                and isinstance(lv, ast.Dict)):
            findings.append(Finding(
                path, getattr(lk, "lineno", 1), "AB006",
                "SIGNATURES entry is not a literal library -> symbol "
                "table",
            ))
            continue
        for sk, sv in zip(lv.keys, lv.values):
            if not (isinstance(sk, ast.Constant)
                    and isinstance(sk.value, str)
                    and isinstance(sv, ast.Tuple) and len(sv.elts) == 2):
                findings.append(Finding(
                    path, getattr(sk, "lineno", lv.lineno), "AB006",
                    f"SIGNATURES[{lk.value!r}] entry is not a literal "
                    "symbol -> (argtypes, restype) pair",
                ))
                continue
            b = Binding(sk.value, line=sk.lineno)
            _bind_signature(b, sv.elts[1], sv.elts[0], env, path,
                            sk.lineno, findings)
            bindings[sk.value] = b
            libraries[sk.value] = lk.value
    return bindings, libraries, findings


# ------------------------------------------------------------------ #
# the diff

def _types_match(c_type: str, py_type: str) -> bool:
    if "?" in (c_type, py_type):
        return True  # already reported as AB006; don't double-report
    return c_type == py_type


def _declarations(paths) -> tuple[dict, list]:
    findings: list[Finding] = []
    decls: dict[str, CDecl] = {}
    for cc in paths:
        ds, fs = parse_extern_c(cc)
        findings.extend(fs)
        for d in ds:
            if d.name in decls:
                findings.append(Finding(
                    d.path, d.line, "AB006",
                    f"duplicate extern \"C\" declaration of {d.name!r} "
                    f"(also in {decls[d.name].path})",
                ))
            decls[d.name] = d
    return decls, findings


def _diff(decls: dict, bindings: dict, bindings_path: str,
          source_dir: str) -> list[Finding]:
    findings: list[Finding] = []
    for name, d in sorted(decls.items()):
        b = bindings.get(name)
        if b is None:
            findings.append(Finding(
                d.path, d.line, "AB001",
                f"extern \"C\" function {name!r} has no ctypes binding in "
                f"{os.path.basename(bindings_path)}",
                hint="declare argtypes/restype before first use, or drop "
                     "the dead native export",
            ))
            continue
        if b.restype is None:
            findings.append(Finding(
                bindings_path, b.line, "AB005",
                f"binding for {name!r} never sets restype "
                f"(ctypes defaults to c_int)",
            ))
        elif not _types_match(d.ret, b.restype):
            findings.append(Finding(
                bindings_path, b.line, "AB005",
                f"restype of {name!r} is {b.restype!r} but the native "
                f"declaration returns {d.ret!r} "
                f"({os.path.basename(d.path)}:{d.line})",
                hint="a narrowed return truncates 64-bit counts/handles",
            ))
        if b.argtypes is None:
            findings.append(Finding(
                bindings_path, b.line, "AB005",
                f"binding for {name!r} never sets argtypes "
                f"(ctypes would guess from call-site values)",
            ))
            continue
        if len(b.argtypes) != len(d.params):
            findings.append(Finding(
                bindings_path, b.line, "AB003",
                f"{name!r} binds {len(b.argtypes)} parameters but the "
                f"native declaration takes {len(d.params)} "
                f"({os.path.basename(d.path)}:{d.line})",
                hint="an arity drift shifts every later argument register",
            ))
            continue
        for pos, (ct, pt) in enumerate(zip(d.params, b.argtypes)):
            if not _types_match(ct, pt):
                findings.append(Finding(
                    bindings_path, b.line, "AB004",
                    f"{name!r} parameter {pos} bound as {pt!r} but "
                    f"declared {ct!r} ({os.path.basename(d.path)}:{d.line})",
                    hint="width mismatches corrupt memory silently; fix "
                         "whichever side drifted",
                ))

    for name, b in sorted(bindings.items()):
        if name not in decls:
            findings.append(Finding(
                bindings_path, b.line, "AB002",
                f"binding names symbol {name!r} but no extern \"C\" block "
                f"under {source_dir} declares it",
                hint="a renamed native function leaves the old binding "
                     "resolving to nothing (AttributeError at best)",
            ))
    return findings


def cross_check(native_dir: str, bindings_path: str,
                cache=None) -> list[Finding]:
    """Diff every ``extern "C"`` declaration under ``native_dir`` against
    the ctypes bindings in ``bindings_path``. ``cache`` optionally
    shares the CLI-wide parsed-source cache for the bindings module."""
    decls, findings = _declarations(
        sorted(glob.glob(os.path.join(native_dir, "*.cc"))))
    bindings, fs = parse_ctypes_bindings(bindings_path, cache=cache)
    findings.extend(fs)
    return findings + _diff(decls, bindings, bindings_path, native_dir)


def cross_check_kernels(csrc_dir: str, build_path: str,
                        cache=None) -> list[Finding]:
    """Diff every ``extern "C"`` entry of ``csrc_dir/*.cu`` against the
    ``SIGNATURES`` table of ``build_path`` (``ops/_build.py``): the same
    rules as :func:`cross_check`, plus AB002 for a symbol its library's
    ``<library>.cu`` does not declare."""
    decls, findings = _declarations(
        sorted(glob.glob(os.path.join(csrc_dir, "*.cu"))))
    bindings, libraries, fs = parse_kernel_signatures(build_path,
                                                      cache=cache)
    findings.extend(fs)
    findings += _diff(decls, bindings, build_path, csrc_dir)
    for name, lib in sorted(libraries.items()):
        d = decls.get(name)
        if d is not None and os.path.basename(d.path) != f"{lib}.cu":
            findings.append(Finding(
                build_path, bindings[name].line, "AB002",
                f"binding loads {name!r} from library {lib!r} but "
                f"{lib}.cu does not declare it (it is in "
                f"{os.path.basename(d.path)})",
                hint="the library is built from csrc/<library>.cu alone; "
                     "the symbol resolves to nothing there",
            ))
    return findings
