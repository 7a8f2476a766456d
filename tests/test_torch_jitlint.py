"""gelly_torch.analysis.jitlint against gelly_tpu's, and its PyTorch rules.

Two vocabularies, one tool. A module that imports ``jax`` is read as
``gelly_tpu``'s jitlint reads it: on every fixture source of
``tests/test_analysis.py`` (its module constants and the sources its
jitlint tests write) and on the ``gelly_tpu/`` tree the port's findings
equal ``gelly_tpu``'s in path, line, rule and message. A module that
imports ``torch`` is read in the PyTorch vocabulary: each rule GL001-GL007
fires on a torch fixture and not on its clean twin, the port's tree is
clean, every ``DEVICE_SCOPES`` entry resolves on both packages and the
table covers every jit site ``gelly_tpu``'s jitlint finds, and a
``host_sync`` unwrapped in a real fold of the port is flagged.
"""

import ast
import importlib
import os
import shutil
import sys
import textwrap

import pytest

from gelly_torch.analysis import jitlint, suppressions
from gelly_tpu.analysis import jitlint as tpu_jitlint
from gelly_tpu.analysis import suppressions as tpu_suppressions

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TESTS = os.path.join(REPO, "tests")
TPU_PKG = os.path.join(REPO, "gelly_tpu")
TORCH_PKG = os.path.join(REPO, "gelly_torch")


def _test_module(name):
    if TESTS not in sys.path:
        sys.path.insert(0, TESTS)
    return importlib.import_module(name)


def _parses(src: str) -> bool:
    try:
        ast.parse(src)
    except SyntaxError:
        return False
    return True


def _jax_fixtures():
    """Every Python fixture source of ``tests/test_analysis.py``: its
    module-level string constants, and the ``textwrap.dedent`` sources its
    jitlint tests write."""
    mod = _test_module("test_analysis")
    out = []
    for k, v in sorted(vars(mod).items()):
        if isinstance(v, str) and "\n" in v and not k.startswith("__") \
                and _parses(v):
            out.append((f"test_analysis.{k}", v))
    with open(mod.__file__) as f:
        tree = ast.parse(f.read())
    for fn in tree.body:
        if not (isinstance(fn, ast.FunctionDef)
                and fn.name.startswith("test_jitlint")):
            continue
        for i, node in enumerate(n for n in ast.walk(fn)
                                 if isinstance(n, ast.Call)
                                 and getattr(n.func, "attr", "") == "dedent"
                                 and n.args
                                 and isinstance(n.args[0], ast.Constant)):
            src = textwrap.dedent(node.args[0].value)
            if _parses(src):
                out.append((f"test_analysis.{fn.name}.{i}", src))
    return out


JAX_FIXTURES = _jax_fixtures()


def _norm(findings, base):
    return sorted((os.path.relpath(f.path, base), f.line, f.rule, f.message)
                  for f in findings)


def _lint(tmp_path, src, name="fixture_mod.py"):
    p = tmp_path / name
    p.write_text(src)
    return jitlint.lint_paths(str(tmp_path), [str(p)])


def _line_of(src, marker):
    for i, line in enumerate(src.splitlines(), 1):
        if marker in line:
            return i
    raise AssertionError(f"marker {marker!r} not in fixture")


# --------------------------------------------------------------------- #
# the JAX vocabulary: gelly_tpu's findings exactly

def test_fixture_harvest_is_not_vacuous():
    names = {n for n, _ in JAX_FIXTURES}
    assert {"test_analysis.JIT_FIXTURE",
            "test_analysis.DONATION_FIXTURE"} <= names
    assert len(JAX_FIXTURES) >= 12


@pytest.mark.parametrize("case", [n for n, _ in JAX_FIXTURES])
def test_matches_gelly_tpu_on_fixture(tmp_path, case):
    src = dict(JAX_FIXTURES)[case]
    p = tmp_path / "fixture_mod.py"
    p.write_text(src)
    got = _norm(jitlint.lint_paths(str(tmp_path), [str(p)]), tmp_path)
    want = _norm(tpu_jitlint.lint_paths(str(tmp_path), [str(p)]), tmp_path)
    assert got == want


def test_fixtures_fire_every_jax_rule(tmp_path):
    rules = set()
    for i, (_case, src) in enumerate(JAX_FIXTURES):
        d = tmp_path / str(i)
        d.mkdir()
        rules |= {f.rule for f in _lint(d, src)}
    assert rules == {f"GL00{i}" for i in range(1, 8)}


@pytest.mark.parametrize("ignore", [False, True],
                         ids=["directives", "no-directives"])
def test_matches_gelly_tpu_on_its_tree(ignore):
    if ignore:
        with suppressions.ignoring_suppressions(), \
                tpu_suppressions.ignoring_suppressions():
            got = jitlint.lint_paths(REPO, [TPU_PKG])
            want = tpu_jitlint.lint_paths(REPO, [TPU_PKG])
    else:
        got = jitlint.lint_paths(REPO, [TPU_PKG])
        want = tpu_jitlint.lint_paths(REPO, [TPU_PKG])
    assert _norm(got, REPO) == _norm(want, REPO)


# --------------------------------------------------------------------- #
# the PyTorch vocabulary: each rule both ways

HEAD = textwrap.dedent("""\
    import time

    import numpy as np
    import torch

    from gelly_torch.engine.aggregation import SummaryAggregation
    from gelly_torch.ops.unionfind import host_sync


""")

# rule -> (firing body of `fold(s, chunk)`, its clean twin, marker)
TORCH_RULE_CASES = {
    "GL001": ("    h = np.asarray(s)  # M\n    return s\n",
              "    h = np.asarray(s.shape)\n    return s\n"),
    "GL002": ("    if s.sum() > 0:  # M\n        return s\n    return s\n",
              "    if host_sync(s.sum()) > 0:\n        return s\n"
              "    return s\n"),
    "GL003": ("    n = s.sum().item()  # M\n    return s + n\n",
              "    n = host_sync(s.sum())\n    return s + n\n"),
    "GL004": ("    d = {'a': s, 'b': chunk}\n"
              "    return torch.stack(list(d.values()))  # M\n",
              "    d = {'a': s, 'b': chunk}\n"
              "    return torch.stack([v for _k, v in sorted(d.items())])\n"),
    "GL005": ("    return s + torch.full((4,), 0.25)  # M\n",
              "    return s + torch.full((4,), 0.25, dtype=torch.float64)\n"),
    "GL007": ("    t = time.perf_counter()  # M\n    return s\n",
              "    return s\n"),
}


def _plan_fixture(body: str) -> str:
    return HEAD + "def fold(s, chunk):\n" + body + textwrap.dedent("""\


        agg = SummaryAggregation(init=None, fold=fold, combine=None)
    """)


@pytest.mark.parametrize("rule", sorted(TORCH_RULE_CASES))
def test_torch_rule_fires_in_a_plan_fold(tmp_path, rule):
    src = _plan_fixture(TORCH_RULE_CASES[rule][0])
    findings = _lint(tmp_path, src)
    assert [(f.rule, f.line) for f in findings] \
        == [(rule, _line_of(src, "# M"))], \
        "\n".join(f.render() for f in findings)
    assert "SummaryAggregation.fold 'fold'" in findings[0].message
    assert jitlint.TORCH_RULES[rule] in findings[0].message


@pytest.mark.parametrize("rule", sorted(TORCH_RULE_CASES))
def test_torch_rule_clean_twin(tmp_path, rule):
    findings = _lint(tmp_path, _plan_fixture(TORCH_RULE_CASES[rule][1]))
    assert findings == [], "\n".join(f.render() for f in findings)


@pytest.mark.parametrize("rule", sorted(TORCH_RULE_CASES))
def test_torch_rule_silent_outside_a_scope(tmp_path, rule):
    # The same body in a function no plan binds is host code.
    src = HEAD + "def helper(s, chunk):\n" + TORCH_RULE_CASES[rule][0]
    assert _lint(tmp_path, src) == []


GL006_SRC = HEAD + textwrap.dedent("""\
    def step(batch, state, chunk):
        out = batch.plan.fold(state, chunk)
        return out, state.parent  # M


    def step_ok(batch, state, chunk):
        state = batch.plan.fold(state, chunk)
        return state.parent


    def round_ok(batch, dev, act):
        fold = batch.plan.fold_codec if batch.compressed else batch.plan.fold
        batch.state = fold(batch.state, dev, act)
        return batch.state


    def round_bad(batch, dev, act):
        fold = batch.plan.fold_codec if batch.compressed else batch.plan.fold
        new = fold(batch.state, dev, act)
        return new, batch.state  # M2
""")


def test_gl006_in_place_entry_both_ways(tmp_path):
    findings = _lint(tmp_path, GL006_SRC)
    assert sorted((f.rule, f.line) for f in findings) == [
        ("GL006", _line_of(GL006_SRC, "# M")),
        ("GL006", _line_of(GL006_SRC, "# M2"))], \
        "\n".join(f.render() for f in findings)
    assert "'state'" in findings[0].message


def test_gl006_spanner_gate_entries(tmp_path):
    # The spanner's gates update their summary in place: the combine
    # must rebind what it hands on.
    src = HEAD + textwrap.dedent("""\
        def _insert_edges_batched(s, esrc, edst, n, k):
            return s


        def combine(big, small):
            _insert_edges_batched(big, small.esrc, small.edst, small.n, 2)
            return big.overflow  # M


        def combine_ok(big, small):
            big = _insert_edges_batched(big, small.esrc, small.edst,
                                        small.n, 2)
            return big.overflow
    """)
    findings = _lint(tmp_path, src, name="spanner.py")
    assert [(f.rule, f.line) for f in findings] \
        == [("GL006", _line_of(src, "# M"))], \
        "\n".join(f.render() for f in findings)
    assert _lint(tmp_path, src, name="helpers.py") == []


GL007_SRC = HEAD + textwrap.dedent("""\
    def fold(s, chunk):
        return s


    agg = SummaryAggregation(init=None, fold=fold, combine=None)


    def timed(s, chunks):
        t0 = time.perf_counter()
        for c in chunks:
            s = agg.fold(s, c)
        wall = time.perf_counter() - t0  # M
        return s, wall


    def timed_synced(s, chunks):
        t0 = time.perf_counter()
        for c in chunks:
            s = agg.fold(s, c)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return s, wall


    def timed_scope_call(s, chunk):
        t0 = time.perf_counter()
        s = fold(s, chunk)
        end = time.perf_counter()  # M2
        return s, end - t0


    def exclusive_branches(s, chunk, flag):
        if flag:
            t0 = time.perf_counter()
            s = fold(s, chunk)
            host_sync(s.sum())
        else:
            t0 = time.perf_counter()
        return s, time.perf_counter() - t0
""")


def test_gl007_unsynchronized_interval_both_ways(tmp_path):
    findings = _lint(tmp_path, GL007_SRC)
    assert sorted((f.rule, f.line) for f in findings) == [
        ("GL007", _line_of(GL007_SRC, "# M")),
        ("GL007", _line_of(GL007_SRC, "# M2"))], \
        "\n".join(f.render() for f in findings)
    assert "agg.fold(...)" in findings[0].message


DATA_DEPENDENT = {
    "nonzero": "    i = s.nonzero()  # M\n    return s\n",
    "unique": "    u = torch.unique(s)  # M\n    return s\n",
    "mask": "    live = s[s > 0]  # M\n    return s\n",
    "named mask": "    live = s[chunk.valid]  # M\n    return s\n",
    "where1": "    i = torch.where(s > 0)  # M\n    return s\n",
    "bincount": "    b = torch.bincount(s)  # M\n    return s\n",
    "repeat": "    r = s.repeat_interleave(chunk)  # M\n    return s\n",
    "coerce": "    n = int(s.sum())  # M\n    return s\n",
    "cpu": "    h = s.cpu()  # M\n    return s\n",
    "to_numpy": "    h = to_numpy(s)  # M\n    return s\n",
    "assert": "    assert (s >= 0).all()  # M\n    return s\n",
    "ternary": "    return s if s.any() else chunk  # M\n",
    "and": "    ok = s.any() and chunk  # M\n    return s\n",
}


@pytest.mark.parametrize("case", sorted(DATA_DEPENDENT))
def test_syncs_the_card_reports_are_flagged(tmp_path, case):
    # Each op here synchronizes under torch.cuda.set_sync_debug_mode on
    # one H100 (chip_smoke.py phase R's probes): each is flagged.
    body = DATA_DEPENDENT[case]
    src = _plan_fixture(body).replace(
        "from gelly_torch.ops.unionfind import host_sync",
        "from gelly_torch.core.device import to_numpy\n"
        "from gelly_torch.ops.unionfind import host_sync")
    findings = _lint(tmp_path, src)
    assert [f.line for f in findings] == [_line_of(src, "# M")], \
        "\n".join(f.render() for f in findings)
    assert findings[0].rule in ("GL001", "GL002", "GL003")


NO_SYNC = {
    "where3": "    return torch.where(s > 0, s, 0)\n",
    "masked_fill": "    return s.masked_fill(s > 0, 0)\n",
    "shape": "    if s.shape[0] > 4 and s.numel() > 4:\n        return s\n"
             "    return s\n",
    "is None": "    if chunk is None:\n        return s\n    return s\n",
    "repeat output_size": "    return s.repeat_interleave(chunk, "
                          "output_size=8)\n",
    "host value": "    n = host_sync(s.sum())\n    if n > 0:\n"
                  "        return s\n    return s\n",
    "static param": "    return s\n",
}


@pytest.mark.parametrize("case", sorted(NO_SYNC))
def test_device_only_ops_are_clean(tmp_path, case):
    findings = _lint(tmp_path, _plan_fixture(NO_SYNC[case]))
    assert findings == [], "\n".join(f.render() for f in findings)


def test_host_annotated_parameters_are_not_tensors(tmp_path):
    src = HEAD + textwrap.dedent("""\
        def fold(s, chunk, k: int, flag: bool = False, mode="x"):
            if k > 2 and flag and mode == "y":
                return s
            return s


        agg = SummaryAggregation(init=None, fold=fold, combine=None)
    """)
    assert _lint(tmp_path, src) == []


def test_scope_ways_b_and_c(tmp_path):
    # (b): a DEVICE_SCOPES def of the module's basename; (c): the
    # same-module function it calls, one level deep (not a sync helper,
    # not a *_plain version).
    src = HEAD + textwrap.dedent("""\
        def _helper(x):
            return x.nonzero()  # M


        def _helper_plain(x):
            return x.nonzero()


        def _propagate(labels, seen, chunk):
            _helper(labels)
            _helper_plain(labels)
            return labels
    """)
    findings = _lint(tmp_path, src, name="iterative_cc.py")
    assert [(f.rule, f.line) for f in findings] \
        == [("GL003", _line_of(src, "# M"))], \
        "\n".join(f.render() for f in findings)
    assert "device scope '_propagate' -> '_helper'" in findings[0].message
    assert _lint(tmp_path, src, name="other.py") == []


def test_host_transform_is_not_a_scope(tmp_path):
    src = HEAD + textwrap.dedent("""\
        def transform(s):
            return s.cpu().numpy()


        agg = SummaryAggregation(init=None, fold=None, combine=None,
                                 transform=transform, jit_transform=False)
    """)
    assert _lint(tmp_path, src) == []
    src = src.replace("jit_transform=False", "jit_transform=True")
    assert [f.rule for f in _lint(tmp_path, src)] == ["GL003"]


def test_suppression_with_reason_silences_one_line(tmp_path):
    src = _plan_fixture(
        "    n = s.sum().item()  # graphlint: disable=GL003 -- one read\n"
        "    m = s.max().item()  # M\n    return s + n + m\n")
    findings = _lint(tmp_path, src)
    assert [f.line for f in findings] == [_line_of(src, "# M")]


# --------------------------------------------------------------------- #
# the port's tree

def test_tip_clean_on_the_port():
    findings = jitlint.lint_paths(REPO, [TORCH_PKG])
    assert findings == [], "\n".join(f.render() for f in findings)


def test_port_tree_unsuppressed_holds_the_vetted_sites():
    with suppressions.ignoring_suppressions():
        findings = jitlint.lint_paths(REPO, [TORCH_PKG])
    sites = {(os.path.relpath(f.path, REPO), f.rule) for f in findings}
    assert ("gelly_torch/ops/kernels.py", "GL003") in sites
    assert ("gelly_torch/engine/aggregation.py", "GL007") in sites
    assert ("gelly_torch/engine/tenants.py", "GL007") in sites
    assert len(findings) >= 20


def test_device_scopes_resolve_on_both_packages():
    linter = jitlint.JitLinter(REPO)
    scopes = linter.device_scopes([TORCH_PKG])
    names = {(os.path.basename(p), n) for p, spans in scopes.items()
             for _lo, _hi, n in spans}
    for key, counterpart in sorted(jitlint.DEVICE_SCOPES.items()):
        assert key in names, key
        rel, fname = counterpart.split(":")
        with open(os.path.join(TPU_PKG, rel)) as f:
            text = f.read()
        if fname.isdigit():  # a jax.jit(...) call on that line
            assert "jax.jit(" in text.splitlines()[int(fname) - 1], \
                counterpart
            continue
        assert fname in {n.name for n in ast.walk(ast.parse(text))
                         if isinstance(n, ast.FunctionDef)}, counterpart
    for site, what in jitlint.OTHER_JIT_SITES.items():
        kind, _, name = what.partition(" ")
        if kind == "field":
            assert name in jitlint.DEVICE_FIELDS, site
        elif kind == "attribute":
            assert name in jitlint.DEVICE_ATTRIBUTES, site
        elif what != "user function":
            assert tuple(what.split(":")) in jitlint.DEVICE_SCOPES, site
    # Way (a) finds the library's plan folds.
    assert ("connected_components.py", "fold") in names
    assert ("degrees.py", "fold_compressed_sparse") in names
    assert ("bipartiteness.py", "fold") in names


def _jax_jit_sites():
    """Every ``jax.jit`` site of gelly_tpu outside ``analysis/``: a jitted
    def as ``relpath:name``, a ``jax.jit(...)`` call on a name as
    ``relpath:name``, any other call as ``relpath:line``. The first set
    is the one gelly_tpu's jitlint finds."""
    tpu = tpu_jitlint.JitLinter(REPO)
    found, every = set(), set()
    for path in tpu_jitlint.collect_python_files([TPU_PKG]):
        rel = os.path.relpath(path, TPU_PKG)
        if rel.startswith("analysis") or rel.endswith("pallas_kernels.py"):
            continue
        m = tpu.load(path)
        for fn in m.all_functions:
            jitted, _s, _n = tpu._jit_decoration(m, fn)
            if jitted or fn.name in m.jit_called:
                found.add(f"{rel}:{fn.name}")
        decorators = {id(d) for fn in m.all_functions
                      for d in fn.decorator_list}
        for node in ast.walk(m.tree):
            if not isinstance(node, ast.Call) or id(node) in decorators:
                continue
            if tpu._is_jax_jit(m, node.func):
                arg = node.args[0] if node.args else None
                every.add(f"{rel}:{arg.id}" if isinstance(arg, ast.Name)
                          else f"{rel}:{node.lineno}")
            chain = tpu_jitlint._attr_chain(node.func)
            if chain and chain[-1] == "partial" and node.args \
                    and tpu._is_jax_jit(m, node.args[0]):
                every.add(f"{rel}:{node.lineno}")
        for fn in m.all_functions:
            if tpu._jit_decoration(m, fn)[0]:
                every.add(f"{rel}:{fn.name}")
    return found, every


def test_scope_table_covers_every_gelly_tpu_jit_site():
    found, every = _jax_jit_sites()
    assert len(found) >= 40 and found <= every
    covered = set(jitlint.DEVICE_SCOPES.values()) \
        | set(jitlint.OTHER_JIT_SITES)
    assert found <= covered, sorted(found - covered)
    assert every <= covered, sorted(every - covered)


def test_seeded_flip_unwrapped_host_sync_in_a_fold(tmp_path):
    # Unwrap the counted sync of the iterative CC fold: GL003 at the line.
    path = os.path.join(TORCH_PKG, "library", "iterative_cc.py")
    with open(path) as f:
        src = f.read()
    needle = "changed = host_sync((lab2 != lab).any())"
    assert src.count(needle) == 1, "the fold's sync moved: re-anchor"
    assert _lint(tmp_path, src, name="iterative_cc.py") == []
    flipped = src.replace(needle, "changed = (lab2 != lab).any().item()")
    findings = _lint(tmp_path, flipped, name="iterative_cc.py")
    assert [(f.rule, f.line) for f in findings] == [
        ("GL003", _line_of(flipped, "changed = (lab2"))], \
        "\n".join(f.render() for f in findings)
    assert "device scope '_propagate'" in findings[0].message


def test_seeded_flip_on_a_kernel_wrapper(tmp_path):
    # Drop the justification-bearing directive from a wrapper's sync:
    # the finding comes back, and the audit loses nothing else.
    path = os.path.join(TORCH_PKG, "ops", "kernels.py")
    with open(path) as f:
        src = f.read()
    line = "    if int(status):  # graphlint: disable=GL003 -- one read a launch"
    assert src.count(line) == 1
    flipped = src.replace(line, "    if int(status):")
    findings = _lint(tmp_path, flipped, name="kernels.py")
    assert [(f.rule, f.line) for f in findings] == [
        ("GL003", _line_of(flipped, "    if int(status):"))]
    assert "device scope 'hashset_insert'" in findings[0].message


def test_device_scopes_api_spans(tmp_path):
    shutil.copy(os.path.join(TORCH_PKG, "library", "iterative_cc.py"),
                tmp_path / "iterative_cc.py")
    spans = jitlint.device_scopes(str(tmp_path),
                                  [str(tmp_path / "iterative_cc.py")])
    [(path, found)] = spans.items()
    assert [n for _lo, _hi, n in found] == ["_propagate"]
    lo, hi, _ = found[0]
    with open(path) as f:
        lines = f.read().splitlines()
    assert lines[lo - 1].startswith("def _propagate(")
    assert hi > lo


@pytest.mark.parametrize("tool", ["jitlint", "plancheck"])
def test_cli_tool_exits_0_on_both_trees_without_jax(tool):
    import subprocess

    code = textwrap.dedent(f"""\
        import sys
        from gelly_torch.analysis.__main__ import main
        rcs = [main(["{tool}", "gelly_torch"]), main(["{tool}", "gelly_tpu"])]
        assert "jax" not in sys.modules, "jax imported"
        assert "gelly_tpu" not in sys.modules, "gelly_tpu imported"
        sys.exit(max(rcs))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert f"analysis clean ({tool})" in proc.stdout
