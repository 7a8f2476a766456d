"""gelly_torch.analysis against gelly_tpu.analysis, and the port's gate.

The port keeps its own copies of the JAX-free tools (racecheck,
contracts, liveness, abi, the suppression audit, the sanitizer lane),
so each is held to ``gelly_tpu``'s on the same inputs: every fixture
source of ``tests/test_racecheck.py``, ``test_contracts.py``,
``test_liveness.py`` and ``test_analysis.py`` (plus the seeded
coordination invariants and a suppression fixture), the ``gelly_tpu/``
tree, and ``gelly_torch/`` with its vetted directives ignored. Findings
must agree in path, line, rule and message. Then the gate itself:
``python -m gelly_torch.analysis --all gelly_torch`` exits 0 without
importing JAX, the kernel bindings are checked against ``csrc/*.cu``,
and the RC001 fix holds at run time.
"""

import ast
import importlib
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import gelly_tpu.analysis.contracts as tpu_contracts
import gelly_tpu.analysis.liveness as tpu_liveness
import gelly_tpu.analysis.racecheck as tpu_racecheck
import gelly_tpu.analysis.suppressions as tpu_suppressions
from gelly_tpu.analysis import abi as tpu_abi
from gelly_torch.analysis import (
    abi,
    contracts,
    liveness,
    racecheck,
    sanitize,
    suppressions,
)
from gelly_torch.analysis.__main__ import main as analysis_main

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TESTS = os.path.join(REPO, "tests")
NATIVE_DIR = os.path.join(REPO, "native")
CSRC = os.path.join(REPO, "gelly_torch", "csrc")
KERNEL_BUILD = os.path.join(REPO, "gelly_torch", "ops", "_build.py")
TPU_PKG = os.path.join(REPO, "gelly_tpu")
TORCH_PKG = os.path.join(REPO, "gelly_torch")

TOOLS = {
    "racecheck": (racecheck.lint_paths, tpu_racecheck.lint_paths),
    "contracts": (contracts.lint_paths, tpu_contracts.lint_paths),
    "liveness": (liveness.lint_paths, tpu_liveness.lint_paths),
    "suppressions": (suppressions.audit, tpu_suppressions.audit),
}


def _test_module(name):
    if TESTS not in sys.path:
        sys.path.insert(0, TESTS)
    return importlib.import_module(name)


def _py_constants(module_name):
    """Module-level multi-line string constants that parse as Python:
    the fixture sources of one JAX analysis test module."""
    mod = _test_module(module_name)
    out = []
    for k, v in sorted(vars(mod).items()):
        if k.startswith("__") or not isinstance(v, str) or "\n" not in v:
            continue
        try:
            ast.parse(v)
        except SyntaxError:
            continue
        out.append((f"{module_name}.{k}", v))
    return out


SUPPRESSION_FIXTURE = textwrap.dedent('''\
    import threading


    class Box:
        def __init__(self):
            self._lock = threading.Lock()
            self.value = 0

        def start(self):
            threading.Thread(target=self.run, daemon=True).start()

        def run(self):
            # The worker owns the counter alone once started, so the
            # unlocked write is safe by construction.
            self.value = 1  # graphlint: disable=RC001

        def reset(self):
            self.value = 0  # graphlint: disable=RC001

        def stale(self):
            x = 1  # graphlint: disable=RC002 -- nothing fires on this line
            return x

        def typo(self):
            y = 2  # graphlint: disable=RC0099 -- a misspelled rule id here
            return y
''')


def _fixture_cases():
    cases = []
    for m in ("test_racecheck", "test_contracts", "test_liveness"):
        for name, src in _py_constants(m):
            fname = "bus.py" if "BUS" in name else "fixture_mod.py"
            cases.append((name, {fname: src}))
    contracts_mod = _test_module("test_contracts")
    seen = set()
    for rule, files in sorted(contracts_mod._RULE_SEEDS.items()):
        key = tuple(sorted(files.items()))
        if len(files) > 1 and key not in seen:
            seen.add(key)
            cases.append((f"test_contracts._RULE_SEEDS.{rule}", files))
    race_mod = _test_module("test_racecheck")
    with open(os.path.join(TPU_PKG, "engine", "coordination.py")) as f:
        coordination = f.read()
    for rule, seed in sorted(race_mod._PI_SEEDS.items()):
        cases.append((f"test_racecheck._PI_SEEDS.{rule}",
                      {"coordination.py": coordination + seed}))
    cases.append(("suppression_fixture",
                  {"fixture_mod.py": SUPPRESSION_FIXTURE}))
    return cases


FIXTURE_CASES = _fixture_cases()


def _norm(findings, base):
    return sorted((os.path.relpath(f.path, base), f.line, f.rule, f.message)
                  for f in findings)


def _write(tmp_path, files):
    paths = []
    for name, src in files.items():
        p = tmp_path / name
        p.write_text(src)
        paths.append(str(p))
    return paths


def test_fixture_harvest_covers_every_jax_fixture_module():
    names = {n.split(".")[0] for n, _ in FIXTURE_CASES}
    assert {"test_racecheck", "test_contracts", "test_liveness"} <= names
    assert len(FIXTURE_CASES) >= 29


@pytest.mark.parametrize("tool", sorted(TOOLS))
@pytest.mark.parametrize("case", [c[0] for c in FIXTURE_CASES])
def test_tool_matches_gelly_tpu_on_fixture(tmp_path, tool, case):
    files = dict(FIXTURE_CASES)[case]
    paths = _write(tmp_path, files)
    port, tpu = TOOLS[tool]
    got = _norm(port(str(tmp_path), paths), tmp_path)
    want = _norm(tpu(str(tmp_path), paths), tmp_path)
    assert got == want


def test_fixtures_are_not_vacuous(tmp_path):
    # The parity above must compare real findings: every family fires
    # somewhere in the fixture set, through the port's tools.
    rules = set()
    for i, (_case, files) in enumerate(FIXTURE_CASES):
        d = tmp_path / str(i)
        d.mkdir()
        paths = _write(d, files)
        for tool, (port, _tpu) in TOOLS.items():
            rules |= {f.rule[:2] for f in port(str(d), paths)}
    assert {"RC", "PI", "EO", "WP", "OB", "LV", "SU"} <= rules


@pytest.fixture(scope="module")
def tree_findings():
    """Each tool of each package over gelly_tpu/ (directives honored) and
    over gelly_torch/ (directives ignored, so the vetted sites show)."""
    from gelly_torch.analysis.loader import SourceCache
    from gelly_tpu.analysis.loader import SourceCache as TpuSourceCache

    out = {}
    caches = {"torch": SourceCache(), "tpu": TpuSourceCache()}
    for tool, (port, tpu) in TOOLS.items():
        for pkg_name, fn, ctx in (
            ("torch", port, suppressions.ignoring_suppressions),
            ("tpu", tpu, tpu_suppressions.ignoring_suppressions),
        ):
            cache = caches[pkg_name]
            out[(tool, pkg_name, "gelly_tpu")] = _norm(
                fn(REPO, [TPU_PKG], cache=cache), REPO)
            if tool != "suppressions":
                with ctx():
                    out[(tool, pkg_name, "gelly_torch")] = _norm(
                        fn(REPO, [TORCH_PKG], cache=cache), REPO)
    return out


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tool_reproduces_gelly_tpu_on_its_tree(tree_findings, tool):
    assert (tree_findings[(tool, "torch", "gelly_tpu")]
            == tree_findings[(tool, "tpu", "gelly_tpu")])


@pytest.mark.parametrize("tool", ["racecheck", "contracts", "liveness"])
def test_tool_matches_gelly_tpu_on_the_port_unsuppressed(tree_findings,
                                                         tool):
    assert (tree_findings[(tool, "torch", "gelly_torch")]
            == tree_findings[(tool, "tpu", "gelly_torch")])


def test_port_tree_unsuppressed_holds_the_vetted_sites(tree_findings):
    rules = {(p, r) for tool in ("racecheck", "contracts")
             for p, _l, r, _m in tree_findings[(tool, "torch",
                                                "gelly_torch")]}
    assert ("gelly_torch/engine/resilience.py", "RC006") in rules
    assert ("gelly_torch/engine/coordination.py", "EO004") in rules
    assert not any(r in ("RC001", "RC004") for _p, r in rules)


def test_racecheck_discovers_the_port_thread_roots():
    c = racecheck.RaceChecker(REPO)
    c.lint_paths([TORCH_PKG])
    names = {r.entry.name for r in c.roots}
    assert {"writer", "run", "_beat_loop", "worker", "_accept_loop",
            "_conn_loop", "_reader_loop", "_drive_loop"} <= names


# --------------------------------------------------------------------- #
# abi

def test_abi_matches_gelly_tpu_on_its_bindings_and_fixture(tmp_path):
    got = abi.cross_check(NATIVE_DIR, os.path.join(TPU_PKG, "utils",
                                                   "native.py"))
    want = tpu_abi.cross_check(NATIVE_DIR, os.path.join(TPU_PKG, "utils",
                                                        "native.py"))
    assert _norm(got, REPO) == _norm(want, REPO) == []
    fx = _test_module("test_analysis")
    native = tmp_path / "native"
    native.mkdir()
    (native / "fixture.cc").write_text(fx.FIXTURE_CC)
    py = tmp_path / "fixture_bindings.py"
    py.write_text(fx.FIXTURE_PY)
    got = _norm(abi.cross_check(str(native), str(py)), tmp_path)
    want = _norm(tpu_abi.cross_check(str(native), str(py)), tmp_path)
    assert got == want
    assert {r for _p, _l, r, _m in got} == {"AB001", "AB002", "AB003",
                                           "AB004", "AB005"}


def test_abi_follows_the_bind_helper():
    # gelly_tpu's checker does not know the port's _bind(lib, flag, name,
    # restype, argtypes): it reports the six symbols bound through it as
    # unbound (AB001). The port's checker reads them.
    bindings = os.path.join(TORCH_PKG, "utils", "native.py")
    tpu = tpu_abi.cross_check(NATIVE_DIR, bindings)
    helped = {"cc_chunk_combine_sparse", "cc_chunk_combine_sparse_idx",
              "parity_chunk_combine", "degree_chunk_deltas",
              "parity_chunk_combine_sparse", "degree_chunk_deltas_sparse"}
    assert {f.rule for f in tpu} == {"AB001"}
    assert {f.message.split("'")[1] for f in tpu} == helped
    assert abi.cross_check(NATIVE_DIR, bindings) == []
    parsed, fs = abi.parse_ctypes_bindings(bindings)
    assert fs == [] and helped <= set(parsed)
    assert all(parsed[n].argtypes and parsed[n].restype for n in helped)


def test_kernel_signatures_clean_and_complete():
    assert abi.cross_check_kernels(CSRC, KERNEL_BUILD) == []
    from gelly_torch.ops._build import SIGNATURES

    bindings, libs, fs = abi.parse_kernel_signatures(KERNEL_BUILD)
    assert fs == []
    assert libs == {sym: lib for lib, syms in SIGNATURES.items()
                    for sym in syms}
    decls = {}
    for cu in sorted(os.listdir(CSRC)):
        if cu.endswith(".cu"):
            ds, fs = abi.parse_extern_c(os.path.join(CSRC, cu))
            assert fs == []
            decls.update((d.name, d) for d in ds)
    assert set(decls) == set(bindings)
    for lib, syms in SIGNATURES.items():
        for sym, (argtypes, _restype) in syms.items():
            assert len(bindings[sym].argtypes) == len(argtypes)


def _mutated_kernels(tmp_path, old, new):
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    with open(KERNEL_BUILD) as f:
        src = f.read()
    assert src.count(old) == 1
    build = tmp_path / "_build.py"
    build.write_text(src.replace(old, new))
    return abi.cross_check_kernels(str(csrc), str(build))


def test_kernel_check_fires_on_a_dropped_argument(tmp_path):
    findings = _mutated_kernels(
        tmp_path,
        '"wedge_count_matrix_launch": (\n            [_P, _P, _P, _P,',
        '"wedge_count_matrix_launch": (\n            [_P, _P, _P,')
    [f] = findings
    assert f.rule == "AB003" and "wedge_count_matrix_launch" in f.message
    assert "binds 5 parameters" in f.message and "takes 6" in f.message


def test_kernel_check_fires_on_a_narrowed_width(tmp_path):
    findings = _mutated_kernels(
        tmp_path,
        "[_P, _P, _P, ctypes.c_longlong, ctypes.c_int,",
        "[_P, _P, _P, ctypes.c_int, ctypes.c_int,")
    [f] = findings
    assert f.rule == "AB004"
    assert "'sorted_window_gather_launch' parameter 3 bound as 'i32' but " \
        "declared 'i64'" in f.message


def test_kernel_check_fires_on_a_symbol_in_the_wrong_library(tmp_path):
    findings = _mutated_kernels(
        tmp_path,
        '    "row_insert": {\n        "row_insert_launch"',
        '    "hashset": {\n        "row_insert_launch"')
    # The second "hashset" key replaces the first in the dict literal's
    # evaluation but both are parsed: the moved symbol is AB002.
    assert any(f.rule == "AB002" and "row_insert_launch" in f.message
               for f in findings)


def test_extern_c_single_declarations_parse(tmp_path):
    cu = tmp_path / "k.cu"
    cu.write_text(textwrap.dedent("""\
        extern "C" int launch(const void* a, long long n, int k,
                              void* stream) {
            if (n <= 0) { return 0; }
            return k;
        }
        extern "C"  const char* err(int code);
        extern "C" {
        int block_fn(int x);
        }
    """))
    decls, fs = abi.parse_extern_c(str(cu))
    assert fs == []
    by = {d.name: d for d in decls}
    assert by["launch"].params == ["void*", "i64", "i32", "void*"]
    assert by["err"].ret == "char*" and by["err"].params == ["i32"]
    assert by["block_fn"].params == ["i32"]


# --------------------------------------------------------------------- #
# the gate

def test_tip_clean_gate_without_jax():
    code = textwrap.dedent("""\
        import sys
        from gelly_torch.analysis.__main__ import main
        rc = main(["--all", "gelly_torch"])
        assert "jax" not in sys.modules, "jax imported"
        assert "gelly_tpu" not in sys.modules, "gelly_tpu imported"
        sys.exit(rc)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "analysis clean (abi, jitlint, racecheck, contracts, " \
        "plancheck, liveness, suppressions-audit)" in proc.stdout


def test_cli_suppressions_lane_clean_on_the_port(capsys):
    assert analysis_main(["suppressions", TORCH_PKG]) == 0


@pytest.mark.parametrize("tool", ["jitlint", "plancheck"])
def test_cli_runs_the_jit_tools_clean_on_the_port(tool, capsys):
    assert analysis_main([tool, TORCH_PKG, "--root", REPO]) == 0
    out = capsys.readouterr().out
    assert f"{tool}: 0 finding(s)" in out
    assert f"analysis clean ({tool})" in out


@pytest.mark.parametrize("tool,rule", [("jitlint", "GL003"),
                                       ("plancheck", "PC202")])
def test_cli_runs_the_jit_tools_on_a_torch_fixture(tmp_path, tool, rule,
                                                   capsys):
    src = {
        "GL003": textwrap.dedent("""\
            import torch
            from gelly_torch.engine.aggregation import SummaryAggregation


            def fold(s, chunk):
                n = int(chunk.valid.sum())
                return s + n


            agg = SummaryAggregation(init=None, fold=fold, combine=None)
        """),
        "PC202": textwrap.dedent("""\
            import torch


            def step(batch, state, chunk, out):
                out.result = batch.plan.fold(state, chunk)
                return state
        """),
    }[rule]
    p = tmp_path / "fixture_mod.py"
    p.write_text(src)
    rc = analysis_main([tool, str(p), "--root", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 1 and rule in out


def test_cli_exit_code_and_json_on_findings(tmp_path, capsys):
    import json

    [racy] = dict(FIXTURE_CASES)["test_racecheck.RACY_SRC"].values()
    p = tmp_path / "fixture_mod.py"
    p.write_text(racy)
    rc = analysis_main(["racecheck", "--format=json", "--root",
                        str(tmp_path), str(p)])
    out = json.loads(capsys.readouterr().out)
    assert rc == 1 and not out["ok"]
    assert out["tools"]["racecheck"]["count"] >= 1


@pytest.mark.parametrize("rule", ["GL001", "PC101"])
def test_suppression_audit_flags_a_stale_jit_directive(tmp_path, rule):
    # GL and PC are live rule families now: a directive whose rule does
    # not fire at its line is stale (SUP002), as for every other family.
    p = tmp_path / "m.py"
    p.write_text("import torch\n"
                 f"x = 1  # graphlint: disable={rule} -- nothing fires "
                 "on this line\n")
    [f] = suppressions.audit(str(tmp_path), [str(p)])
    assert f.rule == "SUP002" and rule in f.message
    tpu = tpu_suppressions.audit(str(tmp_path), [str(p)])
    assert _norm([f], tmp_path) == _norm(tpu, tmp_path)


# --------------------------------------------------------------------- #
# RC001: the checkpoint writer's counters

def test_checkpoint_writer_stores_counters_under_the_lock(tmp_path):
    from gelly_torch.engine.resilience import CheckpointManager, Counters

    class Checked(Counters):
        def __setitem__(self, key, value):
            assert self._lock.locked(), f"{key} written without the lock"
            super().__setitem__(key, value)

    stats = Checked()
    mgr = CheckpointManager(str(tmp_path), async_write=True, stats=stats)
    mgr.save({"x": np.arange(4)}, position=1)
    mgr.flush()
    assert stats["checkpoint_writes"] == 1
    assert stats["checkpoint_write_s"] > 0


def test_racecheck_clean_on_the_fixed_writer():
    path = os.path.join(TORCH_PKG, "engine", "resilience.py")
    assert racecheck.lint_paths(REPO, [path]) == []
    native = os.path.join(TORCH_PKG, "utils", "native.py")
    assert racecheck.lint_paths(REPO, [native]) == []


# --------------------------------------------------------------------- #
# sanitizer lane

def test_sanitizer_smoke_runs_unsanitized():
    assert sanitize.smoke() == []
    assert sanitize.plan_smoke() == []


@pytest.mark.sanitize
@pytest.mark.parametrize("mode", ["asan", "ubsan"])
def test_native_folds_clean_under_sanitizer(mode):
    if not sanitize.sanitizer_available(mode):
        pytest.skip(f"{mode} runtime unavailable")
    proc = sanitize.run_smoke(mode)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert f"mode={mode}" in proc.stdout
