"""gelly_torch.analysis.plancheck against gelly_tpu's, and its PyTorch rules.

A module that imports ``jax`` (or neither package) is read as
``gelly_tpu``'s plancheck reads it: on every module constant of
``tests/test_plancheck.py`` (``AGG_SRC``, ``VALIDATOR_SRC``,
``FUSE_SRC``, each ``PC*_SRC``, the ``_RULE_SEEDS`` file sets) and on
the ``gelly_tpu/`` tree the port's findings equal ``gelly_tpu``'s. A
module of the port is read in the PyTorch vocabulary (the ``cache.get``
probe, in-place writes for donation, ``dst.copy_(torch.where(...))``
masked selects, the port's ``REFUSAL_MATRIX``): each rule PC101-PC402
fires on a torch fixture and not on its clean twin, the port's tree is
clean, every matrix entry resolves, and three seeded flips of the port's
real files fire: ``stack_ordered`` stripped from ``fuse`` (PC401), a
member dropped from ``_compiled_tenant_plan``'s key (PC101), and the
hit guard's device check dropped (PC103). The tenant plan keyed on its
lane form rebuilds when the form is replaced, with the same stacks.
"""

import ast
import importlib
import os
import sys
import textwrap

import numpy as np
import pytest

from gelly_torch.analysis import plancheck, suppressions
from gelly_torch.analysis.__main__ import main as analysis_main
from gelly_tpu.analysis import plancheck as tpu_plancheck
from gelly_tpu.analysis import suppressions as tpu_suppressions

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TESTS = os.path.join(REPO, "tests")
TPU_PKG = os.path.join(REPO, "gelly_tpu")
TORCH_PKG = os.path.join(REPO, "gelly_torch")
PORT_AGG = os.path.join(TORCH_PKG, "engine", "aggregation.py")
PORT_MQ = os.path.join(TORCH_PKG, "engine", "multiquery.py")


def _test_module(name):
    if TESTS not in sys.path:
        sys.path.insert(0, TESTS)
    return importlib.import_module(name)


def _parses(src) -> bool:
    if not isinstance(src, str):
        return False
    try:
        ast.parse(src)
    except SyntaxError:
        return False
    return True


def _jax_cases():
    """Every module constant of tests/test_plancheck.py that is a Python
    source, as ``fixture_mod.py`` and as ``multiquery.py``, and each
    ``_RULE_SEEDS`` file set."""
    mod = _test_module("test_plancheck")
    out = []
    for k, v in sorted(vars(mod).items()):
        if k.startswith("__") or not _parses(v) or "\n" not in v:
            continue
        for name in ("fixture_mod.py", "multiquery.py"):
            out.append((f"{k}:{name}", {name: v}))
    for rule, files in sorted(mod._RULE_SEEDS.items()):
        out.append((f"_RULE_SEEDS.{rule}", dict(files)))
    out.append(("AGG_SRC+VALIDATOR_SRC", {
        "fixture_mod.py": mod.PC101_SRC.replace(
            "agg.merge_degree)", "agg.merge_mode, agg.merge_degree)", 1),
        "validators.py": mod.VALIDATOR_SRC}))
    return out


JAX_CASES = _jax_cases()


def _norm(findings, base):
    return sorted((os.path.relpath(f.path, base), f.line, f.rule, f.message)
                  for f in findings)


def _write(d, files):
    paths = []
    for name, src in files.items():
        p = d / name
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src)
        paths.append(str(p))
    return paths


def _lint(d, files):
    return plancheck.lint_paths(str(d), _write(d, files))


def _absent(f) -> bool:
    """A PC402 for a matrix module this fixture's package lacks."""
    return f.rule == "PC402" and "is absent from the linted" in f.message


def _lint_engine(d, files):
    """A fixture in an ``engine`` package: the other matrix modules of
    the package are absent by construction."""
    return [f for f in _lint(d, files) if not _absent(f)]


def _line_of(src, marker):
    for i, line in enumerate(src.splitlines(), 1):
        if marker in line:
            return i
    raise AssertionError(f"marker {marker!r} not in fixture")


# --------------------------------------------------------------------- #
# the JAX vocabulary: gelly_tpu's findings exactly

def test_fixture_harvest_is_not_vacuous():
    names = {n.split(":")[0] for n, _ in JAX_CASES}
    assert {"AGG_SRC", "VALIDATOR_SRC", "FUSE_SRC", "PC101_SRC",
            "PC203_SRC", "PC302_SRC"} <= names
    assert sum(n.startswith("_RULE_SEEDS") for n, _ in JAX_CASES) == 10


@pytest.mark.parametrize("case", [n for n, _ in JAX_CASES])
def test_matches_gelly_tpu_on_fixture(tmp_path, case):
    paths = _write(tmp_path, dict(JAX_CASES)[case])
    got = _norm(plancheck.lint_paths(str(tmp_path), paths), tmp_path)
    want = _norm(tpu_plancheck.lint_paths(str(tmp_path), paths), tmp_path)
    assert got == want


def test_fixtures_fire_every_jax_rule(tmp_path):
    rules = set()
    for i, (_case, files) in enumerate(JAX_CASES):
        d = tmp_path / str(i)
        d.mkdir()
        rules |= {f.rule for f in _lint(d, files)}
    assert rules == set(plancheck.RULES)


@pytest.mark.parametrize("ignore", [False, True],
                         ids=["directives", "no-directives"])
def test_matches_gelly_tpu_on_its_tree(ignore):
    if ignore:
        with suppressions.ignoring_suppressions(), \
                tpu_suppressions.ignoring_suppressions():
            got = plancheck.lint_paths(REPO, [TPU_PKG])
            want = tpu_plancheck.lint_paths(REPO, [TPU_PKG])
    else:
        got = plancheck.lint_paths(REPO, [TPU_PKG])
        want = tpu_plancheck.lint_paths(REPO, [TPU_PKG])
    assert _norm(got, REPO) == _norm(want, REPO)


def test_jax_matrix_is_gelly_tpus():
    assert plancheck.JAX_REFUSAL_MATRIX == tpu_plancheck.REFUSAL_MATRIX


# --------------------------------------------------------------------- #
# the PyTorch vocabulary: each rule both ways

AGG = textwrap.dedent('''\
    import dataclasses
    from typing import Any, Callable

    import torch


    @dataclasses.dataclass
    class SummaryAggregation:
        name: str
        init: Callable[[], Any]
        fold: Callable[[Any, Any], Any]
        fold_backend: str = "plain"
        merge_mode: str = "replicated"
        merge_degree: int = 8
        lane_form: Any = None


    def resolve(agg):
        if agg.merge_mode not in ("replicated", "delta"):
            raise ValueError("unknown merge_mode")
        if agg.fold_backend not in ("plain", "kernel"):
            raise ValueError("unknown fold_backend")


''')

BUILDER = AGG + textwrap.dedent('''\
    def _write_rows(stack, rows, new):
        stack[rows].copy_(new)


    def _compiled_tenant_plan(agg, lanes, *, device="cpu", width=None):
        key = ("tenants", lanes, agg.fold_backend, agg.merge_mode)  # K
        per_agg = agg.__dict__.setdefault("_plan_cache", {})
        hit = per_agg.get(key)
        if hit is not None and hit.device == device and hit.width == width:
            return hit
        form = agg.lane_form  # M-PC101

        def fold(state, stacked, active):
            _write_rows(state, 0, agg.fold(state, stacked))
            return state

        def snapshot_fn(s):
            return s  # M-PC201

        plan = (fold, snapshot_fn, form, device, width)
        per_agg[key] = plan
        return plan
''')


def test_pc101_unkeyed_knob_through_the_get_probe(tmp_path):
    findings = _lint(tmp_path, {"fixture_mod.py": BUILDER.replace(
        "return s  # M-PC201",
        "return s.clone()")})
    assert [(f.rule, f.line) for f in findings] \
        == [("PC101", _line_of(BUILDER, "M-PC101"))], \
        "\n".join(f.render() for f in findings)
    assert "agg.lane_form" in findings[0].message


def test_pc101_keyed_knob_is_clean(tmp_path):
    src = BUILDER.replace("agg.merge_mode)  # K",
                          "agg.merge_mode, agg.lane_form)") \
        .replace("return s  # M-PC201", "return s.clone()")
    assert _lint(tmp_path, {"fixture_mod.py": src}) == []


def test_pc201_in_place_builder_snapshot_without_a_copy(tmp_path):
    src = BUILDER.replace("agg.merge_mode)  # K",
                          "agg.merge_mode, agg.lane_form)")
    findings = _lint(tmp_path, {"fixture_mod.py": src})
    assert [f.rule for f in findings] == ["PC201"], \
        "\n".join(f.render() for f in findings)
    assert "'snapshot_fn'" in findings[0].message


def test_pc201_inactive_without_in_place_writes(tmp_path):
    src = BUILDER.replace("agg.merge_mode)  # K",
                          "agg.merge_mode, agg.lane_form)").replace(
        "_write_rows(state, 0, agg.fold(state, stacked))\n"
        "        return state",
        "return agg.fold(state, stacked)")
    assert _lint(tmp_path, {"fixture_mod.py": src}) == []


def test_pc102_unvalidated_str_knob(tmp_path):
    src = BUILDER.replace("agg.merge_mode)  # K",
                          "agg.merge_mode, agg.lane_form)") \
        .replace("return s  # M-PC201", "return s.clone()") \
        .replace('    if agg.merge_mode not in ("replicated", "delta"):\n'
                 '        raise ValueError("unknown merge_mode")\n', "")
    findings = _lint(tmp_path, {"fixture_mod.py": src})
    assert [(f.rule, f.line) for f in findings] \
        == [("PC102", _line_of(src, "key = ("))], \
        "\n".join(f.render() for f in findings)
    assert "merge_mode" in findings[0].message


def test_pc103_hit_guard_is_part_of_the_key(tmp_path):
    # `device` and `width` reach no key member, but the hit guard
    # compares both: a hit equals the call on them (the port's tenant
    # plan). Drop the guard's width check and PC103 names width.
    clean = BUILDER.replace("agg.merge_mode)  # K",
                            "agg.merge_mode, agg.lane_form)") \
        .replace("return s  # M-PC201", "return s.clone()")
    assert _lint(tmp_path, {"fixture_mod.py": clean}) == []
    flipped = clean.replace(" and hit.width == width", "")
    findings = _lint(tmp_path, {"fixture_mod.py": flipped})
    assert [f.rule for f in findings] == ["PC103"], \
        "\n".join(f.render() for f in findings)
    assert "'width'" in findings[0].message


TENANT_ROUND = textwrap.dedent('''\
    import torch


    def round_ok(batch, dev, act):
        fold = batch.plan.fold_codec if batch.compressed else batch.plan.fold
        batch.state = fold(batch.state, dev, act)
        return batch.state


    def round_bad(batch, dev, act, sink):
        fold = batch.plan.fold_codec if batch.compressed else batch.plan.fold
        sink.append(fold(batch.state, dev, act))  # M-PC202
        return batch.state


    def publish(batch, store, dev, act):
        store.latest = batch.state  # M-PC203
        batch.state = batch.plan.fold(batch.state, dev, act)
        store.snapshot = batch.plan.snapshot(batch.state)
''')


def test_pc202_pc203_in_place_tenant_fold(tmp_path):
    findings = _lint(tmp_path, {"fixture_mod.py": TENANT_ROUND})
    assert sorted((f.rule, f.line) for f in findings) == [
        ("PC202", _line_of(TENANT_ROUND, "M-PC202")),
        ("PC203", _line_of(TENANT_ROUND, "M-PC203"))], \
        "\n".join(f.render() for f in findings)


def test_pc202_pc203_clean_twin(tmp_path):
    src = TENANT_ROUND.replace(
        "    sink.append(fold(batch.state, dev, act))  # M-PC202\n",
        "    batch.state = fold(batch.state, dev, act)\n"
        "    sink.append(batch.plan.snapshot(batch.state))\n").replace(
        "    store.latest = batch.state  # M-PC203\n",
        "    store.latest = batch.plan.snapshot(batch.state)\n")
    assert _lint(tmp_path, {"fixture_mod.py": src}) == []


SELECT_ROWS = textwrap.dedent('''\
    import torch


    def _select_rows(stack, rows, new, keep):
        for old, val in zip(stack, new):
            block = old[rows]
            mask = keep.view((-1,) + (1,) * (block.dim() - 1))
            block.copy_(torch.where(mask, val, block))  # M


    _WIDTH = 8


    def _select_fixed(stack, new):
        mask = torch.arange(_WIDTH) < 4
        for old, val in zip(stack, new):
            old.copy_(torch.where(mask, val, old))  # M2
''')


def test_pc301_pc302_in_place_masked_select(tmp_path):
    assert [f.rule for f in _lint(tmp_path, {"fixture_mod.py": SELECT_ROWS})] \
        == ["PC302"]
    drift = SELECT_ROWS.replace("torch.where(mask, val, block))",
                                "torch.where(mask, val, block + 0))")
    findings = _lint(tmp_path, {"fixture_mod.py": drift})
    assert sorted((f.rule, f.line) for f in findings) == [
        ("PC301", _line_of(drift, "# M")),
        ("PC302", _line_of(drift, "# M2"))], \
        "\n".join(f.render() for f in findings)
    clean = SELECT_ROWS.replace("mask = torch.arange(_WIDTH) < 4",
                                "mask = new[0] > 0")
    assert _lint(tmp_path, {"fixture_mod.py": clean}) == []


TORCH_FUSE = "import torch\n\n\n" + _test_module("test_plancheck").FUSE_SRC


def test_pc401_pc402_on_the_port_matrix(tmp_path):
    # The port's matrix binds (engine/multiquery.py, fuse): in its home
    # package only.
    assert _lint_engine(tmp_path, {"engine/multiquery.py": TORCH_FUSE}) \
        == []
    stripped = TORCH_FUSE.replace(
        '        if codec is not None and codec.stack_ordered:\n'
        '            raise ValueError("stack_ordered codecs are '
        'unsupported")\n', "")
    findings = _lint_engine(tmp_path, {"engine/multiquery.py": stripped})
    assert [(f.rule, f.line) for f in findings] \
        == [("PC401", _line_of(stripped, "M-PC401"))], \
        "\n".join(f.render() for f in findings)
    renamed = TORCH_FUSE.replace("def fuse(", "def fuse_all(")
    findings = _lint_engine(tmp_path, {"engine/multiquery.py": renamed})
    assert [(f.rule, f.line) for f in findings] == [("PC402", 1)]
    # Outside its home package the same basename is another module.
    assert _lint(tmp_path, {"examples/multiquery.py": stripped}) == []


def test_early_return_and_getattr_guards_reach_the_matrix(tmp_path):
    src = textwrap.dedent('''\
        import torch


        def _check(agg, ttl_panes, windowed, prefetch_depth):
            if ttl_panes is None:
                return
            if windowed is None:
                raise ValueError("ttl needs a ring")
            if getattr(agg, "windowed_evict", None) is None:
                raise ValueError("no eviction hooks")
            if prefetch_depth != 0:
                raise ValueError("quiesce the pipeline")


        def run_aggregation(agg, window_ms=None, ttl_panes=None,
                            windowed=None, prefetch_depth=2):
            _check(agg, ttl_panes, windowed, prefetch_depth)
    ''')
    findings = _lint_engine(tmp_path, {"engine/aggregation.py": src})
    labels = {f.message.split("[")[1].split("]")[0] for f in findings
              if f.rule == "PC401"}
    ttl = {"ttl without a windowed pane ring", "ttl without the eviction "
           "hooks", "ttl x pipeline lookahead"}
    assert not labels & ttl, labels
    assert "windowed x window_ms" in labels


# --------------------------------------------------------------------- #
# the port's tree

def test_tip_clean_on_the_port():
    findings = plancheck.lint_paths(REPO, [TORCH_PKG])
    assert findings == [], "\n".join(f.render() for f in findings)


def test_port_builder_and_knob_discovery_not_vacuous():
    c = plancheck.PlanChecker(REPO)
    c.lint_paths([TORCH_PKG])
    agg_mod = c._modules[PORT_AGG]
    assert agg_mod.torch
    assert {b.fn.name for b in c._find_builders(agg_mod)} \
        == {"_compiled_tenant_plan"}
    assert {"merge_mode", "fold_backend", "transient", "lane_form",
            "stack_ordered"} <= c._scalar_knobs
    assert {"merge_mode", "fold_backend"} <= c._str_knobs


def test_port_matrix_keeps_every_gelly_tpu_row():
    tpu = tpu_plancheck.REFUSAL_MATRIX
    port = plancheck.REFUSAL_MATRIX
    moved = {("aggregation.py", "_compiled_plan"):
             ("aggregation.py", "_check_merge_knobs")}
    assert {moved.get(k, k) for k in tpu} == set(port)
    for key, rows in tpu.items():
        assert port[moved.get(key, key)] == rows, key


def test_port_matrix_entry_points_all_resolve():
    c = plancheck.PlanChecker(REPO)
    findings = c.lint_paths([TORCH_PKG])
    assert [f for f in findings if f.rule.startswith("PC4")] == []
    for base, fname in plancheck.REFUSAL_MATRIX:
        home = plancheck._MATRIX_DIRS[base]
        path = os.path.join(TORCH_PKG, home, base)
        with open(path) as f:
            tree = ast.parse(f.read())
        assert fname in {n.name for n in ast.walk(tree)
                         if isinstance(n, ast.FunctionDef)}, (base, fname)


def _flip(tmp_path, path, old, new, home):
    with open(path) as f:
        src = f.read()
    assert src.count(old) == 1, f"{old!r} moved: re-anchor"
    d = tmp_path / home
    clean = plancheck.lint_paths(
        str(tmp_path), _write(tmp_path, {f"{home}/{os.path.basename(path)}":
                                         src}))
    flipped = plancheck.lint_paths(
        str(tmp_path), _write(tmp_path, {f"{home}/{os.path.basename(path)}":
                                         src.replace(old, new)}))
    assert d.is_dir()
    return clean, flipped


def test_seeded_flip_fuse_without_stack_ordered(tmp_path):
    # Renaming the eligibility token out of fuse()'s guards (the shape a
    # refactor that drops the refusal produces) flags exactly that row.
    with open(PORT_MQ) as f:
        src = f.read()
    assert "stack_ordered" in src
    d = tmp_path / "engine"
    [p] = _write(tmp_path, {"engine/multiquery.py": src})
    assert [f for f in plancheck.lint_paths(str(tmp_path), [p])
            if f.rule.startswith("PC4") and not _absent(f)] == []
    [p] = _write(tmp_path, {"engine/multiquery.py": src.replace(
        "stack_ordered", "stack_reordered")})
    pc401 = [f for f in plancheck.lint_paths(str(tmp_path), [p])
             if f.rule == "PC401"]
    assert len(pc401) == 1 and "stack_ordered" in pc401[0].message, \
        "\n".join(f.render() for f in pc401)
    assert d.is_dir()


def test_seeded_flip_tenant_key_member_dropped(tmp_path):
    clean, flipped = _flip(
        tmp_path, PORT_AGG,
        "agg.merge_mode, mesh_key,\n           agg.lane_form)",
        "agg.merge_mode, mesh_key)", "engine")
    assert [f for f in clean if f.rule == "PC101"] == []
    pc101 = [f for f in flipped if f.rule == "PC101"]
    assert len(pc101) == 1 and "agg.lane_form" in pc101[0].message \
        and "'_compiled_tenant_plan'" in pc101[0].message, \
        "\n".join(f.render() for f in flipped)


def test_seeded_flip_tenant_hit_guard_device_dropped(tmp_path):
    clean, flipped = _flip(
        tmp_path, PORT_AGG, "hit is not None and hit.device == dev\n",
        "hit is not None\n", "engine")
    assert [f for f in clean if f.rule == "PC103"] == []
    pc103 = [f for f in flipped if f.rule == "PC103"]
    assert [f.message.split("'")[1] for f in pc103] == ["device"], \
        "\n".join(f.render() for f in flipped)


# --------------------------------------------------------------------- #
# the fix: the tenant plan keyed on its lane form

def test_tenant_plan_rebuilds_when_the_lane_form_is_replaced():
    import torch

    from gelly_torch.core.chunk import make_chunk
    from gelly_torch.engine.aggregation import _compiled_tenant_plan
    from gelly_torch.engine.checkpoint import tree_flatten
    from gelly_torch.library.connected_components import cc_tenant_tier

    agg, cap = cc_tenant_tier(64, chunk_capacity=16)
    batched = _compiled_tenant_plan(agg, 4, device="cpu",
                                    chunk_capacity=cap)
    assert batched.forms["fold"] == "lane-batched"
    assert _compiled_tenant_plan(agg, 4, device="cpu",
                                 chunk_capacity=cap) is batched
    form = agg.lane_form
    agg.lane_form = None  # replaced on the live aggregation
    by_lane = _compiled_tenant_plan(agg, 4, device="cpu", chunk_capacity=cap)
    assert by_lane is not batched and by_lane.forms["fold"] == "lane-by-lane"
    agg.lane_form = form
    assert _compiled_tenant_plan(agg, 4, device="cpu",
                                 chunk_capacity=cap) is batched
    # Both forms fold a round to the same stack.
    rng = np.random.default_rng(3)
    rows = [make_chunk(rng.integers(0, 64, cap).astype(np.int32),
                       rng.integers(0, 64, cap).astype(np.int32),
                       capacity=cap, device="cpu") for _ in range(4)]
    stacked = type(rows[0])(*(torch.stack([getattr(r, f) for r in rows])
                              for f in rows[0]._fields))
    active = np.array([True, False, True, True])
    outs = []
    for plan in (batched, by_lane):
        state = plan.fold(plan.init(), stacked, active)
        outs.append([x.numpy() for x in tree_flatten(state)[0]])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------- #
# the CLI

def test_cli_list_rules_and_sarif_carry_both_families(capsys):
    import json

    assert analysis_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rid in list(plancheck.RULES) + [f"GL00{i}" for i in range(1, 8)]:
        assert rid in out, rid
    assert "torch: uncounted host sync" in out
    rc = analysis_main(["plancheck", TORCH_PKG, "--root", REPO,
                        "--format=sarif"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0
    ids = {r["id"] for r in doc["runs"][0]["tool"]["driver"]["rules"]}
    assert set(plancheck.RULES) <= ids and "GL007" in ids


def test_cli_skip_flags(tmp_path, capsys):
    import json

    p = tmp_path / "fixture_mod.py"
    p.write_text(TENANT_ROUND.replace("round_bad", "round_other").replace(
        "    sink.append(fold(batch.state, dev, act))  # M-PC202\n"
        "    return batch.state\n",
        "    sink.append(fold(batch.state, dev, act))  # M-PC202\n"))
    rc = analysis_main(["--all", str(p), "--root", str(tmp_path),
                        "--skip-abi", "--skip-jitlint", "--skip-racecheck",
                        "--skip-contracts", "--skip-liveness",
                        "--format=json"])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 1 and set(payload["tools"]) == {"plancheck"}
    rc = analysis_main(["--all", str(p), "--root", str(tmp_path),
                        "--skip-abi", "--skip-plancheck", "--format=json"])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 0 and set(payload["tools"]) == {
        "jitlint", "racecheck", "contracts", "liveness"}
