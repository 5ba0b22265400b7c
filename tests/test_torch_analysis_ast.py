"""The port's AST tier held to the reference's.

- Every inline fixture of tests/test_static_analysis.py (each
  `run_rule(<rule>, <source>, <path>)` call, read from that file's syntax
  tree) goes through both packages' rule with its path mapped from
  karpenter_tpu/ to karpenter_tpu_torch/ (tests/test_x.py to
  tests/test_torch_x.py): the same (rule, line) findings. `kernel-purity`
  and `tracer-leak` take the port's meaning (no host sync on the card
  path): their fixtures run with the fixture's functions declared card
  path, and the port flags the reference's findings less the ones that
  are no host sync in torch (`print`, numpy on a host value, a branch on
  a jax.numpy value).
- The torch `kernel-purity` rule on a copy of solver/tpu_runs.py: a
  `.item()` put into a card-path function is flagged, the same put into a
  `*_plain` function is not; on a copy of the sweeps' module, the lane
  scan's one counted fetch passes and a second is flagged; the counted
  seams, their manifest entries and the card windows they must sync in
  (runtime.seam_issues).
- dtype-overflow's baselined findings: the int64 guards at the 2^31 edge.
- The CLI: `--ast` exits 0 on the tree; the baseline is canonical,
  justified and not stale.
"""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from karpenter_tpu.analysis import engine as ref_engine
from karpenter_tpu_torch.analysis import engine, rules_kernel
from karpenter_tpu_torch.analysis.__main__ import main as cli

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the rules whose meaning the port changes (rules_kernel.py)
TORCH_MEANING = ("kernel-purity", "tracer-leak")


def map_path(path: str) -> str:
    """A reference path as the port's: karpenter_tpu/ -> karpenter_tpu_torch/,
    tests/test_x.py -> tests/test_torch_x.py."""
    if path.startswith("karpenter_tpu/"):
        return "karpenter_tpu_torch/" + path[len("karpenter_tpu/"):]
    if path.startswith("tests/test_") and not path.startswith("tests/test_torch_"):
        return "tests/test_torch_" + path[len("tests/test_"):]
    return path


def _reference_fixtures() -> list:
    """(test name, rule id, source, path) of every literal `run_rule` call
    in the reference's static-analysis tests."""
    with open(os.path.join(REPO_ROOT, "tests", "test_static_analysis.py"), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    out = []
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef) or not fn.name.startswith("test_"):
            continue
        for node in ast.walk(fn):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "run_rule"
                and len(node.args) == 3
                and not node.keywords
                and all(isinstance(a, ast.Constant) for a in node.args)
            ):
                rule, source, path = (a.value for a in node.args)
                out.append((fn.name, rule, source, path))
    return out


FIXTURES = _reference_fixtures()


def _findings(rules, rule_id, source, path, config, rule=None):
    rule = rule or next(r for r in rules() if r.id == rule_id)
    assert rule.applies_to(path), f"{rule_id} must target {path}"
    ctx_type = engine.FileContext if rules is engine.all_rules else ref_engine.FileContext
    ctx = ctx_type(path, path, textwrap.dedent(source), config)
    return [(f.rule, f.line) for f in rule.run(ctx)]


def test_fixtures_were_found():
    rules = {rule for _, rule, _, _ in FIXTURES}
    assert len(FIXTURES) >= 20
    assert {"shared-comparator", "kernel-purity", "tracer-leak", "dtype-overflow", "milli-units",
            "lock-discipline", "cache-invalidation", "metric-naming"} <= rules


@pytest.mark.parametrize("name,rule_id,source,path", FIXTURES, ids=[f[0] for f in FIXTURES])
def test_reference_fixture_gives_the_same_findings(name, rule_id, source, path):
    want = _findings(ref_engine.all_rules, rule_id, source, path, ref_engine.Config(repo_root=REPO_ROOT))
    port_path = map_path(path)
    config = engine.Config(repo_root=REPO_ROOT, markers=engine.load_registered_markers(os.path.join(REPO_ROOT, "pyproject.toml")))
    if rule_id not in TORCH_MEANING:
        got = _findings(engine.all_rules, rule_id, source, port_path, config)
        assert [(r, ln) for r, ln in got] == want, name
        return
    # the port's meaning: the fixture's functions declared card path
    tree = ast.parse(textwrap.dedent(source))
    names = tuple(n.name for n in tree.body if isinstance(n, ast.FunctionDef))
    cls = next(r for r in rules_kernel.RULES if r.id == rule_id)
    got = _findings(engine.all_rules, rule_id, source, port_path, config, rule=cls(loops={port_path: names}, seams={}))
    assert set(got) <= set(want), name
    lines = textwrap.dedent(source).splitlines()
    for _, ln in sorted(set(want) - set(got)):
        # what the port leaves out is no host sync in torch: print, numpy
        # on a host value, a branch on a jax.numpy value
        assert any(t in lines[ln - 1] for t in ("print(", "np.", "jnp.")), (name, lines[ln - 1])


# ---------------------------------------------------------------------------
# kernel-purity on the card paths of solver/tpu_runs.py and the sweeps


def _copy_findings(tmp_path, edit, rel: str = "karpenter_tpu_torch/solver/tpu_runs.py") -> list:
    """kernel-purity's and tracer-leak's findings on a copy of `rel`
    (solver/tpu_runs.py by default) after `edit(source)`."""
    with open(os.path.join(REPO_ROOT, rel), encoding="utf-8") as f:
        source = edit(f.read())
    dst = tmp_path / rel
    dst.parent.mkdir(parents=True, exist_ok=True)
    dst.write_text(source)
    shutil.copy(os.path.join(REPO_ROOT, "torch_budgets.json"), tmp_path / "torch_budgets.json")
    report = engine.run_analysis(str(tmp_path), paths=[str(dst)], baseline_path=str(tmp_path / "none.json"),
                                 rule_ids={"kernel-purity", "tracer-leak"})
    assert report["errors"] == []
    return report["findings"]


_LAUNCH = '    lib, args_type = K.step_library("run_step")\n'
_PLAIN = '    w = _Walk(tb, st, rx, seq, next_seq, relax)\n'


def test_kernel_purity_flags_item_on_the_card_path(tmp_path):
    assert _copy_findings(tmp_path, lambda s: s) == []
    got = _copy_findings(tmp_path, lambda s: s.replace(_LAUNCH, _LAUNCH + "    probe_n = seq.sum().item()\n"))
    assert [(f.rule, f.text) for f in got] == [("kernel-purity", "probe_n = seq.sum().item()")]
    assert "_launch_run_step()" in got[0].message
    branch = "    if bool(rx.bulk.any()):\n        pass\n"
    got = _copy_findings(tmp_path, lambda s: s.replace(_LAUNCH, _LAUNCH + branch))
    assert sorted(f.rule for f in got) == ["kernel-purity", "tracer-leak"]


def test_kernel_purity_passes_the_plain_versions(tmp_path):
    assert _PLAIN in open(os.path.join(REPO_ROOT, "karpenter_tpu_torch/solver/tpu_runs.py")).read()
    got = _copy_findings(tmp_path, lambda s: s.replace(_PLAIN, _PLAIN + "    probe_n = seq.sum().item()\n"))
    assert got == []
    # the seam wrapper's CPU branch runs the plain version: not card path
    wrapper = '    if st.rank.device.type == "cpu":\n        return solve_runs_plain('
    got = _copy_findings(tmp_path, lambda s: s.replace(wrapper, wrapper.replace("return", "seq.tolist()\n        return")))
    assert got == []


_SWEEP = "karpenter_tpu_torch/controllers/disruption/sweep.py"
_FETCH = "        host = torch.cat([c.to(torch.int32) for c in cols], dim=1).cpu().numpy()\n"


def test_lane_scan_fetch_is_one_counted_seam(tmp_path):
    """The full-state lane scan's one packed fetch is a counted seam,
    counted by cuda:sweep_lanes[runtime]: the tree's source gives no
    finding; a second fetch put beside it gives one kernel-purity
    finding; the baseline keeps no kernel-purity entry of sweep.py."""
    assert _FETCH in open(os.path.join(REPO_ROOT, _SWEEP)).read()
    assert rules_kernel.COUNTED_SEAMS[(_SWEEP, "_lane_scan_feasibility")]["entry"] == "cuda:sweep_lanes[runtime]"
    assert _copy_findings(tmp_path, lambda s: s, _SWEEP) == []
    got = _copy_findings(tmp_path, lambda s: s.replace(_FETCH, _FETCH + "        n_over = int(over.sum())\n"), _SWEEP)
    assert [(f.rule, f.text) for f in got] == [("kernel-purity", "n_over = int(over.sum())")]
    assert "_lane_scan_feasibility()" in got[0].message and "no counted seam names it" in got[0].message
    base = engine.Baseline.load(os.path.join(REPO_ROOT, engine.DEFAULT_BASELINE))
    assert not [e for e in base.entries if e["path"] == _SWEEP and e["rule"] == "kernel-purity"]


def test_counted_seams_name_live_manifest_entries():
    with open(os.path.join(REPO_ROOT, "torch_budgets.json"), encoding="utf-8") as f:
        entries = json.load(f)["entries"]
    for (path, fn), seam in rules_kernel.COUNTED_SEAMS.items():
        assert os.path.exists(os.path.join(REPO_ROOT, path)), path
        assert "host_syncs" in entries[seam["entry"]]["metrics"], (path, fn)
        assert seam["why"].strip()


def _seam_sites() -> dict:
    """{entry: {"sync_sites": ...}} as a card window whose every counted
    seam synced once, on the seam function's first line, would record."""
    detail: dict = {}
    for (path, fn), seam in rules_kernel.COUNTED_SEAMS.items():
        with open(os.path.join(REPO_ROOT, path), encoding="utf-8") as f:
            line = rules_kernel._functions(ast.parse(f.read()))[fn].lineno
        site = "/".join(path.split("/")[-2:]) + f":{line}"
        detail.setdefault(seam["entry"], {"sync_sites": {}})["sync_sites"][site] = 1
    return detail


def test_a_counted_seam_must_sync_in_the_window_it_names():
    """runtime.seam_issues, which the card's budgets check runs over the
    windows' sync-debug sites: a seam is held to the window of the entry
    it names. Its sync seen there is no issue; its sync seen only in
    another window, or a window that saw none, is an `unseen-seam`."""
    from karpenter_tpu_torch.analysis import runtime

    detail = _seam_sites()
    assert runtime.seam_issues(detail) == []
    key = ("karpenter_tpu_torch/solver/tpu_runs.py", "_launch_run_step")
    entry = rules_kernel.COUNTED_SEAMS[key]["entry"]
    site = next(s for s in detail[entry]["sync_sites"] if s.startswith("solver/tpu_runs.py:"))
    del detail[entry]["sync_sites"][site]
    detail.setdefault("cuda:solve[runtime]", {"sync_sites": {}})["sync_sites"][site] = 1
    line = int(site.rpartition(":")[2])
    detail[entry]["sync_sites"][f"solver/tpu_runs.py:{line - 1}"] = 1  # the line above the function
    got = runtime.seam_issues(detail)
    assert [(i.kind, i.entry, i.metric) for i in got] == [("unseen-seam", entry, "solver/tpu_runs.py _launch_run_step")]
    assert "made no host sync" in got[0].render()
    assert len(runtime.seam_issues({})) == len(rules_kernel.COUNTED_SEAMS)


def test_counted_seam_with_a_missing_entry_or_a_stale_sync_is_a_finding(tmp_path):
    rel = "karpenter_tpu_torch/solver/tpu_runs.py"
    seams = dict(rules_kernel.COUNTED_SEAMS)
    key = (rel, "_launch_run_step")
    rule = rules_kernel.KernelPurityRule(seams={**seams, key: {**seams[key], "entry": "cuda:gone[runtime]"}})
    ctx = engine.FileContext(rel, rel, open(os.path.join(REPO_ROOT, rel)).read(), engine.Config(repo_root=REPO_ROOT))
    got = rule.run(ctx)
    assert len(got) == 1 and "cuda:gone[runtime]" in got[0].message
    rule = rules_kernel.KernelPurityRule(seams={**seams, key: {**seams[key], "syncs": ("int(next_seq)", ".item()")}})
    got = rule.run(ctx)
    assert len(got) == 1 and "no longer makes" in got[0].message and ".item()" in got[0].message


def test_card_path_covers_every_launch_and_seam_wrapper():
    """Every function that launches a kernel or picks between its plain
    version and its kernel is card path."""
    for rel in rules_kernel.KERNEL_MODULES:
        with open(os.path.join(REPO_ROOT, rel), encoding="utf-8") as f:
            tree = ast.parse(f.read())
        path = rules_kernel.card_path(tree, rel)
        for name, fn in rules_kernel._functions(tree).items():
            src = ast.unparse(fn)
            if "budgets.seam(" in src or "budgets.launched(" in src:
                assert name in path, (rel, name)
            if name.endswith("_plain"):
                assert name not in path, (rel, name)


# ---------------------------------------------------------------------------
# dtype-overflow: the int64 guards at the 2^31 edge


def test_capacity_guard_at_the_2_31_edge():
    from karpenter_tpu_torch.controllers.disruption import sweep

    sizes = np.ones((2, 3), np.int32)
    edge = np.array([[1 << 30] * 3, [(1 << 30) - 1] * 3, [-1, 5, 5]], np.int64)  # a removed row counts 0
    assert sweep.capacity_cumsum_fits_int32(edge, sizes)
    edge[1] += 1  # the per-class total reaches 2^31
    assert not sweep.capacity_cumsum_fits_int32(edge, sizes)
    # the bound is exact: an int32 cumsum of that total wraps
    assert int(torch.cumsum(torch.tensor([1 << 30, 1 << 30], dtype=torch.int32), 0, dtype=torch.int32)[-1]) < 0


def test_plain_sweep_core_is_exact_up_to_the_guard(monkeypatch):
    """fast_sweep_plain (the plain core both flagged functions share) on
    a real fleet's tables with per-node capacities summing to 2^31 - 1,
    which the guards admit: every leftover equals the int64 count."""
    from karpenter_tpu_torch.controllers.disruption import sweep
    from karpenter_tpu_torch.controllers.disruption.consolidation import MultiNodeConsolidation
    from karpenter_tpu_torch.solver import tpu_runs as KR
    from karpenter_tpu_torch.testing import fixtures

    captured = []
    real = sweep.fast_sweep
    monkeypatch.setattr(sweep, "fast_sweep", lambda *a, **k: captured.append(a) or real(*a, **k))
    op = fixtures.underutilized_operator(5, seed=7, force_oracle=True, max_ticks=120)
    mnc = MultiNodeConsolidation(op.kube, op.cluster, op.cloud, op.clock, options=op.opts, force_oracle=True)
    sweep.prefix_feasibility(op.kube, op.cluster, op.cloud, mnc.candidates(), op.opts, device="cpu")
    tb, st, xs, avail0, cand_idx, _, _ = captured[0]
    E, R = avail0.shape
    caps = np.zeros(E, np.int64)
    caps[0], caps[-1] = 1 << 30, (1 << 30) - 1
    avail = torch.from_numpy(np.repeat(caps[:, None], R, 1).astype(np.int32))
    sizes = torch.ones((1, R), dtype=torch.int32)
    assert sweep.capacity_cumsum_fits_int32(avail.numpy(), sizes.numpy())
    counts = torch.tensor([[(1 << 30) - 7], [(1 << 29) + 3]], dtype=torch.int32)  # worst_tot < 2^30
    never = torch.full((E,), 1 << 30, dtype=torch.int32)
    _, _, left = sweep.fast_sweep_plain(tb, st, sweep._row0(xs), avail, never, counts, sizes, with_left=True)
    ok_e = KR._build_cache(tb, st, sweep._row0(xs)).ok_e.numpy()
    cap = np.where(ok_e, caps, 0)
    before = np.cumsum(cap) - cap
    for b, n in enumerate(counts[:, 0].tolist()):
        take = np.minimum(np.maximum(n - before, 0), cap)
        assert int(left[b, 0]) == n - int(take.sum())


# ---------------------------------------------------------------------------
# the tree


def test_ast_tier_exits_0_on_the_tree(capsys):
    assert cli(["--ast", "--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["findings"] == [] and payload["errors"] == []
    assert payload["stale_baseline"] == [] and payload["unjustified_baseline"] == []
    assert payload["baselined"] == len(engine.Baseline.load(os.path.join(REPO_ROOT, engine.DEFAULT_BASELINE)).entries)


def test_ast_cli_exit_codes(tmp_path, capsys):
    bad = tmp_path / "karpenter_tpu_torch" / "controllers" / "bad.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("def shave(requests):\n    return requests['cpu'] / 2\n")
    assert cli(["--ast", "--root", str(tmp_path)]) == 1
    assert "[milli-units]" in capsys.readouterr().out
    assert cli(["--ast", "--rules", "milli-unitz"]) == 2
    broken = tmp_path / "b.json"
    broken.write_text("{")
    assert cli(["--ast", "--baseline", str(broken)]) == 2
    assert cli(["--ast", "--race"]) == 2


def test_baselines_are_canonical_and_justified():
    for name in (engine.DEFAULT_BASELINE, engine.RACE_DEFAULT_BASELINE):
        path = os.path.join(REPO_ROOT, name)
        with open(path, encoding="utf-8") as f:
            content = f.read()
        assert engine.canonical_json(json.loads(content)) == content, name
        assert engine.Baseline.load(path).unjustified() == [], name


def test_discovery_covers_the_port_and_never_the_reference():
    files = [os.path.relpath(p, REPO_ROOT) for p in engine.discover_files(REPO_ROOT)]
    assert "chip_smoke.py" in files and "tests/test_torch_analysis_ast.py" in files
    assert any(f.startswith("tools/") and f.endswith("_phase.py") for f in files)
    assert not any(f.startswith("karpenter_tpu/") or f == "tests/test_static_analysis.py" for f in files)


def test_analysis_tiers_import_stdlib_only():
    probe = (
        "import sys\n"
        "from karpenter_tpu_torch.analysis import engine, locks, racert, proto, protorec, __main__\n"
        "from karpenter_tpu_torch.analysis import rules_data, rules_docs, rules_kernel, rules_metrics, rules_threads, rules_wire\n"
        "print(sorted(m for m in ('torch', 'numpy', 'jax', 'karpenter_tpu') if m in sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO_ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
