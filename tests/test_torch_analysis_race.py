"""The port's race tier held to the reference's.

- Every whole-program fixture of tests/test_race_analysis.py (each
  `race_findings(tmp_path, <files>, rule_ids=...)` call, read from that
  file's syntax tree) is written into two throwaway trees, the reference's
  paths in one and the port's (karpenter_tpu/ -> karpenter_tpu_torch/) in
  the other: both static halves give the same findings (rule, path, line
  and message, paths mapped).
- The port's blocking set: torch's host syncs under a lock in a module
  that imports torch, `.synchronize()` anywhere.
- A scripted two-thread lock inversion is reported by both witnesses with
  the same creation sites; the port's witness also keeps long holds and
  background-thread exceptions.
- `--race` exits 0 on the tree.
"""

from __future__ import annotations

import ast
import json
import os
import textwrap
import threading
import time

import pytest

from karpenter_tpu.analysis import locks as ref_locks
from karpenter_tpu.analysis import racert as ref_racert
from karpenter_tpu_torch.analysis import locks, racert
from karpenter_tpu_torch.analysis.__main__ import main as cli

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def map_path(path: str) -> str:
    if path.startswith("karpenter_tpu/"):
        return "karpenter_tpu_torch/" + path[len("karpenter_tpu/"):]
    return path


def _literal(node: ast.AST, fn: ast.FunctionDef):
    """A literal argument, or the literal a Name in `fn` was bound to."""
    if isinstance(node, ast.Name):
        for sub in ast.walk(fn):
            if isinstance(sub, ast.Assign) and any(isinstance(t, ast.Name) and t.id == node.id for t in sub.targets):
                node = sub.value
                break
    return ast.literal_eval(node)


def _reference_fixtures() -> list:
    """(test name, {path: source}, rule ids) of every `race_findings` call
    whose files are literal in the reference's race tests."""
    with open(os.path.join(REPO_ROOT, "tests", "test_race_analysis.py"), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    out = []
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef) or not fn.name.startswith("test_"):
            continue
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Name) and node.func.id == "race_findings"):
                continue
            try:
                files = _literal(node.args[1], fn)
                kw = {k.arg: k.value for k in node.keywords}
                rules = _literal(node.args[2] if len(node.args) > 2 else kw["rule_ids"], fn) if (
                    len(node.args) > 2 or "rule_ids" in kw) else None
            except (ValueError, KeyError):
                continue
            out.append((fn.name, files, rules))
    return out


FIXTURES = _reference_fixtures()


def _write(root, files: dict, mapper) -> None:
    for rel, src in files.items():
        p = root / mapper(rel)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src), encoding="utf-8")


def _view(findings, mapper) -> list:
    return sorted((f.rule, mapper(f.path), f.line, f.message.replace("karpenter_tpu/", "karpenter_tpu_torch/")) for f in findings)


def test_fixtures_were_found():
    assert len(FIXTURES) >= 20
    assert {"race-lock-order", "race-blocking-hold", "race-unguarded-shared"} <= {
        r for _, _, rules in FIXTURES if rules for r in rules
    }


@pytest.mark.parametrize("name,files,rules", FIXTURES, ids=[f[0] for f in FIXTURES])
def test_reference_fixture_gives_the_same_findings(tmp_path, name, files, rules):
    _write(tmp_path / "ref", files, lambda p: p)
    _write(tmp_path / "port", files, map_path)
    want = ref_locks.run_race_analysis(str(tmp_path / "ref"), rule_ids=rules)
    got = locks.run_race_analysis(str(tmp_path / "port"), rule_ids=rules)
    assert want["errors"] == got["errors"] == []
    assert _view(got["findings"], lambda p: p) == _view(want["findings"], map_path), name


_TORCHY = """
import threading
import torch

class Dev:
    def __init__(self):
        self._lock = threading.Lock()
        self.n = 0

    def fetch(self, x, limit=4):
        with self._lock:
            self.n = int(limit)  # a host scalar
            return x.cpu()

    def wait(self, x):
        with self._lock:
            if torch.any(x):
                return True
            return False

    def count(self, x):
        with self._lock:
            return int(x.sum())
"""

_HOSTY = """
import threading

class Host:
    def __init__(self):
        self._lock = threading.Lock()

    def fetch(self, x, ev):
        with self._lock:
            ev.synchronize()
            return x.cpu()
"""


def test_blocking_hold_sees_torch_syncs(tmp_path):
    _write(tmp_path, {"karpenter_tpu_torch/dev.py": _TORCHY, "karpenter_tpu_torch/host.py": _HOSTY}, lambda p: p)
    got = locks.run_race_analysis(str(tmp_path), rule_ids={"race-blocking-hold"})["findings"]
    view = sorted((f.path.rsplit("/", 1)[1], f.line) for f in got)
    # dev.py: .cpu(), the branch on torch.any, int(x.sum()); not int(limit).
    # host.py imports no torch: only the Event's synchronize counts
    assert view == [("dev.py", 13), ("dev.py", 17), ("dev.py", 23), ("host.py", 10)], [f.render() for f in got]
    assert all("device sync" in f.message for f in got)


# ---------------------------------------------------------------------------
# the runtime witness


def _scripted_inversion(mod):
    """Two threads taking two locks in opposite orders under `mod`'s
    witness; both locks are made on the lines below, for either module."""
    witness = mod.instrument(hold_ms=60_000)
    try:
        a = threading.Lock()
        b = threading.Lock()

        def one():
            with a:
                with b:
                    pass

        def two():
            with b:
                with a:
                    pass

        for fn in (one, two):
            t = threading.Thread(target=fn, name=fn.__name__)
            t.start()
            t.join(timeout=30)
    finally:
        mod.uninstrument()
    return witness


def test_both_witnesses_report_the_inversion_with_the_same_sites():
    ref = _scripted_inversion(ref_racert)
    port = _scripted_inversion(racert)
    assert len(ref.inversions) == len(port.inversions) == 1
    assert port.inversions[0]["locks"] == ref.inversions[0]["locks"]
    sites = port.inversions[0]["locks"]
    assert all(s.startswith("tests/test_torch_analysis_race.py:") for s in sites)
    assert sorted(port.report()["edges"]) == sorted(ref.report()["edges"])
    with pytest.raises(AssertionError, match="lock-order inversion"):
        port.assert_no_inversions()


def test_port_witness_keeps_long_holds_and_thread_exceptions():
    witness = racert.instrument(hold_ms=5.0)
    try:
        lock = threading.Lock()
        with lock:
            time.sleep(0.05)

        def boom():
            raise RuntimeError("scripted")

        t = threading.Thread(target=boom, name="boom")
        t.start()
        t.join(timeout=30)
    finally:
        racert.uninstrument()
    assert [h["site"] for h in witness.long_holds] == [f"tests/test_torch_analysis_race.py:{_line('lock = threading.Lock()')}"]
    assert [(e["thread"], e["exc_type"]) for e in witness.thread_exceptions] == [("boom", "RuntimeError")]
    with pytest.raises(AssertionError, match="background-thread"):
        witness.assert_no_thread_exceptions()
    assert threading.Lock is racert._RAW_LOCK


def _line(text: str) -> int:
    with open(__file__, encoding="utf-8") as f:
        return next(i for i, line in enumerate(f, 1) if line.strip() == text)


# ---------------------------------------------------------------------------
# the tree


def test_race_tier_exits_0_on_the_tree(capsys):
    assert cli(["--race", "--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["findings"] == [] and payload["errors"] == []
    assert payload["stale_baseline"] == [] and payload["unjustified_baseline"] == []
    # what the baseline keeps: the single-flight nvcc build, nothing else
    entries = json.load(open(os.path.join(REPO_ROOT, "torch_graftlint.race.baseline.json")))["entries"]
    assert payload["baselined"] == 1
    assert [(e["rule"], e["path"]) for e in entries] == [("race-blocking-hold", "karpenter_tpu_torch/_build.py")]


def test_race_cli_refuses_paths_and_unknown_rules(capsys):
    assert cli(["--race", "karpenter_tpu_torch"]) == 2
    assert cli(["--race", "--rules", "race-lock-orderz"]) == 2
    assert cli(["--race", "--reference-root", "/nowhere"]) == 2
