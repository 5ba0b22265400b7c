"""The port's runtime budgets (karpenter_tpu_torch/analysis/): the manifest
mechanics of torch_budgets.json, twins of tests/test_budget_manifest.py's
cases; every CPU-scope entry held to a measurement with the plain versions;
the names the port shares with kernel_budgets.json held to the JAX
package's values (read as a file: no JAX compile); injected regressions
caught (an extra table build, extra run arrays, a lane scan run twice);
the CLI's exit codes; ptxas's spill lines and the profiler census behind
the `cuda:` scope, which only the card measures (chip_smoke.py phase
14c)."""

from __future__ import annotations

import json
import os
import random
import string
from types import SimpleNamespace

import pytest

from karpenter_tpu_torch import _build
from karpenter_tpu_torch.analysis import __main__ as cli
from karpenter_tpu_torch.analysis import budgets as B
from karpenter_tpu_torch.analysis import runtime as R

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MANIFEST = os.path.join(REPO_ROOT, B.DEFAULT_MANIFEST)


def _load(name: str) -> dict:
    with open(os.path.join(REPO_ROOT, name), encoding="utf-8") as f:
        return json.load(f)["entries"]


CPU_SCOPE = sorted(n for n in _load(B.DEFAULT_MANIFEST) if not n.startswith(B.CUDA_PREFIX))


@pytest.fixture(scope="module")
def measured():
    """One CPU measurement of the CPU scope (about 10 s)."""
    return R.measure_cpu_scope("cpu")


# ---------------------------------------------------------------------------
# the manifest file


def test_checked_in_manifest_is_canonical_and_justified():
    m = B.BudgetManifest.load(MANIFEST)
    assert m.entries
    with open(MANIFEST, encoding="utf-8") as f:
        assert B.BudgetManifest.dumps({"entries": m.entries}) == f.read()
    assert m.unjustified() == []
    for name, e in m.entries.items():
        assert e["metrics"], name
        for metric in e["metrics"]:
            assert metric in B.METRIC_POLICY, (name, metric)
    # both scopes are present: the CPU's and the card's
    assert set(CPU_SCOPE) == set(R.CPU_ENTRIES)
    cuda = {n for n in m.entries if n.startswith(B.CUDA_PREFIX)}
    assert {f"cuda:{n}" for n in R.CPU_ENTRIES} | {"cuda:headline[runtime]", "cuda:c6[runtime]"} <= cuda
    assert {f"cuda:kernel:{k}" for k in R.HAND_KERNELS} <= cuda


@pytest.mark.parametrize("cuda_scope", [None, False, True])
def test_write_budgets_roundtrip_property(cuda_scope):
    """render -> dumps -> load -> render -> dumps is a fixed point, a
    manifest compared with its own measurements is clean, and a write of
    one scope carries the other scope's entries over verbatim."""
    rng = random.Random(0xBEEF)
    metric_names = sorted(B.METRIC_POLICY)
    other = {"cuda:other[runtime]" if cuda_scope is False else "other[runtime]": {
        "justification": "kept verbatim", "metrics": {"launches_torch": 7}}}
    for _ in range(25):
        measured = {}
        for i in range(rng.randint(1, 6)):
            name = "".join(rng.choice(string.ascii_lowercase) for _ in range(8)) + f"[case={i}]"
            if cuda_scope:
                name = B.CUDA_PREFIX + name
            measured[name] = {m: rng.randint(0, 1 << 20) for m in rng.sample(metric_names, rng.randint(1, 8))}
        existing = B.BudgetManifest(dict(other)) if cuda_scope is not None else None
        data = B.BudgetManifest.render(measured, existing, cuda_scope=cuda_scope)
        s1 = B.BudgetManifest.dumps(data)
        loaded = B.BudgetManifest(json.loads(s1)["entries"])
        if cuda_scope is not None:
            assert {n: loaded.entries[n] for n in other} == other
        mine = {k: dict(e["metrics"]) for k, e in loaded.entries.items() if k in measured}
        s2 = B.BudgetManifest.dumps(B.BudgetManifest.render(mine, loaded, cuda_scope=cuda_scope))
        assert s2 == s1
        scope = loaded.scoped(bool(cuda_scope)) if cuda_scope is not None else loaded
        for e in scope.entries.values():
            e["justification"] = "x"
        cmp = scope.compare(mine)
        assert cmp.issues == [] and cmp.improvements == []


def test_render_preserves_existing_justifications():
    existing = B.BudgetManifest({"kept": {"justification": "a reason", "metrics": {"table_uploads": 1}}})
    data = B.BudgetManifest.render({"kept": {"table_uploads": 2}, "new": {"calls_run_arrays": 0}}, existing)
    assert data["entries"]["kept"]["justification"] == "a reason"
    assert data["entries"]["new"]["justification"] == B.TODO_JUSTIFICATION


@pytest.mark.parametrize(
    "budget,measured,kinds,slack",
    [
        ({"calls_run_arrays": 2}, {"calls_run_arrays": 1}, ["structure-mismatch"], 0),  # exact: any drift
        ({"calls_run_arrays": 2}, {"calls_run_arrays": 3}, ["structure-mismatch"], 0),
        ({"calls_run_arrays": 2}, {"calls_run_arrays": 2}, [], 0),
        ({"launches_torch": 100}, {"launches_torch": 101}, ["regression"], 0),  # ceiling: only growth
        ({"launches_torch": 100}, {"launches_torch": 99}, [], 1),  # slack is not a finding
        ({"launches_hand": 6}, {"launches_hand": 5}, ["structure-mismatch"], 0),
        ({"table_uploads": 1, "typo_metric": 5}, {"table_uploads": 1, "calls_solve_runs": 0},
         ["missing-metric", "unknown-metric"], 0),
    ],
)
def test_metric_policy(budget, measured, kinds, slack):
    m = B.BudgetManifest({"k": {"justification": "x", "metrics": budget}})
    cmp = m.compare({"k": measured})
    assert sorted(i.kind for i in cmp.issues) == kinds
    assert len(cmp.improvements) == slack
    for note in cmp.improvements:
        assert "under the budget" in note.render() and "exceeds" not in note.render()


def test_orphaned_missing_and_unjustified_entries_policed():
    m = B.BudgetManifest({
        "gone[runtime]": {"justification": "x", "metrics": {"table_uploads": 1}},
        "bare[runtime]": {"justification": "TODO: justify or fix", "metrics": {"table_uploads": 1}},
    })
    cmp = m.compare({"new[runtime]": {"table_uploads": 1}, "bare[runtime]": {"table_uploads": 1}})
    assert sorted((i.kind, i.entry) for i in cmp.issues) == [
        ("missing-entry", "new[runtime]"), ("orphaned-entry", "gone[runtime]"), ("unjustified", "bare[runtime]"),
    ]
    assert m.unjustified() == ["bare[runtime]"]


def test_cpu_run_never_orphans_a_cuda_entry():
    m = B.BudgetManifest({
        "solve[runtime]": {"justification": "x", "metrics": {"table_uploads": 1}},
        "cuda:solve[runtime]": {"justification": "x", "metrics": {"launches_hand": 5}},
        "cuda:kernel:run_step_kernel": {"justification": "x", "metrics": {"registers": 128}},
    })
    assert m.scoped(False).compare({"solve[runtime]": {"table_uploads": 1}}).issues == []
    assert sorted(m.scoped(True).entries) == ["cuda:kernel:run_step_kernel", "cuda:solve[runtime]"]
    assert [i.kind for i in m.compare({"solve[runtime]": {"table_uploads": 1}}).issues] == ["orphaned-entry"] * 2


def test_issue_render_strings_are_actionable():
    kinds = ("regression", "structure-mismatch", "missing-entry", "orphaned-entry", "missing-metric",
             "unknown-metric", "unjustified", "improvement")
    texts = [B.BudgetIssue(k, "solve[runtime]", "calls_run_arrays", 1, 2).render() for k in kinds]
    assert all("solve[runtime]" in t for t in texts)
    assert len(set(texts)) == len(kinds)
    assert "--write-budgets" in texts[0]


@pytest.mark.parametrize(
    "content",
    ["{not json", '{"entries": []}', '{"entries": {"k": {"justification": "x", "metrics": {"table_uploads": "1"}}}}'],
)
def test_malformed_manifest_refused(tmp_path, content):
    path = tmp_path / "m.json"
    path.write_text(content)
    with pytest.raises(B.ManifestError):
        B.BudgetManifest.load(str(path))


# ---------------------------------------------------------------------------
# the CPU scope against the plain versions


@pytest.mark.parametrize("entry", CPU_SCOPE)
def test_cpu_scope_entry_holds(measured, entry):
    m = B.BudgetManifest.load(MANIFEST).scoped(False)
    cmp = m.compare({entry: measured[entry]})
    assert [i.render() for i in cmp.issues if i.kind != "orphaned-entry"] == []


@pytest.mark.parametrize("entry", sorted(set(CPU_SCOPE) & set(_load("kernel_budgets.json"))))
def test_shared_metrics_equal_the_reference(measured, entry):
    """A metric the JAX package's manifest pins under the same entry and
    name reads the same in the port's manifest and measurement."""
    ref = _load("kernel_budgets.json")[entry]["metrics"]
    mine = _load(B.DEFAULT_MANIFEST)[entry]["metrics"]
    shared = sorted(set(ref) & set(mine))
    assert shared
    for metric in shared:
        assert mine[metric] == ref[metric] == measured[entry][metric], (entry, metric)


def _extra_tables(monkeypatch):
    """Every upload phase builds the tables twice (one upload too many)."""
    from karpenter_tpu_torch.solver.tpu import TorchScheduler

    orig = TorchScheduler._upload

    def twice(self, problem, prof):
        self._tables(problem)
        return orig(self, problem, prof)

    monkeypatch.setattr(TorchScheduler, "_upload", twice)


def _extra_run_arrays(monkeypatch):
    """Every runs-path round computes its run arrays twice (a seam call too
    many)."""
    from karpenter_tpu_torch.solver.tpu import TorchScheduler

    orig = TorchScheduler._run_x

    def twice(self, xs, idx_d, n):
        orig(self, xs, idx_d, n)
        return orig(self, xs, idx_d, n)

    monkeypatch.setattr(TorchScheduler, "_run_x", twice)


def _lane_scan_twice(monkeypatch):
    """Every full-state lane sweep runs its lane scan twice (a seam call
    too many)."""
    from karpenter_tpu_torch.solver import tpu_kernel

    orig = tpu_kernel.scan_lanes

    def twice(*args, **kwargs):
        orig(*args, **kwargs)
        return orig(*args, **kwargs)

    monkeypatch.setattr(tpu_kernel, "scan_lanes", twice)


@pytest.mark.parametrize(
    "inject,entry,want",
    [
        # the second build screens its class rows again: K1's seam counts it too
        (_extra_tables, "solve[runtime]", [("calls_typeok_screen", 5, 10), ("table_uploads", 1, 2)]),
        (_extra_run_arrays, "solve[runtime]", [("calls_run_arrays", 3, 6)]),
        (_lane_scan_twice, "sweep_lanes[runtime]", [("calls_scan_lanes", 2, 4)]),
    ],
    ids=["extra_tables", "extra_run_arrays", "lane_scan_twice"],
)
def test_injected_regression_is_caught(monkeypatch, inject, entry, want):
    inject(monkeypatch)
    measured = {entry: R.CPU_ENTRIES[entry](device="cpu")}
    cmp = B.BudgetManifest.load(MANIFEST).scoped(False).compare(measured)
    found = [(i.kind, i.entry, i.metric, i.budget, i.measured) for i in cmp.issues if i.kind != "orphaned-entry"]
    assert found == [("structure-mismatch", entry, *w) for w in want]


# ---------------------------------------------------------------------------
# the command line


def _write_manifest(tmp_path, entries: dict) -> str:
    path = tmp_path / "m.json"
    path.write_text(B.BudgetManifest.dumps({"entries": entries}))
    return str(path)


def _patch_measure(monkeypatch, cpu: dict, cuda=None):
    monkeypatch.setattr(cli, "measure", lambda device: (cpu, cuda, {}))


def _checked_in(tmp_path) -> str:
    return _write_manifest(tmp_path, _load(B.DEFAULT_MANIFEST))


def _raise(device):
    raise RuntimeError("no card")


@pytest.mark.parametrize(
    "case,rc",
    [("holds", 0), ("finding", 1), ("malformed", 2), ("raises", 2), ("no_tier", 2), ("bad_device", 2)],
)
def test_cli_exit_codes(tmp_path, monkeypatch, capsys, measured, case, rc):
    path = _checked_in(tmp_path)
    cpu = {k: dict(v) for k, v in measured.items()}
    argv = ["--budgets", "--device", "cpu", "--manifest", path]
    if case == "finding":
        cpu["solve[runtime]"]["calls_run_arrays"] += 1
    elif case == "malformed":
        (tmp_path / "m.json").write_text("{")
    elif case == "no_tier":
        argv = argv[1:]
    elif case == "bad_device":
        argv[2] = "tpu"
    _patch_measure(monkeypatch, cpu)
    if case == "raises":
        monkeypatch.setattr(cli, "measure", _raise)
    assert cli.main(argv) == rc
    out = capsys.readouterr().out
    if case == "finding":
        assert "solve[runtime]: calls_run_arrays" in out


def test_cli_write_keeps_justifications_and_the_card_scope(tmp_path, monkeypatch, measured):
    entries = _load(B.DEFAULT_MANIFEST)
    path = _write_manifest(tmp_path, entries)
    cpu = {k: dict(v) for k, v in measured.items()}
    cpu["sweep[runtime]"]["calls_fast_sweep"] = 3
    _patch_measure(monkeypatch, cpu)
    assert cli.main(["--budgets", "--device", "cpu", "--manifest", path, "--write-budgets"]) == 0
    got = B.BudgetManifest.load(path).entries
    assert got["sweep[runtime]"]["metrics"]["calls_fast_sweep"] == 3
    assert {n: e["justification"] for n, e in got.items()} == {n: e["justification"] for n, e in entries.items()}
    assert {n: e for n, e in got.items() if n.startswith(B.CUDA_PREFIX)} == {
        n: e for n, e in entries.items() if n.startswith(B.CUDA_PREFIX)
    }


def test_cli_write_refuses_an_unjustified_new_entry(tmp_path, monkeypatch, measured):
    path = _checked_in(tmp_path)
    before = open(path, encoding="utf-8").read()
    cpu = dict(measured, **{"new[runtime]": {"calls_run_arrays": 1}})
    _patch_measure(monkeypatch, cpu)
    argv = ["--budgets", "--device", "cpu", "--manifest", path, "--write-budgets"]
    assert cli.main(argv) == 2
    assert open(path, encoding="utf-8").read() == before
    assert cli.main(argv + ["--justify", "new[runtime]=one call"]) == 0
    assert B.BudgetManifest.load(path).entries["new[runtime]"]["justification"] == "one call"


def test_cli_card_write_needs_the_cpu_scope_to_hold(tmp_path, monkeypatch, measured):
    path = _checked_in(tmp_path)
    entries = _load(B.DEFAULT_MANIFEST)
    cuda = {n: dict(e["metrics"]) for n, e in entries.items() if n.startswith(B.CUDA_PREFIX)}
    cuda["cuda:headline[runtime]"]["launches_torch"] += 1
    argv = ["--budgets", "--device", "cuda", "--manifest", path, "--write-budgets"]
    bad = {k: dict(v) for k, v in measured.items()}
    bad["epoch[runtime]"]["epoch_repeat_table_uploads"] = 1
    _patch_measure(monkeypatch, bad, cuda)
    assert cli.main(argv) == 1
    _patch_measure(monkeypatch, measured, cuda)
    assert cli.main(argv) == 0
    got = B.BudgetManifest.load(path).entries
    assert got["cuda:headline[runtime]"]["metrics"]["launches_torch"] == cuda["cuda:headline[runtime]"]["launches_torch"]
    assert {n: got[n] for n in CPU_SCOPE} == {n: entries[n] for n in CPU_SCOPE}


# ---------------------------------------------------------------------------
# what the cuda: scope reads (the card measures it; here its parsers)

# ptxas -v output for K3 as the card's build logs it (sm_90a): the kernel's
# frame and spills, then a device function's, whose spills are its own
_PTXAS_LOG = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z15run_step_kernelv' for 'sm_90a'
ptxas info    : Function properties for _Z15run_step_kernelv
    1264 bytes stack frame, 708 bytes spill stores, 3020 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 16 bytes smem, 400 bytes cmem[0]
ptxas info    : Function properties for _Z10case_leveliiRK7Scratch
    0 bytes stack frame, 0 bytes spill stores, 4 bytes spill loads
ptxas info    : Compiling entry function '_Z20dedup_cluster_kernelILb0EEv9DedupArgs' for 'sm_90a'
ptxas info    : Function properties for _Z20dedup_cluster_kernelILb0EEv9DedupArgs
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 352 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z20dedup_cluster_kernelILb1EEv9DedupArgs' for 'sm_90a'
ptxas info    : Function properties for _Z20dedup_cluster_kernelILb1EEv9DedupArgs
    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 77 registers, used 1 barriers, 352 bytes smem, 400 bytes cmem[0]
"""


def test_ptxas_resources_reads_frames_and_spills():
    got = _build.ptxas_resources(_PTXAS_LOG)
    assert got["run_step_kernel"] == {
        "registers": 128, "smem_bytes": 16, "stack_bytes": 1264, "spill_store_bytes": 708, "spill_load_bytes": 3020,
    }
    # a template's instances share a name and keep the largest of each
    assert got["dedup_cluster_kernel"] == {
        "registers": 128, "smem_bytes": 352, "stack_bytes": 8, "spill_store_bytes": 8, "spill_load_bytes": 8,
    }
    assert set(got) == {"run_step_kernel", "dedup_cluster_kernel"}


def test_kernel_metrics_cover_every_hand_kernel(monkeypatch):
    logs = {}
    for k in R.HAND_KERNELS:
        logs[k] = (
            f"ptxas info    : Compiling entry function '_Z{len(k)}{k}v' for 'sm_90a'\n"
            f"ptxas info    : Function properties for _Z{len(k)}{k}v\n"
            "    0 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads\n"
            "ptxas info    : Used 40 registers, used 1 barriers, 0 bytes smem, 400 bytes cmem[0]\n"
        )
    monkeypatch.setattr(_build, "build_all", lambda: {k: {"log": v} for k, v in logs.items()})
    got = R.kernel_metrics()
    assert set(got) == {f"cuda:kernel:{k}" for k in R.HAND_KERNELS}
    assert got["cuda:kernel:run_step_kernel"] == {"registers": 40, "smem_bytes": 0, "spill_store_bytes": 4}
    del logs["typeok_kernel"]
    with pytest.raises(RuntimeError, match="typeok_kernel"):
        R.kernel_metrics()


@pytest.mark.parametrize(
    "library,n,lanes,want",
    [
        ("typeok", 0, 0, {"typeok_kernel": 1}),
        ("dedup_rows", 8192, 0, {"dedup_cluster_kernel": 1}),
        # 8193 rows: L = 16384 = 2^14 positions, 14 * 15 / 2 sort passes
        ("dedup_rows", 8193, 0, {"hash_kernel": 1, "sort_pass_kernel": 105, "mark_kernel": 1, "tile_sum_kernel": 1,
                                 "tile_scan_kernel": 1, "scatter_kernel": 1}),
        ("scan_lanes", 0, 128, {"scan_lanes_kernel": 1}),
        ("scan_lanes", 0, 136, {"scan_lanes_kernel": 2}),
        ("set_sweep", 0, 0, {"sweep_cache_kernel": 1, "set_sweep_lanes": 1}),
    ],
)
def test_kernel_records_per_call(library, n, lanes, want):
    got = R.kernel_records(library, n, lanes)
    assert got == want
    assert set(got) <= set(R.HAND_KERNELS)


def test_census_counts_the_block_by_correlation():
    """Runtime records count inside the window's annotation; device
    records count when their correlation id is one of those calls'."""
    events = []

    def ev(name, device="DeviceType.CPU", at=5.0, corr=0):
        e = SimpleNamespace(name=name, device_type=device, id=corr, time_range=SimpleNamespace(start=at, end=at + 1))
        events.append(e)
        return e

    def call(name, device_name=None, at=5.0):
        corr = len(events) + 100
        ev(name, at=at, corr=corr)
        if device_name is not None:
            ev(device_name, "DeviceType.CUDA", at=at, corr=corr)

    call("cudaLaunchKernel", "empty_kernel()", at=0.5)  # a marker, before the window
    call("cudaMemcpyAsync", "Memcpy HtoD (Pageable -> Device)", at=0.5)
    ev(R.WINDOW_RANGE).time_range = SimpleNamespace(start=1.0, end=9.0)
    ev(R.WINDOW_RANGE, "DeviceType.CUDA")  # the annotation's device-side record
    call("cudaLaunchKernel", "typeok_kernel(TypeokTypes, TypeokRows)")
    call("cudaLaunchKernelExC", "void dedup_cluster_kernel<true>(DedupArgs)")
    call("cudaLaunchKernel", "_Z15run_step_kernelv")
    call("cudaLaunchKernel", "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<int> >(int)")
    call("cudaMemcpyAsync", "Memcpy HtoD (Pageable -> Device)")
    call("cudaMemcpyToSymbolAsync", "Memcpy HtoD (Pageable -> Device)")
    call("cudaMemcpyAsync", "Memcpy DtoH (Device -> Pageable)")
    call("cudaMemsetAsync", "Memset (Device)")
    call("cudaStreamSynchronize")
    call("cudaDeviceSynchronize")
    call("cudaDeviceSynchronize", at=9.5)  # the profiler's own, after the window
    ev("aten::copy_")
    c = R.census(events)
    assert (c["launches_hand"], c["launches_torch"], c["launch_calls"]) == (3, 1, 4)
    assert c["hand_kernels"] == {"dedup_cluster_kernel": 1, "run_step_kernel": 1, "typeok_kernel": 1}
    assert (c["h2d_copies"], c["d2h_copies"], c["memsets"]) == (2, 1, 1)
    # cudaMemcpyAsync and cudaMemcpyToSymbolAsync are copies, not syncs
    assert c["host_syncs"] == 2
    assert (c["runtime_calls_outside"], c["device_records_outside"], c["annotated"]) == (3, 2, True)
    assert c["records_missing"] == 0
    # a call whose device record the profiler lost is missing, not a smaller count
    events[:] = [e for e in events if not e.name.startswith("Memcpy DtoH")]
    c = R.census(events)
    assert (c["d2h_copies"], c["records_missing"]) == (0, 1)


def test_measurements_default_to_the_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        R.solve_metrics("generic")
    with pytest.raises(RuntimeError, match="CUDA"):
        R.measure_cuda_scope()
