"""The port's prewarm (karpenter_tpu_torch/solver/aot.py) on the CPU.

- `claim_rungs` and the representative problems' bucket signatures equal
  the JAX package's for every rung of `ladder(64, 1024)`;
- `prewarm(device="cpu")` runs every kernel's plain version over the
  ladder, writes a manifest that reads back, skips a combo this process
  already launched whose recorded signature matches, relaunches one whose
  signature moved, and never calls `_build.build_all`;
- a set `stop` event interrupts between combos and leaves a readable
  manifest; a corrupt, torn or foreign-version manifest reads as the empty
  shell; a process killed mid-prewarm leaves a manifest the next process
  reads and completes (tests/test_service_faults.py:796's counterpart);
- `SolverServer(prewarm=True, device="cpu")` with the default prewarm
  answers PONG "prewarming", serves a solve sent mid-prewarm on the oracle
  with the port's in-process decisions, then reports "ready" and solves on
  the kernel route (tests/test_service_faults.py:714's counterpart).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import threading

import pytest

os.environ["KARPENTER_COMPILATION_CACHE_DIR"] = ""

from karpenter_tpu_torch import _build  # noqa: E402
from karpenter_tpu_torch.cloudprovider.kwok import construct_instance_types  # noqa: E402
from karpenter_tpu_torch.solver import aot, buckets  # noqa: E402
from karpenter_tpu_torch.solver.hybrid import solve_in_process  # noqa: E402
from karpenter_tpu_torch.solver.oracle import SchedulerOptions  # noqa: E402
from karpenter_tpu_torch.solver.service import KIND_PING, SolverClient, SolverServer  # noqa: E402
from karpenter_tpu_torch.testing import fixtures  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(max_pods=128, device="cpu")


def _combos(max_pods=128, include_sweeps=True, fleet_buckets=()) -> int:
    rungs = len(buckets.ladder(64, max_pods, floor=64))
    per_kind = 1 + 3 * rungs + len(fleet_buckets)
    return 2 * per_kind + (2 if include_sweeps else 0)


@pytest.fixture
def no_build(monkeypatch):
    """A prewarm on the CPU must never reach nvcc or a library load."""
    monkeypatch.setattr(_build, "build_all", lambda: pytest.fail("build_all called"))
    monkeypatch.setattr(_build, "library", lambda name: pytest.fail(f"library({name}) called"))
    monkeypatch.setattr(aot, "_WARM", set())


def test_rungs_and_signatures_equal_the_reference():
    from karpenter_tpu.solver import aot as raot
    from karpenter_tpu.solver import buckets as rbuckets

    assert buckets.ladder(64, 1024, floor=64) == rbuckets.ladder(64, 1024, floor=64)
    for div in (1, 4, 16):
        for P in buckets.ladder(64, 1024, floor=64):
            assert aot.claim_rungs(P, div) == raot.claim_rungs(P, div)
    for kind in ("generic", "mixed"):
        _, problem, order = aot._representative(kind, "cpu")
        _, rproblem, rorder, _ = raot._representative(kind)
        assert buckets.signature(problem) == rbuckets.signature(rproblem)
        assert [problem.pods[i].name for i in order] == [rproblem.pods[i].name for i in rorder]


def test_prewarm_writes_reads_back_skips_and_builds_nothing(tmp_path, no_build):
    d = str(tmp_path)
    first = aot.prewarm(cache_dir=d, **SMALL)
    n = _combos()
    assert first["completed"] and first["launched"] == n and first["skipped"] == 0
    assert first["built"] == 0 and first["build_seconds"] == 0
    assert aot.PREWARM_READY.value() == 1.0
    manifest = aot.load_manifest(d)
    assert manifest["device"] == "cpu" and set(manifest["combos"]) == set(first["combos"])
    assert len(manifest["combos"]) == n
    names = set(manifest["combos"])
    assert {"typeok_screen[relax=False]@generic", "set_sweep@contract", "fast_sweep@contract"} <= names
    assert "solve_runs[relax=True]@P=128,N=64" in names and "dedup_rows[relax=False]@P=64,N=64" in names
    for entry in manifest["combos"].values():
        assert entry["signature"] and entry["first_launch_ms"] > 0 and entry["bytes"] > 0
        assert entry["build_seconds"] == 0 and set(entry["kernels"])

    second = aot.prewarm(cache_dir=d, **SMALL)
    assert second["completed"] and second["launched"] == 0 and second["skipped"] == n

    # a moved signature relaunches that combo alone
    name = "solve_scan[relax=False]@P=64,N=64"
    manifest["combos"][name]["signature"] = [["E", 0]]
    aot._write_manifest(d, manifest)
    third = aot.prewarm(cache_dir=d, **SMALL)
    assert third["launched"] == 1 and third["skipped"] == n - 1
    assert aot.load_manifest(d)["combos"][name]["signature"] != [["E", 0]]


def test_prewarm_fleet_lanes(tmp_path, no_build):
    out = aot.prewarm(cache_dir=str(tmp_path), max_pods=64, device="cpu", include_sweeps=False,
                      include_fleet=True, fleet_lane_buckets=(2,))
    assert out["completed"] and out["launched"] == _combos(64, False, (2,))
    assert "fleet_solve_scan[relax=True]@B=2,P=64,N=64" in out["combos"]


def test_stop_interrupts_between_combos(tmp_path, no_build):
    stop = threading.Event()
    seen = []

    def progress(name, seconds):
        seen.append(name)
        stop.set()

    out = aot.prewarm(cache_dir=str(tmp_path), stop=stop, progress=progress, **SMALL)
    assert not out["completed"] and out["launched"] == 1 and seen == ["typeok_screen[relax=False]@generic"]
    assert aot.PREWARM_READY.value() == 0.0
    assert list(aot.load_manifest(str(tmp_path))["combos"]) == seen


@pytest.mark.parametrize(
    "body",
    ["{not json", '{"version": 1, "combos": {"a": ', json.dumps({"version": 99, "combos": {"x": {}}}),
     json.dumps([1, 2]), json.dumps({"version": 1, "combos": []}), "\xff\xfe"],
    ids=["garbage", "torn", "foreign_version", "not_a_dict", "combos_not_a_dict", "binary"],
)
def test_bad_manifest_reads_as_the_empty_shell(tmp_path, body):
    with open(aot.manifest_path(str(tmp_path)), "w", encoding="latin-1") as f:
        f.write(body)
    assert aot.load_manifest(str(tmp_path)) == {"version": aot.MANIFEST_VERSION, "combos": {}}
    assert aot.program_catalog(str(tmp_path))["programs"] == {}
    assert aot.load_manifest(None)["combos"] == {} and aot.load_manifest(str(tmp_path / "none"))["combos"] == {}


_KILL_SCRIPT = """
import sys, time
from karpenter_tpu_torch.solver import aot
count = [0]
def progress(name, seconds):
    count[0] += 1
    if count[0] == 3 and sys.argv[2] == "stall":
        print("MID_PREWARM", flush=True)
        time.sleep(600)
out = aot.prewarm(max_pods=64, include_sweeps=False, device="cpu", cache_dir=sys.argv[1], progress=progress)
print("PREWARM_DONE", out["completed"], out["launched"] + out["skipped"], flush=True)
"""


def test_killed_prewarm_leaves_a_readable_manifest(tmp_path):
    d = str(tmp_path / "cache")
    os.makedirs(d)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-c", _KILL_SCRIPT, d, "stall"], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
    )
    try:
        assert proc.stdout.readline().strip() == "MID_PREWARM"
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    survived = aot.load_manifest(d)
    assert len(survived["combos"]) == 3
    assert not [f for f in os.listdir(d) if f.startswith(".aot_manifest.") and f != aot.MANIFEST_NAME]
    done = subprocess.run(
        [sys.executable, "-c", _KILL_SCRIPT, d, "run"], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=300,
    )
    assert done.returncode == 0, done.stderr[-4000:]
    assert f"PREWARM_DONE True {_combos(64, False)}" in done.stdout
    assert set(survived["combos"]) <= set(aot.load_manifest(d)["combos"])


def _parts(results, pods) -> tuple:
    name = {p.uid: p.name for p in pods}
    claims = sorted(tuple(sorted(name[p.uid] for p in c.pods)) for c in results.new_node_claims if c.pods)
    existing = {name[p.uid]: n.name for n in results.existing_nodes for p in n.pods}
    return claims, existing, tuple(sorted(name[u] for u in results.pod_errors))


def _wire_parts(got: dict, pods) -> tuple:
    name = {p.uid: p.name for p in pods}
    claims = sorted(tuple(sorted(name[u] for u in c["pod_uids"])) for c in got["new_node_claims"] if c["pod_uids"])
    existing = {name[u]: n for u, n in got["existing_assignments"].items()}
    return claims, existing, tuple(sorted(name[u] for u in got["pod_errors"]))


def test_server_default_prewarm_degrades_mid_prewarm_then_serves(tmp_path, monkeypatch):
    """The server's default prewarm (`aot.prewarm` on its device), held at
    its third combo: PONG says "prewarming", a solve is served by the
    oracle with the in-process decisions; released, the ladder completes,
    PONG says "ready" and the same solve takes the kernel route."""
    gate = threading.Event()
    calls = []
    real = aot.prewarm

    def held_prewarm(**kw):
        calls.append(kw)
        count = [0]

        def progress(name, seconds):
            count[0] += 1
            if count[0] == 3:
                gate.wait(60)

        return real(max_pods=64, cache_dir=str(tmp_path), progress=progress, **kw)

    monkeypatch.setattr(aot, "prewarm", held_prewarm)
    monkeypatch.setattr(aot, "_WARM", set())
    fixtures.reset_rng(7)
    pools = [fixtures.node_pool(name="default")]
    ibp = {"default": construct_instance_types(sizes=[2, 8])}
    pods = fixtures.make_generic_pods(6)
    kernels = SchedulerOptions(tpu_min_pods=0)
    want, sched = solve_in_process(pools, ibp, pods, options=kernels, device="cpu")
    assert sched.used_tpu
    srv = SolverServer(tempfile.mktemp(suffix=".sock"), prewarm=True, device="cpu")
    srv.start()
    try:
        c = SolverClient(srv.socket_path, request_timeout=120.0)
        assert c._roundtrip(KIND_PING, b"", 10.0)[1] == b"prewarming"
        assert c.ping_status()["status"] == "prewarming" and not srv.ready.is_set()
        got = c.solve(pools, ibp, pods, options=kernels)
        assert not got["used_tpu"] and srv.oracle_degraded_solves == 1
        assert _wire_parts(got, pods) == _parts(want, pods)
        gate.set()
        assert srv.ready.wait(60)
        assert c._roundtrip(KIND_PING, b"", 10.0)[1] == b"ready"
        got2 = c.solve(pools, ibp, pods, options=kernels)
        assert got2["used_tpu"] and srv.oracle_degraded_solves == 1
        assert _wire_parts(got2, pods) == _parts(want, pods)
        c.close()
    finally:
        gate.set()
        srv.stop()
    assert calls and calls[0]["device"] == "cpu" and calls[0]["include_fleet"] is False
    assert len(aot.load_manifest(str(tmp_path))["combos"]) == _combos(64)
    assert aot.PREWARM_READY.value() == 1.0
