"""The port stands alone: no jax and no karpenter_tpu in its import closure,
and no silent CPU fallback when the card is asked for."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "karpenter_tpu_torch"

_PROBE = """
import importlib, pkgutil, sys
import karpenter_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "karpenter_tpu.")) or m == "karpenter_tpu")
print(len(names), bad)
"""


def test_importing_every_module_loads_no_jax_or_reference():
    # a subprocess: this test process already imported jax (tests/conftest.py)
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
    )
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 25
    assert bad == "[]"


_HARNESS_PROBE = """
import sys
from karpenter_tpu_torch.cloudprovider import fake
from karpenter_tpu_torch.testing import faults, fixtures, fuzz
case = fixtures.runs_stall_case(shrunk=True)
fuzz.check_parity(case, device="cpu")
fuzz.check_invariants(case, device="cpu")
print(sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "karpenter_tpu.")) or m == "karpenter_tpu"))
"""


def test_fuzz_harness_loads_no_jax_or_reference():
    """The fuzz harness, the fake cloud provider and the fault proxy, with
    a parity and an invariant check run, load neither jax nor the JAX
    package."""
    out = subprocess.run(
        [sys.executable, "-c", _HARNESS_PROBE], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


_CONFIGS_PROBE = """
import sys
from karpenter_tpu_torch.solver.tpu import TorchScheduler
from karpenter_tpu_torch.testing import configs, fuzz
for name in configs.CONFIGS:
    pools, ibp, pods, topo = configs.build(name, n_pods=20, its=configs.build_universe(20))
res = TorchScheduler(pools, ibp, topo, device="cpu").solve(pods)
fuzz.snapshot_digest(fuzz.results_snapshot(res, pods))
print(sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "karpenter_tpu.")) or m == "karpenter_tpu"))
"""


def test_configs_load_no_jax_or_reference():
    """The BASELINE.json config makers, a solve of one and its digest
    load neither jax nor the JAX package."""
    out = subprocess.run(
        [sys.executable, "-c", _CONFIGS_PROBE], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _forbidden(name: str) -> bool:
    return name in ("jax", "karpenter_tpu") or name.startswith(("jax.", "karpenter_tpu."))


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_file_of_the_port_imports_jax_or_reference(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, node.lineno, names)


def test_default_device_without_cuda_raises(monkeypatch):
    from karpenter_tpu_torch.device import resolve_device
    from karpenter_tpu_torch.solver.topology import Topology
    from karpenter_tpu_torch.solver.tpu import TorchScheduler
    from karpenter_tpu_torch.testing import fixtures

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pools = [fixtures.node_pool(name="default")]
    ibp = {"default": []}
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchScheduler(pools, ibp, Topology(pools, ibp, []))
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_the_walk_covers_the_analysis_tiers():
    """The checks above walk the analysis tiers too (the AST, race and
    protocol tiers' modules, their runtime witness and recorder)."""
    walked = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    tiers = {"engine", "rules_kernel", "rules_data", "rules_threads", "rules_metrics", "rules_wire", "rules_docs",
             "locks", "racert", "proto", "protorec", "__main__"}
    assert {f"analysis/{m}.py" for m in tiers} <= walked
