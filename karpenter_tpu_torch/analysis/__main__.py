"""`python -m karpenter_tpu_torch.analysis --budgets`: the port's runtime budgets.

    python -m karpenter_tpu_torch.analysis --budgets [--device cpu|cuda]
        [--write-budgets [--justify ENTRY=TEXT ...]] [--manifest PATH]
        [--detail PATH]

Measures the CPU scope of torch_budgets.json on `--device` (default: the
card) and, on the card, the `cuda:` scope too (runtime.py), and compares
each scope with its slice of the manifest (budgets.py). On the card the
CPU-scope entries must read what they read on the CPU.

`--write-budgets` re-baselines the scope that was measured (the `cuda:`
entries on the card, the others on the CPU) and carries the other scope
over verbatim; each entry keeps its justification, and a new entry needs
one (`--justify ENTRY=TEXT`) or nothing is written. On the card it writes
only when the CPU scope holds there.

Exit codes: 0 the budgets hold (or were written); 1 a finding; 2 a usage
error, a malformed manifest, a refused write or a measurement that raised.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

from karpenter_tpu_torch.analysis.budgets import (
    DEFAULT_MANIFEST,
    BudgetManifest,
    ManifestError,
    is_justified,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m karpenter_tpu_torch.analysis", description=__doc__.split("\n\n")[0])
    p.add_argument("--budgets", action="store_true", help="measure the runtime budgets and check torch_budgets.json")
    p.add_argument("--device", default="cuda", help="cpu (the plain versions) or cuda (the card; default)")
    p.add_argument("--write-budgets", action="store_true", help="re-baseline the measured scope")
    p.add_argument("--justify", action="append", default=[], metavar="ENTRY=TEXT",
                   help="the justification of an entry --write-budgets adds or re-justifies")
    p.add_argument("--manifest", default=None, help=f"the manifest (default: <repo>/{DEFAULT_MANIFEST})")
    p.add_argument("--detail", default=None, metavar="PATH", help="write the card's census behind each window here")
    return p


def measure(device: str) -> tuple[dict, Optional[dict], dict]:
    """(CPU-scope entries, `cuda:` entries or None, detail) on `device`."""
    from karpenter_tpu_torch.analysis import runtime

    if device == "cpu":
        return runtime.measure_cpu_scope("cpu"), None, {}
    return runtime.measure_cuda_scope(device)


def _write(path: str, manifest: BudgetManifest, measured: dict, cuda_scope: bool, justify: dict) -> int:
    existing = BudgetManifest({name: dict(e) for name, e in manifest.entries.items()}, path)
    for name, text in justify.items():
        existing.entries.setdefault(name, {"metrics": {}})["justification"] = text
    data = BudgetManifest.render(measured, existing, cuda_scope=cuda_scope)
    fresh = sorted(name for name, e in data["entries"].items() if not is_justified(e))
    if fresh:
        print(
            "budgets: refused to write: no justification for " + ", ".join(fresh)
            + " (--justify ENTRY=TEXT)",
            file=sys.stderr,
        )
        return 2
    with open(path, "w", encoding="utf-8") as f:
        f.write(BudgetManifest.dumps(data))
    n = sum(1 for name in data["entries"] if name in measured)
    print(f"budgets: wrote {n} {'cuda:' if cuda_scope else 'CPU-scope'} entries to {path}")
    return 0


def main(argv: Optional[list] = None) -> int:
    args = _parser().parse_args(argv)
    if not args.budgets:
        print("budgets: nothing to do (pass --budgets)", file=sys.stderr)
        return 2
    if args.device not in ("cpu", "cuda") and not args.device.startswith("cuda:"):
        print(f"budgets: --device {args.device!r}: cpu or cuda", file=sys.stderr)
        return 2
    justify = {}
    for item in args.justify:
        name, sep, text = item.partition("=")
        if not sep or not name or not text.strip():
            print(f"budgets: --justify {item!r}: ENTRY=TEXT", file=sys.stderr)
            return 2
        justify[name] = text.strip()
    path = args.manifest or os.path.join(REPO_ROOT, DEFAULT_MANIFEST)
    try:
        manifest = BudgetManifest.load(path)
    except ManifestError as e:
        print(f"budgets: malformed manifest: {e}", file=sys.stderr)
        return 2
    try:
        cpu, cuda, detail = measure(args.device)
    except Exception as e:  # a measurement that raises is a broken gate, not a verdict
        print(f"budgets: measurement error: {type(e).__name__}: {e}", file=sys.stderr)
        return 2
    if args.detail:
        with open(args.detail, "w", encoding="utf-8") as f:
            json.dump({"measured": {**cpu, **(cuda or {})}, "detail": detail}, f, indent=1, sort_keys=True)

    if args.write_budgets:
        if cuda is None:
            return _write(path, manifest, cpu, False, justify)
        issues = manifest.check(cpu).issues  # the card must read the CPU scope first
        if issues:
            for i in issues:
                print(i.render())
            print(f"budgets: the CPU scope does not hold on the card ({len(issues)} findings); nothing written")
            return 1
        return _write(path, manifest, cuda, True, justify)

    cmp = manifest.check(cpu, cuda)
    issues, improvements = cmp.issues, cmp.improvements
    for i in issues + improvements:
        print(i.render())
    print(
        f"budgets: {len(issues)} finding{'' if len(issues) == 1 else 's'}, "
        f"{len(cpu) + len(cuda or {})} entries measured on {args.device}"
        + (f", {len(improvements)} with slack" if improvements else "")
    )
    return 1 if issues else 0


if __name__ == "__main__":
    sys.exit(main())
