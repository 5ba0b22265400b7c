"""`python -m karpenter_tpu_torch.analysis`: the port's analysis tiers.

    python -m karpenter_tpu_torch.analysis --ast [PATHS ...] [--rules IDS]
        [--baseline PATH] [--reference-root DIR] [--write-baseline] [--json]
    python -m karpenter_tpu_torch.analysis --race [--rules IDS]
        [--baseline PATH] [--write-baseline] [--json]
    python -m karpenter_tpu_torch.analysis --proto [--baseline PATH] [--json]
    python -m karpenter_tpu_torch.analysis --all [--device cpu|cuda] [--json]
    python -m karpenter_tpu_torch.analysis --budgets [--device cpu|cuda]
        [--write-budgets [--justify ENTRY=TEXT ...]] [--manifest PATH]
        [--detail PATH]
    python -m karpenter_tpu_torch.analysis --list-rules

- `--ast`: the AST tier (engine.py and the rules_*.py modules) over the
  port's tree (karpenter_tpu_torch/, tests/test_torch_*.py, chip_smoke.py,
  tools/*_phase.py) or PATHS, under torch_graftlint.baseline.json.
- `--race`: the race tier's static half (locks.py), whole-program, under
  torch_graftlint.race.baseline.json; the runtime witness (racert.py)
  runs under the tests and chip_smoke.py's sidecar phase.
- `--proto`: the protocol tier (proto.py): the model explored under every
  scenario, and the live scenarios on the port's ResilientSolver and
  SolverServer judged by the port's `check_refinement`.
- `--budgets`: the runtime budgets (runtime.py, budgets.py): the CPU scope
  of torch_budgets.json on `--device` (default: the card) and, on the card,
  the `cuda:` scope. `--write-budgets` re-baselines the scope measured and
  carries the other over; a new entry needs `--justify ENTRY=TEXT`.
- `--all`: every tier above (the budgets on `--device`), merged `--json`,
  per-tier seconds, the worst exit code.

The AST, race and protocol tiers keep the reference's rule ids, report
shapes, suppression syntax and exit codes. Exit codes: 0 clean
(baseline-covered findings allowed); 1 findings, or stale or unjustified
baseline entries, or a budget finding; 2 a usage error, an unparsable
file or baseline, a live scenario or measurement that raised, or a
refused write.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional

from karpenter_tpu_torch.analysis.engine import (
    DEFAULT_BASELINE,
    PROTO_DEFAULT_BASELINE,
    RACE_DEFAULT_BASELINE,
    Baseline,
    all_rules,
    canonical_json,
    run_analysis,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_TIERS = ("--ast", "--race", "--proto", "--budgets", "--all")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m karpenter_tpu_torch.analysis", description=__doc__.split("\n\n")[0])
    p.add_argument("paths", nargs="*", help="--ast: files/dirs to lint (default: the port's tree)")
    p.add_argument("--ast", action="store_true", help="the AST tier over the port's tree")
    p.add_argument("--race", action="store_true", help="the race tier's static half (whole-program)")
    p.add_argument("--proto", action="store_true", help="the protocol tier: model + live conformance")
    p.add_argument("--budgets", action="store_true", help="measure the runtime budgets and check torch_budgets.json")
    p.add_argument("--all", action="store_true", help="every tier, merged --json, the worst exit code")
    p.add_argument("--list-rules", action="store_true", help="list the rule ids and exit")
    p.add_argument("--root", default=None, help="repo root (default: this checkout)")
    p.add_argument("--baseline", default=None, help="the tier's baseline (default: <root>/torch_graftlint*.json)")
    p.add_argument("--reference-root", default=None, help="--ast: a Go reference checkout for .go citations")
    p.add_argument("--rules", default=None, help="--ast/--race: comma-separated rule ids to run")
    p.add_argument("--write-baseline", action="store_true", help="--ast/--race: write the findings to the baseline")
    p.add_argument("--json", action="store_true", help="JSON output")
    p.add_argument("--device", default="cuda", help="--budgets/--all: cpu (the plain versions) or cuda (the card)")
    p.add_argument("--write-budgets", action="store_true", help="--budgets: re-baseline the measured scope")
    p.add_argument("--justify", action="append", default=[], metavar="ENTRY=TEXT",
                   help="--budgets: the justification of an entry --write-budgets adds or re-justifies")
    p.add_argument("--manifest", default=None, help="--budgets: the manifest (default: <root>/torch_budgets.json)")
    p.add_argument("--detail", default=None, metavar="PATH", help="--budgets: write the card's census here")
    return p


# ---------------------------------------------------------------------------
# the AST, race and protocol tiers


def _json_files_parse(*paths: str) -> bool:
    """A hand-edited baseline that does not parse is the documented exit 2
    naming the file, not a traceback."""
    ok = True
    for p in paths:
        if not p or not os.path.exists(p):
            continue
        try:
            with open(p, encoding="utf-8") as f:
                json.load(f)
        except (json.JSONDecodeError, OSError) as e:
            print(f"graftlint: cannot parse {p}: {e}", file=sys.stderr)
            ok = False
    return ok


def _write_baseline_file(baseline_path: str, findings) -> int:
    """Regeneration keeps hand-written justifications; only new findings
    get the TODO placeholder (an unjustified entry fails the next run)."""
    existing = Baseline.load(baseline_path)
    data = Baseline.render_entries(findings)
    fresh = existing.merge_justifications(data)
    with open(baseline_path, "w", encoding="utf-8") as f:
        f.write(canonical_json(data))
    n = len(data["entries"])
    print(
        f"graftlint: wrote {n} entr{'y' if n == 1 else 'ies'} to {baseline_path}"
        + (f" — justify the {fresh} new one(s)" if fresh else "")
    )
    return 0


def _tier_payload(report: dict) -> dict:
    """The `--json` report shape every tier shares."""
    return {
        "findings": [f.to_dict() for f in report["findings"]],
        "stale_baseline": report["stale"],
        "unjustified_baseline": report["unjustified"],
        "errors": report["errors"],
        "baselined": len(report["all_findings"]) - len(report["findings"]),
    }


def _print_problems(payload: dict, prefix: str = "") -> None:
    for f in payload["findings"]:
        print(f"{prefix}{f['path']}:{f['line']}: [{f['rule']}] {f['message']}")
    for e in payload["stale_baseline"]:
        print(f"{prefix}stale baseline entry: [{e.get('rule')}] {e.get('path')}: {e.get('text')!r} no longer matches — remove it")
    for e in payload["unjustified_baseline"]:
        print(f"{prefix}unjustified baseline entry: [{e.get('rule')}] {e.get('path')}: add a one-line justification")
    for e in payload["errors"]:
        print(f"{prefix}error: {e}")


def _exit_code(payload: dict, errors_first: bool) -> int:
    """The reference's codes. The AST tier reports findings before parse
    errors; the whole-program tiers (race, proto) claim completeness, so
    an error there is a broken gate (2) even beside findings."""
    problems = payload["findings"] or payload["stale_baseline"] or payload["unjustified_baseline"]
    if errors_first and payload["errors"]:
        return 2
    if problems:
        return 1
    return 2 if payload["errors"] else 0


def _rule_ids(args, known: set) -> Optional[set]:
    if not args.rules:
        return None
    ids = {r.strip() for r in args.rules.split(",")}
    unknown = ids - known
    if unknown:
        raise ValueError("unknown rule id(s): " + ", ".join(sorted(unknown)) + " (see --list-rules)")
    return ids


def run_ast(root: str, args) -> dict:
    paths = [os.path.abspath(p) for p in args.paths] or None
    rule_ids = _rule_ids(args, {r.id for r in all_rules()})
    baseline = args.baseline or os.path.join(root, DEFAULT_BASELINE)
    report = run_analysis(root, paths=paths, baseline_path=baseline, reference_root=args.reference_root, rule_ids=rule_ids)
    if paths is not None or rule_ids is not None:
        # a subset run leaves out-of-scope entries unmatched: not staleness
        report["stale"] = []
    report["baseline_path"] = baseline
    report["subset"] = paths is not None or rule_ids is not None
    return report


def run_race(root: str, args) -> dict:
    from karpenter_tpu_torch.analysis import locks

    rule_ids = _rule_ids(args, set(locks.RACE_RULES))
    baseline = args.baseline or os.path.join(root, RACE_DEFAULT_BASELINE)
    report = locks.run_race_analysis(root, baseline_path=baseline, rule_ids=rule_ids)
    if rule_ids is not None:
        report["stale"] = []
    report["baseline_path"] = baseline
    report["subset"] = rule_ids is not None
    return report


def run_proto(root: str, args) -> dict:
    from karpenter_tpu_torch.analysis import proto

    baseline = args.baseline or os.path.join(root, PROTO_DEFAULT_BASELINE)
    report = proto.run_proto_analysis(root, baseline_path=baseline)
    report["baseline_path"] = baseline
    report["subset"] = False
    return report


_LINT_TIERS = {
    "ast": (run_ast, False),
    "race": (run_race, True),
    "proto": (run_proto, True),
}


def _main_lint(tier: str, root: str, args) -> int:
    if tier != "ast" and args.paths:
        print(f"graftlint: --{tier} is whole-program; it takes no paths", file=sys.stderr)
        return 2
    if tier != "ast" and args.reference_root is not None:
        print(f"graftlint: --reference-root is not used by --{tier}", file=sys.stderr)
        return 2
    if tier == "proto" and (args.rules or args.write_baseline):
        print("graftlint: --rules/--write-baseline are not used by --proto (one exploration per scenario)", file=sys.stderr)
        return 2
    run, errors_first = _LINT_TIERS[tier]
    default = {"ast": DEFAULT_BASELINE, "race": RACE_DEFAULT_BASELINE, "proto": PROTO_DEFAULT_BASELINE}[tier]
    if not _json_files_parse(args.baseline or os.path.join(root, default)):
        return 2
    try:
        report = run(root, args)
    except ValueError as e:
        print(f"graftlint: {e}", file=sys.stderr)
        return 2
    if args.write_baseline:
        if report["subset"]:
            print(f"graftlint: --write-baseline under --{tier} takes a full run (no paths, no --rules)", file=sys.stderr)
            return 2
        if report["errors"]:
            for e in report["errors"]:
                print(f"error: {e}", file=sys.stderr)
            return 2
        return _write_baseline_file(report["baseline_path"], report["all_findings"])
    payload = _tier_payload(report)
    for key in ("scenarios", "properties", "conformance"):
        if key in report:
            payload[key] = report[key]
    code = _exit_code(payload, errors_first)
    if args.json:
        print(json.dumps({**payload, "exit_code": code}, indent=2))
    else:
        _print_problems(payload)
        n = len(payload["findings"])
        extra = ""
        if tier == "proto":
            states = sum(s["states"] for s in report["scenarios"].values())
            truncated = [k for k, s in report["scenarios"].items() if s["truncated"]]
            extra = (
                f", {states} states over {len(report['scenarios'])} scenario(s), "
                f"{len(report['conformance'])} live trace(s)"
                + (f", truncated: {', '.join(truncated)}" if truncated else "")
            )
        print(
            f"graftlint --{tier}: {n} finding{'' if n == 1 else 's'}{extra}"
            + (f", {payload['baselined']} baselined" if payload["baselined"] else "")
            + (f", {len(payload['stale_baseline'])} stale" if payload["stale_baseline"] else "")
        )
    return code


# ---------------------------------------------------------------------------
# the runtime budgets


def measure(device: str) -> tuple[dict, Optional[dict], dict]:
    """(CPU-scope entries, `cuda:` entries or None, detail) on `device`."""
    from karpenter_tpu_torch.analysis import runtime

    if device == "cpu":
        return runtime.measure_cpu_scope("cpu"), None, {}
    return runtime.measure_cuda_scope(device)


def _write_budgets(path: str, manifest, measured: dict, cuda_scope: bool, justify: dict) -> int:
    from karpenter_tpu_torch.analysis.budgets import BudgetManifest, is_justified

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


def _load_and_measure(root: str, args):
    """(path, manifest, CPU-scope entries, `cuda:` entries or None, the
    card's census), or the
    error string of a malformed manifest or a measurement that raised (a
    broken gate, not a verdict). Writes the card's census to `--detail`."""
    from karpenter_tpu_torch.analysis.budgets import DEFAULT_MANIFEST, BudgetManifest, ManifestError

    path = args.manifest or os.path.join(root, DEFAULT_MANIFEST)
    try:
        manifest = BudgetManifest.load(path)
    except ManifestError as e:
        return f"malformed manifest: {e}"
    try:
        cpu, cuda, detail = measure(args.device)
    except Exception as e:
        return f"measurement error: {type(e).__name__}: {e}"
    if args.detail:
        with open(args.detail, "w", encoding="utf-8") as f:
            json.dump({"measured": {**cpu, **(cuda or {})}, "detail": detail}, f, indent=1, sort_keys=True)
    return path, manifest, cpu, cuda, detail


def run_budgets(root: str, args) -> dict:
    """{"issues", "improvements", "measured", "errors", "exit_code"} of the
    budgets against the manifest (no write)."""
    got = _load_and_measure(root, args)
    if isinstance(got, str):
        return {"errors": [got], "exit_code": 2}
    _, manifest, cpu, cuda, detail = got
    cmp = manifest.check(cpu, cuda)
    if cuda is not None:
        from karpenter_tpu_torch.analysis import runtime

        cmp.issues += runtime.seam_issues(detail)
    return {
        "issues": [i.render() for i in cmp.issues],
        "improvements": [i.render() for i in cmp.improvements],
        "measured": len(cpu) + len(cuda or {}),
        "errors": [],
        "exit_code": 1 if cmp.issues else 0,
    }


def _main_budgets(root: str, args) -> int:
    justify = {}
    for item in args.justify:
        name, sep, text = item.partition("=")
        if not sep or not name or not text.strip():
            print(f"budgets: --justify {item!r}: ENTRY=TEXT", file=sys.stderr)
            return 2
        justify[name] = text.strip()

    if args.write_budgets:
        got = _load_and_measure(root, args)
        if isinstance(got, str):
            print(f"budgets: {got}", file=sys.stderr)
            return 2
        path, manifest, cpu, cuda, _ = got
        if cuda is None:
            return _write_budgets(path, manifest, cpu, False, justify)
        issues = manifest.check(cpu).issues  # the card must read the CPU scope first
        if issues:
            for i in issues:
                print(i.render())
            print(f"budgets: the CPU scope does not hold on the card ({len(issues)} findings); nothing written")
            return 1
        return _write_budgets(path, manifest, cuda, True, justify)

    out = run_budgets(root, args)
    for e in out["errors"]:
        print(f"budgets: {e}", file=sys.stderr)
    if out["errors"]:
        return out["exit_code"]
    issues, improvements = out["issues"], out["improvements"]
    for line in issues + improvements:
        print(line)
    print(
        f"budgets: {len(issues)} finding{'' if len(issues) == 1 else 's'}, "
        f"{out['measured']} entries measured on {args.device}"
        + (f", {len(improvements)} with slack" if improvements else "")
    )
    return out["exit_code"]


# ---------------------------------------------------------------------------
# every tier


def _main_all(root: str, args) -> int:
    """AST + race + proto + budgets in one run: merged `--json` with
    per-tier seconds and the worst exit code (2 > 1 > 0). Read-only: the
    write modes stay per tier."""
    if args.paths or args.rules or args.baseline or args.write_baseline or args.write_budgets:
        print(
            "graftlint: --all runs every tier full-tree with each tier's default "
            "baseline; it takes no paths/--rules/--baseline/--write-*",
            file=sys.stderr,
        )
        return 2
    if not _json_files_parse(*(os.path.join(root, b) for b in (DEFAULT_BASELINE, RACE_DEFAULT_BASELINE, PROTO_DEFAULT_BASELINE))):
        return 2
    payload: dict = {}
    for tier in ("ast", "race", "proto", "budgets"):
        t0 = time.monotonic()
        try:
            if tier == "budgets":
                out = run_budgets(root, args)
            else:
                run, errors_first = _LINT_TIERS[tier]
                out = _tier_payload(run(root, args))
                out["exit_code"] = _exit_code(out, errors_first)
        except Exception as e:  # a crashed tier is a broken gate, not a pass
            out = {"errors": [f"{type(e).__name__}: {e}"], "exit_code": 2}
        out["seconds"] = round(time.monotonic() - t0, 3)
        payload[tier] = out
    worst = max(p["exit_code"] for p in payload.values())
    if args.json:
        print(json.dumps({**payload, "exit_code": worst}, indent=2))
    else:
        for tier, out in payload.items():
            if tier == "budgets":
                for line in out.get("issues", []) + [f"error: {e}" for e in out["errors"]]:
                    print(f"[budgets] {line}")
                print(f"graftlint --all [budgets]: {len(out.get('issues', []))} finding(s) ({out['seconds']}s, exit {out['exit_code']})")
                continue
            _print_problems(out, prefix=f"[{tier}] ")
            print(
                f"graftlint --all [{tier}]: {len(out['findings'])} finding(s)"
                + (f", {out['baselined']} baselined" if out.get("baselined") else "")
                + f" ({out['seconds']}s, exit {out['exit_code']})"
            )
        print(f"graftlint --all: worst exit {worst}")
    return worst


def main(argv: Optional[list] = None) -> int:
    args = _parser().parse_args(argv)
    root = os.path.abspath(args.root or REPO_ROOT)
    if args.list_rules:
        from karpenter_tpu_torch.analysis.locks import RACE_RULES
        from karpenter_tpu_torch.analysis.proto import PROTO_RULES

        for r in all_rules():
            print(f"{r.id:22s} {r.summary}")
        for rid, summary in RACE_RULES.items():
            print(f"{rid:22s} [race] {summary}")
        for rid, summary in PROTO_RULES.items():
            print(f"{rid:22s} [proto] {summary}")
        return 0
    picked = [flag for flag in _TIERS if getattr(args, flag[2:])]
    if len(picked) != 1:
        print(
            "graftlint: pick one tier: " + " ".join(_TIERS)
            + (f" ({' and '.join(picked)} are mutually exclusive)" if picked else ""),
            file=sys.stderr,
        )
        return 2
    if args.device not in ("cpu", "cuda") and not args.device.startswith("cuda:"):
        print(f"budgets: --device {args.device!r}: cpu or cuda", file=sys.stderr)
        return 2
    if args.all:
        return _main_all(root, args)
    if args.budgets:
        return _main_budgets(root, args)
    return _main_lint(picked[0][2:], root, args)


if __name__ == "__main__":
    sys.exit(main())
