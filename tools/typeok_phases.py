#!/usr/bin/env python3
"""Where K1 `typeok_screen`'s device time goes, phase by phase, on one card.

    python3 tools/typeok_phases.py [--source karpenter_tpu_torch/csrc/typeok.cu] [--out build/typeok_phases.json]

The kernel is too short for a clock breakdown, so this builds variants of
its source (`--source`, by default the checkout's) that return after each
phase, keeping the phase's results alive through a test that never holds,
and times every variant by its device time in a torch.profiler trace
(200 launches), on the launch shapes of chip_smoke.py: the headline's
class rows, the c6 mix's tier rows and the class rows of a 2048-type
catalog. The variants:

- `entry`: returns at once (the grid's launch and teardown);
- `staged`: after the copies into shared memory and the first barrier;
- `stages`: after the mask words' loop (nonzero keys and intersection);
- `keys`: after the key masks;
- `bounds`: after the bounds, before the last barrier;
- `full`: the kernel as it is.

A phase's cost is its variant's time less the one before. Each cut
point is a `// phase cut: <variant>` line of the source; a source that
lacks one, or has it twice, is refused. Each variant is built with the
checkout's nvcc command (`_build.nvcc_command`) into
`build/typeok_phases/`; the printout has their ptxas lines. Without a
CUDA device it exits 2.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

# (variant, what it keeps alive): the variant returns at the source's
# `// phase cut: <variant>` line
CUTS = (
    ("entry", ""),
    ("staged", "if (po == 0x12345 && pn == 7) R.out[0] = 1;"),
    ("stages", "if (seg == 0x9e3779b97f4a7c15ull && tnz[0] == 3 && tnz[3] == 9 && pnz == 5) R.out[0] = 7;"),
    ("keys", "if (seg == 0x9e3779b97f4a7c15ull && ptol == 5) R.out[0] = 7;"),
    ("bounds", "if (seg == 0x9e3779b97f4a7c15ull && ptol == 5 && bounds == 3) R.out[0] = 7;"),
)


def variants(src: str) -> dict:
    """{variant: source}, the kernel as it is last ("full"). Raises when a
    cut point is missing or not unique."""
    out = {}
    for name, keep in CUTS:
        at = f"  // phase cut: {name} "
        if src.count(at) != 1:
            raise ValueError(f"typeok_phases: the source has {src.count(at)} '{at.strip()}' lines, not one")
        out[name] = src.replace(at, f"  {keep}\n  return;\n{at}", 1)
    out["full"] = src
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", default=str(HERE / "karpenter_tpu_torch" / "csrc" / "typeok.cu"))
    ap.add_argument("--out", default="build/typeok_phases.json")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("typeok_phases: torch.cuda.is_available() is False; this needs the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import chip_smoke as CS
    from karpenter_tpu_torch import _build
    from karpenter_tpu_torch.solver import tpu as T

    work = HERE / "build" / "typeok_phases"
    work.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variants(Path(args.source).read_text()).items():
        (work / f"{name}.cu").write_text(text)
        cmd = _build.nvcc_command(work / f"{name}.cu", work / f"lib{name}.so")
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(log.decode(), file=sys.stderr)
            return 1
        for line in CS.ptxas_lines(log.decode()):
            print(f"ptxas {name}: {line}")
        lib = ctypes.CDLL(str(work / f"lib{name}.so"))
        lib.typeok_screen_launch.argtypes = [ctypes.c_void_p] * 3
        lib.typeok_screen_launch.restype = ctypes.c_int
        libs[name] = lib
    dev = torch.device("cuda")
    its = CS.build_universe(CS.HEADLINE_TYPES)
    shapes = {
        "headline class rows": CS.k1_rows(CS.headline_world(CS.HEADLINE_PODS, its), dev),
        "c6 tier rows": CS.k1_rows(CS.c6_world(CS.C6_PODS, its), dev, tier=True),
        f"{CS.LARGE_CATALOG_TYPES}-type catalog class rows": CS.k1_rows(
            CS.headline_world(CS.LARGE_CATALOG_PODS, CS.build_universe(CS.LARGE_CATALOG_TYPES)), dev),
    }
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    result = {"card": smi, "source": args.source, "shapes": {}}
    for label, k in shapes.items():
        ireq = k.tb.ireq
        half = T._typeok_types(ireq, k.tb.va, ireq.mask.device)
        B, TW = k.rows.mask.shape
        rb, cw = T.typeok_tiling(B, TW, half.args.K)
        out = torch.empty((B, k.iw), dtype=torch.int32, device=dev)
        ptrs = {f: getattr(k.rows, f).data_ptr() for f in T._TYPEOK_FIELDS}
        rows = T._TypeokRows(out=out.data_ptr(), B=B, IW=k.iw, rb=rb, cw=cw, **ptrs)
        times = {}
        for name, lib in libs.items():
            def launch(lib=lib):
                code = lib.typeok_screen_launch(ctypes.byref(half.args), ctypes.byref(rows),
                                                ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
                _build.check_launch(f"typeok variant {name}", code)

            ms = None
            for _ in range(3):  # a trace now and then shows no kernel; take another
                ms = CS.device_ms(launch, 200, ("typeok_kernel",))
                if ms is not None:
                    break
            times[name] = ms
        result["shapes"][label] = {"B": B, "IW": k.iw, "TW": TW, "rb": rb, "cw": cw, "device_ms": times}
        print(f"{label} (B={B}, IW={k.iw}, TW={TW}, rb={rb}, cw={cw}): device ms {json.dumps(times)}",
              flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
