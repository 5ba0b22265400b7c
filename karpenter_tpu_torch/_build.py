"""Build and load the CUDA kernels.

Each `csrc/*.cu` file is compiled by `nvcc` on first use into its own
shared library with a plain C interface, and loaded with ctypes (no
PyTorch headers, so a build takes seconds). Libraries land in
`build/karpenter_tpu_torch/<hash>/` at the repository root, keyed by a hash
of every source in `csrc/` and the flags, so an edit rebuilds and an
unchanged tree reuses the build. All sources compile in parallel, one
`nvcc` each. A failed build, load or launch raises `DeviceError` (a
build with the compiler's output); nothing falls back. A module lock makes the first use build once when several
threads (a fleet window's lanes) reach their first kernel together.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "karpenter_tpu_torch"
SOURCES = (
    "typeok", "scan_step", "run_step", "run_arrays", "dedup_rows", "scan_lanes", "fast_sweep", "set_sweep", "empty",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class DeviceError(RuntimeError):
    """The card failed: a kernel did not build, load or launch. The hybrid
    scheduler's last-resort guard lets it through instead of re-solving on
    the oracle."""


class BuildError(DeviceError):
    """nvcc is missing or refused a source."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise BuildError("nvcc not found (PATH or /usr/local/cuda/bin)")


def nvcc_command(source: Path, out: Path) -> list:
    """The command that builds one source into a shared library."""
    return [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out), str(source)]


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh", ".h"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / _source_hash()


# nvcc processes started and libraries loaded by this process (the
# budgets' rebuild and load counts)
NVCC_STARTS = 0
LIBRARY_LOADS = 0

# held around the first build and each first load: functools.lru_cache
# alone lets two threads that miss together both run the body (two nvcc
# into one directory)
_LOCK = threading.RLock()


def build_all() -> dict:
    """Compile every source not yet built for this hash, all at once.
    Returns {name: {"path", "seconds", "log"}} (seconds 0 when reused; the
    log is the compiler's, kept in `<hash>.logs/` beside the libraries).

    This hash-keyed directory is the port's persistent build cache (the
    counterpart of the JAX package's compilation cache): a process that
    finds it filled invokes no nvcc."""
    with _LOCK:
        return _build_all()


@functools.lru_cache(maxsize=None)
def _build_all() -> dict:
    global NVCC_STARTS
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    starts = {}
    results = {}
    for name in SOURCES:
        lib = out_dir / f"lib{name}.so"
        if lib.exists():
            log_file = _log_path(name)
            log = log_file.read_text(errors="replace") if log_file.exists() else ""
            results[name] = {"path": str(lib), "seconds": 0.0, "log": log}
            continue
        tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = nvcc_command(CSRC / f"{name}.cu", tmp)
        starts[name] = time.monotonic()
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp, lib)
        NVCC_STARTS += 1
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        text = log.decode(errors="replace")
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{text}")
            continue
        # the compiler's log (ptxas's registers and shared memory a kernel)
        # is kept before the library lands, so a reused build still has it
        log_file = _log_path(name)
        log_file.parent.mkdir(parents=True, exist_ok=True)
        log_tmp = log_file.with_name(f"{log_file.name}.{os.getpid()}.tmp")
        log_tmp.write_text(text)
        os.replace(log_tmp, log_file)
        os.replace(tmp, lib)  # atomic: concurrent builders never load a partial file
        results[name] = {
            "path": str(lib),
            "seconds": time.monotonic() - starts[name],
            "log": text,
        }
    if failed:
        raise BuildError("nvcc failed for " + "\n".join(failed))
    return results


def _log_path(name: str) -> Path:
    """Where one source's compiler log is kept: beside the hash directory
    (`<hash>.logs/`), which holds the libraries alone."""
    d = build_dir()
    return d.with_name(d.name + ".logs") / f"lib{name}.log"


_ENTRY_RE = re.compile(r"Compiling entry function '([^']+)'")
_PROPS_RE = re.compile(r"Function properties for (\S+)")
_FRAME_RE = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_USED_RE = re.compile(r"Used (\d+) registers")
_SMEM_RE = re.compile(r"(\d+) bytes smem")


def _demangle(symbol: str) -> str:
    """`_Z15run_step_kernelv` -> `run_step_kernel` (the length-prefixed
    name of an Itanium-mangled function; anything else as it is)."""
    m = re.match(r"_Z(\d+)", symbol)
    if not m:
        return symbol
    start = m.end()
    return symbol[start : start + int(m.group(1))]


def ptxas_resources(log: str) -> dict:
    """{kernel: {"registers", "smem_bytes", "stack_bytes",
    "spill_store_bytes", "spill_load_bytes"}} from an `nvcc -Xptxas -v`
    log: each entry function's registers, static shared memory, stack
    frame and spills, as ptxas reports them for the build's architecture
    (dynamic shared memory, sized at launch, is not in the log). The
    instances of a template share one name and keep the largest of each."""
    out: dict = {}
    current = props = None
    frame = (0, 0, 0)
    for line in log.splitlines():
        m = _ENTRY_RE.search(line)
        if m:
            current, frame = m.group(1), (0, 0, 0)
            continue
        p = _PROPS_RE.search(line)
        if p:
            props = p.group(1)
            continue
        f = _FRAME_RE.search(line)
        if f:
            if props == current:
                frame = tuple(int(g) for g in f.groups())
            continue
        u = _USED_RE.search(line)
        if u and current is not None:
            s = _SMEM_RE.search(line)
            got = {
                "registers": int(u.group(1)),
                "smem_bytes": int(s.group(1)) if s else 0,
                "stack_bytes": frame[0],
                "spill_store_bytes": frame[1],
                "spill_load_bytes": frame[2],
            }
            name = _demangle(current)
            had = out.get(name, {})
            out[name] = {k: max(v, had.get(k, 0)) for k, v in got.items()}
            current = None
    return out


_library: dict[str, ctypes.CDLL] = {}  # the loaded libraries by source name


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one source (built on first use). A library
    already loaded is returned without `_LOCK`, so a caller never waits
    behind a build in flight; a first use builds (`build_all`, single
    flight under the lock), then loads under the lock, once."""
    global LIBRARY_LOADS
    lib = _library.get(name)
    if lib is not None:
        return lib
    path = build_all()[name]["path"]
    with _LOCK:
        lib = _library.get(name)
        if lib is None:
            LIBRARY_LOADS += 1
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise DeviceError(f"{name}: cannot load {path}: {e}") from e
            _library[name] = lib
        return lib


def check_launch(name: str, code: int) -> None:
    """Raise on a nonzero cudaError_t returned by a launch function."""
    if code != 0:
        raise DeviceError(f"{name}: CUDA launch failed with cudaError_t {code}")
