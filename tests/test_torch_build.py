"""The kernel build's first use from many threads (karpenter_tpu_torch/_build.py).

A fleet window's lanes are concurrent threads, and each reaches its first
kernel on first use. With `nvcc` and the library loader stubbed, eight
threads that call `build_all` and `library` together must compile every
source once, into one hash-keyed directory, and load each library once; a
library already loaded is returned without waiting for the build's lock.
"""

import threading
import time
from pathlib import Path

import pytest

from karpenter_tpu_torch import _build


class _FakeNvcc:
    """Stands in for subprocess.Popen: writes the `-o` file after a pause
    (so that concurrent callers overlap) and counts its runs."""

    runs: list = []
    lock = threading.Lock()

    def __init__(self, cmd, stdout=None, stderr=None):
        with _FakeNvcc.lock:
            _FakeNvcc.runs.append(cmd)
        self.out = Path(cmd[cmd.index("-o") + 1])
        self.returncode = 0

    def communicate(self):
        time.sleep(0.05)
        self.out.write_bytes(b"")
        return b"ptxas info: stub", b""


@pytest.fixture
def stubbed_build(monkeypatch, tmp_path):
    _FakeNvcc.runs = []
    loads = []
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", _FakeNvcc)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: loads.append(path) or path)
    _build._build_all.cache_clear()
    _build._library.clear()
    yield loads
    _build._build_all.cache_clear()
    _build._library.clear()


def test_concurrent_first_use_builds_and_loads_once(stubbed_build):
    loads = stubbed_build
    n = 8
    barrier = threading.Barrier(n)
    got, errors = [], []

    def lane(k):
        try:
            barrier.wait(timeout=30)
            got.append((_build.build_all(), _build.library(_build.SOURCES[k % len(_build.SOURCES)])))
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=lane, args=(k,), daemon=True) for k in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors
    assert len(got) == n
    assert len(_FakeNvcc.runs) == len(_build.SOURCES), "every source compiles exactly once"
    assert all(built is got[0][0] for built, _ in got)
    out_dir = _build.build_dir()
    assert sorted(p.name for p in out_dir.iterdir()) == sorted(f"lib{s}.so" for s in _build.SOURCES)
    assert sorted(loads) == sorted({path for _, path in got}), "each library loads once"
    # a second call reuses the build: no compiler, no load
    _build.build_all()
    _build.library(_build.SOURCES[0])
    assert len(_FakeNvcc.runs) == len(_build.SOURCES) and len(loads) == len(set(loads))


def test_a_loaded_library_does_not_wait_behind_the_build_lock(stubbed_build):
    """`library` returns a library already loaded without `_LOCK`: a thread
    that holds the lock (a build in flight) does not delay it."""
    name = _build.SOURCES[0]
    loads0 = _build.LIBRARY_LOADS
    lib = _build.library(name)
    assert _build.LIBRARY_LOADS == loads0 + 1, "a first use counts one load (the budgets' library loads)"
    held, release = threading.Event(), threading.Event()

    def hold():
        with _build._LOCK:
            held.set()
            release.wait(30)

    holder = threading.Thread(target=hold, daemon=True)
    holder.start()
    assert held.wait(30)
    try:
        got = []
        caller = threading.Thread(target=lambda: got.append(_build.library(name)), daemon=True)
        caller.start()
        caller.join(5)
        assert got == [lib], "library() waited behind the held build lock"
    finally:
        release.set()
        holder.join(30)
    assert len(stubbed_build) == 1 and _build.LIBRARY_LOADS == loads0 + 1, "loaded once"
