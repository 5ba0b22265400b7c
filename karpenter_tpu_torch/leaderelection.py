"""Leader election: the single-writer guarantee for HA deployments.

Reference pkg/operator/operator.go:157-182 configures
controller-runtime leader election over a coordination.k8s.io Lease:
candidates race to write their identity into the lease, the holder renews
within the lease duration, and a stuck holder is deposed when the lease
expires. This module implements the same algorithm over a lease FILE
(JSON record, atomically replaced) guarded by an OS-level advisory lock:

- acquisition: take the flock, read the record, and claim iff the lease
  is empty, expired (renewed_at + lease_duration < now), or already ours;
- renewal: the holder re-writes renewed_at every renew_period; a holder
  that cannot renew before expiry considers itself deposed and stops
  acting (the reference manager exits; here `is_leader` turns False and
  Operator.step() goes standby);
- crash safety: the record survives the process, so a crashed leader is
  replaced after one lease_duration — identical to Lease semantics. The
  flock only serializes record updates; it is NOT held between calls, so
  a wedged process cannot fence out successors.

The clock is injected for testability (controllers/kube.FakeClock works).
"""

from __future__ import annotations

import fcntl
import json
import os
import socket
import time
from typing import Optional


class _WallClock:
    def now(self) -> float:
        return time.time()


_instance_seq = iter(range(1, 1 << 62))


class LeaderElector:
    """One candidate's view of a file-backed lease."""

    def __init__(
        self,
        lease_path: str,
        identity: Optional[str] = None,
        lease_duration: float = 15.0,
        renew_period: float = 5.0,
        clock=None,
    ):
        if renew_period >= lease_duration:
            raise ValueError("renew_period must be < lease_duration")
        self.lease_path = lease_path
        # the default identity carries a per-instance nonce: two electors in
        # ONE process (tests, embedded operators) must not alias each other
        self.identity = identity or (
            f"{socket.gethostname()}-{os.getpid()}-{next(_instance_seq)}"
        )
        self.lease_duration = lease_duration
        self.renew_period = renew_period
        self.clock = clock or _WallClock()
        self._last_renew: float = -1.0
        self._leading = False

    # -- record IO (caller holds the flock) ------------------------------

    def _read_record(self) -> dict:
        try:
            with open(self.lease_path) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return {}

    def _write_record(self, rec: dict) -> None:
        tmp = f"{self.lease_path}.{self.identity}.tmp"
        with open(tmp, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, self.lease_path)

    def _with_lock(self, fn):
        lock_path = self.lease_path + ".lock"
        with open(lock_path, "w") as lf:
            fcntl.flock(lf, fcntl.LOCK_EX)
            try:
                return fn()
            finally:
                fcntl.flock(lf, fcntl.LOCK_UN)

    # -- the lease algorithm ---------------------------------------------

    def ensure(self) -> bool:
        """Advance the state machine one tick: acquire if free/expired,
        renew if due, depose ourselves if the record moved on. Returns
        whether this candidate is the leader now. Call from the control
        loop; cheap no-op between renew periods."""
        now = self.clock.now()
        if self._leading and now - self._last_renew < self.renew_period:
            return True

        def step():
            rec = self._read_record()
            holder = rec.get("holder")
            renewed = float(rec.get("renewed_at", 0.0))
            # expiry is judged by the HOLDER's advertised duration (stored
            # in the record) — judging by the challenger's own config would
            # let a short-lease candidate depose a healthy long-lease
            # holder mid-lease and run as a second writer
            holder_duration = float(
                rec.get("lease_duration", self.lease_duration)
            )
            expired = now > renewed + holder_duration
            if holder == self.identity or holder is None or expired:
                self._write_record(
                    {
                        "holder": self.identity,
                        "renewed_at": now,
                        "acquired_at": (
                            rec.get("acquired_at", now)
                            if holder == self.identity
                            else now
                        ),
                        "lease_duration": self.lease_duration,
                    }
                )
                return True
            return False

        got = self._with_lock(step)
        if got:
            self._last_renew = now
        self._leading = got
        return got

    @property
    def is_leader(self) -> bool:
        """Leadership as of the last ensure(); a holder past its own lease
        duration no longer counts itself leader even without a successor
        (the fencing rule that keeps two writers from overlapping)."""
        return (
            self._leading
            and self.clock.now() - self._last_renew <= self.lease_duration
        )

    def release(self) -> None:
        """Voluntary handoff (the reference releases on shutdown so the
        successor needn't wait out the lease)."""
        if not self._leading:
            return

        def step():
            rec = self._read_record()
            if rec.get("holder") == self.identity:
                self._write_record({})

        self._with_lock(step)
        self._leading = False
        self._last_renew = -1.0

    def holder(self) -> Optional[str]:
        """Current holder per the record (observability; may be stale the
        instant it returns)."""
        rec = self._with_lock(self._read_record)
        holder = rec.get("holder")
        if holder is None:
            return None
        if self.clock.now() > float(rec.get("renewed_at", 0.0)) + float(
            rec.get("lease_duration", self.lease_duration)
        ):
            return None  # expired == vacant
        return holder
