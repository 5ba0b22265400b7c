"""Shared fault-injection harness for the solver service boundary.

`FaultyProxy` is the programmable UDS man-in-the-middle the fault suite
(tests/test_service_faults.py) has soaked the resilience contract with
since the fault-tolerance PR; the differential chaos fuzzer
(karpenter_tpu_torch/testing/fuzz.py chaos mode) replays seeded fuzz cases
through the same proxy, so both consumers inject byte-level faults
through ONE implementation — a proxy behavior fix or a new fault mode
lands in the fault matrix and the fuzzer at once. The port's copy of
karpenter_tpu/testing/faults.py (stdlib only).
"""

from __future__ import annotations

import socket
import threading
import time


class FaultyProxy:
    """A UDS man-in-the-middle with programmable faults on the
    server->client direction (responses), applied once then reverting to
    pass-through:

    - "pass":      forward both directions untouched
    - "blackhole": swallow client bytes; the server never sees the
                   request, the client never gets a response
    - "truncate":  forward the request; relay only `truncate_after` bytes
                   of the response, then close both sides
    - "corrupt":   forward the request; flip the response's first byte
                   (the frame magic) so framing is unrecoverable
    - "delay":     forward the request; sleep `delay` before relaying the
                   response
    """

    def __init__(self, listen_path: str, target_path: str):
        self.listen_path = listen_path
        self.target_path = target_path
        self.mode = "pass"
        self.once = False
        self.delay = 0.0
        self.truncate_after = 20
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(listen_path)
        self._sock.listen(8)
        self._sock.settimeout(0.1)
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()

    def set_fault(self, mode: str, once: bool = True, **kw) -> None:
        with self._lock:
            self.mode = mode
            self.once = once
            for k, v in kw.items():
                setattr(self, k, v)

    def _take_fault(self) -> str:
        with self._lock:
            mode = self.mode
            if self.once and mode != "pass":
                self.mode = "pass"
            return mode

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
        self._sock.close()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                client, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(
                target=self._relay, args=(client,), daemon=True
            ).start()

    def _relay(self, client: socket.socket) -> None:
        mode = self._take_fault()
        try:
            upstream = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            upstream.connect(self.target_path)
        except OSError:
            client.close()
            return
        try:
            if mode == "blackhole":
                # read and discard until the client gives up
                client.settimeout(0.2)
                while not self._stop.is_set():
                    try:
                        if not client.recv(65536):
                            return
                    except socket.timeout:
                        continue
                    except OSError:
                        return
            # pump client -> server in the background
            up = threading.Thread(
                target=self._pump, args=(client, upstream, "pass", 0), daemon=True
            )
            up.start()
            self._pump(upstream, client, mode, self.truncate_after)
        finally:
            for s in (client, upstream):
                try:
                    s.close()
                except OSError:
                    pass

    def _pump(self, src: socket.socket, dst: socket.socket, mode: str, cut: int) -> None:
        relayed = 0
        first = True
        src.settimeout(0.2)
        while not self._stop.is_set():
            try:
                chunk = src.recv(65536)
            except socket.timeout:
                continue
            except OSError:
                return
            if not chunk:
                return
            if mode == "delay" and first:
                time.sleep(self.delay)
            if mode == "corrupt" and first:
                chunk = bytes([chunk[0] ^ 0xFF]) + chunk[1:]
            if mode == "truncate":
                chunk = chunk[: max(0, cut - relayed)]
                if not chunk:
                    return
            first = False
            relayed += len(chunk)
            try:
                dst.sendall(chunk)
            except OSError:
                return
            if mode == "truncate" and relayed >= cut:
                return
