"""Disagg transfer layer: stdlib sockets, length-prefixed frames,
bounded send queue with backpressure.

The port's copy of the JAX package's transport
(llama_fastapi_k8s_gpu_tpu/serving/disagg/transport.py); a received frame
lands in one writable buffer, which the page decoder views in place.  Two
small pieces, both deliberately boring:

- :class:`FrameConn` — one blocking TCP connection speaking the
  serving/disagg/wire.py frame format.  Reads are exact (a short read IS
  a :class:`~.wire.WireError`, never a silent partial); the length
  prefix is sanity-bounded before any allocation.  The fault-injection
  points ``slow_wire`` and ``truncated_frame`` (utils/faults.py) live on
  the send path so the drills exercise a stalling and a torn wire
  without a real network fault.

- :class:`FrameSender` — a bounded queue + one sender thread per peer
  connection.  ``put()`` BLOCKS when the queue is full: a slow or
  wedged wire applies backpressure to the prefill tier's page export
  instead of buffering unboundedly (the buffered bytes are reported
  into the memory ledger as the ``disagg_txbuf`` component by the
  owning PrefillServer).  A send failure latches: every later ``put``
  raises immediately, so a producer mid-stream learns the peer is gone
  within one frame.
"""

from __future__ import annotations

import logging
import queue as queue_mod
import socket
import struct
import threading

from ...utils.faults import FAULTS, FaultError
from .wire import MAX_FRAME, WireError, decode_frame, encode_frame

logger = logging.getLogger(__name__)

_LEN = struct.Struct("!I")


class FrameConn:
    """One framed, blocking socket.  Not thread-safe per direction: one
    reader thread and one writer thread at most (the roles use exactly
    that shape — FrameSender owns the writes)."""

    def __init__(self, sock: socket.socket):
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        self._sock = sock

    def settimeout(self, t: float | None) -> None:
        self._sock.settimeout(t)

    def _recv_exact(self, n: int) -> memoryview:
        """Exactly ``n`` bytes, read into one writable buffer (a PAGE
        payload is then viewed, not copied, by ``wire.decode_pages``)."""
        buf = bytearray(n)
        view = memoryview(buf)
        got = 0
        while got < n:
            k = self._sock.recv_into(view[got:], min(n - got, 1 << 20))
            if not k:
                raise WireError(
                    f"connection closed mid-frame ({got}/{n} bytes)")
            got += k
        return view

    def recv_frame(self) -> tuple[int, dict, bytes]:
        """(ftype, header, payload) — raises :class:`WireError` on a
        truncated/oversized/malformed frame, ``socket.timeout``/``OSError``
        on transport failure.  EOF between frames raises ConnectionError
        (clean close), EOF inside one raises WireError (torn)."""
        head = self._sock.recv(_LEN.size)
        if not head:
            raise ConnectionError("peer closed the connection")
        if len(head) < _LEN.size:
            head += bytes(self._recv_exact(_LEN.size - len(head)))
        (n,) = _LEN.unpack(head)
        if n > MAX_FRAME:
            raise WireError(f"frame length {n} exceeds MAX_FRAME")
        return decode_frame(self._recv_exact(n))

    def send_raw(self, buf: bytes) -> None:
        """Write one pre-encoded frame.  THE injection site: ``slow_wire``
        (mode slow stalls here) and ``truncated_frame`` (mode error ships
        a deliberately torn frame, then closes — the receiving side must
        refuse it, never restore partial KV)."""
        FAULTS.fire("slow_wire")
        try:
            FAULTS.fire("truncated_frame")
        except FaultError:
            try:
                self._sock.sendall(buf[:max(_LEN.size + 1, len(buf) // 2)])
            finally:
                self.close()
            raise WireError("truncated frame injected (drill)") from None
        self._sock.sendall(buf)

    def send_frame(self, ftype: int, header: dict,
                   payload: bytes = b"") -> None:
        self.send_raw(encode_frame(ftype, header, payload))

    def close(self) -> None:
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


class FrameSender:
    """Bounded async frame writer for one connection (the prefill tier's
    page stream).  The producer's ``put()`` blocks once ``max_frames``
    are queued — THE backpressure contract: a slow wire throttles page
    export instead of growing the process."""

    # put() runs on the handler thread, _loop on the sender thread; the
    # byte counter and the latched error cross between them under _lock.
    # The queue itself is the stdlib's (internally locked).

    # put() runs on the handler thread, _loop on the sender thread; the
    # byte counter and the latched error cross between them under _lock.
    # The queue itself is the stdlib's (internally locked).
    _GUARDED_BY = {"_buffered": "_lock", "_error": "_lock"}
    _THREAD_ENTRIES = ("_loop",)
    _SHARED_ATOMIC = ("_q", "_closed")

    def __init__(self, conn: FrameConn, max_frames: int = 32):
        self._conn = conn
        self._q: queue_mod.Queue = queue_mod.Queue(
            maxsize=max(1, int(max_frames)))
        self._lock = threading.Lock()
        self._buffered = 0
        self._error: BaseException | None = None
        self._closed = False
        self._thread = threading.Thread(
            target=self._loop, name="lfkt-disagg-send", daemon=True)
        self._thread.start()

    def buffered_bytes(self) -> int:
        """Queued-but-unsent frame bytes (memory ledger: disagg_txbuf)."""
        with self._lock:
            return self._buffered

    def _set_error(self, e: BaseException) -> None:
        with self._lock:
            if self._error is None:
                self._error = e

    def put(self, ftype: int, header: dict, payload: bytes = b"",
            timeout: float = 30.0) -> None:
        """Queue one frame; blocks (bounded by ``timeout``, never
        unbounded — a producer must not wedge behind a dead wire) when
        the queue is full — backpressure.  Raises the sender thread's
        latched error (the wire is dead: stop producing pages) or
        ``queue.Full`` when the wire is too slow for the timeout."""
        buf = encode_frame(ftype, header, payload)
        # account BEFORE the enqueue: the sender thread can only see (and
        # decrement) a frame whose increment already happened, so the
        # disagg_txbuf gauge can never drift upward on a fast wire
        with self._lock:
            if self._error is not None:
                raise self._error
            self._buffered += len(buf)
        try:
            self._q.put(buf, timeout=timeout)
        except queue_mod.Full:
            with self._lock:
                self._buffered = max(0, self._buffered - len(buf))
            raise
        with self._lock:
            if self._error is not None:
                # the wire died while we enqueued: this frame will never
                # send (the error-path drain may already have missed it)
                self._buffered = max(0, self._buffered - len(buf))
                raise self._error

    def _drain(self) -> None:
        """Empty the queue after a latched error: frames are
        undeliverable, and a producer blocked in ``put`` on a full queue
        must get its slot back so it can observe the error and stop."""
        while True:
            try:
                self._q.get_nowait()
            except queue_mod.Empty:
                return

    def _loop(self) -> None:
        while True:
            buf = self._q.get()
            if buf is None:
                return
            try:
                self._conn.send_raw(buf)
            except BaseException as e:  # noqa: BLE001 — latch, drain, stop:
                # the producer sees the error on its next put(); frames
                # already queued are undeliverable and dropped
                self._set_error(e)
                self._conn.close()
                self._drain()
                with self._lock:
                    self._buffered = 0
                return
            finally:
                with self._lock:
                    self._buffered = max(0, self._buffered - len(buf))

    def close(self, join_timeout: float = 2.0) -> None:
        """Stop the sender after the queued frames drain (or its error)."""
        if self._closed:
            return
        self._closed = True
        try:
            self._q.put(None, timeout=join_timeout)
        except queue_mod.Full:
            self._set_error(RuntimeError("sender queue wedged at close"))
            self._conn.close()
        self._thread.join(timeout=join_timeout)


def connect(host: str, port: int, timeout: float) -> FrameConn:
    """Dial the prefill tier's page service (decode side)."""
    return FrameConn(socket.create_connection((host, port), timeout=timeout))
