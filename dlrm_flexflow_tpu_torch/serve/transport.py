"""Pluggable transport for the serving seams' wire protocol (the
counterpart of ``dlrm_flexflow_tpu.serve.transport``; a client of either
package talks to a server of the other).

``serve/wire.py`` defines the frames; this module carries them. Two
transports:

- **inproc** — the default is no transport at all: the shard tier,
  fleet, and watcher keep calling methods (today's zero-serialization
  fast path, bit-identical to pre-wire behavior). For tests and
  single-process deployments that want the full codec + fault seams
  without sockets, :class:`InprocTransport` loops frames through a
  :class:`WireServer`'s dispatch in-process.
- **tcp** — :class:`WireClient` over real sockets: a small connection
  pool with a lock per connection, per-request deadlines through the
  existing
  :class:`~..utils.watchdog.Deadline`, and bounded retry with
  exponential backoff on transient frame errors (CRC mismatch, torn
  stream, refused/reset connections). Retries reuse the SAME
  request-id, so a retry racing a slow-but-delivered original is
  answered from the server's dedup window instead of being applied
  twice.

Network-level fault injection (``FF_FAULT_NET_*``) is applied HERE,
against real frames: drop (client raises a transient error pre-send and
its retry budget absorbs it), duplicate (client sends the frame twice;
the server's request-id dedup proves the second delivery a no-op),
reorder (server defers a frame until a later arrival has been handled),
slow-link (client sleeps per frame). Per-seam RTT Reservoirs and
``ff_wire_*`` counters make every seam's behavior scrapeable.

The seam proxies live here too: :class:`RemoteShard` (an
:class:`~.shardtier.EmbeddingShard` client the tier's breaker/
degradation machinery drives unchanged), :class:`ShardServer`,
:class:`RemoteEngineClient`/:class:`EngineServer` (the
FleetRouter→replica dispatch seam), and :class:`SnapshotServer` (the
watcher's manifest + file-fetch seam).
"""

from __future__ import annotations

import os
import socket
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..obs import metrics as obsm
from ..utils import faults
from ..utils.logging import get_logger
from ..utils.watchdog import Deadline, Heartbeat
from . import wire
from .wire import FrameError

log_wire = get_logger("serve.transport")

# seam names (the FF_FAULT_NET_* and ff_wire_* vocabulary)
SEAM_LOOKUP = "lookup"      # ranker -> embedding shard
SEAM_DISPATCH = "dispatch"  # router -> ranker replica
SEAM_PUBLISH = "publish"    # watcher/publisher -> embedding shard
SEAM_MANIFEST = "manifest"  # watcher -> publish directory
SEAMS = (SEAM_LOOKUP, SEAM_DISPATCH, SEAM_PUBLISH, SEAM_MANIFEST)

TRANSPORTS = ("inproc", "tcp")


class WireError(ConnectionError):
    """Transport failure after the retry budget: unreachable peer,
    deadline expired mid-exchange, or persistent frame corruption. The
    caller's circuit breaker treats it like any other seam outage."""


class WireRemoteError(RuntimeError):
    """The server's handler raised something the wire has no typed
    mapping for; carries ``{type}: {message}`` verbatim."""


# ---------------------------------------------------------------------
# per-seam telemetry (RTT Reservoirs + ff_wire_* counters)
# ---------------------------------------------------------------------
class _WireTelemetry:
    """Process-wide wire counters and per-seam RTT windows. Plain ints
    under one lock (obs may be off; stats() needs them either way);
    registered as an obs collector so ``--obs on`` scrapes the same
    numbers as ``ff_wire_*`` series."""

    COUNTERS = ("frames_sent", "frames_recv", "bytes_sent",
                "bytes_recv", "retries", "crc_errors", "drops", "dups",
                "reorders", "dedup_hits", "remote_errors")

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Dict[Tuple[str, str], int] = {}
        self._rtt: Dict[str, Any] = {}
        self._registered = False

    def _ensure_registered(self) -> None:
        # obs collectors resolve at configure time; register lazily so a
        # transport built after ``--obs on`` shows up in /metrics
        if not self._registered:
            self._registered = True
            obsm.register_collector(self._obs_collect)

    def count(self, seam: str, counter: str, n: int = 1) -> None:
        with self._lock:
            key = (seam, counter)
            self._counts[key] = self._counts.get(key, 0) + n

    def rtt_reservoir(self, seam: str):
        with self._lock:
            res = self._rtt.get(seam)
            if res is None:
                res = obsm.latency_reservoir(
                    "ff_wire_rtt_ms",
                    "one wire request round trip, per serving seam",
                    maxlen=2048, seam=seam)
                self._rtt[seam] = res
            return res

    def observe_rtt(self, seam: str, ms: float) -> None:
        self.rtt_reservoir(seam).observe(ms)

    def measured_rtt_floor(self, seam: str) -> Optional[float]:
        """The seam's observed p50 RTT, or None before any traffic."""
        with self._lock:
            res = self._rtt.get(seam)
        if res is None:
            return None
        p50 = res.percentile(50)
        return None if not p50 else float(p50)

    def _obs_collect(self):
        with self._lock:
            items = sorted(self._counts.items())
        for (seam, counter), n in items:
            yield f"ff_wire_{counter}_total", {"seam": seam}, n

    def stats(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        with self._lock:
            seams = sorted({s for s, _ in self._counts} |
                           set(self._rtt))
            for seam in seams:
                d = {c: self._counts.get((seam, c), 0)
                     for c in self.COUNTERS
                     if self._counts.get((seam, c), 0)}
                res = self._rtt.get(seam)
                if res is not None and res.count:
                    d["rtt_p50_ms"] = res.percentile(50)
                    d["rtt_p99_ms"] = res.percentile(99)
                out[seam] = d
        return out

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()
            self._rtt.clear()


_TELEMETRY = _WireTelemetry()


def wire_stats() -> Dict[str, Any]:
    """Per-seam wire counters + RTT percentiles (everything the
    ``ff_wire_*`` series export, as one dict)."""
    return _TELEMETRY.stats()


def measured_rtt_floor(seam: str = SEAM_LOOKUP) -> Optional[float]:
    return _TELEMETRY.measured_rtt_floor(seam)


def reset_wire_stats() -> None:
    """Test isolation: drop every counter and RTT window."""
    _TELEMETRY.reset()


# ---------------------------------------------------------------------
# request ids
# ---------------------------------------------------------------------
_RID_LOCK = threading.Lock()
_RID_NEXT = [((os.getpid() & 0xFFFF) << 32) | 1]


def next_request_id() -> int:
    """Process-unique, monotonic. The pid salt keeps two processes'
    streams to one server from colliding in its dedup window."""
    with _RID_LOCK:
        rid = _RID_NEXT[0]
        _RID_NEXT[0] = rid + 1
    return rid


def _raise_remote(meta: Dict[str, Any], seam: str) -> None:
    """Re-raise a server-side failure as the typed error the client's
    breaker logic already understands. Applied errors are NOT retried by
    the transport — the handler ran; only the byte carriage failed
    cases retry."""
    kind = str(meta.get("type", ""))
    msg = str(meta.get("message", ""))
    _TELEMETRY.count(seam, "remote_errors")
    if kind == "ShardDown":
        from .shardtier import ShardDown
        raise ShardDown(meta.get("shard_id"), msg)
    if kind == "ShardLookupTimeout":
        from .shardtier import ShardLookupTimeout
        raise ShardLookupTimeout(msg)
    if kind == "ChainError":
        from ..utils.delta import ChainError
        raise ChainError(msg)
    if kind == "ReplicaDown":
        from .engine import ReplicaDown
        raise ReplicaDown(meta.get("replica_id"), msg)
    if kind == "Overloaded":
        from .engine import Overloaded
        raise Overloaded(-1, -1)
    if kind == "ValueError":
        raise ValueError(msg)
    raise WireRemoteError(f"{kind}: {msg}")


# ---------------------------------------------------------------------
# the tcp client
# ---------------------------------------------------------------------
class _Conn:
    """One pooled socket + its lock (held while a request is in flight
    on it)."""

    def __init__(self, sock: socket.socket, name: str):
        self.sock = sock
        self.name = name
        self.lock = threading.Lock()
        self.dead = False


class WireClient:
    """Pooled, deadline-bounded, retrying client to ONE wire server.

    Transient failures (connect refused/reset, torn stream, CRC
    mismatch, injected drop) burn the connection and retry with
    exponential backoff up to ``retries`` times within the per-request
    :class:`Deadline`; the request-id is minted once per request, so a
    retry that crosses a slow-but-delivered original is served from the
    server's dedup window. Typed server-side errors (ShardDown,
    ChainError, ...) are re-raised without retry — the handler ran."""

    def __init__(self, address: Tuple[str, int], *,
                 seam: str = SEAM_LOOKUP, retries: int = 2,
                 backoff_ms: float = 5.0, pool_size: int = 2,
                 connect_timeout_s: float = 5.0,
                 default_deadline_s: float = 10.0, name: str = ""):
        self.address = (str(address[0]), int(address[1]))
        self.seam = seam
        self.retries = max(int(retries), 0)
        self.backoff_ms = float(backoff_ms)
        self.pool_size = max(int(pool_size), 1)
        self.connect_timeout_s = float(connect_timeout_s)
        self.default_deadline_s = float(default_deadline_s)
        self.name = name or f"{self.address[0]}:{self.address[1]}"
        self._pool_lock = threading.Lock()
        self._idle: List[_Conn] = []
        self._made = 0
        self._closed = False
        self.wire_retries = 0
        self.last_wire_error = ""
        _TELEMETRY._ensure_registered()

    # --- pool ---------------------------------------------------------
    def _borrow(self, dl: Deadline) -> _Conn:
        with self._pool_lock:
            if self._closed:
                raise WireError(f"client {self.name} is closed")
            if self._idle:
                return self._idle.pop()
            n = self._made
            self._made += 1
        timeout = min(self.connect_timeout_s,
                      max(dl.remaining(), 0.001))
        try:
            sock = socket.create_connection(self.address,
                                            timeout=timeout)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError as e:
            raise WireError(
                f"shard/replica process unreachable at "
                f"{self.address[0]}:{self.address[1]}: {e}") from e
        return _Conn(sock, f"WireClient.conn[{self.name}#{n}]")

    def _give_back(self, conn: _Conn) -> None:
        if conn.dead:
            self._close_conn(conn)
            return
        with self._pool_lock:
            if not self._closed and len(self._idle) < self.pool_size:
                self._idle.append(conn)
                return
        self._close_conn(conn)

    @staticmethod
    def _close_conn(conn: _Conn) -> None:
        try:
            conn.sock.close()
        except OSError:
            pass

    # --- one request --------------------------------------------------
    def request(self, opcode: int, payload: bytes,
                deadline_s: Optional[float] = None
                ) -> Tuple[int, bytes]:
        """Send one frame, return ``(opcode, payload)`` of its response.
        Raises :class:`WireError` when the budget is spent, or the
        re-raised typed error when the server's handler failed."""
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        dl = Deadline(deadline_s)
        rid = next_request_id()
        frame = wire.encode_frame(opcode, rid, payload)
        seam = self.seam
        attempt = 0
        while True:
            err: Optional[BaseException] = None
            t0 = time.perf_counter()
            try:
                faults.maybe_net_slow(seam)
                if faults.take_net_drop(seam):
                    _TELEMETRY.count(seam, "drops")
                    raise FrameError(
                        f"injected frame drop on seam {seam!r}")
                resp = self._exchange(frame, rid, dl, seam)
            except (FrameError, OSError) as e:
                # OSError covers socket.timeout / reset / refused; a
                # FrameError means stream framing is lost — either way
                # the connection is burned and the attempt retries
                if isinstance(e, FrameError):
                    _TELEMETRY.count(seam, "crc_errors")
                err = e
            else:
                r_op, r_payload = resp
                _TELEMETRY.observe_rtt(
                    seam, 1e3 * (time.perf_counter() - t0))
                if r_op == wire.OP_ERR:
                    _raise_remote(wire.decode_error(r_payload), seam)
                return r_op, r_payload
            attempt += 1
            self.last_wire_error = f"{type(err).__name__}: {err}"
            if attempt > self.retries or dl.expired() or self._closed:
                raise WireError(
                    f"{wire.opcode_name(opcode)} to {self.name} failed "
                    f"after {attempt} attempt(s) "
                    f"({dl.elapsed() * 1e3:.0f} ms of "
                    f"{dl.seconds * 1e3:.0f} ms budget): "
                    f"{self.last_wire_error}") from err
            self.wire_retries += 1
            _TELEMETRY.count(seam, "retries")
            time.sleep(min((self.backoff_ms / 1e3) * (2 ** (attempt - 1)),
                           max(dl.remaining(), 0.0)))

    def _exchange(self, frame: bytes, rid: int, dl: Deadline,
                  seam: str) -> Tuple[int, bytes]:
        conn = self._borrow(dl)
        try:
            with conn.lock:
                conn.dead = True   # healthy again only on a clean round
                conn.sock.settimeout(max(dl.remaining(), 0.001))
                dup = faults.take_net_dup(seam)
                conn.sock.sendall(frame)
                _TELEMETRY.count(seam, "frames_sent")
                _TELEMETRY.count(seam, "bytes_sent", len(frame))
                if dup:
                    # same request-id on the wire twice: the server's
                    # dedup must answer both without re-running the
                    # handler
                    _TELEMETRY.count(seam, "dups")
                    conn.sock.sendall(frame)
                    _TELEMETRY.count(seam, "frames_sent")
                    _TELEMETRY.count(seam, "bytes_sent", len(frame))
                r_op, r_rid, r_payload = wire.read_frame(conn.sock)
                _TELEMETRY.count(seam, "frames_recv")
                _TELEMETRY.count(seam, "bytes_recv",
                                 wire.HEADER_BYTES + len(r_payload))
                if dup:
                    # drain the duplicate's response so it cannot
                    # poison the next request on this connection
                    d_op, d_rid, _d = wire.read_frame(conn.sock)
                    _TELEMETRY.count(seam, "frames_recv")
                    if d_rid != rid or d_op != r_op:
                        raise FrameError(
                            f"duplicate response mismatch: "
                            f"{wire.opcode_name(d_op)}/{d_rid:#x} vs "
                            f"{wire.opcode_name(r_op)}/{rid:#x}")
                if r_rid != rid:
                    raise FrameError(
                        f"response request-id {r_rid:#x} != sent "
                        f"{rid:#x} (stream desynchronized)")
                conn.dead = False
                return r_op, r_payload
        finally:
            self._give_back(conn)

    def stats(self) -> Dict[str, Any]:
        return {"address": f"{self.address[0]}:{self.address[1]}",
                "seam": self.seam,
                "wire_retries": self.wire_retries,
                "last_wire_error": self.last_wire_error}

    def close(self) -> None:
        with self._pool_lock:
            self._closed = True
            idle, self._idle = self._idle, []
        for conn in idle:
            self._close_conn(conn)


# ---------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------
class WireServer:
    """Threaded frame server: one accept loop, one thread per
    connection, all ff-named daemons, all joined on close.

    ``handlers`` maps request opcodes to ``fn(payload) -> payload``;
    the response echoes the opcode with ``RESP_BIT``; a handler
    exception becomes an ``OP_ERR`` frame carrying the typed error.
    A bounded request-id dedup window answers repeated ids from cache
    without re-invoking the handler — what makes client retries and
    injected duplicates provably idempotent. The ``FF_FAULT_NET_REORDER``
    seam applies here: a marked frame's processing is deferred until a
    LATER frame (any connection) has been handled, bounded by a timeout
    so a lone frame cannot deadlock."""

    DEDUP_WINDOW = 512
    REORDER_HOLD_S = 0.25

    def __init__(self, handlers: Dict[int, Callable[[bytes], bytes]],
                 host: str = "127.0.0.1", port: int = 0,
                 seam: str = SEAM_LOOKUP, name: str = "wire"):
        self.handlers = dict(handlers)
        self.seam = seam
        self.name = name
        self._host = host
        self._port = int(port)
        self._listener: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._conn_threads: List[threading.Thread] = []
        self._conns: List[socket.socket] = []
        self._conn_lock = threading.Lock()
        self._stop = threading.Event()
        self._dedup: "OrderedDict[int, Tuple[int, bytes]]" = \
            OrderedDict()
        self._dedup_lock = threading.Lock()
        # reorder bookkeeping: a plain Condition (internal ordering
        # primitive, never held across handler work)
        self._order = threading.Condition()
        self._handled = 0
        self.requests = 0
        self.dedup_hits = 0
        _TELEMETRY._ensure_registered()

    # --- lifecycle ----------------------------------------------------
    @property
    def address(self) -> Tuple[str, int]:
        return (self._host, self._port)

    def start(self) -> "WireServer":
        if self._listener is not None:
            return self
        self._listener = socket.create_server(
            (self._host, self._port), backlog=64)
        self._port = self._listener.getsockname()[1]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"ff-wire-accept-{self.name}")
        self._accept_thread.start()
        log_wire.info("wire server %s listening on %s:%d (seam %s)",
                      self.name, self._host, self._port, self.seam)
        return self

    def serve_forever(self) -> None:
        """Start and block until :meth:`close` (a shard process's main
        thread parks here)."""
        self.start()
        self._stop.wait()

    def close(self) -> None:
        self._stop.set()
        listener = self._listener
        self._listener = None
        if listener is not None:
            # closing alone does not wake a thread blocked in accept();
            # a shutdown does
            try:
                listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                listener.close()
            except OSError:
                pass
        with self._conn_lock:
            conns, self._conns = self._conns, []
            threads = list(self._conn_threads)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        t = self._accept_thread
        self._accept_thread = None
        if t is not None:
            t.join(5.0)
        for t in threads:
            t.join(5.0)
        with self._order:
            self._order.notify_all()

    def __enter__(self) -> "WireServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # --- loops --------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            listener = self._listener
            if listener is None:
                return
            try:
                sock, _addr = listener.accept()
            except OSError:
                return   # listener closed
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conn_lock:
                if self._stop.is_set():
                    sock.close()
                    return
                self._conns.append(sock)
                t = threading.Thread(
                    target=self._serve_conn, args=(sock,), daemon=True,
                    name=f"ff-wire-conn-{self.name}"
                         f"-{len(self._conn_threads)}")
                self._conn_threads.append(t)
            t.start()

    def _serve_conn(self, sock: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                try:
                    opcode, rid, payload = wire.read_frame(sock)
                except (ConnectionError, OSError):
                    return   # peer went away / server closing
                except FrameError as e:
                    # framing is lost on this stream: drop the
                    # connection, the client retries on a fresh one
                    log_wire.warning(
                        "wire server %s dropping connection: %s",
                        self.name, e)
                    return
                if faults.take_net_reorder(self.seam):
                    _TELEMETRY.count(self.seam, "reorders")
                    self._hold_for_reorder()
                resp_op, resp_payload = self.dispatch(opcode, rid,
                                                      payload)
                try:
                    wire.write_frame(sock, resp_op, rid, resp_payload)
                except (ConnectionError, OSError):
                    return
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def _hold_for_reorder(self) -> None:
        """Defer this frame until another frame has been handled (or
        the hold window expires — a lone frame must not deadlock)."""
        with self._order:
            target = self._handled + 1
            self._order.wait_for(
                lambda: self._handled >= target or self._stop.is_set(),
                timeout=self.REORDER_HOLD_S)

    # --- dispatch (shared with InprocTransport) -----------------------
    def dispatch(self, opcode: int, rid: int,
                 payload: bytes) -> Tuple[int, bytes]:
        """Dedup-checked handler invocation; returns the response
        (opcode, payload) and caches it under the request-id."""
        with self._dedup_lock:
            hit = self._dedup.get(rid)
            if hit is not None:
                self.dedup_hits += 1
                _TELEMETRY.count(self.seam, "dedup_hits")
                return hit
        handler = self.handlers.get(opcode)
        try:
            if handler is None:
                raise WireRemoteError(
                    f"server {self.name} has no handler for "
                    f"{wire.opcode_name(opcode)}")
            resp = (opcode | wire.RESP_BIT, handler(payload))
        except Exception as e:   # noqa: BLE001 — becomes an OP_ERR frame
            resp = (wire.OP_ERR, wire.encode_error(e))
        with self._dedup_lock:
            self.requests += 1
            self._dedup[rid] = resp
            while len(self._dedup) > self.DEDUP_WINDOW:
                self._dedup.popitem(last=False)
        with self._order:
            self._handled += 1
            self._order.notify_all()
        return resp

    def stats(self) -> Dict[str, Any]:
        return {"address": f"{self._host}:{self._port}",
                "seam": self.seam, "requests": self.requests,
                "dedup_hits": self.dedup_hits}


class InprocTransport:
    """Loopback transport: the full frame codec + fault seams + dedup
    against a :class:`WireServer`'s dispatch, no sockets. Same
    ``request()`` surface as :class:`WireClient`."""

    def __init__(self, server: WireServer, *,
                 seam: Optional[str] = None, retries: int = 2,
                 backoff_ms: float = 1.0,
                 default_deadline_s: float = 10.0):
        self._server = server
        self.seam = seam or server.seam
        self.retries = max(int(retries), 0)
        self.backoff_ms = float(backoff_ms)
        self.default_deadline_s = float(default_deadline_s)
        self.wire_retries = 0
        self.last_wire_error = ""

    def request(self, opcode: int, payload: bytes,
                deadline_s: Optional[float] = None
                ) -> Tuple[int, bytes]:
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        dl = Deadline(deadline_s)
        rid = next_request_id()
        frame = wire.encode_frame(opcode, rid, payload)
        seam = self.seam
        attempt = 0
        while True:
            t0 = time.perf_counter()
            err: Optional[BaseException] = None
            try:
                faults.maybe_net_slow(seam)
                if faults.take_net_drop(seam):
                    _TELEMETRY.count(seam, "drops")
                    raise FrameError(
                        f"injected frame drop on seam {seam!r}")
                sends = 2 if faults.take_net_dup(seam) else 1
                if sends == 2:
                    _TELEMETRY.count(seam, "dups")
                resp = None
                for _ in range(sends):
                    f_op, f_rid, f_payload = wire.decode_frame(frame)
                    _TELEMETRY.count(seam, "frames_sent")
                    _TELEMETRY.count(seam, "bytes_sent", len(frame))
                    resp = self._server.dispatch(f_op, f_rid, f_payload)
                    _TELEMETRY.count(seam, "frames_recv")
            except FrameError as e:
                _TELEMETRY.count(seam, "crc_errors")
                err = e
            else:
                r_op, r_payload = resp
                _TELEMETRY.observe_rtt(
                    seam, 1e3 * (time.perf_counter() - t0))
                if r_op == wire.OP_ERR:
                    _raise_remote(wire.decode_error(r_payload), seam)
                return r_op, r_payload
            attempt += 1
            self.last_wire_error = f"{type(err).__name__}: {err}"
            if attempt > self.retries or dl.expired():
                raise WireError(
                    f"{wire.opcode_name(opcode)} (inproc) failed after "
                    f"{attempt} attempt(s): "
                    f"{self.last_wire_error}") from err
            self.wire_retries += 1
            _TELEMETRY.count(seam, "retries")
            time.sleep(min((self.backoff_ms / 1e3) * (2 ** (attempt - 1)),
                           max(dl.remaining(), 0.0)))

    def stats(self) -> Dict[str, Any]:
        return {"address": "inproc", "seam": self.seam,
                "wire_retries": self.wire_retries,
                "last_wire_error": self.last_wire_error}

    def close(self) -> None:
        pass


# ---------------------------------------------------------------------
# shard seam: server + client proxy
# ---------------------------------------------------------------------
class ShardServer:
    """One :class:`~.shardtier.EmbeddingShard` behind a wire server —
    what :meth:`EmbeddingShard.serve_forever` runs, and what a shard
    OS process is."""

    def __init__(self, shard, host: str = "127.0.0.1", port: int = 0):
        self.shard = shard
        self._server = WireServer(
            {
                wire.OP_LOOKUP: self._on_lookup,
                wire.OP_PUBLISH: self._on_publish,
                wire.OP_INSTALL: self._on_install,
                wire.OP_PROBE: self._on_probe,
                wire.OP_STATS: self._on_stats,
            },
            host=host, port=port, seam=SEAM_LOOKUP,
            name=f"shard{shard.slot}")

    # --- handlers -----------------------------------------------------
    def _on_lookup(self, payload: bytes) -> bytes:
        requests = wire.decode_lookup_request(payload)
        out, version = self.shard.lookup(requests)
        return wire.encode_lookup_response(out, version)

    def _on_publish(self, payload: bytes) -> bytes:
        sub, version, expect_crc = wire.decode_publish(payload)
        applied = self.shard.apply_publish(sub, version, expect_crc)
        return wire.encode_payload(
            {"applied": bool(applied), "version": self.shard.version,
             "chain_crc": self.shard.chain_crc})

    def _on_install(self, payload: bytes) -> bytes:
        blocks, version, chain_crc = wire.decode_blocks(payload)
        applied = self.shard.install_blocks(blocks, version,
                                            chain_crc=chain_crc)
        return wire.encode_payload(
            {"applied": bool(applied), "version": self.shard.version,
             "chain_crc": self.shard.chain_crc})

    def _on_probe(self, payload: bytes) -> bytes:
        s = self.shard
        return wire.encode_payload(
            {"sid": s.sid, "slot": s.slot, "domain": s.domain,
             "version": s.version, "chain_crc": s.chain_crc,
             "hbm_bytes": s.hbm_bytes(),
             "quant": dict(getattr(s, "quant", {}) or {})})

    def _on_stats(self, payload: bytes) -> bytes:
        # the shard's counters, and this process's wire counters (what a
        # fault drill injected server-side, such as reorders)
        return wire.encode_payload(dict(self.shard.stats(),
                                        wire=wire_stats()))

    # --- lifecycle ----------------------------------------------------
    @property
    def address(self) -> Tuple[str, int]:
        return self._server.address

    def start(self) -> "ShardServer":
        self._server.start()
        return self

    def serve_forever(self) -> None:
        self._server.serve_forever()

    def close(self) -> None:
        self._server.close()

    def stats(self) -> Dict[str, Any]:
        return self._server.stats()


class RemoteShard:
    """Client-side proxy speaking :class:`~.shardtier.EmbeddingShard`'s
    serving surface over a transport. The tier's
    :class:`~.shardtier.ShardReplica` wraps it unchanged — retries,
    ejection, probing, degradation, and publish fan-out all drive this
    object exactly as they drive a local shard; only the byte carriage
    differs. Versions/CRCs are cached from every response's in-band
    copy, so ``min_version()``/``version_vector()`` stay O(1) reads."""

    # the set's warm-cache persistence reads blocks_copy(); a remote
    # shard's blocks live in another process — its own boot source (the
    # seeded ShardCache) already covers replacement
    supports_persist = False
    remote = True

    def __init__(self, sid: int, slot: int, transport, *,
                 domain: str = "", quant: Optional[Dict[str, str]] = None,
                 lookup_deadline_s: float = 10.0,
                 publish_deadline_s: float = 30.0):
        self.sid = int(sid)
        self.slot = int(slot)
        self.domain = domain
        self.quant = dict(quant or {})
        self.transport = transport
        self.lookup_deadline_s = float(lookup_deadline_s)
        self.publish_deadline_s = float(publish_deadline_s)
        self._version = 0
        self._chain_crc = 0
        self._hbm_bytes = 0

    # --- EmbeddingShard surface ---------------------------------------
    @property
    def version(self) -> int:
        return self._version

    @property
    def chain_crc(self) -> int:
        return self._chain_crc

    def hbm_bytes(self) -> int:
        return self._hbm_bytes

    def _adopt_meta(self, meta: Dict[str, Any]) -> None:
        """Adopt a response's in-band version/CRC MONOTONICALLY.

        Responses are written back by whichever client thread receives
        them, so a reordered/duplicated frame's stale version can land
        here AFTER a newer one: adopting it unconditionally would
        regress ``version_vector()`` — the exact thing the tier's
        monotonic-apply contract forbids. The CRC travels with its
        version, so both move (or neither)."""
        ver = int(meta.get("version", self._version))
        if ver >= self._version:
            self._version = ver
            self._chain_crc = int(meta.get("chain_crc",
                                           self._chain_crc))

    def lookup(self, requests: Dict[str, np.ndarray]
               ) -> Tuple[Dict[str, Any], int]:
        _op, data = self.transport.request(
            wire.OP_LOOKUP, wire.encode_lookup_request(requests),
            deadline_s=self.lookup_deadline_s)
        out, ver = wire.decode_lookup_response(data)
        self._adopt_meta({"version": ver})
        return out, ver

    def apply_publish(self, sub: Optional[Dict[str, Any]], version: int,
                      expect_crc: Optional[int] = None) -> bool:
        _op, data = self.transport.request(
            wire.OP_PUBLISH, wire.encode_publish(sub, version,
                                                 expect_crc),
            deadline_s=self.publish_deadline_s)
        meta, _ = wire.decode_payload(data)
        self._adopt_meta(meta)
        return bool(meta.get("applied"))

    def install_blocks(self, blocks: Dict[str, Any], version: int,
                       chain_crc: int = 0) -> bool:
        _op, data = self.transport.request(
            wire.OP_INSTALL, wire.encode_blocks(blocks, version,
                                                chain_crc),
            deadline_s=self.publish_deadline_s)
        meta, _ = wire.decode_payload(data)
        self._adopt_meta(meta)
        return bool(meta.get("applied"))

    def refresh(self) -> Dict[str, Any]:
        """PROBE round trip: refresh the cached version/CRC/footprint
        from the authoritative process (connect-time admission and
        health probes call this)."""
        _op, data = self.transport.request(
            wire.OP_PROBE, wire.encode_payload({}),
            deadline_s=self.lookup_deadline_s)
        meta, _ = wire.decode_payload(data)
        self._adopt_meta(meta)
        self._hbm_bytes = int(meta.get("hbm_bytes", self._hbm_bytes))
        if meta.get("quant") and not self.quant:
            self.quant = {str(k): str(v)
                          for k, v in meta["quant"].items()}
        return meta

    def stats(self) -> Dict[str, Any]:
        """Local view only — stats() runs on scrape paths that must not
        block on a dead peer; the cached version/CRC are refreshed by
        every successful round trip."""
        out = {"sid": self.sid, "slot": self.slot, "domain": self.domain,
               "version": self._version, "chain_crc": self._chain_crc,
               "hbm_bytes": self._hbm_bytes, "remote": True}
        out.update(self.transport.stats())
        return out

    def close(self) -> None:
        self.transport.close()


# ---------------------------------------------------------------------
# ranker dispatch seam: server + client proxy
# ---------------------------------------------------------------------
class EngineServer:
    """One :class:`~.engine.InferenceEngine` behind a wire server —
    the process-per-replica entry (``engine.serve_forever()``)."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0):
        self.engine = engine
        rid = getattr(engine, "replica_id", 0)
        self._server = WireServer(
            {
                wire.OP_PREDICT: self._on_predict,
                wire.OP_HEALTH: self._on_health,
                wire.OP_STATS: self._on_stats,
                wire.OP_PROBE: self._on_probe,
            },
            host=host, port=port, seam=SEAM_DISPATCH,
            name=f"engine{rid}")

    def _on_predict(self, payload: bytes) -> bytes:
        features = wire.decode_predict_request(payload)
        pred = self.engine.predict(features)
        return wire.encode_prediction(pred)

    def _on_health(self, payload: bytes) -> bytes:
        return wire.encode_payload(self.engine.healthz())

    def _on_stats(self, payload: bytes) -> bytes:
        return wire.encode_payload(self.engine.stats())

    def _on_probe(self, payload: bytes) -> bytes:
        e = self.engine
        return wire.encode_payload(
            {"replica_id": getattr(e, "replica_id", 0),
             "version": e.version, "alive": bool(e.alive()),
             "queue_depth": int(e.queue_depth),
             "heartbeat_age_s": float(e.heartbeat_age())})

    @property
    def address(self) -> Tuple[str, int]:
        return self._server.address

    def start(self) -> "EngineServer":
        self._server.start()
        return self

    def serve_forever(self) -> None:
        self._server.serve_forever()

    def close(self) -> None:
        self._server.close()


class RemoteEngineClient:
    """The dispatch-relevant :class:`~.engine.InferenceEngine` surface
    over the wire, so a :class:`~.fleet.Replica` can wrap a ranker in
    another process. Routing signals (queue depth, heartbeat age,
    liveness) come from probe/response traffic; a transport failure
    surfaces as :class:`~.engine.ReplicaDown`, which the router's
    breaker already absorbs. Deploy mutations (canary/shadow snapshot
    installs) are refused — those stay an inproc feature."""

    remote = True

    def __init__(self, address: Tuple[str, int], rid: int = 0, *,
                 deadline_s: float = 30.0, retries: int = 1,
                 backoff_ms: float = 5.0, pool_size: int = 4):
        self.replica_id = int(rid)
        self.client = WireClient(
            address, seam=SEAM_DISPATCH, retries=retries,
            backoff_ms=backoff_ms, pool_size=pool_size,
            default_deadline_s=deadline_s, name=f"engine{rid}")
        self._heartbeat = Heartbeat(f"remote-engine-{rid}")
        self._lat_ms = obsm.latency_reservoir(
            "ff_wire_dispatch_latency_ms",
            "remote replica dispatch round trip",
            maxlen=2048, replica=str(rid))
        self._pool = ThreadPoolExecutor(
            max_workers=max(int(pool_size), 1),
            thread_name_prefix=f"ff-wire-dispatch-{rid}")
        self._pending_lock = threading.Lock()
        self._pending: List[Future] = []
        self._version = 0
        self._closed = False

    # --- the dispatch path --------------------------------------------
    def predict(self, features: Dict[str, np.ndarray],
                timeout: Optional[float] = None):
        t0 = time.perf_counter()
        try:
            _op, data = self.client.request(
                wire.OP_PREDICT, wire.encode_predict_request(features),
                deadline_s=timeout)
        except WireError as e:
            from .engine import ReplicaDown
            raise ReplicaDown(self.replica_id, str(e)) from e
        pred = wire.decode_prediction(data)
        self._version = pred.version
        self._heartbeat.beat()
        self._lat_ms.observe(1e3 * (time.perf_counter() - t0))
        return pred

    def submit(self, features: Dict[str, np.ndarray]) -> Future:
        if self._closed:
            raise RuntimeError("remote engine client is closed")
        fut = self._pool.submit(self.predict, features)
        with self._pending_lock:
            self._pending = [f for f in self._pending
                             if not f.done()] + [fut]
        return fut

    # --- fleet hooks --------------------------------------------------
    @property
    def queue_depth(self) -> int:
        with self._pending_lock:
            self._pending = [f for f in self._pending if not f.done()]
            return len(self._pending)

    def alive(self) -> bool:
        return not self._closed

    def heartbeat_age(self) -> float:
        return self._heartbeat.age()

    @property
    def heartbeat(self) -> Heartbeat:
        return self._heartbeat

    def drain_pending(self, exc: Optional[BaseException] = None) -> int:
        with self._pending_lock:
            taken, self._pending = self._pending, []
        n = 0
        for f in taken:
            if f.cancel():
                n += 1
        return n

    @property
    def version(self) -> int:
        return self._version

    def healthz(self) -> Dict[str, Any]:
        try:
            _op, data = self.client.request(
                wire.OP_HEALTH, wire.encode_payload({}), deadline_s=5.0)
            meta, _ = wire.decode_payload(data)
            return meta
        except (WireError, WireRemoteError) as e:
            return {"ok": False, "reason": f"wire: {e}"}

    def stats(self) -> Dict[str, Any]:
        # the ENGINE-stats shape (Fleet.stats() sums these keys across
        # replicas), fetched from the remote process; zeros + an
        # ``unreachable`` reason when the peer is gone — a stats scrape
        # must degrade, not raise
        out: Dict[str, Any] = {
            k: 0 for k in ("requests", "responses", "overloaded",
                           "timeouts", "batches", "queue_depth",
                           "reloads", "reload_rejects")}
        try:
            _op, data = self.client.request(
                wire.OP_STATS, wire.encode_payload({}), deadline_s=5.0)
            meta, _ = wire.decode_payload(data)
            out.update(meta)
        except (WireError, WireRemoteError) as e:
            out["unreachable"] = str(e)
        out["replica_id"] = self.replica_id
        out["remote"] = True
        out["wire"] = self.client.stats()
        return out

    # --- deploy mutations stay inproc ---------------------------------
    def state_snapshot(self):
        raise RuntimeError(
            "canary/shadow deploys mutate replica state in-place; a "
            "REMOTE replica refuses them over the wire — run the "
            "candidate in its own process instead")

    def install_snapshot(self, state, version, source=""):
        raise RuntimeError(
            "install_snapshot over the wire is not supported — the "
            "remote replica's own SnapshotWatcher reloads it")

    # --- lifecycle ----------------------------------------------------
    def start(self) -> "RemoteEngineClient":
        return self

    def close(self, deadline_s: float = 10.0) -> None:
        self._closed = True
        self.drain_pending()
        self._pool.shutdown(wait=False)
        self.client.close()


# ---------------------------------------------------------------------
# watcher seam: manifest + file fetch over the wire
# ---------------------------------------------------------------------
class SnapshotServer:
    """Serves a publish directory's manifest and files over the wire —
    the trainer-side end of the watcher's delta subscription when the
    watcher runs in another process. Read-only, path-confined."""

    def __init__(self, directory: str, host: str = "127.0.0.1",
                 port: int = 0):
        self.directory = os.path.abspath(directory)
        self._server = WireServer(
            {wire.OP_MANIFEST: self._on_manifest,
             wire.OP_FETCH: self._on_fetch},
            host=host, port=port, seam=SEAM_MANIFEST, name="snapshots")

    def _on_manifest(self, payload: bytes) -> bytes:
        import json
        path = os.path.join(self.directory, "manifest.json")
        if not os.path.isfile(path):
            return wire.encode_payload({"manifest": None})
        with open(path) as f:
            return wire.encode_payload({"manifest": json.load(f)})

    def _on_fetch(self, payload: bytes) -> bytes:
        meta, _ = wire.decode_payload(payload)
        name = str(meta.get("name", ""))
        path = os.path.abspath(os.path.join(self.directory, name))
        if not (path == self.directory
                or path.startswith(self.directory + os.sep)):
            raise ValueError(f"fetch of {name!r} escapes the publish "
                             f"directory")
        with open(path, "rb") as f:
            blob = f.read()
        return wire.encode_payload(
            {"name": name, "bytes": len(blob)},
            {"data": np.frombuffer(blob, np.uint8)})

    @property
    def address(self) -> Tuple[str, int]:
        return self._server.address

    def start(self) -> "SnapshotServer":
        self._server.start()
        return self

    def close(self) -> None:
        self._server.close()


class SnapshotWireSource:
    """The watcher's wire-side reader: manifest polls and file loads
    with the same retry/backoff treatment ``read_with_retries`` gives
    file IO, spooled to a local directory so the existing loaders (zip
    validation, chain CRCs) run unchanged on local paths."""

    def __init__(self, transport, spool_dir: str, *, retries: int = 3,
                 backoff_s: float = 0.05):
        self.transport = transport
        self.spool_dir = os.path.abspath(spool_dir)
        self.retries = max(int(retries), 0)
        self.backoff_s = float(backoff_s)
        self.wire_retries = 0
        self.last_wire_error = ""
        os.makedirs(self.spool_dir, exist_ok=True)

    def _with_retries(self, fn: Callable[[], Any], what: str) -> Any:
        """Transient wire failures absorbed with exponential backoff —
        the wire analog of ``read_with_retries`` (which only knows
        IOError/OSError); cumulative counts surface in stats() and
        ``GET /metrics``."""
        attempt = 0
        while True:
            try:
                return fn()
            except (WireError, FrameError, OSError) as e:
                attempt += 1
                self.wire_retries += 1
                self.last_wire_error = f"{what}: {type(e).__name__}: {e}"
                _TELEMETRY.count(SEAM_MANIFEST, "retries")
                if attempt > self.retries:
                    raise
                time.sleep(self.backoff_s * (2 ** (attempt - 1)))

    def read_manifest(self) -> Optional[Dict[str, Any]]:
        def _poll():
            _op, data = self.transport.request(
                wire.OP_MANIFEST, wire.encode_payload({}))
            meta, _ = wire.decode_payload(data)
            return meta.get("manifest")

        m = self._with_retries(_poll, "manifest poll")
        return m if isinstance(m, dict) else None

    def fetch_file(self, name: str) -> str:
        """Fetch one published file's bytes to the spool and return the
        local path (temp + ``os.replace`` — a crash mid-spool must not
        leave a torn file where a loader will trust it)."""
        def _fetch():
            _op, data = self.transport.request(
                wire.OP_FETCH, wire.encode_payload({"name": name}))
            _meta, arrays = wire.decode_payload(data)
            return arrays["data"].tobytes()

        blob = self._with_retries(_fetch, f"fetch {name}")
        local = os.path.join(self.spool_dir, name.replace(os.sep, "_"))
        tmp = local + ".tmp-spool"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, local)
        return local

    def stats(self) -> Dict[str, Any]:
        return {"wire_retries": self.wire_retries,
                "last_wire_error": self.last_wire_error}

    def close(self) -> None:
        self.transport.close()
