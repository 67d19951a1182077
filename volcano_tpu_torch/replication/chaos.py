"""Federation PROCESS mode (the port's own copy of
volcano_tpu/replication/chaos.py): the chaos harness behind ``python -m
volcano_tpu_torch.sim.cli federation --procs`` (docs/design/federation.md
"process mode").

The in-proc federation gate (:mod:`.gate`) proves the replication
protocol; this module proves the DEPLOYMENT of it: three real
``vc-apiserver`` OS processes (``python -m
volcano_tpu_torch.cmd.apiserver``, host-only: no CUDA device is visible
to them) (:class:`ReplicaProcess`), each reached
only through a deterministic fault-injecting TCP proxy
(:class:`ChaosProxy`), a selector-based 1k-subscriber watch fleet
(:class:`WatchFleet`) and a seeded CRUD writer that both fail over
between replicas, and two scripted fault episodes:

* **Episode A** — the leader's proxy goes half-open and its lease
  pushes are dropped at the peers. The next-shortest lease expires, the
  follower's elector takes the lease with a bumped fencing token, the
  partition heals, and the deposed leader is demoted by the newer
  regime it learns from its own push replies. One write carrying the
  deposed token must be FENCED (412) by the new leader.
* **Episode B** — the new leader is SIGKILLed mid-flush. Writes
  fail fast with 503 + Retry-After while the lease lapses, the original
  replica takes over (token bumped again), and the supervisor restarts
  the dead process as a follower that snapshot-bootstraps back in.

Every proxy fault (connection reset, byte-stall, mid-frame truncation,
half-open partition, lease-push drop) is decided by a seeded coin keyed
on (path class, per-class connection sequence, proxy seed) — two runs
inject the same fate sequence, and the gate's bind/ledger fingerprints
are CONTENT digests (volatile metadata stripped) so a double run is
bit-identical. The whole gate runs under a watchdog: no hang escapes.
"""

from __future__ import annotations

import errno
import json
import os
import random
import selectors
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.parse
import urllib.request
import zlib
from collections import deque
from typing import Dict, List, Optional, Tuple

from ..utils.backoff import seeded_backoff

# ---------------------------------------------------------------------------
# deterministic fault-injecting TCP proxy
# ---------------------------------------------------------------------------

_FATE_CLEAN = "clean"
_FATE_RESET = "reset"
_FATE_STALL = "stall"
_FATE_TRUNCATE = "truncate"


class _ProxyConn:
    """One proxied connection: client side, lazily-opened server side,
    and the fate the seeded coin dealt it at classification time."""

    __slots__ = ("client", "server", "cls", "fate", "cutoff", "fired",
                 "down_fwd", "stalled_until", "head", "up_buf",
                 "down_buf", "blackhole", "server_eof", "closed",
                 "connecting")

    def __init__(self, client_sock):
        self.client = client_sock
        self.server = None
        self.connecting = False    # upstream connect still in flight
        self.cls = None            # replicate | watch | lease | other
        self.fate = _FATE_CLEAN
        self.cutoff = 0            # downstream byte offset the fault fires at
        self.fired = False
        self.down_fwd = 0
        self.stalled_until = 0.0
        self.head = b""            # bytes until the request line classifies
        self.up_buf = b""
        self.down_buf = b""
        self.blackhole = False     # half-open partition: swallow silently
        self.server_eof = False
        self.closed = False


class ChaosProxy:
    """Deterministic fault-injecting TCP proxy in front of one replica.

    Single selector thread; every connection is classified from its
    first request line (``/replicate*`` / ``/watchstream`` /
    ``/lease/<sender>`` / other) and — for the replication and watch
    stream classes — dealt a fate by a seeded coin keyed on
    ``(class, per-class connection sequence, seed)``: a connection
    RESET (RST at a derived downstream byte offset), a byte-level
    STALL (forwarding pauses mid-stream, then resumes — half-open
    detection's food), or a mid-frame TRUNCATION (FIN inside a chunk).
    CRUD traffic is never fault-injected here — client failover is
    exercised by the partition modes instead, so the write history
    stays deterministic.

    Partition modes (the harness flips them at episode boundaries):
    ``halfopen`` accepts and swallows silently (established streams go
    quiet, new requests hang until the client's own timeout);
    ``refuse`` resets every connection at accept. ``block_lease_from``
    drops lease pushes from named senders — the asymmetric partition
    that lets a peer's lease expire while the deposed leader still
    renews its own local board.
    """

    def __init__(self, name: str, target_port: int, seed: int,
                 reset_rate: float = 0.06, stall_rate: float = 0.06,
                 truncate_rate: float = 0.04, stall_s: float = 0.4,
                 host: str = "127.0.0.1"):
        self.name = name
        self.seed = int(seed)
        self.target = (host, int(target_port))
        self.reset_rate = reset_rate
        self.stall_rate = stall_rate
        self.truncate_rate = truncate_rate
        self.stall_s = stall_s
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, 0))
        self._lsock.listen(512)
        self._lsock.setblocking(False)
        self.port = self._lsock.getsockname()[1]
        self.url = f"http://{host}:{self.port}"
        self._sel = selectors.DefaultSelector()
        self._sel.register(self._lsock, selectors.EVENT_READ, None)
        self._conns: Dict[object, Tuple[_ProxyConn, str]] = {}
        self._class_seq: Dict[str, int] = {}
        # control flags: whole-value swaps only (episode boundaries are
        # coarse; the proxy thread reads whichever regime is current)
        self.partition_mode: Optional[str] = None
        self.block_lease_from: frozenset = frozenset()
        self.faults = {_FATE_RESET: 0, _FATE_STALL: 0, _FATE_TRUNCATE: 0,
                       "lease_blocked": 0, "partition_dropped": 0}
        self._stop = threading.Event()
        self._sweep_partition = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- control -----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"chaos-proxy-{self.name}")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        for conn, _side in list(self._conns.values()):
            self._close_conn(conn)
        try:
            self._sel.unregister(self._lsock)
        except Exception:
            pass
        try:
            self._lsock.close()
        except Exception:
            pass

    def partition(self, mode: str) -> None:
        """``halfopen`` (accept + swallow) or ``refuse`` (RST at
        accept; existing connections reset too). Existing-conn teardown
        is deferred to the proxy thread's next loop pass (<=50 ms):
        closing sockets from the control thread races the selector
        mid-batch and a torn ``conn.server`` kills the whole proxy."""
        self.partition_mode = mode
        self._sweep_partition.set()

    def heal(self) -> None:
        self.partition_mode = None
        self.block_lease_from = frozenset()

    def block_lease(self, *senders: str) -> None:
        self.block_lease_from = frozenset(
            set(self.block_lease_from) | set(senders))

    # -- fate coins --------------------------------------------------------

    def _deal_fate(self, cls: str) -> Tuple[str, int]:
        """Seeded coin for one (class, seq) connection: the fate and the
        downstream byte offset it fires at. Bit-identical across runs
        for the same accept order."""
        seq = self._class_seq.get(cls, 0)
        self._class_seq[cls] = seq + 1
        if cls not in ("replicate", "watch"):
            return _FATE_CLEAN, 0
        h = zlib.crc32(f"{self.seed}:{cls}:{seq}".encode())
        u = (h % 100000) / 100000.0
        if u < self.reset_rate:
            return _FATE_RESET, 200 + ((h >> 8) % 1800)
        if u < self.reset_rate + self.stall_rate:
            return _FATE_STALL, 100 + ((h >> 8) % 1000)
        if u < self.reset_rate + self.stall_rate + self.truncate_rate:
            return _FATE_TRUNCATE, 400 + ((h >> 8) % 3000)
        return _FATE_CLEAN, 0

    # -- selector loop -----------------------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set():
            if self._sweep_partition.is_set():
                self._sweep_partition.clear()
                mode = self.partition_mode
                if mode == "refuse":
                    for conn, side in list(self._conns.values()):
                        if side == "client":
                            self._close_conn(conn, rst=True)
                elif mode == "halfopen":
                    for conn, _side in list(self._conns.values()):
                        conn.blackhole = True
            events = self._sel.select(timeout=0.05)
            now = time.perf_counter()
            for key, mask in events:
                if key.fileobj is self._lsock:
                    self._accept()
                    continue
                conn, side = key.data
                if side == "client":
                    self._read_client(conn, now)
                else:
                    if mask & selectors.EVENT_WRITE:
                        self._finish_connect(conn)
                    if mask & selectors.EVENT_READ:
                        self._read_server(conn, now)
            # flush pass: buffered bytes + stalls that just expired
            for conn, side in list(self._conns.values()):
                if side != "client" or conn.closed:
                    continue
                self._pump_up(conn)
                self._pump_down(conn, now)
                if conn.server_eof and not conn.down_buf:
                    self._close_conn(conn)

    def _accept(self) -> None:
        while True:
            try:
                csock, _addr = self._lsock.accept()
            except (BlockingIOError, OSError):
                return
            if self.partition_mode == "refuse":
                self.faults["partition_dropped"] += 1
                self._rst_close(csock)
                continue
            csock.setblocking(False)
            conn = _ProxyConn(csock)
            if self.partition_mode == "halfopen":
                conn.blackhole = True
                self.faults["partition_dropped"] += 1
            self._conns[csock] = (conn, "client")
            self._sel.register(csock, selectors.EVENT_READ,
                               (conn, "client"))

    def _read_client(self, conn: _ProxyConn, now: float) -> None:
        if conn.closed:
            return    # closed earlier in this same select batch
        try:
            data = conn.client.recv(65536)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._close_conn(conn)
            return
        if not data:
            self._close_conn(conn)
            return
        if conn.blackhole:
            return                     # swallow: half-open partition
        if conn.cls is None:
            conn.head += data
            if b"\r\n" not in conn.head and len(conn.head) < 4096:
                return
            if not self._classify(conn):
                return                 # dropped at classification
            data = conn.head
            conn.head = b""
        conn.up_buf += data
        self._pump_up(conn)

    def _classify(self, conn: _ProxyConn) -> bool:
        """Parse the request line, deal the fate, open the server side.
        Returns False when the connection was dropped (blocked lease
        push / unreachable target)."""
        line = conn.head.split(b"\r\n", 1)[0].decode("latin-1",
                                                     "replace")
        parts = line.split(" ")
        path = parts[1] if len(parts) >= 2 else ""
        path = path.split("?", 1)[0]
        if path.startswith("/replicate"):
            conn.cls = "replicate"
        elif path.startswith("/watchstream"):
            conn.cls = "watch"
        elif path.startswith("/lease/"):
            conn.cls = "lease"
            sender = path[len("/lease/"):].strip("/")
            if sender in self.block_lease_from:
                self.faults["lease_blocked"] += 1
                self._close_conn(conn, rst=True)
                return False
        else:
            conn.cls = "other"
        conn.fate, conn.cutoff = self._deal_fate(conn.cls)
        # NON-blocking upstream connect: a blocking connect here would
        # stall the whole proxy (every other stream, the lease pushes)
        # behind one replica whose accept queue is backed up — under the
        # 1k-subscriber storm on a starved box that livelocks the run
        ssock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        ssock.setblocking(False)
        try:
            err = ssock.connect_ex(self.target)
        except OSError:
            ssock.close()
            self._close_conn(conn, rst=True)
            return False
        if err not in (0, errno.EINPROGRESS, errno.EWOULDBLOCK):
            ssock.close()
            self._close_conn(conn, rst=True)
            return False
        conn.server = ssock
        conn.connecting = err != 0
        self._conns[ssock] = (conn, "server")
        self._sel.register(
            ssock,
            selectors.EVENT_READ | (selectors.EVENT_WRITE
                                    if conn.connecting else 0),
            (conn, "server"))
        return True

    def _finish_connect(self, conn: _ProxyConn) -> None:
        """Upstream connect completed (write-ready): check the result,
        then downgrade the registration to read-only and flush whatever
        the client sent while the connect was in flight."""
        if conn.closed or conn.server is None or not conn.connecting:
            return
        err = conn.server.getsockopt(socket.SOL_SOCKET, socket.SO_ERROR)
        if err:
            self._close_conn(conn, rst=True)
            return
        conn.connecting = False
        try:
            self._sel.modify(conn.server, selectors.EVENT_READ,
                             (conn, "server"))
        except Exception:
            self._close_conn(conn)
            return
        self._pump_up(conn)

    def _read_server(self, conn: _ProxyConn, now: float) -> None:
        if conn.closed or conn.server is None:
            return    # closed earlier in this same select batch
        try:
            data = conn.server.recv(65536)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            conn.server_eof = True
            self._drop_server(conn)
            return
        if not data:
            conn.server_eof = True
            self._drop_server(conn)
            return
        if conn.blackhole:
            return                     # swallow: half-open partition
        conn.down_buf += data
        self._pump_down(conn, now)

    def _pump_up(self, conn: _ProxyConn) -> None:
        if conn.blackhole:
            conn.up_buf = b""
            return
        if conn.connecting:
            return        # buffered until the upstream connect lands
        while conn.up_buf and conn.server is not None:
            try:
                sent = conn.server.send(conn.up_buf)
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                self._close_conn(conn)
                return
            conn.up_buf = conn.up_buf[sent:]

    def _pump_down(self, conn: _ProxyConn, now: float) -> None:
        if conn.blackhole:
            conn.down_buf = b""
            return
        if conn.stalled_until and now < conn.stalled_until:
            return                     # mid-stall: hold the bytes
        while conn.down_buf:
            chunk = conn.down_buf
            if (conn.fate in (_FATE_RESET, _FATE_TRUNCATE)
                    and not conn.fired
                    and conn.down_fwd + len(chunk) >= conn.cutoff):
                take = max(0, conn.cutoff - conn.down_fwd)
                try:
                    conn.client.send(chunk[:take])
                except OSError:
                    pass
                conn.fired = True
                self.faults[conn.fate] += 1
                self._close_conn(conn, rst=(conn.fate == _FATE_RESET))
                return
            if (conn.fate == _FATE_STALL and not conn.fired
                    and conn.down_fwd + len(chunk) > conn.cutoff):
                conn.fired = True
                conn.stalled_until = now + self.stall_s
                self.faults[_FATE_STALL] += 1
                return
            try:
                sent = conn.client.send(chunk)
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                self._close_conn(conn)
                return
            conn.down_fwd += sent
            conn.down_buf = chunk[sent:]
            if sent < len(chunk):
                return

    # -- teardown helpers --------------------------------------------------

    @staticmethod
    def _rst_close(sock) -> None:
        import struct
        try:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                            struct.pack("ii", 1, 0))
        except OSError:
            pass
        try:
            sock.close()
        except OSError:
            pass

    def _drop_server(self, conn: _ProxyConn) -> None:
        # snapshot first: a concurrent drop (stop() after a join
        # timeout) nulling conn.server between check and close must
        # degrade to a no-op, never an AttributeError
        srv = conn.server
        if srv is None:
            return
        conn.server = None
        try:
            self._sel.unregister(srv)
        except Exception:
            pass
        self._conns.pop(srv, None)
        try:
            srv.close()
        except OSError:
            pass

    def _close_conn(self, conn: _ProxyConn, rst: bool = False) -> None:
        if conn.closed:
            return
        conn.closed = True
        self._drop_server(conn)
        try:
            self._sel.unregister(conn.client)
        except Exception:
            pass
        self._conns.pop(conn.client, None)
        if rst:
            self._rst_close(conn.client)
        else:
            try:
                conn.client.close()
            except OSError:
                pass

    def report(self) -> dict:
        return {"name": self.name, "port": self.port,
                "partition": self.partition_mode,
                "connections": dict(self._class_seq),
                "faults": dict(self.faults)}


# ---------------------------------------------------------------------------
# process supervisor
# ---------------------------------------------------------------------------


class ReplicaProcess:
    """One supervised ``vc-apiserver`` child process.

    Spawns ``python -m volcano_tpu_torch.cmd.apiserver`` with the
    federation
    member flags, drains its stdout into a bounded ring (diagnostics),
    probes liveness via ``GET /rv`` on the DIRECT port, and restarts a
    dead child a bounded number of times with the shared seeded
    backoff. SIGKILL is the chaos input; SIGTERM the clean teardown.
    """

    def __init__(self, name: str, argv: List[str], probe_url: str,
                 seed: int = 0, max_restarts: int = 3,
                 extra_env: Optional[Dict[str, str]] = None):
        self.name = name
        self.argv = list(argv)
        self.probe_url = probe_url.rstrip("/")
        self.seed = int(seed)
        self.max_restarts = max_restarts
        self.restarts = 0
        # one-shot env overlay (the durability gate arms the WAL's crash
        # point (apiserver/wal.py:CRASH_ENV) on the child it intends to
        # kill; the supervised restart must NOT re-arm it)
        self.extra_env = dict(extra_env or {})
        self.proc: Optional[subprocess.Popen] = None
        self.log: deque = deque(maxlen=400)
        self._drainer: Optional[threading.Thread] = None

    def start(self) -> None:
        # the apiserver is host-only: it gets no CUDA device
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        env.update(self.extra_env)
        self.extra_env = {}
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "volcano_tpu_torch.cmd.apiserver",
             *self.argv],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env)
        self._drainer = threading.Thread(
            target=self._drain, args=(self.proc,), daemon=True,
            name=f"drain-{self.name}")
        self._drainer.start()

    def _drain(self, proc: subprocess.Popen) -> None:
        try:
            for line in proc.stdout:
                self.log.append(line.rstrip("\n"))
        except Exception:
            pass

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def probe_rv(self, timeout: float = 2.0) -> Optional[int]:
        try:
            with urllib.request.urlopen(self.probe_url + "/rv",
                                        timeout=timeout) as resp:
                return int(json.loads(resp.read())["rv"])
        except Exception:
            return None

    def wait_ready(self, deadline_s: float = 60.0) -> bool:
        deadline = time.perf_counter() + deadline_s
        while time.perf_counter() < deadline:
            if not self.alive():
                return False
            if self.probe_rv(timeout=1.0) is not None:
                return True
            time.sleep(0.15)
        return False

    def sigkill(self) -> None:
        if self.proc is not None:
            try:
                self.proc.kill()        # SIGKILL: no cleanup, no flush
            except OSError:
                pass
            self.proc.wait(timeout=10)

    def terminate(self) -> None:
        if self.proc is None:
            return
        try:
            self.proc.send_signal(signal.SIGTERM)
            self.proc.wait(timeout=5)
        except (OSError, subprocess.TimeoutExpired):
            try:
                self.proc.kill()
                self.proc.wait(timeout=5)
            except Exception:
                pass

    def supervise(self, argv: Optional[List[str]] = None) -> bool:
        """Restart a dead child (bounded, seeded backoff). Returns True
        when a restart was performed."""
        if self.alive():
            return False
        if self.restarts >= self.max_restarts:
            raise RuntimeError(
                f"{self.name}: restart budget exhausted "
                f"({self.max_restarts}); last output:\n"
                + "\n".join(list(self.log)[-10:]))
        self.restarts += 1
        time.sleep(seeded_backoff(f"supervise:{self.name}",
                                  self.restarts, 0.2, 2.0,
                                  seed=self.seed))
        if argv is not None:
            self.argv = list(argv)
        self.start()
        return True

    def tail(self, n: int = 15) -> List[str]:
        return list(self.log)[-n:]


# ---------------------------------------------------------------------------
# selector-based watch fleet
# ---------------------------------------------------------------------------


class _FleetClient:
    __slots__ = ("cid", "tenant", "kinds", "ep_idx", "sock", "buf",
                 "headers_done", "request_sent", "applied", "seen_rv",
                 "relists", "gaps", "failovers", "dup_frames", "events",
                 "frames", "last_rx", "retry_at", "attempt", "connected")

    def __init__(self, cid: str, tenant: str, kinds: str, ep_idx: int):
        self.cid = cid
        self.tenant = tenant
        self.kinds = kinds
        self.ep_idx = ep_idx
        self.sock = None
        self.buf = b""
        self.headers_done = False
        self.request_sent = False
        self.applied = 0           # frame-chain position (prev must match)
        self.seen_rv = 0           # newest store rv seen (pings included)
        self.relists = 0
        self.gaps = 0
        self.failovers = 0
        self.dup_frames = 0
        self.events = 0
        self.frames = 0
        self.last_rx = 0.0
        self.retry_at = 0.0
        self.attempt = 1
        self.connected = False


class WatchFleet:
    """N ``/watchstream`` clients over real sockets, one selector
    thread. Each client tracks its frame chain (``prev`` must equal the
    last applied ``to_rv``), treats relists as structured recovery,
    counts chain gaps and duplicate frames, and on ANY stream failure —
    reset, truncation, silence past the heartbeat horizon (half-open),
    refused connect — reconnects to the NEXT replica endpoint resuming
    its cursor. Zero lost events = every surviving chain converges to
    the final rv with ``dup_frames == 0``.
    """

    STALE_S = 8.0                  # heartbeat=2: 4 missed pings = broken

    def __init__(self, endpoints: List[str], n: int, seed: int,
                 tenants: int = 16):
        self.endpoints = []
        for ep in endpoints:
            u = urllib.parse.urlsplit(ep)
            self.endpoints.append((u.hostname or "127.0.0.1",
                                   int(u.port or 80)))
        self.seed = int(seed)
        self.clients: List[_FleetClient] = []
        for i in range(n):
            cid = f"chaos-{i:05d}"
            kinds = ("pods", "pods", "pods", "nodes", "")[i % 5]
            self.clients.append(_FleetClient(
                cid, f"tenant-{i % tenants}", kinds,
                zlib.crc32(cid.encode()) % len(self.endpoints)))
        self._sel = selectors.DefaultSelector()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.dup_log: List[dict] = []  # forensic context per dup frame

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="chaos-watch-fleet")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        for c in self.clients:
            self._disconnect(c)

    # -- connection lifecycle ---------------------------------------------

    def _request_bytes(self, c: _FleetClient) -> bytes:
        q = (f"cursor={c.applied}&heartbeat=2&client={c.cid}"
             f"&tenant={c.tenant}")
        if c.kinds:
            q += f"&kinds={c.kinds}"
        return (f"GET /watchstream?{q} HTTP/1.1\r\n"
                f"Host: chaos\r\n\r\n").encode()

    def _connect(self, c: _FleetClient, now: float) -> None:
        host, port = self.endpoints[c.ep_idx]
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setblocking(False)
        try:
            sock.connect_ex((host, port))
        except OSError:
            sock.close()
            self._backoff(c, now, failover=True)
            return
        c.sock = sock
        c.buf = b""
        c.headers_done = False
        c.request_sent = False
        c.last_rx = now
        self._sel.register(sock,
                           selectors.EVENT_READ | selectors.EVENT_WRITE,
                           c)

    def _disconnect(self, c: _FleetClient) -> None:
        if c.sock is not None:
            try:
                self._sel.unregister(c.sock)
            except Exception:
                pass
            try:
                c.sock.close()
            except OSError:
                pass
            c.sock = None
        c.connected = False

    def _backoff(self, c: _FleetClient, now: float,
                 failover: bool) -> None:
        self._disconnect(c)
        if failover:
            c.ep_idx = (c.ep_idx + 1) % len(self.endpoints)
            c.failovers += 1
        c.retry_at = now + seeded_backoff(f"fleet:{c.cid}", c.attempt,
                                          0.05, 1.0, seed=self.seed)
        c.attempt += 1

    # -- stream parsing ----------------------------------------------------

    def _on_frame(self, c: _FleetClient, frame: dict, now: float) -> bool:
        """Apply one NDJSON frame; False = chain broke, reconnect."""
        rv = frame.get("rv")
        if rv is not None:
            c.seen_rv = max(c.seen_rv, int(rv))
        if frame.get("hello"):
            if int(frame["rv"]) > c.applied:
                c.applied = int(frame["rv"])
            return True
        if frame.get("ping"):
            return True
        if frame.get("relist"):
            # structured recovery: re-anchor, never regress (a lagging
            # replica's relist below our chain would re-deliver)
            if int(frame["rv"]) >= c.applied:
                c.applied = int(frame["rv"])
                c.relists += 1
                return True
            c.gaps += 1
            return False
        to_rv = int(frame["to_rv"])
        c.seen_rv = max(c.seen_rv, to_rv)
        if to_rv <= c.applied:
            c.dup_frames += 1          # gate requires this stays 0
            self.dup_log.append({"cid": c.cid, "ep": c.ep_idx,
                                 "applied": c.applied, "frame": frame,
                                 "failovers": c.failovers,
                                 "relists": c.relists})
            return True
        if int(frame["prev"]) != c.applied:
            c.gaps += 1
            return False               # reconnect resumes at applied
        c.applied = to_rv
        c.frames += 1
        c.events += len(frame.get("events", ()))
        return True

    def _on_data(self, c: _FleetClient, data: bytes,
                 now: float) -> bool:
        c.buf += data
        c.last_rx = now
        if not c.headers_done:
            i = c.buf.find(b"\r\n\r\n")
            if i < 0:
                return len(c.buf) < 65536
            status = c.buf.split(b"\r\n", 1)[0]
            if b" 200" not in status:
                return False
            c.headers_done = True
            c.connected = True
            c.attempt = 1
            c.buf = c.buf[i + 4:]
        while True:
            i = c.buf.find(b"\r\n")
            if i < 0:
                return len(c.buf) < 1 << 20
            try:
                size = int(c.buf[:i], 16)
            except ValueError:
                return False           # truncated mid-frame: resync
            if size == 0:
                return False           # server ended the stream
            if len(c.buf) < i + 2 + size + 2:
                return True
            body = c.buf[i + 2:i + 2 + size]
            c.buf = c.buf[i + 2 + size + 2:]
            try:
                frame = json.loads(body)
            except ValueError:
                return False           # mid-frame truncation
            if not self._on_frame(c, frame, now):
                return False

    # -- selector loop -----------------------------------------------------

    def _run(self) -> None:
        now = time.perf_counter()
        # staggered rampup: N simultaneous SYNs would storm the replica
        # accept queues and read as dead endpoints before the first
        # frame ever flows; waves of 32 every 100 ms are deterministic
        # (index-keyed) and spread 1k clients over ~3 s
        for i, c in enumerate(self.clients):
            c.retry_at = now + (i // 32) * 0.1
        while not self._stop.is_set():
            events = self._sel.select(timeout=0.05)
            now = time.perf_counter()
            for key, mask in events:
                c = key.data
                if c.sock is None:
                    continue
                if (mask & selectors.EVENT_WRITE) and not c.request_sent:
                    err = c.sock.getsockopt(socket.SOL_SOCKET,
                                            socket.SO_ERROR)
                    if err:
                        self._backoff(c, now, failover=True)
                        continue
                    try:
                        c.sock.sendall(self._request_bytes(c))
                        c.request_sent = True
                        self._sel.modify(c.sock, selectors.EVENT_READ, c)
                    except OSError:
                        self._backoff(c, now, failover=True)
                        continue
                if mask & selectors.EVENT_READ:
                    try:
                        data = c.sock.recv(65536)
                    except (BlockingIOError, InterruptedError):
                        continue
                    except OSError:
                        self._backoff(c, now, failover=True)
                        continue
                    if not data:
                        self._backoff(c, now, failover=True)
                        continue
                    if not self._on_data(c, data, now):
                        # chain gap / truncation: reconnect (rotating)
                        # and resume from the applied cursor
                        self._backoff(c, now, failover=True)
            # timer scan: reconnects due + half-open detection
            for c in self.clients:
                if c.sock is None:
                    if now >= c.retry_at:
                        self._connect(c, now)
                elif now - c.last_rx > self.STALE_S:
                    self._backoff(c, now, failover=True)

    # -- verdicts ----------------------------------------------------------

    def converged(self, final_rv: int) -> int:
        return sum(1 for c in self.clients
                   if c.connected and c.seen_rv >= final_rv)

    def report(self) -> dict:
        return {
            "clients": len(self.clients),
            "failovers": sum(c.failovers for c in self.clients),
            "gaps": sum(c.gaps for c in self.clients),
            "relists": sum(c.relists for c in self.clients),
            "dup_frames": sum(c.dup_frames for c in self.clients),
            "frames": sum(c.frames for c in self.clients),
            "events": sum(c.events for c in self.clients),
        }


# ---------------------------------------------------------------------------
# seeded writer workload
# ---------------------------------------------------------------------------


class ChaosWriter:
    """Deterministic CRUD storm against the replica set via the
    failover :class:`~volcano_tpu_torch.apiserver.http.StoreClient`.

    The op plan (creates, binds, deletes in namespace ``chaos``) is a
    pure function of the seed, and every op runs under
    :func:`~volcano_tpu_torch.apiserver.remote.retry_transient` — the shared
    seeded-backoff retry that honors degraded 503 Retry-After. The
    at-least-once caveat is handled by op semantics (409 on a replayed
    create = landed; conflict on a bind = re-get + re-apply), and the
    REPLAY phase reconciles acked ops a leader takeover may have
    dropped from the un-replicated journal tail — after it, the final
    store state must equal the expected map exactly (zero lost
    writes)."""

    def __init__(self, endpoints: List[str], seed: int,
                 pods: int = 192, nodes: int = 16):
        from ..apiserver.http import StoreClient
        self.client = StoreClient(endpoints, timeout=2.0,
                                  client_id=f"chaos-writer-{seed}")
        self.seed = int(seed)
        self.n_pods = pods
        self.n_nodes = nodes
        self.expected: Dict[str, Optional[str]] = {}
        self.ops_done = 0
        self.repairs = 0
        self.plan = self._build_plan()

    def _build_plan(self) -> List[tuple]:
        rng = random.Random(self.seed)
        names = [f"cp-{i:04d}" for i in range(self.n_pods)]
        plan: List[tuple] = [("create", n) for n in names]
        bind_order = names[:]
        rng.shuffle(bind_order)
        for n in bind_order:
            plan.append(("bind", n, f"chaos-node-{rng.randrange(self.n_nodes)}"))
        for n in sorted(rng.sample(names, self.n_pods // 6)):
            plan.append(("delete", n))
        return plan

    # -- op primitives (each wrapped in the shared transient retry) -------

    def _retry(self, op: str, key: str, fn):
        from ..apiserver.remote import retry_transient
        return retry_transient(op, key, fn, attempts=10, base=0.3,
                               cap=2.0, seed=self.seed)

    def _new_pod(self, name: str):
        from ..models.objects import ObjectMeta, Pod, PodSpec
        return Pod(metadata=ObjectMeta(name=name, namespace="chaos"),
                   spec=PodSpec(scheduler_name="volcano"))

    def _create(self, name: str) -> None:
        from ..apiserver.http import ApiError
        try:
            self._retry("chaos-create", name, lambda: self.client.create(
                "pods", self._new_pod(name)))
        except ApiError as e:
            if e.code != 409:          # 409: an earlier attempt landed
                raise

    def _bind(self, name: str, node: str) -> None:
        from ..apiserver.http import ApiError
        for _conflict in range(12):
            cur = self._retry("chaos-get", name, lambda: self.client.get(
                "pods", name, "chaos"))
            if cur is None:
                return                 # create lost to a takeover: the
                #                        replay phase reconciles it
            if cur.spec.node_name == node:
                return
            cur.spec.node_name = node
            try:
                self._retry("chaos-bind", name,
                            lambda c=cur: self.client.update("pods", c))
                return
            except ApiError as e:
                if e.code != 409:
                    raise              # conflict: re-get + re-apply
        raise RuntimeError(f"bind {name}: conflict loop did not settle")

    def _delete(self, name: str) -> None:
        from ..apiserver.http import ApiError
        try:
            self._retry("chaos-delete", name, lambda: self.client.delete(
                "pods", name, "chaos"))
        except ApiError as e:
            if e.code != 404:          # already gone: replayed delete
                raise

    def _exec(self, op: tuple) -> None:
        if op[0] == "create":
            self._create(op[1])
            self.expected[op[1]] = ""
        elif op[0] == "bind":
            self._bind(op[1], op[2])
            self.expected[op[1]] = op[2]
        else:
            self._delete(op[1])
            self.expected.pop(op[1], None)
        self.ops_done += 1

    # -- phases ------------------------------------------------------------

    def setup_nodes(self) -> None:
        from ..apiserver.http import ApiError
        from ..models.objects import Node, NodeStatus, ObjectMeta
        rl = {"cpu": 64.0, "memory": 128.0}
        for i in range(self.n_nodes):
            node = Node(metadata=ObjectMeta(name=f"chaos-node-{i}"),
                        status=NodeStatus(allocatable=dict(rl),
                                          capacity=dict(rl)))
            try:
                self._retry("chaos-node", node.metadata.name,
                            lambda n=node: self.client.create("nodes", n))
            except ApiError as e:
                if e.code != 409:
                    raise

    def run_slice(self, start: int, stop: int) -> None:
        for op in self.plan[start:stop]:
            self._exec(op)

    def _leader_pods(self) -> Dict[str, str]:
        """The chaos pods' nodes as the LEADER holds them. Another replica
        may trail it, or, a member restarted from its own log, still
        serve a deposed regime's unreplicated tail until it re-anchors:
        reconciling against that would keep writes the leader lost (the
        reference's writer lists through whichever replica its client
        last used)."""
        def listed():
            if self.client.discover_leader() is None:
                raise ConnectionError("no replica claims the lease")
            return self.client.list("pods", namespace="chaos")
        return {p.metadata.name: p.spec.node_name
                for p in self._retry("chaos-list", "pods", listed)}

    def replay(self) -> int:
        """Reconcile the expected map against the surviving leader:
        re-apply acked ops a takeover dropped from the un-replicated
        journal tail. Returns the number of repairs."""
        live = self._leader_pods()
        repairs = 0
        for name, node in sorted(self.expected.items()):
            if name not in live:
                self._create(name)
                if node:
                    self._bind(name, node)
                repairs += 1
            elif live[name] != node:
                self._bind(name, node)
                repairs += 1
        for name in sorted(set(live) - set(self.expected)):
            if name.startswith("cp-"):
                self._delete(name)
                repairs += 1
        self.repairs += repairs
        return repairs

    def verify(self) -> List[str]:
        """Names whose final state on the leader diverges from the
        expected map — MUST be empty after replay (zero lost writes)."""
        live = self._leader_pods()
        bad = [n for n, node in self.expected.items()
               if live.get(n) != node]
        bad += [n for n in live if n.startswith("cp-")
                and n not in self.expected]
        return sorted(bad)


# ---------------------------------------------------------------------------
# fingerprints + gate plumbing
# ---------------------------------------------------------------------------

_VOLATILE_META = ("resource_version", "uid", "creation_timestamp",
                  "generation", "managed_fields")


def _http_json(url: str, timeout: float = 5.0) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read())


def _audit_digest(snapshot: dict) -> int:
    """rv-INCLUSIVE digest of one replica's snapshot — cross-replica
    mirrors must match bit-for-bit at the leader's rvs."""
    crc = 0
    objects = snapshot.get("objects", {})
    for kind in sorted(objects):
        for key in sorted(objects[kind]):
            enc = json.dumps(objects[kind][key], sort_keys=True)
            crc = zlib.crc32(f"{kind}/{key}:{zlib.crc32(enc.encode())}\n"
                             .encode(), crc)
    return crc


def _content_digests(snapshot: dict) -> Tuple[int, int]:
    """(bind, ledger) CONTENT fingerprints: volatile metadata (rvs,
    uids, timestamps) stripped, so a double run — which assigns
    different rvs to the same logical history — is bit-identical."""
    objects = snapshot.get("objects", {})
    bind_crc = 0
    pods = objects.get("pods", {})
    for key in sorted(k for k in pods if k.startswith("chaos/")):
        node = ((pods[key].get("spec") or {}).get("node_name")) or ""
        bind_crc = zlib.crc32(f"{key}={node}\n".encode(), bind_crc)
    ledger_crc = 0
    for kind in sorted(objects):
        for key in sorted(objects[kind]):
            enc = json.loads(json.dumps(objects[kind][key]))
            md = enc.get("metadata")
            if isinstance(md, dict):
                for f in _VOLATILE_META:
                    md.pop(f, None)
            line = json.dumps(enc, sort_keys=True)
            ledger_crc = zlib.crc32(
                f"{kind}/{key}:{zlib.crc32(line.encode())}\n".encode(),
                ledger_crc)
    return bind_crc, ledger_crc


class _Watchdog:
    """Hard deadline over the whole gate: on expiry every child process
    and proxy is torn down and the run reports ``watchdog_fired``
    instead of hanging the smoke ladder."""

    def __init__(self, seconds: float, teardown):
        self.fired = False
        self._teardown = teardown
        self._timer = threading.Timer(seconds, self._fire)
        self._timer.daemon = True
        self._timer.start()

    def _fire(self) -> None:
        self.fired = True
        try:
            self._teardown()
        except Exception:
            pass

    def check(self) -> None:
        if self.fired:
            raise TimeoutError("federation proc gate watchdog fired")

    def cancel(self) -> None:
        self._timer.cancel()


def _free_port() -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _wait_until(predicate, deadline_s: float, watchdog: _Watchdog,
                interval: float = 0.2) -> bool:
    deadline = time.perf_counter() + deadline_s
    while time.perf_counter() < deadline:
        watchdog.check()
        if predicate():
            return True
        time.sleep(interval)
    return False


def _leader_info(direct_url: str) -> dict:
    try:
        return _http_json(direct_url + "/leader", timeout=2.0)
    except Exception:
        return {}


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------


def run_federation_procs(seed: int = 43, subscribers: int = 1024,
                         pods: int = 192, nodes: int = 16,
                         reset_rate: float = 0.06,
                         stall_rate: float = 0.06,
                         truncate_rate: float = 0.04,
                         watchdog_s: float = 240.0,
                         verbose: bool = False) -> dict:
    """One full process-mode federation run; returns the flat verdict
    dict the CLI gates on (module docstring has the scenario)."""
    # staggered lease durations make the succession order deterministic:
    # after a partition the shortest surviving lease wins
    lease_durations = [2.0, 3.5, 5.0]
    names = [f"replica-{i}" for i in range(3)]
    direct_ports = [_free_port() for _ in range(3)]
    direct_urls = [f"http://127.0.0.1:{p}" for p in direct_ports]
    proxies = [ChaosProxy(names[i], direct_ports[i], seed ^ (i * 7919),
                          reset_rate=reset_rate, stall_rate=stall_rate,
                          truncate_rate=truncate_rate)
               for i in range(3)]
    peers = ",".join(f"{names[i]}={proxies[i].url}" for i in range(3))
    # every replica runs the durable WAL (docs/design/durability.md):
    # the SIGKILLed leader's restart exercises real crash recovery, and
    # the epoch guard then decides local-log resume vs peer bootstrap
    import tempfile
    data_dirs = [tempfile.mkdtemp(prefix=f"vc-wal-{names[i]}-")
                 for i in range(3)]

    def _argv(i: int) -> List[str]:
        argv = ["--host", "127.0.0.1", "--port", str(direct_ports[i]),
                "--serving-shards", "2",
                "--max-subscriptions", "8192",
                "--tenant-write-rate", "100000",
                "--tenant-write-burst", "100000",
                "--data-dir", data_dirs[i],
                "--wal-flush-interval", "0.02",
                "--checkpoint-interval", "5",
                "--peers", peers,
                "--replica-name", names[i],
                "--advertise-url", proxies[i].url,
                "--lease-duration", str(lease_durations[i]),
                "--renew-interval", "0.5"]
        if i == 0:
            argv.append("--bootstrap-leader")
        else:
            argv += ["--initial-leader", names[0]]
        return argv

    procs = [ReplicaProcess(names[i], _argv(i), direct_urls[i],
                            seed=seed) for i in range(3)]
    fleet: Optional[WatchFleet] = None
    torn_down = threading.Event()

    def _teardown() -> None:
        if torn_down.is_set():
            return
        torn_down.set()
        if fleet is not None:
            fleet.stop()
        for p in procs:
            p.terminate()
        for px in proxies:
            px.stop()

    watchdog = _Watchdog(watchdog_s, _teardown)
    verdict: dict = {"seed": seed, "procs": 3, "watchdog_fired": False}
    t0 = time.perf_counter()
    try:
        for px in proxies:
            px.start()
        for p in procs:
            p.start()
        ready = all(p.wait_ready(60.0) for p in procs)
        verdict["replicas_ready"] = ready
        if not ready:
            raise RuntimeError("replica set failed to come up: "
                               + json.dumps({p.name: p.tail(8)
                                             for p in procs}))
        # followers must ACCEPT the seeded leader before the storm
        _wait_until(lambda: all(
            _leader_info(u).get("holder") == "replica-0"
            for u in direct_urls), 20.0, watchdog)

        writer = ChaosWriter([px.url for px in proxies], seed,
                             pods=pods, nodes=nodes)
        writer.setup_nodes()
        fleet = WatchFleet([px.url for px in proxies], subscribers,
                           seed)
        fleet.start()
        n_creates = pods
        n_binds = pods
        writer.run_slice(0, n_creates + n_binds // 2)

        # -- episode A: half-open partition of the leader ---------------
        proxies[0].partition("halfopen")
        proxies[1].block_lease("replica-0")
        proxies[2].block_lease("replica-0")
        took_over = _wait_until(
            lambda: (_leader_info(direct_urls[1]).get("role") == "leader"
                     and int(_leader_info(direct_urls[1])
                             .get("token") or 0) >= 2),
            30.0, watchdog)
        verdict["episode_a_takeover"] = took_over
        proxies[0].heal()
        proxies[1].heal()
        proxies[2].heal()
        demoted = _wait_until(
            lambda: _leader_info(direct_urls[0]).get("role")
            == "follower", 30.0, watchdog)
        verdict["deposed_leader_demoted"] = demoted
        # the deposed regime's write: fence token 1 against the new
        # leader MUST be rejected 412 (never silently retried)
        from ..apiserver.http import ApiError, StoreClient
        fenced = 0
        probe = StoreClient(direct_urls[1], timeout=5.0,
                            client_id="fenced-probe")
        try:
            probe.create("pods", writer._new_pod("deposed-write-a"),
                         fence=1)
        except ApiError as e:
            if e.code == 412:
                fenced = 1
        verdict["fenced_deposed_writes"] = fenced

        writer.run_slice(n_creates + n_binds // 2, n_creates + n_binds)

        # -- episode B: SIGKILL the leader mid-flush --------------------
        tail_thread = threading.Thread(
            target=writer.run_slice,
            args=(n_creates + n_binds, len(writer.plan)), daemon=True)
        tail_thread.start()
        time.sleep(0.3)               # mid-flush: deletes in flight
        procs[1].sigkill()
        proxies[1].partition("refuse")
        # degraded window: a follower fails writes FAST with structured
        # 503 + Retry-After (retry_transient's pacing signal)
        degraded_probe = StoreClient(direct_urls[2], timeout=5.0,
                                     client_id="degraded-probe")
        degraded_503 = False
        degraded_retry_after = None
        try:
            degraded_probe.create("pods",
                                  writer._new_pod("degraded-write-b"))
        except ApiError as e:
            if e.code == 503:
                degraded_503 = True
                degraded_retry_after = e.retry_after
        except Exception:
            pass
        verdict["degraded_503"] = degraded_503
        verdict["degraded_retry_after"] = degraded_retry_after
        stale_info = _leader_info(direct_urls[2])
        verdict["staleness_annotated"] = \
            stale_info.get("staleness") is not None
        second = _wait_until(
            lambda: (_leader_info(direct_urls[0]).get("role") == "leader"
                     and int(_leader_info(direct_urls[0])
                             .get("token") or 0) >= 3),
            30.0, watchdog)
        verdict["episode_b_takeover"] = second
        tail_thread.join(timeout=60.0)
        watchdog.check()
        # supervisor: bounded seeded restart of the dead child, which
        # rejoins as a follower and snapshot-bootstraps from the leader
        restarted = procs[1].supervise()
        verdict["supervisor_restarts"] = procs[1].restarts
        verdict["restarted_ready"] = restarted and procs[1].wait_ready(
            60.0)
        # the SIGKILLed replica must have replayed its local WAL on the
        # way back up (the deposed-leader epoch guard then decides
        # whether to keep the log or snapshot-bootstrap over it)
        verdict["restarted_recovered_wal"] = any(
            "recovered rv=" in line for line in procs[1].log)
        proxies[1].heal()

        # -- replay + settle -------------------------------------------
        writer.replay()
        lost_writes = writer.verify()
        if lost_writes:                # one more reconcile round: the
            writer.replay()            # first may have raced a takeover
            lost_writes = writer.verify()
        verdict["writer_repairs"] = writer.repairs
        verdict["lost_writes_after_replay"] = len(lost_writes)

        final_rv = 0

        def _settled() -> bool:
            nonlocal final_rv
            rvs = [p.probe_rv() for p in procs]
            if any(rv is None for rv in rvs) or len(set(rvs)) != 1:
                return False
            final_rv = rvs[0]
            return fleet.converged(final_rv) == len(fleet.clients)

        settled = _wait_until(_settled, 60.0, watchdog, interval=0.3)
        verdict["settled"] = settled
        verdict["final_rv"] = final_rv

        # -- audits + fingerprints -------------------------------------
        snaps = {names[i]: _http_json(direct_urls[i]
                                      + "/replicate/snapshot",
                                      timeout=10.0)
                 for i in range(3)}
        digests = {n: _audit_digest(s) for n, s in snaps.items()}
        verdict["audit_digests"] = digests
        verdict["audit_identical"] = len(set(digests.values())) == 1
        bind_fp, ledger_fp = _content_digests(snaps[names[0]])
        verdict["bind_fingerprint"] = bind_fp
        verdict["ledger_fingerprint"] = ledger_fp
        verdict["final_epoch"] = int(
            _leader_info(direct_urls[0]).get("token") or 0)
        verdict["takeovers"] = max(0, verdict["final_epoch"] - 1)

        fl = fleet.report()
        verdict.update({
            "subscribers": fl["clients"],
            "converged": fleet.converged(final_rv),
            "watch_failovers": fl["failovers"],
            "watch_gaps": fl["gaps"],
            "watch_relists": fl["relists"],
            "dup_frames": fl["dup_frames"],
            "frames": fl["frames"],
            "events": fl["events"],
        })
        verdict["unconverged"] = (fl["clients"]
                                  - verdict["converged"])
        verdict["lost_events"] = (verdict["unconverged"]
                                  + fl["dup_frames"]
                                  + len(lost_writes))
        verdict["writer_ops"] = writer.ops_done
        verdict["writer_failovers"] = writer.client.failovers
        verdict["leader_redirects"] = writer.client.leader_redirects
        verdict["client_failovers"] = (fl["failovers"]
                                       + writer.client.failovers
                                       + writer.client.leader_redirects)
        verdict["proxy_faults"] = {
            px.name: dict(px.faults) for px in proxies}
        total_faults = {}
        for px in proxies:
            for k, v in px.faults.items():
                total_faults[k] = total_faults.get(k, 0) + v
        verdict["faults_total"] = total_faults
        if verbose:
            for p in procs:
                print(f"--- {p.name} tail ---")
                for line in p.tail(6):
                    print("   ", line)
    except TimeoutError:
        verdict["watchdog_fired"] = True
    finally:
        watchdog.cancel()
        _teardown()
        import shutil
        for d in data_dirs:
            shutil.rmtree(d, ignore_errors=True)
    verdict["elapsed_s"] = round(time.perf_counter() - t0, 1)
    return verdict


__all__ = ["ChaosProxy", "ReplicaProcess", "WatchFleet", "ChaosWriter",
           "run_federation_procs"]
