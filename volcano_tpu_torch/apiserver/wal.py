"""Durable write-ahead journal for the apiserver store (the port's own
copy of volcano_tpu/apiserver/wal.py; its data directories are the
reference's, byte for byte, and each package recovers the other's).

The federation layer (docs/design/federation.md) made the control plane
survive replica kills only because a LIVE PEER holds the state — every
replica's journal and object map are RAM-only. This module is the
single-node durability story (docs/design/durability.md): a segmented
append-only write-ahead log that persists every journal entry batch the
sequencer publishes, plus snapshot-anchored compaction reusing the
persistence.py snapshot format.

Design points (the doc has the full protocol):

- **Riding the sequencer.** The store forwards every run of journal
  entries that lands on the contiguous tail (``_journal_extend_locked``)
  to :meth:`WriteAheadLog.append_entries` — a 50k-bind flush arrives as
  ONE call and lands as ONE group-committed record range. The call is
  O(1) under the store lock (it enqueues object REFS; stored objects are
  replaced, never mutated, so deferred encoding off-lock is safe).
- **Record framing.** ``<u32 length><u32 crc32(payload)><payload>``,
  payload compact JSON. Record types: ``seg`` (segment header), ``e``
  (entry batch: ``[[rv, action, kind, encoded_obj], ...]``), ``f``
  (fence-floor advance, so recovery re-anchors the write fence).
- **Group commit.** A flusher thread (or the sim's deterministic
  :meth:`pump`) drains pending batches, writes them as records and
  issues ONE fsync per drain, bounded by ``flush_interval``. Writers
  never wait on fsync: the durability contract is "at most
  ``flush_interval`` of acked writes lost on power failure", exactly
  the etcd default a Volcano deployment delegates to.
- **Generations.** A snapshot-install (follower bootstrap) REPLACES the
  rv space, so segments from before it must never replay over the new
  snapshot. Every cutover bumps a generation counter; segments carry it
  in their name and recovery only replays segments whose generation
  matches the snapshot's.
- **Degradation.** ENOSPC/EIO on append or fsync flips the attached
  store read-only (writes answer structured 503 + Retry-After at the
  HTTP edge); a failed record write is truncated away so a later retry
  cannot leave garbage mid-log. fsync failure is terminal for the
  process lifetime (post-failure page-cache state is unknowable —
  the fsyncgate lesson).

Crash injection (the durability-smoke gate): ``VOLCANO_TPU_TORCH_WAL_CRASH`` set
to ``<point>:<n>`` SIGKILLs the process at the n-th crossing of that
injection point (``pre-fsync``, ``post-fsync-pre-rename``,
``mid-compaction``) — a REAL kill, no atexit, no flush.
"""

from __future__ import annotations

import errno
import io
import json
import os
import re
import signal
import struct
import threading
import time
import zlib
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from ..metrics import metrics as m
from .codec import decode_object, dumps_compact


_HEADER = struct.Struct("<II")
_SEGMENT_RE = re.compile(r"^wal-g(\d+)-s(\d+)-(\d+)\.log$")

#: the crash-injection variable, ``<point>:<n>``
CRASH_ENV = "VOLCANO_TPU_TORCH_WAL_CRASH"
#: crash-point counters for CRASH_ENV (process-local; the smoke harness
#: sets the variable on the child it intends to kill)
_CRASH_HITS: Dict[str, int] = {}


def _maybe_crash(point: str) -> None:
    spec = os.environ.get(CRASH_ENV, "")
    if not spec:
        return
    want, _, nth = spec.partition(":")
    if want != point:
        return
    _CRASH_HITS[point] = _CRASH_HITS.get(point, 0) + 1
    if _CRASH_HITS[point] >= max(1, int(nth or 1)):
        os.kill(os.getpid(), signal.SIGKILL)   # no cleanup, no flush


class WalCorruptionError(Exception):
    """Mid-log corruption: a record that fails its CRC (or breaks rv
    contiguity) with durable records after it. Recovery REFUSES — the
    evidence (segment, byte offset, expected/got CRC) rides on the
    exception so the operator sees exactly what is damaged."""

    def __init__(self, message: str, segment: str = "", offset: int = -1,
                 expected_crc: Optional[int] = None,
                 got_crc: Optional[int] = None):
        super().__init__(message)
        self.segment = segment
        self.offset = offset
        self.expected_crc = expected_crc
        self.got_crc = got_crc


def _fsync_dir(path: str) -> None:
    """fsync the directory entry so a create/rename/unlink is durable,
    not just the file bytes (POSIX crash-consistency requires both)."""
    try:
        fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _default_opener(path: str):
    # unbuffered append-binary: one write() syscall per record blob
    return open(path, "ab", buffering=0)


def pack_record(payload: bytes) -> bytes:
    return _HEADER.pack(len(payload), zlib.crc32(payload)) + payload


class _SegmentReader:
    """Sequential record reader over one segment file with the
    torn-tail / mid-log-corruption distinction:

    - an incomplete header, an incomplete payload, or a CRC mismatch on
      the FINAL record of the file is a torn write → report truncation
      offset and stop;
    - a CRC mismatch followed by another well-formed record is a bit
      flip mid-log → :class:`WalCorruptionError` with the evidence.
    """

    def __init__(self, path: str):
        self.path = path
        self.truncate_at: Optional[int] = None
        self.records: List[dict] = []

    def scan(self) -> "_SegmentReader":
        with open(self.path, "rb") as f:
            data = f.read()
        size = len(data)
        off = 0
        while off < size:
            if off + _HEADER.size > size:
                self.truncate_at = off          # torn header
                break
            length, crc = _HEADER.unpack_from(data, off)
            end = off + _HEADER.size + length
            if end > size:
                self.truncate_at = off          # torn payload
                break
            payload = data[off + _HEADER.size:end]
            got = zlib.crc32(payload)
            if got != crc:
                if self._well_formed_after(data, end):
                    raise WalCorruptionError(
                        f"WAL record at {self.path}:{off} fails CRC "
                        f"(expected {crc:#010x}, got {got:#010x}) with "
                        f"valid records after it — refusing to replay "
                        f"a damaged log",
                        segment=self.path, offset=off,
                        expected_crc=crc, got_crc=got)
                self.truncate_at = off          # torn final record
                break
            try:
                self.records.append(json.loads(payload))
            except ValueError:
                raise WalCorruptionError(
                    f"WAL record at {self.path}:{off} passes CRC but is "
                    f"not JSON — framing damage", segment=self.path,
                    offset=off, expected_crc=crc, got_crc=got)
            off = end
        return self

    @staticmethod
    def _well_formed_after(data: bytes, off: int) -> bool:
        size = len(data)
        if off + _HEADER.size > size:
            return False
        length, crc = _HEADER.unpack_from(data, off)
        end = off + _HEADER.size + length
        if end > size:
            return False
        return zlib.crc32(data[off + _HEADER.size:end]) == crc


class WriteAheadLog:
    """Segmented group-commit write-ahead log bound to one ObjectStore.

    Lifecycle: construct over a data dir, :meth:`attach` to the store
    (which starts forwarding journal-tail advances here), then either
    :meth:`start` the background flusher (process mode) or drive
    :meth:`pump` deterministically (sim / tests). :meth:`close` flushes,
    optionally compacts, and releases the segment file.
    """

    SNAPSHOT_NAME = "snapshot.json"

    def __init__(self, data_dir: str, flush_interval: float = 0.05,
                 segment_max_bytes: int = 64 * 1024 * 1024,
                 compact_interval: float = 30.0,
                 opener: Optional[Callable] = None,
                 on_degrade: Optional[Callable] = None):
        self.data_dir = os.path.abspath(data_dir)
        os.makedirs(self.data_dir, exist_ok=True)
        self.flush_interval = float(flush_interval)
        self.segment_max_bytes = int(segment_max_bytes)
        self.compact_interval = float(compact_interval)
        self._opener = opener or _default_opener
        self._on_degrade = on_degrade
        self.store = None
        # Three locks, strictly ordered _flush_serial -> _io -> _lock
        # (never the reverse):
        #
        # - _lock/_cond guard ONLY the pending queue + flusher wakeup
        #   flags. Enqueue runs under the STORE lock, so nothing held
        #   here may ever block on file I/O (writers must not wait on
        #   fsync) or call back into the store (ABBA deadlock: a writer
        #   holding the store lock blocks in append_entries while the
        #   flusher holding a WAL lock blocks in enter_read_only).
        # - _io guards the segment file + durability cursor; write +
        #   fsync happen under it.
        # - _flush_serial serializes whole flushes: two concurrent
        #   flushes draining separate batches and racing to the file
        #   write would land records out of rv order — a gap to the
        #   recovery scan.
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._io = threading.Lock()
        self._flush_serial = threading.Lock()
        self._pending: deque = deque()      # ("e", entries) | ("f", token)
        self._pending_entries = 0
        self._file: Optional[io.IOBase] = None
        self._segment_path = ""
        self._segment_bytes = 0
        self._generation = 0
        self._seq = 0
        self._durable_rv = 0
        self._reset_to: Optional[int] = None   # snapshot-install cutover
        self._compact_requested = False
        self._degraded: Optional[str] = None
        self._fsync_poisoned = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_compact = time.perf_counter()
        # telemetry rings (perf_counter durations — never decisions)
        self._fsync_ms: deque = deque(maxlen=2048)
        self._append_ms: deque = deque(maxlen=4096)
        self.records_written = 0
        self.entries_written = 0
        self.fsyncs = 0
        self.flushes = 0
        self.compactions = 0
        self.rotations = 0
        self.append_errors = 0

    # -- wiring ------------------------------------------------------------

    @property
    def snapshot_path(self) -> str:
        return os.path.join(self.data_dir, self.SNAPSHOT_NAME)

    def attach(self, store) -> None:
        """Bind to ``store`` and open the active segment at its current
        tail. Call AFTER recovery installed state (attach is the cutover
        from replay mode to append mode)."""
        self.store = store
        gen, seq = _max_gen_seq(self.data_dir)
        with self._io:
            self._generation = gen
            self._seq = seq
            self._durable_rv = store.current_rv()
            self._open_segment_locked(self._durable_rv)
        store.attach_wal(self)
        set_active(self)

    # -- store-side hooks (called under the STORE lock: O(1) only) ---------

    def append_entries(self, entries) -> None:
        """Enqueue one contiguous run of journal entries (refs — the
        flusher encodes off-lock). Called by the sequencer on every
        journal-tail advance."""
        if self._fsync_poisoned:
            return      # terminal: the queue would never drain again
        t0 = time.perf_counter()
        with self._cond:
            self._pending.append(("e", entries))
            self._pending_entries += len(entries)
            self._cond.notify()
        self._append_ms.append((time.perf_counter() - t0) * 1000.0)
        m.inc(m.WAL_APPENDS)

    def append_fence(self, token: int) -> None:
        if self._fsync_poisoned:
            return      # terminal: the queue would never drain again
        with self._cond:
            self._pending.append(("f", int(token)))
            self._cond.notify()

    def on_snapshot_installed(self, rv: int) -> None:
        """A snapshot install (follower bootstrap) replaced the rv
        space: drop pre-install pending batches and schedule a
        generation cutover. Called under the store lock — flag-setting
        only; the flusher performs the cutover off-lock."""
        with self._cond:
            self._pending.clear()
            self._pending_entries = 0
            self._reset_to = int(rv)
            self._compact_requested = True
            self._cond.notify()

    def request_compact(self) -> None:
        with self._cond:
            self._compact_requested = True
            self._cond.notify()

    # -- flusher -----------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="wal-flusher")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            with self._cond:
                # while degraded the pending queue stays non-empty (the
                # failed batch is re-enqueued) — wait the interval
                # anyway so ENOSPC retries are paced, not a spin
                if self._degraded is not None \
                        or (not self._pending
                            and not self._compact_requested):
                    self._cond.wait(timeout=self.flush_interval)
            try:
                self.pump()
            except Exception:
                pass        # degradation is recorded; never kill the loop

    def stop(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def close(self, final_compact: bool = False) -> None:
        self.stop()
        try:
            if final_compact and self._degraded is None:
                self.compact()
            else:
                self.flush()
        finally:
            with self._io:
                if self._file is not None:
                    try:
                        self._file.close()
                    except OSError:
                        pass
                    self._file = None

    def pump(self) -> int:
        """One deterministic flusher round: cutover if scheduled, flush
        pending, compact when due. The sim drives this from the virtual
        clock; the background thread calls it per wakeup. Returns the
        number of entries made durable."""
        reset = None
        with self._lock:
            if self._reset_to is not None:
                reset = self._reset_to
                self._reset_to = None
        if reset is not None:
            self._cutover(reset)
        n = self.flush()
        due = (time.perf_counter() - self._last_compact
               >= self.compact_interval > 0)
        with self._lock:
            requested = self._compact_requested
            self._compact_requested = False
        if requested or due:
            self.compact()
        return n

    # -- the write path ----------------------------------------------------

    def flush(self) -> int:
        """Drain pending batches into the active segment as records and
        group-commit them with one fsync. Returns entries persisted.
        Whole flushes serialize (the group-commit thread and a manual
        caller must not interleave their drained batches on disk)."""
        with self._flush_serial:
            return self._flush_serialized()

    def _flush_serialized(self) -> int:
        with self._cond:
            if not self._pending or self._fsync_poisoned:
                return 0
            batch = list(self._pending)
            self._pending.clear()
            self._pending_entries = 0
        records: List[bytes] = []
        hi_rv = self._durable_rv
        n_entries = 0
        for kind_tag, payload in batch:
            if kind_tag == "f":
                records.append(pack_record(json.dumps(
                    {"t": "f", "token": payload},
                    separators=(",", ":")).encode()))
                continue
            entries = payload
            # the objects themselves go to the encoder: its walk and the
            # compact dump are one pass
            rec = dumps_compact(
                {"t": "e", "lo": entries[0][0], "hi": entries[-1][0],
                 "e": [[rv, action, k, o] for rv, action, k, o in entries]})
            records.append(pack_record(rec))
            hi_rv = max(hi_rv, entries[-1][0])
            n_entries += len(entries)
        blob = b"".join(records)
        t0 = time.perf_counter()
        fail_reason = None
        with self._io:
            if self._fsync_poisoned:
                return 0
            start_size = self._segment_bytes
            try:
                if self._file is None:
                    self._open_segment_locked(self._durable_rv)
                self._file.write(blob)
                self._segment_bytes += len(blob)
                _maybe_crash("pre-fsync")
                self._do_fsync_locked()
            except OSError as e:
                fail_reason = self._handle_write_error_locked(
                    e, start_size)
                poisoned = self._fsync_poisoned
            else:
                self._durable_rv = hi_rv
                self.records_written += len(records)
                self.entries_written += n_entries
                self.flushes += 1
                if self._segment_bytes >= self.segment_max_bytes:
                    self._rotate_locked(self._durable_rv)
        if fail_reason is not None:
            # off _io: the store call in _notify_degrade takes the
            # store lock, which a writer blocked in append_entries may
            # hold — acquiring it under a WAL lock would ABBA-deadlock
            with self._cond:
                if poisoned:
                    # nothing will ever drain again — don't leak
                    self._pending.clear()
                    self._pending_entries = 0
                else:
                    # re-enqueue the drained batch at the FRONT: the
                    # segment was wound back to a clean prefix, so the
                    # retry after an ENOSPC heal re-lands the same
                    # records in the same order and recovery never
                    # sees an rv gap
                    self._pending.extendleft(reversed(batch))
                    self._pending_entries += n_entries
            self._notify_degrade(fail_reason)
            return 0
        self._fsync_ms.append((time.perf_counter() - t0) * 1000.0)
        self._heal()
        m.inc(m.WAL_RECORDS, len(records))
        m.inc(m.WAL_ENTRIES, n_entries)
        m.observe(m.WAL_FSYNC_MS, self._fsync_ms[-1])
        m.set_gauge(m.WAL_DURABLE_RV, self._durable_rv)
        return n_entries

    def _do_fsync_locked(self) -> None:
        f = self._file
        if hasattr(f, "fsync"):
            f.fsync()               # fault-injecting file layer seam
        else:
            os.fsync(f.fileno())
        self.fsyncs += 1
        m.inc(m.WAL_FSYNCS)

    def _handle_write_error_locked(self, e: OSError,
                                   start_size: int) -> str:
        """A failed append must never leave a torn record MID-log: wind
        the segment back to the pre-record size so the log stays a clean
        prefix. Records the degraded state (caller holds ``_io``) and
        returns the reason — the caller notifies the store OFF the WAL
        locks (enter_read_only takes the store lock, which a writer
        blocked in append_entries may hold)."""
        self.append_errors += 1
        if e.errno not in (errno.ENOSPC, errno.EDQUOT):
            # EIO / unknown: durability of already-written bytes is
            # unknowable after a failed fsync — poison the log
            self._fsync_poisoned = True
        try:
            if self._file is not None:
                os.ftruncate(self._file.fileno(), start_size)
                self._segment_bytes = start_size
        except OSError:
            self._fsync_poisoned = True
        reason = (f"WAL append failed: [{errno.errorcode.get(e.errno, e.errno)}] "
                  f"{e.strerror or e}")
        self._degraded = reason
        return reason

    def _degrade(self, reason: str) -> None:
        with self._io:
            self._degraded = reason
        self._notify_degrade(reason)

    def _notify_degrade(self, reason: str) -> None:
        """Propagate a recorded degradation. MUST be called with no WAL
        lock held: enter_read_only acquires the store lock."""
        if self.store is not None:
            self.store.enter_read_only(reason)
        if self._on_degrade is not None:
            try:
                self._on_degrade(reason)
            except Exception:
                pass
        m.set_gauge(m.WAL_READ_ONLY, 1)

    def _heal(self) -> None:
        """A successful full flush after an ENOSPC episode (space was
        freed) lifts the read-only gate; a poisoned fsync never heals.
        Store notification runs off the WAL locks (same deadlock rule
        as _notify_degrade)."""
        with self._io:
            if self._degraded is None or self._fsync_poisoned:
                return
            self._degraded = None
        if self.store is not None:
            self.store.exit_read_only()
        m.set_gauge(m.WAL_READ_ONLY, 0)

    # -- segments ----------------------------------------------------------

    def _segment_name(self, base_rv: int) -> str:
        return (f"wal-g{self._generation}-s{self._seq:06d}-"
                f"{base_rv}.log")

    def _open_segment_locked(self, base_rv: int) -> None:
        self._seq += 1
        path = os.path.join(self.data_dir, self._segment_name(base_rv))
        self._file = self._opener(path)
        self._segment_path = path
        self._segment_bytes = 0
        header = pack_record(json.dumps(
            {"t": "seg", "v": 1, "gen": self._generation,
             "base": base_rv}, separators=(",", ":")).encode())
        self._file.write(header)
        self._segment_bytes += len(header)
        _fsync_dir(self.data_dir)
        m.set_gauge(m.WAL_SEGMENTS, len(self.segments()))

    def _rotate_locked(self, base_rv: int) -> None:
        if self._file is not None:
            try:
                self._file.close()
            except OSError:
                pass
        self._open_segment_locked(base_rv)
        self.rotations += 1

    def segments(self) -> List[str]:
        out = []
        for name in os.listdir(self.data_dir):
            if _SEGMENT_RE.match(name):
                out.append(name)
        return sorted(out, key=_segment_sort_key)

    def _cutover(self, rv: int) -> None:
        """Generation bump after a snapshot install: new segments, new
        snapshot, old generation's files purged (their rv space is
        dead). Runs on the flusher thread, off the store lock."""
        with self._io:
            self._generation += 1
            self._durable_rv = rv
            self._fsync_poisoned = False
            self._rotate_locked(rv)

    def compact(self) -> int:
        """Snapshot-anchored compaction: flush, save a durable snapshot
        of the attached store (atomic tmp+rename; the WAL is truncated
        only AFTER the snapshot fsyncs), then delete segments made
        redundant by the anchor. Returns the anchor rv."""
        if self.store is None or self._degraded is not None:
            return self._durable_rv
        from .persistence import save_store_anchored
        self.flush()
        with self._io:
            self._rotate_locked(self._durable_rv)
        try:
            # settle=True: anchoring at the raw allocation counter
            # mid-bulk would place still-publishing shards BELOW the
            # anchor — recovery would skip them and compaction would
            # prune their segments (silent loss)
            _, anchor = save_store_anchored(
                self.store, self.snapshot_path, fsync=True,
                extra={"wal_generation": self._generation},
                settle=True)
        except OSError as e:
            self._degrade(f"WAL compaction snapshot failed: {e}")
            return self._durable_rv
        _maybe_crash("mid-compaction")
        # every non-active segment is either from a dead generation or
        # covers rvs <= anchor (the rotate above happened pre-snapshot,
        # and the snapshot state is a superset of everything durable at
        # that point) — delete oldest-first so a crash mid-purge leaves
        # a contiguous suffix
        active = os.path.basename(self._segment_path)
        for name in self.segments():
            if name == active:
                continue
            gen, _seq, base = _segment_sort_key(name)
            if gen < self._generation or base <= anchor:
                try:
                    os.unlink(os.path.join(self.data_dir, name))
                except OSError:
                    pass
        _fsync_dir(self.data_dir)
        self.compactions += 1
        self._last_compact = time.perf_counter()
        m.inc(m.WAL_COMPACTIONS)
        m.set_gauge(m.WAL_SEGMENTS, len(self.segments()))
        return anchor

    # -- reporting ---------------------------------------------------------

    def _p(self, ring: deque, q: float) -> float:
        if not ring:
            return 0.0
        vals = sorted(ring)
        return round(vals[min(len(vals) - 1,
                              int(q * (len(vals) - 1)))], 3)

    def report(self) -> dict:
        segs = self.segments()
        seg_bytes = 0
        for name in segs:
            try:
                seg_bytes += os.path.getsize(
                    os.path.join(self.data_dir, name))
            except OSError:
                pass
        with self._lock:
            pending = self._pending_entries
        with self._io:
            durable = self._durable_rv
        store_rv = self.store.current_rv() if self.store is not None \
            else 0
        return {
            "data_dir": self.data_dir,
            "attached": self.store is not None,
            "read_only": self._degraded is not None,
            "degraded_reason": self._degraded,
            "generation": self._generation,
            "durable_rv": durable,
            "store_rv": store_rv,
            "lag_entries": max(0, store_rv - durable) + pending,
            "pending_entries": pending,
            "segments": len(segs),
            "segment_bytes": seg_bytes,
            "records_written": self.records_written,
            "entries_written": self.entries_written,
            "flushes": self.flushes,
            "fsyncs": self.fsyncs,
            "fsync_p50_ms": self._p(self._fsync_ms, 0.50),
            "fsync_p99_ms": self._p(self._fsync_ms, 0.99),
            "append_p99_ms": self._p(self._append_ms, 0.99),
            "rotations": self.rotations,
            "compactions": self.compactions,
            "append_errors": self.append_errors,
            "flush_interval": self.flush_interval,
            "compact_interval": self.compact_interval,
        }


def _segment_sort_key(name: str) -> Tuple[int, int, int]:
    mt = _SEGMENT_RE.match(name)
    return (int(mt.group(1)), int(mt.group(2)), int(mt.group(3)))


def _max_gen_seq(data_dir: str) -> Tuple[int, int]:
    gen = seq = 0
    try:
        names = os.listdir(data_dir)
    except OSError:
        return 0, 0
    for name in names:
        mt = _SEGMENT_RE.match(name)
        if mt:
            g, s = int(mt.group(1)), int(mt.group(2))
            if (g, s) > (gen, seq):
                gen, seq = g, s
    return gen, seq


# ---------------------------------------------------------------------------
# recovery
# ---------------------------------------------------------------------------


def recover_store(data_dir: str, store=None, clock=None) -> tuple:
    """Replay snapshot + WAL tail into ``store`` (or a fresh one),
    rv-preserving. Returns ``(store, report)``.

    Decision table (docs/design/durability.md):

    - no snapshot, no segments → fresh empty store;
    - snapshot only (legacy ``--data-dir`` layout) → install at its
      recorded rv;
    - snapshot + segments → install, then replay every record of the
      snapshot's WAL generation whose entries are above the anchor;
      entry runs must extend the anchor contiguously;
    - torn final record (short header/payload, or CRC-fail with nothing
      durable after it) → truncated away, replay continues with the
      clean prefix;
    - CRC-fail mid-log → :class:`WalCorruptionError` (refuse loudly).

    The rv sequencer re-anchors at the last replayed rv and the fence
    floor at max(snapshot floor, replayed fence records) — a recovering
    federation replica resumes from LOCAL state and only falls back to
    peer snapshot bootstrap when its log is behind or damaged.
    """
    from .persistence import load_snapshot_payload
    from .store import ObjectStore
    if store is None:
        store = ObjectStore(clock=clock) if clock is not None \
            else ObjectStore()
    t0 = time.perf_counter()
    report = {"data_dir": os.path.abspath(data_dir), "snapshot_rv": 0,
              "snapshot_objects": 0, "generation": 0,
              "segments_scanned": 0, "records_replayed": 0,
              "entries_replayed": 0, "torn_records_truncated": 0,
              "truncated_bytes": 0, "fence_floor": 0, "final_rv": 0}
    snap_path = os.path.join(data_dir, WriteAheadLog.SNAPSHOT_NAME)
    anchor = 0
    generation = 0
    fence_floor = 0
    if os.path.exists(snap_path):
        payload = load_snapshot_payload(snap_path)
        anchor = int(payload.get("resource_version", 0))
        generation = int(payload.get("wal_generation", 0))
        fence_floor = int(payload.get("fence_floor", 0))
        objects: Dict[str, dict] = {}
        count = 0
        for kind, items in payload.get("objects", {}).items():
            bucket = objects.setdefault(kind, {})
            for data in items:
                o = decode_object(kind, data)
                bucket[store.key_of(kind, o)] = o
                count += 1
        store.install_snapshot(objects, anchor)
        report["snapshot_rv"] = anchor
        report["snapshot_objects"] = count
        report["generation"] = generation

    seg_names = []
    if os.path.isdir(data_dir):
        seg_names = sorted((n for n in os.listdir(data_dir)
                            if _SEGMENT_RE.match(n)),
                           key=_segment_sort_key)
    expected = anchor + 1
    for name in seg_names:
        gen, _seq, _base = _segment_sort_key(name)
        if gen != generation:
            continue        # dead generation (pre-bootstrap rv space)
        path = os.path.join(data_dir, name)
        reader = _SegmentReader(path).scan()
        report["segments_scanned"] += 1
        for rec in reader.records:
            t = rec.get("t")
            if t == "seg":
                continue
            if t == "f":
                fence_floor = max(fence_floor, int(rec.get("token", 0)))
                report["records_replayed"] += 1
                continue
            if t != "e":
                continue
            entries = []
            for rv, action, kind, data in rec["e"]:
                rv = int(rv)
                if rv <= anchor:
                    continue        # below the snapshot anchor
                if rv != expected and not entries and rv <= expected - 1:
                    continue
                if entries and rv != entries[-1][0] + 1:
                    # a CRC-valid record is still one contiguous run by
                    # construction — an interior gap is framing damage,
                    # never silently absorbed
                    raise WalCorruptionError(
                        f"WAL rv gap inside record in {path}: "
                        f"{entries[-1][0]} followed by {rv} — refusing "
                        f"to replay a damaged log", segment=path)
                entries.append((rv, action, kind,
                                decode_object(kind, data)))
            if not entries:
                continue
            if entries[0][0] != expected:
                raise WalCorruptionError(
                    f"WAL gap in {path}: expected rv {expected}, "
                    f"record starts at {entries[0][0]} — a segment "
                    f"below it is missing or damaged",
                    segment=path)
            try:
                store.apply_replicated(entries)
            except Exception as e:
                raise WalCorruptionError(
                    f"WAL replay failed in {path}: {e}",
                    segment=path) from e
            expected = entries[-1][0] + 1
            report["records_replayed"] += 1
            report["entries_replayed"] += len(entries)
        if reader.truncate_at is not None:
            # torn tail: only the final segment may carry one — a torn
            # record with durable segments after it is mid-log damage
            if name != seg_names[-1]:
                raise WalCorruptionError(
                    f"torn record at {path}:{reader.truncate_at} in a "
                    f"non-final segment — refusing to replay",
                    segment=path, offset=reader.truncate_at)
            size = os.path.getsize(path)
            report["torn_records_truncated"] += 1
            report["truncated_bytes"] += size - reader.truncate_at
            with open(path, "rb+") as f:
                f.truncate(reader.truncate_at)
                os.fsync(f.fileno())
    if fence_floor:
        store.advance_fence(fence_floor)
    report["fence_floor"] = fence_floor
    report["final_rv"] = store.current_rv()
    report["recovery_ms"] = round((time.perf_counter() - t0) * 1000.0, 3)
    m.inc(m.WAL_RECOVERIES)
    if report["torn_records_truncated"]:
        m.inc(m.WAL_TORN_TRUNCATIONS,
              report["torn_records_truncated"])
    _LAST_RECOVERY.clear()
    _LAST_RECOVERY.update(report)
    return store, report


# ---------------------------------------------------------------------------
# active-WAL registry (the /debug/durability surface)
# ---------------------------------------------------------------------------

_ACTIVE: Dict[str, Optional[WriteAheadLog]] = {"wal": None}
_LAST_RECOVERY: dict = {}


def set_active(wal: Optional[WriteAheadLog]) -> None:
    _ACTIVE["wal"] = wal


def durability_report() -> dict:
    """The /debug/durability payload: the active WAL's report (or an
    unattached stub) plus the last recovery's verdict."""
    wal = _ACTIVE["wal"]
    if wal is None:
        out = {"attached": False, "read_only": False}
    else:
        out = wal.report()
    if _LAST_RECOVERY:
        out["last_recovery"] = dict(_LAST_RECOVERY)
    return out


__all__ = ["WriteAheadLog", "WalCorruptionError", "recover_store",
           "durability_report", "set_active", "pack_record"]
