"""Durable submission journal for service mode (docs/SERVING.md
"Durability").

Port (a copy) of ``cluster_tools_tpu/runtime/journal.py``: the same frame
layout, magic and JSON keys, so a journal written by either package scans
and folds to the same lifecycle in the other.

Without it, durability stopped at the graceful drain: a SIGTERM finished
in-flight work and exited 114, but queued and accepted requests died with
the process — on a preemptible fleet, where the common failure is an
abrupt ``kill -9`` and not a polite drain, that pushed exactly-once
bookkeeping onto every client.  This module makes ``/submit``'s 200 a
durable promise: every request lifecycle transition (``accepted`` →
``dispatched`` → ``completed`` / ``failed`` / ``rejected`` /
``quarantined``) is an fsync'd, CRC-framed, append-only record written
*before* the state is acknowledged over HTTP, and a restarted
:class:`~.server.PipelineServer` replays the
journal to reconstruct exactly what it promised:

- **completed** requests are served idempotently — a duplicate resubmit of
  a done id answers from the recorded result instead of re-running (or
  bouncing ``rejected:duplicate``);
- **acknowledged-but-incomplete** requests (accepted / dispatched /
  drained) are re-enqueued with their original tenant + payload and re-run
  through the ordinary resume machinery — block markers plus the
  namespace-stale handoff invalidation make the rerun bit-identical;
- a replayed request that crashes the server ``max_replay_attempts`` times
  (the attempt count is itself journaled as ``dispatched`` records) is
  **quarantined** with a typed ``quarantined:crash_loop`` record instead
  of wedging the server in a crash loop.

Frame format (append-only, binary)::

    MAGIC(4 = b"CTJ1") | payload_len(u32 LE) | crc32(payload)(u32 LE) | payload

``payload`` is compact JSON.  The reader (:func:`scan`) walks frames from
the start and stops at the FIRST inconsistency — short header, short
payload, bad magic, CRC mismatch, unparseable JSON — treating everything
after it as a torn tail: :meth:`Journal.recover` truncates the file back
to the last intact frame and warns, it never refuses to boot (the same
truncate-and-warn posture the atomic-write discipline CT002 gives JSON
manifests).  A torn tail can only be a *suffix* because appends are
serialized under the journal lock, every append is fsync'd before the
state it records becomes observable, and a deliberately torn write (the
injected ``torn`` fault at site ``journal``) hard-exits the process — a
torn record mid-file therefore cannot be followed by intact ones.

Lock discipline (ctlint CT010): all appends go through
:meth:`Journal.append` (raw writes to the journal file anywhere else are
a lint finding), the append path must show fsync evidence, and journal IO
— an fsync is a disk round trip — must never run under the server's
admission/request locks.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
import zlib
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from ..utils import function_utils as fu
from . import faults as faults_mod
from . import trace as trace_mod

#: the journal file, next to ``server_state.json`` / ``failures.json``
JOURNAL_FILENAME = "journal.log"

#: the fence-epoch file, next to the journal it guards (docs/SERVING.md
#: "Gray failures").  Minted (monotonically bumped) by whoever wins the
#: adoption claim for this member's journal; the member itself re-checks
#: it before every journal append and handoff flush, so a falsely-
#: declared-dead zombie that wakes after adoption can never fork the
#: truth a survivor now owns.
FENCE_FILENAME = "fence.json"

MAGIC = b"CTJ1"
_HEADER = struct.Struct("<4sII")  # magic, payload length, crc32(payload)

#: a frame claiming a payload larger than this is framing damage, not a
#: record (the journal holds request metadata, never array data)
MAX_RECORD_BYTES = 16 << 20

#: lifecycle record types (the ``type`` field of every journal record)
ACCEPTED = "accepted"
DISPATCHED = "dispatched"
COMPLETED = "completed"
FAILED = "failed"
REJECTED = "rejected"
QUARANTINED = "quarantined"
DRAINED = "drained"

#: types that end a request's lifecycle; anything else at replay time is an
#: acknowledged-but-incomplete request the restarted server must finish
TERMINAL_TYPES = (COMPLETED, FAILED, REJECTED, QUARANTINED)


#: rotation threshold (bytes) applied on clean boot; 0 disables.  One
#: ``.old`` segment is kept — rotation stops unbounded growth; in-segment
#: redundancy compaction stays future work.
DEFAULT_ROTATE_BYTES = 8 << 20


def rotate_bytes_default() -> int:
    """Boot-time rotation threshold (``CTT_JOURNAL_ROTATE_BYTES``)."""
    try:
        return int(os.environ.get("CTT_JOURNAL_ROTATE_BYTES", "") or
                   DEFAULT_ROTATE_BYTES)
    except ValueError:
        return DEFAULT_ROTATE_BYTES


def journal_path(base_dir: str) -> str:
    return os.path.join(base_dir, JOURNAL_FILENAME)


# -- fencing epochs (docs/SERVING.md "Gray failures") -------------------------
#
# The adoption claim (runtime/fleet.py) proves at most one ADOPTER; fencing
# proves the ADOPTED member can no longer write.  Protocol:
#
#   1. the survivor wins ``adoption.claim`` (O_CREAT|O_EXCL),
#   2. it MINTS a new fence epoch next to the victim's journal
#      (:func:`mint_fence` — read-bump-atomic-replace, strictly monotonic
#      because the replace is atomic and minting happens only under the
#      exclusive claim),
#   3. only THEN does it scan the journal (``read_peer_journal``) and adopt.
#
# Every member boots owning the epoch it finds (:func:`read_fence`) and
# re-validates through a :class:`FenceGuard` — one ``os.stat`` per check,
# re-reading the JSON only when (mtime_ns, size, ino) moved — immediately
# before each journal append (inside :meth:`Journal.append`, under the
# journal lock) and each handoff flush.  A SIGSTOP'd zombie is frozen for
# the whole mint-then-scan window, so its first instruction after SIGCONT
# that could touch the journal re-checks the (changed) fence file, sees the
# higher epoch, and raises :class:`Fenced` — structurally before any byte
# of the old epoch reaches a journal the survivor owns.

class Fenced(RuntimeError):
    """This process's fence epoch has been superseded: a survivor holds
    the adoption claim and owns the journal now.  The only safe move is
    to stop writing and self-drain (``fenced:adopted_away``)."""

    def __init__(self, own_epoch: int, current_epoch: int,
                 minted_by: Optional[str] = None):
        self.own_epoch = int(own_epoch)
        self.current_epoch = int(current_epoch)
        self.minted_by = minted_by
        super().__init__(
            f"fenced: epoch {self.own_epoch} superseded by "
            f"{self.current_epoch}"
            + (f" (minted by {minted_by})" if minted_by else "")
        )


def fence_path(base_dir: str) -> str:
    return os.path.join(base_dir, FENCE_FILENAME)


def read_fence(base_dir: str) -> Dict[str, Any]:
    """The current fence doc: ``{"epoch", "minted_by", "time"}``.  A
    missing or unparseable file reads as epoch 0 — safe because the file
    is only ever installed by atomic replace, so a torn final file cannot
    arise from a crash (the property test crashes the mint at every byte
    offset to prove the epoch never regresses)."""
    try:
        with open(fence_path(base_dir), "r") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return {"epoch": 0, "minted_by": None, "time": None}
    if not isinstance(doc, dict):
        return {"epoch": 0, "minted_by": None, "time": None}
    try:
        epoch = int(doc.get("epoch") or 0)
    except (TypeError, ValueError):
        epoch = 0
    return {"epoch": epoch, "minted_by": doc.get("minted_by"),
            "time": doc.get("time")}


def mint_fence(base_dir: str, by: Optional[str] = None) -> int:
    """Bump the fence epoch by one and return the new value.

    Write discipline mirrors every manifest in the repo (CT002): full doc
    to a tmp file, flush + fsync, then ONE ``os.replace`` — a crash at any
    byte offset of the tmp write leaves the old fence intact, so epochs
    are strictly monotonic across arbitrary adopt/respawn/re-adopt
    interleavings.  Monotonicity across *concurrent* minters is the
    adoption claim's job: mint only while holding ``adoption.claim``.
    """
    new_epoch = int(read_fence(base_dir)["epoch"]) + 1
    doc = {"epoch": new_epoch, "minted_by": by,
           "time": trace_mod.walltime()}
    path = fence_path(base_dir)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    try:
        dfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass  # dir-entry durability is best-effort
    return new_epoch


class FenceGuard:
    """Cheap membership re-validation: holds the epoch this process booted
    with and raises :class:`Fenced` the moment a higher one appears.

    ``check()`` is one ``os.stat`` on the hot path; the JSON is re-read
    only when the file's (mtime_ns, size, ino) signature moves — i.e.
    exactly once per adoption, however many appends happen between.
    """

    def __init__(self, base_dir: str, own_epoch: Optional[int] = None):
        self.base_dir = base_dir
        self.path = fence_path(base_dir)
        self.own_epoch = int(
            read_fence(base_dir)["epoch"] if own_epoch is None else own_epoch
        )
        self._lock = threading.Lock()
        self._cached_sig: Optional[Tuple[int, int, int]] = None
        self._cached_epoch = self.own_epoch
        self._cached_by: Optional[str] = None
        self.checks = 0
        self.rereads = 0

    def current(self) -> int:
        """The last epoch observed (refreshing the cache), without
        raising — the state-doc / progress view uses this."""
        try:
            self.check()
        except Fenced as exc:
            return exc.current_epoch
        return self._cached_epoch

    def check(self) -> None:
        """Raise :class:`Fenced` iff a higher epoch has been minted."""
        try:
            st = os.stat(self.path)
        except OSError:
            return  # never minted: nobody has ever adopted this journal
        sig = (st.st_mtime_ns, st.st_size, st.st_ino)
        with self._lock:
            self.checks += 1
            if sig != self._cached_sig:
                doc = read_fence(self.base_dir)
                self._cached_sig = sig
                self._cached_epoch = max(
                    int(doc["epoch"]), self._cached_epoch
                )
                self._cached_by = doc.get("minted_by")
                self.rereads += 1
            epoch, by = self._cached_epoch, self._cached_by
        if epoch > self.own_epoch:
            raise Fenced(self.own_epoch, epoch, by)


def _frame(record: Dict[str, Any]) -> bytes:
    payload = json.dumps(
        record, separators=(",", ":"), sort_keys=True, default=str
    ).encode()
    return _HEADER.pack(MAGIC, len(payload), zlib.crc32(payload)) + payload


def snapshot_records(ent: Dict[str, Any]) -> List[Dict[str, Any]]:
    """The minimal record sequence that folds back to one request's
    ``fold()`` entry — what rotation writes into the fresh segment so a
    later replay reconstructs the same promises from a bounded file."""
    state = ent.get("state")
    tenant = ent.get("tenant") or "default"
    rid = ent["request_id"]
    out: List[Dict[str, Any]] = []
    if state == REJECTED:
        if ent.get("payload") is not None:
            out.append({"type": ACCEPTED, "request_id": rid,
                        "tenant": tenant, "payload": ent.get("payload"),
                        "fingerprint": ent.get("fingerprint")})
        out.append({"type": REJECTED, "request_id": rid, "tenant": tenant,
                    "code": ent.get("code")})
        return out
    out.append({"type": ACCEPTED, "request_id": rid, "tenant": tenant,
                "payload": ent.get("payload"),
                "fingerprint": ent.get("fingerprint")})
    if ent.get("attempts"):
        out.append({"type": DISPATCHED, "request_id": rid, "tenant": tenant,
                    "attempt": int(ent["attempts"])})
    if state == DRAINED:
        out.append({"type": DRAINED, "request_id": rid, "tenant": tenant})
    elif state in (COMPLETED, FAILED, QUARANTINED):
        out.append({"type": state, "request_id": rid, "tenant": tenant,
                    "record": ent.get("record")})
    return out


def scan(path: str) -> Tuple[List[Dict[str, Any]], int, int]:
    """Read every intact record of ``path`` in append order.

    Returns ``(records, intact_bytes, torn_bytes)``: ``intact_bytes`` is
    the offset of the last frame that framed, CRC'd, and parsed;
    ``torn_bytes`` is whatever trails it (0 for a clean journal).  Missing
    file = ``([], 0, 0)``.  Pure function, stdlib only — the report
    tooling mirrors this framing without importing the runtime.
    """
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return [], 0, 0
    records: List[Dict[str, Any]] = []
    off = 0
    while True:
        header = data[off:off + _HEADER.size]
        if len(header) < _HEADER.size:
            break
        magic, length, crc = _HEADER.unpack(header)
        if magic != MAGIC or length > MAX_RECORD_BYTES:
            break
        payload = data[off + _HEADER.size:off + _HEADER.size + length]
        if len(payload) < length or zlib.crc32(payload) != crc:
            break
        try:
            rec = json.loads(payload)
        except ValueError:
            break
        if not isinstance(rec, dict):
            break
        records.append(rec)
        off += _HEADER.size + length
    return records, off, len(data) - off


def fold(records) -> "OrderedDict[str, Dict[str, Any]]":
    """Collapse the record stream into per-request final state, in first-
    acknowledgement order.

    Each entry: ``{"request_id", "tenant", "payload", "fingerprint",
    "state", "attempts", "record", "code"}`` where ``state`` is the last
    lifecycle type seen, ``attempts`` counts ``dispatched`` records (the
    crash-loop budget), and ``record`` is the terminal request record for
    completed/failed/quarantined entries (the idempotent-answer source).
    A fresh ``accepted`` after a terminal state starts a new incarnation
    of the id — the typed-backpressure protocol is back-off-and-resubmit
    the same id, so a rejected/failed id must be re-acceptable.
    """
    reqs: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
    for rec in records:
        rid = rec.get("request_id")
        typ = rec.get("type")
        if not rid or not typ:
            continue
        ent = reqs.get(rid)
        if typ == ACCEPTED:
            if ent is None or ent["state"] in TERMINAL_TYPES:
                reqs[rid] = {
                    "request_id": rid,
                    "tenant": rec.get("tenant") or "default",
                    "payload": rec.get("payload"),
                    "fingerprint": rec.get("fingerprint"),
                    "state": ACCEPTED,
                    "attempts": 0,
                    "record": None,
                    "code": None,
                }
            # a duplicate accepted for a LIVE id is the racing-submit /
            # client-retry case: the first acknowledgement stands
            continue
        if ent is None:
            if typ == REJECTED:
                # rejected at admission (quota / injected fault): the only
                # transition journaled without a prior accepted
                reqs[rid] = {
                    "request_id": rid,
                    "tenant": rec.get("tenant") or "default",
                    "payload": None,
                    "fingerprint": None,
                    "state": REJECTED,
                    "attempts": 0,
                    "record": None,
                    "code": rec.get("code"),
                }
            continue
        if typ == DISPATCHED:
            ent["state"] = DISPATCHED
            ent["attempts"] = max(
                ent["attempts"] + 1, int(rec.get("attempt") or 0)
            )
        elif typ == DRAINED:
            ent["state"] = DRAINED
            # a graceful drain PROVES the dispatch did not crash the
            # server — rolling SIGTERM restarts of a long-running request
            # must never accrue toward the crash-loop budget, or routine
            # redeploys would quarantine innocent work
            ent["attempts"] = 0
        elif typ in (COMPLETED, FAILED, QUARANTINED):
            ent["state"] = typ
            ent["record"] = rec.get("record")
        elif typ == REJECTED:
            ent["state"] = REJECTED
            ent["code"] = rec.get("code")
    return reqs


class Journal:
    """The append side: one fsync'd CRC-framed record per lifecycle
    transition, serialized under the journal's own lock (never the
    server's admission/request locks — CT010)."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._fh = None
        #: optional :class:`FenceGuard` — when set, every append re-checks
        #: the fence epoch under the journal lock, immediately before the
        #: write, and raises :class:`Fenced` instead of forking a journal
        #: a survivor owns (docs/SERVING.md "Gray failures")
        self.fence_guard: Optional[FenceGuard] = None
        # stats for /healthz + server_state.json (docs/SERVING.md)
        self.appended = 0
        self.bytes = 0
        self.torn_bytes_truncated = 0
        self.rotations = 0
        self.rotated_from_bytes = 0
        self._last_fsync_mono: Optional[float] = None

    # -- recovery ----------------------------------------------------------
    def recover(self) -> List[Dict[str, Any]]:
        """Read every intact record, truncate a torn tail back to the last
        intact frame (warn, never refuse to boot), and open the file for
        appending.  Must be called before the first :meth:`append`."""
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        records, good, torn = scan(self.path)
        if torn:
            fu.log(
                f"journal {self.path}: torn tail ({torn} byte(s) after "
                f"{len(records)} intact record(s)) — truncating to the "
                "last intact frame"
            )
            with open(self.path, "r+b") as f:
                f.truncate(good)
                f.flush()
                os.fsync(f.fileno())
            self.torn_bytes_truncated = torn
        with self._lock:
            self._fh = open(self.path, "ab")
            self.bytes = good
        return records

    def maybe_rotate(self, folded, max_bytes: Optional[int] = None,
                     keep_terminal: int = 512) -> bool:
        """Size guard, run on clean boot after replay: past ``max_bytes``
        (default :func:`rotate_bytes_default`; <=0 disables), snapshot the
        folded live state into a fresh segment and move the old file to
        ``<path>.old``.  The snapshot (one compact record sequence per
        request, :func:`snapshot_records`) folds back to the same per-
        request promises, so a crash right after rotation replays
        identically — no acknowledged request is ever only in the
        archived segment.  Redundancy collapses (repeat dispatches,
        drain/replay churn, superseded incarnations become one sequence),
        and terminal entries beyond ``keep_terminal`` — the server's
        answerable-record cap; older ids are pruned from its memory and
        cannot be answered idempotently anyway — are dropped, oldest
        first.  One ``.old`` is kept (a later rotation replaces it):
        unbounded growth stops here; richer in-segment compaction stays
        future work (docs/SERVING.md "Durability")."""
        limit = rotate_bytes_default() if max_bytes is None else int(max_bytes)
        if limit <= 0:
            return False
        with self._lock:
            if self._fh is None:  # pragma: no cover - misuse guard
                raise RuntimeError("journal.maybe_rotate before recover()")
            old_bytes = self.bytes
        if old_bytes <= limit:
            return False
        ents = list((folded or {}).values())
        terminal = [e for e in ents if e.get("state") in TERMINAL_TYPES]
        if keep_terminal is not None and len(terminal) > int(keep_terminal):
            drop = {id(e) for e in terminal[:-int(keep_terminal)]}
            ents = [e for e in ents if id(e) not in drop]
        tmp = f"{self.path}.rotate.{os.getpid()}"
        n = 0
        with open(tmp, "wb") as f:
            for ent in ents:
                for rec in snapshot_records(ent):
                    f.write(_frame(rec))
                    n += 1
            f.flush()
            os.fsync(f.fileno())
        with self._lock:
            self._fh.close()
            # crash-window discipline: journal.log must EXIST with either
            # the old or the new content at every instant.  Archive via a
            # hard link (the old inode gains the .old name while keeping
            # the journal name), then ONE atomic replace installs the
            # snapshot — there is no window with the journal missing, so
            # a kill mid-rotation replays identically from the old file.
            old = self.path + ".old"
            try:
                os.remove(old)
            except FileNotFoundError:
                pass
            os.link(self.path, old)
            os.replace(tmp, self.path)
            try:
                dfd = os.open(os.path.dirname(self.path) or ".", os.O_RDONLY)
                try:
                    os.fsync(dfd)
                finally:
                    os.close(dfd)
            except OSError:
                pass  # dir-entry durability is best-effort
            self._fh = open(self.path, "ab")
            self.bytes = os.path.getsize(self.path)
            self.rotations += 1
            self.rotated_from_bytes = old_bytes
        fu.log(
            f"journal {self.path}: rotated {old_bytes} byte(s) to .old on "
            f"boot (> {limit}); fresh segment holds {n} snapshot record(s)"
        )
        return True

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    # -- the one append path (CT010) ---------------------------------------
    def append(self, record: Dict[str, Any]) -> None:
        """Frame, append, and fsync one lifecycle record.  Returns only
        once the record is durable — callers acknowledge state over HTTP
        strictly after this returns, so an acknowledgement always has a
        journal record behind it (SIGKILL included)."""
        frame = _frame(record)
        inj = faults_mod.get_injector()
        with self._lock:
            if self._fh is None:  # pragma: no cover - misuse guard
                raise RuntimeError("journal.append before recover()")
            if self.fence_guard is not None:
                # last possible instant before bytes move: a zombie that
                # was adopted away raises Fenced here, with the frame
                # still un-written
                self.fence_guard.check()
            keep = inj.torn_append()
            if keep is not None:
                # the injected torn write (kind='torn', site='journal'):
                # a strict prefix of the frame reaches the disk and the
                # process dies mid-append — the only way a torn tail
                # arises.  The restarted reader must truncate-and-warn.
                self._fh.write(frame[:max(1, int(len(frame) * keep))])
                self._fh.flush()
                os.fsync(self._fh.fileno())
                faults_mod.hard_exit()
            self._fh.write(frame)
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self.appended += 1
            self.bytes += len(frame)
            self._last_fsync_mono = time.monotonic()
        # crash-after-ackable-write: the record is durable, the in-memory
        # state that mirrors it is not yet published — replay must
        # reconstruct it (chaos kills here to prove that)
        inj.kill_point("journal_append")

    def append_transition(self, typ: str, request_id: str,
                          **fields: Any) -> None:
        """``append`` with the envelope every lifecycle record shares."""
        rec = {"type": typ, "request_id": request_id,
               "time": trace_mod.walltime()}
        rec.update(fields)
        self.append(rec)

    # -- introspection -----------------------------------------------------
    def health(self) -> Dict[str, Any]:
        """The journal block of ``/healthz`` / ``server_state.json``:
        byte size, appended-record count, last-fsync age, and the torn
        bytes recovery truncated at boot."""
        with self._lock:
            last = self._last_fsync_mono
            return {
                "path": self.path,
                "bytes": int(self.bytes),
                "appended": int(self.appended),
                "last_fsync_age_s": (
                    round(time.monotonic() - last, 3)
                    if last is not None else None
                ),
                "torn_bytes_truncated": int(self.torn_bytes_truncated),
                "rotations": int(self.rotations),
                "rotated_from_bytes": int(self.rotated_from_bytes),
            }
