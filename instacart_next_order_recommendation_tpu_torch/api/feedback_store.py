"""SQLite storage for feedback events.

The port's copy of the JAX package's ``api/feedback_store.py``: the same
schema, indices and insert semantics (COALESCE created_at, executemany
batch transaction), so a feedback DB written by either server is read by
the other.
"""

from __future__ import annotations

import json
import os
import sqlite3
import threading
from dataclasses import dataclass
from datetime import datetime
from pathlib import Path
from typing import Any, Iterable, Mapping, Optional

from instacart_next_order_recommendation_tpu_torch.constants import (
    DEFAULT_FEEDBACK_DB_PATH,
    ENV_FEEDBACK_DB_PATH,
)

_INSERT_SQL = """
INSERT INTO feedback_events (
    request_id, event_type, user_id, product_id,
    user_context_hash, metadata, created_at
)
VALUES (?, ?, ?, ?, ?, ?, COALESCE(?, CURRENT_TIMESTAMP))
"""


def get_db_path() -> Path:
    value = os.getenv(ENV_FEEDBACK_DB_PATH)
    return Path(value) if value else DEFAULT_FEEDBACK_DB_PATH


_initialized_paths: set[str] = set()
_init_lock = threading.Lock()


def init_db() -> Path:
    """Create the feedback table and indices if missing; returns the DB path.

    Idempotent and cached per resolved path: record_event/record_events call
    this on every insert, and re-running seven DDL statements per feedback
    event would dominate an ingest path whose latency histogram starts at
    1 ms buckets. (If the DB file is deleted mid-run, restart the process —
    or point ENV_FEEDBACK_DB_PATH at a new path — to re-run the DDL.)
    """
    db_path = get_db_path().resolve()
    key = str(db_path)
    if key in _initialized_paths:
        return db_path
    with _init_lock:
        if key in _initialized_paths:
            return db_path
        _create_schema(db_path)
        _initialized_paths.add(key)
    return db_path


def _create_schema(db_path: Path) -> None:
    db_path.parent.mkdir(parents=True, exist_ok=True)
    conn = sqlite3.connect(db_path)
    try:
        cur = conn.cursor()
        cur.execute(
            """
            CREATE TABLE IF NOT EXISTS feedback_events (
                id INTEGER PRIMARY KEY AUTOINCREMENT,
                request_id TEXT,
                event_type TEXT NOT NULL,
                user_id TEXT,
                product_id TEXT NOT NULL,
                user_context_hash TEXT,
                metadata TEXT,
                created_at TIMESTAMP DEFAULT CURRENT_TIMESTAMP
            )
            """
        )
        cur.execute(
            "CREATE INDEX IF NOT EXISTS idx_feedback_request ON feedback_events(request_id)"
        )
        cur.execute(
            "CREATE INDEX IF NOT EXISTS idx_feedback_event_type ON feedback_events(event_type)"
        )
        cur.execute(
            "CREATE INDEX IF NOT EXISTS idx_feedback_created ON feedback_events(created_at)"
        )
        # Server-side request-context store: lets the retrain pipeline join
        # feedback events to the full serving context without clients
        # echoing it back in metadata.
        cur.execute(
            """
            CREATE TABLE IF NOT EXISTS request_contexts (
                request_id TEXT PRIMARY KEY,
                user_id TEXT,
                user_context TEXT NOT NULL,
                created_at TIMESTAMP DEFAULT CURRENT_TIMESTAMP
            )
            """
        )
        cur.execute(
            "CREATE INDEX IF NOT EXISTS idx_context_created ON request_contexts(created_at)"
        )
        conn.commit()
    finally:
        conn.close()


@dataclass
class FeedbackEventRecord:
    request_id: Optional[str]
    event_type: str
    product_id: str
    user_id: Optional[str] = None
    user_context_hash: Optional[str] = None
    metadata: Optional[Mapping[str, Any]] = None
    created_at: Optional[datetime] = None

    def row(self) -> tuple:
        return (
            self.request_id,
            self.event_type,
            self.user_id,
            self.product_id,
            self.user_context_hash,
            _serialize_metadata(self.metadata),
            self.created_at.isoformat() if self.created_at else None,
        )


def _serialize_metadata(metadata: Optional[Mapping[str, Any]]) -> Optional[str]:
    if metadata is None:
        return None
    try:
        return json.dumps(metadata, ensure_ascii=False)
    except TypeError:
        return json.dumps(str(metadata), ensure_ascii=False)


def record_event(event: FeedbackEventRecord) -> None:
    db_path = init_db()
    conn = sqlite3.connect(db_path)
    try:
        conn.execute(_INSERT_SQL, event.row())
        conn.commit()
    finally:
        conn.close()


def record_events(events: Iterable[FeedbackEventRecord]) -> None:
    rows = [e.row() for e in events]
    if not rows:
        return
    db_path = init_db()
    conn = sqlite3.connect(db_path)
    try:
        conn.executemany(_INSERT_SQL, rows)
        conn.commit()
    finally:
        conn.close()


class _ContextWriter:
    """Async single-writer for request contexts.

    The context insert sits on the /recommend hot path: a synchronous
    connect + INSERT + fsync'ing commit + close per request would serialize
    the worker threads on SQLite's file lock. Requests enqueue and return;
    one daemon thread drains the queue and commits each drained batch in
    ONE transaction per DB path. Readers call ``flush()`` first
    (load_context_events does), so read-your-writes stays intact while the
    serve path never touches the disk.
    """

    _FLUSH = object()

    def __init__(self) -> None:
        import queue

        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._start_lock = threading.Lock()
        self._thread: threading.Thread | None = None

    def _ensure_thread(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        with self._start_lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="request-context-writer"
            )
            self._thread.start()

    def put(self, db_path: Path, row: tuple) -> None:
        self._ensure_thread()
        self._q.put((str(db_path), row))

    def flush(self, timeout: float = 10.0) -> None:
        """Block until everything enqueued before this call is committed."""
        if self._thread is None or not self._thread.is_alive():
            return
        done = threading.Event()
        self._q.put((self._FLUSH, done))
        done.wait(timeout=timeout)

    def _run(self) -> None:
        import logging
        import queue

        log = logging.getLogger(__name__)
        while True:
            items = [self._q.get()]  # block for the first item
            try:
                while True:
                    items.append(self._q.get_nowait())
            except queue.Empty:
                pass
            by_path: dict[str, list[tuple]] = {}
            flushes: list[threading.Event] = []
            for key, payload in items:
                if key is self._FLUSH:
                    flushes.append(payload)
                else:
                    by_path.setdefault(key, []).append(payload)
            for path, rows in by_path.items():
                try:
                    conn = sqlite3.connect(path)
                    try:
                        conn.executemany(
                            "INSERT OR REPLACE INTO request_contexts"
                            " (request_id, user_id, user_context) VALUES (?, ?, ?)",
                            rows,
                        )
                        conn.commit()
                    finally:
                        conn.close()
                except Exception:  # noqa: BLE001 - best-effort persistence
                    log.exception("request-context batch write failed (%d rows)", len(rows))
            for ev in flushes:
                ev.set()


_context_writer = _ContextWriter()


def flush_request_contexts(timeout: float = 10.0) -> None:
    """Barrier for readers of ``request_contexts``: returns once every
    context enqueued before the call is committed."""
    _context_writer.flush(timeout)


def record_request_context(
    request_id: str, user_context: str, user_id: Optional[str] = None
) -> None:
    """Persist the serving context for a request (feeds the retrain loop).

    Asynchronous: enqueues to the single-writer thread and returns (the
    serve path must not pay per-request fsyncs — see _ContextWriter).
    Readers call ``flush_request_contexts()`` for read-your-writes.
    Opt-out via STORE_REQUEST_CONTEXTS=0 (then only a client-provided
    context hash is stored, with the feedback event).
    """
    if os.getenv("STORE_REQUEST_CONTEXTS", "1").strip() in ("0", "false"):
        return
    db_path = init_db()
    _context_writer.put(db_path, (request_id, user_id, user_context))


def load_context_events(
    db_path: Path, since: str | None = None
) -> list[tuple[str, str, str]]:
    """(event_type, user_context, product_id) rows for retraining: feedback
    events joined to the server-side request-context store."""
    flush_request_contexts()  # read-your-writes vs the async context writer
    conn = sqlite3.connect(db_path)
    try:
        sql = (
            "SELECT e.event_type, c.user_context, e.product_id "
            "FROM feedback_events e JOIN request_contexts c USING (request_id)"
        )
        params: tuple = ()
        if since:
            sql += " WHERE e.created_at >= ?"
            params = (since,)
        return [(str(a), str(b), str(c)) for a, b, c in conn.execute(sql, params)]
    finally:
        conn.close()
