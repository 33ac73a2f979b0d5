"""The image library: SQLite catalog + edit store.

Schema-compatible with the reference (reference: state/library.rs:52-124):
the same ``images`` and ``edits`` tables, indexes, and idempotent
ALTER-TABLE migrations, so a catalog written by the reference app opens
here unchanged (and vice versa). Edit parameters are stored as one JSON
row per image, upserted on every change — the edit store *is* the
checkpoint (SURVEY.md §5); selecting an image replays its params.

Departures from the reference, on purpose:
- ``verify_thumbnails`` checks the three tier paths the schema actually
  has; the reference reads a ``thumbnail_path`` column that no CREATE or
  ALTER ever adds (latent legacy bug, reference: state/library.rs:242).
- Paths are injectable (headless batch operation is config-driven);
  defaults mirror the reference's platform dirs
  (reference: state/library.rs:40-48).
- One connection is safe across threads here only via one-Library-per-
  thread, same discipline the reference uses (its rusqlite Connection is
  not Send, reference: main.rs:125-126).
"""

from __future__ import annotations

import os
import sqlite3
import time
from pathlib import Path
from typing import List, Optional

from raweditor_tpu_torch.catalog.data import Image
from raweditor_tpu_torch.params import EditParams

# The reference's import filter (reference: main.rs:1852-1855), plus
# "crw": absent from the reference's own list, but its rawloader decode
# backend supports it (reference: raw/loader.rs:50-54) and so do we.
RAW_EXTENSIONS = (
    "nef", "dng", "cr2", "cr3", "arw", "raf", "orf", "rw2",
    "pef", "srw", "erf", "kdc", "dcr", "mos", "raw", "rwl", "crw",
)

_IMAGE_COLS = (
    "id, filename, path, cache_path_thumb, cache_path_instant, "
    "cache_path_working, COALESCE(file_status, 'exists')"
)


def default_db_path() -> Path:
    base = os.environ.get("XDG_DATA_HOME")
    base = Path(base) if base else Path.home() / ".local" / "share"
    return base / "raw-editor" / "raw_editor.db"


class Library:
    """Catalog database handle."""

    def __init__(self, db_path: Optional[os.PathLike] = None):
        self.db_path = Path(db_path) if db_path else default_db_path()
        self.db_path.parent.mkdir(parents=True, exist_ok=True)
        self.conn = sqlite3.connect(self.db_path)
        self.conn.execute("PRAGMA foreign_keys = ON")
        self._init_schema()

    def close(self) -> None:
        self.conn.close()

    def __enter__(self) -> "Library":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- schema ----------------------------------------------------------
    def _init_schema(self) -> None:
        """Create tables/indexes + idempotent migrations
        (reference: state/library.rs:52-124)."""
        c = self.conn
        c.execute(
            """CREATE TABLE IF NOT EXISTS images (
                id              INTEGER PRIMARY KEY AUTOINCREMENT,
                path            TEXT NOT NULL UNIQUE,
                filename        TEXT NOT NULL,
                width           INTEGER,
                height          INTEGER,
                imported_at     INTEGER NOT NULL,
                cache_status    TEXT DEFAULT 'pending'
            )"""
        )
        c.execute(
            """CREATE TABLE IF NOT EXISTS edits (
                id              INTEGER PRIMARY KEY AUTOINCREMENT,
                image_id        INTEGER NOT NULL,
                settings_json   TEXT NOT NULL,
                FOREIGN KEY(image_id) REFERENCES images(id) ON DELETE CASCADE
            )"""
        )
        c.execute(
            "CREATE INDEX IF NOT EXISTS idx_images_imported_at "
            "ON images(imported_at DESC)"
        )
        c.execute(
            "CREATE INDEX IF NOT EXISTS idx_edits_image_id ON edits(image_id)"
        )
        # Idempotent migrations (ALTERs fail harmlessly when the column
        # exists, reference: state/library.rs:93-112).
        for ddl in (
            "ALTER TABLE images ADD COLUMN cache_path_thumb TEXT",
            "ALTER TABLE images ADD COLUMN cache_path_instant TEXT",
            "ALTER TABLE images ADD COLUMN cache_path_working TEXT",
            "ALTER TABLE images ADD COLUMN file_status TEXT DEFAULT 'exists'",
        ):
            try:
                c.execute(ddl)
            except sqlite3.OperationalError as e:
                # Only the idempotent case is harmless; a locked
                # database here would silently skip the migration and
                # break every _IMAGE_COLS query later.
                if "duplicate column" not in str(e).lower():
                    raise
        c.execute(
            "CREATE INDEX IF NOT EXISTS idx_images_cache_status "
            "ON images(cache_status)"
        )
        # Beyond the reference: ratings/flags live in a side table so
        # the images/edits schema stays byte-compatible with the
        # reference app's database.
        c.execute(
            """CREATE TABLE IF NOT EXISTS ratings (
                image_id    INTEGER PRIMARY KEY,
                rating      INTEGER NOT NULL DEFAULT 0,
                flag        TEXT NOT NULL DEFAULT 'none',
                FOREIGN KEY(image_id) REFERENCES images(id)
                    ON DELETE CASCADE
            )"""
        )
        # Collections (also beyond the reference): named image sets in
        # side tables, same schema-compatibility rationale as ratings.
        c.execute(
            """CREATE TABLE IF NOT EXISTS collections (
                id    INTEGER PRIMARY KEY AUTOINCREMENT,
                name  TEXT NOT NULL UNIQUE
            )"""
        )
        c.execute(
            """CREATE TABLE IF NOT EXISTS collection_images (
                collection_id INTEGER NOT NULL,
                image_id      INTEGER NOT NULL,
                PRIMARY KEY (collection_id, image_id),
                FOREIGN KEY(collection_id) REFERENCES collections(id)
                    ON DELETE CASCADE,
                FOREIGN KEY(image_id) REFERENCES images(id)
                    ON DELETE CASCADE
            )"""
        )
        c.commit()

    # -- image CRUD ------------------------------------------------------
    def image_count(self) -> int:
        return self.conn.execute("SELECT COUNT(*) FROM images").fetchone()[0]

    def import_image(self, path: str, filename: str,
                     commit: bool = True) -> int:
        """Insert one file; returns the new id
        (reference: state/library.rs:148-162). ``commit=False`` lets
        bulk callers batch many inserts into one transaction."""
        cur = self.conn.execute(
            "INSERT INTO images (path, filename, imported_at) "
            "VALUES (?, ?, ?)",
            (path, filename, int(time.time())),
        )
        if commit:
            self.conn.commit()
        return cur.lastrowid

    def import_folder(self, folder: os.PathLike) -> dict:
        """Recursive import of a folder, filtered by RAW_EXTENSIONS,
        duplicates skipped via the UNIQUE path constraint
        (reference: main.rs:1840-1924). One transaction for the whole
        walk (a 10k-file import is one fsync, not 10k), and directory
        symlink cycles are broken by a realpath visited set."""
        imported = skipped = 0
        seen_dirs = set()
        try:
            for root, dirs, files in os.walk(folder, followlinks=True):
                real = os.path.realpath(root)
                if real in seen_dirs:
                    dirs[:] = []  # symlink cycle: don't descend again
                    continue
                seen_dirs.add(real)
                for name in sorted(files):
                    ext = os.path.splitext(name)[1].lstrip(".").lower()
                    if ext not in RAW_EXTENSIONS:
                        continue
                    full = os.path.abspath(os.path.join(root, name))
                    try:
                        self.import_image(full, name, commit=False)
                        imported += 1
                    except sqlite3.IntegrityError:
                        skipped += 1  # already imported
        finally:
            self.conn.commit()
        return {"imported": imported, "skipped": skipped}

    def _rows_to_images(self, rows) -> List[Image]:
        return [Image(*row) for row in rows]

    def get_all_images(self) -> List[Image]:
        """Newest-first listing (reference: state/library.rs:166-189)."""
        rows = self.conn.execute(
            f"SELECT {_IMAGE_COLS} FROM images ORDER BY imported_at DESC"
        ).fetchall()
        return self._rows_to_images(rows)

    def get_image(self, image_id: int) -> Optional[Image]:
        row = self.conn.execute(
            f"SELECT {_IMAGE_COLS} FROM images WHERE id = ?", (image_id,)
        ).fetchone()
        return Image(*row) if row else None

    def get_pending_cache(self, limit: int = 100) -> List[Image]:
        """Images awaiting tier-cache generation
        (reference: state/library.rs:192-218)."""
        rows = self.conn.execute(
            f"SELECT {_IMAGE_COLS} FROM images WHERE cache_status = 'pending' "
            "LIMIT ?",
            (limit,),
        ).fetchall()
        return self._rows_to_images(rows)

    def get_failed_cache(self):
        """(id, path) of quarantined images — the tethered watcher
        retries these when the file changes on disk (beyond the
        reference, which never retries, main.rs:460-464)."""
        return self.conn.execute(
            "SELECT id, path FROM images WHERE cache_status = 'failed'"
        ).fetchall()

    def set_cache_status(self, image_id: int, status: str) -> None:
        """State machine pending → cached / failed; failed images are
        quarantined, not retried (reference: main.rs:460-464)."""
        self.conn.execute(
            "UPDATE images SET cache_status = ? WHERE id = ?",
            (status, image_id),
        )
        self.conn.commit()

    def set_image_cache_paths(
        self, image_id: int, thumb: str, instant: str, working: str
    ) -> None:
        """Record all three tier paths + mark cached
        (reference: state/library.rs:374-391)."""
        self.conn.execute(
            "UPDATE images SET cache_status = 'cached', "
            "cache_path_thumb = ?, cache_path_instant = ?, "
            "cache_path_working = ? WHERE id = ?",
            (thumb, instant, working, image_id),
        )
        self.conn.commit()

    # -- startup self-healing -------------------------------------------
    def verify_cache(self) -> int:
        """Reset images whose cached tier files vanished back to
        'pending' (reference: state/library.rs:240-270, fixed to check
        the tier columns that actually exist)."""
        rows = self.conn.execute(
            "SELECT id, cache_path_thumb, cache_path_instant, "
            "cache_path_working FROM images WHERE cache_status = 'cached'"
        ).fetchall()
        reset = 0
        for image_id, *paths in rows:
            if any(p is None or not os.path.exists(p) for p in paths):
                self.conn.execute(
                    "UPDATE images SET cache_status = 'pending', "
                    "cache_path_thumb = NULL, cache_path_instant = NULL, "
                    "cache_path_working = NULL WHERE id = ?",
                    (image_id,),
                )
                reset += 1
        self.conn.commit()
        return reset

    def verify_files(self) -> int:
        """Mark RAW files missing from disk as 'deleted' tombstones
        (reference: state/library.rs:274-304)."""
        rows = self.conn.execute(
            "SELECT id, path FROM images WHERE file_status = 'exists'"
        ).fetchall()
        deleted = 0
        for image_id, path in rows:
            if not os.path.exists(path):
                self.conn.execute(
                    "UPDATE images SET file_status = 'deleted' WHERE id = ?",
                    (image_id,),
                )
                deleted += 1
        self.conn.commit()
        return deleted

    # -- edit store ------------------------------------------------------
    def save_edit_params(self, image_id: int, params: EditParams,
                         append: bool = False) -> None:
        """Persist edit params. Default: upsert the single edit row per
        image (reference: state/library.rs:310-337 — its README claims
        history persistence but the upsert keeps one row; undo/redo was
        a 'future' note, reference: state/mod.rs:7).

        ``append=True`` keeps history instead: every save adds a row
        (the schema's autoincrement id orders them), enabling
        ``undo``/``edit_history`` — schema-compatible with the
        reference, which always reads the latest row."""
        payload = params.to_json()
        row = None
        if not append:
            row = self.conn.execute(
                "SELECT id FROM edits WHERE image_id = ? "
                "ORDER BY id DESC LIMIT 1",
                (image_id,),
            ).fetchone()
        if row:
            self.conn.execute(
                "UPDATE edits SET settings_json = ? WHERE id = ?",
                (payload, row[0]),
            )
        else:
            self.conn.execute(
                "INSERT INTO edits (image_id, settings_json) VALUES (?, ?)",
                (image_id, payload),
            )
        self.conn.commit()

    def edit_history(self, image_id: int):
        """All stored edit states, oldest first (append-mode history)."""
        rows = self.conn.execute(
            "SELECT settings_json FROM edits WHERE image_id = ? "
            "ORDER BY id ASC",
            (image_id,),
        ).fetchall()
        return [EditParams.from_json(r[0]) for r in rows]

    def undo_edit(self, image_id: int) -> EditParams:
        """Drop the newest history row; returns the now-current params
        (defaults when the history empties)."""
        row = self.conn.execute(
            "SELECT id FROM edits WHERE image_id = ? ORDER BY id DESC LIMIT 1",
            (image_id,),
        ).fetchone()
        if row:
            self.conn.execute("DELETE FROM edits WHERE id = ?", (row[0],))
            self.conn.commit()
        return self.load_edit_params(image_id)

    def load_edit_params(self, image_id: int) -> EditParams:
        """Replay stored params; defaults when never edited
        (reference: state/library.rs:341-351 errors instead — callers
        there treat the error as 'use defaults', we fold that in)."""
        row = self.conn.execute(
            "SELECT settings_json FROM edits WHERE image_id = ? "
            "ORDER BY id DESC LIMIT 1",
            (image_id,),
        ).fetchone()
        return EditParams.from_json(row[0]) if row else EditParams()

    def has_edits(self, image_id: int) -> bool:
        """(reference: state/library.rs:354-361)"""
        n = self.conn.execute(
            "SELECT COUNT(*) FROM edits WHERE image_id = ?", (image_id,)
        ).fetchone()[0]
        return n > 0

    def delete_edits(self, image_id: int) -> None:
        """Reset to unedited (reference: state/library.rs:364-370)."""
        self.conn.execute("DELETE FROM edits WHERE image_id = ?", (image_id,))
        self.conn.commit()

    # -- ratings / flags (beyond the reference) ---------------------------
    FLAGS = ("none", "pick", "reject")

    def set_rating(self, image_id: int, rating: int = None,
                   flag: str = None) -> None:
        """Upsert a 0–5 star rating and/or a pick/reject flag."""
        if rating is not None and not 0 <= int(rating) <= 5:
            raise ValueError("rating must be 0..5")
        if flag is not None and flag not in self.FLAGS:
            raise ValueError(f"flag must be one of {self.FLAGS}")
        if self.get_image(image_id) is None:
            raise ValueError(f"no image {image_id}")
        cur = self.get_rating(image_id)
        new_rating = int(rating) if rating is not None else cur[0]
        new_flag = flag if flag is not None else cur[1]
        self.conn.execute(
            "INSERT INTO ratings (image_id, rating, flag) VALUES (?,?,?) "
            "ON CONFLICT(image_id) DO UPDATE SET rating=?, flag=?",
            (image_id, new_rating, new_flag, new_rating, new_flag),
        )
        self.conn.commit()

    def get_rating(self, image_id: int):
        """(rating, flag); (0, 'none') when never rated."""
        row = self.conn.execute(
            "SELECT rating, flag FROM ratings WHERE image_id = ?",
            (image_id,),
        ).fetchone()
        return (row[0], row[1]) if row else (0, "none")

    def filter_images(self, min_rating: int = 0,
                      flag: str = None,
                      collection: str = None,
                      search: str = None) -> List[Image]:
        """Catalog listing filtered by rating/flag/collection/text
        (unrated images count as rating 0, flag 'none'; ``search``
        substring-matches filename or path, case-insensitive)."""
        sql = (
            f"SELECT {_IMAGE_COLS} FROM images "
            "LEFT JOIN ratings ON ratings.image_id = images.id "
            "WHERE COALESCE(ratings.rating, 0) >= ? "
            "AND (? IS NULL OR COALESCE(ratings.flag, 'none') = ?) "
        )
        args: list = [min_rating, flag, flag]
        if collection is not None:
            sql += (
                "AND images.id IN (SELECT image_id FROM collection_images "
                "JOIN collections ON collections.id = collection_id "
                "WHERE collections.name = ?) "
            )
            args.append(collection)
        if flag is not None and flag not in self.FLAGS:
            # Same validation as set_rating — a typo'd flag must error,
            # not silently match nothing (code-review r3).
            raise ValueError(f"flag must be one of {self.FLAGS}")
        if search is not None:
            # Escape LIKE metacharacters so the documented substring
            # semantics hold for filenames containing % or _
            # (code-review r3).
            esc = (search.replace("\\", "\\\\")
                   .replace("%", "\\%").replace("_", "\\_"))
            sql += ("AND (images.filename LIKE ? ESCAPE '\\' "
                    "OR images.path LIKE ? ESCAPE '\\') ")
            pat = f"%{esc}%"
            args += [pat, pat]
        sql += "ORDER BY imported_at DESC"
        rows = self.conn.execute(sql, args).fetchall()
        return self._rows_to_images(rows)

    # -- collections (beyond the reference) -------------------------------
    def create_collection(self, name: str) -> int:
        """Create (or return) the named collection; returns its id."""
        if not name or not name.strip():
            raise ValueError("collection name must be non-empty")
        self.conn.execute(
            "INSERT OR IGNORE INTO collections(name) VALUES (?)", (name,)
        )
        self.conn.commit()
        return self.conn.execute(
            "SELECT id FROM collections WHERE name = ?", (name,)
        ).fetchone()[0]

    def delete_collection(self, name: str) -> bool:
        # Membership rows cascade via the FK (PRAGMA foreign_keys=ON
        # at init) — no manual orphan sweep needed.
        cur = self.conn.execute(
            "DELETE FROM collections WHERE name = ?", (name,)
        )
        self.conn.commit()
        return cur.rowcount > 0

    def add_to_collection(self, name: str, image_ids) -> int:
        """Add images to a collection (created if missing); returns the
        number newly added (duplicates are ignored)."""
        # Validate every id BEFORE mutating: a mid-loop raise used to
        # leave a half-applied, uncommitted insert that the next
        # unrelated commit silently persisted (code-review r3).
        ids = [int(i) for i in image_ids]
        for image_id in ids:
            if self.get_image(image_id) is None:
                raise ValueError(f"no image with id {image_id}")
        cid = self.create_collection(name)
        added = 0
        for image_id in ids:
            cur = self.conn.execute(
                "INSERT OR IGNORE INTO collection_images"
                "(collection_id, image_id) VALUES (?, ?)",
                (cid, image_id),
            )
            added += cur.rowcount
        self.conn.commit()
        return added

    def remove_from_collection(self, name: str, image_ids) -> int:
        removed = 0
        for image_id in image_ids:
            cur = self.conn.execute(
                "DELETE FROM collection_images WHERE image_id = ? AND "
                "collection_id = (SELECT id FROM collections "
                "WHERE name = ?)",
                (int(image_id), name),
            )
            removed += cur.rowcount
        self.conn.commit()
        return removed

    def list_collections(self) -> List[tuple]:
        """[(name, image_count)] sorted by name."""
        return [
            (r[0], r[1])
            for r in self.conn.execute(
                "SELECT c.name, COUNT(ci.image_id) FROM collections c "
                "LEFT JOIN collection_images ci ON ci.collection_id = c.id "
                "GROUP BY c.id ORDER BY c.name"
            )
        ]
