"""Durable atomic file writes: tempfile + fsync + rename, once.

Extracted from the tuning cache's save path so every JSON artifact writer
in the repo — tuning cache, checkpoint manifest/commit marker, trace and
metrics savers, bench artifacts — shares one audited implementation
instead of five ad-hoc ones.  A reader racing any of these sees either
the old file or the new file, never a torn write; a crash between write
and publish leaves the old file intact.

The full durability recipe, in order:

1. ``mkstemp`` in the **target's own directory** — same filesystem, so
   the final rename is atomic (a cross-device rename silently degrades
   to copy+delete).
2. write + flush.
3. ``os.fsync(fd)`` — the bytes reach the disk *before* the rename
   publishes them (the fsync-before-rename audit: without it, a crash
   after the rename can expose an empty file under the final name).
4. ``os.replace`` — atomic publication.
5. fsync the directory — the rename itself survives a crash.

This module is stdlib-only on purpose: ``observability.trace`` (which
deliberately imports neither jax nor numpy) adopts it too.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Callable, Optional


def fsync_dir(path: str) -> None:
    """Best-effort fsync of a directory (persists renames within it)."""

    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # platforms/filesystems that refuse O_RDONLY on dirs
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_text(
    path: str,
    text: str,
    *,
    prefix: str = ".tmp-",
    suffix: str = "",
    durable: bool = True,
) -> str:
    """Atomically publish ``text`` at ``path``; returns ``path``.

    ``durable=False`` skips the fsyncs (atomicity without the disk
    barrier) for callers where a post-crash loss of the *newest* version
    is acceptable as long as no torn file is ever visible.
    """

    path = os.path.abspath(path)
    d = os.path.dirname(path)
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=prefix, suffix=suffix)
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
            f.flush()
            if durable:
                os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    if durable:
        fsync_dir(d)
    return path


def atomic_write_json(
    path: str,
    payload: Any,
    *,
    indent: int = 1,
    sort_keys: bool = True,
    default: Optional[Callable[[Any], Any]] = None,
    newline: bool = True,
    prefix: str = ".tmp-",
    durable: bool = True,
) -> str:
    """Atomically publish ``payload`` as JSON at ``path``; returns ``path``."""

    text = json.dumps(payload, indent=indent, sort_keys=sort_keys, default=default)
    if newline:
        text += "\n"
    return atomic_write_text(
        path, text, prefix=prefix, suffix=".json", durable=durable
    )


__all__ = ["atomic_write_json", "atomic_write_text", "fsync_dir"]
