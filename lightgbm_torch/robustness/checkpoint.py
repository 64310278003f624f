"""Atomic file writes: the port's copy of ``atomic_open`` and
``atomic_write_text`` of ``lightgbm_tpu/robustness/checkpoint.py:98-150``.
A writer streams into a tmp file in the destination's directory, which on a
clean exit is fsynced and ``os.replace``d onto the destination, so a crash
mid-write never leaves a partial file there (``Dataset.save_binary``,
``CVBooster.save_model``).  Checkpoints themselves are not ported yet."""
from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def atomic_open(path: str, mode: str = "w", **open_kw):
    """Open a same-directory tmp file for writing; on a clean ``with`` exit
    it is fsynced and ``os.replace``d onto ``path``, on an exception it is
    unlinked.  Truncating-write modes only: an append or update mode would
    start from an empty tmp file and ``os.replace`` would discard what is
    at ``path``."""
    if "a" in mode or "+" in mode or "r" in mode:
        raise ValueError(
            f"atomic_open mode {mode!r} unsupported: the tmp file starts "
            "empty, so append/update modes would truncate the destination; "
            "use 'w'/'wb'/'x'/'xb'")
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, f".{os.path.basename(path)}.tmp.{os.getpid()}")
    try:
        with open(tmp, mode, **open_kw) as fh:
            yield fh
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass


def atomic_write_text(path: str, text: str) -> None:
    """``text`` as UTF-8 at ``path``, through ``atomic_open``."""
    with atomic_open(path, "wb") as fh:
        fh.write(text.encode("utf-8"))
