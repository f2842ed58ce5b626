"""Background sync of the checkpoint directory to a mirror (counterpart of
``clip_embeds_tpu/core/remote_sync.py``; open_clip's ``remote_sync``, a
child process there, a daemon thread here).

A local or mounted destination is mirrored file by file; ``s3://`` and
``gs://`` go through the ``aws`` / ``gsutil`` command-line tools where they
are installed. :mod:`.checkpoint` writes each file as ``.tmp_*`` and renames
it when it is whole, so a pass skips ``.tmp_*`` names: a pass that runs
during a save never publishes half a checkpoint. A copy lands in the mirror
under a ``.tmp_`` name too and is renamed when whole.
"""

from __future__ import annotations

import logging
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Callable, List, Optional

from .checkpoint import TMP_PREFIX


def _sync_local(src: str, dst: str) -> None:
    os.makedirs(dst, exist_ok=True)
    for root, dirs, files in os.walk(src):
        dirs[:] = [d for d in dirs if not d.startswith(TMP_PREFIX)]
        rel = os.path.relpath(root, src)
        target_dir = os.path.join(dst, rel) if rel != "." else dst
        os.makedirs(target_dir, exist_ok=True)
        for name in files:
            if name.startswith(TMP_PREFIX):
                continue
            s = os.path.join(root, name)
            t = os.path.join(target_dir, name)
            try:
                if os.path.exists(t) and \
                        os.path.getmtime(s) <= os.path.getmtime(t):
                    continue
                fd, tmp = tempfile.mkstemp(dir=target_dir, prefix=TMP_PREFIX)
                os.close(fd)
                try:
                    shutil.copy2(s, tmp)
                    os.replace(tmp, t)
                except BaseException:
                    os.remove(tmp)
                    raise
            except FileNotFoundError:
                continue  # pruned since the walk listed it


def _sync_cli(tool: List[str], src: str, dst: str) -> None:
    subprocess.run([*tool, src, dst], check=True, capture_output=True)


def sync_once(src: str, dst: str) -> bool:
    """One sync pass; True on success, a warning and False on failure."""
    try:
        if dst.startswith("s3://"):
            _sync_cli(["aws", "s3", "sync", "--exclude", f"{TMP_PREFIX}*",
                       "--exclude", f"*/{TMP_PREFIX}*"], src, dst)
        elif dst.startswith("gs://"):
            _sync_cli(["gsutil", "-m", "rsync", "-r", "-x",
                       r"(^|.*/)\.tmp_"], src, dst)
        else:
            _sync_local(src, dst)
        return True
    except Exception as exc:
        logging.warning("remote sync failed: %s", exc)
        return False


class RemoteSync:
    """A pass every ``every_seconds`` on a daemon thread, and a final pass
    on :meth:`stop`. Passes never overlap: the final one waits for a pass
    in flight."""

    def __init__(self, src: str, dst: str, every_seconds: float = 300.0,
                 sync_fn: Optional[Callable[[str, str], bool]] = None):
        self.src = src
        self.dst = dst
        self.every_seconds = every_seconds
        self.sync_fn = sync_fn or sync_once
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    def _pass(self) -> bool:
        with self._lock:
            return self.sync_fn(self.src, self.dst)

    def start(self) -> None:
        def loop():
            while not self._stop.wait(self.every_seconds):
                self._pass()

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self, final_sync: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
        if final_sync:
            self._pass()
