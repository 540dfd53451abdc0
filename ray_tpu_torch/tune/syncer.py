"""Experiment-directory syncing.

Parity with ``python/ray/tune/syncer.py``: a ``SyncConfig`` names an
``upload_dir`` URI; a ``Syncer`` mirrors the experiment directory there
periodically and at experiment end, so results/checkpoints survive the
driver host. The reference ships cloud syncers behind pyarrow's fs; this
environment has no egress, so the built-in syncer handles ``file://`` /
plain paths (NFS-style durable storage) and custom ``Syncer`` subclasses
plug in anything else.
"""

from __future__ import annotations

import os
import shutil
import time
from dataclasses import dataclass
from typing import Optional


class Syncer:
    """Mirror a local directory to remote storage (one-way, newest wins)."""

    def sync_up(self, local_dir: str, remote_dir: str) -> bool:
        raise NotImplementedError

    def sync_down(self, remote_dir: str, local_dir: str) -> bool:
        raise NotImplementedError


class _LocalMirrorSyncer(Syncer):
    """rsync-style incremental copy for file:// / plain-path targets:
    only files whose (size, mtime) changed are rewritten, so periodic
    syncs of a mostly-static experiment dir are cheap. With
    ``prune_stale`` (the default) the mirror also DELETES entries absent
    from the source — rolled-back or renamed trial checkpoints must not
    accumulate in the durable copy forever."""

    def __init__(self, prune_stale: bool = True):
        self.prune_stale = prune_stale

    @staticmethod
    def _strip(uri: str) -> str:
        return uri[len("file://"):] if uri.startswith("file://") else uri

    def _mirror(self, src: str, dst: str) -> bool:
        if not os.path.isdir(src):
            return False
        os.makedirs(dst, exist_ok=True)
        seen_dirs, seen_files = {"."}, set()
        for root, _dirs, files in os.walk(src):
            rel = os.path.relpath(root, src)
            seen_dirs.add(rel)
            troot = os.path.join(dst, rel) if rel != "." else dst
            os.makedirs(troot, exist_ok=True)
            for name in files:
                seen_files.add(os.path.normpath(os.path.join(rel, name)))
                s = os.path.join(root, name)
                d = os.path.join(troot, name)
                try:
                    st = os.stat(s)
                    if os.path.exists(d):
                        dt = os.stat(d)
                        if (dt.st_size == st.st_size
                                and dt.st_mtime >= st.st_mtime):
                            continue
                    shutil.copy2(s, d)
                except OSError:
                    return False
        if self.prune_stale:
            self._prune(dst, seen_dirs, seen_files)
        return True

    @staticmethod
    def _prune(dst: str, seen_dirs, seen_files) -> None:
        for root, dirs, files in os.walk(dst, topdown=True):
            rel = os.path.relpath(root, dst)
            stale_dirs = [d for d in dirs
                          if os.path.normpath(os.path.join(rel, d))
                          not in seen_dirs]
            for d in stale_dirs:
                shutil.rmtree(os.path.join(root, d), ignore_errors=True)
                dirs.remove(d)  # pruned subtree: don't descend
            for name in files:
                if os.path.normpath(os.path.join(rel, name)) in seen_files:
                    continue
                try:
                    os.unlink(os.path.join(root, name))
                except OSError:
                    pass  # raylint: allow(swallow) best-effort cleanup; next sync retries

    def sync_up(self, local_dir: str, remote_dir: str) -> bool:
        return self._mirror(local_dir, self._strip(remote_dir))

    def sync_down(self, remote_dir: str, local_dir: str) -> bool:
        return self._mirror(self._strip(remote_dir), local_dir)


@dataclass
class SyncConfig:
    """Reference ``tune/syncer.py:SyncConfig``."""

    upload_dir: Optional[str] = None
    syncer: Optional[Syncer] = None
    sync_period: float = 300.0
    # delete mirror entries absent from the source (stale checkpoints of
    # rolled-back/renamed trials); off = pure-additive mirroring
    prune_stale: bool = True

    def get_syncer(self) -> Optional[Syncer]:
        if not self.upload_dir:
            return None
        if self.syncer is not None:
            return self.syncer
        if (self.upload_dir.startswith("file://")
                or "://" not in self.upload_dir):
            return _LocalMirrorSyncer(prune_stale=self.prune_stale)
        raise ValueError(
            f"no syncer for {self.upload_dir!r}: schemes other than "
            "file:// need an explicit SyncConfig(syncer=...) (no cloud "
            "egress in this runtime)")


class _SyncerState:
    """Runner-side driver of one experiment's syncing."""

    def __init__(self, sync_config: Optional[SyncConfig],
                 experiment_dir: str, experiment_name: str):
        self.cfg = sync_config
        self.syncer = sync_config.get_syncer() if sync_config else None
        self.local = experiment_dir
        self.remote = (os.path.join(sync_config.upload_dir, experiment_name)
                       if self.syncer else "")
        self._last = 0.0
        self._warned = False

    def maybe_sync(self, force: bool = False) -> bool:
        if self.syncer is None:
            return False
        now = time.monotonic()
        if not force and now - self._last < self.cfg.sync_period:
            return False
        self._last = now
        ok = self.syncer.sync_up(self.local, self.remote)
        if not ok:
            # Every failure is loud (a driver crash between now and the
            # end of the run means the durable mirror is stale), but
            # repeats of the SAME broken target only log once.
            import logging
            if not self._warned:
                self._warned = True
                logging.getLogger("ray_tpu").warning(
                    "experiment sync to %s FAILED — the durable mirror "
                    "is missing or partial (further failures for this "
                    "run are silenced)", self.remote)
        else:
            self._warned = False
        return ok
