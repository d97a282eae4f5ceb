"""Two-level file IO with explicit flush/fence and crash injection (the
port's own copy of ``repro.persistence.manifest``: the bytes it writes,
and the crash images it leaves, are the same).

:class:`StagedIO` is the paper's two-level memory at file granularity:
writes land in a volatile staging area (page cache), ``flush`` marks a
file, ``fence`` moves all marked files to durable storage, and
``publish`` is the atomic rename -- the pointer swing (the CAS of the
critical phase).  A crash loses the staging area, except for a chosen
subset of staged files that may have been "evicted" to disk whole or, in
the ``torn`` mode, torn.

:class:`Manifest` is one link of the checkpoint chain: its ``prev`` field
is the parent pointer, and its publish (the rename of
``step_XXXXXXXX/MANIFEST.json``) commits the step.  A step directory
without a committed manifest is a marked-but-disconnected node that
recovery trims.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
from pathlib import Path
from typing import Dict, Iterable, Optional

import numpy as np

from ..core.pmem import evicted_mask


def _torn_payload(data: bytes, rng) -> bytes:
    """One torn image of ``data``: a strict prefix, tail either gone
    (short write) or bitwise-inverted in place (garbled sectors).  Never
    equal to ``data`` for non-empty payloads — the cut is strictly
    inside — so a "torn" eviction is guaranteed to actually tear."""
    if len(data) == 0:
        return data
    cut = int(rng.integers(0, len(data)))
    if int(rng.integers(0, 2)):
        return data[:cut] + bytes(255 - b for b in data[cut:])
    return data[:cut]


@dataclasses.dataclass
class IOCounters:
    writes: int = 0
    bytes_staged: int = 0
    flushes: int = 0
    fences: int = 0
    bytes_fenced: int = 0

    def snapshot(self):
        return dataclasses.asdict(self)


class StagedIO:
    """Two-level file IO with explicit flush/fence and crash injection."""

    def __init__(self, root: Path, seed: int = 0):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._staged: Dict[str, bytes] = {}
        self._flushed: set = set()
        self.counters = IOCounters()
        self._rng = np.random.default_rng(seed)
        # optional repro.robustness.faultinject.CrashPlan: when set,
        # every persistence instruction (flush/fence/publish/trim)
        # reports a crash site before executing (attach via
        # CrashPlan.attach, never set directly).  Recorders that
        # additionally define ``on_event`` (repro.analysis.trace.
        # PersistTrace) receive the full stream, writes included.
        self.faults = None

    def _event(self, kind: str, target: str = "", **meta) -> None:
        """Report one executed instruction to an attached trace recorder."""
        cb = getattr(self.faults, "on_event", None) if self.faults else None
        if cb is not None:
            cb(kind, target, **meta)

    # -- volatile writes -------------------------------------------------- #
    def write(self, rel: str, data: bytes) -> None:
        self._staged[rel] = data
        self.counters.writes += 1
        self.counters.bytes_staged += len(data)
        if self.faults is not None:
            self._event("write", rel)

    def flush(self, rel: str) -> None:
        if rel in self._staged:
            if self.faults is not None:
                self.faults.on_site("flush", rel)
                self._event("flush", rel)
            self._flushed.add(rel)
            self.counters.flushes += 1

    def fence(self) -> None:
        if self.faults is not None:
            self.faults.on_site("fence", "")
            self._event("fence")
        self.counters.fences += 1
        for rel in sorted(self._flushed):
            data = self._staged.pop(rel, None)
            if data is None:
                continue
            path = self.root / rel
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_bytes(data)
            self.counters.bytes_fenced += len(data)
        self._flushed.clear()

    # -- the publish CAS --------------------------------------------------- #
    def publish(self, tmp_rel: str, final_rel: str) -> None:
        """Atomic rename of a durable file — the pointer swing.  The tmp
        file must already be fenced."""
        if self.faults is not None:
            self.faults.on_site("publish", final_rel)
            self._event("publish", final_rel, src=tmp_rel)
        os.replace(self.root / tmp_rel, self.root / final_rel)

    # -- crash adversary --------------------------------------------------- #
    def crash(self, evict: str = "none", p_evict: float = 0.5) -> None:
        """Lose the staging area; a chosen subset of staged-but-unfenced
        files may still have reached disk (background eviction).  The
        eviction policy is the shared seedable adversary
        (:func:`repro_torch.core.pmem.evicted_mask`) applied over staged
        files in sorted order, so DRAM-line and file-staging crash
        models agree — and an unknown mode raises instead of silently
        evicting at random.

        ``evict="torn"`` is the partial-write adversary: a random
        subset reaches disk **torn** — a strict prefix of the payload,
        half the time with the remaining tail bitwise-garbled in place
        instead of truncated — modeling a kill mid-``write(2)``.
        Recovery must treat such a file exactly like a torn record.
        (File-granularity only: the 8-byte-atomic ``PMem`` model keeps
        rejecting the mode, partial cache lines do not exist there.)"""
        staged = sorted(self._staged)
        torn = evict == "torn"
        mask = evicted_mask(len(staged), "random" if torn else evict,
                            self._rng, p_evict)
        for rel, hit in zip(staged, mask):
            if hit:
                data = self._staged[rel]
                if torn:
                    data = _torn_payload(data, self._rng)
                path = self.root / rel
                path.parent.mkdir(parents=True, exist_ok=True)
                path.write_bytes(data)
        self._staged.clear()
        self._flushed.clear()

    # -- durable reads ----------------------------------------------------- #
    def read(self, rel: str) -> bytes:
        return (self.root / rel).read_bytes()

    def exists(self, rel: str) -> bool:
        return (self.root / rel).exists()

    def unlink(self, rel: str) -> None:
        """Remove one durable file (snapshot truncation, journal GC).
        A trim is a crash site too: recovery must tolerate a kill
        between any two unlinks of a truncation pass."""
        if self.faults is not None:
            self.faults.on_site("trim", rel)
            self._event("trim", rel)
        (self.root / rel).unlink(missing_ok=True)

    def remove_tree(self, rel: str) -> None:
        if self.faults is not None:
            self.faults.on_site("trim", rel)
            self._event("trim", rel)
        shutil.rmtree(self.root / rel, ignore_errors=True)


def digest(data: bytes) -> str:
    return hashlib.sha1(data).hexdigest()


@dataclasses.dataclass
class Manifest:
    step: int
    prev: Optional[int]
    files: Dict[str, dict]          # leaf path -> {"file","digest","owner"}
    aux: dict                       # data cursor, rng, ...

    def to_bytes(self) -> bytes:
        return json.dumps(dataclasses.asdict(self), sort_keys=True).encode()

    @staticmethod
    def from_bytes(b: bytes) -> "Manifest":
        d = json.loads(b.decode())
        return Manifest(step=d["step"], prev=d["prev"], files=d["files"],
                        aux=d.get("aux", {}))


def manifest_rel(step: int) -> str:
    return f"step_{step:08d}/MANIFEST.json"


def list_step_dirs(root: Path) -> Iterable[int]:
    for p in sorted(Path(root).glob("step_*")):
        try:
            yield int(p.name.split("_")[1])
        except (IndexError, ValueError):
            continue
