"""NVTraverse-style checkpoint manager with the Izraelevitz-style baseline
(port of ``repro.persistence.checkpoint``).

Commit protocol for ``save(step, tree, aux)``:

  1. *node initialization*: write each changed leaf to the step dir and
     flush it (no fence yet);
  2. *makePersistent / delta*: only leaves whose digest differs from the
     parent manifest are written at all; unchanged leaves reference the
     parent's file;
  3. *ensureReachable*: the manifest, whose ``prev`` pointer links this
     step into the recoverable chain, is written and flushed;
  4. **one fence**, then the atomic manifest rename (the publish CAS).

``policy="izraelevitz"`` fences after every single write instead, the
general-transform baseline the paper compares against.

Recovery (:meth:`CheckpointManager.recover`) is ``disconnect(root)``:
every step directory that no valid committed manifest commits or
delta-references is trimmed, and liveness is a membership probe on the
durable map (:func:`repro_torch.persistence.index.live_step_index`).

A tree is a nested dict (or list) of tensors or numpy arrays.  Leaf names
are the reference's pytree paths (dict keys in sorted order, list
indices, joined by ``/``), and each leaf is stored as ``np.save`` bytes,
so a checkpoint directory written by either package is byte-identical
and recovers in the other.  A bfloat16 leaf is written as the
reference writes it (``'descr': '<V2'``, the raw 16-bit payload) and
restored as ``torch.bfloat16`` from ``tree_like``'s dtype.
"""
from __future__ import annotations

import io
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..core.batched import resolve_device
from .index import MembershipIndex, live_step_index
from .manifest import (Manifest, StagedIO, digest, list_step_dirs,
                       manifest_rel)

# the header np.save writes for a 2-byte unsigned view, and the one the
# reference writes for bfloat16 (ml_dtypes' dtype descr): same length,
# so the header's padding is unchanged
_U2_DESCR = b"'descr': '<u2'"
_BF16_DESCR = b"'descr': '<V2'"


def _paths(tree, prefix=()):
    """``(path, leaf)`` pairs in the reference's pytree order: dict keys
    sorted, list and tuple entries in order; ``None`` is an empty node."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (str(i),))
    elif tree is not None:
        yield "/".join(prefix), tree


def _unflatten(tree, leaves: Dict[str, object], prefix=()):
    """``tree``'s structure with each leaf replaced by ``leaves[path]``."""
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_unflatten(v, leaves, prefix + (str(i),))
               for i, v in enumerate(tree)]
        return type(tree)(out)
    return None if tree is None else leaves["/".join(prefix)]


def _flatten(tree) -> Dict[str, object]:
    return dict(_paths(tree))


def _leaf_bytes(leaf) -> bytes:
    """``np.save`` bytes of one leaf, as the reference writes them."""
    buf = io.BytesIO()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            np.save(buf, t.view(torch.int16).numpy().view(np.uint16),
                    allow_pickle=False)
            # patch the descr in the header, in place (no copy of the data)
            view = buf.getbuffer()
            i = bytes(view[:256]).index(_U2_DESCR)
            view[i:i + len(_BF16_DESCR)] = _BF16_DESCR
            del view
            return buf.getvalue()
        leaf = t.numpy()
    np.save(buf, np.asarray(leaf), allow_pickle=False)
    return buf.getvalue()


def _leaf_from_bytes(b: bytes, like, device) -> torch.Tensor:
    """One stored leaf as a tensor on ``device``; a 2-byte void payload
    is bfloat16 when ``like`` is."""
    arr = np.load(io.BytesIO(b), allow_pickle=False)
    if not arr.flags.writeable:
        arr = arr.copy()
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        if not (isinstance(like, torch.Tensor)
                and like.dtype == torch.bfloat16):
            raise TypeError(f"2-byte void leaf restored into {like!r}")
        t = torch.from_numpy(arr.view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


class CheckpointManager:
    def __init__(self, root, *, policy: str = "nvtraverse", seed: int = 0,
                 faults=None, device=None):
        """``faults`` (optional) attaches a
        :class:`repro_torch.robustness.faultinject.CrashPlan` to the
        manager's IO, so every flush/fence/publish/trim of save()/gc() is
        an enumerable crash site.  ``device`` (``None`` = the card) holds
        the live-step index and receives restored trees."""
        if policy not in ("nvtraverse", "izraelevitz"):
            raise ValueError(f"unknown policy {policy!r}")
        self.device = resolve_device(device)
        self.io = StagedIO(Path(root), seed=seed)
        if faults is not None:
            faults.attach(self.io)
        self.policy = policy
        self._last_manifest: Optional[Manifest] = None
        # live-step membership index, kept current across recover()/gc()
        # passes by mixed add/remove rounds instead of per-pass rebuilds
        self._step_index = MembershipIndex(device=self.device)

    # ------------------------------------------------------------------ #
    def save(self, step: int, tree, aux: Optional[dict] = None,
             *, crash_after: Optional[str] = None) -> Optional[Manifest]:
        """Commit a checkpoint.  ``crash_after`` in {"shards", "manifest",
        None} stops before the fence or before the publish rename."""
        parent = self._last_manifest
        files = {}
        sdir = f"step_{step:08d}"
        for name, leaf in _flatten(tree).items():
            data = _leaf_bytes(leaf)
            d = digest(data)
            if (parent is not None and name in parent.files
                    and parent.files[name]["digest"] == d):
                # unchanged since the parent: reference, don't rewrite
                ref = dict(parent.files[name])
                ref["owner"] = ref.get("owner", parent.step)
                files[name] = ref
                continue
            rel = f"{sdir}/{name.replace('/', '_')}.npy"
            self.io.write(rel, data)
            self.io.flush(rel)
            if self.policy == "izraelevitz":
                self.io.fence()          # fence per write: the baseline
            files[name] = {"file": rel, "digest": d, "owner": step}
        if crash_after == "shards":
            return None
        man = Manifest(step=step, prev=(parent.step if parent else None),
                       files=files, aux=aux or {})
        tmp_rel = f"{sdir}/MANIFEST.tmp"
        self.io.write(tmp_rel, man.to_bytes())
        self.io.flush(tmp_rel)           # ensureReachable: the prev-link
        self.io.fence()                  # THE single fence
        if crash_after == "manifest":
            return None
        self.io.publish(tmp_rel, manifest_rel(step))   # the CAS
        self._last_manifest = man
        return man

    # ------------------------------------------------------------------ #
    def recover(self) -> Optional[Manifest]:
        """disconnect(root): trim every uncommitted step dir, return the
        newest valid committed manifest (head of the recoverable chain).
        A manifest is valid iff every file it references verifies."""
        committed = {}
        for step in list_step_dirs(self.io.root):
            rel = manifest_rel(step)
            if self.io.exists(rel):
                try:
                    committed[step] = Manifest.from_bytes(self.io.read(rel))
                except Exception:
                    continue            # torn manifest: treat as marked
        valid: Dict[int, Manifest] = {}
        for step in sorted(committed):
            man = committed[step]
            if all(self.io.exists(info["file"])
                   and digest(self.io.read(info["file"])) == info["digest"]
                   for info in man.files.values()):
                valid[step] = man
        head = valid[max(valid)] if valid else None
        self._trim_dead(list(valid.values()),
                        list(list_step_dirs(self.io.root)))
        self._last_manifest = head
        return head

    def _trim_dead(self, manifests, candidates) -> None:
        """Remove every candidate step dir that no surviving manifest
        commits or delta-references: a membership probe on the live-step
        index, updated in place by one mixed insert/delete round."""
        keep_files = set()
        for man in manifests:
            keep_files.update(info["file"] for info in man.files.values())
        idx = live_step_index(manifests, keep_files, self._step_index)
        for step, alive in zip(candidates, idx.contains(candidates)):
            if not alive:
                self.io.remove_tree(f"step_{step:08d}")

    # ------------------------------------------------------------------ #
    def restore(self, tree_like, *, device=None):
        """Restore the newest committed checkpoint into ``tree_like``'s
        structure, every leaf a tensor on ``device`` (default: the
        manager's).  Returns ``(manifest, tree)``, or ``(None, None)``."""
        man = self.recover()
        if man is None:
            return None, None
        dev = self.device if device is None else resolve_device(device)
        flat_like = _flatten(tree_like)
        leaves = {name: _leaf_from_bytes(
            self.io.read(man.files[name]["file"]), like, dev)
            for name, like in flat_like.items()}
        return man, _unflatten(tree_like, leaves)

    def gc(self, keep: int = 2) -> None:
        """Drop all but the newest ``keep`` committed checkpoints (never
        breaking delta-references of the survivors)."""
        man = self.recover()
        if man is None:
            return
        steps = sorted(s for s in list_step_dirs(self.io.root)
                       if self.io.exists(manifest_rel(s)))
        manifests = [Manifest.from_bytes(self.io.read(manifest_rel(s)))
                     for s in steps[-keep:]]
        self._trim_dead(manifests, steps[:-keep])
