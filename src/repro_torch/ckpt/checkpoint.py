"""Crash-safe checkpoints in the JAX package's on-disk format, numpy only.

Counterpart of ``repro.ckpt.checkpoint``; a checkpoint written by either
package restores in the other. Layout of one step:

* ``step_K/leaf_NNNNN.npy`` — one ``.npy`` file per array leaf, written
  whole (logical, unsharded);
* ``step_K/manifest.json`` — ``{"step": K, "leaves": [{"index", "path",
  "file", "shape", "dtype", "sha256"}, ...]}``.

A tree is a dict, tuple, list or ``NamedTuple`` of trees, ``None`` (no
leaf) or an array leaf (``utils.tree``). Leaves are numbered in
``jax.tree_util``'s flattening order (dict keys sorted, fields in order,
depth first; a ``NamedTuple``'s ``tree_aux`` fields, as ``Q8.last``, are
static data and not leaves) and ``path`` is the leaf's ``keystr``
(``"['ls_blooms']"``, ``"['opt'].m['segments'][0][0]['attn'].wq.q"``), so
the training state of ``launch.train`` checkpoints as the JAX launcher's
does.

* writes go to ``step_K.tmp`` and are published by one atomic
  ``os.rename``, so a crash mid-save never corrupts the latest step;
* async mode hands the host arrays to a writer thread; its error is kept and
  re-raised from ``CheckpointManager.wait()`` (which the next ``save()``
  calls), never swallowed;
* ``keep_last`` garbage-collects old steps.

Recovery: a checksum mismatch, a missing or truncated leaf, or shape/dtype
drift raises :class:`CheckpointCorruptionError`; callers (``Index.load``)
quarantine the bad step (``step_K.quarantined``, never listed or restored)
and fall back to the previous intact one. Stale ``step_K.tmp`` dirs of a
killed writer are removed by :func:`reap_tmp`. Manifests digest with
sha256; md5 manifests of older writers still verify (the digest key names
the algorithm).

Restoring returns numpy arrays, or with ``shardings`` (a tree of
``launch.shardings.NamedSharding`` shaped as the target) tensors placed
on each leaf's sharding: an unsharded checkpoint restores onto any mesh.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np

from repro_torch.utils.tree import tree_flatten_with_path, tree_unflatten

_DIGEST_CHUNK = 1 << 20        # stream checksums in 1 MB chunks


class CheckpointCorruptionError(AssertionError):
    """A checkpoint failed integrity verification (checksum mismatch,
    truncated leaf, or shape/dtype drift). Subclasses AssertionError, like
    the JAX package's."""


@dataclasses.dataclass(frozen=True)
class ArraySpec:
    """A restore target: the shape and dtype a leaf must have."""
    shape: tuple
    dtype: Any


def _leaf_name(i: int) -> str:
    return f"leaf_{i:05d}.npy"


def file_digest(path: str, algo: str = "sha256") -> str:
    """Streaming file digest — constant memory regardless of leaf size."""
    h = hashlib.new(algo)
    with open(path, "rb") as f:
        while chunk := f.read(_DIGEST_CHUNK):
            h.update(chunk)
    return h.hexdigest()


def _flatten(tree) -> list:
    """``[(keystr path, leaf), ...]`` in ``jax.tree_util``'s order."""
    return tree_flatten_with_path(tree)


def _to_host(leaf) -> np.ndarray:
    if hasattr(leaf, "detach"):          # a torch tensor, on any device
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


class _AsyncWriter(threading.Thread):
    """Writer thread that keeps its exception for :meth:`CheckpointManager.
    wait` instead of dying silently."""

    def __init__(self, fn):
        super().__init__(daemon=True)
        self._fn = fn
        self.exc: Optional[BaseException] = None

    def run(self):
        try:
            self._fn()
        except BaseException as e:     # noqa: BLE001 — re-raised in wait()
            self.exc = e


def save(ckpt_dir: str, step: int, tree: Any, async_write: bool = False,
         keep_last: int = 3, injector=None) -> Optional[_AsyncWriter]:
    """Save a tree of arrays (numpy, torch tensors, scalars) as step
    ``step``. Returns the writer thread if async.

    ``injector`` (a ``core.faults.FaultInjector``) makes leaf writes flaky:
    an injected fault truncates the leaf mid-write and raises IOError,
    leaving ``step_K.tmp`` behind like a crashed writer; the published
    checkpoint is untouched either way."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = _flatten(tree)
    names = [p for p, _ in flat]
    host_leaves = [_to_host(leaf) for _, leaf in flat]

    def _write():
        tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
        final = os.path.join(ckpt_dir, f"step_{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": []}
        for i, (arr, name) in enumerate(zip(host_leaves, names)):
            fn = _leaf_name(i)
            fpath = os.path.join(tmp, fn)
            np.save(fpath, arr)
            if injector is not None and injector.ckpt_write_fails(step, i):
                with open(fpath, "r+b") as f:   # truncated mid-write
                    f.truncate(max(0, os.path.getsize(fpath) // 2))
                raise IOError(
                    f"injected write fault: step {step} leaf {i} ({name})")
            manifest["leaves"].append({
                "index": i, "path": name, "file": fn,
                "shape": list(arr.shape), "dtype": str(arr.dtype),
                "sha256": file_digest(fpath)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)                       # atomic publish
        _gc(ckpt_dir, keep_last)

    if async_write:
        th = _AsyncWriter(_write)
        th.start()
        return th
    _write()
    return None


def _gc(ckpt_dir: str, keep_last: int):
    steps = sorted(_list_steps(ckpt_dir))
    for s in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"),
                      ignore_errors=True)


def _list_steps(ckpt_dir: str) -> list:
    """Published, non-quarantined steps only: ``step_<int>`` exactly —
    ``step_K.tmp`` and ``step_K.quarantined`` never list."""
    out = []
    if not os.path.isdir(ckpt_dir):
        return out
    for name in os.listdir(ckpt_dir):
        if not name.startswith("step_"):
            continue
        suffix = name[len("step_"):]
        if suffix.isdigit():
            out.append(int(suffix))
    return out


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _list_steps(ckpt_dir)
    return max(steps) if steps else None


def reap_tmp(ckpt_dir: str) -> list:
    """Delete stale ``step_K.tmp`` dirs left by killed or failed writers
    (publishes are atomic renames, so none is valid across a restart).
    Returns the reaped dir names."""
    reaped = []
    if not os.path.isdir(ckpt_dir):
        return reaped
    for name in sorted(os.listdir(ckpt_dir)):
        if name.startswith("step_") and name.endswith(".tmp"):
            shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)
            reaped.append(name)
    return reaped


def quarantine(ckpt_dir: str, step: int) -> str:
    """Sideline a corrupted step as ``step_K.quarantined`` (kept on disk,
    excluded from listing and restore). Returns the new path."""
    src = os.path.join(ckpt_dir, f"step_{step}")
    dst = src + ".quarantined"
    shutil.rmtree(dst, ignore_errors=True)
    os.rename(src, dst)
    return dst


def _verify_leaf(path: str, meta: dict, leaf_path: str):
    """Integrity-check one leaf file against its manifest entry."""
    if not os.path.exists(path):
        raise CheckpointCorruptionError(f"{leaf_path}: leaf file missing")
    for algo in ("sha256", "md5"):      # md5: manifests of older writers
        if algo in meta:
            if file_digest(path, algo) != meta[algo]:
                raise CheckpointCorruptionError(
                    f"checksum mismatch for {leaf_path}")
            return
    raise CheckpointCorruptionError(f"{leaf_path}: manifest carries no "
                                    "digest")


def restore(ckpt_dir: str, step: int, target_tree: Any,
            shardings: Any = None, verify: bool = True) -> Any:
    """Restore step ``step`` into the structure of ``target_tree``, whose
    leaves carry ``.shape`` and ``.dtype`` (numpy arrays or
    :class:`ArraySpec`). Returns numpy arrays; with ``shardings`` (same
    structure, leaves with a ``place`` method: ``NamedSharding``) each
    leaf is checked against its sharding and placed on its device as a
    tensor. Integrity failures (missing or truncated leaf, checksum
    mismatch, shape or dtype drift) raise
    :class:`CheckpointCorruptionError`."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    manifest_fn = os.path.join(path, "manifest.json")
    if not os.path.exists(manifest_fn):
        raise CheckpointCorruptionError(
            f"step {step}: manifest.json missing (truncated checkpoint?)")
    with open(manifest_fn) as f:
        manifest = json.load(f)
    targets = [leaf for _, leaf in _flatten(target_tree)]
    if len(targets) != len(manifest["leaves"]):
        raise CheckpointCorruptionError(
            f"checkpoint has {len(manifest['leaves'])} leaves, "
            f"target {len(targets)}")
    places = [None] * len(targets) if shardings is None else \
        [leaf for _, leaf in _flatten(shardings)]
    assert len(places) == len(targets), (len(places), len(targets))
    out = []
    for meta, tgt, shd in zip(manifest["leaves"], targets, places):
        fn = os.path.join(path, meta["file"])
        if verify:
            _verify_leaf(fn, meta, meta["path"])
        try:
            arr = np.load(fn)
        except Exception as e:          # unreadable/truncated npy payload
            raise CheckpointCorruptionError(
                f"{meta['path']}: unreadable leaf ({e})") from e
        if list(arr.shape) != list(tgt.shape):
            raise CheckpointCorruptionError(
                f"{meta['path']}: shape {arr.shape} vs target {tgt.shape}")
        if np.dtype(arr.dtype) != np.dtype(tgt.dtype):
            raise CheckpointCorruptionError(
                f"{meta['path']}: dtype {arr.dtype} vs target {tgt.dtype}")
        out.append(arr if shd is None else shd.place(arr))
    return tree_unflatten(target_tree, out)


class CheckpointManager:
    """Async save + resume. An async writer's exception is kept
    (``_AsyncWriter``) and re-raised from :meth:`wait`, which the next
    :meth:`save` calls first."""

    def __init__(self, ckpt_dir: str, keep_last: int = 3,
                 async_write: bool = True):
        self.ckpt_dir = ckpt_dir
        self.keep_last = keep_last
        self.async_write = async_write
        self._pending: Optional[_AsyncWriter] = None

    def save(self, step: int, tree: Any, injector=None):
        self.wait()
        self._pending = save(self.ckpt_dir, step, tree,
                             async_write=self.async_write,
                             keep_last=self.keep_last, injector=injector)

    def wait(self):
        """Join the in-flight writer; re-raise its error if it failed."""
        if self._pending is not None:
            th, self._pending = self._pending, None
            th.join()
            if th.exc is not None:
                raise th.exc

    def latest(self) -> Optional[int]:
        return latest_step(self.ckpt_dir)

    def restore(self, target_tree, shardings=None, step=None):
        step = step if step is not None else self.latest()
        assert step is not None, f"no checkpoint in {self.ckpt_dir}"
        return step, restore(self.ckpt_dir, step, target_tree, shardings)
