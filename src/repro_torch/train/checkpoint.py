"""Fault-tolerant checkpoints (PyTorch port of ``repro.train.checkpoint``).

The on-disk format is the JAX package's, so each package restores the
other's checkpoints:

* a ``step-%010d`` directory holding ``arrays.npz`` (keys ``leaf_{i}``,
  the tree's leaves in ``repro_torch.tree`` order, which is
  ``jax.tree``'s: dicts by sorted key) and ``manifest.json`` (``step``,
  ``n_leaves``, ``treedef``, ``extra``, and per leaf ``key``, ``shape``,
  ``dtype`` and ``crc32``, the ``zlib.crc32`` of its contiguous bytes);
* **atomicity**: written to ``tmp-<step>``, fsynced, renamed; a crash
  mid-write never corrupts the latest checkpoint, and the next save's GC
  reaps the debris;
* **integrity**: a leaf whose CRC disagrees makes its checkpoint
  unreadable, and restore falls back to the previous one;
* **async**: ``AsyncCheckpointer`` copies the state to the host before
  ``save`` returns (the next step may update the tensors in place) and
  writes on a thread; a write's error is raised by the next ``wait``;
* **retention**: keep-last-k GC;
* **deltas**: ``save_delta``/``restore_delta`` for the online-training
  publish path: a delta stores only the leaves whose bytes changed since
  the previous publish (past an optional threshold) and a manifest of
  touched embedding rows ({field: row ids}); restore walks the
  ``base_step`` chain back to a full snapshot.

Where the packages differ:

* ``None`` is a leaf of ``repro_torch.tree`` but an empty subtree to
  ``jax.tree``: leaves are numbered without the ``None`` ones, and restore
  puts ``None`` back wherever the template holds it.
* ``treedef`` is a structure string of this package's own; neither
  package's loader reads the other's.
* numpy has no bfloat16: a bf16 leaf is stored as its ``uint16`` bits
  with ``"dtype": "bfloat16"``, so its CRC covers the same bytes as the
  JAX package's; ``uint16`` or raw two-byte (``|V2``, what ``np.load``
  makes of the JAX package's bf16) data is read back as bf16.
* restored leaves are tensors on the template leaf's device, with its
  dtype (the 0-d int32 ``step`` too), where the JAX package returns host
  numpy arrays.

Under a ``repro_torch.dist`` context the format stays the JAX package's:
**global** arrays.  ``save`` (and ``AsyncCheckpointer.save``) gathers
each sharded leaf by its ``shardings`` (a collective: every rank calls
it), rank 0 of the mesh writes, and every rank passes a barrier after
the write (``AsyncCheckpointer``: in the next ``wait``), so a later
restore on any rank reads the finished files and only one process ever
renames a ``tmp-*`` directory.  The barrier carries the write's outcome:
a failed write raises on every rank.  Restoring with ``shardings`` (a tree of
``dist.api.Sharding``, as ``dist.api.named_shardings`` builds) cuts each
global leaf to the rank's shard; ``restore_onto`` first prunes a spec
tree against the checkpoint's global shapes and the (possibly degraded)
mesh.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.dist import api as dist
from repro_torch.dist import collectives as coll
from repro_torch.tree import leaves, leaves_up_to, unflatten

_BF16 = "bfloat16"


def _structure(tree) -> str:
    """The tree's containers with ``*`` at each leaf (``None`` stays
    ``None``), dicts in sorted key order: this package's ``treedef``."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_structure(v) for v in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner},)"
    return "None" if tree is None else "*"


def _flatten(tree) -> Tuple[list, str]:
    """The non-``None`` leaves, in order, and the structure string."""
    return [x for x in leaves(tree) if x is not None], _structure(tree)


def _host(leaf) -> Tuple[np.ndarray, str]:
    """A host copy of ``leaf`` as numpy (a bf16 tensor as its uint16
    bits) and the dtype name the manifest records."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        arr = t.numpy()
    else:
        arr = np.array(leaf)
    return arr, str(arr.dtype)


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def _snapshot(tree, shardings=None) -> list:
    """[(host array, dtype name)] of the tree's non-``None`` leaves, each
    sharded leaf gathered whole by its sharding."""
    if shardings is not None:
        sh = _flat_shardings(tree, shardings)
        tree = unflatten(tree, [x if (x is None or s is None) else
                                s.gather(x)
                                for x, s in zip(leaves(tree), sh)])
    return [_host(x) for x in _flatten(tree)[0]]


def _flat_shardings(tree, shardings) -> list:
    """The sharding of each leaf of ``tree`` (None: whole)."""
    flat = leaves(tree)
    try:
        sh = leaves_up_to(tree, shardings)
    except ValueError as e:
        raise ValueError(f"shardings tree is not congruent with the state "
                         f"({e}): it would cut the wrong leaves") from None
    if len(sh) != len(flat):
        raise ValueError(f"shardings tree has {len(sh)} leaves, state has "
                         f"{len(flat)}")
    return sh


def _writer(shardings):
    """(the context whose rank 0 writes, whether this rank writes)."""
    ctx = dist.current()
    if shardings is not None:
        for s in leaves(shardings):
            if s is not None:
                ctx = s.ctx
                break
    if ctx is None:
        return None, True
    return ctx, ctx.index(ctx.mesh.axis_names) == 0


def _write(tmp: str, final: str, manifest: dict, arrays: dict) -> None:
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)


def _fresh_dir(path: str) -> None:
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)


def _save_snapshot(ckpt_dir: str, step: int, snap: list, structure: str,
                   extra: Optional[dict], keep_last: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp-{step}")
    final = os.path.join(ckpt_dir, f"step-{step:010d}")
    _fresh_dir(tmp)
    manifest = {"step": step, "n_leaves": len(snap), "treedef": structure,
                "extra": extra or {}, "leaves": []}
    arrays = {}
    for i, (arr, dtype) in enumerate(snap):
        key = f"leaf_{i}"
        arrays[key] = arr
        manifest["leaves"].append({"key": key, "shape": list(arr.shape),
                                   "dtype": dtype, "crc32": _crc(arr)})
    _write(tmp, final, manifest, arrays)
    _gc(ckpt_dir, keep_last)
    return final


def save(ckpt_dir: str, step: int, tree, extra: Optional[dict] = None,
         keep_last: int = 3, shardings=None) -> str:
    """Synchronous atomic checkpoint of ``tree`` (tensors, on any device,
    or numpy arrays). Returns the final path.  Under a mesh, the leaves
    are gathered by ``shardings`` (None: every leaf whole on every rank),
    rank 0 writes, and every rank waits for the write."""
    ctx, writes = _writer(shardings)
    snap = _snapshot(tree, shardings)
    final = os.path.join(ckpt_dir, f"step-{step:010d}")
    err = None
    if writes:
        try:
            final = _save_snapshot(ckpt_dir, step, snap, _structure(tree),
                                   extra, keep_last)
        except Exception as e:
            err = e
    if ctx is not None:
        err = coll.agree_failure(err, ctx)
    if err is not None:
        raise err
    return final


class AsyncCheckpointer:
    """Snapshot synchronously, write on a background thread."""

    def __init__(self, ckpt_dir: str, keep_last: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None
        self._ctx = None
        self.last_error: Optional[BaseException] = None

    def save(self, step: int, tree, extra: Optional[dict] = None,
             shardings=None) -> None:
        """Copy ``tree`` to the host now (a synchronous device-to-host
        copy, so the next step may update the tensors in place; under a
        mesh, the gather of the sharded leaves by ``shardings``, a
        collective, on the calling thread), then write it on a thread (on
        rank 0 of the mesh only)."""
        self.wait()
        self._ctx, writes = _writer(shardings)
        snap, structure = _snapshot(tree, shardings), _structure(tree)
        if not writes:
            return

        def work():
            try:
                _save_snapshot(self.ckpt_dir, step, snap, structure, extra,
                               self.keep_last)
            except BaseException as e:       # surfaced on the next wait()
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the write and raise its error; under a mesh every rank
        then passes a barrier (so no rank reads a checkpoint before it is
        renamed) that carries the writer's outcome, so that a failed write
        raises on every rank, not on rank 0 alone."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self.last_error = self.last_error, None
        if self._ctx is not None:
            ctx, self._ctx = self._ctx, None
            err = coll.agree_failure(err, ctx)
        if err is not None:
            raise err


def _gc(ckpt_dir: str, keep_last: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step-"))
    for d in steps[:-keep_last] if keep_last else []:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
    # stale tmp-* dirs are crashed half-writes (killed between the write
    # and the rename); saves are serialised, so anything here is dead
    for d in os.listdir(ckpt_dir):
        if d.startswith("tmp-"):
            shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def _checked(data, path: str, meta: dict) -> np.ndarray:
    arr = data[meta["key"]]
    if _crc(arr) != meta["crc32"]:
        raise IOError(f"checksum mismatch in {path}:{meta['key']}")
    return arr


def _to_tensor(arr: np.ndarray, dtype: str, like,
               sharding=None) -> torch.Tensor:
    """A stored leaf as a tensor on ``like``'s device with its dtype (a
    template leaf that is no tensor: on the CPU, in the stored dtype);
    with a ``sharding``, the rank's shard of it (the template may hold
    another mesh's shards: its shape is not checked)."""
    if dtype == _BF16 or arr.dtype.kind == "V":
        if arr.dtype.itemsize != 2:
            raise IOError(f"a bfloat16 leaf stored as {arr.dtype}")
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                             ).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    if sharding is not None:
        t = sharding.cut(t)
    if isinstance(like, torch.Tensor):
        if sharding is None and tuple(t.shape) != tuple(like.shape):
            raise IOError(f"a leaf of shape {tuple(t.shape)} where the "
                          f"template has {tuple(like.shape)}")
        t = t.to(device=like.device, dtype=like.dtype)
    return t


def _rebuild(template, arrays: list, dtypes: list,
             shardings=None) -> Any:
    """``template``'s structure with the stored leaves in place of its
    non-``None`` leaves (``None`` stays ``None``), cut by ``shardings``."""
    flat = leaves(template)
    sh = ([None] * len(flat) if shardings is None
          else _flat_shardings(template, shardings))
    live = [(x, s) for x, s in zip(flat, sh) if x is not None]
    if len(live) != len(arrays):
        raise IOError(f"{len(arrays)} stored leaves, the template has "
                      f"{len(live)}")
    it = iter(zip(arrays, dtypes, live))

    def one():
        arr, dtype, (like, s) = next(it)
        return _to_tensor(arr, dtype, like, s)

    return unflatten(template, [None if x is None else one() for x in flat])


def _read_leaves(path: str) -> Tuple[list, list, dict]:
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        arrays = [_checked(data, path, meta) for meta in manifest["leaves"]]
    return arrays, [m["dtype"] for m in manifest["leaves"]], manifest


def _verify_and_load(path: str, template,
                     shardings=None) -> Tuple[Any, dict]:
    arrays, dtypes, manifest = _read_leaves(path)
    if callable(shardings):
        shardings = shardings(manifest)
    return _rebuild(template, arrays, dtypes, shardings), manifest


def restore_latest(ckpt_dir: str, template, shardings=None,
                   step: Optional[int] = None) -> Optional[Tuple[Any, dict]]:
    """Restore the newest valid checkpoint (skipping corrupted ones) into
    ``template``'s structure: (tree, manifest), or None when there is none.

    ``step``: pin a specific snapshot instead of the newest.
    ``shardings``: a tree of ``dist.api.Sharding`` (or None leaves: whole)
    congruent with ``template``; each global leaf is cut to the rank's
    shard (the elastic resume onto a mesh).
    """
    if shardings is not None and not callable(shardings):
        _flat_shardings(template, shardings)      # raises when not congruent
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted((d for d in os.listdir(ckpt_dir)
                    if d.startswith("step-")), reverse=True)
    if step is not None:
        steps = [d for d in steps if d == f"step-{step:010d}"]
    for d in steps:
        try:
            return _verify_and_load(os.path.join(ckpt_dir, d), template,
                                    shardings)
        except Exception:
            continue                         # corrupted -> try the previous
    return None


def _manifest_shapes(manifest: dict, template):
    """The checkpoint's global leaf shapes in ``template``'s structure."""
    shapes = iter(dist.Shape(tuple(m["shape"])) for m in manifest["leaves"])
    return unflatten(template, [None if x is None else next(shapes)
                                for x in leaves(template)])


def restore_onto(ckpt_dir: str, template, ctx, spec_tree,
                 step: Optional[int] = None) -> Optional[Tuple[Any, dict]]:
    """Elastic resume: restore the newest checkpoint onto ``ctx``'s mesh.

    ``spec_tree`` is the ``P`` tree for ``template`` under the new
    context's rules.  The specs are first re-resolved against the mesh and
    the checkpoint's global shapes (``dist.api.prune_specs``: axes the
    mesh no longer carries or no longer divides fall back to replicated),
    then every leaf is cut to the rank's shard.
    """
    def shardings(manifest):
        specs = dist.prune_specs(spec_tree,
                                 _manifest_shapes(manifest, template),
                                 ctx.mesh)
        return dist.named_shardings(ctx, specs)

    return restore_latest(ckpt_dir, template, shardings=shardings, step=step)


# ---------------------------------------------------------------------------
# Delta checkpoints (online-training publish path)
# ---------------------------------------------------------------------------

def _as_float(arr: np.ndarray, dtype: str) -> np.ndarray:
    if dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).float().numpy()
    return arr


def _leaf_changed(a: np.ndarray, b: np.ndarray, threshold: float,
                  dtype: str = "", base_dtype: str = "") -> bool:
    """Did the leaf's bytes change past ``threshold``?  ``threshold`` is a
    max-abs bound, read only for float leaves; 0.0 means any byte change.
    ``dtype``/``base_dtype`` name the manifest dtypes (bf16 arrives as its
    uint16 bits)."""
    if a.shape != b.shape or a.dtype != b.dtype or dtype != base_dtype:
        return True
    a, b = _as_float(a, dtype), _as_float(b, base_dtype)
    if threshold > 0.0 and np.issubdtype(a.dtype, np.floating):
        if a.size == 0:
            return False
        return bool(np.max(np.abs(a.astype(np.float64)
                                  - b.astype(np.float64))) > threshold)
    return not np.array_equal(a, b)


def save_delta(ckpt_dir: str, step: int, tree, base_tree, base_step: int,
               threshold: float = 0.0,
               touched: Optional[dict] = None) -> str:
    """Atomic delta checkpoint: only the leaves that changed since
    ``base_tree``, the previously published tree (full or delta) at
    ``base_step``; ``restore_delta`` walks the ``base_step`` links back to
    a full ``save`` snapshot and re-applies each delta's changed leaves.

    ``touched``: ``{field index: iterable of row ids}``, the rows training
    could have moved since ``base_step``, which the serving tier
    invalidates on a push (exact only under an optimizer that leaves a
    zero-gradient row bit for bit: plain SGD or adagrad).

    Writing a delta GCs the deltas older than the newest full snapshot.
    """
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp-delta-{step}")
    final = os.path.join(ckpt_dir, f"delta-{step:010d}")
    _fresh_dir(tmp)
    flat, structure = _flatten(tree)
    base_flat, base_structure = _flatten(base_tree)
    if structure != base_structure:
        raise ValueError("delta tree structure differs from base tree")
    manifest = {"step": step, "base_step": base_step, "delta": True,
                "threshold": threshold, "n_leaves": len(flat),
                "treedef": structure,
                "touched": {str(k): sorted(int(i) for i in np.ravel(list(v)))
                            for k, v in (touched or {}).items()},
                "leaves": []}
    arrays = {}
    for i, (leaf, base) in enumerate(zip(flat, base_flat)):
        (arr, dtype), (barr, bdtype) = _host(leaf), _host(base)
        meta = {"key": f"leaf_{i}", "shape": list(arr.shape), "dtype": dtype,
                "changed": _leaf_changed(arr, barr, threshold, dtype,
                                         bdtype)}
        if meta["changed"]:
            arrays[meta["key"]] = arr
            meta["crc32"] = _crc(arr)
        manifest["leaves"].append(meta)
    _write(tmp, final, manifest, arrays)
    _gc_deltas(ckpt_dir)
    return final


def _gc_deltas(ckpt_dir: str) -> None:
    fulls = [int(d[5:]) for d in os.listdir(ckpt_dir)
             if d.startswith("step-")]
    newest_full = max(fulls) if fulls else None
    for d in os.listdir(ckpt_dir):
        if d.startswith("tmp-"):
            shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
        elif (d.startswith("delta-") and newest_full is not None
              and int(d[6:]) < newest_full):
            shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def _list_snapshots(ckpt_dir: str) -> list:
    """[(step, kind, dirname)] oldest to newest; a full snapshot sorts
    after a delta of the same step (it is the preferred restore source)."""
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step-"):
            out.append((int(d[5:]), "full", d))
        elif d.startswith("delta-"):
            out.append((int(d[6:]), "delta", d))
    return sorted(out, key=lambda t: (t[0], t[1] == "full"))


def _load_manifest(path: str) -> dict:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def _apply_delta(arrays: list, dtypes: list, path: str,
                 manifest: dict) -> Tuple[list, list]:
    out, out_dt = list(arrays), list(dtypes)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for i, meta in enumerate(manifest["leaves"]):
            if meta["changed"]:
                out[i] = _checked(data, path, meta)
                out_dt[i] = meta["dtype"]
    return out, out_dt


def _restore_chain(ckpt_dir: str, path: str, template,
                   shardings=None) -> Tuple[Any, dict]:
    """A delta at ``path``: walk its ``base_step`` links down to a full
    snapshot, then apply the deltas oldest to newest."""
    chain = [(path, _load_manifest(path))]
    while True:
        b = int(chain[-1][1]["base_step"])
        full_d = os.path.join(ckpt_dir, f"step-{b:010d}")
        delta_d = os.path.join(ckpt_dir, f"delta-{b:010d}")
        if os.path.isdir(full_d):
            base_path, base_full_step = full_d, b
            break
        if not os.path.isdir(delta_d):
            raise IOError(f"delta chain broken at step {b}")
        chain.append((delta_d, _load_manifest(delta_d)))
    arrays, dtypes, _ = _read_leaves(base_path)
    merged: dict = {}
    chain_meta = []
    for dpath, dman in reversed(chain):          # oldest -> newest
        if dman["n_leaves"] != len(arrays):
            raise IOError(f"leaf count mismatch in {dpath}")
        arrays, dtypes = _apply_delta(arrays, dtypes, dpath, dman)
        for fld, ids in dman.get("touched", {}).items():
            merged.setdefault(fld, set()).update(ids)
        chain_meta.append({"step": dman["step"],
                           "base_step": dman["base_step"],
                           "touched": dman.get("touched", {})})
    tree = _rebuild(template, arrays, dtypes, shardings)
    manifest = dict(chain[0][1], chain=chain_meta,
                    touched={k: sorted(v) for k, v in merged.items()},
                    base_full_step=base_full_step)
    return tree, manifest


def restore_delta(ckpt_dir: str, template, step: Optional[int] = None,
                  shardings=None) -> Optional[Tuple[Any, dict]]:
    """Restore the newest publish (a full snapshot or a delta chain), as
    ``restore_latest`` but delta-aware.

    The returned manifest is the requested snapshot's, with the merged
    invalidation view of the applied chain:

    * ``"chain"``: [{"step", "base_step", "touched"}] oldest to newest;
    * ``"touched"``: the per-field union of the chain's touched row ids;
    * ``"base_full_step"``: the full snapshot the chain starts from.

    Unreadable candidates (a bad CRC, a broken chain) are skipped, falling
    back to the next-newest snapshot, as ``restore_latest`` does.
    ``shardings``: as ``restore_latest``'s.
    """
    if shardings is not None:
        _flat_shardings(template, shardings)      # raises when not congruent
    if not os.path.isdir(ckpt_dir):
        return None
    snaps = _list_snapshots(ckpt_dir)[::-1]          # newest first
    if step is not None:
        snaps = [s for s in snaps if s[0] == step]
    for snap_step, kind, d in snaps:
        path = os.path.join(ckpt_dir, d)
        try:
            if kind == "full":
                tree, manifest = _verify_and_load(path, template, shardings)
                return tree, dict(manifest, delta=False, chain=[],
                                  touched=manifest.get("touched", {}),
                                  base_full_step=snap_step)
            return _restore_chain(ckpt_dir, path, template, shardings)
        except Exception:
            continue                     # corrupted or broken -> previous
    return None
