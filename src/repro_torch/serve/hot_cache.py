"""Frequency-sketch hot-row cache for fetch-bound embedding substrates
(PyTorch port of ``repro.serve.hot_cache``: a numpy copy, with the same
sketch hashes, admission order and eviction ties).

Criteo-style traffic is heavily skewed — a few hot rows, a huge cold tail
(exactly what ``data/synthetic_ctr.py`` generates) — and a streaming
count-min sketch is the right primitive for exploiting that skew in front
of exact tables.  This module is the serving-side half of that idea:

* ``CountMinSketch`` — a depth×width counter array with splitmix-style
  row hashes; ``update`` streams the request ids through, ``estimate``
  answers (over-)counts.  Memory is fixed regardless of vocab size.
* ``HotRowCache`` — a fixed-capacity host-side store of *exact* embedding
  rows keyed by global row id (per-field offset + id, so fields never
  collide).  Misses gather through the backend's ``cacheable_rows`` hook
  — the same rows the device lookup would produce, bit for bit — so a
  cached score is bit-exact against the uncached path; eviction keeps the
  rows the sketch says are hottest.  A batch's misses are fetched one
  field at a time (one ``cacheable_rows`` call, so one device gather and
  one copy to the host, for each field that misses), in the JAX
  package's order: the insertion order of the store decides eviction
  ties.

Which substrates opt in is the backends' call via the optional
``cacheable_rows`` protocol hook (class attribute ``None`` on the base):
``full`` and ``hashed`` implement it — they are fetch-bound, and fronting
them with a hot-row store is how production DLRM serves a 100GB table.
``robe``, ``qrobe`` and ``tt`` decline: the robe array is already
cache-resident, which is the paper's point — declining keeps the
full-vs-robe serving comparison honest (the cache accelerates the
*baseline*, not the paper's substrate).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

__all__ = ["CountMinSketch", "HotRowCache"]


_MIX1 = np.uint64(0x9E3779B97F4A7C15)
_MIX2 = np.uint64(0xBF58476D1CE4E5B9)


class CountMinSketch:
    """Streaming frequency estimates in O(depth × width) fixed memory.

    ``estimate`` never undercounts (each row is an independent hash; the
    minimum over rows bounds the collision inflation).  ``width`` rounds
    up to a power of two so the hash reduces with a mask.
    """

    def __init__(self, width: int = 1 << 16, depth: int = 4, seed: int = 0):
        w = 1
        while w < width:
            w *= 2
        self.width, self.depth = w, depth
        self._mask = np.uint64(w - 1)
        rs = np.random.RandomState(seed)
        # odd 64-bit multipliers + independent offsets per row
        self._a = (rs.randint(1, 2 ** 63, depth).astype(np.uint64)
                   | np.uint64(1))
        self._b = rs.randint(0, 2 ** 63, depth).astype(np.uint64)
        self._t = np.zeros((depth, w), np.int64)
        self.total = 0

    def _slots(self, keys: np.ndarray) -> np.ndarray:
        """[depth, n] table columns for int64/uint64 ``keys``."""
        with np.errstate(over="ignore"):            # wraparound intended
            h = (keys.astype(np.uint64)[None, :] * self._a[:, None]
                 + self._b[:, None])
            h ^= h >> np.uint64(29)
            h *= _MIX2
            h ^= h >> np.uint64(32)
        return (h & self._mask).astype(np.int64)

    def update(self, keys: np.ndarray) -> None:
        keys = np.asarray(keys).ravel()
        if keys.size == 0:
            return
        cols = self._slots(keys)
        for d in range(self.depth):
            np.add.at(self._t[d], cols[d], 1)
        self.total += int(keys.size)

    def estimate(self, keys: np.ndarray) -> np.ndarray:
        """Per-key estimated counts (shape of ``keys``; never undercounts)."""
        keys = np.asarray(keys)
        flat = keys.ravel()
        if flat.size == 0:
            return np.zeros(keys.shape, np.int64)
        cols = self._slots(flat)
        est = self._t[np.arange(self.depth)[:, None], cols].min(axis=0)
        return est.reshape(keys.shape)


class HotRowCache:
    """Fixed-capacity exact-row cache fronting a fetch-bound backend.

    ``lookup(idx, n_valid)`` answers the padded ``[B, F]`` id batch with
    the ``[B, F, dim]`` float32 rows the backend's own gather would
    produce (bit-exact: hits come from rows previously produced by
    ``backend.cacheable_rows``, misses from a fresh call to it).  Only the
    first ``n_valid`` rows feed the frequency sketch and the hit-rate
    accounting — the padded tail must never distort the heat map.

    Admission/eviction: every miss with sketch count ≥ ``admit_threshold``
    is admitted; when the store exceeds ``capacity`` it prunes to the
    ``capacity`` keys the sketch currently ranks hottest.  The store
    therefore converges onto the head of the skew, which is the whole
    hit-rate criterion (see the ``CtrStream`` skew property test).
    """

    def __init__(self, backend, spec, params, *, capacity: int = 16384,
                 sketch_width: int = 1 << 16, sketch_depth: int = 4,
                 admit_threshold: int = 1, seed: int = 0):
        if backend.cacheable_rows is None:
            raise ValueError(
                f"backend {backend.name!r} declines the hot-row cache "
                f"(cacheable_rows is None); use HotRowCache.for_backend")
        self.backend, self.spec, self.params = backend, spec, params
        self.capacity = int(capacity)
        self.admit_threshold = int(admit_threshold)
        self._sketch_seed = seed
        self.sketch = CountMinSketch(sketch_width, sketch_depth, seed)
        self._rows: Dict[int, np.ndarray] = {}
        self._offsets = spec.offsets.astype(np.int64)     # per-field
        self.hits = 0
        self.misses = 0

    @staticmethod
    def for_backend(backend, spec, params, **kw) -> Optional["HotRowCache"]:
        """Build a cache, or None when the backend declines (robe/tt)."""
        if backend.cacheable_rows is None:
            return None
        return HotRowCache(backend, spec, params, **kw)

    # -- the serve path ----------------------------------------------------

    def lookup(self, idx: np.ndarray,
               n_valid: Optional[int] = None) -> np.ndarray:
        """idx [B, F] int ids -> [B, F, dim] float32 rows (bit-exact).

        Rows ``>= n_valid`` are padding: gathered (the compiled shape
        downstream needs them) but never counted.
        """
        idx = np.asarray(idx, np.int64)
        b, f = idx.shape
        n_valid = b if n_valid is None else int(n_valid)
        gids = idx + self._offsets[None, :f]
        self.sketch.update(gids[:n_valid])
        out = np.empty((b, f, self.spec.dim), np.float32)
        for field in range(f):
            uniq, inv = np.unique(idx[:, field], return_inverse=True)
            guniq = uniq + self._offsets[field]
            rows = np.empty((uniq.size, self.spec.dim), np.float32)
            cached = np.fromiter((int(g) in self._rows for g in guniq),
                                 bool, count=guniq.size)
            for i in np.flatnonzero(cached):
                rows[i] = self._rows[int(guniq[i])]
            miss_ix = np.flatnonzero(~cached)
            if miss_ix.size:
                fetched = np.asarray(self.backend.cacheable_rows(
                    self.params, self.spec, field, uniq[miss_ix]),
                    np.float32)
                rows[miss_ix] = fetched
                self._admit(guniq[miss_ix], fetched)
            out[:, field] = rows[inv]
            # per-occurrence accounting over the real rows only
            occ = inv[:n_valid]
            nh = int(cached[occ].sum())
            self.hits += nh
            self.misses += occ.size - nh
        if len(self._rows) > self.capacity:
            self._prune()
        return out

    # -- admission / eviction ----------------------------------------------

    def _admit(self, gids: np.ndarray, rows: np.ndarray) -> None:
        est = self.sketch.estimate(gids)
        for g, r, e in zip(gids, rows, est):
            if e >= self.admit_threshold:
                self._rows[int(g)] = r

    def _prune(self) -> None:
        keys = np.fromiter(self._rows.keys(), np.int64,
                           count=len(self._rows))
        est = self.sketch.estimate(keys)
        keep = keys[np.argpartition(-est, self.capacity - 1)
                    [:self.capacity]]
        self._rows = {int(k): self._rows[int(k)] for k in keep}

    # -- model push / invalidation ------------------------------------------

    def set_params(self, params) -> None:
        """Re-point at freshly pushed parameters.  Always paired with
        ``invalidate``/``clear`` — surviving entries are only valid because
        the push contract says their rows are bit-identical under the new
        params (delta manifest: untouched rows never moved)."""
        self.params = params

    def clear(self) -> int:
        """Drop every resident row (a full-snapshot push, where no delta
        manifest bounds what changed).  Sketch heat survives — the hot set
        is a property of the *traffic*, not of the parameters — so the
        store re-converges in one warm pass.  Returns rows dropped."""
        n = len(self._rows)
        self._rows.clear()
        return n

    def invalidate(self, field: int, ids) -> int:
        """Drop the resident rows of ``field`` that a push's touched-id set
        invalidates; untouched entries survive (and stay bit-exact, per the
        delta contract).  Exact id match by default; a backend whose stored
        rows are shared across ids widens the set via its ``affected_rows``
        hook (``hashed``: quotient/remainder bucket-mates).  Returns rows
        dropped."""
        ids = np.asarray(list(ids) if not isinstance(ids, np.ndarray)
                         else ids, np.int64).ravel()
        if ids.size == 0 or not self._rows:
            return 0
        resident = np.fromiter(self._rows.keys(), np.int64,
                               count=len(self._rows))
        lo = int(self._offsets[field])
        hi = lo + int(self.spec.vocab_sizes[field])
        cand = resident[(resident >= lo) & (resident < hi)] - lo
        if cand.size == 0:
            return 0
        if self.backend.affected_rows is not None:
            mask = self.backend.affected_rows(self.spec, field, ids, cand)
        else:
            mask = np.isin(cand, ids)
        dropped = cand[mask] + lo
        for g in dropped:
            del self._rows[int(g)]
        return int(dropped.size)

    def invalidate_manifest(self, touched: Dict) -> int:
        """Apply a delta manifest's touched map ({field: ids}; JSON string
        keys accepted).  Returns total rows dropped."""
        return sum(self.invalidate(int(f), ids)
                   for f, ids in (touched or {}).items())

    # -- bookkeeping --------------------------------------------------------

    def reset(self) -> None:
        """Full reset to the cold-start state: drop the resident store AND
        the sketch heat (plus hit/miss counters), keeping only the
        configuration (capacity, admit threshold, sketch geometry/seed,
        backend/params binding).  ``clear`` deliberately preserves sketch
        heat because a model push does not change the *traffic*; a
        benchmark grid moving to a different traffic distribution must
        reset both, or the previous cell's heat leaks into the next cell's
        admission decisions (and its resident rows into the hit rate)."""
        self._rows.clear()
        self.sketch = CountMinSketch(self.sketch.width, self.sketch.depth,
                                     self._sketch_seed)
        self.reset_stats()

    def warm(self, id_batches) -> None:
        """Pre-heat sketch + store from prior traffic (e.g. the request
        log's recent window) so a replay measures steady state, not the
        cold start.  ``id_batches``: iterable of [B, F] id arrays."""
        for ids in id_batches:
            self.lookup(np.asarray(ids))
        self.reset_stats()

    def reset_stats(self) -> None:
        self.hits = 0
        self.misses = 0

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "hit_rate": round(self.hit_rate, 4),
                "resident_rows": len(self._rows),
                "capacity": self.capacity,
                "sketch_total": self.sketch.total}
