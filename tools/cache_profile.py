#!/usr/bin/env python3
"""Profile the serving tier's ``HotRowCache.lookup`` on the host alone.

    PYTHONPATH=src python3 tools/cache_profile.py [BATCHES] [BATCH]

A 16,384-row cache over the 26 CriteoTB fields (d = 64), warmed on 64
batches of 256 zipf-1.05 requests as ``chip_smoke.py`` phase (f) warms
it, then ``lookup`` of BATCHES (20) distinct batches of BATCH (512) ids
under ``cProfile``.  The backend is a stub returning zero rows, so the
numbers are the cache's own host work (sketch, admission, eviction, the
hit walk), without any gather; they are CPU numbers of the machine that
runs the script, not a device measurement.
"""

import cProfile
import pstats
import sys
import time

import numpy as np

from repro_torch.configs.recsys_archs import CRITEO_TB_VOCABS
from repro_torch.data import CtrDataConfig, CtrStream, RequestStream
from repro_torch.nn.embeddings import EmbeddingSpec
from repro_torch.serve.hot_cache import HotRowCache


class StubBackend:
    name = "stub"
    affected_rows = None

    def cacheable_rows(self, params, spec, field, ids):
        return np.zeros((len(ids), spec.dim), np.float32)


def main(n_batches: int = 20, batch: int = 512) -> None:
    spec = EmbeddingSpec(vocab_sizes=CRITEO_TB_VOCABS, dim=64, kind="full")
    cache = HotRowCache(StubBackend(), spec, None, capacity=16384)
    cache.warm(RequestStream(CtrDataConfig(
        vocab_sizes=CRITEO_TB_VOCABS, n_dense=13, batch_size=256,
        zipf_exponent=1.05, seed=7)).id_batches(64, start_step=10_000))
    stream = CtrStream(CtrDataConfig(vocab_sizes=CRITEO_TB_VOCABS,
                                     n_dense=13, batch_size=batch,
                                     zipf_exponent=1.05, seed=7))
    ids = [stream.batch_at(20_000 + k)["sparse"] for k in range(n_batches)]
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    for b in ids:
        cache.lookup(b)
    prof.disable()
    ms = (time.perf_counter() - t0) / n_batches * 1e3
    print(f"lookup: {ms:.1f} ms a batch of {batch} under cProfile; "
          f"{cache.stats()}")
    pstats.Stats(prof).sort_stats("tottime").print_stats(8)


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:3]))
