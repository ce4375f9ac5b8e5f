"""``repro_torch.cache`` — the DRAM buffer manager over the three-tier read path.

The paper's Fig. 3 ladder (DRAM ≪ PMem ≪ flash) says *where data is
cached* dominates read cost; Wu et al. (arXiv:2005.07658) confirm it
end-to-end for Optane DBMSs. This package adds the ladder's top rung to
the stack:

- :class:`BufferManager` — a bounded pool of DRAM frames fronting a
  pool's page regions: clock (second-chance) eviction preferring clean
  frames, dirty-frame write-back routed through the owning
  :class:`~repro_torch.io.flushq.FlushQueue` (durability semantics
  unchanged), pin/unpin so a spill epoch can never evict a frame
  mid-flush, and a k-touch admission policy replacing the spill tier's
  promote-on-first-access.
- :class:`CacheStats` — exact per-tier hit/miss counts, converted to
  modeled time by ``costmodel.PMemCostModel.readpath_time_ns`` (and
  folded into ``engine_time_ns(..., cache=...)``) with the DRAM
  constants of the Fig. 3 ladder.

Construct one per pool with ``pool.cache(frames=, admit_k=)`` (cached,
like ``pool.placer()``) and register page regions with
:meth:`BufferManager.attach_pages`. The cache is volatile by
construction: crash recovery is bit-identical with the cache enabled,
disabled, or sized to zero (``tests/test_crash_corpus.py``).
"""

from repro_torch.cache.bufmgr import BufferManager, CacheStats  # noqa: F401
