"""Model-state serving: checkpoint shards paged through the tiers.

The ROADMAP's paged-KV exemplar scenario: the parameters of one
``repro_torch.configs`` model, laid out shard-by-shard (embedding table +
one shard per transformer layer) over a *tiered* page region whose
PMem slot budget holds only a fraction of the pages — the rest live on
the SSD spill tier and fault in through the shared DRAM buffer
manager on access. A serving process that pages model state (adapter
swaps, expert offload, cold checkpoint restore) sees exactly this
stack: DRAM hit ≪ PMem fill ≪ SSD fill, with k-touch admission
deciding which shards earn PMem residency.

Shard sizes are *analytic* — ``ModelConfig.param_count()`` at
``bytes_per_param`` (bf16 = 2) split into an embedding shard
(``vocab_size × d_model`` params) plus equal per-layer shards — so no
tensor framework is imported; page contents are deterministic from
``(seed, pid)`` and verifiable after any crash/spill/promotion
history.
"""

from __future__ import annotations

from typing import List, Tuple, Union

import numpy as np

__all__ = ["ModelStateStore"]

_MAP_CAPACITY = 1 << 17


class ModelStateStore:
    """Shard-addressed paged storage for one model's parameters.

    Shard 0 is the embedding table; shards ``1..num_layers`` are the
    transformer layers. Each shard occupies a contiguous page run of
    the region; :meth:`read_shard` faults its pages through the pool's
    shared cache (so repeated reads of a hot shard hit DRAM, cold
    shards pay the SSD rung — the serving latency ladder)."""

    def __init__(self, pool, config: Union[str, object], *,
                 name: str = "ms", page_size: int = 4096,
                 slot_frac: float = 0.25, bytes_per_param: int = 2,
                 seed: int = 0, flush_lanes: int = 4) -> None:
        """Lay out + populate the shard pages on ``pool``.

        Args:
            pool: host pool; must have an SSD attached when
                ``slot_frac < 1`` (the spill tier backs the overcommit).
            config: a :class:`~repro_torch.models.config.ModelConfig` or a
                name resolved via ``repro_torch.configs.get_reduced``.
            name: region-name prefix (keep short; 20-byte cap).
            page_size: bytes per page.
            slot_frac: fraction of pages that get PMem slots (the rest
                spill; 1.0 = untiered).
            bytes_per_param: checkpoint precision (2 = bf16).
            seed: page-content seed (deterministic, verifiable).
            flush_lanes: lanes of the populate write-back epochs.
        """
        if isinstance(config, str):
            from repro_torch.configs import get_reduced
            config = get_reduced(config)
        self.config = config
        self.page_size = int(page_size)
        embed_params = config.vocab_size * config.d_model
        total_params = config.param_count()
        layer_params = max(0, total_params - embed_params)
        per_layer = layer_params // config.num_layers
        sizes = [embed_params * bytes_per_param]
        for li in range(config.num_layers):
            p = per_layer + (layer_params % config.num_layers
                             if li == config.num_layers - 1 else 0)
            sizes.append(p * bytes_per_param)
        #: (first_pid, npages) per shard, shard 0 = embedding
        self.shards: List[Tuple[int, int]] = []
        pid = 0
        for nbytes in sizes:
            npages = max(1, -(-nbytes // self.page_size))
            self.shards.append((pid, npages))
            pid += npages
        self.npages = pid
        self.nslots = max(1, int(round(self.npages * slot_frac)))
        self.tiered = self.nslots < self.npages
        self.seed = int(seed)
        self.name = name

        from repro_torch.io.flushq import FlushQueue
        pages = pool.pages(f"{name}.pages", npages=self.npages,
                           page_size=self.page_size, nslots=self.nslots)
        self.store = pages.store
        self._spill = None
        if self.tiered:
            from repro_torch.tier import SpillScheduler
            if pool.ssd_dev is None:
                raise ValueError(
                    f"model-state store {name!r}: slot_frac={slot_frac} "
                    f"overcommits {self.npages} pages onto {self.nslots} "
                    f"slots; attach a flash device first (pool.attach_ssd)")
            self._spill = SpillScheduler(pool, name=f"{name}.sp",
                                         map_capacity=_MAP_CAPACITY)
            self._spill.attach_pages(pages)
        self._fq = FlushQueue(self.store, lanes=flush_lanes,
                              spill=self._spill)
        self.cache = pool.cache()
        self.cache.attach_pages(pages, flushq=self._fq, spill=self._spill)
        self._populate()

    # ------------------------------------------------------------ layout

    @property
    def num_shards(self) -> int:
        """Embedding + one per layer."""
        return len(self.shards)

    def shard_pages(self, shard: int) -> range:
        """The contiguous pid run holding one shard."""
        first, npages = self.shards[shard]
        return range(first, first + npages)

    def page_content(self, pid: int) -> np.ndarray:
        """The expected (deterministic) content of one page — what
        :meth:`read_shard` must return no matter which tier served it."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, int(pid)]))
        return rng.integers(0, 256, self.page_size, dtype=np.uint8)

    # ---------------------------------------------------------- populate

    def _populate(self) -> None:
        """Write every page through the cache, draining a write-back
        epoch each slot-budget's worth so the populate never needs more
        than ``nslots`` dirty pages in flight; finish by spilling down
        to the slot budget and dropping the (now stale-ordered) frames
        — cold-start: shards fault back in on first access."""
        for pid in range(self.npages):
            self.cache.put(pid, self.page_content(pid), store=self.store)
            if (pid + 1) % self.nslots == 0:
                self.cache.writeback(self.store)
        self.cache.writeback(self.store)
        if self._spill is not None:
            self._spill.ensure_slots(self.store, need=self.nslots)
        self.cache.invalidate(self.store)

    # ------------------------------------------------------------- reads

    def read_shard(self, shard: int) -> np.ndarray:
        """Fault one shard's pages in through the cache and return the
        concatenated bytes (embedding or one layer's parameters)."""
        parts = [self.cache.get(pid, store=self.store)
                 for pid in self.shard_pages(shard)]
        return np.concatenate(parts)

    def verify_shard(self, shard: int) -> bool:
        """Bit-check one shard against its deterministic content."""
        for pid in self.shard_pages(shard):
            got = self.cache.get(pid, store=self.store)
            if not np.array_equal(got, self.page_content(pid)):
                return False
        return True

    def residency(self, pid: int):
        """Which tier holds a page now (``"pmem"``/``"ssd"``/None)."""
        if self._spill is not None:
            return self._spill.residency(self.store, pid)
        return "pmem" if pid in self.store.table else None
