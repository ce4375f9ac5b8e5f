"""Block/cache-line geometry of PMem (paper §2.2).

The paper's central physical observation: Optane DC PMM internally operates
on 256-byte blocks (4 cache lines) behind a small write-combining buffer,
while the CPU transfer granule stays 64 bytes. Guideline G1: "Algorithms
should no longer be designed to fit data on single cache lines (64 byte) but
on PMem blocks (256 byte)."

On TPU we additionally expose a ``tpu_tile`` geometry: the natural device
block of one float32 (8, 128) VREG tile = 4096 bytes, used by the
delta-checkpoint layer when tracking dirtiness of HBM-resident parameters.
"""

from __future__ import annotations

import dataclasses

CACHE_LINE: int = 64
PMEM_BLOCK: int = 256  # 4 cache lines — Optane internal write granule
TPU_TILE: int = 4096   # (8, 128) f32 tile — TPU-native "block"

LINES_PER_BLOCK: int = PMEM_BLOCK // CACHE_LINE


def align_down(off: int, granule: int) -> int:
    return off - (off % granule)


def align_up(off: int, granule: int) -> int:
    return -(-off // granule) * granule


def line_index(off: int) -> int:
    """Cache line number covering byte offset ``off``."""
    return off // CACHE_LINE


def block_index(off: int) -> int:
    """PMem block number covering byte offset ``off``."""
    return off // PMEM_BLOCK


def lines_covering(off: int, size: int) -> range:
    """All cache-line indices touched by the byte range [off, off+size)."""
    if size <= 0:
        return range(0)
    return range(off // CACHE_LINE, (off + size - 1) // CACHE_LINE + 1)


def blocks_covering(off: int, size: int, block: int = PMEM_BLOCK) -> range:
    if size <= 0:
        return range(0)
    return range(off // block, (off + size - 1) // block + 1)


@dataclasses.dataclass(frozen=True)
class BlockGeometry:
    """Configurable geometry so the same algorithms run in paper mode
    (256 B Optane blocks) and TPU mode (4 KB tiles)."""

    cache_line: int = CACHE_LINE
    block: int = PMEM_BLOCK

    @property
    def lines_per_block(self) -> int:
        return self.block // self.cache_line

    def pad_to_line(self, size: int) -> int:
        return align_up(size, self.cache_line)

    def pad_to_block(self, size: int) -> int:
        return align_up(size, self.block)


PAPER_GEOMETRY = BlockGeometry()
#: Checkpoint-layer geometry: the dirty-tracking unit ("cache line") is one
#: 4 KiB TPU tile (= the Pallas kernels' block), and the device write
#: granule ("block") is 16 KiB — preserving the paper's 4:1 line:block ratio
#: at TPU-native sizes.
TPU_GEOMETRY = BlockGeometry(cache_line=TPU_TILE, block=4 * TPU_TILE)
