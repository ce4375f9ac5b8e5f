"""Hand-written CUDA kernels (``csrc/*.cu``, sm_90a) for the persistence
layer's device work, each with a plain PyTorch version beside it:

  - popcnt_checksum — per-block popcounts (page checksums, full saves)
  - dirty_diff      — per-block dirty flags (the staged save path)
  - flush_pack      — diff + popcount + prefix sum + pack (delta saves)
  - apply_unpack    — verify + scatter + apply (restores)
  - delta_pack      — gather and in-place scatter of blocks (the staged
                      delta chain)
  - flush_scan      — dirty flags + popcounts in one pass

Each subpackage has ``ops.py`` (the wrapper: launches the kernel on a
CUDA tensor, counts its launches, takes the plain version on a CPU
tensor) and ``ref.py`` (the plain version). :mod:`.build` compiles the
sources with ``nvcc`` at first use; importing this package needs neither
``nvcc`` nor a card.
"""

from repro_torch.kernels.apply_unpack import ApplyUnpack, apply_unpack  # noqa: F401
from repro_torch.kernels.delta_pack import apply_delta, pack_delta, pack_dirty  # noqa: F401
from repro_torch.kernels.dirty_diff import dirty_blocks  # noqa: F401
from repro_torch.kernels.flush_pack import FlushPack, flush_pack  # noqa: F401
from repro_torch.kernels.flush_scan import flush_scan  # noqa: F401
from repro_torch.kernels.popcnt_checksum import popcount_blocks, popcount_checksum  # noqa: F401
