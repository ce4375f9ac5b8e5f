"""Delta pack/apply: gather blocks of a flat buffer into a dense delta,
and scatter a delta back onto a buffer in place (the staged save and
restore chains' copies)."""

from repro_torch.kernels.delta_pack.ops import (  # noqa: F401
    apply_delta,
    pack_delta,
    pack_dirty,
)
