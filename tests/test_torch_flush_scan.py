"""The port's flush scan (plain version, on the CPU) against the JAX
package's ``flush_scan``, bit for bit.

Inputs are made from a seed with numpy and go through both packages; the
outputs are flags and popcounts, so the tolerance is 0. The JAX side
runs its jnp reference (``impl="ref"``) and its Pallas kernel
``flush_scan_blocked`` in interpret mode (``impl="pallas"``, which pads
the block count to a whole tile and slices it off again) across the
dtype × geometry sweep.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flush_scan import flush_scan as jax_flush_scan
from repro_torch.kernels import dirty_blocks, flush_pack, flush_scan, popcount_blocks
from test_torch_kernels import DTYPES, GEOMETRIES, dirtied, ints, rand, signed_zero_and_nan, tt

JAX_IMPLS = ["ref", "pallas"]


@pytest.mark.parametrize("jax_impl", JAX_IMPLS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block_bytes,n", GEOMETRIES)
def test_flush_scan_matches_jax(dtype, block_bytes, n, jax_impl):
    rng = np.random.default_rng(5 * block_bytes + n)
    snap = rand(rng, (n,), dtype)
    cur = dirtied(rng, snap, [2, n // 2, n - 1])
    want_flags, want_counts = jax_flush_scan(
        jnp.asarray(cur), jnp.asarray(snap), block_bytes=block_bytes,
        impl=jax_impl)
    flags, counts = flush_scan(tt(cur), tt(snap), block_bytes=block_bytes)
    assert flags.dtype == counts.dtype == torch.int32
    np.testing.assert_array_equal(ints(flags), ints(want_flags))
    np.testing.assert_array_equal(ints(counts), ints(want_counts))
    assert int(flags.sum()) >= 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_flush_scan_is_dirty_blocks_plus_popcounts(dtype):
    """One pass equals the two staged kernels composed, and flush_pack's
    flags and counts."""
    rng = np.random.default_rng(7)
    snap = rand(rng, (5000,), dtype)
    cur = dirtied(rng, snap, [123, 4999])
    flags, counts = flush_scan(tt(cur), tt(snap))
    fp = flush_pack(tt(cur), tt(snap))
    for want in (dirty_blocks(tt(cur), tt(snap)), fp.flags):
        np.testing.assert_array_equal(ints(flags), ints(want))
    for want in (popcount_blocks(tt(cur)), fp.counts):
        np.testing.assert_array_equal(ints(counts), ints(want))


def test_flush_scan_pads_nothing():
    """The reference pads the block count to a tile of 8; the port
    returns exactly one entry per block (here 3)."""
    x = torch.arange(3 * 1024, dtype=torch.float32)
    flags, counts = flush_scan(x, x.clone())
    assert flags.shape == counts.shape == (3,)
    assert not flags.any()


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16, np.float16])
@pytest.mark.parametrize("jax_impl", JAX_IMPLS)
def test_flush_scan_float_flags_match_jax(dtype, jax_impl):
    """±0 compare equal and NaN differs from itself, as in the JAX
    package's value compare."""
    cur, snap, want = signed_zero_and_nan(dtype)
    jflags, jcounts = jax_flush_scan(jnp.asarray(cur), jnp.asarray(snap),
                                     impl=jax_impl)
    flags, counts = flush_scan(tt(cur), tt(snap))
    np.testing.assert_array_equal(ints(flags), want)
    np.testing.assert_array_equal(ints(flags), ints(jflags))
    np.testing.assert_array_equal(ints(counts), ints(jcounts))


def test_cpu_tensors_take_the_plain_version():
    x = torch.arange(4096, dtype=torch.int32)
    before = flush_scan.launches
    for impl in ("auto", "fused", "pallas", "ref"):
        flush_scan(x, x, impl=impl)
    assert flush_scan.launches == before
    with pytest.raises(ValueError):
        flush_scan(x, x, impl="cuda")
    with pytest.raises(ValueError):
        flush_scan(x, x[:100])
