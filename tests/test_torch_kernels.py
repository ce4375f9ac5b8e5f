"""The port's kernels (plain versions, on the CPU) against the JAX
package's ops, bit for bit.

Inputs are made from a seed with numpy and go through both packages;
every output is bytes or integers, so the tolerance is 0. The JAX side
runs its jnp reference (``impl="ref"``) across the sweep and its Pallas
kernel in interpret mode (``impl="pallas"``) on one small case per
kernel. The CUDA kernels themselves run only on a card: ``chip_smoke.py``
holds each against its plain version there.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.apply_unpack import apply_unpack as jax_apply_unpack
from repro.kernels.apply_unpack import block_popcounts as jax_block_popcounts
from repro.kernels.dirty_diff import dirty_blocks as jax_dirty_blocks
from repro.kernels.flush_pack import compact_index as jax_compact_index
from repro.kernels.flush_pack import flush_pack as jax_flush_pack
from repro.kernels.popcnt_checksum import popcount_blocks as jax_popcount_blocks
from repro.kernels.popcnt_checksum import popcount_checksum as jax_popcount_checksum
from repro_torch.kernels import (
    apply_unpack,
    dirty_blocks,
    flush_pack,
    popcount_blocks,
    popcount_checksum,
)
from repro_torch.kernels.common import as_blocks, as_bytes
from repro_torch.kernels.flush_pack import compact_index
from repro_torch.persistence.state import from_numpy

DTYPES = [np.float32, ml_dtypes.bfloat16, np.int8, np.uint32]
#: (block_bytes, elements): whole blocks, ragged tails, several block sizes
GEOMETRIES = [(4096, 4096), (4096, 5000), (8192, 13000), (16384, 3001)]
KERNELS = [popcount_blocks, dirty_blocks, flush_pack, apply_unpack]


def rand(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    if dtype == np.uint32:
        return (x * 1e6).view(np.uint32).reshape(shape)
    if dtype == np.int8:
        return (x * 10).astype(np.int8)
    return x.astype(dtype)


def dirtied(rng, snap, positions):
    cur = snap.copy()
    for p in positions:
        cur[p] = rand(rng, (1,), snap.dtype)[0]
    return cur


def signed_zero_and_nan(dtype):
    """``(cur, snap, flags)``: six 4 KiB blocks of a float ``dtype`` and
    the reference's dirty flags. Block 0 holds -0.0 against +0.0 (equal
    values, other bytes: clean), block 1 the same NaN on both sides (NaN
    != NaN: dirty), block 2 a NaN against 1.0, block 3 +0.0 against
    -0.0 and a changed value, block 4 the same bytes on both sides, and
    the ragged block 5 a NaN only in ``snap``."""
    per = 4096 // np.dtype(dtype).itemsize
    snap = np.ones(5 * per + 7, dtype=dtype)
    cur = snap.copy()
    snap[[0, 5, per - 1]] = 0.0
    cur[[0, 5, per - 1]] = -0.0
    cur[per + 3] = snap[per + 3] = np.nan
    snap[2 * per + 9] = np.nan
    snap[3 * per] = -0.0
    cur[3 * per] = 0.0
    cur[3 * per + 1] = 2.0
    snap[5 * per + 6] = np.nan
    return cur, snap, np.array([0, 1, 1, 1, 0, 1])


def tt(a: np.ndarray) -> torch.Tensor:
    """numpy (bf16 included) → CPU tensor with the same bytes."""
    return from_numpy({"x": a}, "cpu")["x"]


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def bytes_of(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return as_bytes(x.contiguous()).numpy()
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8).reshape(-1)


def ints(x) -> np.ndarray:
    return as_np(x).astype(np.int64)


def assert_flush_pack_equal(port, ref):
    assert port.total == int(ref.total)
    for f in ("flags", "counts", "offsets", "index"):
        np.testing.assert_array_equal(ints(getattr(port, f)),
                                      ints(getattr(ref, f)), err_msg=f)
    np.testing.assert_array_equal(bytes_of(port.packed), bytes_of(ref.packed))


# ----------------------------------------------------------- popcnt_checksum

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block_bytes,n", GEOMETRIES)
def test_popcount_blocks_matches_jax(dtype, block_bytes, n):
    rng = np.random.default_rng(block_bytes + n)
    x = rand(rng, (n,), dtype)
    want = jax_popcount_blocks(jnp.asarray(x), block_bytes=block_bytes,
                               impl="ref")
    got = popcount_blocks(tt(x), block_bytes=block_bytes)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(ints(got), ints(want))


@pytest.mark.parametrize("dtype", DTYPES)
def test_popcount_checksum_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = rand(rng, (2048,), dtype)
    want = int(jax_popcount_checksum(jnp.asarray(x), impl="ref"))
    assert int(popcount_checksum(tt(x))) == want != 0
    assert int(popcount_checksum(torch.zeros(512, dtype=torch.float32))) == 1


# --------------------------------------------------------------- dirty_diff

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block_bytes,n", GEOMETRIES)
def test_dirty_blocks_matches_jax(dtype, block_bytes, n):
    rng = np.random.default_rng(2 * block_bytes + n)
    snap = rand(rng, (n,), dtype)
    cur = dirtied(rng, snap, [1, n // 2, n - 1])
    want = jax_dirty_blocks(jnp.asarray(cur), jnp.asarray(snap),
                            block_bytes=block_bytes, impl="ref")
    got = dirty_blocks(tt(cur), tt(snap), block_bytes=block_bytes)
    np.testing.assert_array_equal(ints(got), ints(want))
    assert int(got.sum()) >= 1


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16, np.float16])
@pytest.mark.parametrize("kernel", [dirty_blocks, flush_pack],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("jax_impl", ["ref", "pallas"])
def test_float_dirty_flags_match_jax(dtype, kernel, jax_impl):
    """Typed float tensors compare values, as the reference does: ±0 are
    equal and a NaN differs from itself; their uint8 views compare
    bytes (the checkpoint's case)."""
    cur, snap, want = signed_zero_and_nan(dtype)
    jax_op = {dirty_blocks: jax_dirty_blocks, flush_pack: jax_flush_pack}[kernel]
    jgot = jax_op(jnp.asarray(cur), jnp.asarray(snap), impl=jax_impl)
    got = kernel(tt(cur), tt(snap))
    if kernel is flush_pack:
        assert_flush_pack_equal(got, jgot)
        got, jgot = got.flags, jgot.flags
    np.testing.assert_array_equal(ints(got), want)
    np.testing.assert_array_equal(ints(got), ints(jgot))
    as_u8 = kernel(as_bytes(tt(cur)), as_bytes(tt(snap)))
    byte_flags = (as_blocks(as_bytes(tt(cur)), 4096)
                  != as_blocks(as_bytes(tt(snap)), 4096)).any(dim=1)
    np.testing.assert_array_equal(
        ints(as_u8.flags if kernel is flush_pack else as_u8),
        ints(byte_flags))


@pytest.mark.parametrize("kernel", [dirty_blocks, flush_pack],
                         ids=lambda f: f.__name__)
def test_dirty_flags_refuse_other_float_dtypes(kernel):
    """float64 and complex have no counterpart in the reference, which
    takes 1-, 2- and 4-byte dtypes; their bytes can still be compared."""
    for dtype in (torch.float64, torch.complex64):
        x = torch.zeros(512, dtype=dtype)
        with pytest.raises(ValueError, match="uint8 view"):
            kernel(x, x.clone())
        kernel(as_bytes(x), as_bytes(x.clone()))


def test_dirty_blocks_identical_is_clean():
    x = torch.arange(10_000, dtype=torch.float32)
    assert int(dirty_blocks(x, x.clone()).sum()) == 0


# ----------------------------------------------------------- flush_pack

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block_bytes,n", GEOMETRIES)
def test_flush_pack_matches_jax(dtype, block_bytes, n):
    rng = np.random.default_rng(3 * block_bytes + n)
    snap = rand(rng, (n,), dtype)
    cur = dirtied(rng, snap, [0, n // 3, n - 1])
    want = jax_flush_pack(jnp.asarray(cur), jnp.asarray(snap),
                          block_bytes=block_bytes, impl="ref")
    got = flush_pack(tt(cur), tt(snap), block_bytes=block_bytes)
    assert_flush_pack_equal(got, want)
    assert got.packed.dtype == tt(cur).dtype
    assert 1 <= got.total <= 3


@pytest.mark.parametrize("impl", ["ref", "auto", "fused"])
def test_flush_pack_all_clean_and_all_dirty(impl):
    rng = np.random.default_rng(11)
    snap = rand(rng, (6000,), np.float32)
    clean = flush_pack(tt(snap), tt(snap), impl=impl)
    assert_flush_pack_equal(clean, jax_flush_pack(
        jnp.asarray(snap), jnp.asarray(snap), impl="ref"))
    assert clean.total == 0 and not clean.packed.any() and not clean.index.any()

    cur = rand(rng, (6000,), np.float32)   # independent draw: all blocks differ
    full = flush_pack(tt(cur), tt(snap), impl=impl)
    assert_flush_pack_equal(full, jax_flush_pack(
        jnp.asarray(cur), jnp.asarray(snap), impl="ref"))
    nblocks = full.flags.shape[0]
    assert full.total == nblocks
    np.testing.assert_array_equal(full.index.numpy(), np.arange(nblocks))
    np.testing.assert_array_equal(bytes_of(full.packed),
                                  as_blocks(as_bytes(tt(cur)), 4096).numpy()
                                  .reshape(-1))


@pytest.mark.parametrize("pattern", [[0] * 16, [1] * 16, [0] * 15 + [1],
                                     [1] + [0] * 15, [0, 1, 1, 0, 1, 0, 0, 1],
                                     [1, 0] * 8])
def test_compact_index_matches_jax(pattern):
    index, total = compact_index(torch.tensor(pattern, dtype=torch.int32))
    want_index, want_total = jax_compact_index(jnp.asarray(pattern, jnp.int32))
    assert total == int(want_total)
    np.testing.assert_array_equal(ints(index[:total]),
                                  ints(want_index)[:total])
    assert not index[total:].any()


# ----------------------------------------------------------- apply_unpack

def unpack_case(rng, n, dtype, k, block_bytes):
    """``k`` packed blocks scattered over an ``n``-element base, with
    their true popcounts (the JAX package's own count)."""
    base = rand(rng, (n,), dtype)
    itemsize = np.dtype(dtype).itemsize
    nblocks = -(-n * itemsize // block_bytes)
    idx = np.sort(rng.choice(nblocks, size=min(k, nblocks),
                             replace=False)).astype(np.int32)
    rows = block_bytes // (128 * itemsize)
    packed = rand(rng, (idx.size, rows, 128), dtype)
    expected = np.asarray(jax_block_popcounts(jnp.asarray(packed)))
    return base, packed, idx, expected


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block_bytes,n", GEOMETRIES)
def test_apply_unpack_matches_jax(dtype, block_bytes, n):
    rng = np.random.default_rng(4 * block_bytes + n)
    base, packed, idx, exp = unpack_case(rng, n, dtype, 3, block_bytes)
    want = jax_apply_unpack(jnp.asarray(base), jnp.asarray(packed),
                            jnp.asarray(idx), jnp.asarray(exp),
                            block_bytes=block_bytes, impl="ref")
    tbase = tt(base)
    got = apply_unpack(tbase, tt(packed), idx, exp, block_bytes=block_bytes)
    assert got.out is tbase                      # in place over the base
    assert got.nbad == want.nbad == 0
    np.testing.assert_array_equal(bytes_of(got.out), bytes_of(want.out))
    np.testing.assert_array_equal(ints(got.ok), ints(want.ok))
    np.testing.assert_array_equal(ints(got.counts), ints(want.counts))


@pytest.mark.parametrize("impl", ["ref", "auto"])
def test_apply_unpack_inverts_flush_pack(impl):
    rng = np.random.default_rng(23)
    snap = rand(rng, (9000,), np.float32)
    cur = dirtied(rng, snap, [0, 4097, 8000])
    fp = flush_pack(tt(cur), tt(snap))
    k = fp.total
    exp = fp.counts[fp.index[:k].long()]
    res = apply_unpack(tt(snap), fp.packed[:k], fp.index[:k], exp, impl=impl)
    assert res.nbad == 0
    np.testing.assert_array_equal(res.out.numpy(), cur)


@pytest.mark.parametrize("impl", ["ref", "auto"])
def test_apply_unpack_detects_corruption(impl):
    rng = np.random.default_rng(29)
    base, packed, idx, exp = unpack_case(rng, 8192, np.float32, 4, 4096)
    bad = exp.astype(np.int64) + np.array([0, 1, 0, 0])
    want = jax_apply_unpack(jnp.asarray(base), jnp.asarray(packed),
                            jnp.asarray(idx), jnp.asarray(bad, jnp.uint32),
                            impl="ref")
    got = apply_unpack(tt(base), tt(packed), idx, bad, impl=impl)
    assert got.nbad == want.nbad == 1
    np.testing.assert_array_equal(got.ok.numpy(), [1, 0, 1, 1])
    np.testing.assert_array_equal(bytes_of(got.out), bytes_of(want.out))


def test_apply_unpack_empty_and_ragged():
    rng = np.random.default_rng(37)
    base = rand(rng, (5000,), np.float32)      # 20000 bytes: ragged at 4 KiB
    tbase = tt(base)
    empty = apply_unpack(tbase, torch.zeros(0), np.zeros(0, np.int32),
                         np.zeros(0, np.int64))
    assert empty.nbad == 0
    np.testing.assert_array_equal(empty.out.numpy(), base)
    # the ragged last block is clipped to the base's length
    packed = rand(rng, (1, 1024), np.float32)
    last = np.array([4], np.int32)
    exp = np.asarray(jax_block_popcounts(jnp.asarray(packed.reshape(1, 8, 128))))
    want = jax_apply_unpack(jnp.asarray(base), jnp.asarray(packed.reshape(-1)),
                            jnp.asarray(last), jnp.asarray(exp), impl="ref")
    got = apply_unpack(tbase, tt(packed), last, exp)
    assert got.out.shape == (5000,) and got.nbad == 0
    np.testing.assert_array_equal(bytes_of(got.out), bytes_of(want.out))


# ----------------------------------------------- against the Pallas kernels

@pytest.mark.parametrize("kernel", KERNELS, ids=lambda f: f.__name__)
def test_plain_versions_match_pallas_interpret(kernel):
    """One small case per kernel against the Pallas kernel itself, run in
    interpret mode as the JAX package's own tests run it."""
    rng = np.random.default_rng(41)
    snap = rand(rng, (3000,), ml_dtypes.bfloat16)
    cur = dirtied(rng, snap, [7, 2100])
    if kernel is popcount_blocks:
        want = jax_popcount_blocks(jnp.asarray(cur), impl="pallas")
        np.testing.assert_array_equal(ints(popcount_blocks(tt(cur))), ints(want))
    elif kernel is dirty_blocks:
        want = jax_dirty_blocks(jnp.asarray(cur), jnp.asarray(snap), impl="pallas")
        np.testing.assert_array_equal(ints(dirty_blocks(tt(cur), tt(snap))),
                                      ints(want))
    elif kernel is flush_pack:
        want = jax_flush_pack(jnp.asarray(cur), jnp.asarray(snap), impl="pallas")
        assert_flush_pack_equal(flush_pack(tt(cur), tt(snap)), want)
    else:
        base, packed, idx, exp = unpack_case(rng, 6000, np.float32, 2, 4096)
        want = jax_apply_unpack(jnp.asarray(base), jnp.asarray(packed),
                                jnp.asarray(idx), jnp.asarray(exp),
                                impl="pallas")
        got = apply_unpack(tt(base), tt(packed), idx, exp)
        np.testing.assert_array_equal(bytes_of(got.out), bytes_of(want.out))
        np.testing.assert_array_equal(ints(got.ok), ints(want.ok))


# ----------------------------------------------------------------- dispatch

@pytest.mark.parametrize("kernel", KERNELS, ids=lambda f: f.__name__)
def test_cpu_tensors_take_the_plain_version(kernel):
    """A CPU tensor never reaches the launch path (its count stays put),
    and an unknown ``impl`` is refused."""
    x = torch.arange(4096, dtype=torch.int32)
    args = {popcount_blocks: (x,), dirty_blocks: (x, x), flush_pack: (x, x),
            apply_unpack: (x.clone(), x[:1024], [0], [0])}[kernel]
    before = kernel.launches
    for impl in ("auto", "fused", "pallas", "ref"):
        kernel(*args, impl=impl)
    assert kernel.launches == before
    with pytest.raises(ValueError):
        kernel(*args, impl="cuda")


def test_block_bytes_must_be_vector_multiples():
    x = torch.zeros(100, dtype=torch.uint8)
    for bad in (0, 24, 1 << 29):
        with pytest.raises(ValueError):
            popcount_blocks(x, block_bytes=bad)

