"""The port's delta gather and scatter (plain versions, on the CPU)
against the JAX package's ``delta_pack`` ops, bit for bit.

Inputs are made from a seed with numpy and go through both packages; the
ops copy blocks, so every comparison is of bytes and the tolerance is 0.
The JAX side runs its jnp reference (``impl="ref"``) and its Pallas
kernels (``delta_pack_blocked``, ``delta_apply_blocked``) in interpret
mode (``impl="pallas"``) across the dtype × geometry sweep.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.common import LANES
from repro.kernels.delta_pack import apply_delta as jax_apply_delta
from repro.kernels.delta_pack import pack_delta as jax_pack_delta
from repro.kernels.delta_pack import pack_dirty as jax_pack_dirty
from repro.kernels.delta_pack.kernel import delta_apply_blocked
from repro.kernels.dirty_diff import dirty_blocks as jax_dirty_blocks
from repro_torch.kernels import (
    apply_delta,
    dirty_blocks,
    flush_pack,
    pack_delta,
    pack_dirty,
    popcount_blocks,
)
from test_torch_kernels import DTYPES, GEOMETRIES, bytes_of, dirtied, ints, rand, tt

#: the JAX package's jnp reference and its Pallas kernel in interpret mode
JAX_IMPLS = ["ref", "pallas"]


def case(seed, dtype, block_bytes, n, k=3):
    """A buffer of ``n`` elements and ``k`` distinct block ids of it in
    random order, the ragged last block among them."""
    rng = np.random.default_rng(seed)
    buf = rand(rng, (n,), dtype)
    nblocks = -(-n * np.dtype(dtype).itemsize // block_bytes)
    rest = rng.permutation(nblocks - 1)[: min(k, nblocks) - 1]
    idx = rng.permutation(np.append(rest, nblocks - 1)).astype(np.int32)
    return rng, buf, idx


def rows_of(dtype, block_bytes):
    return block_bytes // (LANES * np.dtype(dtype).itemsize)


# ------------------------------------------------------------------- gather

@pytest.mark.parametrize("jax_impl", JAX_IMPLS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block_bytes,n", GEOMETRIES)
def test_pack_delta_matches_jax(dtype, block_bytes, n, jax_impl):
    _, buf, idx = case(block_bytes + n, dtype, block_bytes, n)
    want = jax_pack_delta(jnp.asarray(buf), jnp.asarray(idx),
                          block_bytes=block_bytes, impl=jax_impl)
    got = pack_delta(tt(buf), idx, block_bytes=block_bytes)
    elems = block_bytes // np.dtype(dtype).itemsize
    assert got.shape == (idx.size, elems) and got.dtype == tt(buf).dtype
    np.testing.assert_array_equal(bytes_of(got), bytes_of(want))
    np.testing.assert_array_equal(
        bytes_of(pack_delta(tt(buf), torch.from_numpy(idx).long(),
                            block_bytes=block_bytes)), bytes_of(want))


def test_pack_delta_empty_index():
    got = pack_delta(torch.ones(5000), np.zeros(0, np.int32))
    assert got.shape == (0, 1024) and got.dtype == torch.float32


# ------------------------------------------------------------------ scatter

@pytest.mark.parametrize("jax_impl", JAX_IMPLS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block_bytes,n", GEOMETRIES)
def test_apply_delta_matches_jax(dtype, block_bytes, n, jax_impl):
    rng, base, idx = case(2 * block_bytes + n, dtype, block_bytes, n)
    rows = rows_of(dtype, block_bytes)
    delta = rand(rng, (idx.size, rows, LANES), dtype)
    want = jax_apply_delta(jnp.asarray(base), jnp.asarray(delta),
                           jnp.asarray(idx), block_bytes=block_bytes,
                           impl=jax_impl)
    tbase = tt(base)
    got = apply_delta(tbase, tt(delta.reshape(idx.size, -1)), idx,
                      block_bytes=block_bytes)
    assert got is tbase                     # in place over the buffer
    assert got.shape == (n,)
    np.testing.assert_array_equal(bytes_of(got), bytes_of(want))


def test_apply_delta_keeps_clean_blocks():
    """Blocks that no id names keep their bytes, as in the JAX package's
    ``delta_apply_blocked`` (64 blocks, two written)."""
    rng = np.random.default_rng(3)
    base = rand(rng, (64, 8, LANES), np.float32)
    upd = rand(rng, (2, 8, LANES), np.float32)
    idx = np.array([5, 60], np.int32)
    want = np.asarray(delta_apply_blocked(jnp.asarray(base), jnp.asarray(upd),
                                          jnp.asarray(idx), interpret=True))
    got = apply_delta(tt(base.reshape(-1)), tt(upd), idx).numpy()
    got = got.reshape(64, 8, LANES)
    clean = [b for b in range(64) if b not in (5, 60)]
    np.testing.assert_array_equal(got[clean], base[clean])
    np.testing.assert_array_equal(got[[5, 60]], upd)
    np.testing.assert_array_equal(got, want)


def test_apply_delta_refuses_mismatches():
    buf = torch.zeros(4096)
    with pytest.raises(ValueError):
        apply_delta(buf, torch.zeros(1024, dtype=torch.int32), [0])
    with pytest.raises(ValueError):
        apply_delta(buf, torch.zeros(1000), [0])        # not whole blocks
    with pytest.raises(ValueError):
        apply_delta(buf, torch.zeros(1024), [0, 1])     # one id a block
    empty = apply_delta(buf, torch.zeros(0), [])
    assert empty is buf and not buf.any()


# --------------------------------------------------------------- round trip

@pytest.mark.parametrize("dtype", DTYPES)
def test_staged_chain_round_trip(dtype):
    """The staged chain composed equals the fused pass, and its delta
    replays: dirty_blocks + popcount_blocks give flush_pack's flags and
    counts, pack_dirty its packed rows and ids (and the JAX package's
    delta), and apply_delta onto the snapshot gives back the live
    buffer."""
    rng = np.random.default_rng(13)
    snap = rand(rng, (9000,), dtype)
    cur = dirtied(rng, snap, [0, 4097, 8999])
    fp = flush_pack(tt(cur), tt(snap))
    flags = dirty_blocks(tt(cur), tt(snap))
    np.testing.assert_array_equal(ints(flags), ints(fp.flags))
    np.testing.assert_array_equal(ints(popcount_blocks(tt(cur))),
                                  ints(fp.counts))
    delta, idx, k = pack_dirty(tt(cur), flags)
    assert k == fp.total >= 1 and idx.dtype == torch.int32
    np.testing.assert_array_equal(ints(idx), ints(fp.index[:k]))
    np.testing.assert_array_equal(bytes_of(delta), bytes_of(fp.packed[:k]))
    jflags = jax_dirty_blocks(jnp.asarray(cur), jnp.asarray(snap), impl="ref")
    jdelta, jidx, jk = jax_pack_dirty(jnp.asarray(cur), jflags, impl="ref")
    assert jk == k
    np.testing.assert_array_equal(ints(idx), ints(jidx))
    np.testing.assert_array_equal(bytes_of(delta), bytes_of(jdelta))
    restored = apply_delta(tt(snap), delta, idx)
    np.testing.assert_array_equal(bytes_of(restored), bytes_of(tt(cur)))


def test_pack_dirty_agrees_with_pack_delta():
    """pack_dirty's compaction gives the ascending dirty ids, and its
    delta is pack_delta's at those ids."""
    rng = np.random.default_rng(17)
    snap = rand(rng, (8192,), np.float32)
    cur = dirtied(rng, snap, [100, 3000, 8000])
    flags = dirty_blocks(tt(cur), tt(snap))
    delta, idx, k = pack_dirty(tt(cur), flags)
    want_idx = np.flatnonzero(flags.numpy()).astype(np.int32)
    assert k == want_idx.size == 3
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(bytes_of(delta),
                                  bytes_of(pack_delta(tt(cur), want_idx)))


# ----------------------------------------------------------------- dispatch

@pytest.mark.parametrize("op", [pack_delta, apply_delta],
                         ids=lambda f: f.__name__)
def test_cpu_tensors_take_the_plain_version(op):
    x = torch.arange(4096, dtype=torch.int32)
    args = {pack_delta: (x, [0, 3]),
            apply_delta: (x.clone(), x[:2048], [3, 0])}[op]
    before = op.launches
    for impl in ("auto", "fused", "pallas", "ref"):
        op(*args, impl=impl)
    assert op.launches == before
    with pytest.raises(ValueError):
        op(*args, impl="cuda")
