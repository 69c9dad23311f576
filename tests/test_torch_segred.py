"""The plain owner-segment sums of the port (the CPU versions of kernels
A and D) against the JAX package's seg_sum_sorted_blocks and
seg_sum_sorted (v1) in interpret mode, and the two-sided seg_sum_pair
against the JAX package's reduce_wrench_segment over the same kernel.

Tolerance: rtol 1e-5 per element, no atol. Both sides add f32 in
different orders; the largest reading is 7.4e-6 of the element, on the
heavy owner's 2,500-row sum (4.5e-8 on the random case, 0 on the dead
tail). Owners with no rows are 0 on both sides. The v1 cases are those
of tests/test_pallas_segred.py (256-row tiles, 512-owner windows): a
dense table, a dead tail, and a sparse table that must spill; the spill
flag must agree, and so must the (then partial) sums. The pair cases
hold each element to 1e-5 of the largest |sum| (a clump's A-side and
B-side rows cancel to rounding, so a per-element rtol has no meaning
there); the largest reading is 6.6e-7.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dem_engine_tpu.ops.forces import reduce_wrench_segment
from dem_engine_tpu.ops.pallas_segred import seg_sum_sorted as jax_v1
from dem_engine_tpu.ops.pallas_segred import seg_sum_sorted_blocks
from dem_engine_tpu_torch.ops import segred

torch.set_num_threads(2)
jax.config.update("jax_platforms", "cpu")


def _case(kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "random":
        cap, n, n_live = 4096, 700, 4096
        ids = np.sort(rng.integers(0, n, n_live))
    elif kind == "dead_tail":
        cap, n, n_live = 2048, 300, 600
        ids = np.sort(rng.integers(0, n, n_live))
    else:  # one owner holds most rows, like the floor plane's B side
        cap, n, n_live = 3000, 520, 2900
        ids = np.sort(np.concatenate(
            [np.full(2500, 512), rng.integers(0, n, n_live - 2500)]))
    ids = np.concatenate([ids, np.full(cap - n_live, n)]).astype(np.int32)
    rec = rng.normal(size=(cap, 6)).astype(np.float32)
    rec[n_live:] = 0.0
    return rec, ids, n


@pytest.mark.parametrize("kind", ["random", "dead_tail", "heavy_owner"])
def test_plain_matches_jax_blocks(kind):
    rec, ids, n = _case(kind)
    ref = seg_sum_sorted_blocks(jnp.asarray(rec), jnp.asarray(ids), n,
                                interpret=True)
    got = segred.seg_sum_sorted(torch.from_numpy(rec),
                                torch.from_numpy(ids), n)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)


def test_plain_through_permutation():
    """The B-side form: row j reads rec[perm[j]] under the grouped ids,
    equal to summing the permuted records."""
    rec, ids, n = _case("heavy_owner", seed=3)
    rng = np.random.default_rng(4)
    perm = rng.permutation(ids.shape[0]).astype(np.int32)
    inv = np.argsort(perm)
    ref = seg_sum_sorted_blocks(jnp.asarray(rec), jnp.asarray(ids), n,
                                interpret=True)
    got = segred.seg_sum_sorted(torch.from_numpy(rec[inv]),
                                torch.from_numpy(ids), n,
                                perm=torch.from_numpy(perm))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)


def _table(seed, cap=1536, n=520, n_live=1400, heavy=900):
    """One contact table's wrench rows in the (own_a, own_b) order: a
    dead tail, a B owner (512) that holds `heavy` rows like the floor
    plane, and the B-side order through perm_b."""
    rng = np.random.default_rng(seed)
    own_a = np.sort(rng.integers(0, n, n_live))
    own_b = np.where(np.arange(n_live) < heavy, 512,
                     rng.integers(0, n, n_live))
    own_b = own_b[rng.permutation(n_live)]
    dead = np.full(cap - n_live, n)
    perm_b = np.concatenate([np.lexsort((own_a, own_b)),
                             np.arange(n_live, cap)]).astype(np.int32)
    own_a = np.concatenate([own_a, -np.ones(cap - n_live)]).astype(np.int32)
    own_b_sorted = np.concatenate([own_b, dead])[perm_b].astype(np.int32)
    rec_a = rng.normal(size=(cap, 6)).astype(np.float32)
    rec_b = rng.normal(size=(cap, 6)).astype(np.float32)
    rec_a[n_live:] = rec_b[n_live:] = 0.0
    on_heavy = np.concatenate([own_b, dead]) == 512
    rec_b[on_heavy] = np.abs(rec_b[on_heavy])  # same-sign rows, like weight
    return dict(rec_a=rec_a, rec_b=rec_b, own_a=own_a,
                own_b_sorted=own_b_sorted, perm_b=perm_b), n


@pytest.fixture(scope="module")
def pair_tables():
    """Two tables of one shape, and the JAX package's sums of the first
    and of both (reduce_wrench_segment over seg_sum_sorted_blocks in
    interpret mode, traced once)."""
    (t1, n), (t2, _) = _table(5), _table(6)

    def as_pass(t):
        return dict(rec_a=t["rec_a"], rec_b=t["rec_b"],
                    table=SimpleNamespace(**t))

    @jax.jit
    def sums(a, b):
        one = reduce_wrench_segment(n, [as_pass(a)], use_pallas=True)
        both = reduce_wrench_segment(n, [as_pass(a), as_pass(b)],
                                     use_pallas=True)
        return jnp.concatenate(one, 1), jnp.concatenate(both, 1)

    one, both = sums(t1, t2)
    return t1, t2, n, np.asarray(one), np.asarray(both)


def _pair(t, n, out=None):
    return segred.seg_sum_pair(*(torch.from_numpy(t[k]) for k in (
        "rec_a", "own_a", "rec_b", "own_b_sorted", "perm_b")), n, out=out)


@pytest.mark.parametrize("case", ["one_table", "second_table_onto_out"])
def test_pair_matches_jax_reduce(pair_tables, case):
    t1, t2, n, ref_one, ref_both = pair_tables
    got = _pair(t1, n)
    ref = ref_one
    if case == "second_table_onto_out":
        acc = got
        got = _pair(t2, n, out=acc)
        assert got is acc  # added in place
        ref = ref_both
    assert np.abs(ref).max() > 500  # the heavy owner's sum
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def _v1_case(kind):
    rng = np.random.default_rng(0 if kind != "sparse_spill" else 1)
    if kind == "sparse_spill":
        cap, n = 1024, 100_000
        ids = np.sort(rng.integers(0, n, cap)).astype(np.int32)
        return np.ones((cap, 6), np.float32), ids, n
    cap, n, density = (4096, 700, 0.8) if kind == "dense" else (2048, 300,
                                                                0.3)
    n_live = int(cap * density)
    ids = np.sort(rng.integers(0, n, n_live))
    ids = np.concatenate([ids, np.full(cap - n_live, n)]).astype(np.int32)
    rec = rng.normal(size=(cap, 6)).astype(np.float32)
    rec[n_live:] = 0.0
    return rec, ids, n


@pytest.mark.parametrize("kind", ["dense", "dead_tail", "sparse_spill"])
def test_v1_plain_matches_jax(kind):
    rec, ids, n = _v1_case(kind)
    ref, ref_spill = jax_v1(jnp.asarray(rec), jnp.asarray(ids), n,
                            interpret=True, tile=256, owin=512)
    got, spill = segred.seg_sum_sorted_v1(torch.from_numpy(rec),
                                          torch.from_numpy(ids), n,
                                          tile=256, owin=512)
    assert bool(spill) == bool(ref_spill) == (kind == "sparse_spill")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)
