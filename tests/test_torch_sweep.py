"""The port's SS pair search (kernel C's CPU version) against the JAX
package's Pallas sweep v3 (interpret mode, tile 64, window 512) and its
XLA slot sweep, on the dense and family-mask cases of
tests/test_pallas_sweep3.py. Pair sets and counts must be identical.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dem_engine_tpu.defines import F
from dem_engine_tpu.ops import binning as jbinning
from dem_engine_tpu.ops.pallas_sweep3 import find_pairs_ss_pallas3
from dem_engine_tpu_torch.ops import binning as tbinning
from dem_engine_tpu_torch.ops import sweep

torch.set_num_threads(2)
jax.config.update("jax_platforms", "cpu")


def _random_spheres(n, seed, box=0.25, r=0.012):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.03, box - 0.03, size=(n, 3)).astype(np.float32)
    reach = np.full(n, r, np.float32) * rng.uniform(0.8, 1.2, n).astype(
        np.float32)
    owner = np.arange(n, dtype=np.int32)
    family = rng.integers(0, 3, n).astype(np.int32)
    return pos, reach, owner, family


# jitted, so the two cases (equal shapes) share one compile of each
_jax_xla = jax.jit(jbinning.find_pairs_ss, static_argnums=(7, 8))
_jax_pallas = jax.jit(
    functools.partial(find_pairs_ss_pallas3, interpret=True, tile=64,
                      win=512, family_filter=True), static_argnums=(7,))


def _pairs(idA, idB):
    a = np.asarray(idA)
    b = np.asarray(idB)
    live = a >= 0
    return set(zip(a[live].tolist(), b[live].tolist()))


@pytest.mark.parametrize("fam_block", [False, True],
                         ids=["dense", "family_mask"])
def test_sweep_matches_jax(fam_block):
    n, seed, box, cap = 700, 5, 0.25, 16384
    pos, reach, owner, family = _random_spheres(n, seed, box)
    mask = np.ones((256, 256), bool)
    if fam_block:
        mask[1, 2] = mask[2, 1] = False
    domain = np.asarray([box] * 3, np.float32)

    jbs, jnb = jbinning.build_grid(jnp.asarray(domain),
                                   jnp.asarray(reach).max())
    args_j = (jnp.asarray(pos), jnp.asarray(reach), jnp.asarray(owner),
              jnp.asarray(family), jnp.asarray(mask), jbs, jnb, cap)
    a1, b1, n1, _, _ = _jax_xla(*args_j, 16)
    a2, b2, n2, _, _, win_ovf = _jax_pallas(*args_j)
    assert not bool(win_ovf)

    tbs, tnb = tbinning.build_grid(torch.from_numpy(domain),
                                   torch.from_numpy(reach).max())
    a3, b3, n3 = sweep.find_pairs_ss(
        torch.from_numpy(pos), torch.from_numpy(reach),
        torch.from_numpy(owner), torch.from_numpy(family),
        torch.from_numpy(mask), tbs, tnb, cap)

    ref = _pairs(a1, b1)
    assert len(ref) > 100
    assert _pairs(a2, b2) == ref
    assert _pairs(a3, b3) == ref
    assert int(n3) == int(n1) == int(n2) == len(ref)
    if fam_block:
        fam = dict(enumerate(family.tolist()))
        assert all(not (fam[a] == 1 and fam[b] == 2 or fam[a] == 2
                        and fam[b] == 1) for a, b in ref)


def test_sweep_count_past_capacity():
    """A table smaller than the pair count keeps the first `cap` pairs
    and reports the full count (the caller raises OVF_SS_CAP)."""
    pos, reach, owner, family = _random_spheres(700, 5)
    args = [torch.from_numpy(x) for x in (pos, reach, owner, family)]
    mask = torch.ones((256, 256), dtype=torch.bool)
    bs, nb = tbinning.build_grid(torch.full((3,), 0.25), args[1].max())
    a_full, b_full, n_full = sweep.find_pairs_ss(*args, mask, bs, nb, 16384)
    a_cut, b_cut, n_cut = sweep.find_pairs_ss(*args, mask, bs, nb, 100)
    assert int(n_cut) == int(n_full) > 100
    assert torch.equal(a_cut, a_full[:100])
    assert torch.equal(b_cut, b_full[:100])
