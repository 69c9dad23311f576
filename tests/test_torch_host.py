"""Host-side parity of the port with the JAX package, on the CPU.

* The samplers (``dem_engine_tpu_torch/utils/samplers.py`` against
  ``dem_engine_tpu/utils/samplers.py``): GridSampler, HCPSampler (their
  box, sphere and z-cylinder regions, as tests/test_materials_samplers.py
  calls them), DEMBoxGridSampler, DEMBoxHCPSampler and DEMCylSurfSampler
  on seeded centres, sizes and spacings: the same points, exactly.
* The sort-merge history map (``ops/history.py``), the cases of
  tests/test_history_map.py at that test's sizes: ``_merge_match``
  against a brute-force dict match on three seeded tables;
  ``carry_history`` with persistency re-injecting an undetected
  persistent row after the new ones with its history, and the
  lost-contact sentry counting a dropped history, each table held row
  for row. (``tests/test_torch_custom.py`` holds carry_history with
  persistency to the JAX function's tables.)
"""

import numpy as np
import pytest
import torch

import dem_engine_tpu as jdem
import dem_engine_tpu_torch as tdem
from dem_engine_tpu_torch.ops import history as thistory
from dem_engine_tpu_torch.state import ContactTable


def _cases(seed, n=6):
    """Seeded (centre, half-dims or radius, spacing) triples."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield (rng.uniform(-0.5, 0.5, 3), rng.uniform(0.05, 0.3, 3),
               float(rng.uniform(0.02, 0.08)))


@pytest.mark.parametrize("sampler", ["GridSampler", "HCPSampler"])
def test_sampler_regions_match_jax(sampler):
    for c, hd, sep in _cases(1):
        j, t = getattr(jdem, sampler)(sep), getattr(tdem, sampler)(sep)
        for region, args in (("SampleBox", (c, hd)),
                             ("SampleSphere", (c, hd[0])),
                             ("SampleCylinderX", (c, hd[0], hd[1])),
                             ("SampleCylinderY", (c, hd[0], hd[1])),
                             ("SampleCylinderZ", (c, hd[0], hd[1]))):
            a = getattr(j, region)(*args)
            b = getattr(t, region)(*args)
            assert a.shape == b.shape and len(a), (sampler, region, args)
            assert np.array_equal(a, b), (sampler, region, args)
    # tests/test_materials_samplers.py's own calls
    for args in (("GridSampler", "SampleBox", [0, 0, 0], [0.25] * 3, 0.1),
                 ("HCPSampler", "SampleSphere", [0, 0, 0], 0.2, 0.05),
                 ("GridSampler", "SampleCylinderZ", [0, 0, 0], 0.15, 0.05)):
        name, region, c, size, sep = args
        if name != sampler:
            continue
        extra = (0.1,) if region == "SampleCylinderZ" else ()
        assert np.array_equal(
            getattr(getattr(jdem, name)(sep), region)(c, size, *extra),
            getattr(getattr(tdem, name)(sep), region)(c, size, *extra))


def test_dem_samplers_match_jax():
    for c, hd, sep in _cases(2):
        for name, args in (
                ("DEMBoxGridSampler", (c, hd, sep)),
                ("DEMBoxGridSampler", (c, hd, sep, 1.3 * sep, 0.8 * sep)),
                ("DEMBoxHCPSampler", (c, hd, sep)),
                ("DEMCylSurfSampler", (c, hd / np.linalg.norm(hd), hd[0],
                                       hd[1], sep))):
            a = getattr(jdem, name)(*args)
            b = getattr(tdem, name)(*args)
            assert a.shape == b.shape and len(a), (name, args)
            assert np.array_equal(a, b), (name, args)
    # tests/test_materials_samplers.py's own calls
    for name, args in (("DEMBoxHCPSampler", ([0, 0, 0], [0.2] * 3, 0.05)),
                       ("DEMCylSurfSampler", ([0, 0, 0], [0, 0, 1], 0.1,
                                              0.2, 0.03))):
        assert np.array_equal(getattr(jdem, name)(*args),
                              getattr(tdem, name)(*args))


def _rand_table(rng, cap, n_live, n_geo=40):
    """tests/test_history_map.py's ``_rand_table``: unique random
    (idA, idB) pairs, live entries compacted to the front."""
    pairs = set()
    while len(pairs) < n_live:
        pairs.add((int(rng.integers(0, n_geo)), int(rng.integers(0, n_geo))))
    idA = np.full(cap, -1, np.int32)
    idB = np.full(cap, -1, np.int32)
    for i, (a, b) in enumerate(sorted(pairs)):
        idA[i], idB[i] = a, b
    return idA, idB


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_match_brute_parity(seed):
    rng = np.random.default_rng(seed)
    oA, oB = _rand_table(rng, 96, 60)
    nA, nB = _rand_table(rng, 128, 70)
    mapping, old_matched = (x.numpy() for x in thistory._merge_match(
        *(torch.from_numpy(x) for x in (oA, oB, nA, nB))))
    lut = {(a, b): i for i, (a, b) in enumerate(zip(oA, oB)) if a >= 0}
    hit = np.zeros(96, bool)
    for j in range(128):
        if nA[j] < 0:
            continue
        want = lut.get((nA[j], nB[j]), -1)
        assert mapping[j] == want, (j, nA[j], nB[j], mapping[j], want)
        hit[max(want, 0)] |= want >= 0
    live_old = oA >= 0
    assert (old_matched[live_old] == hit[live_old]).all()


def _carry(cap, old_rows, persist, wc, new_rows, use_persistency):
    """The port's carry_history on one old table and one new pair list
    (tests/test_history_map.py's cases). Returns (table, n_lost)."""
    def ids(rows):
        a = torch.full((cap,), -1, dtype=torch.int32)
        b = torch.full((cap,), -1, dtype=torch.int32)
        for i, (x, y) in enumerate(rows):
            a[i], b[i] = x, y
        return a, b

    oA, oB = ids(old_rows)
    p = torch.zeros(cap, dtype=torch.int32)
    p[:len(persist)] = torch.tensor(persist, dtype=torch.int32)
    w = torch.zeros(cap)
    w[:len(wc)] = torch.tensor(wc)
    old = ContactTable.empty(cap, ("w",)).replace(
        idA=oA, idB=oB, persist=p,
        count=torch.tensor(len(old_rows), dtype=torch.int32),
        wildcards={"w": w})
    tab, n_lost = thistory.carry_history(
        old, *ids(new_rows), torch.tensor(len(new_rows), dtype=torch.int32),
        ("w",), use_persistency=use_persistency)
    return tab, int(n_lost)


def test_carry_history_persistency_reinject():
    """Old: (0,1) persistent with history, (2,3) plain with history, (4,5)
    plain without; new: (2,3) and a fresh (6,7). (2,3) carries its
    history, (6,7) starts clean, (0,1) comes back at row 2 with its
    history and mark, nothing counts as lost."""
    t, n_lost = _carry(16, [(0, 1), (2, 3), (4, 5)], [1], [7.5, 3.25],
                       [(2, 3), (6, 7)], use_persistency=True)
    want_a = [2, 6, 0] + [-1] * 13
    want_b = [3, 7, 1] + [-1] * 13
    assert t.idA.tolist() == want_a and t.idB.tolist() == want_b
    assert t.wildcards["w"].tolist() == [3.25, 0.0, 7.5] + [0.0] * 13
    assert t.persist.tolist() == [0, 0, 1] + [0] * 13
    assert int(t.count) == 3 and n_lost == 0


def test_carry_history_lost_sentry_counts_dropped_history():
    """A non-persistent old contact with history that is not found again
    counts as lost."""
    t, n_lost = _carry(8, [(1, 2)], [], [0.5], [], use_persistency=False)
    assert n_lost == 1 and int(t.count) == 0
