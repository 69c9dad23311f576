"""Contact-history mapping across contact-table refreshes.

A new contact matching an old (idA, idB) pair inherits its wildcards and
persistency mark; unmatched new contacts start from zero. Re-injecting
persistent contacts that were not re-detected comes with the
persistency slice.

Mechanism: one stable merge-sort of old+new keys. Each key occurs at
most once per table and old rows precede new rows in the concatenation,
so a new entry matches iff its predecessor in the merged order is an old
entry with the same key.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..defines import F, I
from ..state import ContactTable


def pair_key(a, b):
    """int64 key ordering (a, b) lexicographically, for ids in
    [-1, 2**31 - 2].

    ``jax.lax.sort(..., num_keys=2)`` has no torch twin: the port sorts
    one combined key with a stable sort instead."""
    return ((a.long() + 1) << 32) | (b.long() + 1)


def _merge_match(old_idA, old_idB, new_idA, new_idB):
    """For each new slot the index of the old slot with equal (idA, idB),
    or -1; and for each old slot whether a new slot matched it."""
    n_old = old_idA.shape[0]
    n_new = new_idA.shape[0]
    dev = old_idA.device
    key = pair_key(torch.cat([old_idA, new_idA]),
                   torch.cat([old_idB, new_idB]))
    skey, spos = torch.sort(key, stable=True)
    spos = spos.to(I)
    sold = spos < n_old

    prev_eq = torch.zeros_like(sold)
    prev_eq[1:] = skey[1:] == skey[:-1]
    prev_old = torch.zeros_like(sold)
    prev_old[1:] = sold[:-1]
    matched_here = (~sold) & prev_eq & prev_old
    partner = torch.zeros_like(spos)
    partner[1:] = spos[:-1]
    match_val = torch.where(matched_here, partner, -1)

    next_eq = torch.zeros_like(sold)
    next_eq[:-1] = prev_eq[1:]
    next_new = torch.zeros_like(sold)
    next_new[:-1] = ~sold[1:]
    old_hit_here = sold & next_eq & next_new

    # un-sort: spos is a permutation, so a scatter carries both home
    mv = torch.empty(n_old + n_new, dtype=I, device=dev)
    oh = torch.empty(n_old + n_new, dtype=torch.bool, device=dev)
    mv[spos.long()] = match_val
    oh[spos.long()] = old_hit_here
    return mv[n_old:], oh[:n_old]


def carry_history(old: ContactTable, new_idA, new_idB, new_count,
                  wildcard_names: Tuple[str, ...]):
    """The refreshed table with wildcards/persistency carried over, and
    n_lost: old non-persistent contacts with live history (a nonzero
    wildcard) that were not re-detected.

    Layout fields (own_a, statics, fstat_a, ...) stay stale until the
    caller's finalize_table rebuilds them."""
    mapping, old_matched = _merge_match(old.idA, old.idB, new_idA, new_idB)
    live = new_idA >= 0
    matched = live & (mapping >= 0)
    safe_map = torch.where(matched, mapping, 0).long()

    def carried(src):
        return torch.where(matched, src[safe_map], 0)

    wildcards = {}
    for k in wildcard_names:
        src = old.wildcards.get(k)
        wildcards[k] = (carried(src) if src is not None else
                        torch.zeros(new_idA.shape, dtype=F,
                                    device=new_idA.device))
    persist = carried(old.persist)

    old_live = old.idA >= 0
    had_history = torch.zeros_like(old_live)
    for k in wildcard_names:
        src = old.wildcards.get(k)
        if src is not None:
            had_history |= torch.abs(src) > 0
    n_lost = torch.sum(
        (old_live & ~old_matched & (old.persist == 0) & had_history).to(I)
    ).to(I)

    return old.replace(
        idA=new_idA,
        idB=new_idB,
        count=new_count,
        persist=persist,
        force=torch.zeros_like(old.force),
        torque=torch.zeros_like(old.torque),
        cpoint=torch.zeros_like(old.cpoint),
        wildcards=wildcards,
    ), n_lost
