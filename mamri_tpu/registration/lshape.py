"""L-shaped fiducial-triplet matching, vectorized for the accelerator.

The reference scans `itertools.combinations` of detected blobs per
marker-bearing link, accepting the first triplet whose sorted pairwise
distances match `sorted([l1, l2, hypot(l1, l2)])` within 5 mm, consuming the
blob ids, then ordering the triplet as (corner, short-arm, long-arm)
(Mamri/Mamri.py:1343-1363, :1782-1792).

Here all C(K,3) combinations are scored at once on the VPU; "first match in
combination order" and the greedy used-id bookkeeping across links are
reproduced with masked argmins so the result is bit-compatible with the
sequential semantics while staying jit/vmap-friendly with static shapes.
"""

from __future__ import annotations

import itertools
import math
from functools import lru_cache
from typing import NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_BIGI = jnp.iinfo(jnp.int32).max


class LShapeMatches(NamedTuple):
    points: jnp.ndarray  # (J, 3, 3) matched & ordered marker world positions
    found: jnp.ndarray  # (J,) bool
    member_ids: jnp.ndarray  # (J, 3) blob indices used (or -1)


@lru_cache(maxsize=8)
def _combo_table(k: int) -> np.ndarray:
    """All C(k,3) index triples in lexicographic (itertools) order."""
    return np.asarray(list(itertools.combinations(range(k), 3)), dtype=np.int32)


def expected_distances(l1: float, l2: float) -> Tuple[float, float, float]:
    return tuple(sorted([l1, l2, math.hypot(l1, l2)]))


def order_l_shape(points, l1: float, l2: float, tol: float, strict_reference_order: bool = False):
    """Order a triplet as (corner, short-arm end, long-arm end).

    The reference's `_sort_l_shaped_markers` tries each point as the corner in
    input order and accepts the FIRST whose two distances are within tol of
    (short, long) or (long, short). That is ambiguous for the Baseplate's
    (40, 20) arms: the hypotenuse (44.7 mm) is itself within the 5 mm
    tolerance of the long arm, so a non-corner point can be accepted first and
    skew the Kabsch fit by ~10 mm. Default behavior here picks the
    *minimum-error* in-tolerance candidate instead (identical in all
    unambiguous cases, correct in the ambiguous ones);
    `strict_reference_order=True` reproduces the reference's first-match rule.

    Returns (ordered_points (3,3), ordered (bool)).
    """
    points = jnp.asarray(points)
    l_short, l_long = sorted((float(l1), float(l2)))

    orders = []
    conds = []
    errs = []
    for i in range(3):
        c, p1, p2 = points[i], points[(i + 1) % 3], points[(i + 2) % 3]
        d1 = jnp.linalg.norm(c - p1)
        d2 = jnp.linalg.norm(c - p2)
        for (first_arm, _second_arm), perm in (
            ((l_short, l_long), jnp.stack([c, p1, p2])),
            ((l_long, l_short), jnp.stack([c, p2, p1])),
        ):
            e1 = jnp.abs(d1 - first_arm)
            e2 = jnp.abs(d2 - _second_arm)
            conds.append(jnp.logical_and(e1 <= tol, e2 <= tol))
            errs.append(e1 + e2)
            orders.append(perm)

    conds = jnp.stack(conds)  # (6,)
    errs = jnp.stack(errs)
    orders = jnp.stack(orders)  # (6, 3, 3)
    any_ok = jnp.any(conds)
    if strict_reference_order:
        choice = jnp.argmax(conds)  # first in-tolerance candidate
    else:
        choice = jnp.argmin(jnp.where(conds, errs, jnp.inf))
    ordered = jnp.where(any_ok, orders[choice], points)
    return ordered, any_ok


def match_l_shaped_triplets(
    points,
    valid,
    arm_lengths: Sequence[Tuple[float, float]],
    tol: float = 5.0,
    strict_reference_order: bool = False,
) -> LShapeMatches:
    """Greedy per-link triplet assignment over K candidate blobs.

    Args:
      points: (K, 3) candidate blob centroids (world/RAS mm).
      valid: (K,) bool — which slots hold real blobs.
      arm_lengths: per marker-link (l1, l2), in the link order the greedy
        consumption should follow (robot-definition order in the reference).
      tol: per-distance tolerance in mm (reference DISTANCE_TOLERANCE = 5).
      strict_reference_order: the reference takes the FIRST in-tolerance
        combination in blob order (Mamri.py:1356-1362). All four MAMRI marker
        signatures overlap pairwise within the 5 mm tolerance
        (Baseplate(40,20)~Joint6(45,20), Joint2(70,25)~Joint4(70,20)), so
        first-match can hand a link the wrong link's triplet whenever blob
        ordering is unlucky — leaving the rightful link unmatched. Default
        False selects the *minimum-signature-error* in-tolerance combination
        per link instead: identical whenever the reference is unambiguous,
        correct where it is order-dependent. True reproduces the reference
        exactly.
    """
    points = jnp.asarray(points)
    valid = jnp.asarray(valid)
    k = points.shape[0]
    combos = jnp.asarray(_combo_table(k))  # (C, 3)
    ncombo = combos.shape[0]

    p0 = points[combos[:, 0]]
    p1 = points[combos[:, 1]]
    p2 = points[combos[:, 2]]
    dists = jnp.stack(
        [
            jnp.linalg.norm(p0 - p1, axis=-1),
            jnp.linalg.norm(p0 - p2, axis=-1),
            jnp.linalg.norm(p1 - p2, axis=-1),
        ],
        axis=-1,
    )
    sig = jnp.sort(dists, axis=-1)  # (C, 3)
    members_valid = valid[combos[:, 0]] & valid[combos[:, 1]] & valid[combos[:, 2]]

    used = jnp.zeros((k,), dtype=bool)
    out_points = []
    out_found = []
    out_ids = []
    for l1, l2 in arm_lengths:
        expected = jnp.asarray(expected_distances(l1, l2), dtype=points.dtype)
        sig_err = jnp.abs(sig - expected[None, :])
        fits = jnp.all(sig_err <= tol, axis=-1)
        free = ~(used[combos[:, 0]] | used[combos[:, 1]] | used[combos[:, 2]])
        ok = fits & members_valid & free
        if strict_reference_order:
            choice = jnp.argmax(ok)  # first combo in lexicographic order
        else:
            choice = jnp.argmin(jnp.where(ok, jnp.sum(sig_err, axis=-1), jnp.inf))
        found = jnp.any(ok)
        idx = combos[choice]  # (3,)
        triplet = points[idx]
        ordered, _ = order_l_shape(triplet, l1, l2, tol, strict_reference_order)
        # consume blob ids only on a real match
        consume = jnp.zeros((k,), dtype=bool).at[idx].set(found)
        used = used | consume
        out_points.append(jnp.where(found, ordered, jnp.zeros_like(ordered)))
        out_found.append(found)
        out_ids.append(jnp.where(found, idx, -1))

    return LShapeMatches(
        points=jnp.stack(out_points),
        found=jnp.stack(out_found),
        member_ids=jnp.stack(out_ids),
    )


def match_l_shaped_triplets_global(
    points,
    valid,
    arm_lengths: Sequence[Tuple[float, float]],
    tol: float = 5.0,
    top_m: int = 8,
) -> LShapeMatches:
    """Globally optimal link<->triplet assignment (third matching mode).

    Even the min-error greedy can mis-assign when signatures overlap within
    the 5 mm tolerance AND a link's own triplet is missing: an earlier link
    in the consumption order steals a later link's triplet (e.g. a missing
    Baseplate (40,20) absorbing Joint6's (45,20) markers), leaving the
    rightful owner unmatched. The reference has exactly this failure mode
    (first-match greedy, Mamri/Mamri.py:1343-1363). This mode solves the
    joint assignment instead: per link, the `top_m` lowest-signature-error
    in-tolerance combinations are shortlisted, then every (top_m+1)^J
    combination of {shortlisted triplet | unmatched} is scored under the
    pairwise-disjointness constraint. The objective is lexicographic —
    maximize the number of matched links, then minimize total signature
    error. Exhaustive over the shortlist, so it IS the global optimum
    whenever each link's true triplet ranks in its own top-`top_m` (with
    K <= 32 blobs and 4 links that always holds in practice).

    Fully vectorized and jit/vmap-compatible: (top_m+1)^J static assignment
    table, blob sets as multi-word uint32 bitmasks (ceil(K/32) words, so any
    escalated blob budget fits), disjointness via population counts.
    """
    points = jnp.asarray(points)
    valid = jnp.asarray(valid)
    k = points.shape[0]
    nwords = -(-k // 32)  # blob-set bitmask words; 1 word up to 32 blobs
    nlinks = len(arm_lengths)
    combos = jnp.asarray(_combo_table(k))  # (C, 3)

    p0 = points[combos[:, 0]]
    p1 = points[combos[:, 1]]
    p2 = points[combos[:, 2]]
    dists = jnp.stack(
        [
            jnp.linalg.norm(p0 - p1, axis=-1),
            jnp.linalg.norm(p0 - p2, axis=-1),
            jnp.linalg.norm(p1 - p2, axis=-1),
        ],
        axis=-1,
    )
    sig = jnp.sort(dists, axis=-1)  # (C, 3)
    members_valid = valid[combos[:, 0]] & valid[combos[:, 1]] & valid[combos[:, 2]]
    word_ids = jnp.arange(nwords, dtype=jnp.uint32)[None, :] * 32  # (1, W)
    combo_mask = jnp.zeros((combos.shape[0], nwords), jnp.uint32)
    for m in range(3):
        idxu = combos[:, m].astype(jnp.uint32)[:, None]  # (C, 1)
        in_word = (idxu >= word_ids) & (idxu < word_ids + 32)
        # clamp the shift for out-of-word lanes (a >=32-bit shift is
        # implementation-defined even when `where` discards the result)
        shift = jnp.where(in_word, idxu - word_ids, jnp.uint32(0))
        combo_mask = combo_mask | jnp.where(
            in_word, jnp.uint32(1) << shift, jnp.uint32(0)
        )  # (C, W) blob-membership bitmask

    _INF = jnp.float32(jnp.inf)
    cand_idx, cand_err, cand_ok, cand_mask = [], [], [], []
    for l1, l2 in arm_lengths:
        expected = jnp.asarray(expected_distances(l1, l2), dtype=points.dtype)
        sig_err = jnp.abs(sig - expected[None, :])
        fits = jnp.all(sig_err <= tol, axis=-1) & members_valid
        err = jnp.sum(sig_err, axis=-1)
        keys = jnp.where(fits, -err, -_INF)
        vals, idx = jax.lax.top_k(keys, top_m)  # best = least error first
        cand_idx.append(idx)
        cand_err.append(-vals)  # inf where not fitting
        cand_ok.append(vals > -_INF)
        cand_mask.append(jnp.where((vals > -_INF)[:, None], combo_mask[idx], jnp.uint32(0)))
    cand_idx = jnp.stack(cand_idx)  # (J, M)
    cand_err = jnp.stack(cand_err)
    cand_ok = jnp.stack(cand_ok)
    cand_mask = jnp.stack(cand_mask)  # (J, M, W)

    # option M (the last) = "leave this link unmatched": always legal, zero
    # error, empty blob set — scored below matched options by the lexicographic
    # objective.
    m1 = top_m + 1
    opt_err = jnp.concatenate([jnp.where(cand_ok, cand_err, _INF), jnp.zeros((nlinks, 1))], axis=1)
    opt_mask = jnp.concatenate([cand_mask, jnp.zeros((nlinks, 1, nwords), jnp.uint32)], axis=1)
    opt_matched = jnp.concatenate(
        [cand_ok, jnp.zeros((nlinks, 1), bool)], axis=1
    )

    n_assign = m1**nlinks
    a = jnp.arange(n_assign, dtype=jnp.int32)
    digits = jnp.stack([(a // (m1**j)) % m1 for j in range(nlinks)], axis=1)  # (A, J)
    link_ids = jnp.arange(nlinks)[None, :]
    a_err = opt_err[link_ids, digits]  # (A, J)
    a_mask = opt_mask[link_ids, digits]  # (A, J, W)
    a_matched = opt_matched[link_ids, digits]

    pop = jax.lax.population_count
    union = jnp.zeros((n_assign, nwords), jnp.uint32)
    popsum = jnp.zeros(n_assign, jnp.int32)
    for j in range(nlinks):
        union = union | a_mask[:, j]
        popsum = popsum + jnp.sum(pop(a_mask[:, j]), axis=-1).astype(jnp.int32)
    disjoint = jnp.sum(pop(union), axis=-1).astype(jnp.int32) == popsum

    n_matched = jnp.sum(a_matched, axis=1)
    total_err = jnp.sum(a_err, axis=1)
    feasible = disjoint & jnp.isfinite(total_err)
    # lexicographic argmin in two exact stages (a single combined f32 score
    # -n_matched*1e6 + err has ~0.5 ulp at |4e6|, which rounds away sub-0.5mm
    # error differences between equal-match assignments): first mask to the
    # max feasible match count, then argmin total error within it.
    best_matched = jnp.max(jnp.where(feasible, n_matched, -1))
    tie = feasible & (n_matched == best_matched)
    best = jnp.argmin(jnp.where(tie, total_err, _INF))

    out_points, out_found, out_ids = [], [], []
    for j, (l1, l2) in enumerate(arm_lengths):
        opt = digits[best, j]
        found = opt_matched[j, opt]
        idx = combos[cand_idx[j, jnp.minimum(opt, top_m - 1)]]  # (3,)
        triplet = points[idx]
        ordered, _ = order_l_shape(triplet, l1, l2, tol)
        out_points.append(jnp.where(found, ordered, jnp.zeros_like(ordered)))
        out_found.append(found)
        out_ids.append(jnp.where(found, idx, -1))

    return LShapeMatches(
        points=jnp.stack(out_points),
        found=jnp.stack(out_found),
        member_ids=jnp.stack(out_ids),
    )
