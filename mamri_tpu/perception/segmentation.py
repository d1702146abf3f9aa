"""On-device MRI segmentation: threshold -> ball closing -> CCL -> blob stats.

Replaces the reference's SimpleITK C++ pipeline (Mamri/Mamri.py:1304-1341)
with one jit/vmap-compatible program:

  * threshold + morphological closing are element-wise/shift ops that XLA
    fuses into a handful of passes over the volume;
  * connected-component labeling uses *directional segmented min-scans*
    along each axis, iterated on a fixed half-sweep schedule — a
    data-parallel formulation that converges in a few sweeps for anatomical
    shapes instead of the O(diameter) of naive 6-neighbor propagation, and
    avoids the irregular union-find of CPU CCL. Each line scan is a
    `lax.associative_scan` (a CUDA line-scan kernel measured no faster end
    to end on an H100; see PERF.md);
  * per-component statistics come from a candidate-root reduction: the
    `max_roots` smallest roots, then one chunked compare-and-contract of the
    membership one-hot against [1, i, j, k] features.

Labels are the minimum linear voxel index of each component, so candidate
ordering matches ITK's raster-scan label order (first voxel encountered).
Output shapes are static (MAX_BLOBS slots + validity mask) for jit/vmap.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import jax.numpy as jnp
from jax import lax

MAX_BLOBS = 32
MAX_ROOTS = 256  # candidate components considered for stats (log if exceeded)
_BIG = jnp.iinfo(jnp.int32).max


class SegmentationParams(NamedTuple):
    intensity_low: float = 65.0  # thresholds must be finite (validated)
    intensity_high: float = 65535.0
    min_volume_mm3: float = 50.0
    max_volume_mm3: float = 1500.0
    closing_radius: int = 2
    max_sweeps: int = 16
    max_blobs: int = MAX_BLOBS
    max_roots: int = MAX_ROOTS
    exhaustive_roots: bool = False  # exact flat top_k root selection instead
    # of the blocked two-level top_k (the engine sets it when the blocked
    # selection's per-block budget overflowed).
    passes: Optional[int] = None  # explicit HALF-SWEEP schedule length:
    # alternating [yz, x, yz, x, ...] passes. None = 2*max_sweeps (classic
    # full sweeps). The local-consistency certificate proves the fixed point
    # regardless of schedule, so an odd count (trailing yz, no final x) is
    # valid and the engine defaults to passes=3 — convex-ish anatomy
    # converges with [yz, x, yz] and the certificate escalates the rest.


class SegmentationResult(NamedTuple):
    centroids_ras: jnp.ndarray  # (max_blobs, 3) f32, RAS mm (zeros where invalid)
    volumes_mm3: jnp.ndarray  # (max_blobs,) f32
    blob_valid: jnp.ndarray  # (max_blobs,) bool
    num_blobs: jnp.ndarray  # () int32
    body_mask: jnp.ndarray  # (nx, ny, nz) bool
    body_volume_mm3: jnp.ndarray  # () f32
    body_found: jnp.ndarray  # () bool
    num_components: jnp.ndarray  # () int32 — total component count (exact)
    labels: jnp.ndarray  # (nx, ny, nz) int32 min-linear-index labels (_BIG = background)
    ccl_converged: jnp.ndarray  # () bool — labels are the exact CCL fixed
    # point (certificate; escalate passes/max_sweeps if False)
    roots_complete: jnp.ndarray  # () bool — every component's stats were
    # considered (num_components <= max_roots and no block of the blocked
    # root selection overflowed); escalate otherwise
    blobs_complete: jnp.ndarray  # () bool — every in-band (50-1500 mm^3)
    # component got a blob slot (num_in_band <= max_blobs). The ITK reference
    # has no component cap (Mamri.py:1310-1317), so a full blob band is a
    # silent truncation unless certified; the engine escalates max_blobs.
    count_ok: jnp.ndarray = True  # num_components <= max_roots: the part of
    # roots_complete that only a larger max_roots can fix (targeted
    # escalation, see MamriEngine._escalate_seg_params)


def _ball_offsets(radius: int) -> Tuple[Tuple[int, int, int], ...]:
    offs = []
    r = int(radius)
    for dx in range(-r, r + 1):
        for dy in range(-r, r + 1):
            for dz in range(-r, r + 1):
                if dx * dx + dy * dy + dz * dz <= r * r:
                    offs.append((dx, dy, dz))
    return tuple(offs)


def _shift3(a, off):
    """Shift a 3-D array by `off` (zero/edge-garbage enters only the outer
    |off| shells, which callers keep inside a padding margin)."""
    return jnp.roll(a, shift=(-off[0], -off[1], -off[2]), axis=(-3, -2, -1))


def _ball2_dilate(p):
    """Dilation by the Euclidean ball r=2, decomposed exactly:
    ball(2) = {|v|_inf <= 1}  UNION  {±2 axis vectors}
    (the 3^3 box's corners have |v|^2 = 3 <= 4; the only radius-2 members
    beyond the box are the six axis points). The box is separable into three
    3-tap max passes — 9 + 6 shifted ops instead of 33 full-volume ORs."""
    box = p
    for axis in (-3, -2, -1):
        box = jnp.logical_or(
            box,
            jnp.logical_or(jnp.roll(box, 1, axis=axis), jnp.roll(box, -1, axis=axis)),
        )
    out = box
    for axis in (-3, -2, -1):
        out = jnp.logical_or(
            out, jnp.logical_or(jnp.roll(p, 2, axis=axis), jnp.roll(p, -2, axis=axis))
        )
    return out


def _ball2_erode(p):
    box = p
    for axis in (-3, -2, -1):
        box = jnp.logical_and(
            box,
            jnp.logical_and(jnp.roll(box, 1, axis=axis), jnp.roll(box, -1, axis=axis)),
        )
    out = box
    for axis in (-3, -2, -1):
        out = jnp.logical_and(
            out, jnp.logical_and(jnp.roll(p, 2, axis=axis), jnp.roll(p, -2, axis=axis))
        )
    return out


def binary_close(mask, radius: int = 2):
    """Morphological closing with a Euclidean ball, safe-border semantics.

    The mask is padded by 2*radius so that (a) the dilation never clips at the
    volume border and (b) `jnp.roll` wraparound garbage stays in shells the
    final crop discards. Matches `reference_cpu.binary_close_safe_border`.
    radius=2 (the reference's ball, Mamri.py:1308) uses an exact separable
    decomposition; other radii fall back to the full offset reduction.
    """
    if radius <= 0:
        return mask
    pad = 2 * radius
    p = jnp.pad(mask, pad, mode="constant", constant_values=False)
    if radius == 2:
        dil = _ball2_dilate(p)
        ero = _ball2_erode(dil)
    else:
        offs = _ball_offsets(radius)
        dil = functools.reduce(jnp.logical_or, (_shift3(p, o) for o in offs))
        ero = functools.reduce(jnp.logical_and, (_shift3(dil, o) for o in offs))
    sl = tuple(slice(pad, -pad) for _ in range(3))
    return ero[sl]


def _segmented_min_scan(lab, reset, axis: int, reverse: bool):
    """Running minimum along `axis` that restarts at background voxels.

    Semiring scan: element = (reset_flag, value); combine keeps the right
    value at a reset, else the min — associative, so `lax.associative_scan`
    evaluates it in log depth."""

    def combine(a, b):
        fa, va = a
        fb, vb = b
        return jnp.logical_or(fa, fb), jnp.where(fb, vb, jnp.minimum(va, vb))

    _, vals = lax.associative_scan(combine, (reset, lab), axis=axis, reverse=reverse)
    return vals


def bidirectional_min_scan(lab, reset, axis: int):
    """One CCL line pass: min(forward scan, backward scan, lab) along
    `axis`. Every voxel of a foreground run ends up with the run's minimum
    label."""
    fwd = _segmented_min_scan(lab, reset, axis, reverse=False)
    bwd = _segmented_min_scan(lab, reset, axis, reverse=True)
    return jnp.minimum(jnp.minimum(fwd, bwd), lab)


def connected_components(mask, max_sweeps: int = 8):
    """6-connectivity CCL: label = min linear index over the component.

    Runs exactly `max_sweeps` rounds of bidirectional segmented min-scans
    along all three axes. Each sweep propagates labels along entire straight
    runs, so convergence needs only as many sweeps as the component's
    shortest paths turn corners — anatomical blobs/bodies settle in 2-4;
    sweeps past convergence are idempotent. A *fixed* `lax.scan` (not a
    convergence-tested while_loop) is deliberate: it is vmap-exact, avoids a
    full-volume reduction per sweep, and compiles to a static-shape program.
    Convergence is certified instead (see segment_volume's ccl_converged).
    Background voxels carry the sentinel int32 max.
    """
    labels, _ = _ccl_sweeps(_init_labels(mask), jnp.logical_not(mask), max_sweeps)
    return labels


def _init_labels(mask):
    # Raster order = (z, y, x) lexicographic, matching ITK's visiting order so
    # component ordering (min label) reproduces ITK label numbering.
    shape = mask.shape
    nx, ny, nz = shape
    gi = lax.broadcasted_iota(jnp.int32, shape, 0)
    gj = lax.broadcasted_iota(jnp.int32, shape, 1)
    gk = lax.broadcasted_iota(jnp.int32, shape, 2)
    lin = gk * (nx * ny) + gj * nx + gi
    return jnp.where(mask, lin, _BIG)


def _ccl_sweeps(lab0, reset, max_sweeps: int, passes: Optional[int] = None):
    """Fixed CCL sweep schedule; returns (labels, converged).

    Convergence is certified by the LOCAL-CONSISTENCY check, not an extra
    sweep: labels are monotone non-increasing member indices, so "every
    within-run adjacent pair equal" holds iff the labels are the exact CCL
    fixed point (uniformity on a component forces its minimum). That makes
    ANY half-sweep schedule valid. With `passes` set, the schedule
    alternates [yz, x, yz, ...] half-sweeps (the x pass must come between
    yz passes — cross-plane propagation in the middle is what makes the odd
    default work); `passes=None` keeps the classic per-sweep (x, y, z) axis
    order for max_sweeps callers."""

    def scan_axis(lab, axis):
        return bidirectional_min_scan(lab, reset, axis)

    if passes is None:
        def body(lab, _):
            for axis in (0, 1, 2):
                lab = scan_axis(lab, axis)
            return lab, None

        lab, _ = lax.scan(body, lab0, None, length=max_sweeps)
        return lab, _labels_consistent(lab, reset)

    def full_sweep(lab, _):
        lab = scan_axis(scan_axis(lab, 1), 2)  # yz half
        lab = scan_axis(lab, 0)  # x half
        return lab, None

    lab, _ = lax.scan(full_sweep, lab0, None, length=passes // 2)
    if passes % 2:
        lab = scan_axis(scan_axis(lab, 1), 2)
    return lab, _labels_consistent(lab, reset)


def _labels_consistent(lab, reset):
    """() bool: True iff every within-run adjacent label pair is equal along
    every axis — i.e. `lab` is the exact CCL fixed point."""
    fg = jnp.logical_not(reset)
    bad = jnp.zeros((), jnp.bool_)
    for axis in range(3):
        pair = jnp.logical_and(
            jnp.take(fg, jnp.arange(1, fg.shape[axis]), axis=axis),
            jnp.take(fg, jnp.arange(0, fg.shape[axis] - 1), axis=axis),
        )
        diff = jnp.take(lab, jnp.arange(1, lab.shape[axis]), axis=axis) != jnp.take(
            lab, jnp.arange(0, lab.shape[axis] - 1), axis=axis
        )
        bad = jnp.logical_or(bad, jnp.any(jnp.logical_and(pair, diff)))
    return jnp.logical_not(bad)


def component_stats_reference(flat_labels, roots, ny: int, nz: int, x_off=0):
    """(R, 4) [count, sum_i, sum_j, sum_k] of the voxels whose label equals
    each root. `flat_labels` is an (x, y, z) C-order volume flattened; i is
    offset by `x_off` (an x-shard's global offset, 0 on one device).

    The membership one-hot (chunk, R) is contracted with per-voxel features
    [1, i, j, k] chunk by chunk, so it never materializes at volume size (a
    full (n, R) f32 would be ~34 GB at 256^3). HIGHEST precision keeps the
    f32 contraction out of TF32."""
    n = flat_labels.shape[0]
    chunk = 1 << 15
    nchunks = -(-n // chunk)
    flat_padded = jnp.pad(flat_labels, (0, nchunks * chunk - n), constant_values=_BIG)

    def body(acc, c):
        start = c * chunk
        lab_c = lax.dynamic_slice(flat_padded, (start,), (chunk,))
        pos = start + jnp.arange(chunk, dtype=jnp.int32)
        gi = (pos // (ny * nz) + x_off).astype(jnp.float32)
        rem = pos % (ny * nz)
        gj = (rem // nz).astype(jnp.float32)
        gk = (rem % nz).astype(jnp.float32)
        feats = jnp.stack([jnp.ones(chunk, jnp.float32), gi, gj, gk], axis=-1)
        eq = (lab_c[:, None] == roots[None, :]).astype(jnp.float32)
        return acc + jnp.einsum("cr,cf->rf", eq, feats, precision=lax.Precision.HIGHEST), None

    stats, _ = lax.scan(body, jnp.zeros((roots.shape[0], 4), jnp.float32), jnp.arange(nchunks))
    return stats


def _component_stats(labels, max_roots: int, exhaustive: bool = False):
    """Counts and index-coordinate sums for up to `max_roots` components.

    A voxel is its component's *root* iff its label equals its own linear
    index. Candidate roots are the `max_roots` smallest (= ITK label order).

    Returns (roots, root_valid, counts, sums_ijk, num_components, count_ok,
    complete): `count_ok` is num_components <= max_roots; `complete` also
    requires that no candidate was lost to the blocked top_k. Callers
    escalate (larger max_roots, or exhaustive=True) when False.

    Works directly on the volume's native (x, y, z) C-order — the raster
    linear index each label encodes is recomputed arithmetically per voxel,
    so no full-volume transpose pass is needed."""
    shape = labels.shape
    nx, ny, nz = shape
    n = nx * ny * nz
    flat = labels.reshape(n)  # free: native C-order, no data movement
    # (z, y, x)-raster linear index of each flat position: flat position
    # f = k + nz*(j + ny*i)  ->  raster index = i + nx*(j + ny*k)
    f = jnp.arange(n, dtype=jnp.int32)
    gi = f // (ny * nz)
    rem = f - gi * (ny * nz)
    gj = rem // nz
    gk = rem - gj * nz
    lin = gi + nx * (gj + ny * gk)
    is_root = jnp.logical_and(flat == lin, flat != _BIG)
    num_components = jnp.sum(is_root, dtype=jnp.int32)
    count_ok = num_components <= max_roots
    complete = count_ok

    # smallest root indices first. Two-level (per-block then global) top_k
    # is cheaper than one flat top_k over the volume, and exact as long as
    # no block holds more than `per_block` roots — which is verified.
    root_keys = jnp.where(is_root, -lin, -_BIG)
    if n >= (1 << 20) and not exhaustive:
        nblocks = 2048
        per_block = min(max_roots, 64)
        pad = (-n) % nblocks
        if pad:
            root_keys = jnp.pad(root_keys, (0, pad), constant_values=-_BIG)
            is_root_b = jnp.pad(is_root, (0, pad), constant_values=False)
        else:
            is_root_b = is_root
        block_counts = jnp.sum(is_root_b.reshape(nblocks, -1), axis=1)
        complete = jnp.logical_and(complete, jnp.all(block_counts <= per_block))
        blk, _ = lax.top_k(root_keys.reshape(nblocks, -1), per_block)
        keys, _ = lax.top_k(blk.reshape(-1), max_roots)
    else:
        keys, _ = lax.top_k(root_keys, max_roots)
    roots = -keys  # (R,) root linear indices; _BIG where no component
    root_valid = roots != _BIG

    stats = component_stats_reference(flat, roots, ny, nz)
    counts = stats[:, 0]
    sums_ijk = stats[:, 1:4]
    return roots, root_valid, counts, sums_ijk, num_components, count_ok, complete


def _validate_thresholds(params: SegmentationParams):
    if not (math.isfinite(params.intensity_low) and math.isfinite(params.intensity_high)):
        raise ValueError("intensity thresholds must be finite")


def segment_volume(data, spacing, origin, params: SegmentationParams = SegmentationParams()):
    """Full fiducial + body segmentation of one volume. jit/vmap-compatible.

    Args:
      data: (nx, ny, nz) f32 intensities.
      spacing, origin: (3,) LPS geometry.
    Returns a SegmentationResult with static shapes.
    """
    _validate_thresholds(params)
    data = jnp.asarray(data)
    if data.dtype != jnp.float32:
        # Accept scanner-native integer volumes (Volume preserves int8/16):
        # the cast runs ON DEVICE, fused into the threshold, so callers ship
        # compact dtypes over the host->device link.
        data = data.astype(jnp.float32)
    spacing = jnp.asarray(spacing, dtype=jnp.float32)
    origin = jnp.asarray(origin, dtype=jnp.float32)

    mask = jnp.logical_and(data >= params.intensity_low, data <= params.intensity_high)
    closed = binary_close(mask, params.closing_radius)
    labels, converged = _ccl_sweeps(
        _init_labels(closed), jnp.logical_not(closed), params.max_sweeps, passes=params.passes
    )
    roots, root_valid, counts, sums_ijk, num_components, count_ok, complete = _component_stats(
        labels, params.max_roots, exhaustive=params.exhaustive_roots
    )
    return finalize_segmentation(
        labels, roots, root_valid, counts, sums_ijk, num_components, complete,
        converged, spacing, origin, params, count_ok=count_ok,
    )


def finalize_segmentation(
    labels, roots, root_valid, counts, sums_ijk, num_components, complete,
    converged, spacing, origin, params: SegmentationParams, count_ok=None,
) -> SegmentationResult:
    """Blob-band selection + body extraction from per-component stats.

    Shared tail of `segment_volume` and the shard_map'd sharded path
    (parallel/shard_seg.py): stats arrays are replicated/global; `labels`
    may be the local shard (body_mask then stays sharded)."""
    voxvol = spacing[0] * spacing[1] * spacing[2]
    vols = counts * voxvol
    in_band = jnp.logical_and(
        root_valid,
        jnp.logical_and(vols >= params.min_volume_mm3, vols <= params.max_volume_mm3),
    )

    # fiducial blobs: smallest-root-first among in-band components
    num_in_band = jnp.sum(in_band, dtype=jnp.int32)
    blobs_complete = num_in_band <= params.max_blobs
    blob_keys = jnp.where(in_band, -roots, -_BIG)
    bkeys, bidx = lax.top_k(blob_keys, params.max_blobs)
    blob_valid = bkeys != -_BIG
    blob_counts = counts[bidx]
    blob_vols = vols[bidx]
    centroid_idx = sums_ijk[bidx] / jnp.maximum(blob_counts[:, None], 1.0)
    centroid_lps = origin[None, :] + spacing[None, :] * centroid_idx
    centroid_ras = centroid_lps * jnp.asarray([-1.0, -1.0, 1.0], dtype=jnp.float32)
    centroid_ras = jnp.where(blob_valid[:, None], centroid_ras, 0.0)
    blob_vols = jnp.where(blob_valid, blob_vols, 0.0)
    num_blobs = jnp.sum(blob_valid, dtype=jnp.int32)

    # body: largest component outside the fiducial band (Mamri.py:1320-1322)
    body_candidates = jnp.logical_and(root_valid, jnp.logical_not(in_band))
    body_counts = jnp.where(body_candidates, counts, -1.0)
    body_slot = jnp.argmax(body_counts)
    body_found = body_counts[body_slot] > 0
    body_root = jnp.where(body_found, roots[body_slot], jnp.int32(-1))
    body_mask = labels == body_root
    body_volume = jnp.where(body_found, counts[body_slot] * voxvol, 0.0)

    return SegmentationResult(
        centroids_ras=centroid_ras,
        volumes_mm3=blob_vols,
        blob_valid=blob_valid,
        num_blobs=num_blobs,
        body_mask=body_mask,
        body_volume_mm3=body_volume,
        body_found=body_found,
        num_components=num_components,
        labels=labels,
        ccl_converged=converged,
        roots_complete=complete,
        blobs_complete=blobs_complete,
        # the sharded path selects roots exactly, so its only completeness
        # budget is the count
        count_ok=complete if count_ok is None else count_ok,
    )
