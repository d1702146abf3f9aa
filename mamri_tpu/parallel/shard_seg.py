"""shard_map'd spatially-sharded segmentation (the sp mesh axis).

The volume's x extent is sharded over the `sp` mesh axis; the single-device
segmentation runs shard-locally and every cross-shard interaction is an
explicit collective:

  * threshold + ball closing: a 2*radius-plane x-halo of the MASK is
    exchanged via `lax.ppermute` (global edges receive background,
    identical to `binary_close`'s constant-False padding);
  * CCL sweeps follow the single-device half-sweep schedule ([yz, x, yz,
    ...] when `params.passes` is set, classic full sweeps otherwise). The
    y/z line passes are shard-local. The x pass runs local directional scans,
    one `all_gather` of each shard's per-line fold summaries, a static
    prefix-combine over the shard ring, and a local apply. The combine is
    associative, so the result is bit-identical to the unsharded x pass;
  * the local-consistency convergence certificate runs shard-locally;
    shard-boundary label pairs are checked with one ppermute'd edge plane,
    and `psum` makes the certificate GLOBAL — so any half-sweep schedule is
    legitimized exactly as on one device, and the engine's passes-doubling
    escalation strengthens the sharded path too;
  * component stats: local exact top-k roots merged by `all_gather`, then
    the chunked one-hot contraction over the local shard with global i
    coordinates, `psum`'d.

Everything downstream of the (R, 4) stats is replicated arithmetic (the
same `finalize_segmentation` tail as the single-device path); the big arrays
(labels, body_mask) stay sharded.

Replaces: reference's single-process SimpleITK pipeline
(Mamri/Mamri.py:1306-1341) — which has no distributed story at all.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from mamri_tpu.perception.segmentation import (
    _BIG,
    SegmentationParams,
    SegmentationResult,
    _labels_consistent,
    _segmented_min_scan,
    _validate_thresholds,
    binary_close,
    bidirectional_min_scan,
    component_stats_reference,
    finalize_segmentation,
    segment_volume,
)


def _ring_perms(n_sp: int):
    fwd = [(i, i + 1) for i in range(n_sp - 1)]  # to the right neighbor
    bwd = [(i + 1, i) for i in range(n_sp - 1)]  # to the left neighbor
    return fwd, bwd


# ----------------------------------------------------------------- closing
def _closed_mask_sharded(data, thr_lo, thr_hi, radius: int, axis_name: str):
    """Threshold + ball closing on an x-sharded volume, exact via halo
    exchange. `data` is the local (nxl, ny, nz) shard."""
    mask = jnp.logical_and(data >= thr_lo, data <= thr_hi)
    if radius <= 0:
        return mask
    h = 2 * radius
    if mask.shape[0] < h:
        raise ValueError(
            f"shard width {mask.shape[0]} is thinner than the closing halo "
            f"{h}: use fewer sp shards or a smaller closing radius"
        )
    # send my trailing h planes right / leading h planes left; global edges
    # get zeros (= background), identical to constant-False padding
    n_sp = lax.axis_size(axis_name)
    fwd, bwd = _ring_perms(n_sp)
    left_halo = lax.ppermute(mask[-h:], axis_name, perm=fwd)  # from left neighbor
    right_halo = lax.ppermute(mask[:h], axis_name, perm=bwd)  # from right neighbor
    ext = jnp.concatenate([left_halo, mask, right_halo], axis=0)
    closed = binary_close(ext, radius)
    return closed[h : h + mask.shape[0]]


# ----------------------------------------------------------------- scans
def _prefix_combine(f_all, v_all, reverse: bool):
    """Static prefix-combine of per-shard (any-reset, boundary-run value)
    summaries over the shard ring; returns the per-shard INCOMING value
    (the scan state just before this shard). The combine
        (f, v) . (f_t, v_t) = (f | f_t, v_t if f_t else min(v, v_t))
    is associative — the textbook Blelloch decomposition lifted to the mesh.
    """
    n_sp = f_all.shape[0]
    runv = jnp.full_like(v_all[0], _BIG)
    pref_v = [None] * n_sp
    order = range(n_sp) if not reverse else range(n_sp - 1, -1, -1)
    for t in order:
        pref_v[t] = runv
        runv = jnp.where(f_all[t], v_all[t], jnp.minimum(runv, v_all[t]))
    return jnp.stack(pref_v)


def _global_x_scan(lab, reset, axis_name: str, reverse: bool):
    """Exact inclusive segmented min-scan along the SHARDED x axis.

    Local directional scan, then one all_gather of the (ny, nz) per-line fold
    summaries, a static prefix-combine over shard order, and a local apply:
        out(i) = v_loc(i)                if a reset precedes i locally
               = min(v_in, v_loc(i))     otherwise
    which is exactly combine((f_in, v_in), (f_loc(i), v_loc(i))).
    """
    f_loc = lax.associative_scan(jnp.logical_or, reset, axis=0, reverse=reverse)
    v_loc = _segmented_min_scan(lab, reset, 0, reverse)
    edge = 0 if reverse else -1
    f_all = lax.all_gather(f_loc[edge], axis_name)  # (S, ny, nz)
    v_all = lax.all_gather(v_loc[edge], axis_name)
    pv = _prefix_combine(f_all, v_all, reverse)
    me = lax.axis_index(axis_name)
    v_in = pv[me]
    return jnp.where(f_loc, v_loc, jnp.minimum(v_in[None, :, :], v_loc))


def _boundary_bad(lab, fg, axis_name: str):
    """() int32: 1 iff any shard-boundary x-neighbor pair is foreground on
    both sides with differing labels (the cross-shard part of the
    local-consistency certificate). Uses one ppermute of the right
    neighbor's first plane; the last shard receives zeros (fg=False)."""
    n_sp = lax.axis_size(axis_name)
    _, bwd = _ring_perms(n_sp)
    nb_lab = lax.ppermute(lab[:1], axis_name, perm=bwd)[0]
    nb_fg = lax.ppermute(fg[:1].astype(jnp.int32), axis_name, perm=bwd)[0]
    bad = jnp.any(
        jnp.logical_and(
            jnp.logical_and(fg[-1], nb_fg == 1), lab[-1] != nb_lab
        )
    )
    return bad.astype(jnp.int32)


# ----------------------------------------------------------------- sweeps
def _ccl_sweeps_sharded(lab0, reset, params: SegmentationParams, axis_name: str):
    """CCL sweeps on the x-sharded labels, honoring the same half-sweep
    `passes` schedule as the single-device path; `converged` is the GLOBAL
    local-consistency certificate (valid for ANY schedule), so the engine's
    passes-doubling escalation strengthens this path too."""

    def yz_half(lab):
        return bidirectional_min_scan(bidirectional_min_scan(lab, reset, 1), reset, 2)

    def x_half(lab):
        fwd = _global_x_scan(lab, reset, axis_name, reverse=False)
        bwd = _global_x_scan(lab, reset, axis_name, reverse=True)
        return jnp.minimum(jnp.minimum(fwd, bwd), lab)

    def sweep(lab, _):
        lab = x_half(yz_half(lab))
        return lab, None

    passes = params.passes
    if passes is None:
        lab, _ = lax.scan(sweep, lab0, None, length=params.max_sweeps)
    else:
        lab, _ = lax.scan(sweep, lab0, None, length=passes // 2)
        if passes % 2:
            lab = yz_half(lab)

    # GLOBAL certificate: local within-run adjacent equality on all three
    # axes (axis-0 pairs within the shard) + the shard-boundary pairs
    bad = jnp.logical_not(_labels_consistent(lab, reset)).astype(jnp.int32)
    bad = jnp.maximum(bad, _boundary_bad(lab, jnp.logical_not(reset), axis_name))
    return lab, lax.psum(bad, axis_name) == 0


def segment_volume_sharded(
    data,
    spacing,
    origin,
    params: SegmentationParams = SegmentationParams(),
    axis_name: str = "sp",
) -> SegmentationResult:
    """`segment_volume` for one x-shard of a volume, called INSIDE shard_map.

    `data` is the local (nx/S, ny, nz) shard; the global volume is the
    concatenation along x in mesh order. Returns a SegmentationResult whose
    `labels`/`body_mask` are the local shards and everything else is
    replicated (identical on every shard). Certificates (`ccl_converged`,
    `roots_complete`, `blobs_complete`) are global, so the engine's
    escalation reruns apply. Results are bit-identical to `segment_volume`
    on the whole volume.
    """
    _validate_thresholds(params)
    if lax.axis_size(axis_name) == 1:
        # dp-only meshes (sp=1): the axis size is STATIC under shard_map, so
        # skip the halo concat and x-prefix fix that would degenerate to
        # copies, and run the single-device pipeline (bit-identical)
        return segment_volume(data, spacing, origin, params)
    data = jnp.asarray(data)
    if data.dtype != jnp.float32:
        # scanner-native integer shards: cast on device, shard-locally
        data = data.astype(jnp.float32)
    spacing = jnp.asarray(spacing, dtype=jnp.float32)
    origin = jnp.asarray(origin, dtype=jnp.float32)

    nxl, ny, nz = data.shape
    n_sp = lax.axis_size(axis_name)
    nx = n_sp * nxl
    me = lax.axis_index(axis_name)
    x_off = me * nxl

    closed = _closed_mask_sharded(
        data, params.intensity_low, params.intensity_high, params.closing_radius, axis_name
    )

    # labels: GLOBAL (z, y, x)-raster linear index (ITK label-order parity)
    gi = lax.broadcasted_iota(jnp.int32, closed.shape, 0) + x_off
    gj = lax.broadcasted_iota(jnp.int32, closed.shape, 1)
    gk = lax.broadcasted_iota(jnp.int32, closed.shape, 2)
    lin = gk * (nx * ny) + gj * nx + gi
    lab0 = jnp.where(closed, lin, _BIG)
    reset = jnp.logical_not(closed)

    labels, converged = _ccl_sweeps_sharded(lab0, reset, params, axis_name)

    # roots: local exact top-k, merged across shards
    is_root = jnp.logical_and(labels == lin, labels != _BIG)
    num_components = lax.psum(jnp.sum(is_root, dtype=jnp.int32), axis_name)
    complete = num_components <= params.max_roots
    keys_local = jnp.where(is_root, -lin, -_BIG).reshape(-1)
    loc_keys, _ = lax.top_k(keys_local, min(params.max_roots, keys_local.shape[0]))
    all_keys = lax.all_gather(loc_keys, axis_name).reshape(-1)
    keys, _ = lax.top_k(all_keys, min(params.max_roots, all_keys.shape[0]))
    roots = -keys
    if roots.shape[0] < params.max_roots:
        roots = jnp.pad(roots, (0, params.max_roots - roots.shape[0]), constant_values=_BIG)
    root_valid = roots != _BIG

    stats = component_stats_reference(labels.reshape(-1), roots, ny, nz, x_off=x_off)
    stats = lax.psum(stats, axis_name)
    counts = stats[:, 0]
    sums_ijk = stats[:, 1:4]

    return finalize_segmentation(
        labels, roots, root_valid, counts, sums_ijk, num_components, complete,
        converged, spacing, origin, params,
    )


def shard_spec_volume(sp_axis: str) -> P:
    """PartitionSpec of an x-sharded (nx, ny, nz) volume."""
    return P(sp_axis)
