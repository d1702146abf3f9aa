"""Device-mesh scaling of the pose-estimation pipeline.

The reference is strictly single-process/single-volume (SURVEY.md §2.3: no
distributed layer exists). This package scales along the two axes the
workload actually has:

  dp — data parallel over volumes: volumes are independent, so each device
       runs the vmapped fused pipeline on its slice of the batch.
  sp — spatial parallel over the volume's x extent, for single-scan
       latency: the segmentation stage exchanges closing halos, CCL
       x-scan summaries and stats explicitly (parallel/shard_seg.py).

Both run under one `shard_map` (manual SPMD) program. The mesh follows the
algorithm alone: the cards of one host reach each other all to all.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    n_devices: Optional[int] = None,
    axes: Tuple[str, ...] = ("dp",),
    shape: Optional[Tuple[int, ...]] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a mesh over the first n devices. With two axes and no explicit
    shape, devices split evenly favoring dp. Fails loudly when the default
    platform has fewer than n devices — virtual-mesh validation must provision
    CPU devices explicitly (XLA_FLAGS --xla_force_host_platform_device_count
    before backend init + jax.config.update("jax_platforms", "cpu"); see
    __graft_entry__._provision_cpu_mesh) rather than rely on a silent
    fallback that leaves eager inputs on the default platform."""
    if devices is None:
        devices = jax.devices()
    n = len(devices) if n_devices is None else n_devices
    if len(devices) < n:
        raise ValueError(
            f"need {n} devices, have {len(devices)} on platform "
            f"'{jax.default_backend()}'. For virtual multi-chip validation, "
            "provision host devices before JAX backend init (XLA_FLAGS "
            f"--xla_force_host_platform_device_count={n} and "
            "jax.config.update('jax_platforms', 'cpu'))."
        )
    devices = np.asarray(devices[:n])
    if shape is None:
        if len(axes) == 1:
            shape = (n,)
        elif len(axes) == 2:
            dp = 1
            for cand in range(int(np.sqrt(n)), 0, -1):
                if n % cand == 0:
                    dp = cand
                    break
            shape = (dp, n // dp)
        else:
            raise ValueError("give an explicit shape for >2 mesh axes")
    return Mesh(devices.reshape(shape), axes)


def batch_sharding(mesh: Mesh, dp_axis: str = "dp", sp_axis: Optional[str] = None) -> NamedSharding:
    """Sharding for a (B, nx, ny, nz) volume batch: batch over dp, optionally
    the volume x extent over sp."""
    if sp_axis is None:
        return NamedSharding(mesh, P(dp_axis))
    return NamedSharding(mesh, P(dp_axis, sp_axis))


_OUT_KEYS = (
    "success", "angles", "steps", "rmse", "base_tf", "base_ok", "base_source",
    "markers_found", "num_blobs", "body_found", "num_components",
    "seg_converged", "roots_complete", "blobs_complete",
    "seg_count_ok",
)


def sharded_batched_pipeline(
    engine,
    mesh: Mesh,
    dp_axis: str = "dp",
    sp_axis: Optional[str] = None,
    seg_params=None,
    microbatch: Optional[int] = None,
):
    """jit the engine's fused batched pipeline with mesh shardings.

    Returns fn(data_batch, spacing, origin, apply_correction) -> dict of
    sharded outputs (per-volume results sharded over dp). The batch size must
    be a multiple of the dp axis (and nx of the sp axis when spatial sharding
    is on). `seg_params` overrides the engine's segmentation settings (the
    escalation driver `run_sharded_batched` re-builds with stronger params).

    `microbatch` bounds the per-device segmentation workspace exactly like
    `estimate_pose_batch`'s: the program runs the GLOBAL batch in
    `microbatch`-sized chunks via `lax.map` (each chunk still sharded over
    dp, i.e. microbatch/dp volumes resident per device at a time). Must be a
    multiple of the dp extent and divide the batch size.

    The whole pipeline runs under `shard_map` over (dp, sp). With sp, the
    segmentation stage is `segment_volume_sharded` (parallel/shard_seg.py):
    explicit ppermute mask halos for the closing, an all_gather'd
    boundary-run prefix for the cross-shard x scans, and psum'd
    stats/certificates. Without sp, each device runs the single-device
    pipeline on its slice of the batch.
    """
    nj = engine.model.num_joints
    dp = mesh.shape[dp_axis]
    if microbatch is not None and (microbatch < 1 or microbatch % dp):
        raise ValueError(
            f"microbatch {microbatch} must be a positive multiple of the dp extent {dp}"
        )

    seg_fn = None
    if sp_axis is not None:
        from mamri_tpu.parallel.shard_seg import segment_volume_sharded

        def seg_fn(data, spacing, origin, params):
            return segment_volume_sharded(data, spacing, origin, params, axis_name=sp_axis)

    pipeline = engine.pipeline_fn(seg_params, seg_fn=seg_fn)
    mb_local = None if microbatch is None else microbatch // dp

    def local_fn(data, spacing, origin, apply_correction):
        # data: (B/dp, nx/sp, ny, nz) local block; collectives ride sp only
        def one(d):
            out = pipeline(
                d,
                spacing,
                origin,
                jnp.eye(4, dtype=jnp.float32),
                jnp.asarray(False),
                jnp.asarray(False),
                apply_correction,
                jnp.zeros(nj, dtype=jnp.float32),
            )
            out.pop("body_mask")  # stays device-side; per-volume results only
            return out

        lb = data.shape[0]
        if mb_local is None or mb_local >= lb:
            return jax.vmap(one)(data)
        if lb % mb_local:
            raise ValueError(
                f"microbatch {microbatch} must divide the local batch {lb} (x dp {dp})"
            )
        chunks = data.reshape((lb // mb_local, mb_local) + data.shape[1:])
        out = jax.lax.map(lambda d: jax.vmap(one)(d), chunks)
        return jax.tree.map(lambda x: x.reshape((lb,) + x.shape[2:]), out)

    shmapped = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(dp_axis, sp_axis), P(), P(), P()),
        out_specs={k: P(dp_axis) for k in _OUT_KEYS},
        check_vma=False,  # outputs are replicated over sp by construction
    )
    return jax.jit(shmapped)


def run_sharded_batched(
    engine,
    mesh: Mesh,
    data_batch,
    spacing,
    origin,
    apply_correction: bool = False,
    dp_axis: str = "dp",
    sp_axis: Optional[str] = None,
    microbatch: Optional[int] = None,
    _fn_cache: Optional[dict] = None,
):
    """Execute the mesh-sharded batched pipeline WITH the engine's
    certificate->escalate->rerun loop (the same semantics `estimate_pose`
    has single-chip): an uncertified segmentation (ccl_converged /
    roots_complete / blobs_complete) re-runs at escalated settings until
    every volume certifies or the budgets cap out.

    Escalation is PER VOLUME, like `estimate_pose_batch`: only the failing
    volumes re-run, compacted into a sub-batch padded to dp x power-of-two
    (bounded compile-shape set, dp-divisible), and the results scatter back —
    volumes certified on the first pass keep their first-pass results, and
    one noisy scan in a 64-volume mesh batch costs escalated work for itself
    only. `microbatch` chunks the first pass (see `sharded_batched_pipeline`);
    escalation sub-batches are small and never chunked.

    Returns (outputs dict of host arrays, final SegmentationParams,
    certified: bool). Compiled programs are cached per params in `_fn_cache`
    (pass a dict to keep it across calls).
    """
    import logging

    logger = logging.getLogger(__name__)
    cache = _fn_cache if _fn_cache is not None else {}
    params = engine.seg_params
    dp = mesh.shape[dp_axis]
    batch_size = int(np.shape(data_batch)[0])
    data_np = None  # host copy made lazily, only if an escalation rerun
    # needs fancy-indexed sub-batches — the certified-first-pass common case
    # must not round-trip a device batch through the host

    def get_fn(p, mb):
        key = (p, dp_axis, sp_axis, mb)
        if key not in cache:
            cache[key] = sharded_batched_pipeline(
                engine, mesh, dp_axis=dp_axis, sp_axis=sp_axis, seg_params=p,
                microbatch=mb,
            )
        return cache[key]

    out = get_fn(params, microbatch)(
        # straight onto the mesh: each device receives only its own slice
        jax.device_put(data_batch, batch_sharding(mesh, dp_axis, sp_axis)),
        jnp.asarray(spacing),
        jnp.asarray(origin),
        jnp.asarray(apply_correction),
    )
    # np.array (copy): device_get views are read-only and the escalation
    # loop scatters sub-batch results back in place
    out = {k: np.array(v) for k, v in jax.device_get(out).items()}
    certified = out["seg_converged"] & out["roots_complete"] & out["blobs_complete"]
    while not certified.all():
        fail = np.nonzero(~certified)[0]
        stronger = engine._escalate_seg_params(
            params,
            bool(out["seg_converged"][fail].all()),
            bool(out["roots_complete"][fail].all()),
            bool(out["blobs_complete"][fail].all()),
            count_ok=bool(out["seg_count_ok"][fail].all()),
        )
        if stronger is None:
            logger.warning(
                "mesh-batched segmentation uncertified at strongest settings "
                "for volumes %s", fail.tolist(),
            )
            return out, params, False
        if data_np is None:
            data_np = np.asarray(data_batch)
        # compact the failures and pad with repeats of the first failure to a
        # power-of-two group count (bounded compile-shape set). The padding
        # unit — and the rerun's chunking — honor the caller's `microbatch`
        # memory bound: escalated settings need MORE workspace than the first
        # pass that already required chunking, so running the rerun fully
        # resident would OOM exactly the workloads microbatch protects.
        unit = microbatch if microbatch is not None else dp
        groups = -(-len(fail) // unit)
        n_pad = unit * (1 if groups <= 1 else 1 << (groups - 1).bit_length())
        mb = microbatch if (microbatch is not None and n_pad > microbatch) else None
        sel = np.concatenate([fail, np.full(n_pad - len(fail), fail[0], fail.dtype)])
        logger.warning(
            "mesh-batched segmentation escalation for %d/%d volumes -> "
            "passes=%s max_sweeps=%d max_roots=%d max_blobs=%d exhaustive=%s",
            len(fail), batch_size, stronger.passes, stronger.max_sweeps,
            stronger.max_roots, stronger.max_blobs, stronger.exhaustive_roots,
        )
        sub = get_fn(stronger, mb)(
            jax.device_put(data_np[sel], batch_sharding(mesh, dp_axis, sp_axis)),
            jnp.asarray(spacing),
            jnp.asarray(origin),
            jnp.asarray(apply_correction),
        )
        sub = {k: np.asarray(v) for k, v in jax.device_get(sub).items()}
        for k, v in out.items():
            v[fail] = sub[k][: len(fail)]
        certified[fail] = (
            sub["seg_converged"] & sub["roots_complete"] & sub["blobs_complete"]
        )[: len(fail)]
        params = stronger
    return out, params, True
