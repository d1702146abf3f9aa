"""shard_map'd spatially-sharded segmentation: bit-exact parity with the
single-device path on the virtual 8-CPU mesh (VERDICT r1 item 7).

The sharded path exchanges closing halos with ppermute, decomposes the CCL
x-scans into local scans + an all_gather'd summary prefix, and psums the
component stats — all of which must reproduce `segment_volume` exactly,
including labels, certificates, and ITK-order blob numbering."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from mamri_tpu.parallel.shard_seg import segment_volume_sharded
from mamri_tpu.perception.segmentation import (
    SegmentationParams,
    SegmentationResult,
    segment_volume,
)
from mamri_tpu.perception.volume import synthetic_volume


def _mesh(n=8, axis="sp"):
    return Mesh(np.asarray(jax.devices()[:n]), (axis,))


def _run_sharded(vol, params, n_shards=8):
    mesh = _mesh(n_shards)

    def fn(data, spacing, origin):
        return segment_volume_sharded(data, spacing, origin, params, axis_name="sp")

    shmapped = jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(P("sp"), P(), P()),
        out_specs=SegmentationResult(
            centroids_ras=P(),
            volumes_mm3=P(),
            blob_valid=P(),
            num_blobs=P(),
            body_mask=P("sp"),
            body_volume_mm3=P(),
            body_found=P(),
            num_components=P(),
            labels=P("sp"),
            ccl_converged=P(),
            roots_complete=P(),
            blobs_complete=P(),
            count_ok=P(),
        ),
        check_vma=False,
    )
    return jax.jit(shmapped)(
        jnp.asarray(vol.data), jnp.asarray(vol.spacing), jnp.asarray(vol.origin)
    )


def _assert_parity(got, ref):
    np.testing.assert_array_equal(np.asarray(got.labels), np.asarray(ref.labels))
    np.testing.assert_array_equal(np.asarray(got.body_mask), np.asarray(ref.body_mask))
    np.testing.assert_allclose(np.asarray(got.centroids_ras), np.asarray(ref.centroids_ras), atol=1e-4)
    np.testing.assert_allclose(np.asarray(got.volumes_mm3), np.asarray(ref.volumes_mm3), rtol=1e-6)
    assert int(got.num_blobs) == int(ref.num_blobs)
    assert int(got.num_components) == int(ref.num_components)
    assert bool(got.body_found) == bool(ref.body_found)
    assert bool(got.ccl_converged) and bool(ref.ccl_converged)
    assert bool(got.roots_complete) and bool(ref.roots_complete)
    assert bool(got.blobs_complete) == bool(ref.blobs_complete)


@pytest.fixture(scope="module")
def scene_vol():
    # fiducial-sized spheres + a body ellipsoid, nx divisible by 8
    rng = np.random.default_rng(5)
    pts = np.stack(
        [
            rng.uniform(-60, 60, 12),
            rng.uniform(-60, 60, 12),
            rng.uniform(20, 100, 12),
        ],
        axis=1,
    ).astype(np.float32)
    vol = synthetic_volume(
        shape=(64, 48, 56),
        spacing=np.array([2.5, 2.5, 2.5], np.float32),
        origin=np.array([-80.0, -80.0, -10.0], np.float32),
        fiducials_ras=pts,
        fiducial_radius_mm=4.0,
        body_center_ras=[0.0, 0.0, 60.0],
        body_radii_mm=[35.0, 40.0, 45.0],
    )
    return vol


def test_sharded_matches_single_device(scene_vol):
    params = SegmentationParams(max_sweeps=8)
    ref = segment_volume(scene_vol.data, scene_vol.spacing, scene_vol.origin, params)
    got = _run_sharded(scene_vol, params)
    _assert_parity(got, ref)


def test_sharded_pallas_kernel_in_shard_map(scene_vol):
    """The classic full-sweep schedule (max_sweeps=6, y/z line passes
    shard-local, x passes across shards) inside shard_map, bit-exact with
    the single-device path."""
    params = SegmentationParams(max_sweeps=6)
    ref = segment_volume(scene_vol.data, scene_vol.spacing, scene_vol.origin, params)
    got = _run_sharded(scene_vol, params)
    _assert_parity(got, ref)


def test_sharded_int16_input_bit_identical(scene_vol):
    """Scanner-native int16 shards segment bit-identically: the cast to f32
    happens shard-locally on device (segment_volume_sharded), so compact
    frames ride the same halved-H2D path as the single-chip pipeline."""
    params = SegmentationParams(max_sweeps=8)
    ref = segment_volume(scene_vol.data, scene_vol.spacing, scene_vol.origin, params)
    assert np.array_equal(scene_vol.data, scene_vol.data.astype(np.int16))
    vol16 = type(scene_vol)(
        scene_vol.data.astype(np.int16), scene_vol.spacing, scene_vol.origin
    )
    assert vol16.data.dtype == np.int16
    got = _run_sharded(vol16, params)
    _assert_parity(got, ref)


def test_component_spanning_all_shards():
    """A bar along the full x extent crosses every shard boundary: the
    cross-shard summary-prefix scan must merge it into ONE component."""
    data = np.zeros((64, 16, 136), np.float32)
    data[:, 6:9, 6:9] = 100.0  # full-length bar
    data[10:12, 12:14, 100:102] = 100.0  # a small separate blob
    vol_spacing = np.array([1.0, 2.0, 1.5], np.float32)
    origin = np.zeros(3, np.float32)
    params = SegmentationParams(max_sweeps=8, min_volume_mm3=2.0, max_volume_mm3=50.0)
    ref = segment_volume(data, vol_spacing, origin, params)

    class V:
        pass

    v = V()
    v.data, v.spacing, v.origin = data, vol_spacing, origin
    got = _run_sharded(v, params)
    _assert_parity(got, ref)
    assert int(got.num_components) == 2
    # the bar is the "body" (outside the fiducial volume band)
    assert bool(got.body_found)
    np.testing.assert_array_equal(np.asarray(got.body_mask), np.asarray(ref.body_mask))


def test_closing_halo_exactness():
    """Structures hugging a shard boundary: the ppermute'd 4-plane halo must
    reproduce binary_close exactly (a blob split across shards 3|4 of 8)."""
    data = np.zeros((64, 24, 136), np.float32)
    # blob straddling x=24 (the 8-shard boundary at 64/8*3)
    data[22:27, 8:13, 60:65] = 100.0
    # thin gap that closing bridges, also across a boundary
    data[30:32, 8:11, 10:13] = 100.0
    data[33:35, 8:11, 10:13] = 100.0  # 1-voxel gap at x=32 (boundary 4|5)
    spacing = np.ones(3, np.float32)
    origin = np.zeros(3, np.float32)
    params = SegmentationParams(max_sweeps=8, min_volume_mm3=1.0, max_volume_mm3=1e5)
    ref = segment_volume(data, spacing, origin, params)

    class V:
        pass

    v = V()
    v.data, v.spacing, v.origin = data, spacing, origin
    got = _run_sharded(v, params)
    _assert_parity(got, ref)
    assert int(ref.num_components) == 2  # the gap was bridged by closing


def test_sharded_fast_kernel_pipeline_parity(scene_vol):
    """The half-sweep schedule on the sp axis (mask halo, local y/z passes,
    cross-shard x scans, global certificate, psum'd stats): bit-exact vs
    segment_volume on the [yz, x, yz, x, yz] schedule (this random scene
    needs 5 half-sweeps to certify)."""
    params = SegmentationParams(max_sweeps=2, passes=5)
    ref = segment_volume(scene_vol.data, scene_vol.spacing, scene_vol.origin, params)
    got = _run_sharded(scene_vol, params)
    _assert_parity(got, ref)


def test_sharded_fast_component_spanning_all_shards():
    """A bar along the full x extent on the [yz, x, yz] schedule: the
    cross-shard prefix must merge it into ONE component, bit-exactly."""
    data = np.zeros((64, 16, 136), np.float32)
    data[:, 6:9, 6:9] = 100.0  # full-length bar
    data[10:12, 12:14, 100:102] = 100.0  # a small separate blob
    spacing = np.array([1.0, 2.0, 1.5], np.float32)
    origin = np.zeros(3, np.float32)
    params = SegmentationParams(
        passes=3, max_sweeps=2, min_volume_mm3=2.0, max_volume_mm3=50.0
    )
    ref = segment_volume(data, spacing, origin, params)

    class V:
        pass

    v = V()
    v.data, v.spacing, v.origin = data, spacing, origin
    got = _run_sharded(v, params)
    _assert_parity(got, ref)
    assert int(got.num_components) == 2
    assert bool(got.body_found)


def test_sharded_fast_passes_escalation_certifies():
    """A starved half-sweep schedule must FAIL the global consistency
    certificate on a corner-heavy sharded scene, and honoring an escalated
    `passes` (the engine doubles it) must converge — the certificate path
    the engine's escalation loop relies on (ADVICE r2: the sharded path
    previously ignored params.passes entirely)."""
    rng = np.random.default_rng(3)
    # a dense random maze of corridors: many corners -> needs several sweeps
    data = np.zeros((64, 40, 136), np.float32)
    occ = rng.random((32, 20, 68)) < 0.62
    data[::2, ::2, ::2] = np.where(occ, 100.0, 0.0)
    data[1::2, ::2, ::2] = np.where(occ, 100.0, 0.0)  # connect x pairs
    spacing = np.ones(3, np.float32)
    origin = np.zeros(3, np.float32)

    class V:
        pass

    v = V()
    v.data, v.spacing, v.origin = data, spacing, origin

    starved = SegmentationParams(passes=1, max_sweeps=1, max_roots=2048)
    got1 = _run_sharded(v, starved)
    assert not bool(got1.ccl_converged)

    for p in (2, 4, 8, 16, 32):
        got = _run_sharded(v, starved._replace(passes=p))
        if bool(got.ccl_converged):
            break
    assert bool(got.ccl_converged), "escalated passes never certified"
    ref = segment_volume(
        data, spacing, origin, starved._replace(passes=p)
    )
    assert bool(ref.ccl_converged)
    np.testing.assert_array_equal(np.asarray(got.labels), np.asarray(ref.labels))
    assert int(got.num_components) == int(ref.num_components)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_fast_pipeline_other_shard_counts(scene_vol, n_shards):
    """Shard-count robustness: the halo exchange, x-prefix fix and
    certificate collectives must be exact for any mesh size, not just the
    8-way mesh the other tests pin."""
    params = SegmentationParams(max_sweeps=2, passes=5)
    ref = segment_volume(scene_vol.data, scene_vol.spacing, scene_vol.origin, params)
    got = _run_sharded(scene_vol, params, n_shards=n_shards)
    _assert_parity(got, ref)


def test_sp1_degenerates_to_single_chip(scene_vol):
    """dp-only meshes (sp=1): the sharded entry point detects the static
    axis size and routes to the single-device pipeline (skipping the halo
    concat and x-prefix fix), bit-identical to `segment_volume` (passes=5:
    this scene certifies at 5 half-sweeps, like the other parity tests)."""
    params = SegmentationParams(max_sweeps=2, passes=5)
    ref = segment_volume(scene_vol.data, scene_vol.spacing, scene_vol.origin, params)
    got = _run_sharded(scene_vol, params, n_shards=1)
    _assert_parity(got, ref)


def test_thin_shards_rejected_loudly(scene_vol):
    """A shard thinner than the closing halo would receive its neighbor's
    planes from the halo slice; the sharded path must refuse instead."""
    from mamri_tpu.perception.volume import Volume

    vol = scene_vol
    thin = Volume(
        data=np.asarray(vol.data)[:16],  # 2-wide shards on 8 devices
        spacing=vol.spacing,
        origin=vol.origin,
    )
    with pytest.raises(ValueError, match="thinner|halo"):
        _run_sharded(thin, SegmentationParams())
