import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mamri_tpu.perception.reference_cpu import segment_reference, ball_structuring_element
from mamri_tpu.perception.segmentation import (
    SegmentationParams,
    binary_close,
    connected_components,
    segment_volume,
)
from mamri_tpu.perception.volume import synthetic_volume


FIDUCIALS = np.array(
    [
        [-10.0, 20.0, 5.0],
        [10.0, 20.0, 5.0],
        [-10.0, -20.0, 5.0],
        [25.0, -5.0, 15.0],
    ],
    dtype=np.float32,
)


@pytest.fixture(scope="module")
def vol():
    return synthetic_volume(
        shape=(64, 64, 64),
        fiducials_ras=FIDUCIALS,
        body_center_ras=[0.0, 0.0, -15.0],
        body_radii_mm=[25.0, 20.0, 10.0],
    )


@pytest.fixture(scope="module")
def cpu_seg(vol):
    return segment_reference(vol)


@pytest.fixture(scope="module")
def jax_seg(vol):
    fn = jax.jit(lambda d: segment_volume(d, vol.spacing, vol.origin))
    return fn(jnp.asarray(vol.data))


def test_ball_se_has_33_voxels():
    assert ball_structuring_element(2).sum() == 33


def test_cpu_reference_finds_fiducials_and_body(cpu_seg):
    assert cpu_seg.centroids_ras.shape[0] == 4
    assert cpu_seg.body_mask.sum() > 1000
    # centroids near ground truth (sub-voxel)
    for c in FIDUCIALS:
        d = np.linalg.norm(cpu_seg.centroids_ras - c, axis=1).min()
        assert d < 1.0, (c, d)
    # sphere r=3 -> ~113 mm^3 (closing may add a bit)
    assert np.all(cpu_seg.volumes_mm3 > 50) and np.all(cpu_seg.volumes_mm3 < 400)


def test_jax_binary_close_matches_cpu(vol):
    mask = (vol.data >= 65.0) & (vol.data <= 65535.0)
    from mamri_tpu.perception.reference_cpu import binary_close_safe_border

    cpu = binary_close_safe_border(mask)
    jx = np.asarray(binary_close(jnp.asarray(mask)))
    np.testing.assert_array_equal(jx, cpu)


def test_jax_ccl_matches_cpu_partition(vol, cpu_seg):
    mask = (vol.data >= 65.0) & (vol.data <= 65535.0)
    from mamri_tpu.perception.reference_cpu import binary_close_safe_border

    closed = binary_close_safe_border(mask)
    lab = np.asarray(connected_components(jnp.asarray(closed)))
    # same partition: each scipy label maps to exactly one jax label and vice versa
    scipy_lab = cpu_seg.labels
    for lbl in range(1, cpu_seg.num_components + 1):
        sel = scipy_lab == lbl
        assert len(np.unique(lab[sel])) == 1
    assert len(np.unique(lab[closed])) == cpu_seg.num_components
    # background is sentinel
    assert np.all(lab[~closed] == np.iinfo(np.int32).max)


def test_jax_segmentation_matches_cpu(vol, cpu_seg, jax_seg):
    n = int(jax_seg.num_blobs)
    assert n == cpu_seg.centroids_ras.shape[0]
    got = np.asarray(jax_seg.centroids_ras[:n])
    want = cpu_seg.centroids_ras
    # same label ordering (min linear index == raster order)
    np.testing.assert_allclose(got, want, atol=1e-3)
    np.testing.assert_allclose(np.asarray(jax_seg.volumes_mm3[:n]), cpu_seg.volumes_mm3, rtol=1e-6)
    assert bool(jax_seg.body_found)
    np.testing.assert_array_equal(np.asarray(jax_seg.body_mask), cpu_seg.body_mask)
    assert abs(float(jax_seg.body_volume_mm3) - cpu_seg.body_volume_mm3) < 1e-3


def test_empty_volume():
    v = synthetic_volume(shape=(32, 32, 32))  # background only
    res = segment_volume(jnp.asarray(v.data), v.spacing, v.origin)
    assert int(res.num_blobs) == 0
    assert not bool(res.body_found)
    assert np.asarray(res.body_mask).sum() == 0


def test_anisotropic_spacing():
    v = synthetic_volume(
        shape=(48, 48, 32),
        spacing=(1.0, 1.0, 2.0),
        fiducials_ras=np.array([[5.0, -3.0, 4.0]]),
        fiducial_radius_mm=4.0,
    )
    cpu = segment_reference(v)
    res = segment_volume(jnp.asarray(v.data), v.spacing, v.origin)
    assert int(res.num_blobs) == cpu.centroids_ras.shape[0] == 1
    np.testing.assert_allclose(np.asarray(res.centroids_ras[0]), cpu.centroids_ras[0], atol=1e-3)
    # centroid near ground truth despite coarse z
    assert np.linalg.norm(np.asarray(res.centroids_ras[0]) - [5.0, -3.0, 4.0]) < 1.5


def test_int16_input_bit_identical(vol, jax_seg):
    """Scanner-native int16 volumes segment bit-identically to f32: the cast
    to f32 happens on device (segment_volume), and all synthetic intensities
    (10/90/120) are exact in both dtypes. This is the compact-upload path the
    streaming tracker uses to halve host->device bytes."""
    assert np.array_equal(vol.data, vol.data.astype(np.int16))  # integral scene
    fn = jax.jit(lambda d: segment_volume(d, vol.spacing, vol.origin))
    res16 = fn(jnp.asarray(vol.data.astype(np.int16)))
    np.testing.assert_array_equal(np.asarray(res16.labels), np.asarray(jax_seg.labels))
    np.testing.assert_array_equal(
        np.asarray(res16.centroids_ras), np.asarray(jax_seg.centroids_ras)
    )
    np.testing.assert_array_equal(
        np.asarray(res16.body_mask), np.asarray(jax_seg.body_mask)
    )
    assert int(res16.num_blobs) == int(jax_seg.num_blobs)


def test_volume_preserves_compact_dtypes():
    """Volume keeps int8/uint8/int16/uint16 storage (ships fewer H2D bytes);
    everything else still normalizes to f32."""
    from mamri_tpu.perception.volume import Volume

    for dt in (np.int8, np.uint8, np.int16, np.uint16):
        v = Volume(np.zeros((4, 4, 4), dtype=dt), np.ones(3), np.zeros(3))
        assert v.data.dtype == dt
    for dt in (np.float64, np.int32, np.int64, bool):
        v = Volume(np.zeros((4, 4, 4), dtype=dt), np.ones(3), np.zeros(3))
        assert v.data.dtype == np.float32


def test_vmapped_batch(vol):
    data = jnp.stack([jnp.asarray(vol.data)] * 3)
    fn = jax.jit(jax.vmap(lambda d: segment_volume(d, vol.spacing, vol.origin).num_blobs))
    out = fn(data)
    assert np.all(np.asarray(out) == 4)


def test_touching_blobs_merge_into_one():
    v = synthetic_volume(
        shape=(48, 48, 48),
        fiducials_ras=np.array([[0.0, 0.0, 0.0], [4.0, 0.0, 0.0]]),  # overlapping spheres
        fiducial_radius_mm=3.0,
    )
    cpu = segment_reference(v)
    res = segment_volume(jnp.asarray(v.data), v.spacing, v.origin)
    assert int(res.num_blobs) == cpu.centroids_ras.shape[0] == 1


def test_half_sweep_passes_schedule():
    """`passes` semantics: even counts equal classic full sweeps bit-exact;
    the engine's odd default ([yz, x, yz]) reaches and certifies the fixed
    point on convex-ish components; a yz-only schedule cannot and says so."""
    import jax.numpy as jnp

    from mamri_tpu.perception import segmentation as seg

    x, y, z = np.mgrid[:24, :24, :24]
    mask = ((x - 12.0) ** 2 + (y - 10.0) ** 2 + (z - 14.0) ** 2 < 64) | (
        (x - 5.0) ** 2 + (y - 18.0) ** 2 + (z - 5.0) ** 2 < 9
    )
    lab0 = seg._init_labels(jnp.asarray(mask))
    reset = jnp.asarray(~mask)

    full2, conv_full = seg._ccl_sweeps(lab0, reset, 2)
    even4, conv_even = seg._ccl_sweeps(lab0, reset, 99, passes=4)
    np.testing.assert_array_equal(np.asarray(full2), np.asarray(even4))
    assert bool(conv_full) and bool(conv_even)

    odd3, conv_odd = seg._ccl_sweeps(lab0, reset, 99, passes=3)
    assert bool(conv_odd)
    np.testing.assert_array_equal(np.asarray(odd3), np.asarray(full2))

    _, conv_yz = seg._ccl_sweeps(lab0, reset, 99, passes=1)
    assert not bool(conv_yz)  # x never scanned: certificate refuses


def test_segment_volume_passes_default_certifies(vol, cpu_seg):
    """segment_volume with the engine's passes=3 default matches the scipy
    oracle and certifies on the demo scene."""
    import jax.numpy as jnp

    from mamri_tpu.perception.segmentation import SegmentationParams, segment_volume

    params = SegmentationParams(passes=3, max_sweeps=99)
    res = segment_volume(
        jnp.asarray(vol.data), jnp.asarray(vol.spacing), jnp.asarray(vol.origin), params
    )
    assert bool(res.ccl_converged) and bool(res.roots_complete)
    got = np.sort(np.asarray(res.volumes_mm3)[np.asarray(res.blob_valid)])
    want = np.sort(cpu_seg.volumes_mm3)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    got_c = np.asarray(res.centroids_ras)[np.asarray(res.blob_valid)]
    for c in cpu_seg.centroids_ras:
        assert np.linalg.norm(got_c - c, axis=1).min() < 1e-3


def test_blob_band_certificate():
    """>max_blobs genuine in-band components must fail blobs_complete (the
    ITK reference has no blob cap, Mamri.py:1310-1317); raising max_blobs
    certifies and recovers every component."""
    import jax.numpy as jnp

    from mamri_tpu.perception.segmentation import SegmentationParams, segment_volume

    # 40 separated 3^3 cubes at 1.5 mm spacing: 27 * 3.375 = 91.1 mm^3 each,
    # inside the 50-1500 band
    data = np.zeros((64, 48, 48), np.float32)
    n = 0
    for i in range(8):
        for j in range(5):
            if n >= 40:
                break
            x, y = 4 + 7 * i, 4 + 8 * j
            data[x : x + 3, y : y + 3, 10:13] = 100.0
            n += 1
    spacing = np.full(3, 1.5, np.float32)
    origin = np.zeros(3, np.float32)

    params = SegmentationParams(max_sweeps=8)
    res = segment_volume(jnp.asarray(data), spacing, origin, params)
    assert int(res.num_components) == 40
    assert bool(res.roots_complete) and bool(res.ccl_converged)
    assert not bool(res.blobs_complete)  # 40 > default max_blobs=32
    assert int(res.num_blobs) == 32  # band truncated -> certificate failed

    res64 = segment_volume(
        jnp.asarray(data), spacing, origin, params._replace(max_blobs=64)
    )
    assert bool(res64.blobs_complete)
    assert int(res64.num_blobs) == 40
    vols = np.asarray(res64.volumes_mm3)[np.asarray(res64.blob_valid)]
    # ball(2) closing can add a voxel or two to a 3^3 cube; all stay in-band
    assert vols.shape == (40,)
    assert np.all((vols >= 27 * 1.5**3) & (vols <= 30 * 1.5**3)), vols


def test_huge_threshold_padding_stays_background():
    """Huge thresholds (|thr| >= 2^24, where `thr - 1.0` is an f32 no-op)
    must leave an all-zero volume and its closing padding background, and
    non-finite thresholds are rejected at the boundary."""
    import numpy as np

    from mamri_tpu.perception.segmentation import SegmentationParams, segment_volume

    data = np.zeros((16, 16, 16), np.float32)
    params = SegmentationParams(
        intensity_low=2.0e7, intensity_high=3.0e7
    )
    res = segment_volume(data, np.ones(3, np.float32), np.zeros(3, np.float32), params)
    assert int(np.asarray(res.num_components)) == 0
    assert not bool(np.asarray(res.body_mask).any())
    # non-finite thresholds are rejected at the boundary
    import pytest

    with pytest.raises(ValueError, match="finite"):
        segment_volume(
            data, np.ones(3, np.float32), np.zeros(3, np.float32),
            SegmentationParams(intensity_low=float("-inf")),
        )


def test_targeted_escalation_grows_only_max_roots():
    """Targeted escalation on a speckle storm: the count sub-certificate
    fails at the default root budget, so escalation grows `max_roots` ONLY
    (the exact flat selection stays off — the blocked one is not what
    overflowed), certifies within two steps, and its blob decisions equal
    an exhaustive-selection run's bit for bit."""
    from mamri_tpu.api.engine import MamriEngine

    rng = np.random.default_rng(9)
    v = synthetic_volume(
        shape=(64, 64, 64),
        spacing=(2.5, 2.5, 2.5),
        fiducials_ras=np.array([[20.0, 10.0, -15.0], [-25.0, 5.0, 20.0], [0.0, -30.0, 0.0]]),
        fiducial_radius_mm=4.0,
        body_center_ras=(0.0, 25.0, 30.0),
        body_radii_mm=(22.0, 25.0, 20.0),
    )
    data = np.asarray(v.data).copy()
    bright = data > 60.0
    added = 0
    for i, j, k in rng.integers(2, 62, size=(1200, 3)):
        if not bright[i - 2 : i + 3, j - 2 : j + 3, k - 2 : k + 3].any():
            data[i, j, k] = 100.0
            bright[i, j, k] = True
            added += 1
    assert added > 200

    def run(params):
        return segment_volume(
            jnp.asarray(data), jnp.asarray(v.spacing), jnp.asarray(v.origin), params
        )

    params = SegmentationParams(max_sweeps=2, passes=3, max_roots=128)
    r0 = run(params)
    assert not bool(r0.count_ok)  # > 128 components
    assert not bool(r0.roots_complete)
    assert bool(r0.ccl_converged)

    chain = [params]
    while True:
        r = run(chain[-1])
        if bool(r.ccl_converged) and bool(r.roots_complete) and bool(r.blobs_complete):
            break
        stronger = MamriEngine._escalate_seg_params(
            chain[-1], bool(r.ccl_converged), bool(r.roots_complete), bool(r.blobs_complete),
            count_ok=bool(r.count_ok),
        )
        assert stronger is not None, "escalation exhausted while uncertified"
        chain.append(stronger)
    landed = chain[-1]
    assert landed.max_roots > 128
    assert not landed.exhaustive_roots, "blanket escalation leaked in"
    assert landed.passes == params.passes
    assert len(chain) <= 3

    r_landed = run(landed)
    r_exact = run(landed._replace(exhaustive_roots=True))
    np.testing.assert_array_equal(np.asarray(r_landed.centroids_ras), np.asarray(r_exact.centroids_ras))
    np.testing.assert_array_equal(np.asarray(r_landed.volumes_mm3), np.asarray(r_exact.volumes_mm3))
    np.testing.assert_array_equal(np.asarray(r_landed.blob_valid), np.asarray(r_exact.blob_valid))
    assert int(r_landed.num_blobs) == int(r_exact.num_blobs) == 3
    assert int(r_landed.num_components) == int(r_exact.num_components) > 200
    assert bool(r_landed.body_found) and bool(r_exact.body_found)
    assert bool(r_landed.roots_complete) and bool(r_landed.count_ok)


@pytest.mark.parametrize("shape", [(13, 7, 11), (30, 17, 9), (21, 34, 5), (9, 9, 40)])
def test_component_stats_match_scipy(shape):
    """The chunked one-hot stats reduction (counts and index sums per root)
    against scipy.ndimage on random masks at non-power-of-two shapes."""
    from scipy import ndimage

    from mamri_tpu.perception import segmentation as seg

    rng = np.random.default_rng(sum(shape))
    mask = rng.random(shape) < 0.35
    labels = seg.connected_components(jnp.asarray(mask), max_sweeps=32)
    roots, valid, counts, sums, num, count_ok, complete = seg._component_stats(
        labels, max_roots=512
    )
    ref, n = ndimage.label(mask, structure=ndimage.generate_binary_structure(3, 1))
    assert int(num) == n and bool(count_ok) and bool(complete)

    # scipy's labels, keyed by each component's first voxel in (z, y, x)
    # raster order — the root the JAX labels carry
    nx, ny, _ = shape
    gi, gj, gk = np.meshgrid(*(np.arange(s) for s in shape), indexing="ij")
    raster = gk * (nx * ny) + gj * nx + gi
    idx = np.arange(1, n + 1)
    first = ndimage.minimum(raster, ref, idx).astype(np.int64)
    want = {
        int(r): (c, si, sj, sk)
        for r, c, si, sj, sk in zip(
            first,
            ndimage.sum(np.ones(shape), ref, idx),
            ndimage.sum(gi, ref, idx),
            ndimage.sum(gj, ref, idx),
            ndimage.sum(gk, ref, idx),
        )
    }
    got_roots = np.asarray(roots)[np.asarray(valid)]
    assert sorted(got_roots.tolist()) == sorted(want)
    got = np.concatenate([np.asarray(counts)[:, None], np.asarray(sums)], axis=1)
    for r, row in zip(got_roots, got[np.asarray(valid)]):
        np.testing.assert_array_equal(row, want[int(r)])
