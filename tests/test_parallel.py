"""Multi-device sharding tests on the virtual 8-CPU mesh (conftest forces
JAX_PLATFORMS=cpu with --xla_force_host_platform_device_count=8)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mamri_tpu.api import MamriEngine
from mamri_tpu.parallel import make_mesh, sharded_batched_pipeline
from mamri_tpu.perception.volume import synthetic_volume


@pytest.fixture(scope="module")
def engine():
    return MamriEngine(ik_iters=10, ik_restarts=0)


def _scene(engine, spacing=6.0):
    import sys, os

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from __graft_entry__ import _example_volume

    return _example_volume(engine, spacing=spacing)


def test_eight_devices_available():
    assert len(jax.devices()) == 8
    assert jax.devices()[0].platform == "cpu"


def test_mesh_shapes():
    m1 = make_mesh(8, axes=("dp",))
    assert m1.devices.shape == (8,)
    m2 = make_mesh(8, axes=("dp", "sp"))
    assert m2.devices.shape == (2, 4)
    m3 = make_mesh(4, axes=("dp", "sp"))
    assert m3.devices.shape == (2, 2)


def test_dp_sharded_batch_matches_single_device(engine):
    vol = _scene(engine)
    mesh = make_mesh(4, axes=("dp",))
    fn = sharded_batched_pipeline(engine, mesh)
    batch = jnp.asarray(np.broadcast_to(vol.data, (4,) + vol.data.shape).copy())
    out = fn(batch, jnp.asarray(vol.spacing), jnp.asarray(vol.origin), jnp.asarray(False))
    jax.block_until_ready(out)
    # all four shards computed the same volume -> identical results
    angles = np.asarray(out["angles"])
    assert angles.shape == (4, 6)
    np.testing.assert_allclose(angles[0], angles[3], atol=1e-5)
    # compare against the unsharded batched path
    ref = engine.estimate_pose_batch(batch[:1], vol.spacing, vol.origin)
    np.testing.assert_allclose(angles[0], np.asarray(ref["angles"])[0], atol=1e-4)


def test_dp_sp_sharded_segmentation_consistent(engine):
    """Spatially sharding the volume's x extent must not change results:
    the sharded segmentation exchanges halos and scan summaries explicitly."""
    vol = _scene(engine)
    data = vol.data
    pad_x = (-data.shape[0]) % 4
    if pad_x:
        data = np.pad(data, ((0, pad_x), (0, 0), (0, 0)), constant_values=10.0)
    mesh = make_mesh(8, axes=("dp", "sp"))  # 2 x 4
    fn = sharded_batched_pipeline(engine, mesh, sp_axis="sp")
    batch = jnp.asarray(np.broadcast_to(data, (2,) + data.shape).copy())
    out = fn(batch, jnp.asarray(vol.spacing), jnp.asarray(vol.origin), jnp.asarray(False))
    jax.block_until_ready(out)
    ref = engine.estimate_pose_batch(batch[:1], vol.spacing, vol.origin)
    np.testing.assert_allclose(
        np.asarray(out["angles"])[0], np.asarray(ref["angles"])[0], atol=1e-4
    )
    assert np.asarray(out["num_blobs"])[0] == np.asarray(ref["num_blobs"])[0]


def test_graft_entry_contract():
    import sys, os

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    assert bool(out["success"])

    g.dryrun_multichip(8)


def test_sp_fast_kernel_pipeline_in_mesh(engine):
    """dp x sp with the engine's default [yz, x, yz] schedule through
    `run_sharded_batched`: the sharded segmentation (local y/z line passes,
    cross-shard x scans, psum'd stats) must certify and match the unsharded
    batched path."""
    from mamri_tpu.perception.segmentation import SegmentationParams

    eng = MamriEngine(
        ik_iters=10, ik_restarts=0,
        seg_params=SegmentationParams(max_sweeps=2, passes=3, max_roots=128),
    )
    vol = _scene(eng)
    data = vol.data
    pad_x = (-data.shape[0]) % 4  # sp=4 shards
    if pad_x:
        data = np.pad(data, ((0, pad_x), (0, 0), (0, 0)), constant_values=10.0)
    mesh = make_mesh(8, axes=("dp", "sp"))  # 2 x 4
    from mamri_tpu.parallel import run_sharded_batched

    out, final_params, certified = run_sharded_batched(
        eng, mesh, np.broadcast_to(data, (2,) + data.shape).copy(),
        vol.spacing, vol.origin, sp_axis="sp",
    )
    assert certified
    ref = engine.estimate_pose_batch(jnp.asarray(data[None]), vol.spacing, vol.origin)
    np.testing.assert_allclose(
        np.asarray(out["angles"])[0], np.asarray(ref["angles"])[0], atol=1e-4
    )
    assert np.asarray(out["num_blobs"])[0] == np.asarray(ref["num_blobs"])[0]
    assert np.asarray(out["num_components"])[0] == np.asarray(ref["num_components"])[0]


def test_sharded_escalation_loop(engine):
    """A starved half-sweep budget on the sharded path must fail the psum'd
    consistency certificate and re-run at doubled `passes` until it holds
    (VERDICT r2: escalation must reach the sharded entry points; the sharded
    path must honor params.passes)."""
    from mamri_tpu.parallel import run_sharded_batched
    from mamri_tpu.perception.segmentation import SegmentationParams

    eng = MamriEngine(
        ik_iters=10, ik_restarts=0,
        seg_params=SegmentationParams(passes=1, max_sweeps=1, max_roots=128),
    )
    vol = _scene(eng)
    data = vol.data
    pad_x = (-data.shape[0]) % 4
    if pad_x:
        data = np.pad(data, ((0, pad_x), (0, 0), (0, 0)), constant_values=10.0)
    mesh = make_mesh(8, axes=("dp", "sp"))
    out, final_params, certified = run_sharded_batched(
        eng, mesh, np.broadcast_to(data, (2,) + data.shape).copy(),
        vol.spacing, vol.origin, sp_axis="sp",
    )
    assert certified, "escalation never certified the sharded segmentation"
    assert final_params.passes > 1  # passes=1 cannot certify (x never swept)
    assert np.asarray(out["seg_converged"]).all()
    ref = engine.estimate_pose_batch(jnp.asarray(data[None]), vol.spacing, vol.origin)
    np.testing.assert_allclose(
        np.asarray(out["angles"])[0], np.asarray(ref["angles"])[0], atol=1e-4
    )


def _lattice_clutter(clean):
    """Clutter: a lattice of isolated 2x2x2 bright clusters — OUT of the blob
    band at 6 mm spacing (8 x 216 mm3 > max_volume 1500) and too far apart
    for closing(2) to merge, so only ROOT completeness fails (>128
    components) and the escalated max_roots/exhaustive pass certifies."""
    noisy = clean.copy()
    bright = clean > 60.0
    n_added = 0
    for i in range(2, clean.shape[0] - 3, 7):
        for j in range(2, clean.shape[1] - 3, 7):
            for k in range(2, clean.shape[2] - 3, 7):
                if n_added < 200 and not bright[
                    max(i - 4, 0):i + 6, max(j - 4, 0):j + 6, max(k - 4, 0):k + 6
                ].any():
                    noisy[i:i + 2, j:j + 2, k:k + 2] = 100.0
                    n_added += 1
    assert n_added >= 150
    return noisy


def test_mesh_per_volume_escalation(engine, caplog):
    """VERDICT r3 #2: a mixed clean/noisy mesh batch escalates ONLY the
    uncertified volume — the failing row re-runs as a compacted dp-divisible
    sub-batch and scatters back; clean rows keep first-pass results."""
    import logging

    from mamri_tpu.parallel import run_sharded_batched

    vol = _scene(engine)
    clean = np.asarray(vol.data)
    noisy = _lattice_clutter(clean)

    mesh = make_mesh(4, axes=("dp",))
    batch = np.stack([clean, noisy, clean, clean])
    cache = {}
    with caplog.at_level(logging.WARNING, logger="mamri_tpu.parallel.mesh"):
        out, final_params, certified = run_sharded_batched(
            engine, mesh, batch, vol.spacing, vol.origin, _fn_cache=cache
        )
    assert certified
    assert any("escalation for 1/4 volumes" in r.message for r in caplog.records)
    # clean rows carry FIRST-PASS results: bit-identical to an all-clean run
    ref, _, ref_cert = run_sharded_batched(
        engine, mesh, np.stack([clean] * 4), vol.spacing, vol.origin, _fn_cache=cache
    )
    assert ref_cert
    for row in (0, 2, 3):
        np.testing.assert_array_equal(out["angles"][row], ref["angles"][row])
    assert out["success"].all()


def test_mesh_microbatch_chunking(engine):
    """lax.map-chunked mesh batching must match the flat vmap on both the
    dp-only and dp x sp paths (VERDICT r3 #2: microbatch= under shard_map)."""
    from mamri_tpu.parallel import run_sharded_batched

    vol = _scene(engine)
    batch = np.broadcast_to(vol.data, (4,) + vol.data.shape).copy()

    mesh_dp = make_mesh(2, axes=("dp",))
    flat, _, c1 = run_sharded_batched(engine, mesh_dp, batch, vol.spacing, vol.origin)
    chunked, _, c2 = run_sharded_batched(
        engine, mesh_dp, batch, vol.spacing, vol.origin, microbatch=2
    )
    assert c1 and c2
    np.testing.assert_array_equal(flat["angles"], chunked["angles"])

    data = vol.data
    pad_x = (-data.shape[0]) % 4
    if pad_x:
        data = np.pad(data, ((0, pad_x), (0, 0), (0, 0)), constant_values=10.0)
    batch_sp = np.broadcast_to(data, (4,) + data.shape).copy()
    mesh_sp = make_mesh(4, axes=("dp", "sp"))  # 2 x 2
    flat_sp, _, c3 = run_sharded_batched(
        engine, mesh_sp, batch_sp, vol.spacing, vol.origin, sp_axis="sp"
    )
    chunked_sp, _, c4 = run_sharded_batched(
        engine, mesh_sp, batch_sp, vol.spacing, vol.origin, sp_axis="sp", microbatch=2
    )
    assert c3 and c4
    np.testing.assert_array_equal(flat_sp["angles"], chunked_sp["angles"])

    with pytest.raises(ValueError):
        sharded_batched_pipeline(engine, mesh_sp, sp_axis="sp", microbatch=3)


def test_mesh_microbatch_validation(engine):
    """microbatch must be a positive multiple of dp; values >= batch clamp to
    un-chunked on BOTH paths (consistent dp-only vs dp x sp behavior)."""
    mesh = make_mesh(2, axes=("dp",))
    with pytest.raises(ValueError):
        sharded_batched_pipeline(engine, mesh, microbatch=0)
    with pytest.raises(ValueError):
        sharded_batched_pipeline(engine, mesh, microbatch=-2)
    with pytest.raises(ValueError):
        sharded_batched_pipeline(engine, mesh, microbatch=3)  # not a dp multiple


def test_mesh_escalation_honors_microbatch(engine, monkeypatch, caplog):
    """The escalated rerun must honor the caller's microbatch memory bound:
    the compacted failure sub-batch pads to a microbatch multiple and the
    rerun pipeline is built WITH chunking (review finding: it previously ran
    fully resident at STRONGER settings, the exact OOM microbatch guards)."""
    import logging

    import mamri_tpu.parallel.mesh as mesh_mod

    vol = _scene(engine)
    noisy = _lattice_clutter(np.asarray(vol.data))
    built = []
    orig = mesh_mod.sharded_batched_pipeline

    def spy(*a, **kw):
        built.append(kw.get("microbatch"))
        return orig(*a, **kw)

    monkeypatch.setattr(mesh_mod, "sharded_batched_pipeline", spy)
    mesh = make_mesh(2, axes=("dp",))
    batch = np.stack([noisy] * 4)
    with caplog.at_level(logging.WARNING, logger="mamri_tpu.parallel.mesh"):
        out, params, certified = mesh_mod.run_sharded_batched(
            engine, mesh, batch, vol.spacing, vol.origin, microbatch=2
        )
    assert certified and out["success"].all()
    assert any("escalation for 4/4" in r.message for r in caplog.records)
    # first pass chunked at 2; every escalated rerun (4 failures pad to 4 > 2)
    # must also be chunked at 2, never unchunked
    assert built[0] == 2
    assert len(built) > 1 and all(m == 2 for m in built[1:]), built
