"""Benchmark: batched 256^3 scan -> joint-angles throughput on one accelerator.

HONEST SETTINGS: the engine's defaults, exactly what `estimate_pose` runs —
a 3-half-sweep CCL schedule WITH the fixed-point certificate, 128 candidate
roots WITH the completeness certificate, the blob-band certificate,
analytic-seeded 24-iteration IK.

MULTI-SCENE: the headline is the WORST-CASE of 4 scenes (the canonical demo
pose + 3 random in-bounds poses/base yaws) rendered into one shared
union-bbox grid (one compile; `mamri_tpu.api.demo.bench_scenes`). Per scene
the run asserts all three certificates held and the scene was solved
(marker RMSE, TCP position, and the directly-observed J1 — markers sit only
on Baseplate/J2/J4/J6, so J4/J6 can trade degrees at sub-mm RMSE near the
wrist; TCP is the honest invariant, see
tests/test_engine.py::test_estimate_pose_random_pose_sweep).

PLANNING: entry-point search, the fused up-over-down heuristic-path program
and an 8-distance safety sweep are timed through the public API (p50 incl.
one host fetch each).

STREAMING: N sequential single-volume frames through
`api.streaming.PoseTracker` — fresh host array each frame, so the H2D
transfer is inside the measurement; reports p50/p95 frame latency against
the < 100 ms interactive cadence.

Prints ONE JSON line: {"metric", "value", "unit", "device", ...extras}.
"""

import json
import os
import subprocess
import time

import numpy as np

BATCH = int(os.environ.get("BENCH_BATCH", "16"))
SIZE = int(os.environ.get("BENCH_SIZE", "256"))
REPS = int(os.environ.get("BENCH_REPS", "5"))
STREAM_FRAMES = int(os.environ.get("BENCH_STREAM_FRAMES", "12"))
TARGET_STREAM_MS = 100.0


def _device_info():
    """The device every number below was taken on: JAX's view plus the
    card's name and power limit (a card set below its maximum runs slower
    under load)."""
    import jax

    dev = jax.devices()[0]
    info = {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}
    if dev.platform == "gpu":
        info["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip()
    return info


def main():
    import jax
    import jax.numpy as jnp

    from mamri_tpu.api import MamriEngine
    from mamri_tpu.api.demo import add_speckle, bench_scenes, bench_volume
    from mamri_tpu.core.robot import fk_all_links
    from mamri_tpu.perception.volume import Volume

    engine = MamriEngine()  # default (certified) settings throughout

    scenes, spacing, origin, body_center = bench_scenes(engine, SIZE)
    vols = [
        bench_volume(pts, (SIZE, SIZE, SIZE), spacing, origin, body_center)
        for _, _, pts in scenes
    ]

    # keep outputs tiny: angles/steps/success only stay on device until fetch
    def make_fns(params):
        pipeline = engine.pipeline_fn(params)

        def one(d):
            out = pipeline(
                d,
                jnp.asarray(spacing),
                jnp.asarray(origin),
                jnp.eye(4, dtype=jnp.float32),
                jnp.asarray(False),
                jnp.asarray(False),
                jnp.asarray(False),
                jnp.zeros(engine.model.num_joints, dtype=jnp.float32),
            )
            keep = ("angles", "rmse", "success", "seg_converged", "roots_complete", "blobs_complete")
            return {k: out[k] for k in keep}

        return jax.jit(jax.vmap(one)), jax.jit(one)

    fb_cache = {engine.seg_params: make_fns(engine.seg_params)}
    fb, f1 = fb_cache[engine.seg_params]

    dev_batches = [jnp.asarray(np.broadcast_to(v.data, (BATCH,) + v.data.shape)) for v in vols]
    dev_one = jnp.asarray(vols[0].data)

    # Throughput is measured pipelined (enqueue REPS batches, fence once on
    # a host fetch of the last result); the chained measurement below
    # reports device latency without the per-call host round trip.

    # warmup / compile (one shape -> one compile for all scenes)
    jax.device_get(fb(dev_batches[0])["rmse"])
    jax.device_get(f1(dev_one)["rmse"])

    # ---- per-scene honesty checks + throughput; headline = worst scene.
    # A scene whose certificates fail at the defaults is escalated exactly
    # like estimate_pose would and measured at ITS certified settings — the
    # engine never returns uncertified results, so uncertified throughput
    # would be a fake number.
    per_scene = []
    for si, ((true_angles, base, _), dev_batch) in enumerate(zip(scenes, dev_batches)):
        params = engine.seg_params
        fb_s, _ = fb_cache[params]
        while True:
            res = jax.device_get(fb_s(dev_batch))
            converged = bool(np.asarray(res["seg_converged"]).all())
            complete = bool(np.asarray(res["roots_complete"]).all())
            blobs_ok = bool(np.asarray(res["blobs_complete"]).all())
            certified = converged and complete and blobs_ok
            if certified:
                break
            stronger = engine._escalate_seg_params(params, converged, complete, blobs_ok)
            if stronger is None:
                break
            params = stronger
            if params not in fb_cache:
                fb_cache[params] = make_fns(params)
            fb_s, _ = fb_cache[params]
        ok = bool(np.asarray(res["success"]).all())
        est = np.asarray(res["angles"])[0]
        err_deg = np.degrees(np.abs(est - true_angles))
        tcp_true = np.asarray(fk_all_links(engine.model, jnp.asarray(true_angles), jnp.asarray(base)))[-1][:3, 3]
        tcp_est = np.asarray(fk_all_links(engine.model, jnp.asarray(est), jnp.asarray(base)))[-1][:3, 3]
        tcp_err = float(np.linalg.norm(tcp_true - tcp_est))
        rmse = float(np.asarray(res["rmse"]).max())
        solved = bool(ok and certified and rmse < 1.5 and tcp_err < 2.0 and err_deg[0] < 1.5)

        t0 = time.perf_counter()
        outs = [fb_s(dev_batch) for _ in range(REPS)]
        jax.device_get(outs[-1]["rmse"])
        vols_per_s = BATCH * REPS / (time.perf_counter() - t0)
        per_scene.append(
            {
                "scene": si,
                "vols_per_s": round(vols_per_s, 3),
                "solved": solved,
                "certified": certified,
                "escalated": params != engine.seg_params,
                "passes": params.passes,
                "rmse_mm": round(rmse, 4),
                "tcp_err_mm": round(tcp_err, 4),
                "max_angle_err_deg": round(float(err_deg.max()), 4),
            }
        )
    worst = min(per_scene, key=lambda s: s["vols_per_s"])
    vols_per_s = worst["vols_per_s"]
    pipeline_success = all(s["solved"] for s in per_scene)

    # ---- single-volume latency
    # (a) synchronous round-trips (includes one host fetch per call)
    lats = []
    for _ in range(max(REPS * 2, 10)):
        t0 = time.perf_counter()
        jax.device_get(f1(dev_one)["rmse"])
        lats.append(time.perf_counter() - t0)
    p50_sync_ms = sorted(lats)[len(lats) // 2] * 1e3

    # (b) chained: K dependent executions, one fence — pure device latency.
    # The rmse output is folded back into the input so XLA cannot reorder or
    # overlap the runs.
    def chained(d, k):
        r = jnp.float32(0)
        for _ in range(k):
            out = f1(d + 0.0 * r)
            r = out["rmse"]
        return r

    K = 10
    chained_j = jax.jit(lambda d: chained(d, K))
    jax.device_get(chained_j(dev_one))  # compile
    samples = []
    for _ in range(10):
        t0 = time.perf_counter()
        jax.device_get(chained_j(dev_one))
        samples.append((time.perf_counter() - t0) / K)
    samples.sort()
    p50_device_ms = samples[len(samples) // 2] * 1e3
    p95_device_ms = samples[min(int(len(samples) * 0.95), len(samples) - 1)] * 1e3

    # ---- streaming: sequential frames through the
    # tracker — fresh host array every frame (H2D included),
    # warm-started IK, certificates checked inside estimate_pose (single
    # fused device_get per frame).
    from mamri_tpu.api.streaming import PoseTracker

    frames = [np.array(v.data, copy=True) for v in vols]
    stream_fail = []  # which streaming mode failed, if any

    def _stream(frame_list, mode):
        """One warm frame, then STREAM_FRAMES timed sync steps -> (p50, p95) ms."""
        tr = PoseTracker(engine)
        tr.step(Volume(data=frame_list[0], spacing=spacing, origin=origin))
        tr.tracer.spans["frame"].clear()
        lats = []
        for i in range(STREAM_FRAMES):
            fr = frame_list[i % len(frame_list)]
            t0 = time.perf_counter()
            r = tr.step(Volume(data=fr, spacing=spacing, origin=origin))
            lats.append(time.perf_counter() - t0)
            if not r.success:
                stream_fail.append(mode)
        lats.sort()
        return (
            lats[len(lats) // 2] * 1e3,
            lats[min(int(len(lats) * 0.95), len(lats) - 1)] * 1e3,
        )

    stream_p50_ms, stream_p95_ms = _stream(frames, "sync_f32")

    # pipelined mode: dispatch frame N while collecting N-1 — the H2D upload
    # and result fetch hide behind device compute; steady-state frame rate.
    tracker_p = PoseTracker(engine, pipelined=True, depth=1)
    tracker_p.step(Volume(data=frames[0], spacing=spacing, origin=origin))  # fill
    t0 = time.perf_counter()
    for i in range(STREAM_FRAMES):
        r = tracker_p.step(Volume(data=frames[i % len(frames)], spacing=spacing, origin=origin))
        if r is not None and not r.success:
            stream_fail.append("pipelined")
    for r in tracker_p.flush():
        if not r.success:
            stream_fail.append("pipelined")
    stream_fps = STREAM_FRAMES / (time.perf_counter() - t0)

    # compact-upload mode: scanner-native int16 frames ship HALF the
    # host->device bytes (Volume preserves the dtype; the device pipeline
    # casts to f32 on-chip, and the synthetic intensities are integral so
    # results are bit-identical) — the mitigation for bandwidth-bound links.
    stream_i16_p50_ms, _ = _stream([f.astype(np.int16) for f in frames], "sync_int16")

    # ROI ingest: int16 frames cropped on the host to the fixed marker-bbox
    # window (previous pose + 40 mm margin) before upload — the
    # ingest-bytes lever. ROI is a TRACKING feature, so this
    # row streams a coherent sequence (one scene, the quasi-static robot of
    # the clinical workflow) — the 4-scene cycle above is 4 unrelated poses,
    # where the window correctly falls back to full frames every time.
    frames_i16 = [f.astype(np.int16) for f in frames]
    tr_roi = PoseTracker(engine, roi_margin_mm=40.0)
    tr_roi.step(Volume(data=frames_i16[0], spacing=spacing, origin=origin))  # anchor (full)
    tr_roi.step(Volume(data=frames_i16[0], spacing=spacing, origin=origin))  # compile ROI shape
    tr_roi.tracer.spans["frame"].clear()
    roi_lats = []
    for i in range(STREAM_FRAMES):
        fr = frames_i16[0]
        t0 = time.perf_counter()
        r = tr_roi.step(Volume(data=fr, spacing=spacing, origin=origin))
        roi_lats.append(time.perf_counter() - t0)
        if not r.success:
            stream_fail.append("roi_int16")
    roi_lats.sort()
    stream_roi_p50_ms = roi_lats[len(roi_lats) // 2] * 1e3
    roi_stats = tr_roi.stats()
    roi_mb = (np.prod(roi_stats["roi_shape"]) * 2 / 1e6) if "roi_shape" in roi_stats else None
    stream_ok = not stream_fail

    # ---- planning: entry-point search + collision-checked up-over-down
    # path + safety-distance sweep through the public API (jit-cached fused
    # plan programs; timings include the host fetch — what an interactive
    # caller experiences).
    est = engine.estimate_pose(vols[0])
    plan_ok = bool(est.success)
    target = np.asarray(body_center, dtype=np.float32)

    def timed_p50(fn, reps=8):
        fn()  # warm / compile
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        ts.sort()
        return ts[len(ts) // 2] * 1e3

    # a failed estimate (e.g. BENCH_SIZE so small the fiducials are
    # sub-voxel) must degrade to plan_ok=False — a crash here would cost the
    # WHOLE bench JSON, not just the planning block
    entry_ms = path_ms = sweep_ms = float("nan")
    if plan_ok:
        entry_ms = timed_p50(lambda: engine.find_entry_point(target))
        ep = engine.find_entry_point(target)
        plan_ok = plan_ok and bool(ep.found)
    if plan_ok:
        path_ms = timed_p50(
            lambda: engine.plan_heuristic_path(target, ep.point_ras, 5.0, start_pose_steps=est.steps)
        )
        sweep_d = [2.0, 5.0, 7.5, 10.0, 12.5, 15.0, 17.5, 20.0]
        sweep_ms = timed_p50(lambda: engine.plan_trajectory_sweep(target, ep.point_ras, sweep_d))
        plan = engine.plan_heuristic_path(target, ep.point_ras, 5.0, start_pose_steps=est.steps)
        plan_ok = plan_ok and plan.success and not plan.collision_detected

    # ---- robustness: dense-speckle noisy variant at the noisy-scan settings
    # (the caps the engine's certificate escalation lands on, pre-set so the
    # measurement is one compile). ~1500 single-voxel speckle components
    # + sub-threshold gaussian noise: the ITK reference has no component cap,
    # so neither may we — certificates must hold WITHOUT truncation.
    from mamri_tpu.perception.segmentation import SegmentationParams

    true_angles = scenes[0][0]
    noisy = add_speckle(np.asarray(vols[0].data))

    # the settings the engine's targeted escalation lands on for this scene
    # (count_ok fails at 128 and at 1024 roots; the blocked selection holds)
    noisy_params = SegmentationParams(max_sweeps=2, passes=3, max_roots=4096)
    pipeline_n = engine.pipeline_fn(seg_params=noisy_params)

    def one_noisy(d):
        out = pipeline_n(
            d,
            jnp.asarray(spacing),
            jnp.asarray(origin),
            jnp.eye(4, dtype=jnp.float32),
            jnp.asarray(False),
            jnp.asarray(False),
            jnp.asarray(False),
            jnp.zeros(engine.model.num_joints, dtype=jnp.float32),
        )
        keep = (
            "angles", "rmse", "success", "seg_converged", "roots_complete",
            "blobs_complete", "num_components",
        )
        return {k: out[k] for k in keep}

    fbn = jax.jit(jax.vmap(one_noisy))
    dev_noisy = jnp.asarray(np.broadcast_to(noisy, (BATCH,) + noisy.shape))
    resn = jax.device_get(fbn(dev_noisy))  # compile + honesty checks
    noisy_certified = bool(
        np.asarray(resn["seg_converged"]).all()
        and np.asarray(resn["roots_complete"]).all()
        and np.asarray(resn["blobs_complete"]).all()
    )
    noisy_ok = bool(np.asarray(resn["success"]).all())
    noisy_err_deg = float(
        np.degrees(np.abs(np.asarray(resn["angles"]) - true_angles[None])).max()
    )
    t0 = time.perf_counter()
    outs = [fbn(dev_noisy) for _ in range(max(REPS // 2, 2))]
    jax.device_get(outs[-1]["rmse"])
    noisy_vols_per_s = BATCH * len(outs) / (time.perf_counter() - t0)

    # ---- large volume: anisotropic 512x512x192 (a realistic MR acquisition
    # shape) over the same physical bbox. BENCH_LARGE=off to skip, or
    # "AxBxC" for another shape.
    large = None
    large_env = os.environ.get("BENCH_LARGE", "512x512x192")
    if large_env not in ("", "0", "off"):
        lshape = tuple(int(t) for t in large_env.split("x"))
        extent = spacing * SIZE  # physical bbox of the bench grid
        lspacing = (extent / np.asarray(lshape)).astype(np.float32)
        lvol = bench_volume(scenes[0][2], lshape, lspacing, origin, body_center)
        dev_large = jnp.asarray(lvol.data)

        def make_large_fn(params):
            # the shared make_fns closes over the CUBIC grid's spacing; the
            # large volume has its own anisotropic lspacing
            pipeline = engine.pipeline_fn(params)

            def one(d):
                out = pipeline(
                    d,
                    jnp.asarray(lspacing),
                    jnp.asarray(origin),
                    jnp.eye(4, dtype=jnp.float32),
                    jnp.asarray(False),
                    jnp.asarray(False),
                    jnp.asarray(False),
                    jnp.zeros(engine.model.num_joints, dtype=jnp.float32),
                )
                keep = ("angles", "rmse", "success", "seg_converged", "roots_complete", "blobs_complete")
                return {k: out[k] for k in keep}

            return jax.jit(one)

        lparams = engine.seg_params
        f1_l = make_large_fn(lparams)
        while True:
            resl = jax.device_get(f1_l(dev_large))
            lconv = bool(resl["seg_converged"])
            lcomp = bool(resl["roots_complete"])
            lblob = bool(resl["blobs_complete"])
            if lconv and lcomp and lblob:
                break
            stronger = engine._escalate_seg_params(lparams, lconv, lcomp, lblob)
            if stronger is None:
                break
            lparams = stronger
            f1_l = make_large_fn(lparams)
        t0 = time.perf_counter()
        louts = [f1_l(dev_large) for _ in range(REPS)]
        jax.device_get(louts[-1]["rmse"])
        large_vols_per_s = REPS / (time.perf_counter() - t0)
        large = {
            "shape": "x".join(map(str, lshape)),
            "vols_per_s": round(large_vols_per_s, 3),
            "success": bool(resl["success"]),
            "certified": lconv and lcomp and lblob,
            "escalated": lparams != engine.seg_params,
            "rmse_mm": round(float(resl["rmse"]), 4),
        }

    print(
        json.dumps(
            {
                "metric": f"scan->joint-angles throughput, batched {SIZE}^3 MRI volumes (worst of {len(scenes)} scenes)",
                "value": round(vols_per_s, 3),
                "unit": "volumes/sec",
                "p50_latency_ms": round(p50_device_ms, 2),
                "p95_latency_ms": round(p95_device_ms, 2),
                "p50_sync_incl_host_fetch_ms": round(p50_sync_ms, 2),
                "batch": BATCH,
                "volume": f"{SIZE}^3",
                "pipeline_success": bool(pipeline_success),
                "per_scene": per_scene,
                "streaming": {
                    "p50_ms": round(stream_p50_ms, 2),
                    "p95_ms": round(stream_p95_ms, 2),
                    "pipelined_fps": round(stream_fps, 2),
                    "int16_frames_p50_ms": round(stream_i16_p50_ms, 2),
                    "roi_int16_p50_ms": round(stream_roi_p50_ms, 2),
                    "roi_frames": roi_stats.get("roi_frames"),
                    "roi_fallbacks": roi_stats.get("roi_fallbacks"),
                    "roi_upload_mb_per_frame": None if roi_mb is None else round(float(roi_mb), 2),
                    "full_upload_mb_per_frame": round(frames[0].nbytes / 1e6, 2),
                    # the answer to the < 100 ms bar without the host link:
                    # volume pre-staged on device, chained dispatch->result
                    "device_only_p50_ms": round(p50_device_ms, 2),
                    "device_only_interactive": p50_device_ms < TARGET_STREAM_MS,
                    "frames": STREAM_FRAMES,
                    "all_success": bool(stream_ok),
                    "failed_modes": sorted(set(stream_fail)),
                    "interactive": stream_p50_ms < TARGET_STREAM_MS,
                    "includes": "H2D upload + result fetch + device compute, per frame (pipelined_fps overlaps them across frames; device_only_p50_ms excludes the host link entirely)",
                },
                "planning": {
                    # None (valid JSON), not NaN, when the planning block was
                    # skipped because the scene's pose was unavailable
                    "entry_search_p50_ms": None if entry_ms != entry_ms else round(entry_ms, 2),
                    "heuristic_path_p50_ms": None if path_ms != path_ms else round(path_ms, 2),
                    "safety_sweep8_p50_ms": None if sweep_ms != sweep_ms else round(sweep_ms, 2),
                    "success_collision_free": bool(plan_ok),
                    "includes": "public-API calls incl. one host fetch each; fused jit-cached plan programs",
                },
                "large_volume": large,
                "noisy_scan": {
                    "vols_per_s": round(noisy_vols_per_s, 3),
                    "speckle_components": int(np.asarray(resn["num_components"]).max()),
                    "certified_no_truncation": noisy_certified,
                    "success": noisy_ok,
                    "max_angle_err_deg": round(noisy_err_deg, 4),
                    "settings": "max_roots=4096, blocked root selection (targeted-escalation landing point, one compile)",
                },
                "settings": "engine defaults (certified): [yz,x,yz] half-sweep schedule + local-consistency certificate, 128 roots, 32-slot certified blob band, IK 24 iters analytic-seeded",
                "angle_err_note": "per-joint wrist deviations equal the converged SciPy-TRF-from-truth bound on identical residuals (voxel-centroid quantization gauge freedom, IK_ORACLE.json; invariants: rmse_mm, tcp_err_mm, J1)",
                "device": _device_info(),
            }
        )
    )


if __name__ == "__main__":
    main()
