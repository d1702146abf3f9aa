"""Smoke test of the main path on an NVIDIA GPU: scan -> joint angles at real
sizes, through the public API, compared with the plain references.

    python chip_smoke.py          # one card: phases 0, 1, 3-7
    python chip_smoke.py --four   # four cards: the dp and dp x sp meshes only

Phases (one JSON line each; the first failure stops the run with a nonzero
exit and no result line):

  0 device      platform, device kind and count, JAX version, the card's
                name and power limit (nvidia-smi), the compile-cache path
  1 precision   FK at the zero pose and a needle-tip product against
                float64 numpy (an f32 dot may otherwise run in TF32)
  (2 kernel parity: the repository has no hand-written kernel; XLA compiles
                every stage)
  3 reference   GPU segmentation of a 256^3 bench scene against the
                scipy.ndimage oracle (perception/reference_cpu.py)
  4 main path   estimate_pose and estimate_pose_batch (16 x 256^3), the
                1,500-speckle noisy scene from the engine defaults (the
                escalation ladder runs), and one 512x512x192 volume: every
                result certified and solved by the bench's invariants
  5 planning    entry search, the heuristic path (collision-free), the
                8-distance safety sweep
  6 streaming   PoseTracker: sync f32, int16, ROI window, pipelined
  7 served      MamriServer over loopback HTTP: /estimate, /estimate_batch,
                /entry, /plan, /healthz

Timings are informational (wall clock, first call incl. compile apart from
a repeat call) and claim nothing. The last line is exactly
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import mamri_tpu  # noqa: E402  (configures the compile cache before jax loads)

import numpy as np  # noqa: E402

if os.path.dirname(os.path.abspath(mamri_tpu.__file__)) != os.path.join(HERE, "mamri_tpu"):
    # smoke the checkout this script sits in, never another installed copy
    raise SystemExit(f"mamri_tpu imported from {mamri_tpu.__file__}, not from {HERE}")

SIZE = 256
LARGE_SHAPE = (512, 512, 192)
BATCH = 16
N_SPECKLE = 1500
SWEEP_MM = [2.0, 5.0, 7.5, 10.0, 12.5, 15.0, 17.5, 20.0]
# the bench's "solved" invariants (markers sit only on Baseplate/J2/J4/J6,
# so the TCP position and the directly observed J1 are the honest checks)
MAX_RMSE_MM = 1.5
MAX_TCP_MM = 2.0
MAX_J1_DEG = 1.5


class SmokeFailure(AssertionError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


# ---------------------------------------------------------------- phase 0
def device_info():
    """The device JAX found; raises unless it is a GPU (no CPU fallback)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SmokeFailure(f"no GPU: JAX's first device is on {dev.platform!r}")
    return {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}


def phase_device(device):
    import jax

    smi = nvidia_smi()
    for line in smi.splitlines():
        print(line, flush=True)  # the card's name and power limit, as given
    emit({
        "phase": 0, "name": "device", **device, "jax": jax.__version__,
        "nvidia_smi": smi, "compile_cache": mamri_tpu.compile_cache_dir(),
    })
    return smi


# ---------------------------------------------------------------- phase 1
def phase_precision(engine):
    import jax.numpy as jnp

    from mamri_tpu.api.demo import DEMO_ANGLES, demo_base_tf
    from mamri_tpu.core import transforms as T
    from mamri_tpu.core.robot import fk_all_links, fk_all_links_host

    z = np.asarray(fk_all_links(engine.model, jnp.zeros(engine.model.num_joints))[:, 2, 3])
    want = np.array([0, 20, 50, 200, 200, 355, 368, 439], dtype=np.float64)
    check(np.allclose(z, want, atol=1e-3), f"zero-pose link z {z.tolist()} != {want.tolist()}")

    angles = np.asarray(DEMO_ANGLES, dtype=np.float32)
    base = demo_base_tf(0.15)
    needle = engine.model.link_index("Needle")
    tip_local = np.asarray(engine.model.needle_tip, dtype=np.float64)
    tf = fk_all_links(engine.model, jnp.asarray(angles), jnp.asarray(base))[needle]
    tip = np.asarray(T.apply(tf, jnp.asarray(tip_local, jnp.float32)[None])[0], np.float64)
    tf64 = fk_all_links_host(engine.model, angles.astype(np.float64), base.astype(np.float64))[needle]
    tip64 = tf64[:3, :3] @ tip_local + tf64[:3, 3]
    err = float(np.abs(tip - tip64).max())
    # f32 keeps ~1e-5 mm at these coordinates; TF32 would lose ~0.1 mm
    check(err < 1e-3, f"needle tip differs from float64 by {err} mm")
    emit({"phase": 1, "name": "precision", "zero_pose_z": z.tolist(), "needle_tip_err_mm": err})


# ---------------------------------------------------------------- phase 3
def phase_reference(engine, vol):
    import jax.numpy as jnp

    from mamri_tpu.perception.reference_cpu import segment_reference
    from mamri_tpu.perception.segmentation import segment_volume

    res = segment_volume(jnp.asarray(vol.data), vol.spacing, vol.origin, engine.seg_params)
    check(
        bool(res.ccl_converged) and bool(res.roots_complete) and bool(res.blobs_complete),
        "segmentation uncertified at the engine defaults",
    )
    ref = segment_reference(vol)
    voxvol = float(np.prod(np.asarray(vol.spacing, np.float64)))
    n = int(res.num_blobs)
    got_counts = np.rint(np.asarray(res.volumes_mm3)[:n] / voxvol).astype(int)
    want_counts = np.rint(ref.volumes_mm3 / voxvol).astype(int)
    check(int(res.num_components) == ref.num_components,
          f"components {int(res.num_components)} != reference {ref.num_components}")
    check(n == len(ref.volumes_mm3), f"blobs {n} != reference {len(ref.volumes_mm3)}")
    check(np.array_equal(got_counts, want_counts), "blob voxel counts differ from the reference")
    # f32 sums in another order than the float64 oracle: 1e-3 mm
    cerr = float(np.abs(np.asarray(res.centroids_ras)[:n] - ref.centroids_ras).max()) if n else 0.0
    check(cerr < 1e-3, f"centroids differ from the reference by {cerr} mm")
    body_rel = abs(float(res.body_volume_mm3) - ref.body_volume_mm3) / max(ref.body_volume_mm3, 1e-9)
    check(body_rel < 1e-6, f"body volume differs from the reference by {body_rel} (relative)")
    emit({
        "phase": 3, "name": "reference", "shape": list(vol.data.shape),
        "components": int(res.num_components), "blobs": n,
        "centroid_max_err_mm": cerr, "body_volume_rel_err": body_rel,
    })


# ---------------------------------------------------------------- phase 4
def solved(engine, angles_est, rmse, truth):
    """Bench invariants: marker RMSE, TCP position, directly observed J1."""
    import jax.numpy as jnp

    from mamri_tpu.core.robot import fk_all_links

    true_angles, base = truth
    tcp = [
        np.asarray(fk_all_links(engine.model, jnp.asarray(a, jnp.float32), jnp.asarray(base)))[-1][:3, 3]
        for a in (true_angles, angles_est)
    ]
    tcp_err = float(np.linalg.norm(tcp[0] - tcp[1]))
    j1_err = float(np.degrees(abs(float(angles_est[0]) - float(true_angles[0]))))
    ok = rmse < MAX_RMSE_MM and tcp_err < MAX_TCP_MM and j1_err < MAX_J1_DEG
    return ok, {"rmse_mm": float(rmse), "tcp_err_mm": tcp_err, "j1_err_deg": j1_err}


def _certified(out) -> bool:
    return bool(
        np.all(out["seg_converged"]) and np.all(out["roots_complete"]) and np.all(out["blobs_complete"])
    )


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _estimate(engine, vol, truth, what):
    est, t_first = _timed(lambda: engine.estimate_pose(vol))
    check(est.success, f"{what}: estimate failed ({est.message})")
    check(_certified(engine.last_segmentation), f"{what}: segmentation uncertified")
    ok, err = solved(engine, est.angles_rad, est.rmse_mm, truth)
    check(ok, f"{what}: not solved {err}")
    _, t_repeat = _timed(lambda: engine.estimate_pose(vol, store_state=False))
    return {"first_call_s": t_first, "repeat_s": t_repeat, **err}


def phase_main_path(engine, scene):
    vols, truths = scene["vols"], scene["truths"]
    rows = {"estimate_pose": _estimate(engine, vols[0], truths[0], "estimate_pose scene 0")}

    batch = np.stack([vols[i % len(vols)].data for i in range(scene["batch"])])
    spacing, origin = vols[0].spacing, vols[0].origin
    out, t_first = _timed(lambda: engine.estimate_pose_batch(batch, spacing, origin))
    check(bool(np.all(out["success"])), "estimate_pose_batch: a volume failed")
    check(_certified(out), "estimate_pose_batch: uncertified")
    worst = {}
    for i in range(batch.shape[0]):
        ok, err = solved(engine, out["angles"][i], out["rmse"][i], truths[i % len(vols)])
        check(ok, f"estimate_pose_batch volume {i}: not solved {err}")
        worst = {k: max(worst.get(k, 0.0), v) for k, v in err.items()}
    _, t_repeat = _timed(lambda: engine.estimate_pose_batch(batch, spacing, origin))
    rows["estimate_pose_batch"] = {
        "batch": int(batch.shape[0]), "first_call_s": t_first, "repeat_s": t_repeat, **worst,
    }

    rows["noisy"] = _estimate(engine, scene["noisy"], truths[0], "noisy scene")
    rows["noisy"]["components"] = int(engine.last_segmentation["num_components"])
    rows["large"] = _estimate(engine, scene["large"], truths[0], "large volume")
    rows["large"]["shape"] = list(scene["large"].data.shape)
    emit({"phase": 4, "name": "main_path", **rows})


# ---------------------------------------------------------------- phase 5
def phase_planning(engine, scene):
    est = engine.estimate_pose(scene["vols"][0])
    check(est.success, "planning: pose estimate failed")
    target = scene["target"]
    ep, t_entry = _timed(lambda: engine.find_entry_point(target))
    check(bool(ep.found), "planning: no entry point")
    plan, t_path = _timed(
        lambda: engine.plan_heuristic_path(target, ep.point_ras, 5.0, start_pose_steps=est.steps)
    )
    check(plan.success and not plan.collision_detected, f"planning: path failed ({plan.message})")
    sweep, t_sweep = _timed(lambda: engine.plan_trajectory_sweep(target, ep.point_ras, SWEEP_MM))
    n_ok = int(np.sum(np.asarray(sweep.success)))
    check(n_ok > 0, "planning: no safety distance of the sweep solved")
    emit({
        "phase": 5, "name": "planning", "entry_distance_mm": float(ep.distance_mm),
        "path_samples": int(len(plan.path)), "sweep_solved": n_ok, "sweep_distances": len(SWEEP_MM),
        "entry_s": t_entry, "path_s": t_path, "sweep_s": t_sweep,
    })


# ---------------------------------------------------------------- phase 6
def phase_streaming(engine, scene, frames: int = 3):
    from mamri_tpu.api.streaming import PoseTracker
    from mamri_tpu.perception.volume import Volume

    vols = scene["vols"]
    spacing, origin = vols[0].spacing, vols[0].origin

    def frame(i, dtype=np.float32):
        return Volume(data=np.asarray(vols[i % len(vols)].data).astype(dtype), spacing=spacing, origin=origin)

    rows = {}
    for mode, dtype in (("sync_f32", np.float32), ("sync_int16", np.int16)):
        tr = PoseTracker(engine)
        results = [tr.step(frame(i, dtype)) for i in range(frames)]
        check(all(r.success for r in results), f"streaming {mode}: a frame failed")
        rows[mode] = tr.stats()

    tr = PoseTracker(engine, roi_margin_mm=40.0)
    results = [tr.step(frame(0, np.int16)) for _ in range(frames)]
    check(all(r.success for r in results), "streaming roi: a frame failed")
    check(tr.roi_frames >= 1, "streaming roi: no frame used the ROI window")
    rows["roi_int16"] = tr.stats()

    tr = PoseTracker(engine, pipelined=True)
    results = [tr.step(frame(i)) for i in range(frames)]
    results = [r for r in results if r is not None] + tr.flush()
    check(len(results) == frames and all(r.success for r in results), "streaming pipelined: a frame failed")
    rows["pipelined"] = tr.stats()
    emit({"phase": 6, "name": "streaming", **rows})


# ---------------------------------------------------------------- phase 7
def _request(url, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=1200) as r:
        return r.status, json.loads(r.read())


def phase_served(engine, scene):
    from mamri_tpu.api.server import MamriServer, make_http_server
    from mamri_tpu.perception.io import save_nifti

    target = np.asarray(scene["target"]).tolist()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        scan = os.path.join(tmp, "scan.nii")
        save_nifti(scan, scene["vols"][0])
        core = MamriServer(engine=engine)
        httpd = make_http_server(core, host="127.0.0.1", port=0)
        server = threading.Thread(target=httpd.serve_forever, daemon=True)
        server.start()
        url = "http://%s:%d" % httpd.server_address[:2]
        try:
            rows = {}
            for route, payload in (
                ("/estimate", {"path": scan}),
                ("/estimate_batch", {"paths": [scan, scan]}),
                ("/entry", {"path": scan, "target": target}),
                ("/plan", {"path": scan, "target": target}),
            ):
                (status, body), t = _timed(lambda: _request(url + route, payload))
                check(status == 200 and body.get("success"), f"served {route}: {status} {body}")
                rows[route] = {"status": status, "s": t}
            status, body = _request(url + "/healthz")
            check(status == 200 and body.get("ok"), f"served /healthz: {status} {body}")
            rows["/healthz"] = {"status": status}
        finally:
            httpd.shutdown()
            httpd.server_close()
            server.join(timeout=30)
    emit({"phase": 7, "name": "served", **rows})


# ------------------------------------------------------------------ scenes
def build_scene(engine, size=SIZE, large_shape=LARGE_SHAPE, batch=BATCH, n_speckle=N_SPECKLE):
    """The bench's scenes: 4 poses on one size^3 grid, the noisy variant of
    scene 0 and scene 0 at the large anisotropic shape."""
    from mamri_tpu.api.demo import add_speckle, bench_scenes, bench_volume
    from mamri_tpu.perception.volume import Volume

    scenes, spacing, origin, body_center = bench_scenes(engine, size)
    vols = [bench_volume(p, (size,) * 3, spacing, origin, body_center) for _, _, p in scenes]
    lspacing = (spacing * size / np.asarray(large_shape)).astype(np.float32)
    large = bench_volume(scenes[0][2], large_shape, lspacing, origin, body_center)
    noisy = Volume(add_speckle(vols[0].data, n_speckle), spacing, origin)
    return {
        "vols": vols, "truths": [(a, b) for a, b, _ in scenes], "large": large,
        "noisy": noisy, "batch": batch,
        "target": (np.asarray(body_center) + np.array([0.0, 0.0, -15.0])).astype(np.float32),
    }


# ------------------------------------------------------------- four cards
def four_cards(engine, scene):
    """dp=4 over 16 x 256^3 and dp=2 x sp=2 over 4 x 512x512x192, each
    against one card running the same per-device batch.

    Certificates, component and blob counts and success must be equal, and
    every volume solved by the bench's invariants. Angles are compared with
    a TCP bound, not bit for bit: XLA's GPU programs for another device
    count or batch size round differently in the last bits, and the wrist
    joints move those bits into hundredths of a degree at sub-mm RMSE (the
    gauge freedom of ARCHITECTURE §4a). The angle differences are printed."""
    import jax
    import jax.numpy as jnp

    from mamri_tpu.core.robot import fk_all_links
    from mamri_tpu.parallel import make_mesh, run_sharded_batched

    check(len(jax.devices()) >= 4, f"--four needs 4 devices, JAX found {len(jax.devices())}")
    vols, truths = scene["vols"], scene["truths"]
    spacing, origin = vols[0].spacing, vols[0].origin
    batch = np.stack([vols[i % len(vols)].data for i in range(scene["batch"])])
    large = np.stack([scene["large"].data] * 4)
    lsp, lorg = scene["large"].spacing, scene["large"].origin
    ints = ("num_components", "num_blobs", "success", "seg_converged", "roots_complete", "blobs_complete")

    def on_one_card(data, sp, org, per_call):
        outs = [engine.estimate_pose_batch(data[i : i + per_call], sp, org)
                for i in range(0, data.shape[0], per_call)]
        return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}

    def tcp(angles, base):
        tf = fk_all_links(engine.model, jnp.asarray(angles, jnp.float32), jnp.asarray(base))
        return np.asarray(tf)[-1][:3, 3]

    def compare(name, got, ref, cert, vol_truths):
        row = {
            "bit_exact": bool(np.array_equal(got["angles"], ref["angles"])),
            "max_angle_diff_deg": float(np.degrees(np.abs(got["angles"] - ref["angles"])).max()),
            "max_tcp_diff_mm": max(
                float(np.linalg.norm(tcp(g, t[1]) - tcp(r, t[1])))
                for g, r, t in zip(got["angles"], ref["angles"], vol_truths)
            ),
            "certified": bool(cert),
            "counts_equal": all(np.array_equal(got[k], ref[k]) for k in ints),
            "solved": all(
                solved(engine, a, e, t)[0] for a, e, t in zip(got["angles"], got["rmse"], vol_truths)
            ),
        }
        return row

    single = on_one_card(batch, spacing, origin, batch.shape[0] // 4)
    (dp_out, _, dp_cert), t_dp = _timed(
        lambda: run_sharded_batched(engine, make_mesh(4, axes=("dp",)), batch, spacing, origin)
    )
    batch_truths = [truths[i % len(vols)] for i in range(batch.shape[0])]
    dp = compare("dp4", dp_out, single, dp_cert, batch_truths)

    single_l = on_one_card(large, lsp, lorg, 2)
    (sp_out, _, sp_cert), t_sp = _timed(
        lambda: run_sharded_batched(
            engine, make_mesh(4, axes=("dp", "sp"), shape=(2, 2)), large, lsp, lorg, sp_axis="sp"
        )
    )
    sp = compare("dp2sp2", sp_out, single_l, sp_cert, [truths[0]] * 4)
    emit({
        "phase": "four",
        "dp4": {"batch": int(batch.shape[0]), "first_call_s": t_dp, **dp},
        "dp2sp2": {"batch": 4, "shape": list(scene["large"].data.shape), "first_call_s": t_sp, **sp},
    })
    for name, row in (("dp=4", dp), ("dp=2 x sp=2", sp)):
        check(row["certified"] and row["counts_equal"], f"{name}: certificates or counts differ from one card")
        check(row["solved"], f"{name}: a volume is not solved")
        check(row["max_tcp_diff_mm"] < 0.1, f"{name}: TCP differs from one card by {row['max_tcp_diff_mm']} mm")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="main-path smoke test on an NVIDIA GPU")
    ap.add_argument("--four", action="store_true", help="run only the four-card mesh path")
    args = ap.parse_args(argv)

    device = device_info()  # fails before printing anything off a GPU
    phase_device(device)

    from mamri_tpu.api import MamriEngine

    engine = MamriEngine()
    scene = build_scene(engine)
    if args.four:
        four_cards(engine, scene)
    else:
        phase_precision(engine)
        phase_reference(engine, scene["vols"][0])
        phase_main_path(engine, scene)
        phase_planning(engine, scene)
        phase_streaming(engine, scene)
        phase_served(engine, scene)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
