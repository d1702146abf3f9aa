"""Command-line surface for the framework (the headless counterpart of the
reference's Slicer panel): pose estimation, entry search, and path planning
over NIfTI / NRRD / MetaImage volumes or DICOM files and series
directories (format inferred from extension or magic bytes).

    python -m mamri_tpu estimate scan.nii.gz [--save-baseplate bp.npz] [--correction]
    python -m mamri_tpu entry    scan.nii.gz --target X Y Z
    python -m mamri_tpu plan     scan.nii.gz --target X Y Z [--entry X Y Z]
                                 [--safety 5.0] [--out plan.npz]
    python -m mamri_tpu convert scan_dir/ out.nii.gz
    python -m mamri_tpu convert scan.nii.gz series_out/ --transfer jpegls
    python -m mamri_tpu info
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _engine(args):
    from mamri_tpu.api import MamriEngine

    return MamriEngine(mesh_dir=getattr(args, "mesh_dir", None))


def _load(path):
    from mamri_tpu.perception.formats import load_volume

    try:
        # DICOM series dir / .dcm / NIfTI / NRRD / MetaImage, magic-sniffed
        return load_volume(path)
    except (OSError, ValueError) as e:
        print(json.dumps({"success": False, "message": f"cannot load volume: {e}"}))
        raise SystemExit(2)


def cmd_convert(args) -> int:
    """Volume format conversion over the ingest codecs: NIfTI <-> DICOM
    (per-slice series directory or Enhanced MR multi-frame file), any
    supported transfer syntax — a capability the reference outsources to
    Slicer's DICOM module."""
    import os

    from mamri_tpu.perception.formats import SAVE_EXTENSIONS, save_volume

    vol = _load(args.input)
    out = args.output
    if out.lower().endswith(SAVE_EXTENSIONS):
        save_volume(out, vol)
        written = [out]
    elif out.endswith(".dcm"):
        from mamri_tpu.perception.dicom import save_dicom_multiframe

        written = [save_dicom_multiframe(out, vol, series_number=args.series_number,
                                         transfer=args.transfer)]
    else:  # directory -> one file per slice
        from mamri_tpu.perception.dicom import save_dicom_series

        written = save_dicom_series(out, vol, series_number=args.series_number,
                                    transfer=args.transfer)
    print(json.dumps({
        "success": True,
        "files": len(written),
        "output": out,
        "shape": list(np.asarray(vol.data).shape),
        "spacing_mm": np.asarray(vol.spacing).tolist(),
        "bytes": int(sum(os.path.getsize(w) for w in written)),
    }))
    return 0


def cmd_info(args) -> int:
    from mamri_tpu.core.robot import load_robot_model
    from mamri_tpu import native

    m = load_robot_model()
    print(json.dumps({
        "links": list(m.link_names),
        "articulated": list(m.articulated_names),
        "motor_letters": list(m.motor_letters),
        "joint_limits_deg": np.rad2deg(np.asarray(m.limits_rad)).tolist(),
        "native_runtime": native.available(),
    }, indent=2))
    return 0


def cmd_estimate(args) -> int:
    eng = _engine(args)
    vol = _load(args.volume)
    if args.load_baseplate:
        eng.load_baseplate(args.load_baseplate)
    res = eng.estimate_pose(vol, use_saved_baseplate=bool(args.load_baseplate), apply_correction=args.correction)
    out = {
        "success": res.success,
        "message": res.message,
        "baseplate_source": res.baseplate_source,
        "markers_found": res.markers_found,
        "num_blobs": res.num_blobs,
    }
    if res.success:
        out.update(
            angles_deg=np.rad2deg(res.angles_rad).round(3).tolist(),
            steps=res.steps.tolist(),
            rmse_mm=round(res.rmse_mm, 4),
        )
        if args.save_baseplate:
            eng.save_baseplate(args.save_baseplate)
            out["saved_baseplate"] = args.save_baseplate
    print(json.dumps(out, indent=2))
    return 0 if res.success else 1


def cmd_entry(args) -> int:
    eng = _engine(args)
    vol = _load(args.volume)
    pose = eng.estimate_pose(vol)
    if eng.body_mask() is None:
        print(json.dumps({"success": False, "message": "no body segmentation found in scan"}))
        return 1
    ep = eng.find_entry_point(np.asarray(args.target, dtype=np.float32))
    out = {
        "success": bool(ep.found),
        "entry_ras": np.asarray(ep.point_ras).round(3).tolist(),
        "distance_mm": round(float(ep.distance_mm), 2),
        "normal_ras": np.asarray(ep.normal_ras).round(3).tolist(),
    }
    print(json.dumps(out, indent=2))
    return 0 if ep.found else 1


def cmd_plan(args) -> int:
    eng = _engine(args)
    vol = _load(args.volume)
    pose = eng.estimate_pose(vol, apply_correction=args.correction)
    if not pose.success:
        print(json.dumps({"success": False, "message": f"pose estimation failed: {pose.message}"}))
        return 1
    target = np.asarray(args.target, dtype=np.float32)
    if args.entry:
        entry = np.asarray(args.entry, dtype=np.float32)
    else:
        ep = eng.find_entry_point(target)
        if not bool(ep.found):
            print(json.dumps({"success": False, "message": "no suitable entry point within 80 mm"}))
            return 1
        entry = np.asarray(ep.point_ras)
    plan = eng.plan_heuristic_path(target, entry, args.safety, start_pose_steps=pose.steps)
    out = {
        "success": plan.success,
        "message": plan.message,
        "collision_detected": plan.collision_detected,
        "entry_ras": entry.round(3).tolist(),
    }
    if plan.success:
        out.update(
            goal_angles_deg=np.rad2deg(plan.goal_angles).round(3).tolist(),
            goal_steps=plan.goal_steps.tolist(),
            position_error_mm=round(plan.position_error_mm, 3),
            path_samples=len(plan.path),
        )
        if args.validate_exact:
            exact = eng.validate_plan_exact(plan)
            out["exact_validation"] = {
                k: exact[k]
                for k in (
                    "collision_free", "colliding_samples", "checked_samples",
                    "mode", "fast_checker_flagged", "over_conservative",
                )
            }
        if args.out:
            np.savez(args.out, path=plan.path, keyframes=plan.keyframes, goal_steps=plan.goal_steps)
            out["plan_file"] = args.out
    print(json.dumps(out, indent=2))
    return 0 if plan.success else 1


def cmd_export(args) -> int:
    if not (args.out_dir or args.scene or args.render or args.animate or args.seg):
        print(json.dumps({"success": False, "message": "give --out-dir (posed STLs), --scene (assembled OBJ/GLB/HTML), --render (PNG snapshot), --animate (trajectory-simulation HTML) and/or --seg (Slicer .seg.nrrd)"}))
        return 2
    eng = _engine(args)
    vol = _load(args.volume)
    pose = eng.estimate_pose(vol, apply_correction=args.correction)
    # segmentation runs before IK (as in the reference's process()), so --seg
    # delivers regardless of whether the pose itself is available
    pose_outputs = args.out_dir or args.scene or args.render or args.animate
    seg_path = None
    seg_warning = None
    if args.seg:
        if eng.body_mask() is None:
            if not pose_outputs:  # seg was the only deliverable
                print(json.dumps({"success": False, "message": "no body segmentation found in scan (--seg)"}))
                return 1
            # other outputs can still be produced — skip the seg, don't abort
            seg_warning = "no body segmentation found in scan; --seg skipped"
        else:
            seg_path = eng.export_segmentation(args.seg)
    if not pose.success:
        out = {
            "success": bool(seg_path) and not pose_outputs,
            "message": f"pose estimation failed: {pose.message}"
            + ("; segmentation exported" if seg_path else ""),
        }
        if seg_path:
            out["seg"] = seg_path
        print(json.dumps(out, indent=2))
        return 1 if pose_outputs else 0
    out = {"success": True, "angles_deg": np.rad2deg(pose.angles_rad).round(3).tolist()}
    if seg_path:
        out["seg"] = seg_path
    if seg_warning:
        out["seg_warning"] = seg_warning
    if args.out_dir:
        if not args.mesh_dir:
            print(json.dumps({"success": False, "message": "--out-dir requires --mesh-dir"}))
            return 2
        paths = eng.export_posed_meshes(args.out_dir, args.mesh_dir)
        if not paths:
            print(json.dumps({"success": False, "message": f"no mesh files found under {args.mesh_dir}"}))
            return 1
        out["meshes"] = paths
    if args.scene or args.render or args.animate:
        target = np.asarray(args.target, dtype=np.float32) if args.target else None
        entry = np.asarray(args.entry, dtype=np.float32) if args.entry else None
        if target is not None and entry is None:
            ep = eng.find_entry_point(target)
            if bool(ep.found):
                entry = np.asarray(ep.point_ras)
        if target is not None and entry is not None:
            plan = eng.plan_heuristic_path(target, entry, args.safety, start_pose_steps=pose.steps)
            out["trajectory_planned"] = bool(plan.success)
        body = "smooth" if args.smooth_body else "voxel"
        if args.scene:
            counts = eng.export_scene(
                args.scene, mesh_dir=args.mesh_dir, target_ras=target,
                entry_ras=entry, body_surface=body,
            )
            out["scene"] = args.scene
            out["scene_objects"] = counts
        if args.animate:
            if eng.trajectory_path is None:
                print(json.dumps({"success": False, "message": "--animate needs a planned trajectory: give --target (and optionally --entry)"}))
                return 2
            counts = eng.export_trajectory_html(
                args.animate, mesh_dir=args.mesh_dir, target_ras=target,
                entry_ras=entry, body_surface=body,
            )
            out["animate"] = args.animate
            out["animate_frames"] = counts["frames"]
        if args.render:
            az, el = args.view
            size = eng.render_scene(
                args.render, mesh_dir=args.mesh_dir, target_ras=target,
                entry_ras=entry, azim_deg=az, elev_deg=el, body_surface=body,
            )
            out["render"] = args.render
            out["render_size"] = list(size)
    print(json.dumps(out, indent=2))
    return 0


def cmd_demo(args) -> int:
    """Zero-input end-to-end demo: build the canonical synthetic scene
    (robot at a known pose + body phantom), write it as a scan, estimate
    the pose back, search an entry point, plan the collision-checked path,
    export the artifacts (scan.nrrd, body.seg.nrrd, plan.npz, scene.html),
    and optionally execute the plan on the protocol simulator. The
    reference cannot demo itself without a real scan in the scene."""
    import os

    from mamri_tpu.api.demo import build_demo_scene
    from mamri_tpu.perception.formats import save_volume

    eng = _engine(args)
    vol, true_angles, _, target = build_demo_scene(eng, spacing=args.spacing)
    os.makedirs(args.out_dir, exist_ok=True)

    def art(name):
        return os.path.join(args.out_dir, name)

    save_volume(art("scan.nrrd"), vol)
    pose = eng.estimate_pose(vol)
    out = {
        "success": pose.success,
        "scan": art("scan.nrrd"),
        "shape": list(vol.shape),
        "spacing_mm": float(args.spacing),
    }
    if not pose.success:
        out["message"] = f"pose estimation failed: {pose.message}"
        print(json.dumps(out, indent=2, default=_json_default))
        return 1
    out.update(
        angles_deg=np.rad2deg(pose.angles_rad).round(3).tolist(),
        true_angles_deg=np.rad2deg(true_angles).round(3).tolist(),
        rmse_mm=round(pose.rmse_mm, 4),
    )
    if eng.body_mask() is None:  # very coarse --spacing can lose the phantom
        out["success"] = False
        out["message"] = "no body segmentation found (try a finer --spacing)"
        print(json.dumps(out, indent=2, default=_json_default))
        return 1
    out["seg"] = eng.export_segmentation(art("body.seg.nrrd"))
    ep = eng.find_entry_point(target)
    if bool(ep.found):
        out["entry_ras"] = np.asarray(ep.point_ras).round(3).tolist()
        plan = eng.plan_heuristic_path(target, np.asarray(ep.point_ras), args.safety,
                                       start_pose_steps=pose.steps)
        out["plan_success"] = plan.success
        out["collision_detected"] = plan.collision_detected
        if plan.success:
            np.savez(art("plan.npz"), path=plan.path, keyframes=plan.keyframes,
                     goal_steps=plan.goal_steps)
            out["plan"] = art("plan.npz")
            eng.export_scene(art("scene.html"), target_ras=target,
                             entry_ras=np.asarray(ep.point_ras))
            out["scene"] = art("scene.html")
            if args.execute:
                from mamri_tpu.hw.sim import simulated_hardware

                stack, _, shutdown = simulated_hardware(eng)
                try:
                    stack.execute_trajectory(list(plan.keyframes), timeout_s=60.0)
                    state = stack.runner.run(tick_interval_s=0.01)
                    out["executed"] = state.outcome.name
                    out["final_steps"] = stack.encoder.latest_position
                finally:
                    shutdown()
    else:
        out["plan_success"] = False
        out["message"] = "no suitable entry point found"
    # keep the JSON success field and the exit status consistent: the demo
    # passed only if the plan succeeded AND (when requested) the simulated
    # execution arrived
    ok = bool(out.get("plan_success"))
    if args.execute and "executed" in out:
        ok = ok and out["executed"] == "SUCCESS"
    elif args.execute:
        ok = False
    out["success"] = ok
    print(json.dumps(out, indent=2, default=_json_default))
    return 0 if ok else 1


def _json_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")


def cmd_hw(args) -> int:
    """Hardware control — the reference's 'Connection & Manual Control' +
    execution buttons (Mamri.py:319-446, 367-432) as a CLI: move to a pose,
    execute a planned trajectory (`plan --out plan.npz` -> `hw exec`), jog
    one joint, home, zero the counters, or snapshot the live status table.
    `--sim` runs the full closed loop against the in-process simulator."""
    # pure argument validation FIRST — never open serial ports (handshakes,
    # sync traffic) just to report a typo
    if args.action == "move" and not (args.steps or args.degrees):
        print(json.dumps({"success": False, "message": "hw move needs --steps or --degrees (6 values)"}))
        return 2
    kf = None
    if args.action == "exec":
        if not args.plan:
            print(json.dumps({"success": False, "message": "hw exec needs --plan plan.npz (from `plan --out`)"}))
            return 2
        try:
            npz = np.load(args.plan)
            if "keyframes" not in npz:
                raise ValueError(f"{args.plan}: no 'keyframes' array (not a `plan --out` file?)")
            kf = npz["keyframes"]
        except (OSError, ValueError, KeyError) as e:
            print(json.dumps({"success": False, "message": f"cannot read plan: {e}"}))
            return 2

    eng = _engine(args)
    shutdown = None
    try:
        if args.sim:
            from mamri_tpu.hw.sim import simulated_hardware

            stack, _, shutdown = simulated_hardware(eng, speed_steps_per_s=args.sim_speed)
        else:
            if not args.ports:
                print(json.dumps({"success": False, "message": "give --ports CONTROLLER ENCODER serial devices, or --sim"}))
                return 2
            from mamri_tpu.hw.transport import SerialTransport

            stack = eng.attach_hardware(SerialTransport(args.ports[0]), SerialTransport(args.ports[1]))
            shutdown = stack.disconnect
    except (OSError, RuntimeError) as e:
        print(json.dumps({"success": False, "message": f"hardware connection failed: {e}"}))
        return 1
    stop_sync = None
    try:
        if args.sync:
            stop_sync = stack.start_sync_loop()
        out = {"success": True, "action": args.action}
        if args.action == "status":
            out["status"] = stack.status()
            out["joints"] = stack.joint_status_table()
        elif args.action == "watch":
            # the always-on live status panel (reference: 40 ms poll with
            # 4 Hz heavy updates, Mamri.py:120, :595): passive encoder-state
            # frames at 4 Hz for --duration seconds, one JSON line each —
            # works with a robot commanded by ANY controller, no task needed
            import time as _time

            t_end = _time.time() + args.duration
            while _time.time() < t_end:
                fr = stack.passive_status()
                fr["t"] = _time.time()
                if fr["encoder_steps"] is not None:
                    angles = eng.convert_steps_to_angles(np.asarray(fr["encoder_steps"]))
                    eng.set_pose(angles)  # mirror into the engine scene state
                    fr["angles_deg"] = np.rad2deg(angles).round(3).tolist()
                print(json.dumps(fr, default=_json_default), flush=True)
                _time.sleep(0.25)
            out["frames"] = "streamed"
        elif args.action == "zero-hardware":
            stack.zero_hardware()
            out["status"] = stack.status()
        else:
            if args.action == "move":
                if args.degrees:
                    steps = eng.convert_angles_to_steps(np.deg2rad(np.asarray(args.degrees, np.float64)))
                else:
                    steps = np.asarray(args.steps, dtype=int)
                stack.move_to_pose([int(s) for s in steps], timeout_s=args.timeout)
            elif args.action == "exec":
                stack.execute_trajectory(list(kf), timeout_s=args.timeout)
            elif args.action == "jog":
                stack.jog(args.joint - 1, args.delta, timeout_s=args.timeout)
            elif args.action == "zero":
                stack.return_to_zero(timeout_s=args.timeout)
            watcher = None
            if args.watch and stack.stream is not None:
                # live execution mirror on stdout: one JSON line per control
                # tick (the reference's per-tick scene update, Mamri.py:537)
                import threading

                def _print_frames():
                    for fr in stack.watch(idle_timeout_s=max(args.tick * 4, 1.0)):
                        print(json.dumps(fr, default=_json_default), flush=True)

                watcher = threading.Thread(target=_print_frames, daemon=True)
                watcher.start()
            try:
                state = stack.runner.run(tick_interval_s=args.tick)
            except KeyboardInterrupt:
                # the reference's STOP button: hold at the current position
                # (soft stop) — never leave the controller driving to the old
                # target after the CLI exits
                stack.runner.request_stop()
                stack.controller.soft_stop()
                print(json.dumps({"success": False, "action": args.action,
                                  "outcome": "STOPPED",
                                  "message": "interrupted: soft stop issued (controller holds current position)"}))
                return 1
            if watcher is not None:
                watcher.join(timeout=max(args.tick * 8, 2.0))
            out["outcome"] = state.outcome.name
            out["message"] = state.message
            out["success"] = state.outcome.name == "SUCCESS"
            out["final_status"] = stack.status()
    except (RuntimeError, ValueError, OSError) as e:
        print(json.dumps({"success": False, "action": args.action, "message": str(e)}))
        return 1
    finally:
        if stop_sync is not None:
            stop_sync()
        if shutdown is not None:
            shutdown()
    print(json.dumps(out, indent=2, default=_json_default))
    return 0 if out["success"] else 1


def cmd_serve(args) -> int:
    """Production worker: one warm engine behind HTTP/JSON (api/server.py).
    Exit code 3 = a budget drained the worker; the supervisor should start
    a fresh process."""
    import logging

    from mamri_tpu.api.server import MamriServer, serve, supervise

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    if args.host not in ("127.0.0.1", "localhost", "::1"):
        # on a non-loopback bind, path-mode reads and /shutdown
        # become remote surfaces — demand explicit jailing/tokens
        if args.data_root is None:
            logging.getLogger(__name__).warning(
                "binding %s without --data-root: JSON path requests can read "
                "any server-side file the worker can; pass --data-root to jail them",
                args.host,
            )
        if args.shutdown_token is None:
            logging.getLogger(__name__).warning(
                "binding %s without --shutdown-token: POST /shutdown is "
                "unauthenticated and will drain this worker", args.host,
            )
    if args.supervise:
        # re-exec ourselves as the worker; the parent only respawns on rc=3
        worker_argv = ["serve"]
        for flag, val in (("--host", args.host), ("--port", args.port),
                          ("--data-root", args.data_root), ("--max-rss-mb", args.max_rss_mb),
                          ("--max-frames", args.max_frames), ("--baseplate", args.baseplate),
                          ("--platform", args.platform), ("--mesh-dir", args.mesh_dir),
                          ("--shutdown-token", args.shutdown_token)):
            if val is not None:
                worker_argv += [flag, str(val)]
        if args.sim_hw:
            worker_argv += ["--sim-hw"]
        return supervise(worker_argv, max_restarts=args.max_restarts)
    if args.platform:
        # before any backend touch: the config API wins over JAX_PLATFORMS
        import jax

        jax.config.update("jax_platforms", args.platform)
    eng = _engine(args)
    if args.baseplate:
        eng.load_baseplate(args.baseplate)
    shutdown_sim = None
    if args.sim_hw:
        # demo/deployment rig: the worker serves /hw/move, /hw/exec, /hw/stop
        # and the /watch live mirror against the in-process simulator
        from mamri_tpu.hw.sim import simulated_hardware

        _stack, _robot, shutdown_sim = simulated_hardware(eng)
    core = MamriServer(
        engine=eng,
        data_root=args.data_root,
        max_rss_mb=args.max_rss_mb,
        max_frames=args.max_frames,
        shutdown_token=args.shutdown_token,
    )
    try:
        return serve(core, host=args.host, port=args.port)
    finally:
        if shutdown_sim is not None:
            shutdown_sim()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="mamri_tpu", description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("info", help="robot definition + runtime summary")

    pe = sub.add_parser("estimate", help="scan -> joint angles")
    pe.add_argument("volume", help="volume: .nii/.nii.gz, .nrrd/.nhdr, .mha/.mhd, .dcm, or a DICOM series directory")
    pe.add_argument("--correction", action="store_true", help="apply 180-deg end-effector correction")
    pe.add_argument("--save-baseplate", default=None)
    pe.add_argument("--load-baseplate", default=None)
    pe.add_argument("--mesh-dir", default=None)

    pn = sub.add_parser("entry", help="find a suitable skin entry point")
    pn.add_argument("volume")
    pn.add_argument("--target", nargs=3, type=float, required=True, metavar=("X", "Y", "Z"))
    pn.add_argument("--mesh-dir", default=None)

    pp = sub.add_parser("plan", help="collision-checked up-over-down path")
    pp.add_argument("volume")
    pp.add_argument("--target", nargs=3, type=float, required=True, metavar=("X", "Y", "Z"))
    pp.add_argument("--entry", nargs=3, type=float, default=None, metavar=("X", "Y", "Z"))
    pp.add_argument("--safety", type=float, default=5.0, help="standoff distance mm (default 5)")
    pp.add_argument("--correction", action="store_true")
    pp.add_argument("--out", default=None, help="write path/keyframes to .npz")
    pp.add_argument("--mesh-dir", default=None)
    pp.add_argument("--validate-exact", action="store_true", help="triangle-exact host validation of the final path (undilated body, dense hulls) — reports per-sample contacts and over-conservative fast-checker rejections")

    px = sub.add_parser("export", help="write FK-posed robot meshes (STL) and/or an assembled scene (OBJ)")
    px.add_argument("volume", help="scan to estimate the pose from")
    px.add_argument("--mesh-dir", default=None, help="directory with the robot STL meshes (optional for --scene: capsules stand in)")
    px.add_argument("--out-dir", default=None, help="write per-link FK-posed STLs here")
    px.add_argument("--scene", default=None, help="write one assembled scene (robot + needle + body + trajectory); OBJ, binary glTF (.glb), or a self-contained interactive WebGL viewer (.html)")
    px.add_argument("--render", default=None, help="write a PNG snapshot of the scene (software rasterizer)")
    px.add_argument("--seg", default=None, help="write the body segmentation as a Slicer-loadable .seg.nrrd segmentation node")
    px.add_argument("--animate", default=None, help="write an interactive trajectory-simulation HTML (slider + play at 50 ms) — requires --target")
    px.add_argument("--view", nargs=2, type=float, default=(35.0, 22.0), metavar=("AZIM", "ELEV"))
    px.add_argument("--smooth-body", action="store_true", help="marching-tetrahedra body surface instead of exact voxel faces")
    px.add_argument("--target", nargs=3, type=float, default=None, metavar=("X", "Y", "Z"), help="plan + include a trajectory in the scene")
    px.add_argument("--entry", nargs=3, type=float, default=None, metavar=("X", "Y", "Z"))
    px.add_argument("--safety", type=float, default=5.0)
    px.add_argument("--correction", action="store_true")

    pc = sub.add_parser("convert", help="convert volumes between NIfTI / NRRD / MetaImage / DICOM series or multi-frame, any supported transfer syntax")
    pc.add_argument("input", help="any supported volume (NIfTI/NRRD/MetaImage/.dcm/series dir)")
    pc.add_argument("output", help=".nii/.nii.gz, .nrrd, .mha/.mhd, .dcm (Enhanced multi-frame), or a directory (per-slice series)")
    pc.add_argument("--transfer", default="explicit_le",
                    choices=["explicit_le", "deflated", "rle", "jpegll", "jpegls", "j2k"],
                    help="DICOM transfer syntax for DICOM outputs (default explicit_le)")
    pc.add_argument("--series-number", type=int, default=1)

    pd = sub.add_parser("demo", help="zero-input end-to-end demo on the canonical synthetic scene (scan -> pose -> entry -> plan -> scene.html; --execute runs the simulator)")
    pd.add_argument("--out-dir", default="mamri_demo", help="artifact directory (default ./mamri_demo)")
    pd.add_argument("--spacing", type=float, default=3.0, help="scene voxel spacing mm (larger = faster, default 3.0)")
    pd.add_argument("--safety", type=float, default=5.0, help="needle standoff mm")
    pd.add_argument("--execute", action="store_true", help="execute the planned trajectory on the protocol simulator")

    ps = sub.add_parser("serve", help="long-lived HTTP/JSON worker: POST /estimate /entry /plan, GET /healthz /status; exits 3 when an RSS/frame budget drains the worker (supervisor: restart)")
    ps.add_argument("--host", default="127.0.0.1")
    ps.add_argument("--port", type=int, default=8420)
    ps.add_argument("--data-root", default=None, help="jail JSON 'path' requests under this directory")
    ps.add_argument("--max-rss-mb", type=float, default=None, help="drain the worker once host RSS exceeds this many MB")
    ps.add_argument("--max-frames", type=int, default=None, help="drain the worker after this many compute requests")
    ps.add_argument("--baseplate", default=None, help="preload a saved baseplate transform (.npz)")
    ps.add_argument("--platform", default=None, help="pin the jax platform for this worker (e.g. cpu); default: the runtime's choice")
    ps.add_argument("--supervise", action="store_true", help="built-in supervisor: respawn the worker whenever a budget drains it (exit 3)")
    ps.add_argument("--max-restarts", type=int, default=None, help="with --supervise: give up after this many recycles")
    ps.add_argument("--mesh-dir", default=None)
    ps.add_argument("--sim-hw", action="store_true", help="attach the in-process hardware simulator: serves /hw/move /hw/exec /hw/stop and the /watch live execution mirror")
    ps.add_argument("--shutdown-token", default=None, help="require this token in POST /shutdown bodies (recommended on non-loopback binds)")

    ph = sub.add_parser("hw", help="hardware control: status / move / exec / jog / zero / zero-hardware over serial or the built-in simulator")
    ph.add_argument("action", choices=["status", "watch", "move", "exec", "jog", "zero", "zero-hardware"])
    ph.add_argument("--ports", nargs=2, metavar=("CONTROLLER", "ENCODER"), default=None, help="serial devices (e.g. /dev/ttyUSB0 /dev/ttyUSB1)")
    ph.add_argument("--sim", action="store_true", help="drive the in-process protocol simulator instead of real serial")
    ph.add_argument("--sim-speed", type=float, default=1500.0, help="simulated motor speed, steps/s")
    ph.add_argument("--steps", nargs=6, type=int, default=None, metavar="S", help="move: absolute per-joint steps")
    ph.add_argument("--degrees", nargs=6, type=float, default=None, metavar="D", help="move: absolute per-joint angles in degrees")
    ph.add_argument("--plan", default=None, help="exec: plan .npz written by `plan --out` (keyframes)")
    ph.add_argument("--joint", type=int, default=1, choices=range(1, 7), help="jog: joint number 1-6")
    ph.add_argument("--delta", type=int, default=100, help="jog: step delta")
    ph.add_argument("--timeout", type=float, default=120.0, help="task timeout seconds (reference: 120 s)")
    ph.add_argument("--tick", type=float, default=0.15, help="control-loop tick seconds (reference: 150 ms)")
    ph.add_argument("--sync", action="store_true", help="run the encoder<->controller sync monitor during the task")
    ph.add_argument("--watch", action="store_true", help="print one JSON pose frame per control tick during the task (live execution mirror)")
    ph.add_argument("--duration", type=float, default=10.0, help="watch action: seconds to stream passive status frames (4 Hz)")

    args = ap.parse_args(argv)
    return {
        "info": cmd_info,
        "estimate": cmd_estimate,
        "entry": cmd_entry,
        "plan": cmd_plan,
        "export": cmd_export,
        "convert": cmd_convert,
        "demo": cmd_demo,
        "serve": cmd_serve,
        "hw": cmd_hw,
    }[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
