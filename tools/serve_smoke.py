"""Smoke of the serving surface: start the real HTTP worker with the engine
on the default backend, drive the demo scene through POST /estimate and
/entry over loopback, drive the simulated robot over /hw/move while
recording the /watch stream, and print one JSON line.

Proves the deployment path — HTTP transport -> format ingest -> fused
device pipeline -> certificates -> JSON contract — on hardware, not just
the CPU-mesh tests (tests/test_server.py covers the transport/logic on the
virtual mesh; this covers the device).

    python tools/serve_smoke.py [--spacing 3.0]
"""

import argparse
import json
import os
import sys
import tempfile
import threading
import time
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _req(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=1800) as r:
        return r.status, json.loads(r.read())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spacing", type=float, default=3.0)
    args = ap.parse_args()

    import numpy as np

    from mamri_tpu.api import MamriEngine
    from mamri_tpu.api.demo import build_demo_scene
    from mamri_tpu.api.server import MamriServer, make_http_server
    from mamri_tpu.perception.io import save_nifti

    eng = MamriEngine()
    vol, true_angles, _base, target = build_demo_scene(eng, spacing=args.spacing)
    scan = os.path.join(tempfile.mkdtemp(prefix="serve_smoke_"), "scan.nii.gz")
    save_nifti(scan, vol)

    core = MamriServer(engine=eng)
    httpd = make_http_server(core, port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = "http://%s:%d" % httpd.server_address[:2]

    t0 = time.perf_counter()
    st, est = _req(url + "/estimate", {"path": scan})
    t_est = time.perf_counter() - t0
    err_deg = (
        float(np.max(np.abs(np.asarray(est["angles_deg"]) - np.degrees(true_angles))))
        if est.get("success")
        else None
    )
    t0 = time.perf_counter()
    st2, ent = _req(url + "/entry", {"path": scan, "target": np.asarray(target).tolist()})
    t_ent = time.perf_counter() - t0

    # live execution mirror: attach the protocol simulator,
    # drive a move over POST /hw/move, and record the /watch SSE stream —
    # the reference's per-tick scene mirror + 4 Hz status panel, served.
    from mamri_tpu.hw.sim import simulated_hardware

    # ~1 s of motion = ~6 pose frames at the reference's 150 ms tick
    _stack, _robot, shutdown_sim = simulated_hardware(eng, speed_steps_per_s=2000.0)
    st3, moved = _req(url + "/hw/move", {"steps": [2000, 0, 0, 0, 0, 0], "timeout_s": 30})
    pose_frames = 0
    final_event = None
    if st3 == 200:
        with urllib.request.urlopen(url + "/watch?timeout=10", timeout=60) as r:
            for raw in r:
                line = raw.decode().strip()
                if not line.startswith("data: "):
                    continue
                fr = json.loads(line[6:])
                if fr.get("event") == "pose":
                    pose_frames += 1
                final_event = fr
    shutdown_sim()
    watch_ok = (
        st3 == 200
        and pose_frames >= 3
        and final_event is not None
        and final_event.get("event") == "task_finished"
        and final_event.get("outcome") == "success"
    )
    httpd.shutdown()
    httpd.server_close()

    import jax

    out = {
        "metric": "serve_smoke",
        "backend": jax.default_backend(),
        "device": str(jax.devices()[0]),
        "estimate_http_status": st,
        "estimate_success": bool(est.get("success")),
        "max_angle_err_deg": round(err_deg, 3) if err_deg is not None else None,
        "estimate_wall_s": round(t_est, 2),
        "entry_http_status": st2,
        "entry_success": bool(ent.get("success")),
        "entry_distance_mm": ent.get("distance_mm"),
        "entry_wall_s": round(t_ent, 2),
        "frames_served": core.frames_served,
        "watch": {
            "hw_move_http_status": st3,
            "streamed_pose_frames": pose_frames,
            "final_event": None if final_event is None else final_event.get("event"),
            "outcome": None if final_event is None else final_event.get("outcome"),
            "ok": watch_ok,
        },
    }
    print(json.dumps(out))
    ok = (
        st == 200 and st2 == 200 and out["estimate_success"] and out["entry_success"]
        and watch_ok
    )
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
