"""Multi-generation serving soak: frames through `serve --supervise` until
the RSS budget has recycled the worker >= N times.

Worker recycling bounds a long-running worker's host memory
(`--max-rss-mb` drains the worker, exit 3, the built-in supervisor
respawns it). This tool PROVES the budget bounds memory across
generations on the accelerator: it launches the actual CLI supervisor, streams
path-mode /estimate frames at it, rides through the recycle windows
(503 drain -> connection reset -> fresh worker), and records per-generation
frame counts and the worker RSS trajectory.

Prints one JSON line (SOAK_SUPERVISED artifact):
  {"generations": G, "frames": N, "failures": 0,
   "rss_at_drain_mb": [...], "max_rss_mb": ..., "budget_mb": ...,
   "frames_per_generation": [...], "leak_mb_per_frame": ...}

Usage: python tools/soak_supervised.py [--size 128] [--generations 3]
       [--budget-headroom-mb 400] [--out FILE]
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

PORT = 20000 + (os.getpid() % 20000)  # fresh port per run: no stale-listener collisions


def _read(r):
    try:
        return json.loads(r.read() or b"{}")
    except (ValueError, OSError):
        return {}


def _get(url, timeout=600):
    # urlopen raises HTTPError for 4xx/5xx — a 503 drain is DATA here, not
    # an exception; read its payload instead of treating it as dead
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, _read(r)
    except urllib.error.HTTPError as e:
        return e.code, _read(e)


def _post(url, payload, timeout=1800):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"}
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, _read(r)
    except urllib.error.HTTPError as e:
        return e.code, _read(e)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--generations", type=int, default=3)
    ap.add_argument("--budget-headroom-mb", type=float, default=400.0,
                    help="RSS budget = first worker's warm RSS + this")
    ap.add_argument("--max-frames", type=int, default=2000, help="hard stop")
    ap.add_argument("--out", default="")
    ap.add_argument("--cpu", action="store_true", help="logic smoke on the CPU backend")
    args = ap.parse_args()

    # THIS process only builds the scene and speaks HTTP — pin it to CPU so
    # the device belongs exclusively to the workers under test
    import jax

    jax.config.update("jax_platforms", "cpu")

    # one synthetic scan on disk; every request re-ingests it (fresh host
    # bytes -> fresh H2D staging, exactly like production)
    from mamri_tpu.api import MamriEngine
    from mamri_tpu.api.demo import build_demo_scene
    from mamri_tpu.perception.io import save_nifti
    from mamri_tpu.perception.volume import Volume

    eng = MamriEngine()  # host-only use: scene construction (no device math)
    vol, _angles, _base, _target = build_demo_scene(eng, spacing=max(2.0, 320.0 / args.size))
    data_root = tempfile.mkdtemp(prefix="soak_sup_")
    scan = os.path.join(data_root, "frame.nii")
    save_nifti(scan, Volume(np.asarray(vol.data).astype(np.int16), vol.spacing, vol.origin))
    frame_mb = os.path.getsize(scan) / 1e6

    def launch(budget_mb):
        cmd = [sys.executable, "-m", "mamri_tpu", "serve", "--supervise",
               "--port", str(PORT), "--data-root", data_root,
               "--max-restarts", str(args.generations + 2)]
        if budget_mb is not None:
            cmd += ["--max-rss-mb", str(budget_mb)]
        if args.cpu:
            cmd += ["--platform", "cpu"]
        log = open(os.path.join(data_root, "supervisor.log"), "ab")
        return subprocess.Popen(cmd, stdout=log, stderr=log)

    def wait_healthy(deadline_s=1200):
        t0 = time.time()
        while time.time() - t0 < deadline_s:
            try:
                st, _ = _get(f"http://127.0.0.1:{PORT}/healthz", timeout=10)
                if st == 200:
                    return True
            except (urllib.error.URLError, ConnectionError, OSError):
                pass
            time.sleep(1.0)
        return False

    # phase 1: unbudgeted worker to measure the warm baseline RSS
    sup = launch(None)
    try:
        assert wait_healthy(), "supervised worker never became healthy"
        _post(f"http://127.0.0.1:{PORT}/estimate", {"path": "frame.nii"})  # warm jit
        _, st0 = _get(f"http://127.0.0.1:{PORT}/status")
        base_rss = float(st0["rss_mb"])
    finally:
        try:
            _post(f"http://127.0.0.1:{PORT}/shutdown", {})
        except Exception:
            pass
        sup.wait(timeout=60)

    budget = base_rss + args.budget_headroom_mb
    sup = launch(budget)
    gens, frames, failures = 0, 0, 0
    rss_at_drain, frames_per_gen, rss_max = [], [], 0.0
    gen_frames = 0
    t_start = time.time()
    try:
        assert wait_healthy(), "budgeted worker never became healthy"
        while gens < args.generations and frames < args.max_frames:
            try:
                st, out = _post(f"http://127.0.0.1:{PORT}/estimate", {"path": "frame.nii"})
            except (urllib.error.URLError, ConnectionError, OSError):
                # recycle window: worker already gone (the 503 window can be
                # shorter than our polling) — count the generation and wait
                if gen_frames:
                    gens += 1
                    frames_per_gen.append(gen_frames)
                    gen_frames = 0
                if not wait_healthy():
                    raise RuntimeError("worker did not come back after recycle")
                continue
            if st == 503:
                # draining: count the generation, wait for the fresh worker
                gens += 1
                frames_per_gen.append(gen_frames)
                gen_frames = 0
                if not wait_healthy():
                    raise RuntimeError("worker did not come back after drain")
                continue
            frames += 1
            gen_frames += 1
            if st != 200 or not out.get("success"):
                failures += 1
            if frames % 5 == 0 or gen_frames == 1:
                try:
                    _, stat = _get(f"http://127.0.0.1:{PORT}/status", timeout=60)
                    rss = float(stat["rss_mb"])
                    rss_max = max(rss_max, rss)
                    if stat.get("draining"):
                        rss_at_drain.append(rss)
                except Exception:
                    pass
    finally:
        try:
            _post(f"http://127.0.0.1:{PORT}/shutdown", {})
        except Exception:
            pass
        try:
            sup.wait(timeout=120)
        except subprocess.TimeoutExpired:
            sup.terminate()
    if gen_frames:
        frames_per_gen.append(gen_frames)

    leak = None
    if frames_per_gen and frames_per_gen[0] > 1:
        leak = round(args.budget_headroom_mb / max(np.mean([f for f in frames_per_gen if f > 0]), 1), 2)
    out = {
        "metric": "soak_supervised",
        "generations": gens,
        "frames": frames,
        "failures": failures,
        "frames_per_generation": frames_per_gen,
        "base_rss_mb": round(base_rss, 1),
        "budget_mb": round(budget, 1),
        "max_rss_mb": round(rss_max, 1),
        "rss_bounded": bool(rss_max <= budget * 1.15),
        "frame_file_mb": round(frame_mb, 2),
        "leak_mb_per_frame_est": leak,
        "wall_s": round(time.time() - t_start, 1),
        "ok": bool(gens >= args.generations and failures == 0 and rss_max <= budget * 1.15),
    }
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
