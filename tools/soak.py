"""Sustained-operation soak: N frames through the streaming tracker on the
accelerator, mixed clean / noisy / shape-changing, with memory + cache +
latency drift tracked. The production-readiness counterpart of the bench's
snapshot numbers: proves the engine survives hours-shaped workloads
(jit-cache LRU bounds, per-frame escalation, warm-started IK) without
failures or drift.

Frames upload as scanner-native int16 (the compact ingest path — half the
host-to-device bytes). A noisy frame (dense sub-threshold speckle + real
speckle components) is injected every --noisy-every frames and must still
certify via escalation; every --alt-every frames the volume SHAPE changes,
exercising the engine's bounded compile cache on a long heterogeneous feed.

`rss_now_growth_mb` tracks host-RSS growth per frame (jit caches are
LRU-bounded; `pipeline_cache_entries` proves it).

Prints one JSON line.

Usage: python tools/soak.py [--frames 200] [--size 128] [--noisy-every 20]
"""

import argparse
import gc
import json
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def _vm_rss_mb():
    """CURRENT resident set (MB). ru_maxrss is the PEAK — transfer staging
    churn inflates it without leaking; the VmRSS delta is the leak signal."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return -1.0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=200)
    # 192 is the smallest grid whose voxels resolve band-legal (50-1500 mm^3)
    # fiducials over the 4-scene union bbox; see the bench's BENCH_SIZE note
    ap.add_argument("--size", type=int, default=192)
    ap.add_argument("--noisy-every", type=int, default=20)
    ap.add_argument("--alt-every", type=int, default=50)
    ap.add_argument("--out", default="")
    ap.add_argument(
        "--cpu", action="store_true",
        help="run on the CPU backend (a smoke of the soak logic; "
        "latency/RSS numbers are then not device numbers)",
    )
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    os.environ["BENCH_SIZE"] = str(args.size)
    from mamri_tpu.api import MamriEngine
    from mamri_tpu.api.demo import bench_scenes, bench_volume
    from mamri_tpu.api.streaming import PoseTracker
    from mamri_tpu.perception.volume import Volume

    engine = MamriEngine()
    scenes, spacing, origin, body_center = bench_scenes(engine, args.size)

    def render(pts, shape):
        # per-axis spacing keeps the PHYSICAL extent identical for every
        # shape, so the scene's markers stay inside anisotropic grids
        sp = (spacing * args.size / np.asarray(shape)).astype(np.float32)
        return bench_volume(pts, shape, sp, origin, body_center)

    def compact(v):
        return Volume(v.data.astype(np.int16), v.spacing, v.origin)

    shape_a = (args.size,) * 3
    # alternate shape: anisotropic (x is 1.5x), exercises a second compile
    shape_b = (args.size + args.size // 2, args.size, args.size)
    clean = [compact(render(s[2], shape_a)) for s in scenes]
    alt = compact(render(scenes[0][2], shape_b))

    rng = np.random.default_rng(7)
    noisy_f = clean[0].data.astype(np.float32)
    # dense speckle components inside the fiducial band + sub-threshold noise
    n_speckle = 400
    idx = rng.integers(0, np.asarray(shape_a) - 1, size=(n_speckle, 3))
    noisy_f[idx[:, 0], idx[:, 1], idx[:, 2]] = 120.0
    noisy_f = noisy_f + rng.normal(0.0, 5.0, noisy_f.shape).astype(np.float32)
    noisy = Volume(
        np.clip(np.round(noisy_f), -32768, 32767).astype(np.int16), spacing, origin
    )

    tracker = PoseTracker(engine)
    vols = {"clean": clean, "alt": alt, "noisy": noisy}

    # warm every program (compiles excluded from drift stats)
    for v in (vols["clean"][0], vols["alt"], vols["noisy"]):
        tracker.step(v)
    assert tracker.failures == 0, "warm-up frames must all solve"
    tracker.tracer.spans["frame"].clear()
    tracker.frames = tracker.failures = 0

    gc.collect()
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    vm0 = _vm_rss_mb()
    lat, kinds = [], {"clean": 0, "noisy": 0, "alt": 0}
    pending_alt = False  # alt frame deferred because it collided with a noisy one
    t_start = time.perf_counter()
    for i in range(args.frames):
        want_noisy = args.noisy_every and i % args.noisy_every == args.noisy_every - 1
        want_alt = args.alt_every and i % args.alt_every == args.alt_every - 1
        if want_noisy and want_alt:
            pending_alt = True  # noisy wins this frame; alt runs on the next
        if want_noisy:
            kind = "noisy"
            v = vols["noisy"]
        elif want_alt or pending_alt:
            pending_alt = False
            kind = "alt"
            v = vols["alt"]
        else:
            kind = "clean"
            v = vols["clean"][i % len(vols["clean"])]
        t0 = time.perf_counter()
        r = tracker.step(v)
        lat.append(time.perf_counter() - t0)
        kinds[kind] += 1
        if not r.success:
            print(json.dumps({"soak": "FAIL", "frame": i, "kind": kind,
                              "message": r.message}), flush=True)
    wall = time.perf_counter() - t_start
    gc.collect()
    rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    vm1 = _vm_rss_mb()

    def p50(xs):
        return sorted(xs)[len(xs) // 2]

    first, second = lat[: len(lat) // 2], lat[len(lat) // 2 :]
    lat_sorted = sorted(lat)
    result = {
        "metric": "soak",
        "frames": args.frames,
        "kinds": kinds,
        # a noisy/alt collision on the FINAL frame defers the alt past the
        # end of the run — count it so kinds never silently understates
        "alt_deferred_past_end": pending_alt,
        "failures": tracker.failures,
        "all_success": tracker.failures == 0,
        "p50_ms": round(p50(lat) * 1e3, 2),
        "p95_ms": round(lat_sorted[min(int(len(lat) * 0.95), len(lat) - 1)] * 1e3, 2),
        "max_ms": round(lat_sorted[-1] * 1e3, 2),
        # drift: p50 of the first half vs the second half of the run
        "p50_first_half_ms": round(p50(first) * 1e3, 2) if first else None,
        "p50_second_half_ms": round(p50(second) * 1e3, 2) if second else None,
        "fps": round(args.frames / wall, 2),
        "wall_s": round(wall, 1),
        "rss_peak_growth_mb": round((rss1 - rss0) / 1024.0, 1),
        "rss_now_growth_mb": round(vm1 - vm0, 1),
        "pipeline_cache_entries": len(engine._pipeline_cache),
        "volume": f"{shape_a} + alt {shape_b}",
        "dtype": "int16 frames (compact ingest)",
    }
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(json.dumps(result) + "\n")


if __name__ == "__main__":
    main()
