"""Production serving surface: one long-lived warm engine behind HTTP/JSON.

The reference is an interactive Slicer panel — one operator, one scene
(Mamri/Mamri.py:248-400 builds the widget; `process()` runs on a button).
Deployed at scale, the equivalent workload is a scanner (or a DICOM router)
emitting volumes at a steady cadence into a service that must answer with
joint angles in bounded time. This module is that service: a stdlib-only
ThreadingHTTPServer wrapping ONE `MamriEngine`, so every request after the
first reuses the engine's compiled-program caches (the fused pipeline is
jitted once per volume shape; see `MamriEngine._get_pipeline`).

Design points:

- **One compute lock.** A single accelerator runs one fused program at a
  time anyway; request threads overlap socket I/O, upload parsing, and file
  decode with the current request's device compute, but engine calls are
  serialized under `_compute_lock`. That also lets the engine keep its
  single-operator state contract (ARCHITECTURE §5c): pose/entry/plan
  requests compose through `last_segmentation` exactly like the reference's
  workflow, with the lock held across the whole composition. Scale-out is
  one worker process per card, not threads.
- **Worker recycling.** `--max-rss-mb` (a plain host-RSS budget) and
  `--max-frames` make process recycling a first-class server behavior:
  once a budget is exceeded the worker *drains* — `/healthz` flips to 503
  so a supervisor/load-balancer stops routing to it, in-flight work
  completes, new compute requests get 503 `{"recycle": true}`, and
  `serve_forever` returns so the CLI can exit with code 3 (restart-me).
- **Two ingest modes.** `{"path": ...}` for the shared-storage/DICOM-router
  integration (any format `perception.formats.load_volume` sniffs,
  including a DICOM series directory), or a raw volume upload
  (`application/octet-stream` body = the bytes of a .nii/.nii.gz/.nrrd/
  .mha/.dcm file — magic-sniffed, no filename needed). Path mode can be
  jailed under `data_root`.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

DEFAULT_MAX_UPLOAD_BYTES = 2 << 30  # 2 GiB: a 512^3 f32 volume is 512 MiB
RECYCLE_EXIT_CODE = 3  # CLI exit code asking the supervisor for a restart


def _rss_mb() -> float:
    """Current resident set size in MiB (Linux /proc; 0.0 if unreadable)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


def _pose_json(res) -> dict:
    """PoseEstimate -> the CLI `estimate` JSON contract (__main__.py)."""
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
            rmse_mm=round(float(res.rmse_mm), 4),
        )
    return out


class ServerError(Exception):
    """Request-level failure with an HTTP status (4xx/5xx) and a message."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class MamriServer:
    """The service core: owns the engine, budgets, and request handlers.

    Transport-independent — `handle(method, route, body, content_type)`
    returns `(status, payload_dict)`, so tests can also drive it without
    sockets. `ThreadingHTTPServer` integration lives in `make_http_server`.
    """

    ROUTES_GET = ("/healthz", "/status", "/hw/status", "/watch", "/watch.html")
    ROUTES_POST = (
        "/estimate", "/estimate_batch", "/entry", "/plan", "/shutdown",
        "/hw/move", "/hw/exec", "/hw/stop",
    )

    def __init__(
        self,
        engine=None,
        data_root: Optional[str] = None,
        max_rss_mb: Optional[float] = None,
        max_frames: Optional[int] = None,
        max_upload_bytes: int = DEFAULT_MAX_UPLOAD_BYTES,
        shutdown_token: Optional[str] = None,
        hw_tick_s: float = 0.15,
    ):
        if engine is None:
            from mamri_tpu.api.engine import MamriEngine

            engine = MamriEngine()
        self.engine = engine
        self.data_root = os.path.realpath(data_root) if data_root else None
        self.max_rss_mb = max_rss_mb
        self.max_frames = max_frames
        self.max_upload_bytes = int(max_upload_bytes)
        self.shutdown_token = shutdown_token
        self.hw_tick_s = float(hw_tick_s)  # reference: 150 ms (Mamri.py:80)
        self._compute_lock = threading.Lock()
        self._state_lock = threading.Lock()  # counters + draining flag
        self._hw_lock = threading.Lock()  # one hardware task thread at a time
        self._hw_thread: Optional[threading.Thread] = None
        self._hw_shutdown = False  # set on worker exit: no new tasks may start
        self.frames_served = 0
        self.started_at = time.monotonic()
        self.draining = False
        self.drain_reason: Optional[str] = None
        # an explicit operator /shutdown must win over a budget drain:
        # serve() exits 0 (stop) instead of RECYCLE_EXIT_CODE (respawn)
        self.shutdown_requested = False
        self._httpd: Optional[ThreadingHTTPServer] = None

    # ------------------------------------------------------------- ingest
    def _resolve_path(self, path: str) -> str:
        real = os.path.realpath(
            os.path.join(self.data_root, path) if self.data_root else path
        )
        if self.data_root is not None and not (
            real == self.data_root or real.startswith(self.data_root + os.sep)
        ):
            raise ServerError(403, f"path escapes data root: {path}")
        return real

    def _load_volume(self, body: bytes, content_type: str, opts: dict):
        from mamri_tpu.perception.formats import load_volume

        if content_type.startswith("application/json"):
            path = opts.get("path")
            if not path:
                raise ServerError(400, "JSON body needs a 'path' field")
            try:
                return load_volume(self._resolve_path(str(path)))
            except (OSError, ValueError) as e:
                raise ServerError(422, f"cannot load volume: {e}")
        # raw upload: magic-sniffed single file. load_volume dispatches on
        # extension first, so mirror the gzip case in the suffix.
        suffix = ".nii.gz" if body[:2] == b"\x1f\x8b" else ".bin"
        fd, tmp = tempfile.mkstemp(suffix=suffix, prefix="mamri_upload_")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(body)
            try:
                return load_volume(tmp)
            except (OSError, ValueError) as e:
                raise ServerError(422, f"cannot decode uploaded volume: {e}")
        finally:
            os.unlink(tmp)

    @staticmethod
    def _parse(body: bytes, content_type: str) -> dict:
        if not content_type.startswith("application/json"):
            return {}
        try:
            opts = json.loads(body.decode("utf-8") or "{}")
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ServerError(400, f"malformed JSON body: {e}")
        if not isinstance(opts, dict):
            raise ServerError(400, "JSON body must be an object")
        return opts

    @staticmethod
    def _target(opts: dict, key: str = "target") -> np.ndarray:
        t = opts.get(key)
        if not (isinstance(t, (list, tuple)) and len(t) == 3):
            raise ServerError(400, f"'{key}' must be [R, A, S] (mm)")
        try:
            return np.asarray([float(v) for v in t], dtype=np.float32)
        except (TypeError, ValueError):
            raise ServerError(400, f"'{key}' must be three numbers")

    @staticmethod
    def _coerce_query(query: dict) -> dict:
        """Query-string options for raw-upload requests (`?target=0,0,-18&
        safety=5`): coerce to the JSON option types. JSON-body fields win."""
        out = {}
        for key, val in query.items():
            if key in ("target", "entry"):
                out[key] = [p for p in str(val).split(",") if p != ""]
            elif key == "safety":
                out[key] = val
            elif key in ("correction", "use_saved_baseplate", "remember_baseplate"):
                out[key] = str(val).lower() in ("1", "true", "yes", "on")
            elif key == "path":
                out[key] = str(val)
            else:
                raise ServerError(400, f"unknown query option: {key}")
        return out

    # ------------------------------------------------------------ budgets
    def _check_budgets(self, count: int = 1) -> None:
        """Called after each compute request; flips the worker to draining.
        `count` = volumes ingested (a batch of N is N H2D uploads, so it
        spends N frames of the budget, not 1)."""
        with self._state_lock:
            self.frames_served += max(int(count), 1)
            if self.draining:
                return
            if self.max_frames is not None and self.frames_served >= self.max_frames:
                self.draining = True
                self.drain_reason = f"frame budget reached ({self.frames_served}/{self.max_frames})"
            elif self.max_rss_mb is not None:
                rss = _rss_mb()
                if rss >= self.max_rss_mb:
                    self.draining = True
                    self.drain_reason = f"RSS budget reached ({rss:.0f}/{self.max_rss_mb:.0f} MiB)"
        if self.draining:
            logger.warning("worker draining: %s", self.drain_reason)
            self._stop_accepting()

    def _stop_accepting(self) -> None:
        httpd = self._httpd
        if httpd is not None:
            # shutdown() blocks until serve_forever returns — do it from a
            # helper thread so the in-flight request's handler can finish.
            threading.Thread(target=httpd.shutdown, daemon=True).start()

    # ----------------------------------------------------------- handlers
    def handle(self, method: str, route: str, body: bytes, content_type: str,
               query: Optional[dict] = None):
        """-> (http_status, json_payload). Raises nothing."""
        try:
            if method == "GET" and route == "/healthz":
                return self._healthz()
            if method == "GET" and route == "/status":
                return 200, self.status()
            if method == "POST" and route == "/shutdown":
                opts = self._parse(body, content_type)
                if self.shutdown_token and opts.get("token") != self.shutdown_token:
                    return 403, {"success": False, "message": "shutdown token required"}
                with self._state_lock:
                    self.shutdown_requested = True
                    self.draining = True
                    self.drain_reason = self.drain_reason or "shutdown requested"
                self._stop_accepting()
                return 200, {"ok": True, "draining": True}
            if method == "GET" and route == "/hw/status":
                return 200, self._do_hw_status()
            if method == "POST" and route == "/hw/stop":
                self._hw().stop()
                return 200, {"success": True, "stop_requested": True}
            if method == "POST" and route in ("/hw/move", "/hw/exec"):
                if self.draining:
                    # a draining worker is about to exit: starting a robot
                    # motion it cannot supervise to completion is unsafe
                    return 503, {"success": False, "recycle": True,
                                 "message": f"worker draining: {self.drain_reason}"}
                opts = self._parse(body, content_type)
                if route == "/hw/move":
                    return 200, self._do_hw_move(opts)
                return 200, self._do_hw_exec(opts)
            if method == "POST" and route == "/estimate_batch":
                if self.draining:
                    return 503, {"success": False, "recycle": True,
                                 "message": f"worker draining: {self.drain_reason}"}
                opts = self._parse(body, content_type)
                # budget is charged per volume actually HANDED TO THE DEVICE
                # (set by _do_estimate_batch just before upload): a request
                # rejected at validation/load time uploaded nothing and must
                # not drain the worker's frame budget
                charge = [0]
                try:
                    with self._compute_lock:
                        payload = self._do_estimate_batch(opts, charge)
                finally:
                    if charge[0]:
                        self._check_budgets(charge[0])
                return 200, payload
            if method == "POST" and route in ("/estimate", "/entry", "/plan"):
                if self.draining:
                    return 503, {"success": False, "recycle": True,
                                 "message": f"worker draining: {self.drain_reason}"}
                opts = {**self._coerce_query(query or {}), **self._parse(body, content_type)}
                # validate request options BEFORE decoding a (possibly huge)
                # volume, so malformed requests fail fast and cheap
                if route == "/entry":
                    self._target(opts)
                elif route == "/plan":
                    self._target(opts)
                    if "entry" in opts:
                        self._target(opts, "entry")
                vol = self._load_volume(body, content_type, opts)
                try:
                    with self._compute_lock:
                        payload = getattr(self, "_do" + route.replace("/", "_"))(vol, opts)
                finally:
                    self._check_budgets()
                return 200, payload
            return 404, {"success": False, "message": f"no route {method} {route}"}
        except ServerError as e:
            return e.status, {"success": False, "message": str(e)}
        except Exception as e:  # a bug must not kill the worker thread pool
            logger.exception("request failed: %s %s", method, route)
            return 500, {"success": False, "message": f"{type(e).__name__}: {e}"}

    def _healthz(self):
        with self._state_lock:
            if self.draining:
                return 503, {"ok": False, "recycle": True, "reason": self.drain_reason}
        return 200, {"ok": True}

    def status(self) -> dict:
        import jax

        eng = self.engine
        with self._state_lock:
            out = {
                "frames_served": self.frames_served,
                "uptime_s": round(time.monotonic() - self.started_at, 1),
                "draining": self.draining,
                "drain_reason": self.drain_reason,
            }
        out.update(
            rss_mb=round(_rss_mb(), 1),
            max_rss_mb=self.max_rss_mb,
            max_frames=self.max_frames,
            backend=jax.default_backend(),
            pipeline_cache_entries=len(eng._pipeline_cache),
            has_saved_baseplate=eng.saved_baseplate is not None,
        )
        return out

    # Each _do_* runs with _compute_lock held and a decoded Volume in hand.
    def _do_estimate(self, vol, opts: dict) -> dict:
        res = self.engine.estimate_pose(
            vol,
            use_saved_baseplate=bool(opts.get("use_saved_baseplate", False)),
            apply_correction=bool(opts.get("correction", False)),
        )
        out = _pose_json(res)
        if opts.get("remember_baseplate") and res.success:
            # keep the transform in the worker (reference: save-baseplate
            # button, Mamri.py:1035-1043); later requests opt in with
            # use_saved_baseplate.
            self.engine.save_baseplate()
            out["baseplate_remembered"] = True
        return out

    def _do_estimate_batch(self, opts: dict, charge: Optional[list] = None) -> dict:
        """The flagship throughput path over the wire: a homogeneous batch of
        volumes (one scanner geometry — same shape/spacing/origin, e.g. a
        time series) through the vmapped fused pipeline with per-volume
        certificate escalation (`MamriEngine.estimate_pose_batch`)."""
        from mamri_tpu.perception.formats import load_volume

        paths = opts.get("paths")
        if not (isinstance(paths, list) and paths and all(isinstance(p, str) for p in paths)):
            raise ServerError(400, "'paths' must be a non-empty list of volume paths")
        microbatch = opts.get("microbatch")
        if microbatch is not None:
            microbatch = int(microbatch)
            if microbatch <= 0 or len(paths) % microbatch:
                raise ServerError(400, f"microbatch {microbatch} must divide batch {len(paths)}")
        vols = []
        for p in paths:
            try:
                vols.append(load_volume(self._resolve_path(p)))
            except (OSError, ValueError) as e:
                raise ServerError(422, f"cannot load volume {p!r}: {e}")
        v0 = vols[0]
        for p, v in zip(paths[1:], vols[1:]):
            if np.asarray(v.data).shape != np.asarray(v0.data).shape:
                raise ServerError(422, f"batch is not homogeneous: {p!r} has shape "
                                       f"{np.asarray(v.data).shape}, expected {np.asarray(v0.data).shape}")
            if not (np.allclose(v.spacing, v0.spacing) and np.allclose(v.origin, v0.origin)):
                raise ServerError(422, f"batch is not homogeneous: {p!r} has different geometry")
        batch = np.stack([np.asarray(v.data) for v in vols])
        if charge is not None:
            charge[0] = len(paths)  # uploads start now
        out = self.engine.estimate_pose_batch(
            batch, v0.spacing, v0.origin,
            apply_correction=bool(opts.get("correction", False)),
            microbatch=microbatch,
        )
        certified = out["seg_converged"] & out["roots_complete"] & out["blobs_complete"]
        results = []
        for i, p in enumerate(paths):
            ok = bool(out["success"][i])
            r = {"path": p, "success": ok, "certified": bool(certified[i])}
            if ok:
                r.update(
                    angles_deg=np.rad2deg(out["angles"][i]).round(3).tolist(),
                    steps=np.asarray(out["steps"][i]).astype(int).tolist(),
                    rmse_mm=round(float(out["rmse"][i]), 4),
                )
            results.append(r)
        return {"success": all(r["success"] for r in results),
                "batch": len(paths), "results": results}

    def _do_entry(self, vol, opts: dict) -> dict:
        target = self._target(opts)
        pose = self.engine.estimate_pose(vol)
        if self.engine.body_mask() is None:
            raise ServerError(422, "no body segmentation found in scan")
        ep = self.engine.find_entry_point(target)
        return {
            "success": bool(ep.found),
            "entry_ras": np.asarray(ep.point_ras).round(3).tolist(),
            "distance_mm": round(float(ep.distance_mm), 2),
            "normal_ras": np.asarray(ep.normal_ras).round(3).tolist(),
            "pose": _pose_json(pose),
        }

    def _do_plan(self, vol, opts: dict) -> dict:
        target = self._target(opts)
        pose = self.engine.estimate_pose(
            vol, apply_correction=bool(opts.get("correction", False))
        )
        if not pose.success:
            raise ServerError(422, f"pose estimation failed: {pose.message}")
        if "entry" in opts:
            entry = self._target(opts, "entry")
        else:
            ep = self.engine.find_entry_point(target)
            if not bool(ep.found):
                raise ServerError(422, "no suitable entry point within 80 mm")
            entry = np.asarray(ep.point_ras)
        plan = self.engine.plan_heuristic_path(
            target, entry, float(opts.get("safety", 5.0)), start_pose_steps=pose.steps
        )
        out = {
            "success": plan.success,
            "message": plan.message,
            "collision_detected": plan.collision_detected,
            "entry_ras": np.asarray(entry).round(3).tolist(),
            "pose": _pose_json(pose),
        }
        if plan.success:
            out.update(
                goal_angles_deg=np.rad2deg(plan.goal_angles).round(3).tolist(),
                goal_steps=plan.goal_steps.tolist(),
                position_error_mm=round(float(plan.position_error_mm), 3),
                path_samples=len(plan.path),
            )
        return out

    # ------------------------------------------------- hardware + live mirror
    # The reference executes trajectories from its widget and mirrors the
    # encoder into the 3-D scene every 150 ms tick, status at 4 Hz
    # (Mamri.py:537, :582-648, :595). Served headlessly: POST /hw/move|exec
    # starts the closed-loop executor on a worker thread, GET /watch streams
    # the per-tick pose frames (SSE), /watch.html is a live panel.
    def _hw(self):
        hw = getattr(self.engine, "hardware", None)
        if hw is None:
            raise ServerError(
                409, "no hardware attached to this worker (serve --sim-hw, or attach_hardware before serving)"
            )
        return hw

    def _do_hw_status(self) -> dict:
        hw = self._hw()
        # The serial links are single-writer: while the executor owns them,
        # a status() from this handler thread would interleave a 'P' query
        # with the executor's per-tick traffic. The is_active check and the
        # idle-path query both run under _hw_lock — the same lock that gates
        # task starts — so a concurrent /hw/move cannot slip a task start
        # between the check and the query.
        with self._hw_lock:
            if not hw.runner.is_active:
                st = hw.status()
                return {"success": True, "status": st, "joints": hw.joint_status_table(st)}
        out = {"success": True, "status": hw.passive_status(), "passive": True}
        stream = getattr(hw, "stream", None)
        last = stream.last_frame if stream is not None else None
        if last is not None and last.get("event") == "pose":
            # only a live pose frame: last_frame may still hold the PREVIOUS
            # task's terminal event before this task's first tick publishes
            out["last_pose"] = last
        return out

    def _start_hw_task(self, start_fn) -> dict:
        hw = self._hw()
        with self._hw_lock:
            if self._hw_shutdown:
                raise ServerError(503, "worker is exiting; no new robot tasks")
            if hw.runner.is_active or (self._hw_thread is not None and self._hw_thread.is_alive()):
                raise ServerError(409, "a robot task is already running")
            state = start_fn(hw)
            t = threading.Thread(
                target=hw.runner.run,
                kwargs={"tick_interval_s": self.hw_tick_s},
                daemon=True,
                name="hw-task",
            )
            self._hw_thread = t
            t.start()
        return {
            "success": True,
            "started": True,
            "mode": state.mode,
            "target_steps": [int(s) for s in state.target_steps],
            "watch": "/watch",
        }

    def stop_hw_task(self, join_timeout_s: float = 10.0) -> bool:
        """Soft-stop any active hardware task and wait for its thread.
        Returns True if the thread is gone (or none was running). Called on
        worker exit so a drain/shutdown never abandons a moving robot. Also
        latches _hw_shutdown under _hw_lock, so an in-flight /hw/move
        handler racing the exit cannot start a task AFTER this check (it
        gets a 503 instead — the Ctrl-C path never sets `draining`, so the
        route-level drain gate alone would not cover it)."""
        with self._hw_lock:
            self._hw_shutdown = True
            t = self._hw_thread
        if t is None or not t.is_alive():
            return True
        hw = getattr(self.engine, "hardware", None)
        if hw is not None:
            try:
                hw.stop()  # request_stop -> next tick soft-stops the controller
            except Exception:
                logger.exception("hw soft-stop on worker exit failed")
        t.join(timeout=join_timeout_s)
        if t.is_alive():
            logger.error("hw task thread did not stop within %.0fs", join_timeout_s)
            return False
        return True

    @staticmethod
    def _six(opts: dict, key: str, cast):
        v = opts.get(key)
        if not (isinstance(v, (list, tuple)) and len(v) == 6):
            raise ServerError(400, f"'{key}' must be 6 values")
        try:
            return [cast(x) for x in v]
        except (TypeError, ValueError):
            raise ServerError(400, f"'{key}' must be 6 numbers")

    def _do_hw_move(self, opts: dict) -> dict:
        self._hw()  # no-hardware beats option validation (consistent 409)
        timeout_s = float(opts.get("timeout_s", 120.0))
        if "degrees" in opts:
            deg = self._six(opts, "degrees", float)
            steps = [int(s) for s in self.engine.convert_angles_to_steps(np.deg2rad(np.asarray(deg)))]
        else:
            steps = self._six(opts, "steps", int)
        return self._start_hw_task(lambda hw: hw.move_to_pose(steps, timeout_s=timeout_s))

    def _do_hw_exec(self, opts: dict) -> dict:
        self._hw()
        timeout_s = float(opts.get("timeout_s", 120.0))
        if "path" in opts:  # a `plan --out` .npz under data_root
            try:
                npz = np.load(self._resolve_path(str(opts["path"])))
                keyframes = [np.asarray(k) for k in npz["keyframes"]]
            except (OSError, ValueError, KeyError) as e:
                raise ServerError(422, f"cannot read plan: {e}")
        elif "keyframes_deg" in opts:
            kf = opts["keyframes_deg"]
            if not (isinstance(kf, list) and kf and all(isinstance(k, (list, tuple)) and len(k) == 6 for k in kf)):
                raise ServerError(400, "'keyframes_deg' must be a non-empty list of 6-value rows")
            keyframes = [np.deg2rad(np.asarray([float(x) for x in k])) for k in kf]
        else:
            raise ServerError(400, "hw exec needs 'path' (plan .npz) or 'keyframes_deg'")
        return self._start_hw_task(lambda hw: hw.execute_trajectory(keyframes, timeout_s=timeout_s))

    def watch_frames(self, max_frames=None, heartbeat_s: float = 0.25, idle_timeout_s: float = 30.0):
        """Iterator of live frames: executor pose frames as they arrive,
        encoder-only status heartbeats at >= 4 Hz between them (the
        reference's status cadence, Mamri.py:595). Ends at task_finished,
        `max_frames`, or `idle_timeout_s` with no task running.

        Validates EAGERLY (no hardware / no stream raise here, not at first
        next()), so HTTP callers can reject before committing a 200 SSE
        status line; the returned inner generator owns the subscription."""
        hw = self._hw()
        if hw.stream is None:
            raise ServerError(409, "hardware stack has no pose stream")
        return self._watch_frames_inner(hw, max_frames, heartbeat_s, idle_timeout_s)

    def _watch_frames_inner(self, hw, max_frames, heartbeat_s, idle_timeout_s):
        sub = hw.stream.subscribe()
        try:
            yielded = 0
            idle = 0.0
            while max_frames is None or yielded < max_frames:
                fr = sub.get(timeout=heartbeat_s)
                if fr is None:
                    if sub.closed:
                        return
                    idle += heartbeat_s
                    if idle >= idle_timeout_s and not hw.runner.is_active:
                        return
                    fr = hw.passive_status()
                    fr["t"] = time.time()
                else:
                    idle = 0.0
                yield fr
                yielded += 1
                if fr.get("event") == "task_finished":
                    return
        finally:
            sub.close()


# The live execution panel: the headless counterpart of the reference's
# Live Status group box (Mamri.ui "3. Live Status"; update loop
# Mamri.py:582-648) — a joint table fed by the /watch SSE stream.
_WATCH_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>mamri-tpu live status</title>
<style>
 body { font: 14px/1.5 system-ui, sans-serif; margin: 2rem; color: #222; }
 table { border-collapse: collapse; margin-top: 1rem; }
 th, td { border: 1px solid #bbb; padding: .3rem .8rem; text-align: right; }
 th { background: #f2f2f2; }
 #meta { color: #555; } .done { color: #0a7a0a; } .bad { color: #b00020; }
</style></head><body>
<h3>MAMRI live execution</h3>
<div id="meta">waiting for stream&hellip;</div>
<table><thead><tr><th>Joint</th><th>Encoder (steps)</th><th>Target (steps)</th>
<th>Angle (&deg;)</th></tr></thead><tbody id="rows"></tbody></table>
<div id="tcp"></div>
<script>
const rows = document.getElementById('rows');
for (let i = 0; i < 6; i++) {
  rows.insertAdjacentHTML('beforeend',
    `<tr><td>J${i+1}</td><td id="e${i}">...</td><td id="t${i}">...</td><td id="a${i}">...</td></tr>`);
}
const es = new EventSource('/watch?timeout=3600');
es.onmessage = (ev) => {
  const f = JSON.parse(ev.data);
  const meta = document.getElementById('meta');
  if (f.event === 'task_finished') {
    meta.innerHTML = `task <b>${f.mode}</b> finished: ` +
      `<span class="${f.outcome === 'success' ? 'done' : 'bad'}">${f.outcome}</span> &mdash; ${f.message}`;
    es.close();
    return;
  }
  const steps = f.steps || f.encoder_steps || [];
  const target = f.target_steps || [];
  const ang = f.angles_deg || [];
  for (let i = 0; i < 6; i++) {
    if (steps[i] !== undefined) document.getElementById('e' + i).textContent = steps[i];
    if (target[i] !== undefined) document.getElementById('t' + i).textContent = target[i];
    if (ang[i] !== undefined) document.getElementById('a' + i).textContent = ang[i].toFixed(2);
  }
  meta.textContent = f.event === 'pose'
    ? `executing ${f.mode}` + (f.num_keyframes ? ` (keyframe ${f.keyframe_index + 1}/${f.num_keyframes})` : '')
    : (f.task_active ? 'task active' : 'idle (heartbeat)');
  if (f.tcp_world) document.getElementById('tcp').textContent =
    `needle TCP (RAS mm): ${f.tcp_world.map(v => v.toFixed(1)).join(', ')}`;
};
</script></body></html>
"""


def make_http_server(core: MamriServer, host: str = "127.0.0.1", port: int = 0):
    """Bind a ThreadingHTTPServer for `core`. Returns the httpd; the caller
    runs `httpd.serve_forever()` (blocking) or wraps it in a thread."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        server_version = "mamri-tpu"

        def log_message(self, fmt, *args):  # route access logs to logging
            logger.info("%s %s", self.address_string(), fmt % args)

        def _reply(self, status: int, payload: dict) -> None:
            data = json.dumps(payload).encode("utf-8")
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _body(self) -> bytes:
            try:
                n = int(self.headers.get("Content-Length") or 0)
            except ValueError:
                self.close_connection = True
                raise ServerError(400, "malformed Content-Length header")
            if n > core.max_upload_bytes:
                # replying without draining the body desyncs any pipelined
                # request behind it on this connection — drop the connection
                self.close_connection = True
                raise ServerError(
                    413, f"body of {n} bytes exceeds limit {core.max_upload_bytes}"
                )
            return self.rfile.read(n) if n else b""

        def _serve_watch(self, query: dict) -> None:
            """GET /watch -> Server-Sent Events: one `data: {json}` line per
            live frame (connection-delimited body; the stream has no length)."""
            try:
                # watch_frames validates eagerly (hardware + stream), so a
                # 409 surfaces here — before the 200 SSE headers are on the
                # wire
                frames = core.watch_frames(
                    max_frames=int(query["frames"]) if "frames" in query else None,
                    idle_timeout_s=float(query.get("timeout", 30.0)),
                )
            except ServerError as e:
                self._reply(e.status, {"success": False, "message": str(e)})
                return
            except ValueError:
                self._reply(400, {"success": False, "message": "frames/timeout must be numbers"})
                return
            self.close_connection = True
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            try:
                for fr in frames:
                    self.wfile.write(b"data: " + json.dumps(fr).encode("utf-8") + b"\n\n")
                    self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                pass  # client went away; subscription closes via the generator

        def _serve(self, method: str) -> None:
            try:
                body = self._body()
            except ServerError as e:
                self._reply(e.status, {"success": False, "message": str(e)})
                return
            ctype = self.headers.get("Content-Type", "application/json" if method == "POST" else "")
            route, _, qs = self.path.partition("?")
            query = dict(urllib.parse.parse_qsl(qs)) if qs else None
            if method == "GET" and route == "/watch":
                self._serve_watch(query or {})
                return
            if method == "GET" and route == "/watch.html":
                page = _WATCH_HTML.encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(page)))
                self.end_headers()
                self.wfile.write(page)
                return
            status, payload = core.handle(method, route, body, ctype, query)
            self._reply(status, payload)

        def do_GET(self):  # noqa: N802 (http.server API)
            self._serve("GET")

        def do_POST(self):  # noqa: N802
            self._serve("POST")

    httpd = ThreadingHTTPServer((host, port), Handler)
    httpd.daemon_threads = True
    core._httpd = httpd
    return httpd


def supervise(worker_argv: list, max_restarts: Optional[int] = None) -> int:
    """Tiny built-in supervisor: run `worker_argv` as a child process and
    respawn it whenever it exits with RECYCLE_EXIT_CODE (budget drain).
    Any other exit code ends supervision with that code. The parent stays
    import-light (no jax/engine) — all device state dies with each worker,
    and the parent never holds the card (one process per card)."""
    import signal
    import subprocess
    import sys

    restarts = 0
    child = None

    def forward(signum, frame):
        if child is not None and child.poll() is None:
            child.send_signal(signum)

    prev = {s: signal.signal(s, forward) for s in (signal.SIGINT, signal.SIGTERM)}
    try:
        while True:
            child = subprocess.Popen([sys.executable, "-m", "mamri_tpu"] + worker_argv)
            rc = child.wait()
            if rc != RECYCLE_EXIT_CODE:
                return rc
            restarts += 1
            logger.warning("worker recycled (restart %d)", restarts)
            if max_restarts is not None and restarts >= max_restarts:
                logger.error("restart budget exhausted (%d)", restarts)
                return RECYCLE_EXIT_CODE
    finally:
        for s, h in prev.items():
            signal.signal(s, h)


def serve(core: MamriServer, host: str = "127.0.0.1", port: int = 8420) -> int:
    """Blocking entry point for the CLI. Returns the process exit code:
    0 on an explicit shutdown, RECYCLE_EXIT_CODE when a budget drained the
    worker (ask the supervisor for a fresh process)."""
    httpd = make_http_server(core, host, port)
    bound = httpd.server_address
    logger.info("mamri-tpu serving on http://%s:%d", bound[0], bound[1])
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        # never exit with a robot motion unsupervised: the hw task runs on a
        # daemon thread the interpreter would kill mid-trajectory while the
        # controller keeps driving to the last commanded keyframe (the CLI
        # path soft-stops on interrupt the same way, __main__.cmd_hw)
        core.stop_hw_task(join_timeout_s=10.0)
    # an explicit operator /shutdown always stops for good — even when a
    # budget drain was already in progress (otherwise the supervisor would
    # respawn a worker the operator just asked to stop)
    if core.shutdown_requested:
        return 0
    budget_drained = core.drain_reason not in (None, "shutdown requested")
    return RECYCLE_EXIT_CODE if budget_drained else 0
