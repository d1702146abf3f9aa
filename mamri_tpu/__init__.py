"""mamri_tpu — a JAX/XLA framework with the capabilities of the MAMRI robot
pose-estimation suite (reference: PaulSchlabach/mamri-pose-estimation).

Layering (bottom-up; see SURVEY.md §7):
  core/          pure-jnp geometry, robot model, FK, unit conversion
  perception/    MRI volume ingest + fused segmentation (threshold/closing/CCL/stats)
  registration/  L-shape marker triplet matching + SVD Kabsch rigid alignment
  ik/            bounded Levenberg–Marquardt, full-chain + trajectory residuals
  planning/      entry-point search, voxel collision checking, heuristic paths
  api/           MamriEngine facade (the MamriLogic-equivalent public surface)
  hw/            host-side serial hardware layer + simulator + closed-loop executor
  parallel/      device-mesh sharding of the batched pipeline
  utils/         STL ingest, config IO, tracing, checkpointing
"""

import os
import sys

__version__ = "0.1.0"

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compile_cache_dir(environ=os.environ) -> str:
    """Where JAX keeps its persistent compilation cache: the directory
    `JAX_COMPILATION_CACHE_DIR` names when it is set, else `.jax_cache` in
    the checkout (listed in .gitignore). A fixed path, because the path is
    part of the cache key."""
    return environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(_REPO_ROOT, ".jax_cache")


def _configure_compile_cache() -> None:
    """Point JAX at `compile_cache_dir()` unless the environment already
    does. Runs on package import, before any entry point's first jax use;
    the package itself stays jax-free (see below)."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    path = compile_cache_dir()
    jax = sys.modules.get("jax")
    if jax is None:
        os.environ["JAX_COMPILATION_CACHE_DIR"] = path  # read when jax imports
    else:
        jax.config.update("jax_compilation_cache_dir", path)


_configure_compile_cache()

__all__ = ["RobotModel", "load_robot_model", "default_config_path", "__version__"]

# Lazy exports (PEP 562): importing the bare package must stay jax-free so
# host-only tooling — the serve supervisor (api/server.supervise), transport
# and protocol layers — can import mamri_tpu submodules without pulling the
# device runtime into the process. `from mamri_tpu import load_robot_model`
# resolves exactly as before, on first attribute access.
def __getattr__(name):
    if name in ("RobotModel", "load_robot_model", "default_config_path"):
        from mamri_tpu.core import robot

        return getattr(robot, name)
    raise AttributeError(f"module 'mamri_tpu' has no attribute {name!r}")
