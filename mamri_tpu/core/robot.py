"""Robot model: static kinematic definition + pure-function forward kinematics.

The reference loads `robot_config.json` into per-link dicts with vtk matrices
(Mamri/Mamri.py:1577-1613) and evaluates FK by walking the parent chain with
vtkMatrix4x4 multiplies (Mamri/Mamri.py:1486-1505):

    world(link) = world(parent) @ fixed_offset(link) @ articulation(link, angle)

Here the definition becomes a pytree (`RobotModel`) whose static topology
(parents, axis codes) lives in aux data so FK unrolls at trace time into a
fixed sequence of 4x4 matmuls — jit/vmap/grad-friendly and free of Python-level
state. The scene-graph-of-MRML-transforms of the reference is replaced by the
pure function `fk_all_links`.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mamri_tpu.core import transforms
from mamri_tpu.core.transforms import AXIS_CODE_BY_NAME, AXIS_NONE

_RESOURCE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "resources")


def default_config_path() -> str:
    return os.path.join(_RESOURCE_DIR, "mamri_arm.json")


@dataclass(frozen=True)
class LinkSpec:
    """Static (non-traced) metadata for one link."""

    name: str
    parent: int  # index into link list, -1 for root
    axis_code: int  # transforms.AXIS_* (static; drives trace-time branching)
    joint_index: int  # index into the articulated-angle vector, -1 if fixed
    has_markers: bool
    arm_lengths: Tuple[float, float]  # (l1, l2) of the L-shaped marker triplet
    motor_letter: str
    steps_per_rev: int
    visual_mesh: Optional[str]
    collision_mesh: Optional[str]
    color: Tuple[float, float, float]
    offset_mm: Tuple[float, float, float] = (0.0, 0.0, 0.0)  # host-side copy of
    # the fixed translation to the parent (keeps host geometry construction
    # free of device->host transfers)


class RobotModel:
    """Pytree: traced arrays (offsets, limits, marker coords) + static LinkSpecs.

    Articulated chain parity: Joint1..Joint6 (Mamri/Mamri.py:819); the Needle is
    a fixed translational link whose FK frame provides the TCP
    (robot_config.json:117-130 in the reference).
    """

    def __init__(self, fixed_offsets, limits_rad, steps_per_rev, marker_local, needle_tip, needle_axis, specs: Tuple[LinkSpec, ...]):
        self.fixed_offsets = fixed_offsets  # (L, 4, 4) f32
        self.limits_rad = limits_rad  # (J, 2) f32
        self.steps_per_rev = steps_per_rev  # (J,) f32
        self.marker_local = marker_local  # (L, 3, 3) f32, zeros where absent
        self.needle_tip = needle_tip  # (3,) local coords on the Needle link
        self.needle_axis = needle_axis  # (3,) local needle axis
        self.specs = specs

    # ---- static topology helpers -------------------------------------------------
    @property
    def num_links(self) -> int:
        return len(self.specs)

    @property
    def num_joints(self) -> int:
        return sum(1 for s in self.specs if s.joint_index >= 0)

    @property
    def link_names(self) -> Tuple[str, ...]:
        return tuple(s.name for s in self.specs)

    def link_index(self, name: str) -> int:
        try:
            return self.link_names.index(name)
        except ValueError:
            raise KeyError(f"Unknown link {name!r}; robot links are {self.link_names}") from None

    @property
    def articulated_links(self) -> Tuple[int, ...]:
        """Link indices in joint order (Joint1..Joint6)."""
        pairs = [(s.joint_index, i) for i, s in enumerate(self.specs) if s.joint_index >= 0]
        return tuple(i for _, i in sorted(pairs))

    @property
    def articulated_names(self) -> Tuple[str, ...]:
        return tuple(self.specs[i].name for i in self.articulated_links)

    @property
    def marker_links(self) -> Tuple[int, ...]:
        return tuple(i for i, s in enumerate(self.specs) if s.has_markers)

    @property
    def motor_letters(self) -> Tuple[str, ...]:
        return tuple(self.specs[i].motor_letter for i in self.articulated_links)

    def spec(self, name: str) -> LinkSpec:
        return self.specs[self.link_index(name)]

    # ---- pytree protocol ----------------------------------------------------------
    def tree_flatten(self):
        children = (
            self.fixed_offsets,
            self.limits_rad,
            self.steps_per_rev,
            self.marker_local,
            self.needle_tip,
            self.needle_axis,
        )
        return children, self.specs

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, specs=aux)


jax.tree_util.register_pytree_node(
    RobotModel,
    lambda m: m.tree_flatten(),
    RobotModel.tree_unflatten,
)


def load_robot_model(config_path: Optional[str] = None, dtype=jnp.float32) -> RobotModel:
    """Load the arm definition from mamri_tpu's JSON schema into a RobotModel."""
    path = config_path or default_config_path()
    with open(path, "r") as f:
        cfg = json.load(f)
    try:
        return _build_robot_model(cfg, dtype)
    except (KeyError, TypeError, IndexError) as e:
        raise ValueError(
            f"{path}: malformed robot definition ({type(e).__name__}: {e})"
        ) from e


def _build_robot_model(cfg: Dict[str, Any], dtype) -> RobotModel:
    links: List[Dict[str, Any]] = cfg["links"]

    name_to_idx = {l["link"]: i for i, l in enumerate(links)}
    specs: List[LinkSpec] = []
    offsets = np.tile(np.eye(4, dtype=np.float32), (len(links), 1, 1))
    marker_local = np.zeros((len(links), 3, 3), dtype=np.float32)
    limits: List[Tuple[float, float]] = []
    steps_per_rev: List[float] = []
    needle_tip = np.zeros(3, dtype=np.float32)
    needle_axis = np.array([1.0, 0.0, 0.0], dtype=np.float32)

    joint_counter = 0
    for i, l in enumerate(links):
        axis_name = l.get("axis")
        rotational = axis_name in ("IS", "PA", "LR")
        axis_code = AXIS_CODE_BY_NAME.get(axis_name, AXIS_NONE) if rotational else AXIS_NONE
        joint_index = joint_counter if rotational else -1
        if rotational:
            lo, hi = l.get("limits_deg", [-180.0, 180.0])
            limits.append((math.radians(lo), math.radians(hi)))
            steps_per_rev.append(float(l.get("steps_per_rev", 0)))
            joint_counter += 1
        if l.get("offset_mm") is not None:
            offsets[i, :3, 3] = np.asarray(l["offset_mm"], dtype=np.float32)
        pts = l.get("marker_points_mm")
        if pts is not None:
            marker_local[i] = np.asarray(pts, dtype=np.float32)
        if l.get("needle_tip_mm") is not None:
            needle_tip = np.asarray(l["needle_tip_mm"], dtype=np.float32)
        if l.get("needle_axis") is not None:
            needle_axis = np.asarray(l["needle_axis"], dtype=np.float32)
        arms = l.get("marker_arms_mm", [0.0, 0.0])
        specs.append(
            LinkSpec(
                name=l["link"],
                parent=name_to_idx[l["parent"]] if l.get("parent") else -1,
                axis_code=axis_code,
                joint_index=joint_index,
                has_markers=pts is not None,
                arm_lengths=(float(arms[0]), float(arms[1])),
                motor_letter=l.get("motor_letter", ""),
                steps_per_rev=int(l.get("steps_per_rev", 0)),
                visual_mesh=l.get("visual_mesh"),
                collision_mesh=l.get("collision_mesh"),
                color=tuple(l.get("display_color", [0.7, 0.7, 0.7])),
                offset_mm=tuple(l.get("offset_mm") or (0.0, 0.0, 0.0)),
            )
        )

    return RobotModel(
        fixed_offsets=jnp.asarray(offsets, dtype=dtype),
        limits_rad=jnp.asarray(np.asarray(limits), dtype=dtype),
        steps_per_rev=jnp.asarray(np.asarray(steps_per_rev), dtype=dtype),
        marker_local=jnp.asarray(marker_local, dtype=dtype),
        needle_tip=jnp.asarray(needle_tip, dtype=dtype),
        needle_axis=jnp.asarray(needle_axis, dtype=dtype),
        specs=tuple(specs),
    )


def fk_all_links(model: RobotModel, angles, base_tf=None):
    """Forward kinematics: world transforms of every link.

    Args:
      model: RobotModel.
      angles: (J,) joint angles in radians (Joint1..Joint6 order).
      base_tf: (4, 4) world transform of the robot base (defaults to identity).

    Returns:
      (L, 4, 4) stack of world transforms in link order. Semantics match the
      reference's `_get_world_transform_for_joint` (Mamri/Mamri.py:1486-1505):
      world = parent_world @ fixed_offset @ articulation. The loop unrolls at
      trace time (L=8) — static topology, no dynamic control flow.
    """
    angles = jnp.asarray(angles)
    num_joints = model.num_joints
    if angles.shape != (num_joints,):
        # JAX clamps out-of-bounds gathers, so a wrong-length vector would
        # otherwise compute silently-wrong kinematics.
        raise ValueError(f"angles must have shape ({num_joints},), got {angles.shape}")
    if base_tf is None:
        base_tf = jnp.eye(4, dtype=angles.dtype)
    world: List[jnp.ndarray] = []
    for i, spec in enumerate(model.specs):
        parent_tf = base_tf if spec.parent < 0 else world[spec.parent]
        if spec.joint_index >= 0:
            art = transforms.articulation_matrix(spec.axis_code, angles[spec.joint_index])
            local = transforms.matmul(model.fixed_offsets[i], art)
        else:
            local = model.fixed_offsets[i]
        world.append(transforms.matmul(parent_tf, local))
    return jnp.stack(world, axis=0)


def fk_all_links_host(model: RobotModel, angles, base_tf=None) -> np.ndarray:
    """Host-numpy twin of `fk_all_links` for per-tick / per-frame paths.

    The hardware executor publishes a pose frame every 150 ms control tick
    and the streaming tracker anchors its ROI window every frame; such
    per-tick host paths should not dispatch to the device. This float64
    numpy replica has no device dependency; semantics match `fk_all_links` / the reference's
    `_get_world_transform_for_joint` (Mamri/Mamri.py:1486-1505) with the
    axis conventions of `transforms.articulation_matrix` (IS -> RotZ(+t),
    PA -> RotY(-t), LR -> RotX(+t)). Agrees with the device FK to
    <0.01 mm over the joint ranges (tests/test_robot_fk.py).
    """
    angles = np.asarray(angles, dtype=np.float64).reshape(-1)
    if angles.shape[0] != model.num_joints:
        raise ValueError(f"angles must have shape ({model.num_joints},), got {angles.shape}")
    base = np.eye(4) if base_tf is None else np.asarray(base_tf, dtype=np.float64)
    offsets = np.asarray(model.fixed_offsets, dtype=np.float64)
    world: List[np.ndarray] = []
    for i, spec in enumerate(model.specs):
        parent = base if spec.parent < 0 else world[spec.parent]
        local = offsets[i]
        if spec.joint_index >= 0:
            t = angles[spec.joint_index]
            c, s = np.cos(t), np.sin(t)
            art = np.eye(4)
            if spec.axis_code == transforms.AXIS_IS:  # RotZ(+t)
                art[:2, :2] = [[c, -s], [s, c]]
            elif spec.axis_code == transforms.AXIS_PA:  # RotY(-t)
                art[0, 0] = art[2, 2] = c
                art[0, 2] = -s
                art[2, 0] = s
            elif spec.axis_code == transforms.AXIS_LR:  # RotX(+t)
                art[1:3, 1:3] = [[c, -s], [s, c]]
            local = local @ art
        world.append(parent @ local)
    return np.stack(world, axis=0)


def fk_link(model: RobotModel, angles, link_name: str, base_tf=None):
    """World transform of a single named link (FK of the whole chain prefix)."""
    return fk_all_links(model, angles, base_tf)[model.link_index(link_name)]


def marker_world_positions(model: RobotModel, angles, link_name: str, base_tf=None, local_override=None):
    """World positions of a marker-bearing link's 3 local markers under FK."""
    tf = fk_link(model, angles, link_name, base_tf)
    local = local_override if local_override is not None else model.marker_local[model.link_index(link_name)]
    return transforms.apply(tf, local)
