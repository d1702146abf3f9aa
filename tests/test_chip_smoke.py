"""chip_smoke.py's phases, called directly on the CPU at small sizes.

The script itself refuses to run anywhere but on a GPU; these tests drive
each phase's checks through the same public API on the demo scene (3 mm
grid), so a broken phase shows here before it costs a card."""

import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from mamri_tpu.api import MamriEngine  # noqa: E402
from mamri_tpu.api.demo import add_speckle, build_demo_scene  # noqa: E402
from mamri_tpu.perception.volume import Volume  # noqa: E402


@pytest.fixture(scope="module")
def engine():
    return MamriEngine()


@pytest.fixture(scope="module")
def scene(engine):
    vol, angles, base, target = build_demo_scene(engine, spacing=3.0)
    noisy = Volume(add_speckle(vol.data, 400), vol.spacing, vol.origin)
    # the large slot reuses the scene's own shape: one compile on the CPU
    return {
        "vols": [vol], "truths": [(angles, base)], "large": vol, "noisy": noisy,
        "batch": 2, "target": target,
    }


def _phase_line(capsys, phase):
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert lines and lines[-1]["phase"] == phase
    return lines[-1]


def test_smoke_refuses_cpu_and_prints_nothing(capsys):
    with pytest.raises(cs.SmokeFailure, match="no GPU"):
        cs.main([])
    assert capsys.readouterr().out == ""


def test_phase_precision(engine, capsys):
    cs.phase_precision(engine)
    line = _phase_line(capsys, 1)
    assert line["zero_pose_z"] == [0, 20, 50, 200, 200, 355, 368, 439]
    assert line["needle_tip_err_mm"] < 1e-3


def test_phase_reference(engine, scene, capsys):
    cs.phase_reference(engine, scene["vols"][0])
    line = _phase_line(capsys, 3)
    assert line["blobs"] == 12 and line["components"] >= 13


def test_phase_main_path(engine, scene, capsys):
    cs.phase_main_path(engine, scene)
    line = _phase_line(capsys, 4)
    assert line["estimate_pose_batch"]["batch"] == 2
    assert line["noisy"]["components"] > 400  # escalated past 128 roots


def test_phase_planning(engine, scene, capsys):
    cs.phase_planning(engine, scene)
    line = _phase_line(capsys, 5)
    assert line["sweep_distances"] == 8 and line["sweep_solved"] >= 1


def test_phase_streaming(engine, scene, capsys):
    cs.phase_streaming(engine, scene)
    line = _phase_line(capsys, 6)
    assert line["roi_int16"]["roi_frames"] >= 1
    assert line["pipelined"]["failures"] == 0


def test_phase_served(engine, scene, capsys):
    cs.phase_served(engine, scene)
    line = _phase_line(capsys, 7)
    assert all(line[r]["status"] == 200 for r in ("/estimate", "/estimate_batch", "/entry", "/plan"))


def test_solved_rejects_a_wrong_pose(engine, scene):
    angles, base = scene["truths"][0]
    ok, err = cs.solved(engine, angles, 0.1, (angles, base))
    assert ok and err["tcp_err_mm"] == 0.0
    wrong = np.asarray(angles) + np.float32(0.1)
    ok, err = cs.solved(engine, wrong, 0.1, (angles, base))
    assert not ok and err["j1_err_deg"] > cs.MAX_J1_DEG


def test_build_scene_shapes(engine):
    sc = cs.build_scene(engine, size=24, large_shape=(32, 32, 16), batch=4, n_speckle=20)
    assert [v.data.shape for v in sc["vols"]] == [(24, 24, 24)] * 4
    assert sc["large"].data.shape == (32, 32, 16)
    # the large grid covers the same physical extent as the cubic one
    np.testing.assert_allclose(
        sc["large"].spacing * np.array([32, 32, 16]), sc["vols"][0].spacing * 24, rtol=1e-6
    )
    assert sc["noisy"].data.shape == (24, 24, 24)
    assert not np.array_equal(sc["noisy"].data, sc["vols"][0].data)
    assert sc["batch"] == 4 and len(sc["truths"]) == 4


def test_four_cards_on_virtual_mesh(engine, scene, capsys):
    """The --four path on four of the test mesh's virtual devices, on the
    3 mm demo scene (the real run uses 16 x 256^3 and 4 x 512x512x192); the
    large slot is the scene padded to an even x extent for sp=2."""
    vol = scene["vols"][0]
    pad = vol.data.shape[0] % 2
    padded = np.pad(vol.data, ((0, pad), (0, 0), (0, 0)), constant_values=10.0)
    cs.four_cards(engine, {**scene, "batch": 8, "large": Volume(padded, vol.spacing, vol.origin)})
    line = _phase_line(capsys, "four")
    # on the CPU both meshes reproduce one device bit for bit
    assert line["dp4"]["bit_exact"] and line["dp2sp2"]["bit_exact"]
    assert line["dp4"]["solved"] and line["dp2sp2"]["solved"]
