"""The traffic generator: mixes are data, their kinds of interaction are
files found by name, seeds fix the inputs."""

import numpy as np
import pytest

from vkbench import check, generator, run


def _mix(name, seed, base=None):
    base = base or {"intensity_min": 0.086}
    scene = generator.Scene(pose=None, tf=base,
                            model=check.model_matrix({"fit": "stretch"}),
                            aspect=1.0)
    return generator.Mix(run.load_mix(name), seed, scene)


def _take(mix, n):
    return [it for it, _ in zip(mix.interactions(), range(n))]


def test_orbit_fresh_poses_and_step():
    its = _take(_mix("orbit", 2 ** 31 + 11), 400)
    az = np.array([it.scene.pose.azimuth_deg for it in its])
    steps = np.diff(az)
    assert np.all(steps >= 2.0) and np.all(steps < 2.01)
    assert np.allclose(steps, steps[0])
    assert len({a for a in az}) == len(az)
    assert all(it.edits == () for it in its)
    assert {it.scene.pose.elevation_deg for it in its} == {20.0}


def test_orbit_seeds_differ_and_repeat():
    a = _take(_mix("orbit", 5), 3)
    b = _take(_mix("orbit", 5), 3)
    c = _take(_mix("orbit", 6), 3)
    assert [x.scene.pose.azimuth_deg for x in a] == [
        x.scene.pose.azimuth_deg for x in b]
    assert a[0].scene.pose.azimuth_deg != c[0].scene.pose.azimuth_deg
    np.testing.assert_array_equal(a[1].scene.pose.view, b[1].scene.pose.view)


def test_orbit_repeat_is_refused():
    mix = _mix("orbit", 1)
    mix.moves[0].seen.add(mix.moves[0].az0)
    with pytest.raises(RuntimeError, match="repeats"):
        next(mix.interactions())


def test_tf_edit_triangle_with_jitter():
    mix = _mix("tf_edit", 77)
    its = _take(mix, 48)
    vals = np.array([it.scene.tf["intensity_min"] for it in its])
    assert all([m.field for m in it.edits] == ["intensity_min"]
               for it in its)
    slider = mix.moves[1]
    step = 2 * 0.25 / 23
    base = np.array([0.086 + generator.load_move("slider").slider(
        (slider.phase + i) % 24, 24, 0.25) for i in range(48)])
    off = vals - base
    assert np.all(off >= 0) and np.all(off < step)
    assert len(set(vals)) == len(vals)
    assert vals.max() < 0.086 + 0.25 + step
    assert {it.scene.pose.azimuth_deg for it in its} == {30.0}


def test_still_is_one_pose():
    its = _take(_mix("still", 9), 20)
    assert {it.scene.pose.azimuth_deg for it in its} == {30.0}
    assert all(it.edits == () for it in its)
    assert {it.scene.tf["intensity_min"] for it in its} == {0.086}


def test_warmup_poses_apart_from_window():
    mix = _mix("orbit", 12)
    warm = {it.scene.pose.azimuth_deg for it in mix.warmup()}
    window = {it.scene.pose.azimuth_deg for it in _take(mix, 200)}
    assert len(warm) == 90 and not warm & window


def test_edit_that_changes_nothing_is_not_applied():
    params = {"moves": [
        {"kind": "orbit", "azimuth_deg": 30.0, "elevation_deg": 20.0},
        {"kind": "slider", "field": "intensity_min", "span": 0.0,
         "steps": 24, "jitter_steps": 0.0}], "warmup": 2}
    scene = generator.Scene(pose=None, tf={"intensity_min": 0.1},
                            model=np.eye(4), aspect=1.0)
    mix = generator.Mix(params, 3, scene)
    assert all(it.edits == () for it in _take(mix, 5) + mix.warmup())


def test_slider_triangle():
    slider = generator.load_move("slider").slider
    vals = [slider(i, 24, 0.25) for i in range(24)]
    assert vals[0] == 0.0 and vals[-1] == 0.0
    assert max(vals) == pytest.approx(0.25 * 22 / 23)
