"""The comparison catches a broken timed path: a run of a cell with the
program broken underneath reads ``correct`` false, once for each fault
the cell can have (one card: no exchange between chips to leave out). On
the CPU at a tiny size; with the ``cuda`` marker at the cell's own size.

At the CPU tests' size the kingsnake's calibration squashes the volume's
top values, so its frames past imin 0.35 are blank: the frame faults of
``snake-tfb-iso.tf_edit`` are tested there on ``snake-tfb-iso.still``
(the same frame path at the slider's foot), and on the card on both."""

import dataclasses

import pytest
import torch

from vkbench import run
from vkvolume_tpu_torch.engine import Engine, UpdateStats

SIZES = {"beetle-tfa-aniso.tf_edit": (0.1, (256, 256)),
         "snake-tfb-iso.tf_edit": (0.1, (128, 128)),
         "snake-tfb-iso.still": (0.15, (128, 128))}
CELLS = [w["name"] for w in run.load_manifest()["workloads"]]


def _run(workload, device="cpu"):
    if device == "cpu":
        scale, size = SIZES.get(workload, (0.15, (128, 128)))
        return run.run_cell(workload, 2 ** 31 + 21, 1.0, False,
                            device="cpu", scale=scale, size=size)[0]
    return run.run_cell(workload, 2 ** 31 + 23, 3.0, False,
                        device=device)[0]


def _render_then(change):
    real = Engine.render

    def render(self, camera, width, height, depth_image=None):
        out = real(self, camera, width, height, depth_image)
        return dataclasses.replace(out, color=change(out.color.clone()))
    return render


def _half_left_out(c):
    c[1::2] = 0.0               # every other row of pixels never rendered
    return c


def _altered(c):
    covered = c[..., 3:4] > 0
    return torch.where(covered, (c + 0.05).clamp(max=1.0), c)


def _edits_unchanged():
    """The maps built once, at set-up; every later TF edit returns with
    the volume's state unchanged."""
    real = Engine.update_transfer_function
    built = []

    def update(self, volume, timed_runs=5):
        if any(v is volume for v in built):
            return UpdateStats()
        built.append(volume)
        return real(self, volume, timed_runs)
    return update


FAULTS = {
    "state_unchanged": lambda: ("update_transfer_function",
                                _edits_unchanged()),
    "half_left_out": lambda: ("render", _render_then(_half_left_out)),
    "answer_altered": lambda: ("render", _render_then(_altered)),
}
EDIT_FAULTS = ("state_unchanged", "half_left_out", "answer_altered")
FRAME_FAULTS = ("half_left_out", "answer_altered")
ALL = [(w, f) for w in CELLS
       for f in (EDIT_FAULTS if w.endswith(".tf_edit") else FRAME_FAULTS)]
CPU = [(w, f) for w, f in ALL
       if not (w == "snake-tfb-iso.tf_edit" and f in FRAME_FAULTS)]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    res = _run(workload)
    assert res["correct"], res["check"]


@pytest.mark.parametrize("workload, fault", CPU)
def test_fault_is_caught(monkeypatch, workload, fault):
    monkeypatch.setattr(Engine, *FAULTS[fault]())
    res = _run(workload)
    assert not res["correct"], res["check"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload, fault", ALL)
def test_fault_is_caught_at_cell_size(monkeypatch, cuda_device, workload,
                                      fault):
    monkeypatch.setattr(Engine, *FAULTS[fault]())
    res = _run(workload, cuda_device)
    print(workload, fault, res["check"])
    assert not res["correct"], res["check"]
