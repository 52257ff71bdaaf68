"""The control (the reference in the program's place, in bfloat16) comes
out not correct: on the CPU at a size a test run holds, and with the
``cuda`` marker at each cell's own size on three seeds."""

import pytest

from vkbench import control, run

CPU_SIZES = {"beetle-tfa-aniso.tf_edit": (0.4, (256, 256)),
             "snake-tfb-iso.tf_edit": (0.15, (128, 128)),
             "snake-tfb-iso.still": (0.15, (128, 128))}
CELLS = [w["name"] for w in run.load_manifest()["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_on_cpu(workload):
    scale, size = CPU_SIZES.get(workload, (0.15, (128, 128)))
    r = control.control_numbers(workload, 7, device="cpu", scale=scale,
                                size=size)
    assert not r["passes"], r


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [101, 2 ** 31 + 103, 3_000_000_107])
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_at_cell_size(cuda_device, workload, seed):
    r = control.control_numbers(workload, seed, device=cuda_device)
    print(r)
    assert not r["passes"], r
