"""Each cell of BENCHMARK.json, its traffic at a tiny size on the CPU
through the program's plain versions, gives a result with the contract's
keys; the command refuses to run without a card."""

import json

import pytest

from vkbench import run

MANIFEST = run.load_manifest()
SCALE = {"beetle-tfa-aniso": 0.08, "snake-tfb-iso": 0.05}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload",
                         [w["name"] for w in MANIFEST["workloads"]])
def test_cell_result_line(workload, trace, capsys):
    cell = next(w for w in MANIFEST["workloads"] if w["name"] == workload)
    scale = SCALE.get(cell["config"], 0.05)
    res, lines = run.run_cell(workload, 2 ** 31 + 5, 1.5, bool(trace),
                              device="cpu", scale=scale, size=(128, 128))
    line = json.loads(json.dumps(res))
    assert list(line)[-1] == "check"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in run.cell_metrics(MANIFEST, workload, kind)}
    # On the CPU no device operation is traced: the device readers give
    # nothing, and the result leaves them out.
    assert set(line["metrics"]) <= want
    if trace:
        assert "render_host_ms" in line["metrics"]
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == want
        assert line["metrics"]["setup_s"]["unit"] == "s"
    assert [l.split()[1] for l in lines] == list(line["check"])
    out = capsys.readouterr().out
    assert "interactions" in out and "memory_peak_bytes" in out


def test_refuses_without_a_card(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", MANIFEST["workloads"][0]["name"],
                   "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_manifest_names_exist():
    for c in MANIFEST["configs"]:
        cfg = run.load_config(c["name"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
    for w in MANIFEST["workloads"]:
        run.load_mix(w["traffic"])
        assert w["chips"] == 1
    for m in MANIFEST["per_layer"]:
        assert hasattr(run.load_metric(m["name"]), "read")
