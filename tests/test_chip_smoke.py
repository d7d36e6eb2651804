"""chip_smoke.py on the CPU: its refusals, its last line, and its phase
functions at a tiny size."""

import json
from types import SimpleNamespace

import jax
import numpy as np
import pytest


@pytest.mark.parametrize("devices,count", [
    ("cpu", 1),
    ([SimpleNamespace(platform="gpu", device_kind="NVIDIA H100")], 4),
    ([], 1)])
def test_require_gpu_refuses(chip_smoke, devices, count):
    devs = jax.devices() if devices == "cpu" else devices
    with pytest.raises(SystemExit) as e:
        chip_smoke.require_gpu(devs, count)
    assert e.value.code not in (0, None)


def test_main_exits_nonzero_without_gpu(chip_smoke, tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main(["--workdir", str(tmp_path / "w")])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out
    assert not (tmp_path / "w").exists()


def test_result_line_format(chip_smoke):
    devs = [SimpleNamespace(platform="gpu",
                            device_kind="NVIDIA H100 80GB HBM3")]
    line = chip_smoke.result_line(devs)
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(line)["device"]["count"] == 1


def test_corpus_and_frame_ce_phases_tiny(chip_smoke, tmp_path):
    p = chip_smoke.phase_corpus(str(tmp_path), train_utts=30, cv_utts=8)
    assert p["dim_nn"] == 368 and p["n_phones"] == 39
    model, cv_acc = chip_smoke.phase_frame_ce(p, bunch=256, cache=2048)
    assert cv_acc > chip_smoke.MIN_CV_ACC
    from nnet_asr_tpu.models import Network
    net = Network.read(model)
    assert [s.n_outputs for s in net.specs] == [500, 500, 39, 39]


def test_reference_comparison_helper_reduced_bunch(chip_smoke):
    cpu = jax.devices("cpu")[0]
    dev = chip_smoke.compare_reference(cpu, cpu, "highest", bunch=32,
                                       n_bunches=2)
    chip_smoke.check_highest(dev)
    chip_smoke.check_band(dev)
    assert dev["post_max_abs"] < chip_smoke.POST_ATOL_HIGHEST
    assert dev["param_max_abs"] == 0.0       # same device, same program
    moved = max(float(np.abs(p["weight"]).max())
                for p in dev["params"] if p)
    assert np.isfinite(moved)
