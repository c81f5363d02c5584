"""The port's health report (``utils/doctor.py``, the ``doctor`` command), its
logging and stage timers (``utils/logging.py``) and its traces
(``utils/profiler.py``), on the CPU.  The card probe's subprocess is replaced
where a test needs a healthy or a hung card.
"""

import json
import logging
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from seekr_tpu_torch import cli
from seekr_tpu_torch.utils import doctor, get_logger, span, stage_timer, trace_session

ROOT = Path(__file__).resolve().parents[1]


def test_host_checks_pass(capsys):
    assert doctor.run_doctor(skip_device=True) is True
    out = capsys.readouterr().out
    for line in ("[ok  ] python", "[ok  ] torch", "[ok  ] numpy", "[ok  ] scipy",
                 "[ok  ] native", "all checks passed"):
        assert line in out
    assert "card" not in out and "device" not in out


def test_env_knobs_surface_as_warnings(monkeypatch, capsys):
    monkeypatch.setenv("SEEKR_TPU_HOST_SORT", "numpy")
    monkeypatch.setenv("SEEKR_TPU_SCRATCH", "/tmp")
    assert doctor.run_doctor(skip_device=True) is True  # a warning is not a failure
    out = capsys.readouterr().out
    assert "[warn] env        SEEKR_TPU_HOST_SORT=numpy (non-default)" in out
    assert "SEEKR_TPU_SCRATCH=/tmp (non-default)" in out


class Proc:
    def __init__(self, stdout="", returncode=0, stderr=""):
        self.stdout, self.returncode, self.stderr = stdout, returncode, stderr


def test_device_probe_healthy_and_wrong(monkeypatch):
    res = {"name": "NVIDIA H100 80GB HBM3", "nvcc": "/usr/local/cuda/bin/nvcc",
           "build_s": 3.1, "launches": 1, "equal": True}
    monkeypatch.setattr(doctor.subprocess, "run", lambda *a, **kw: Proc(json.dumps(res)))
    (s1, n1, d1), (s2, n2, d2) = doctor._device_probe(5.0)
    assert (s1, n1, s2, n2) == (doctor.OK, "cuda-build", doctor.OK, "device")
    assert "H100" in d2 and "bitwise equal" in d2 and "3.10 s" in d1
    res["equal"] = False
    monkeypatch.setattr(doctor.subprocess, "run", lambda *a, **kw: Proc(json.dumps(res)))
    assert doctor._device_probe(5.0)[1][0] == doctor.FAIL


def test_device_probe_hang_and_failure_are_reported(monkeypatch):
    def hang(*a, **kw):
        raise subprocess.TimeoutExpired(cmd=a[0], timeout=kw["timeout"])

    monkeypatch.setattr(doctor.subprocess, "run", hang)
    (status, name, detail), = doctor._device_probe(1.0)
    assert status == doctor.FAIL and "hung" in detail
    monkeypatch.setattr(doctor.subprocess, "run",
                        lambda *a, **kw: Proc(returncode=1, stderr="x\nKernelBuildError: no nvcc"))
    (status, _, detail), = doctor._device_probe(1.0)
    assert status == doctor.FAIL and "no nvcc" in detail


def test_the_probe_runs_in_a_subprocess_and_fails_here():
    # the real probe: no nvcc and no card here, so the build fails in the child
    # and the parent process stays without a CUDA context
    rows = doctor._device_probe(120.0)
    assert rows[-1][0] == doctor.FAIL and rows[-1][1] == "device"
    assert not torch.cuda.is_initialized()


def test_doctor_command_exit_codes():
    run = dict(cwd=ROOT, capture_output=True, text=True, timeout=300)
    host = subprocess.run([sys.executable, "-m", "seekr_tpu_torch.cli", "doctor",
                           "--no-device"], **run)
    assert host.returncode == 0 and "doctor: all checks passed" in host.stdout
    # a bare doctor runs every check; without a card it is unhealthy
    bare = subprocess.run([sys.executable, "-m", "seekr_tpu_torch.cli", "doctor",
                           "--device-timeout", "120"], **run)
    assert bare.returncode == 1 and "FAILURES above" in bare.stdout
    assert "[fail] card" in bare.stdout and "[fail] device" in bare.stdout


def test_doctor_command_in_process(capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["doctor", "--no-device"])
    assert exc.value.code == 0 and "[ok  ] native" in capsys.readouterr().out


def test_stage_timer_logs_also_when_the_block_raises(caplog):
    get_logger()
    caplog.set_level(logging.INFO, logger="seekr_tpu_torch.timing")
    with stage_timer("unit/ok", items=10, unit="rows"):
        pass
    with pytest.raises(RuntimeError):
        with stage_timer("unit/raises"):
            raise RuntimeError("boom")
    names = [r.args[0] for r in caplog.records if r.name == "seekr_tpu_torch.timing"]
    assert names == ["unit/ok", "unit/raises"]
    assert "rows/s" in caplog.records[0].getMessage()


def test_trace_session_writes_a_chrome_trace(tmp_path, monkeypatch):
    with trace_session(str(tmp_path / "t")) as path:
        with span("seekr/unit"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads(Path(path).read_text())
    assert any(e.get("name") == "seekr/unit" for e in trace["traceEvents"])
    # the variable is read at call time; unset, the session is a no-op
    monkeypatch.setenv("SEEKR_TPU_TRACE", str(tmp_path / "env"))
    with trace_session() as env_path:
        torch.zeros(4).sum()
    assert Path(env_path).parent == tmp_path / "env" and Path(env_path).is_file()
    monkeypatch.delenv("SEEKR_TPU_TRACE")
    with trace_session() as none:
        assert none is None
