"""chip_smoke.py: its CPU rehearsal, its four-device path and its refusals.

The script itself runs on the GPU; here it runs with ``--rehearse`` at tiny
sizes, once per module, and each phase's JSON line is checked.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")


def _run(*args, cwd=REPO, devices=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    flags = env.get("XLA_FLAGS", "").replace(
        "--xla_force_host_platform_device_count=8", ""
    )
    if devices:
        flags += f" --xla_force_host_platform_device_count={devices}"
    env["XLA_FLAGS"] = flags.strip()
    return subprocess.run(
        [sys.executable, os.path.join(cwd, "chip_smoke.py"), *args],
        capture_output=True, text=True, timeout=900, cwd=cwd, env=env,
    )


def _json_lines(stdout):
    return [json.loads(line) for line in stdout.splitlines() if line.startswith("{")]


@pytest.fixture(scope="module")
def rehearsal():
    out = _run("--rehearse")
    assert out.returncode == 0, out.stderr[-3000:]
    lines = _json_lines(out.stdout)
    return {line.get("phase", "last"): line for line in lines}, out.stdout


@pytest.mark.parametrize("phase", ["ops", "f32", "irls"])
def test_rehearsal_phase_passes(rehearsal, phase):
    line = rehearsal[0][phase]
    assert line["ok"] is True
    assert line["max_err"] <= line["tol"]
    assert line["seconds"] > 0
    assert all(c["err"] <= c["tol"] for c in line["checks"].values())


def test_rehearsal_device_phase(rehearsal):
    line = rehearsal[0]["device"]
    assert line["device"]["platform"] == "cpu"
    assert line["rehearsal"] is True and line["x64"] is True
    assert line["compilation_cache_dir"]
    assert isinstance(line["native_helpers_loaded"], bool)
    assert "nvidia-smi" in line["card"] or "W" in line["card"]


def test_rehearsal_covers_every_public_op(rehearsal):
    checks = rehearsal[0]["ops"]["checks"]
    for mat in ("dense", "sparse", "categorical", "split", "standardized"):
        for op in ("sandwich", "matvec", "transpose_matvec"):
            assert f"{mat}.{op}" in checks
        assert f"{mat}.sandwich[rows,cols]" in checks


def test_rehearsal_tf32_probe_present(rehearsal):
    checks = rehearsal[0]["f32"]["checks"]
    probes = [k for k in checks if k.startswith("tf32_probe.")]
    assert len(probes) == 5
    assert all(checks[k]["tol"] == 2.0**-14 for k in probes)


def test_rehearsal_from_df_phase(rehearsal):
    line = rehearsal[0]["from_df"]
    assert line.get("ok", True) is True
    if line.get("ran") is False:
        assert "not installed" in line["reason"]


def test_rehearsal_timing_phase(rehearsal):
    line = rehearsal[0]["timing"]
    assert line["device"]["platform"] == "cpu"
    assert line["ops"]["dense.sandwich"]["median_ms"] > 0
    assert "dense.sandwich_byte_bound_ms" in line
    assert any(k.startswith("irls_step.") for k in line["ops"])


def test_rehearsal_last_line(rehearsal):
    last = rehearsal[1].strip().splitlines()[-1]
    got = json.loads(last)
    assert set(got) == {"ok", "device"}
    assert got["ok"] is True
    assert set(got["device"]) == {"platform", "kind", "count"}


def test_four_cards_rehearsal_on_virtual_devices():
    out = _run("--rehearse", "--four-cards", devices=4)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = _json_lines(out.stdout)
    assert [line.get("phase") for line in lines] == ["four_cards", None]
    phase = lines[0]
    assert phase["ok"] is True
    for key in ("rows_over_4.irls_step", "dp2_x_mp2.irls_step", "mixed_irls_step",
                "shard_map.sandwich", "rows_over_4.distinct_devices"):
        assert phase["checks"][key]["err"] <= phase["checks"][key]["tol"]
    assert lines[-1]["device"]["count"] == 4


def test_four_cards_refuses_fewer_devices():
    out = _run("--rehearse", "--four-cards", devices=2)
    assert out.returncode != 0
    assert not _json_lines(out.stdout)


def test_refuses_cpu_without_rehearse():
    out = _run()
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert not _json_lines(out.stdout)


def test_fails_alone_without_the_package(tmp_path):
    shutil.copy(SCRIPT, tmp_path / "chip_smoke.py")
    out = _run(cwd=str(tmp_path))
    assert out.returncode != 0
    assert "No module named 'tabmat_tpu'" in out.stderr
    assert not _json_lines(out.stdout)
