"""Smoke-test the core-op benchmark script at tiny scale (CPU rehearsal).

Guards against bench.py breaking silently: it runs unattended on the GPU.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_bench(*args):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py"), *args],
        capture_output=True,
        text=True,
        timeout=600,
        cwd=REPO,
        env=env,
    )


def test_bench_py_smoke():
    out = _run_bench("--rehearse", "--scale", "0.002")
    assert out.returncode == 0, out.stderr[-2000:]
    line = [l for l in out.stdout.splitlines() if l.startswith("{")][-1]
    d = json.loads(line)
    assert {"metric", "value", "unit", "vs_baseline", "device", "card"} <= set(d)
    assert d["value"] > 0
    assert d["dense_sandwich_f64_relerr"] < 1e-11
    assert d["device"]["platform"] == "cpu" and d["device"]["count"] >= 1
    assert d["rehearsal"] is True


def test_bench_py_refuses_cpu_without_rehearse():
    out = _run_bench("--scale", "0.002")
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert not [l for l in out.stdout.splitlines() if l.startswith("{")]
