"""Smoke-test the benchmark CLI at tiny scale (mirrors reference strategy)."""

import numpy as np
from click.testing import CliRunner

from tabmat_tpu.bench.generate import get_all_benchmark_matrices
from tabmat_tpu.bench.main import run_all_benchmarks


def test_generators_tiny():
    designs = get_all_benchmark_matrices(scale=0.0001)
    for name in ("dense", "sparse", "two_cat"):
        mat = designs[name]()
        assert mat.shape[0] >= 16
        d = np.random.default_rng(0).random(mat.shape[0])
        mat.sandwich(d)


def test_cli_smoke():
    runner = CliRunner()
    result = runner.invoke(
        run_all_benchmarks,
        [
            "--matrix_name", "dense,sparse",
            "--scale", "0.0001",
            "--n_iterations", "2",
            "--rehearse",
            "--include_baseline",
        ],
    )
    assert result.exit_code == 0, result.output
    assert "tabmat_tpu" in result.output
    assert "numpy/scipy" in result.output
    assert '"device_platform": "cpu"' in result.output
    assert '"card": ' in result.output


def test_cli_refuses_cpu_without_rehearse():
    result = CliRunner().invoke(
        run_all_benchmarks, ["--matrix_name", "dense", "--scale", "0.0001"]
    )
    assert result.exit_code != 0
    assert "tabmat_tpu" not in result.output


def test_cli_memory_and_standardized():
    runner = CliRunner()
    result = runner.invoke(
        run_all_benchmarks,
        [
            "--matrix_name", "dense",
            "--scale", "0.0001",
            "--n_iterations", "2",
            "--rehearse",
            "--bench_memory",
            "--standardized",
        ],
    )
    assert result.exit_code == 0, result.output
    assert "peak_mem_bytes" in result.output


def test_cli_csv_and_visualize(tmp_path):
    runner = CliRunner()
    csv_path = str(tmp_path / "out.csv")
    result = runner.invoke(
        run_all_benchmarks,
        [
            "--matrix_name", "dense,sparse",
            "--scale", "0.0001",
            "--n_iterations", "2",
            "--rehearse",
            "--include_baseline",
            "--output", csv_path,
        ],
    )
    assert result.exit_code == 0, result.output
    from tabmat_tpu.bench.visualize import load_results, plot_relative

    rows = load_results(csv_path)
    assert len(rows) == 12
    png = str(tmp_path / "chart.png")
    assert plot_relative(rows, png) == png
    import os

    assert os.path.getsize(png) > 10_000
