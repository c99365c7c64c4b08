"""Process set-up for the card: compile cache and CPU-pinned children;
the entry scripts' refusal to run without a GPU."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from kaldi_aslp_tpu.utils import jax_setup

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_defaults_to_fixed_dir_in_checkout(
        monkeypatch, restore_cache_dir):
    monkeypatch.delenv(jax_setup.CACHE_ENV, raising=False)
    path = jax_setup.configure_compile_cache()
    assert path == str(REPO / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()
    # a second call (a second process) picks the same directory
    assert jax_setup.configure_compile_cache() == path


def test_compile_cache_env_var_wins_and_code_sets_nothing(
        monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv(jax_setup.CACHE_ENV, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert jax_setup.configure_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_cpu_only_env_pins_children_to_cpu():
    env = jax_setup.cpu_only_env({"JAX_PLATFORMS": "cuda", "A": "1"})
    assert env == {"JAX_PLATFORMS": "cpu", "A": "1"}
    assert jax_setup.cpu_only_env()["JAX_PLATFORMS"] == "cpu"


@pytest.mark.parametrize("script,args", [("chip_smoke.py", []),
                                         ("chip_smoke.py", ["--four-cards"]),
                                         ("bench.py", ["--sections", "ctc"])])
def test_entry_scripts_refuse_the_cpu(script, args, tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    r = subprocess.run([sys.executable, str(REPO / script)] + args,
                       capture_output=True, text=True, env=env,
                       cwd=REPO, timeout=300)
    assert r.returncode != 0
    assert "GPU" in r.stderr
    assert '"ok"' not in r.stdout


def test_chip_smoke_alone_fails_without_the_package(tmp_path):
    (tmp_path / "chip_smoke.py").write_text(
        (REPO / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, env=env,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_bench_peak_table_knows_the_h100():
    sys.path.insert(0, str(REPO))
    import bench

    peak = bench.peak_for("NVIDIA H100 80GB HBM3")
    assert peak == {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", ""])
def test_bench_peak_table_rejects_unknown_devices(kind):
    sys.path.insert(0, str(REPO))
    import bench

    with pytest.raises(ValueError, match="no peak rates"):
        bench.peak_for(kind)
