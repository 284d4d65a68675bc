"""Device-facing helpers that the GPU runs rely on, checked on the CPU:
the published-peak table, the compile-cache location, which modules
the train path imports, and the measurement entry points refusing a
CPU."""

import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import pytest

from gnn_fpga_jax.utils import compile_cache, flops


@pytest.mark.parametrize("kind,tflops,gbps", [
    ("NVIDIA H100 80GB HBM3", 989.0, 3350.0),
    ("NVIDIA H100 PCIe", 756.0, 2000.0),
])
def test_h100_peaks(kind, tflops, gbps):
    dev = SimpleNamespace(device_kind=kind)
    assert flops.device_peaks(dev) == {"bf16_tflops": tflops,
                                       "hbm_gbps": gbps}
    assert flops.mfu(tflops * 1e12 / 4, dev) == pytest.approx(0.25)


def test_unknown_device_kind_raises():
    with pytest.raises(KeyError, match="no published peaks"):
        flops.mfu(1e12, jax.devices("cpu")[0])


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(root, ".jax_cache")
    assert compile_cache.enable_compile_cache() == want
    assert calls == [("jax_compilation_cache_dir", want)]


@pytest.mark.parametrize("module", ["gnn_fpga_jax.cli.train",
                                    "gnn_fpga_jax.train.trainer",
                                    "gnn_fpga_jax.cli.infer"])
def test_train_path_imports_no_optional_packages(module):
    """The GPU machine is only sure to have jax, numpy, scipy, optax,
    chex, einops, pytest and hypothesis."""
    code = ("import sys, {m}; bad = [n for n in ('orbax', 'pandas', "
            "'matplotlib', 'sklearn', 'uproot') if n in sys.modules]; "
            "print(bad); sys.exit(1 if bad else 0)").format(m=module)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("script", ["bench", "bench_scaling"])
def test_benchmarks_refuse_cpu(script, capsys):
    mod = __import__(script)
    with pytest.raises(SystemExit, match="needs a GPU"):
        mod.main([])
    assert capsys.readouterr().out == ""
