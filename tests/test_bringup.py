"""Device-independent parts of running on the GPU: the compile-cache
location, the peak table the benchmarks divide by, and that the chip
smoke test refuses to run (and to report success) without a GPU."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

from deeprec_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import model_benchmark  # noqa: E402


@pytest.fixture
def cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_env(monkeypatch, cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable() == "/some/where"
    assert jax.config.jax_compilation_cache_dir == before  # nothing set


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch,
                                                    cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_chip_peaks_h100_only():
    assert model_benchmark.chip_peaks("NVIDIA H100 80GB HBM3") == (
        989e12, 3.35e12)
    assert list(model_benchmark.CHIP_PEAKS) == ["NVIDIA H100 80GB HBM3"]
    # Exact kinds only: no substring match, no default peak.
    for kind in ("NVIDIA H100", "h100", "cpu", ""):
        assert model_benchmark.chip_peaks(kind) is None


class _Compiled:
    def cost_analysis(self):
        return {"flops": 2.0e12}


@pytest.mark.parametrize("kind,mfu", [
    ("NVIDIA H100 80GB HBM3", 2.0e12 / 0.01 / 989e12),
    ("Some Future GPU", None),
])
def test_roofline_peak_known_or_null(kind, mfu):
    out = model_benchmark.roofline({}, _Compiled(), 0.01, kind=kind)
    assert out["tflops_per_s"] == 200.0
    if mfu is None:
        assert out["peak"] is None and "mfu" not in out
    else:
        assert out["peak"] == {"bf16_flops_per_s": 989e12,
                               "bytes_per_s": 3.35e12}
        assert out["mfu"] == round(mfu, 4)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_gpu(alone, tmp_path):
    """On the CPU backend, beside the repo or in a directory holding only
    the script, chip_smoke.py stops at its platform gate: non-zero exit,
    no verdict line."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "chip_smoke: needs a GPU, JAX found 'cpu'" in r.stderr
    for line in r.stdout.splitlines():
        if line.startswith("{"):
            assert json.loads(line).get("ok") is not True
    assert '"ok": true' not in r.stdout


def test_kernel_benchmark_small_on_cpu(capsys):
    """The XLA row-op benchmark runs end to end at --small shapes and
    labels every row with the device it ran on."""
    import kernel_benchmark
    kernel_benchmark.main(["--small"])
    rows = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert [r["op"] for r in rows] == (
        ["gather_rows"] * 2 + ["sparse_adagrad_apply"] * 2
        + ["sparse_adam_apply"] * 2 + ["hash_find"] * 2)
    assert all(r["device"]["platform"] == "cpu" and r["ms"] > 0
               for r in rows)
