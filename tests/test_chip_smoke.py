"""chip_smoke.py at toy sizes on the CPU: every phase runs its checks
(the GPU-vs-CPU comparisons compare the CPU with itself here), the device
check refuses a machine without a GPU before any phase, and the last line
is the exact JSON object the smoke contract names. The script itself
runs only on a GPU (see README)."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


@pytest.fixture(autouse=True)
def _private_compile_cache(monkeypatch, tmp_path):
    # cli.main turns the persistent cache on; keep it out of the checkout.
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jc"))
    prev = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", prev)


@pytest.mark.parametrize("scene", ["chap12", "rttnw_final"])
def test_phase_forward_toy(tmp_path, capsys, scene):
    chip_smoke.phase_forward(scene, 16, 12, 2, 4, str(tmp_path),
                             n_rays=64)
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith(f"[forward {scene}]")]
    fields = json.loads(line[0].split("] ", 1)[1])
    assert fields["rays_within_tol"] == 1.0
    assert fields["smoke_mrays_per_s"] > 0
    assert os.path.getsize(tmp_path / f"{scene}.png") > 0


def test_phase_train_toy(capsys):
    chip_smoke.phase_train(16, 8, 4, 4, steps=2, compare_size=(64, 48))
    out = capsys.readouterr().out
    assert "[train chap12]" in out and "GPU vs CPU gradient" in out


def test_phase_chunked_toy(capsys):
    chip_smoke.phase_chunked(32, 24, 16, 4, n_chunks=4)
    out = capsys.readouterr().out
    fields = json.loads(out.split("[chunked chap12] ", 1)[1].splitlines()[0])
    assert fields["chunks"] == 4


def test_phase_four_gpus_toy(capsys):
    """The --four-gpus phase on four of the eight virtual CPU devices."""
    chip_smoke.phase_four_gpus(32, 24, 8, 4, train_spp=8)
    assert "[four_gpus chap12]" in capsys.readouterr().out


def test_main_refuses_without_gpu(capsys):
    with pytest.raises(chip_smoke.NoGPUError):
        chip_smoke.main([])
    out = capsys.readouterr().out
    assert '"ok"' not in out  # no result line
    assert out.splitlines()[0].startswith("[device]")


def test_result_line_is_exact():
    rec = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
           "nvidia_smi": "ignored"}
    assert chip_smoke.result_line(rec) == (
        '{"ok": true, "device": {"platform": "gpu", '
        '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')


@pytest.mark.parametrize("alone", [False, True],
                         ids=["in_checkout", "script_alone"])
def test_script_exits_nonzero_without_gpu(tmp_path, alone):
    """Run as the smoke contract runs it: without a GPU, and in a
    directory holding the script and nothing else of the repo, it exits
    non-zero and prints no result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "jc"))
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, script], capture_output=True,
                         text=True, timeout=300, cwd=cwd, env=env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.gpu
@pytest.mark.parametrize("scene", ["chap12", "rttnw_final"])
def test_gpu_rays_match_cpu(gpu_device, scene):
    """On the card: per-ray radiance of the GPU trace agrees with the CPU
    backend at the golden tolerance."""
    from rrt_tpu.scenes import SCENES
    sc, cm = SCENES[scene](64, 48)
    frac, _ = chip_smoke.compare_rays(sc, cm, 64, 48, 50, n_rays=1024)
    assert frac >= chip_smoke.RAY_MIN_MATCH
