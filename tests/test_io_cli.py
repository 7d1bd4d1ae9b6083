"""IO, CLI and checkpoint/resume tests (SURVEY.md §5.4/5.6)."""

import os
import subprocess
import sys
import zlib

import numpy as np
import pytest

from rrt_tpu import io as rio


def test_ppm_roundtrip(tmp_path):
    img = (np.arange(2 * 3 * 3) % 255).astype(np.uint8).reshape(2, 3, 3)
    p = str(tmp_path / "x.ppm")
    rio.write_ppm(p, img)
    data = open(p, "rb").read()
    assert data.startswith(b"P6\n3 2\n255\n")
    assert data.endswith(img.tobytes())


def test_png_valid_structure(tmp_path):
    img = np.zeros((4, 5, 3), np.uint8)
    img[1, 2] = (255, 10, 3)
    p = str(tmp_path / "x.png")
    rio.write_png(p, img)
    data = open(p, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    # decode IDAT and check the raw pixel survives
    idat_start = data.index(b"IDAT") + 4
    idat_len = int.from_bytes(data[idat_start - 8:idat_start - 4], "big")
    raw = zlib.decompress(data[idat_start:idat_start + idat_len])
    row1 = raw[1 * (1 + 5 * 3):2 * (1 + 5 * 3)][1:]
    assert tuple(row1[6:9]) == (255, 10, 3)


def test_checkpoint_roundtrip(tmp_path):
    p = str(tmp_path / "ck.npz")
    acc = np.random.rand(12, 3).astype(np.float32)
    rio.save_checkpoint(p, acc, 17, 42, {"scene": "diffuse"})
    acc2, spp, seed, meta = rio.load_checkpoint(p)
    np.testing.assert_array_equal(acc, acc2)
    assert (spp, seed, meta["scene"]) == (17, 42, "diffuse")


def _run_cli(*args, extra_env=None):
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # Append to (not replace) any PYTHONPATH the environment sets.
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    if extra_env:
        env.update(extra_env)
    return subprocess.run(
        [sys.executable, "-m", "rrt_tpu.cli", "--cpu", *args],
        capture_output=True, text=True, env=env, timeout=500)


def test_cli_renders_and_resumes(tmp_path):
    out = str(tmp_path / "o.png")
    ck = str(tmp_path / "ck.npz")
    r = _run_cli("--scene", "diffuse", "-r", "32x18", "-s", "4",
                 "--spp-chunk", "2", "-o", out, "--checkpoint", ck,
                 "--max-depth", "6")
    assert r.returncode == 0, r.stderr
    assert os.path.exists(out)
    img_full = open(out, "rb").read()

    # Resume: same checkpoint, rendering is already complete -> instant.
    r2 = _run_cli("--scene", "diffuse", "-r", "32x18", "-s", "4",
                  "-o", out, "--checkpoint", ck, "--max-depth", "6")
    assert r2.returncode == 0, r2.stderr
    assert "resumed checkpoint at 4/4" in r2.stderr
    assert open(out, "rb").read() == img_full


def test_read_image_ppm_whitespace_raster(tmp_path):
    """PPM rasters whose leading bytes are whitespace values (9/10/13/32
    are valid intensities) must decode exactly — a naive header split()
    eats them. Also: '#' header comments parse; maxval != 255 and
    truncated rasters are rejected loudly."""
    img8 = np.zeros((2, 2, 3), np.uint8)
    img8[0, 0] = (10, 32, 13)  # newline/space/CR as pixel values
    img8[1, 1] = (200, 9, 255)
    p = str(tmp_path / "ws.ppm")
    rio.write_ppm(p, img8)
    np.testing.assert_allclose(rio.read_image(p),
                               img8.astype(np.float32) / 255.0)

    pc = str(tmp_path / "comment.ppm")
    with open(pc, "wb") as f:
        f.write(b"P6\n# a GIMP-style comment\n2 2\n255\n"
                + img8.tobytes())
    np.testing.assert_allclose(rio.read_image(pc),
                               img8.astype(np.float32) / 255.0)

    p16 = str(tmp_path / "wide.ppm")
    with open(p16, "wb") as f:
        f.write(b"P6\n1 1\n65535\n\x00\x01\x00\x02\x00\x03")
    with pytest.raises(ValueError, match="8-bit"):
        rio.read_image(p16)
    ptr = str(tmp_path / "trunc.ppm")
    with open(ptr, "wb") as f:
        f.write(b"P6\n2 2\n255\n\x01\x02")
    with pytest.raises(ValueError, match="truncated"):
        rio.read_image(ptr)


def test_read_image_png_roundtrip(tmp_path):
    """read_image must invert write_png (via PIL) exactly."""
    rg = np.random.default_rng(11)
    img8 = rg.integers(0, 256, (7, 9, 3), dtype=np.uint8)
    p = str(tmp_path / "t.png")
    rio.write_png(p, img8)
    loaded = rio.read_image(p)
    np.testing.assert_allclose(loaded, img8.astype(np.float32) / 255.0)


def test_cli_texture_flag(tmp_path):
    """--texture PATH mounts a file-loaded image on the earth sphere
    (VERDICT r3 #9): the render must succeed and differ from the
    procedural stand-in; a textureless scene must reject the flag."""
    rg = np.random.default_rng(5)
    img8 = rg.integers(0, 256, (16, 32, 3), dtype=np.uint8)
    tex = str(tmp_path / "tex.ppm")
    rio.write_ppm(tex, img8)

    out_d = str(tmp_path / "default.png")
    out_t = str(tmp_path / "textured.png")
    common = ("--scene", "earth", "-r", "24x14", "-s", "2",
              "--max-depth", "4")
    r = _run_cli(*common, "-o", out_d)
    assert r.returncode == 0, r.stderr
    r = _run_cli(*common, "-o", out_t, "--texture", tex,
                 "--texture-filter", "bilinear")
    assert r.returncode == 0, r.stderr
    assert "texture " in r.stderr
    assert open(out_d, "rb").read() != open(out_t, "rb").read()

    r = _run_cli("--scene", "cornell", "-r", "8x8", "-s", "1",
                 "--texture", tex)
    assert r.returncode == 2
    assert "no image texture" in r.stderr


def test_cli_texture_max_caps_atlas(tmp_path):
    """Oversized texture files are resampled down to --texture-max on
    host with the chosen filter."""
    rg = np.random.default_rng(9)
    img8 = rg.integers(0, 256, (64, 128, 3), dtype=np.uint8)
    tex = str(tmp_path / "big.ppm")
    rio.write_ppm(tex, img8)
    out = str(tmp_path / "o.png")
    r = _run_cli("--scene", "earth", "-r", "16x9", "-s", "1",
                 "--max-depth", "3", "-o", out, "--texture", tex,
                 "--texture-max", "32x16", "--texture-filter",
                 "bilinear")
    assert r.returncode == 0, r.stderr
    assert "-> 16x32 (bilinear" in r.stderr
    assert os.path.exists(out)


def test_builder_bilinear_atlas_resample():
    """When images of different sizes share one atlas, bilinear
    resampling interpolates a ramp exactly while nearest snaps it."""
    from rrt_tpu.scene import SceneBuilder

    ramp = np.zeros((2, 2, 3), np.float32)
    ramp[:, 1] = 1.0  # horizontal 0 -> 1 ramp
    big = np.zeros((4, 4, 3), np.float32)  # forces a 4x4 atlas

    def build(resample):
        b = SceneBuilder()
        m1 = b.lambertian(b.image(ramp, resample=resample))
        m2 = b.lambertian(b.image(big))
        b.sphere((0, 0, 0), 1.0, m1)
        b.sphere((3, 0, 0), 1.0, m2)
        return np.asarray(b.build().images[0])

    near = build("nearest")
    bil = build("bilinear")
    # nearest: texel duplication, only 0s and 1s
    assert set(np.unique(near[..., 0])) <= {0.0, 1.0}
    # bilinear: atlas x-centers 0.125..0.875 map into the ramp's
    # [−0.5, 1.5] texel space -> 0, 0.25, 0.75, 1 per row
    np.testing.assert_allclose(bil[0, :, 0], [0.0, 0.25, 0.75, 1.0],
                               atol=1e-6)


def test_cli_crash_recovery_bit_exact(tmp_path):
    """Fault injection + recovery (SURVEY §5.3, VERDICT r3 #6): a render
    killed mid-run (hard os._exit after 2 of 4 chunks, past >=1 saved
    checkpoint) must, on restart with the same --checkpoint, produce a
    final image BIT-FOR-BIT equal to an uninterrupted render. The
    counter-keyed RNG makes every (pixel, sample) draw independent of
    execution history, so the resumed accumulator continues exactly."""
    out_ok = str(tmp_path / "uninterrupted.png")
    r = _run_cli("--scene", "diffuse", "-r", "32x18", "-s", "8",
                 "--spp-chunk", "2", "-o", out_ok, "--max-depth", "6")
    assert r.returncode == 0, r.stderr
    golden = open(out_ok, "rb").read()

    out = str(tmp_path / "crashed.png")
    ck = str(tmp_path / "ck.npz")
    r1 = _run_cli("--scene", "diffuse", "-r", "32x18", "-s", "8",
                  "--spp-chunk", "2", "-o", out, "--checkpoint", ck,
                  "--checkpoint-every", "1", "--max-depth", "6",
                  extra_env={"RRT_FAULT_AFTER_CHUNKS": "2"})
    assert r1.returncode == 17  # the injected crash, not a clean exit
    assert not os.path.exists(out)  # died before the final write
    assert os.path.exists(ck)  # ...but after >=1 checkpoint
    from rrt_tpu import io as rio2
    _, spp_done, _, _ = rio2.load_checkpoint(ck)
    assert spp_done == 4  # mid-render: 2 of 4 chunks

    r2 = _run_cli("--scene", "diffuse", "-r", "32x18", "-s", "8",
                  "--spp-chunk", "2", "-o", out, "--checkpoint", ck,
                  "--max-depth", "6")
    assert r2.returncode == 0, r2.stderr
    assert "resumed checkpoint at 4/8" in r2.stderr
    assert open(out, "rb").read() == golden


def test_cli_bad_resolution():
    r = _run_cli("--scene", "diffuse", "-r", "banana")
    assert r.returncode == 2
    assert "resolution" in r.stderr


def test_cli_unknown_scene():
    r = _run_cli("--scene", "nope", "-r", "8x8", "-s", "1")
    assert r.returncode == 2
    assert "unknown scene" in r.stderr


@pytest.mark.parametrize("driver,resolved", [("auto", "queue"),
                                             ("queue", "queue"),
                                             ("batch", "batch")])
def test_cli_driver_choice(tmp_path, monkeypatch, capsys, driver,
                           resolved):
    """`--driver auto` (the default) is the compacted queue; queue and
    batch are honored, and each renders the image in-process."""
    from rrt_tpu import cli

    assert cli.build_parser().parse_args([]).driver == "auto"
    assert cli.resolve_driver(driver) == resolved
    import jax
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jc"))
    prev = jax.config.jax_compilation_cache_dir
    out = str(tmp_path / "o.ppm")
    try:
        assert cli.main(["--scene", "diffuse", "-r", "8x6", "-s", "2",
                         "--max-depth", "3", "--driver", driver,
                         "-o", out]) == 0
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)
    assert f"driver={driver}" in capsys.readouterr().err
    assert os.path.getsize(out) == len(b"P6\n8 6\n255\n") + 8 * 6 * 3


@pytest.mark.parametrize("argv", [["--driver", "tile"], ["--pallas"],
                                  ["--no-megakernel"]])
def test_cli_rejects_removed_options(argv, capsys):
    from rrt_tpu import cli
    with pytest.raises(SystemExit) as e:
        cli.build_parser().parse_args(argv)
    assert e.value.code == 2
