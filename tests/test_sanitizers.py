"""Sanitizer-class checks (SURVEY.md §5.2).

The reference NEEDS a race detector for its UnsafeCell thread-local RNG
(src/threadpool.rs:6, src/lib.rs:90-92) but ships none; the rebuild's
stateless counter-keyed design removes that hazard class by
construction. What remains checkable here:

  * NaN hygiene — jax_debug_nans raises on any NaN materialized by a
    render (the kernels use INF sentinels and clamped math; a NaN
    anywhere is a bug);
  * buffer aliasing/donation — no entry point may mutate its inputs
    (nothing is donated; a clobbered scene would silently corrupt the
    next chunk of a progressive render);
  * tracer leaks — jit boundaries must not capture tracers (the
    existing check in test_queue covers the queue driver; this covers
    the train step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rrt_tpu
from rrt_tpu.diff import make_train_step
from rrt_tpu.scenes import chap11_scene, cornell_box_scene


def test_render_is_nan_free():
    cfg = rrt_tpu.RenderConfig(width=24, height=16, spp=2, max_depth=4,
                               tile_pixels=96, samples_per_pass=2)
    scene, cam = cornell_box_scene(cfg.width, cfg.height)
    jax.config.update("jax_debug_nans", True)
    try:
        img, n = rrt_tpu.render_image(scene, cam, cfg, 0)
        jax.block_until_ready(img)
    finally:
        jax.config.update("jax_debug_nans", False)
    assert np.isfinite(np.asarray(img)).all()


def test_entry_points_do_not_mutate_inputs():
    """No donation/aliasing: scene and camera buffers are bit-identical
    after a render and after a full train step."""
    cfg = rrt_tpu.RenderConfig(width=16, height=8, spp=2, max_depth=3,
                               tile_pixels=64, samples_per_pass=2)
    scene, cam = chap11_scene(cfg.width, cfg.height)
    before = jax.tree_util.tree_map(np.array, (scene, cam))

    img, _ = rrt_tpu.render_image(scene, cam, cfg, 0)
    jax.block_until_ready(img)
    step = make_train_step(cfg, lr=1e-3)
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    out = step(scene, cam, target, 0)
    jax.block_until_ready(out)

    after = jax.tree_util.tree_map(np.array, (scene, cam))
    for a, b in zip(jax.tree_util.tree_leaves(before),
                    jax.tree_util.tree_leaves(after)):
        np.testing.assert_array_equal(a, b)


def test_train_step_leaks_no_tracers():
    cfg = rrt_tpu.RenderConfig(width=16, height=8, spp=2, max_depth=3,
                               tile_pixels=64, samples_per_pass=2)
    scene, cam = chap11_scene(cfg.width, cfg.height)
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    with jax.check_tracer_leaks():
        step = make_train_step(cfg, lr=1e-3)
        s2, c2, loss = step(scene, cam, target, 0)
        jax.block_until_ready(loss)
    assert np.isfinite(float(loss))


def test_enable_persistent_cache_respects_user_config(monkeypatch,
                                                     tmp_path):
    """A user's JAX_COMPILATION_CACHE_DIR wins over the checkout default,
    even when it was set after jax was imported."""
    from rrt_tpu.utils.cache import enable_persistent_cache

    prev = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert enable_persistent_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


@pytest.mark.parametrize("env_set", [True, False],
                         ids=["env", "default"])
def test_compile_cache_written_where_configured(tmp_path, env_set):
    """A fresh process compiles one function: with
    JAX_COMPILATION_CACHE_DIR set the cache lands there and nowhere else;
    without it, in <checkout>/.jax_cache. The package is copied into a
    scratch checkout so that its default cache is private to this
    test."""
    import os
    import shutil
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    checkout = tmp_path / "checkout"
    shutil.copytree(os.path.join(repo, "rrt_tpu"), checkout / "rrt_tpu",
                    ignore=shutil.ignore_patterns("__pycache__"))
    script = (
        "import jax, jax.numpy as jnp\n"
        "from rrt_tpu.utils.cache import enable_persistent_cache\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', "
        "0)\n"
        "print(enable_persistent_cache())\n"
        "jax.jit(lambda x: jnp.sin(x) * 3.0)(jnp.ones(7))"
        ".block_until_ready()\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(checkout))
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env_dir = tmp_path / "jc"
    if env_set:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_dir)
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         cwd=str(tmp_path), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    default_dir = checkout / ".jax_cache"
    where = out.stdout.strip().splitlines()[-1]
    if env_set:
        assert where == str(env_dir)
        assert os.listdir(env_dir)
        assert not default_dir.exists()
    else:
        assert where == str(default_dir)
        assert os.listdir(default_dir)
        assert not env_dir.exists()
