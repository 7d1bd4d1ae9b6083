"""Multi-device tests on the 8-virtual-device CPU mesh (SURVEY.md §4
item 4): shard-vs-single equivalence, mesh-factorization invariance, and
the full sharded training step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rrt_tpu
from rrt_tpu.diff import make_train_step
from rrt_tpu.parallel.mesh import make_mesh, render_image_sharded
from rrt_tpu.scenes import chap11_scene, diffuse_scene

CFG = rrt_tpu.RenderConfig(width=64, height=36, spp=16, max_depth=8,
                           tile_pixels=576, samples_per_pass=2)


def test_sharded_matches_single_device():
    scene, cam = diffuse_scene(CFG.width, CFG.height)
    img1, n1 = rrt_tpu.render_image(scene, cam, CFG, 0)
    mesh = make_mesh(dp=4, sp=2)
    img2, n2 = render_image_sharded(scene, cam, CFG, 0, mesh)
    np.testing.assert_allclose(np.asarray(img1), np.asarray(img2),
                               atol=1e-5, rtol=1e-5)
    assert int(n1) == int(n2)


def test_mesh_factorization_invariance():
    """Tile/pass keys are global ids, so any dp x sp factorization of the
    same device count produces the same image (up to psum ordering)."""
    scene, cam = diffuse_scene(CFG.width, CFG.height)
    imgs = []
    for dp, sp in ((8, 1), (4, 2), (2, 4), (1, 8)):
        img, _ = render_image_sharded(scene, cam, CFG, 0,
                                      make_mesh(dp=dp, sp=sp))
        imgs.append(np.asarray(img))
    for other in imgs[1:]:
        np.testing.assert_allclose(imgs[0], other, atol=1e-5, rtol=1e-5)


@pytest.mark.slow
def test_sharded_train_step_runs_and_descends():
    mesh = make_mesh(dp=4, sp=2)
    cfg = rrt_tpu.RenderConfig(width=16, height=8, spp=4, max_depth=4,
                               tile_pixels=16, samples_per_pass=2)
    scene, cam = chap11_scene(cfg.width, cfg.height)
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    step = make_train_step(cfg, mesh=mesh, lr=1e-3)
    s, c, loss0 = step(scene, cam, target, 0)
    assert np.isfinite(float(loss0))
    # One step toward a black target must reduce the same-seed loss.
    _, _, loss1 = step(s, c, target, 0)
    assert float(loss1) < float(loss0)


@pytest.mark.slow
def test_gradients_replicated_across_mesh():
    """Parameter grads must come back identical to unsharded grads (the
    implicit psum of the shard_map transpose)."""
    from rrt_tpu.diff import partition, render_loss
    cfg = rrt_tpu.RenderConfig(width=16, height=8, spp=4, max_depth=3,
                               tile_pixels=16, samples_per_pass=2)
    scene, cam = chap11_scene(cfg.width, cfg.height)
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    params = partition(scene)

    g_single = jax.grad(render_loss)(params, cam, scene, target, cfg, 0,
                                     None)
    mesh = make_mesh(devices=jax.devices()[:4], dp=2, sp=2)
    g_shard = jax.grad(render_loss)(params, cam, scene, target, cfg, 0,
                                    mesh)
    for k in g_single:
        np.testing.assert_allclose(np.asarray(g_single[k]),
                                   np.asarray(g_shard[k]), atol=1e-5,
                                   rtol=1e-4, err_msg=k)


def test_sharded_queue_matches_single():
    """The fast (queue) driver sharded over dp x sp must reproduce the
    single-device queue image (global per-sample keys)."""
    from rrt_tpu.parallel.mesh import render_image_queue_sharded
    from rrt_tpu.render import render_image_queue
    cfg = rrt_tpu.RenderConfig(width=48, height=27, spp=8, max_depth=8,
                               queue_size=2048)
    scene, cam = diffuse_scene(cfg.width, cfg.height)
    img1, n1 = render_image_queue(scene, cam, cfg, 0)
    for dp, sp in ((8, 1), (4, 2), (2, 4)):
        img2, n2 = render_image_queue_sharded(scene, cam, cfg, 0,
                                              make_mesh(dp=dp, sp=sp))
        np.testing.assert_allclose(np.asarray(img1), np.asarray(img2),
                                   atol=1e-5, rtol=1e-5)
        assert int(n1) == int(n2)


def test_check_vma_policy():
    """Every shard_map in parallel.mesh runs with the static
    varying-manual-axes verifier on: the module passes no check_vma, so
    jax's default (True) holds, and no kernel path needs it off."""
    import inspect

    import rrt_tpu.parallel.mesh as mesh_mod

    assert "check_vma=False" not in inspect.getsource(mesh_mod)
    assert inspect.signature(jax.shard_map).parameters[
        "check_vma"].default is True


def _vma_paths():
    from rrt_tpu.diff import loss_and_grad_chunked
    from rrt_tpu.parallel.mesh import (render_image_queue_sharded,
                                       render_image_sharded)
    cfg = rrt_tpu.RenderConfig(width=16, height=8, spp=4, max_depth=3,
                               tile_pixels=32, samples_per_pass=2,
                               queue_size=256)

    def queue(scene, cam, mesh):
        return render_image_queue_sharded(scene, cam, cfg, 0, mesh)[0]

    def batch(scene, cam, mesh):
        return render_image_sharded(scene, cam, cfg, 0, mesh)[0]

    def batch_grad(scene, cam, mesh):
        from rrt_tpu.diff import partition, render_loss
        return jax.grad(render_loss)(partition(scene), cam, scene, 0.0,
                                     cfg, 0, mesh)

    def chunked_grad(scene, cam, mesh):
        return loss_and_grad_chunked(cfg, spp_chunk=2 * mesh.shape["sp"],
                                     mesh=mesh)(scene, cam, 0.0, 0)[1]

    return {"queue": queue, "batch": batch, "batch_grad": batch_grad,
            "chunked_grad": chunked_grad}


@pytest.mark.parametrize("path", ["queue", "batch", "batch_grad",
                                  "chunked_grad"])
def test_check_vma_on_sharded_paths(monkeypatch, path):
    """Each sharded path traces and runs with check_vma=True."""
    calls = []
    orig = jax.shard_map

    def recording(f=None, /, **kw):
        calls.append(kw.get("check_vma", True))
        return orig(f, **kw)

    monkeypatch.setattr(jax, "shard_map", recording)
    scene, cam = chap11_scene(16, 8)
    mesh = make_mesh(devices=jax.devices()[:4], dp=2, sp=2)
    out = _vma_paths()[path](scene, cam, mesh)
    assert all(np.isfinite(np.asarray(x)).all()
               for x in jax.tree.leaves(out))
    assert calls and all(calls), calls


def test_vary_for_mesh_noop_outside_shard_map():
    """vary_for_mesh must be IDENTITY outside a shard_map — no pcast in
    single-device jaxprs (cache keys and lowering unchanged), leaves
    returned as-is eagerly."""
    import jax.numpy as jnp

    from rrt_tpu.utils.vma import manual_axis_names, vary_for_mesh

    assert manual_axis_names() == ()
    x = (jnp.ones((4,)), jnp.zeros((), jnp.int32))
    y = vary_for_mesh(x)
    assert y[0] is x[0] and y[1] is x[1]

    from rrt_tpu import rng
    from rrt_tpu.camera import generate_rays
    from rrt_tpu.render import trace_batch
    from rrt_tpu.scenes import diffuse_scene

    scene, cam = diffuse_scene(8, 4)
    ids = jnp.arange(32, dtype=jnp.int32)
    px, py = ids % 8, ids // 8
    keys = rng.sample_keys(jax.random.key(0),
                           (py * 8 + px).astype(jnp.uint32), 0)
    o, d, tm = generate_rays(cam, px, py, 8, 4, keys)
    jaxpr = jax.make_jaxpr(
        lambda: trace_batch(scene, o, d, tm, keys, 2, 1e-3,
                            differentiable=False))()
    assert "pcast" not in str(jaxpr) and "pvary" not in str(jaxpr)


@pytest.mark.parametrize("address,pid,explicit,expected", [
    ("localhost:9876", 2, None, [2]),       # several processes, one host
    ("127.0.0.1:9876", 0, None, [0]),
    ("10.0.0.5:9876", 1, None, None),       # one process per host
    ("localhost:9876", 1, [0, 1], [0, 1]),  # explicit ids win
])
def test_initialize_distributed_one_card_per_process(monkeypatch, address,
                                                     pid, explicit,
                                                     expected):
    import rrt_tpu.parallel.mesh as mesh_mod

    seen = {}
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: seen.update(kw))
    mesh_mod.initialize_distributed(address, 4, pid,
                                    local_device_ids=explicit)
    assert seen == {"coordinator_address": address, "num_processes": 4,
                    "process_id": pid, "local_device_ids": expected}
