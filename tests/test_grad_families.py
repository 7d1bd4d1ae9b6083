"""Finite-difference checks of the differentiable scan for every
primitive family, texture kind and driver option the book scenes use.

Each case builds a scene in which the checked parameter moves no
visibility edge and no discrete decision, so central differences see
exactly the interior (detached-sampling) gradient that autodiff returns:
colors and emission enter the radiance polynomially; a moving sphere that
covers the frame turns its surface normals, and with them the sky
radiance its scattered rays see.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rrt_tpu
from rrt_tpu.camera import Camera
from rrt_tpu.diff import partition, render_loss
from rrt_tpu.scene import SceneBuilder

CFG = rrt_tpu.RenderConfig(width=16, height=12, spp=4, max_depth=4,
                           tile_pixels=16 * 12, samples_per_pass=4)
ASPECT = CFG.width / CFG.height


def _camera(fov=10.0, **kw):
    return Camera.create(look_from=(0.0, 0.0, 1.0),
                         look_at=(0.0, 0.0, -1.0), fov_deg=fov,
                         aspect=ASPECT, **kw)


def media():
    b = SceneBuilder()
    b.medium_sphere((0.0, 0.0, -1.0), 0.5, 2.0, (0.7, 0.5, 0.3))
    return b.build(), _camera(), "tex_color1", (0, 0)


def perlin():
    b = SceneBuilder()
    b.sphere((0.0, 0.0, -1.0), 0.5, b.lambertian(b.perlin(scale=4.0)))
    return b.build(), _camera(), "tex_scale", (0,)


def image_texture():
    b = SceneBuilder()
    ramp = np.linspace(0.2, 0.9, 8 * 16 * 3, dtype=np.float32).reshape(
        8, 16, 3)
    b.sphere((0.0, 0.0, -1.0), 0.5, b.lambertian(b.image(ramp)))
    return b.build(), _camera(), "bg_top", (1,)


def rotated_box():
    b = SceneBuilder()
    b.box((-3.0, -3.0, -2.5), (3.0, 3.0, -2.0),
          b.lambertian((0.6, 0.3, 0.2)), rotate_y_deg=30.0)
    scene = b.build()
    assert scene.has_rot_boxes
    return scene, _camera(fov=30.0), "tex_color1", (0, 1)


def moving_sphere():
    b = SceneBuilder()
    b.moving_sphere((0.0, 0.0, -1.0), (0.0, 0.05, -1.0), 0.0, 1.0, 0.5,
                    b.lambertian((0.6, 0.3, 0.2)))
    scene = b.build()
    assert scene.has_moving
    return scene, _camera(time0=0.0, time1=1.0), "sphere_dc", (0, 1)


def emissive_quad():
    b = SceneBuilder()
    b.solid_background((0.0, 0.0, 0.0))
    b.quad((-3.0, -3.0, -2.0), (6.0, 0.0, 0.0), (0.0, 6.0, 0.0),
           b.lambertian((0.5, 0.4, 0.3)))
    b.quad((-50.0, -50.0, 5.0), (100.0, 0.0, 0.0), (0.0, 100.0, 0.0),
           b.diffuse_light((4.0, 3.0, 2.0)))
    scene = b.build()
    assert scene.has_emissive
    return scene, _camera(fov=30.0), "tex_color1", (1, 0)


def russian_roulette():
    b = SceneBuilder()
    b.sphere((0.0, 0.0, -1.0), 0.5, b.lambertian((0.5, 0.4, 0.3)))
    b.sphere((0.0, -100.5, -1.0), 100.0, b.lambertian((0.5, 0.5, 0.5)))
    return b.build(), _camera(), "bg_top", (2,)


@pytest.mark.parametrize("build,cfg_kw,eps", [
    (media, {}, 1e-3),
    (perlin, {}, 1e-3),
    (image_texture, {}, 1e-3),
    (rotated_box, {}, 1e-3),
    # Geometry: more samples and a wider step average out the rare
    # discrete events a displaced surface triggers.
    (moving_sphere, {"spp": 32}, 1e-2),
    (emissive_quad, {}, 1e-3),
    (russian_roulette, {"rr_depth": 1, "max_depth": 6}, 1e-3),
], ids=["media", "perlin", "image_texture", "rotated_box", "moving_sphere",
        "emissive_quad", "russian_roulette"])
def test_grad_matches_finite_difference(build, cfg_kw, eps):
    scene, cam, field, index = build()
    cfg = dataclasses.replace(CFG, **cfg_kw)
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    params = partition(scene)

    def loss_at(delta):
        p = dict(params)
        p[field] = p[field].at[index].add(delta)
        return float(render_loss(p, cam, scene, target, cfg, 0, None))

    g = jax.grad(render_loss)(params, cam, scene, target, cfg, 0, None)
    auto = float(g[field][index])
    fd = (loss_at(eps) - loss_at(-eps)) / (2.0 * eps)
    assert np.isfinite(auto)
    assert auto != 0.0, f"{field}{index}: no gradient flowed"
    assert abs(auto - fd) <= 1e-5 + 0.1 * abs(fd), (
        f"{field}{index}: autodiff {auto:.6g} vs fd {fd:.6g}")
