"""Batched texture evaluation: solid / checker / perlin-marble / image.

The reference has no textures (gap inventory, SURVEY.md §2.4); semantics
follow RTTNW chs. 4-6. Evaluation is a branchless select over texture type
for a whole ray batch in component-SoA form; Perlin noise uses the book's
gradient-lattice scheme with permutation tables as device arrays (8 small
gathers per batch — only paid when a scene actually samples noise).
"""

import jax
import jax.numpy as jnp

from .scene import TEX_CHECKER, TEX_PERLIN, TEX_SOLID, SceneArrays
from .vec import V3


def _lattice_grad(ix, iy, iz):
    """Gradient vector at an integer lattice point from a computational
    hash — the replacement for the book's permutation/gradient tables
    (RTTNW ch. 5), whose lookups would be 56 per-lane gathers per bounce
    at 7 octaves; this is pure elementwise u32 arithmetic. Same
    statistical construction: pseudo-random unit-ish
    gradient per lattice point, fully deterministic."""
    h = (ix.astype(jnp.uint32) * jnp.uint32(0x8DA6B343)
         + iy.astype(jnp.uint32) * jnp.uint32(0xD8163841)
         + iz.astype(jnp.uint32) * jnp.uint32(0xCB1AB31F))
    h = h ^ (h >> jnp.uint32(13))
    h = h * jnp.uint32(0x85EBCA6B)
    h = h ^ (h >> jnp.uint32(16))
    # Three 10-bit fields -> components in [-1, 1).
    scale = jnp.float32(2.0 / 1024.0)
    gx = (h & jnp.uint32(1023)).astype(jnp.int32).astype(
        jnp.float32) * scale - 1.0
    gy = ((h >> jnp.uint32(10)) & jnp.uint32(1023)).astype(
        jnp.int32).astype(jnp.float32) * scale - 1.0
    gz = ((h >> jnp.uint32(20)) & jnp.uint32(1023)).astype(
        jnp.int32).astype(jnp.float32) * scale - 1.0
    inv = jax.lax.rsqrt(jnp.maximum(gx * gx + gy * gy + gz * gz, 1e-6))
    return gx * inv, gy * inv, gz * inv


def perlin_noise(scene: SceneArrays, p: V3):
    """Gradient-lattice noise in [-1,1], shape (N,). RTTNW ch. 5 scheme
    (hermite-smoothed trilinear interpolation of corner-gradient dots),
    with hashed gradients instead of table lookups."""
    fx, fy, fz = jnp.floor(p.x), jnp.floor(p.y), jnp.floor(p.z)
    ux, uy, uz = p.x - fx, p.y - fy, p.z - fz
    i = fx.astype(jnp.int32)
    j = fy.astype(jnp.int32)
    k = fz.astype(jnp.int32)
    sx = ux * ux * (3.0 - 2.0 * ux)
    sy = uy * uy * (3.0 - 2.0 * uy)
    sz = uz * uz * (3.0 - 2.0 * uz)

    acc = jnp.zeros_like(p.x)
    for di in range(2):
        for dj in range(2):
            for dk in range(2):
                gx, gy, gz = _lattice_grad(i + di, j + dj, k + dk)
                dotv = (gx * (ux - di) + gy * (uy - dj)
                        + gz * (uz - dk))
                w = ((sx if di else 1.0 - sx) * (sy if dj else 1.0 - sy)
                     * (sz if dk else 1.0 - sz))
                acc = acc + w * dotv
    return acc


def perlin_turb(scene: SceneArrays, p: V3, depth: int = 7):
    """Turbulence: sum of |noise| octaves (RTTNW ch. 5.6)."""
    acc = jnp.zeros_like(p.x)
    temp = p
    weight = 1.0
    for _ in range(depth):
        acc = acc + weight * jnp.abs(perlin_noise(scene, temp))
        temp = temp * 2.0
        weight = weight * 0.5
    return acc


def texture_value(scene: SceneArrays, tex_id, u, v, p: V3) -> V3:
    """Evaluate texture tex_id (N,) at surface uv and point p -> V3."""
    ttype = scene.tex_type[tex_id]
    c1 = V3.from_array(scene.tex_color1).gather(tex_id)
    c2 = V3.from_array(scene.tex_color2).gather(tex_id)
    scale = scene.tex_scale[tex_id]

    # Checker (RTTNW ch. 4.3 sine form).
    s = (jnp.sin(scale * p.x) * jnp.sin(scale * p.y)
         * jnp.sin(scale * p.z))
    checker = V3.where(s < 0.0, c2, c1)

    # Marble (RTTNW ch. 5.7): modulate phase with turbulence. Only emitted
    # into the graph when the scene statically contains a perlin texture.
    if scene.has_perlin:
        turb = perlin_turb(scene, p)
        marble = c1 * (0.5 * (1.0 + jnp.sin(scale * p.z + 10.0 * turb)))
    else:
        marble = c1

    # Image texture: nearest lookup into the shared atlas.
    if scene.has_images:
        img_idx = jnp.maximum(scene.tex_image[tex_id], 0)
        n_img, ah, aw = (scene.images.shape[0], scene.images.shape[1],
                         scene.images.shape[2])
        uc = jnp.clip(u, 0.0, 1.0)
        vc = 1.0 - jnp.clip(v, 0.0, 1.0)
        xi = jnp.clip((uc * aw).astype(jnp.int32), 0, aw - 1)
        yi = jnp.clip((vc * ah).astype(jnp.int32), 0, ah - 1)
        flat = scene.images.reshape(-1, 3)
        lin = (jnp.clip(img_idx, 0, n_img - 1) * ah + yi) * aw + xi
        image = V3(flat[lin, 0], flat[lin, 1], flat[lin, 2])
    else:
        image = c1

    out = V3.where(ttype == TEX_SOLID, c1,
                   V3.where(ttype == TEX_CHECKER, checker,
                            V3.where(ttype == TEX_PERLIN, marble, image)))
    return out
