"""Branchless batched material scatter, component-SoA form.

The reference dispatches `Material::scatter` through a vtable per ray
(reference: src/materials.rs:5-7). With only five material models, the
batched form computes *all* responses for the whole batch and selects by
material id — no divergence and no sort by material, at the cost of
evaluating five cheap models per ray.

Semantics mirror the books (and the reference where it has the material):
  lambertian  dir = n + unit_vector, degenerate -> n     (materials.rs:19-35)
  metal       dir = reflect(unit(d), n) + fuzz*in_sphere,
              absorbed if dir.n <= 0                     (materials.rs:44-61)
  dielectric  Schlick reflectance, TIR, stochastic
              reflect-vs-refract, attenuation = 1        (materials.rs:75-104)
  diffuse_light  emits tex(u,v,p), never scatters        (RTTNW ch. 7)
  isotropic   dir = in_unit_sphere                       (RTTNW ch. 9)

Scattered rays inherit the incoming ray's time (materials.rs:30,53,99) — the
caller keeps `time` unchanged across bounces.
"""

import dataclasses

import jax
import jax.numpy as jnp

from . import rng
from .scene import (MAT_DIELECTRIC, MAT_DIFFUSE_LIGHT, MAT_ISOTROPIC,
                    MAT_LAMBERTIAN, MAT_METAL, SceneArrays)
from .textures import texture_value
from .vec import V3


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Scatter:
    direction: V3  # new ray direction
    attenuation: V3
    emitted: V3
    scattered: jax.Array  # (N,) bool — False = absorbed / pure emitter


def _reflect(v: V3, n: V3) -> V3:
    return v - n * (2.0 * v.dot(n))


def _refract(unit_d: V3, n: V3, ratio) -> V3:
    """Snell refraction of a unit direction about unit normal n.

    Double-where keeps the sqrt gradient finite at the total-internal-
    reflection boundary (r_par_sq -> 0), where this branch is masked out
    by the caller anyway."""
    cos_theta = jnp.minimum(-unit_d.dot(n), 1.0)
    r_perp = (unit_d + n * cos_theta) * ratio
    r_par_sq = 1.0 - r_perp.norm_sq()
    ok = r_par_sq > 1e-12
    r_par_len = jnp.sqrt(jnp.where(ok, r_par_sq, 1.0)) * ok
    return r_perp - n * r_par_len


def _schlick(cosine, ref_idx):
    r0 = ((1.0 - ref_idx) / (1.0 + ref_idx)) ** 2
    return r0 + (1.0 - r0) * (1.0 - cosine) ** 5


def scatter(scene: SceneArrays, d_in: V3, hit, keys, bounce) -> Scatter:
    """Evaluate all material models for the batch and select by mat_id.

    d_in: incoming ray directions (unnormalized, like the reference).
    hit: geometry.Hit. keys: (N,2) sample key words; bounce: per-lane or
    scalar bounce counter for the draw stream."""
    n_rays = hit.mat_id.shape[0]
    mtype = scene.mat_type[hit.mat_id]  # (N,)
    albedo = texture_value(scene, scene.mat_tex[hit.mat_id], hit.u, hit.v,
                           hit.p)

    unit_rand, sphere_rand, u_choice = rng.scatter_draws(keys, bounce)

    normal = hit.normal

    # Lambertian.
    lam_dir = normal + unit_rand
    lam_degenerate = ((jnp.abs(lam_dir.x) < 1e-8)
                      & (jnp.abs(lam_dir.y) < 1e-8)
                      & (jnp.abs(lam_dir.z) < 1e-8))
    lam_dir = V3.where(lam_degenerate, normal, lam_dir)

    # Metal.
    unit_d = d_in.normalized()
    fuzz = scene.mat_fuzz[hit.mat_id]
    met_dir = _reflect(unit_d, normal) + sphere_rand * fuzz
    met_ok = met_dir.dot(normal) > 0.0

    # Dielectric.
    ior = scene.mat_ior[hit.mat_id]
    ratio = jnp.where(hit.front_face, 1.0 / ior, ior)
    cos_theta = jnp.minimum(-unit_d.dot(normal), 1.0)
    sin_theta = jnp.sqrt(jnp.maximum(1.0 - cos_theta * cos_theta, 0.0))
    cannot_refract = ratio * sin_theta > 1.0
    # The reflect-vs-refract *decision* is discrete: detach it so its
    # (measure-zero) boundary contributes no gradient — path-replay
    # detached sampling (SURVEY.md §7 design stance).
    reflect_choice = jax.lax.stop_gradient(
        cannot_refract | (_schlick(cos_theta, ratio) > u_choice))
    die_dir = V3.where(reflect_choice, _reflect(unit_d, normal),
                       _refract(unit_d, normal, ratio))

    is_lam = mtype == MAT_LAMBERTIAN
    is_met = mtype == MAT_METAL
    is_die = mtype == MAT_DIELECTRIC
    is_iso = mtype == MAT_ISOTROPIC

    direction = V3.where(is_lam, lam_dir,
                         V3.where(is_met, met_dir,
                                  V3.where(is_die, die_dir, sphere_rand)))
    ones = jnp.ones((n_rays,), jnp.float32)
    attenuation = V3.where(is_die, V3(ones, ones, ones), albedo)

    if scene.has_emissive:
        is_light = mtype == MAT_DIFFUSE_LIGHT
        zeros = jnp.zeros((n_rays,), jnp.float32)
        emitted = V3.where(is_light, albedo, V3(zeros, zeros, zeros))
    else:
        emitted = V3.zeros((n_rays,))

    scattered = jnp.where(is_met, met_ok, is_lam | is_die | is_iso)
    return Scatter(direction=direction, attenuation=attenuation,
                   emitted=emitted, scattered=scattered)
