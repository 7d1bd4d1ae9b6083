"""Differentiable rendering: parameter partitioning + training step.

The north star requires pixel gradients w.r.t. geometry (centers, radii),
materials (albedo/fuzz/ior) and camera parameters. The wavefront loop is
reverse-differentiable by construction (scan + per-bounce checkpoint in
render.trace_batch); this module handles the bookkeeping:

  * `partition` extracts the float leaves of SceneArrays as a grad-able
    params dict (integer id/valid tables stay frozen);
  * `make_train_step` builds a fwd+bwd step: render -> scalar loss ->
    grads -> SGD update, optionally sharded over a ("dp","sp") mesh, in
    which case parameter gradients are implicitly all-reduced by the
    shard_map transpose of the replicated in_specs (the "grad psum
    overlapped with replay" of SURVEY.md §2.2). A step whose backward
    residual would not fit the device runs as several sample chunks
    (`make_train_step_chunked`).

Discrete sampling decisions (argmin winners, dielectric branch, material
masks) are integer/boolean selects, so sampling is detached exactly as
path-replay backprop prescribes: gradients flow only through continuous
quantities.
"""

import dataclasses

import jax
import jax.numpy as jnp

from .camera import Camera
from .parallel.mesh import render_image_diff_sharded, render_image_sharded
from .render import (RenderConfig, diff_residual_bytes, render_image,
                     render_image_diff)
from .scene import SceneArrays

# Scene leaves that make sense to optimize (continuous scene parameters).
DIFFERENTIABLE_FIELDS = (
    "sphere_c0", "sphere_dc", "sphere_radius",
    "quad_q", "quad_u", "quad_v",
    "box_center", "box_half",
    "med_center", "med_radius", "med_half", "med_neg_inv_density",
    "mat_fuzz", "mat_ior",
    "tex_color1", "tex_color2", "tex_scale",
    "bg_bottom", "bg_top",
)

# Share of the device's memory limit the backward residual may take; the
# rest holds the per-tile working set of the forward and backward sweeps
# (the (rays x primitives) intersection temporaries), the gradients and
# the image.
RESIDUAL_SHARE = 0.5


def partition(scene: SceneArrays) -> dict:
    """Extract optimizable float leaves."""
    return {f: getattr(scene, f) for f in DIFFERENTIABLE_FIELDS}


def combine(scene: SceneArrays, params: dict) -> SceneArrays:
    return dataclasses.replace(scene, **params)


def render_loss(params: dict, camera: Camera, scene: SceneArrays,
                target, cfg: RenderConfig, seed, mesh=None):
    """MSE between a differentiable render and a target image."""
    s = combine(scene, params)
    if mesh is None:
        img, _ = render_image_diff(s, camera, cfg, seed)
    else:
        img, _ = render_image_diff_sharded(s, camera, cfg, seed, mesh)
    return jnp.mean((img - target) ** 2)


def residual_budget_bytes(devices=None) -> int | None:
    """Bytes one device may spend on the backward residual:
    RESIDUAL_SHARE of the smallest `memory_stats()["bytes_limit"]` among
    `devices` (default: the local devices). None when the backend reports
    no limit (the CPU), in which case no step is chunked for memory."""
    devices = jax.local_devices() if devices is None else devices
    limits = []
    for dev in devices:
        stats = dev.memory_stats()
        if not stats or "bytes_limit" not in stats:
            return None
        limits.append(stats["bytes_limit"])
    return int(min(limits) * RESIDUAL_SHARE)


def resolve_spp_chunk(cfg: RenderConfig, spp_chunk: int | None = None,
                      mesh=None, budget_bytes: int | None = None) -> int:
    """Samples per device call of the training step.

    A requested `spp_chunk` is used as given. Otherwise the chunk is the
    largest sample count whose backward residual on one device
    (render.diff_residual_bytes: carry bytes x (max_depth+1) x pixels x
    samples, per dp shard and sp rank) fits `budget_bytes` (default:
    residual_budget_bytes() of the mesh's devices); with no budget the
    whole spp is one chunk. Every chunk must divide cfg.spp into equal
    chunks and split evenly into samples_per_pass passes over the sp
    axis, so equal chunks share one compilation."""
    dp, sp = (1, 1) if mesh is None else (mesh.shape["dp"],
                                          mesh.shape["sp"])
    unit = cfg.samples_per_pass * sp

    def valid(c):
        return c > 0 and cfg.spp % c == 0 and c % unit == 0

    if spp_chunk:
        if not valid(spp_chunk):
            raise ValueError(
                f"spp_chunk={spp_chunk} must divide spp={cfg.spp} and be "
                f"a multiple of samples_per_pass*sp={unit}")
        return spp_chunk
    if budget_bytes is None:
        devices = None if mesh is None else list(mesh.devices.flat)
        budget_bytes = residual_budget_bytes(devices)
    candidates = [c for c in range(cfg.spp, 0, -1) if valid(c)]
    if not candidates:
        raise ValueError(f"spp={cfg.spp} has no chunk that is a multiple "
                         f"of samples_per_pass*sp={unit}")
    if budget_bytes is None:
        return candidates[0]
    for c in candidates:
        if diff_residual_bytes(cfg, c // sp, dp) <= budget_bytes:
            return c
    raise ValueError(
        f"even a {candidates[-1]}-sample chunk needs "
        f"{diff_residual_bytes(cfg, candidates[-1] // sp, dp) / 1e9:.1f} "
        f"GB of backward residual per device at {cfg.width}x{cfg.height}"
        f" (dp={dp}), over the {budget_bytes / 1e9:.1f} GB budget")


def loss_and_grad_chunked(cfg: RenderConfig, spp_chunk: int | None = None,
                          mesh=None):
    """MSE loss and its gradient, executed as one device call per sample
    chunk, so that the backward residual of one chunk, not of the whole
    spp, must fit the device. Single-device or sharded over a
    ("dp","sp") mesh.

    The image is LINEAR in per-chunk radiance, so the result is exact:

      pass 1  forward every chunk (no residuals kept) -> image;
      pass 2  loss + d(loss)/d(image) (tiny jit);
      pass 3  one jax.vjp per chunk seeded with the image cotangent;
              gradients accumulate.

    The chunk's sample offset is a traced argument, so every chunk runs
    the same two compiled programs. Numerically the one-shot gradient
    (same (pixel, sample)-global keys; f32 accumulation order differs).

    Returns fn(scene, camera, target, seed) ->
        (loss, (param grads, camera grads)), with fn.spp_chunk set.
    """
    chunk = resolve_spp_chunk(cfg, spp_chunk, mesh=mesh)
    passes = chunk // cfg.samples_per_pass
    n_chunks = cfg.spp // chunk

    def chunk_image(scene, camera, seed, pass_start, differentiable):
        # Mean radiance over the chunk's samples.
        if mesh is None:
            img, _ = render_image(scene, camera, cfg, seed,
                                  differentiable=differentiable,
                                  pass_start=pass_start, n_passes=passes)
        else:
            img, _ = render_image_sharded(
                scene, camera, cfg, seed, mesh,
                differentiable=differentiable, pass_start=pass_start,
                n_passes=passes)
        return img

    @jax.jit
    def fwd_chunk(scene, camera, seed, pass_start):
        return chunk_image(scene, camera, seed, pass_start, False)

    @jax.jit
    def bwd_chunk(scene, params, camera, seed, pass_start, cot):
        def img_of(p, c):
            return chunk_image(combine(scene, p), c, seed, pass_start,
                               True)
        _, vjp = jax.vjp(img_of, params, camera)
        return vjp(cot)

    @jax.jit
    def loss_and_cot(img, target):
        return jax.value_and_grad(
            lambda im: jnp.mean((im - target) ** 2))(img)

    def fn(scene: SceneArrays, camera: Camera, target, seed):
        seed = jnp.asarray(seed)
        params = partition(scene)
        starts = [jnp.int32(i * passes) for i in range(n_chunks)]
        img = fwd_chunk(scene, camera, seed, starts[0])
        for s in starts[1:]:
            img = img + fwd_chunk(scene, camera, seed, s)
        loss, cot = loss_and_cot(img / n_chunks, target)
        cot = cot / n_chunks
        gp, gc = bwd_chunk(scene, params, camera, seed, starts[0], cot)
        for s in starts[1:]:
            dgp, dgc = bwd_chunk(scene, params, camera, seed, s, cot)
            gp = jax.tree.map(jnp.add, gp, dgp)
            gc = jax.tree.map(jnp.add, gc, dgc)
        return loss, (gp, gc)

    fn.spp_chunk = chunk
    return fn


def make_train_step_chunked(cfg: RenderConfig, lr: float = 1e-2,
                            spp_chunk: int | None = None, mesh=None):
    """Full-spp MSE training step built on loss_and_grad_chunked: the
    one-shot step's update in one device call per sample chunk.

    Returns step(scene, camera, target, seed) -> (scene', camera', loss),
    with step.spp_chunk set."""
    grad_fn = loss_and_grad_chunked(cfg, spp_chunk, mesh)

    @jax.jit
    def apply_sgd(params, camera, gp, gc):
        new_p = jax.tree.map(lambda p, g: p - lr * g, params, gp)
        new_c = jax.tree.map(lambda p, g: p - lr * g, camera, gc)
        return new_p, new_c

    def step(scene: SceneArrays, camera: Camera, target, seed):
        loss, (gp, gc) = grad_fn(scene, camera, target, seed)
        new_params, new_camera = apply_sgd(partition(scene), camera, gp,
                                           gc)
        return combine(scene, new_params), new_camera, loss

    step.spp_chunk = grad_fn.spp_chunk
    return step


def make_train_step(cfg: RenderConfig, mesh=None, lr: float = 1e-2):
    """Full training step: fwd render + bwd replay + SGD update.

    One jitted device call when the backward residual of the whole spp
    fits the device's budget (resolve_spp_chunk); otherwise the chunked
    step (make_train_step_chunked), which gives the same update in
    several device calls.

    Returns step(scene, camera, target, seed) ->
        (scene', camera', loss).
    """
    chunk = resolve_spp_chunk(cfg, mesh=mesh)
    if chunk < cfg.spp:
        return make_train_step_chunked(cfg, lr=lr, spp_chunk=chunk,
                                       mesh=mesh)
    return _make_train_step_oneshot(cfg, mesh, lr)


def _make_train_step_oneshot(cfg: RenderConfig, mesh, lr: float):

    def step(scene: SceneArrays, camera: Camera, target, seed):
        params = partition(scene)
        loss, (gp, gc) = jax.value_and_grad(render_loss,
                                            argnums=(0, 1))(
            params, camera, scene, target, cfg, seed, mesh)
        new_params = jax.tree.map(lambda p, g: p - lr * g, params, gp)
        new_camera = jax.tree.map(lambda p, g: p - lr * g, camera, gc)
        return combine(scene, new_params), new_camera, loss

    return jax.jit(step)
