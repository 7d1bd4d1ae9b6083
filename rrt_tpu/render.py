"""Wavefront render core.

The reference's hot path is a per-pixel recursive `trace` to depth 50 with a
BVH walk inside (reference: src/lib.rs:50-71, 96-103). Here the recursion
inverts into an *iterative bounce loop over a megabatch of rays* in
component-SoA layout (rrt_tpu.vec), the wavefront design of Laine, Karras &
Aila ("Megakernels Considered Harmful", HPG 2013). Two drivers share the
physics:

1. `trace_batch` — fixed ray batch, `lax.while_loop` (forward) or
   `lax.scan` + `jax.checkpoint` (reverse-differentiable with per-bounce
   rematerialization: the O(1)-in-depth memory of path-replay backprop,
   SURVEY.md §5.7).

2. `trace_queue` — the fast forward path: a persistent ray queue with
   stream compaction by *refill*. Dead lanes are re-issued with fresh
   (pixel, sample) camera rays so occupancy stays high instead of decaying
   with the alive fraction (SURVEY.md §7 "hard parts" #3). Refill (and its
   cumsum + pixel scatter-add) runs once every `bounces_per_refill` bounce
   steps to amortize the two O(Q) structural ops.

Because every random draw is keyed by (seed, pixel, sample, bounce)
(rrt_tpu.rng), both drivers produce the *identical* per-sample radiance for
any queue size, tile shape or batching; images differ only by f32 summation
order. Discrete decisions (argmin winner, front-face, dielectric branch,
metal absorption) are integer/boolean selects, so sampling is detached by
construction.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from . import rng
from .camera import Camera, generate_rays
from .geometry import INF, intersect_all, make_hit
from .materials import scatter
from .scene import BG_SKY, SceneArrays
from .utils.vma import vary_for_mesh
from .vec import V3


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 400
    height: int = 225
    spp: int = 32
    max_depth: int = 50
    # Queue renderer: in-flight rays (bounds the (Q, S) working set) and
    # bounce steps between compaction/refill passes.
    queue_size: int = 131072
    bounces_per_refill: int = 4
    # Batch renderer (differentiable path): rays per traced batch =
    # tile_pixels * samples_per_pass.
    tile_pixels: int = 16384
    samples_per_pass: int = 4
    t_min: float = 1.0e-3
    # Russian roulette: past this bounce, continue with probability
    # p = clamp(max throughput component, 0.05, 1) and divide the
    # survivor's throughput by p (unbiased; shortens the depth-50
    # straggler tail). 0 = off (the books' method and the default —
    # golden comparisons use exact depth-termination; rr changes the
    # estimator's variance, not its mean). Honored by every driver,
    # including the differentiable path: the kill decision replays like
    # other discrete decisions and the 1/p weight is detached, so
    # scene/camera gradients stay in the same detached-sampling class as
    # reflect-vs-refract.
    rr_depth: int = 0


# Bytes of trace_batch's loop carry per ray: o, d, time, throughput and
# radiance (13 f32) plus the alive flag. The differentiable scan keeps
# one carry per bounce as its residual (diff_residual_bytes).
CARRY_BYTES_PER_RAY = 13 * 4 + 1


def background_color(scene: SceneArrays, d: V3) -> V3:
    """Miss shader: the RTIOW vertical sky lerp (reference src/lib.rs:66-70)
    or a solid color for emissive scenes."""
    unit_y = d.y * jax.lax.rsqrt(jnp.maximum(d.norm_sq(), 1e-20))
    t = 0.5 * (unit_y + 1.0)
    is_sky = scene.bg_mode == BG_SKY
    bot = scene.bg_bottom
    top = scene.bg_top
    return V3(
        jnp.where(is_sky, (1.0 - t) * bot[0] + t * top[0], bot[0]),
        jnp.where(is_sky, (1.0 - t) * bot[1] + t * top[1], bot[1]),
        jnp.where(is_sky, (1.0 - t) * bot[2] + t * top[2], bot[2]))


def _shade(scene: SceneArrays, o: V3, d: V3, time, keys, bounce, alive,
           t_min, max_depth):
    """One physics step for a ray set: intersect, shade, scatter.

    bounce may be a scalar (batch driver) or per-lane array (queue driver).
    Returns (contribution V3 — radiance to bank this step, scaled by
    throughput by the caller — new_o, new_d, attenuation V3, survives).
    """
    n = o.x.shape[0]
    if scene.has_media:
        u_med = rng.medium_draws(keys, bounce, scene.n_media_active)
    else:
        u_med = None

    t_min_v = jnp.full((n,), t_min, jnp.float32)
    t_max_v = jnp.full((n,), INF, jnp.float32)
    t, fam, idx, hit_mask = intersect_all(scene, o, d, time, t_min_v,
                                          t_max_v, u_med)
    hit_mask = hit_mask & alive
    miss_mask = alive & ~hit_mask

    hit = make_hit(scene, o, d, time, t, fam, idx)
    sc = scatter(scene, d, hit, keys, bounce)

    contribution = background_color(scene, d) * miss_mask
    if scene.has_emissive:
        contribution = contribution + sc.emitted * hit_mask

    # The reference kills rays that hit at depth >= 50 *before* scattering
    # (src/lib.rs:58-60); misses at that depth still see the sky.
    survives = hit_mask & sc.scattered & (bounce < max_depth)
    new_o = V3.where(survives, hit.p, o)
    new_d = V3.where(survives, sc.direction, d)
    return contribution, new_o, new_d, sc.attenuation, survives


def _apply_rr(keys, bounce, throughput, attenuation, survives,
              rr_depth: int):
    """Unbiased Russian roulette, shared by every driver. Past rr_depth
    bounces a surviving lane continues with p = clamp(max
    post-attenuation throughput component, 0.05, 1) and the survivor's
    throughput is divided by p. Returns (new throughput, new survives)."""
    t_new = throughput * attenuation
    if not rr_depth:
        return V3.where(survives, t_new, throughput), survives
    p = jnp.clip(jnp.maximum(t_new.x, jnp.maximum(t_new.y, t_new.z)),
                 0.05, 1.0)
    u = rng.rr_draw(keys, bounce)
    rr_on = jnp.asarray(bounce) >= rr_depth
    survives = survives & ((~rr_on) | (u < p))
    # The 1/p weight is DETACHED: like the discrete decisions, the RR
    # acceptance probability is a replayed sampling constant under
    # differentiation (stop_gradient is the identity on the primal, so
    # forward renders are unchanged). Keeps the differentiable path's
    # estimator in the same detached-sampling class as
    # reflect-vs-refract (SURVEY.md §7).
    inv_p = jnp.where(rr_on, 1.0 / jax.lax.stop_gradient(p), 1.0)
    return V3.where(survives, t_new * inv_p, throughput), survives


def _bounce_body(scene, t_min, keys, carry, bounce, max_depth,
                 rr_depth: int = 0):
    o, d, time, throughput, radiance, alive, n_traced = carry
    contribution, new_o, new_d, attenuation, survives = _shade(
        scene, o, d, time, keys, bounce, alive, t_min, max_depth)
    radiance = radiance + throughput * contribution
    throughput, survives = _apply_rr(keys, bounce, throughput,
                                     attenuation, survives, rr_depth)
    n_traced = n_traced + jnp.sum(alive.astype(jnp.float32))
    return (new_o, new_d, time, throughput, radiance, survives, n_traced)


def trace_batch(scene: SceneArrays, o: V3, d: V3, time, keys,
                max_depth: int, t_min: float, differentiable: bool,
                rr_depth: int = 0):
    """Trace a fixed ray batch to completion.

    keys: (N,2) per-lane sample key words (rng.sample_keys).
    rr_depth: Russian roulette (see RenderConfig.rr_depth); the
    differentiable scan honors it too.
    Returns (radiance V3, n_traced ())."""
    n = o.x.shape[0]
    # vary_for_mesh: under a shard_map the freshly created carry
    # constants are device-invariant while the body output is varying
    # (it mixes in dp/sp-varying rays); casting the init to varying
    # satisfies the static vma verifier and is a no-op single-device
    # (utils/vma.py).
    carry0 = vary_for_mesh(
        (o, d, time,
         V3.ones((n,)),  # throughput
         V3.zeros((n,)),  # radiance
         jnp.ones((n,), bool),  # alive
         jnp.zeros((), jnp.float32)))  # rays traced (f32: metric only)

    body = partial(_bounce_body, scene, t_min, keys, max_depth=max_depth,
                   rr_depth=rr_depth)

    if differentiable:
        ckpt_body = jax.checkpoint(lambda c, b: body(c, b))

        def scan_step(carry, bounce):
            return ckpt_body(carry, bounce), None

        carry, _ = jax.lax.scan(scan_step, carry0,
                                jnp.arange(max_depth + 1))
    else:
        def cond(state):
            bounce, carry = state
            return (bounce <= max_depth) & jnp.any(carry[5])

        def step(state):
            bounce, carry = state
            return bounce + 1, body(carry, bounce)

        _, carry = jax.lax.while_loop(
            cond, step,
            (vary_for_mesh(jnp.zeros((), jnp.int32)), carry0))
    return carry[4], carry[6]


# ---------------------------------------------------------------------------
# Queue-compaction forward renderer
# ---------------------------------------------------------------------------
#
# Queue state, f32 (16, Q):
#   0-2 o | 3-5 d | 6 time | 7-9 throughput | 10-12 pending radiance
#   | 13 bounce | 14 alive | 15 per-lane traced-ray count
# Keys: (2, Q) uint32 sample key words.


def pack_state(o, d, time, thr, pend, bounce, alive, traced):
    """V3 components + scalars -> (16, Q) queue state matrix."""
    return jnp.stack([
        o.x, o.y, o.z, d.x, d.y, d.z, time,
        thr.x, thr.y, thr.z, pend.x, pend.y, pend.z,
        bounce.astype(jnp.float32), alive.astype(jnp.float32),
        traced], axis=0)


def unpack_state(st):
    """(16, Q) queue state matrix -> the pack_state components."""
    o = V3(st[0], st[1], st[2])
    d = V3(st[3], st[4], st[5])
    time = st[6]
    thr = V3(st[7], st[8], st[9])
    pend = V3(st[10], st[11], st[12])
    bounce = st[13].astype(jnp.int32)
    alive = st[14] > 0.5
    traced = st[15]
    return o, d, time, thr, pend, bounce, alive, traced


def trace_queue(scene: SceneArrays, camera: Camera, px, py,
                cfg: RenderConfig, seed_key, sample_lo, sample_hi,
                queue_size: int | None = None):
    """Render samples [sample_lo, sample_hi) of the given pixels with a
    persistent compacted ray queue.

    px, py: (P,) pixel coordinates. Sample ids are enumerated sample-major
    (all pixels at sample s, then s+1, ...) so fresh camera rays in a
    refill are spatially coherent. sample_lo/sample_hi may be traced
    (progressive chunks then share one compilation) or Python ints (the
    queue is then capped at the total sample count).

    State lives in one packed (16, Q) matrix (pack_state), so the
    refill/flush pass is a handful of fused ops: one cumsum, one
    threefry, the camera math, a single (16, Q) select, and one batched
    (3, P) scatter-add.

    Returns (radiance_sum (P,3) — sum over samples — and n_traced).
    """
    p_count = px.shape[0]
    q = queue_size or cfg.queue_size
    if isinstance(sample_hi, int) and isinstance(sample_lo, int):
        q = min(q, p_count * (sample_hi - sample_lo))
    pixel_gid = (py * cfg.width + px).astype(jnp.uint32)
    total = p_count * (sample_hi - sample_lo)
    k_steps = max(1, cfg.bounces_per_refill)

    ones_q = jnp.ones((q,), jnp.float32)
    zeros_q = jnp.zeros((q,), jnp.float32)

    def flush_refill(state):
        st, keys, pix, next_s, acc = state
        alive = st[14] > 0.5
        dead = ~alive
        ranks = jnp.cumsum(dead.astype(jnp.int32)) - 1
        sidx = next_s + ranks
        issue = dead & (sidx < total)
        sidx_c = jnp.minimum(sidx, total - 1)
        p_new = (sidx_c % p_count).astype(jnp.int32)
        s_new = (sidx_c // p_count).astype(jnp.uint32) + jnp.asarray(
            sample_lo, jnp.uint32)

        # Flush finished samples' pending radiance (rows 10-12) into the
        # (3, P) accumulator with one batched scatter-add.
        fmask = issue.astype(jnp.float32)
        acc = V3(acc.x.at[pix].add(st[10] * fmask, mode="drop"),
                 acc.y.at[pix].add(st[11] * fmask, mode="drop"),
                 acc.z.at[pix].add(st[12] * fmask, mode="drop"))

        new_keys = rng.sample_keys(seed_key, pixel_gid[p_new], s_new)
        o_new, d_new, tm_new = generate_rays(
            camera, px[p_new], py[p_new], cfg.width, cfg.height, new_keys)

        fresh = jnp.stack([
            o_new.x, o_new.y, o_new.z, d_new.x, d_new.y, d_new.z, tm_new,
            ones_q, ones_q, ones_q,  # throughput
            zeros_q, zeros_q, zeros_q,  # pending radiance
            zeros_q,  # bounce
            ones_q,  # alive
            st[15]], axis=0)  # traced count carries over
        st = jnp.where(issue[None, :], fresh, st)
        keys = jnp.where(issue[None, :], new_keys, keys)
        pix = jnp.where(issue, p_new, pix)
        next_s = next_s + jnp.sum(issue.astype(jnp.int32))
        return st, keys, pix, next_s, acc

    def bounce_step(_, state):
        st, keys, pix, next_s, acc = state
        (o, d, tm, thr, pend, bounce, alive,
         traced) = unpack_state(st)
        contribution, new_o, new_d, attenuation, survives = _shade(
            scene, o, d, tm, keys, bounce, alive, cfg.t_min, cfg.max_depth)
        pend = pend + thr * contribution
        thr, survives = _apply_rr(keys, bounce, thr, attenuation,
                                  survives, cfg.rr_depth)
        bounce = bounce + survives.astype(jnp.int32)
        traced = traced + alive.astype(jnp.float32)
        st = pack_state(new_o, new_d, tm, thr, pend, bounce, survives,
                        traced)
        return st, keys, pix, next_s, acc

    def outer(state):
        state = flush_refill(state)
        return jax.lax.fori_loop(0, k_steps, bounce_step, state)

    def cond(state):
        st, _, _, next_s, _ = state
        return (next_s < total) | jnp.any(st[14] > 0.5)

    dummy_keys = rng.sample_keys(seed_key, jnp.zeros((q,), jnp.uint32), 0)
    st0 = jnp.zeros((16, q), jnp.float32)
    st0 = st0.at[3:6].set(1.0)  # non-degenerate direction
    # vary_for_mesh: see trace_batch — carry init must match the
    # body's varying vma type under shard_map (no-op single-device).
    state0 = vary_for_mesh(
        (st0, dummy_keys,
         jnp.zeros((q,), jnp.int32),  # pixel index in tile
         jnp.zeros((), jnp.int32),  # next sample cursor
         V3.zeros((p_count,))))  # accumulator

    st, keys, pix, next_s, acc = jax.lax.while_loop(cond, outer, state0)
    # Final flush: lanes that finished after the cursor was exhausted were
    # never refilled, so their pending radiance is still lane-resident.
    acc = V3(acc.x.at[pix].add(st[10], mode="drop"),
             acc.y.at[pix].add(st[11], mode="drop"),
             acc.z.at[pix].add(st[12], mode="drop"))
    return jnp.stack([acc.x, acc.y, acc.z], axis=-1), jnp.sum(st[15])


# ---------------------------------------------------------------------------
# Image assembly
# ---------------------------------------------------------------------------


def render_tile(scene: SceneArrays, camera: Camera, px, py,
                cfg: RenderConfig, seed_key, pass_start, n_passes: int,
                differentiable: bool = False):
    """Render one tile of pixels with `n_passes` sample passes through the
    batch driver (the differentiable path).

    Pass i covers samples [(pass_start+i)*spc, ...+spc); pass_start may be
    traced. Returns (radiance_sum (P,3) — sum over the rendered samples —
    and n_traced).
    """
    p_count = px.shape[0]
    spc = cfg.samples_per_pass
    pxr = jnp.tile(px, spc)
    pyr = jnp.tile(py, spc)
    gid = (pyr * cfg.width + pxr).astype(jnp.uint32)
    replica = jnp.repeat(jnp.arange(spc, dtype=jnp.uint32), p_count)
    pass0 = jnp.asarray(pass_start).astype(jnp.uint32)

    def body(pass_i, acc):
        acc_rad, acc_n = acc
        samp = (pass0 + pass_i.astype(jnp.uint32)) * jnp.uint32(spc) \
            + replica
        keys = rng.sample_keys(seed_key, gid, samp)
        o, d, tm = generate_rays(camera, pxr, pyr, cfg.width, cfg.height,
                                 keys)
        radiance, n_traced = trace_batch(scene, o, d, tm, keys,
                                         cfg.max_depth, cfg.t_min,
                                         differentiable,
                                         rr_depth=cfg.rr_depth)
        rad = jnp.stack([radiance.x, radiance.y, radiance.z], axis=-1)
        rad = jnp.sum(rad.reshape(spc, p_count, 3), axis=0)
        return acc_rad + rad, acc_n + n_traced

    # Static trip count: fori_loop lowers to a scan, so the pass loop is
    # reverse-differentiable without unrolling the passes in the trace.
    # vary_for_mesh: see trace_batch — accumulator init must match the
    # body's varying vma type under shard_map (no-op single-device).
    return jax.lax.fori_loop(
        0, n_passes, body,
        vary_for_mesh((jnp.zeros((p_count, 3), jnp.float32),
                       jnp.zeros((), jnp.float32))))


def tile_grid(cfg: RenderConfig, multiple_of: int = 1):
    """Flat pixel ids split into fixed-size tiles, the tile count padded
    to a multiple of `multiple_of` (padding repeats the last pixel and is
    cropped at assembly). Returns (px, py, n_tiles, tile_pixels)."""
    n_pix = cfg.width * cfg.height
    tp = min(cfg.tile_pixels, n_pix)
    n_tiles = -(-n_pix // tp)
    n_tiles = -(-n_tiles // multiple_of) * multiple_of
    ids = jnp.minimum(jnp.arange(n_tiles * tp, dtype=jnp.int32), n_pix - 1)
    px = (ids % cfg.width).reshape(n_tiles, tp)
    py = (ids // cfg.width).reshape(n_tiles, tp)
    return px, py, n_tiles, tp


def diff_residual_bytes(cfg: RenderConfig, n_samples: int,
                        dp: int = 1) -> int:
    """Bytes the differentiable scan keeps for its backward pass when it
    renders `n_samples` samples of every pixel of one dp shard: one loop
    carry per ray per bounce (trace_batch's per-bounce checkpoint)."""
    _, _, n_tiles, tp = tile_grid(cfg, dp)
    rays = n_tiles // dp * tp * n_samples
    return CARRY_BYTES_PER_RAY * (cfg.max_depth + 1) * rays


def _as_key(seed):
    if jnp.issubdtype(jnp.asarray(seed).dtype, jnp.integer):
        return jax.random.key(seed)
    return seed


def _check_passes(cfg: RenderConfig):
    if cfg.spp % cfg.samples_per_pass != 0:
        raise ValueError("spp must be a multiple of samples_per_pass")
    return cfg.spp // cfg.samples_per_pass


@partial(jax.jit, static_argnames=("cfg", "differentiable", "n_passes"))
def render_image(scene: SceneArrays, camera: Camera, cfg: RenderConfig,
                 seed, differentiable: bool = False, pass_start=0,
                 n_passes: int | None = None):
    """Render the full image on the local device via the batch driver.

    pass_start/n_passes select a sample sub-range (samples
    [pass_start*spc, (pass_start+n_passes)*spc)) for progressive /
    resumed rendering and the chunked trainer; pass_start is traced, so
    every sub-range of one size shares a compilation. The default covers
    all cfg.spp samples.
    Returns (image (H,W,3) float mean radiance over the rendered
    samples, n_traced). Forward-only rendering is faster through
    `render_image_queue`; multi-device rendering lives in parallel.mesh.
    """
    all_passes = _check_passes(cfg)
    seed_key = _as_key(seed)
    px, py, n_tiles, tp = tile_grid(cfg)
    if n_passes is None:
        n_passes = all_passes

    def do_tile(tile_id):
        return render_tile(scene, camera, px[tile_id], py[tile_id], cfg,
                           seed_key, pass_start, n_passes,
                           differentiable=differentiable)

    rad, n_traced = jax.lax.map(do_tile, jnp.arange(n_tiles,
                                                    dtype=jnp.int32))
    rad = rad.reshape(n_tiles * tp, 3)[: cfg.width * cfg.height]
    image = rad.reshape(cfg.height, cfg.width, 3) / jnp.float32(
        n_passes * cfg.samples_per_pass)
    return image, jnp.sum(n_traced)


@partial(jax.jit, static_argnames=("cfg",))
def render_image_queue(scene: SceneArrays, camera: Camera,
                       cfg: RenderConfig, seed):
    """Render the full image with the compacted-queue driver (forward
    only). Per-sample radiance identical to render_image; pixel sums
    differ only by f32 accumulation order."""
    seed_key = _as_key(seed)
    n_pix = cfg.width * cfg.height
    ids = jnp.arange(n_pix, dtype=jnp.int32)
    px = ids % cfg.width
    py = ids // cfg.width
    rad, n_traced = trace_queue(scene, camera, px, py, cfg, seed_key,
                                0, cfg.spp)
    image = rad.reshape(cfg.height, cfg.width, 3) / jnp.float32(cfg.spp)
    return image, n_traced


def render_image_diff(scene: SceneArrays, camera: Camera,
                      cfg: RenderConfig, seed):
    """Differentiable full-image render: the batch driver's
    per-bounce-checkpointed scan. Returns (image (H,W,3) mean radiance,
    n_traced)."""
    return render_image(scene, camera, cfg, seed, differentiable=True)


def tonemap(image):
    """Gamma-2.0 to RGB8, saturating like the reference's `as u8`
    (src/lib.rs:104-108)."""
    c = jnp.sqrt(jnp.maximum(image, 0.0)) * 255.99
    return jnp.clip(c, 0.0, 255.0).astype(jnp.uint8)
