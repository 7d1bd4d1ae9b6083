"""Counter-based, stateless random sampling for the wavefront renderer.

Design (vector-machine-first, intentionally different from the reference):

The reference threads a mutable xoshiro128+ generator through every thread
via an unsafe thread-local (reference: src/rng.rs:14, src/threadpool.rs:6-24)
and draws vectors by *rejection sampling* loops (src/rng.rs:32-55). Neither
pattern maps to a lockstep vector machine: mutable per-lane state serializes,
and rejection loops have data-dependent trip counts.

Here every draw is a pure function of (seed, pixel_id, sample_id, bounce,
stream): the radiance of any (pixel, sample) is independent of tile shape,
batch size, queue compaction order, or mesh layout — strictly stronger
determinism than the reference, whose output changes with thread count
(SURVEY.md §1). It is also the recovery/checkpoint story: any subset of
samples can be re-rendered in isolation (SURVEY.md §5.3/5.4).

Implementation note: draws use a hand-vectorized Threefry-2x32 over raw
(N, 2) uint32 key words rather than per-lane `jax.vmap(jax.random.*)`,
whose per-lane key plumbing defeats vectorization; the direct counter
hash below is pure elementwise u32 work (~200 ops per lane). Same
construction as jax.random's threefry — counters in, iid words out.

Rejection sampling is replaced with closed-form equal-distribution samplers:

  * unit vector        = gaussian / ||gaussian||  (Box-Muller)
  * in unit sphere     = unit vector * cbrt(U)
  * in unit disc       = sqrt(U) * (cos 2πV, sin 2πV)
"""

import jax
import jax.numpy as jnp

from .vec import V3

# Stream ids: every distinct consumer of randomness inside one bounce gets
# its own stream (the bounce/stream counter is bounce * 8 + stream).
STREAM_CAMERA = 0  # pixel jitter (2) + lens disc (2) + shutter time (1)
STREAM_SCATTER = 1  # lambertian/metal/isotropic dirs + dielectric choice
STREAM_MEDIUM = 2  # constant-medium distance sampling
STREAM_RR = 3  # (reserved) russian roulette

_NUM_STREAMS = 8

_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_PARITY = 0x1BD11BDA  # python int: jnp constants may not be captured by kernels


def _rotl(x, r):
    return (x << r) | (x >> (32 - r))


def threefry2x32(k0, k1, c0, c1):
    """Vectorized Threefry-2x32 (20 rounds). All args uint32 arrays
    (broadcastable); returns two uint32 arrays of the broadcast shape."""
    k0 = jnp.asarray(k0, jnp.uint32)
    k1 = jnp.asarray(k1, jnp.uint32)
    x0 = jnp.asarray(c0, jnp.uint32) + k0
    x1 = jnp.asarray(c1, jnp.uint32) + k1
    ks2 = k0 ^ k1 ^ jnp.uint32(_PARITY)

    def four_rounds(x0, x1, rots):
        for r in rots:
            x0 = x0 + x1
            x1 = _rotl(x1, r)
            x1 = x1 ^ x0
        return x0, x1

    x0, x1 = four_rounds(x0, x1, _ROT_A)
    x0, x1 = x0 + k1, x1 + ks2 + jnp.uint32(1)
    x0, x1 = four_rounds(x0, x1, _ROT_B)
    x0, x1 = x0 + ks2, x1 + k0 + jnp.uint32(2)
    x0, x1 = four_rounds(x0, x1, _ROT_A)
    x0, x1 = x0 + k0, x1 + k1 + jnp.uint32(3)
    x0, x1 = four_rounds(x0, x1, _ROT_B)
    x0, x1 = x0 + k1, x1 + ks2 + jnp.uint32(4)
    x0, x1 = four_rounds(x0, x1, _ROT_A)
    x0, x1 = x0 + ks2, x1 + k0 + jnp.uint32(5)
    return x0, x1


def _seed_words(seed_key):
    """Accept a jax PRNG key, an int, or raw (2,) uint32 words."""
    if isinstance(seed_key, int):
        return (jnp.uint32(seed_key & 0xFFFFFFFF),
                jnp.uint32((seed_key >> 32) & 0xFFFFFFFF))
    arr = jnp.asarray(seed_key)
    if jnp.issubdtype(arr.dtype, jax.dtypes.prng_key):
        arr = jax.random.key_data(seed_key)
    arr = arr.astype(jnp.uint32).reshape(-1)
    return arr[0], arr[-1]


def sample_keys(seed_key, pixel_gid, sample_id):
    """Per-lane sample key words, shape (2, N) uint32 (row-major so the
    minor dim stays lane-sized; see rrt_tpu.vec on (N,2) padding).

    pixel_gid: (N,) global pixel index py*W+px. sample_id: scalar or (N,).
    """
    s0, s1 = _seed_words(seed_key)
    pixel_gid = jnp.asarray(pixel_gid).astype(jnp.uint32)
    sample_id = jnp.broadcast_to(
        jnp.asarray(sample_id).astype(jnp.uint32), pixel_gid.shape)
    k0, k1 = threefry2x32(s0, s1, pixel_gid, sample_id)
    return jnp.stack([k0, k1], axis=0)


def _words(keys, counter, n_words: int):
    """n_words uint32 streams for this (bounce*8+stream) counter.
    keys: (2, N) uint32 rows. Returns (n_words, N)."""
    k0 = keys[0]
    k1 = keys[1]
    counter = jnp.broadcast_to(jnp.asarray(counter, jnp.uint32), k0.shape)
    outs = []
    for pair in range((n_words + 1) // 2):
        a, b = threefry2x32(k0, k1, counter,
                            jnp.uint32(pair) * jnp.uint32(0x9E3779B9)
                            + jnp.uint32(pair))
        outs.append(a)
        outs.append(b)
    return jnp.stack(outs[:n_words], axis=0)


def _to_uniform(bits):
    """uint32 -> float32 in [0, 1) using the top 24 bits.

    The u32 value goes through i32 before the float cast (bit-identical
    for values < 2^24): Mosaic has no direct u32->f32 conversion, and this
    keeps the kernel and XLA paths on the same draw values."""
    return (bits >> jnp.uint32(8)).astype(jnp.int32).astype(
        jnp.float32) * jnp.float32(1.0 / (1 << 24))


def _counter(bounce, stream: int):
    return jnp.asarray(bounce, jnp.uint32) * _NUM_STREAMS + stream


def uniform_words(keys, bounce, stream: int, n: int):
    """(n, N) float32 uniforms in [0,1) for one (bounce, stream)."""
    return _to_uniform(_words(keys, _counter(bounce, stream), n))


def _cbrt01(u):
    """cbrt for u in [0,1) via exp(log/3) — Mosaic has no cbrt primitive;
    both the XLA and kernel paths share this form so draws stay equal."""
    return jnp.exp(jnp.log(jnp.maximum(u, 1e-12)) * (1.0 / 3.0))


def _box_muller(u1, u2):
    """Two iid standard normals from two uniforms."""
    r = jnp.sqrt(-2.0 * jnp.log(jnp.maximum(1.0 - u1, 1e-12)))
    th = (2.0 * jnp.pi) * u2
    return r * jnp.cos(th), r * jnp.sin(th)


def _normalize3_rows(x, y, z):
    n2 = x * x + y * y + z * z
    inv = jax.lax.rsqrt(jnp.maximum(n2, 1e-20))
    return x * inv, y * inv, z * inv


def camera_draws(keys):
    """(jx, jy, disc_x, disc_y, time_u), each (N,), for the camera ray."""
    u = uniform_words(keys, 0, STREAM_CAMERA, 5)
    r = jnp.sqrt(u[2])
    theta = (2.0 * jnp.pi) * u[3]
    return u[0], u[1], r * jnp.cos(theta), r * jnp.sin(theta), u[4]


def scatter_draws(keys, bounce):
    """(unit_vec V3, in_sphere V3, choice (N,)) for one bounce."""
    u = uniform_words(keys, bounce, STREAM_SCATTER, 8)
    g0, g1 = _box_muller(u[0], u[1])
    g2, g3 = _box_muller(u[2], u[3])
    g4, g5 = _box_muller(u[4], u[5])
    unit = V3(*_normalize3_rows(g0, g1, g2))
    sx, sy, sz = _normalize3_rows(g3, g4, g5)
    radius = _cbrt01(u[6])
    sphere = V3(sx * radius, sy * radius, sz * radius)
    return unit, sphere, u[7]


def medium_draws(keys, bounce, n_media: int):
    """(n_media, N) uniforms for constant-medium distance sampling
    (media-major so the minor dim stays lane-sized)."""
    return uniform_words(keys, bounce, STREAM_MEDIUM, n_media)


def rr_draw(keys, bounce):
    """(N,) uniform for the Russian-roulette continuation test at this
    bounce (STREAM_RR — reserved since round 1, first consumed by the
    round-4 RR option). The kernel path re-derives the identical value
    via threefry2x32(k0, k1, counter, 0) word a."""
    return uniform_words(keys, bounce, STREAM_RR, 1)[0]


# --- batch-level helpers (tests/utilities) -------------------------------


def uniform(key: jax.Array, shape) -> jax.Array:
    return jax.random.uniform(key, shape, dtype=jnp.float32)


def unit_vector(key: jax.Array, shape_prefix) -> jax.Array:
    """Uniform direction on S^2, shape (*shape_prefix, 3)."""
    g = jax.random.normal(key, (*shape_prefix, 3), dtype=jnp.float32)
    n2 = jnp.sum(g * g, axis=-1, keepdims=True)
    return g * jax.lax.rsqrt(jnp.maximum(n2, 1e-20))


def in_unit_sphere(key: jax.Array, shape_prefix) -> jax.Array:
    """Uniform point in the open unit ball, shape (*shape_prefix, 3)."""
    kd, kr = jax.random.split(key)
    d = unit_vector(kd, shape_prefix)
    u = jax.random.uniform(kr, (*shape_prefix, 1), dtype=jnp.float32)
    return d * jnp.cbrt(u)


def in_unit_disc(key: jax.Array, shape_prefix) -> jax.Array:
    """Uniform point in the unit disc; returns (*shape_prefix, 2)."""
    u = jax.random.uniform(key, (*shape_prefix, 2), dtype=jnp.float32)
    r = jnp.sqrt(u[..., 0])
    theta = (2.0 * jnp.pi) * u[..., 1]
    return jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta)], axis=-1)
