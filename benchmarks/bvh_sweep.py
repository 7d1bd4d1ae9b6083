"""Closest-sphere hit for a 64k-ray batch against S random spheres, two
ways, on one GPU:

  * XLA brute force (geometry.intersect_spheres — the (N,S) broadcast)
  * BVH stack traversal (accel.bvh_intersect_spheres)

at S in {512, 4096, 16384}: where (if anywhere) per-ray traversal beats
the full slot sweep. Prints one line per S and the device record.

Run: python benchmarks/bvh_sweep.py
"""

import os
import statistics
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from rrt_tpu import accel, rng  # noqa: E402
from rrt_tpu.geometry import INF, intersect_spheres  # noqa: E402
from rrt_tpu.scene import SceneBuilder  # noqa: E402
from rrt_tpu.utils.cache import enable_persistent_cache  # noqa: E402
from rrt_tpu.utils.device import nvidia_smi, require_gpu  # noqa: E402
from rrt_tpu.vec import V3  # noqa: E402

N = 65536
ITERS = 5


def random_scene(s: int, seed: int = 0):
    rs = np.random.RandomState(seed)
    b = SceneBuilder()
    mat = b.lambertian((0.5, 0.5, 0.5))
    centers = rs.uniform(-50.0, 50.0, size=(s, 3))
    radii = rs.uniform(0.3, 1.5, size=(s,))
    for c, r in zip(centers, radii):
        b.sphere(tuple(c), float(r), mat)
    return b.build()


def timed(fn, *args):
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(ITERS):
        t0 = time.time()
        jax.block_until_ready(fn(*args))
        ts.append(time.time() - t0)
    return statistics.median(ts)


def main():
    enable_persistent_cache()
    print("device:", require_gpu(), "|", nvidia_smi(), flush=True)
    key = jax.random.key(0)
    o = V3(jnp.zeros((N,)), jnp.zeros((N,)), jnp.full((N,), -120.0))
    d_arr = rng.unit_vector(key, (N,))
    d = V3(d_arr[:, 0], d_arr[:, 1], jnp.abs(d_arr[:, 2]))
    tm = jnp.zeros((N,))
    t_min = jnp.full((N,), 1e-3)
    t_max = jnp.full((N,), INF)

    for s in (512, 4096, 16384):
        scene = random_scene(s)
        brute = jax.jit(lambda sc, o, d, tm, lo, hi:
                        intersect_spheres(sc, o, d, tm, lo, hi))
        t_brute = timed(brute, scene, o, d, tm, t_min, t_max)

        bvh = accel.build_sphere_bvh(scene)
        # bvh is closed over (its prim_count/topology feed static shapes
        # inside bvh_intersect_spheres).
        trav = jax.jit(lambda sc, o, d, tm, lo, hi:
                       accel.bvh_intersect_spheres(sc, bvh, o, d, tm, lo,
                                                   hi))
        t_bvh = timed(trav, scene, o, d, tm, t_min, t_max)

        mrs = N / 1e6
        print(f"S={s:6d}: brute {t_brute*1e3:8.2f} ms ({mrs/t_brute:7.1f}"
              f" Mray/s) | bvh {t_bvh*1e3:8.2f} ms ({mrs/t_bvh:7.1f})",
              flush=True)


if __name__ == "__main__":
    main()
