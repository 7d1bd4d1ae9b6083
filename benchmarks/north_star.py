"""North-star training step: chap12 1200x800 @ 500 spp, end to end, on
one GPU.

Measures diff.make_train_step, which chunks the sample range by the
device's memory (diff.resolve_spp_chunk), or the chunked trainer at an
explicit --chunk.

Usage:
  python benchmarks/north_star.py [--spp 500] [--rr-depth 0]
      [--chunk 0] [--iters 2]

--rr-depth N: Russian roulette past bounce N on both the forward chunks
and the backward replays (replayed kill + detached 1/p weight). The
estimator changes (variance, not mean); the A/B at equal spp is the
wall-time lever measured here.
"""

import argparse
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=500)
    ap.add_argument("--rr-depth", type=int, default=0)
    ap.add_argument("--chunk", type=int, default=0,
                    help="spp per chunk (0 = sized by device memory)")
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--width", type=int, default=1200)
    ap.add_argument("--height", type=int, default=800)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from rrt_tpu.diff import make_train_step, make_train_step_chunked
    from rrt_tpu.render import RenderConfig
    from rrt_tpu.scenes import chap12_scene
    from rrt_tpu.utils.cache import enable_persistent_cache
    from rrt_tpu.utils.device import nvidia_smi, require_gpu

    enable_persistent_cache()
    print("device:", require_gpu(), "|", nvidia_smi(), flush=True)
    cfg = RenderConfig(width=args.width, height=args.height,
                       spp=args.spp, max_depth=50,
                       rr_depth=args.rr_depth)
    scene, cam = chap12_scene(cfg.width, cfg.height)
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    if args.chunk:
        step = make_train_step_chunked(cfg, spp_chunk=args.chunk)
    else:
        step = make_train_step(cfg)
    chunk = getattr(step, "spp_chunk", "one-shot")

    print("compiling + warming (first step)...", flush=True)
    t0 = time.time()
    out = jax.block_until_ready(step(scene, cam, target, 0))
    print(f"first step (incl. compile): {time.time() - t0:.1f} s, "
          f"loss {float(out[2]):.6f}", flush=True)

    ts = []
    for i in range(args.iters):
        t0 = time.time()
        jax.block_until_ready(step(scene, cam, target, 0))
        ts.append(time.time() - t0)
        print(f"iter {i}: {ts[-1]:.1f} s", flush=True)
    med = statistics.median(ts)
    rays = cfg.width * cfg.height * cfg.spp  # primary; traced >> this
    print(f"median train step: {med:.1f} s over {args.iters} iters "
          f"(spread [{min(ts):.1f}, {max(ts):.1f}]); "
          f"{rays / med / 1e6:.1f} Mprimary-rays/s fwd+bwd; "
          f"rr_depth={args.rr_depth} chunk={chunk}")


if __name__ == "__main__":
    main()
