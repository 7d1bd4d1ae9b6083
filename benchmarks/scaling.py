"""Scaling-efficiency harness (SURVEY.md §4 item 5, north-star >= 85%).

Measures rays/s of the sharded renderers at 1, 2, 4, ... devices two
ways:
  * strong scaling — total workload fixed (tiles split over "dp");
  * weak scaling — per-device workload fixed (spp grows with the "sp"
    axis), the regime the >=85% target describes.

Driver: `queue` (render_image_queue_sharded, the forward fast path) or
`batch` (render_image_sharded, the rematerialized-scan path's driver).
Timings are median of 3 post-warmup runs.

On GPUs this runs across the cards of one host (or, with
jax.distributed, several hosts); with --cpu it validates the sharding
logic on virtual CPU devices. Virtual devices share the host's cores, so
a --cpu "efficiency" measures host contention, not communication: it
only proves the sweep runs end to end. Every run prints the device
record.
"""

import argparse
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import jax  # noqa: E402


def _median_time(fn, n=3):
    img, _ = fn()  # warm (compile happened in caller's first call)
    img.block_until_ready()  # keep the warm run out of the first sample
    ts = []
    for _ in range(n):
        t0 = time.time()
        img, nt = fn()
        img.block_until_ready()
        ts.append(time.time() - t0)
    return statistics.median(ts), float(nt)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--devices", type=int, default=0,
                    help="max devices (0 = all)")
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=144)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--driver", choices=("queue", "batch"),
                    default="queue")
    ap.add_argument("--mode", choices=("strong", "weak", "both"),
                    default="both")
    args = ap.parse_args()

    if args.cpu:
        os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + \
            " --xla_force_host_platform_device_count=8"
        jax.config.update("jax_platforms", "cpu")

    import rrt_tpu
    from rrt_tpu.parallel.mesh import (make_mesh,
                                       render_image_queue_sharded,
                                       render_image_sharded)
    from rrt_tpu.scenes import chap12_scene
    from rrt_tpu.utils.cache import enable_persistent_cache
    from rrt_tpu.utils.device import (device_record, nvidia_smi,
                                      require_gpu)

    enable_persistent_cache()
    dev = device_record() if args.cpu else require_gpu()
    print("device:", dev, "|", nvidia_smi(), flush=True)

    render = {
        "queue": render_image_queue_sharded,
        "batch": lambda s, c, cfg, seed, mesh: render_image_sharded(
            s, c, cfg, seed, mesh),
    }[args.driver]

    n_dev = len(jax.devices())
    if args.devices:
        n_dev = min(n_dev, args.devices)
    scene, cam = chap12_scene(args.width, args.height)

    def cfg_for(spp):
        return rrt_tpu.RenderConfig(
            width=args.width, height=args.height, spp=spp, max_depth=50,
            tile_pixels=4096, samples_per_pass=2)

    modes = ("strong", "weak") if args.mode == "both" else (args.mode,)
    for mode in modes:
        print(f"== {mode} scaling, driver={args.driver}, "
              f"{args.width}x{args.height} base spp={args.spp} ==",
              flush=True)
        results = {}
        n = 1
        while n <= n_dev:
            # strong: fixed total work, tiles over dp.
            # weak: spp scales with n over sp (per-device work fixed).
            if mode == "strong":
                mesh = make_mesh(devices=jax.devices()[:n], sp=1)
                cfg = cfg_for(args.spp)
            else:
                mesh = make_mesh(devices=jax.devices()[:n], dp=1)
                cfg = cfg_for(args.spp * n)
            dt, rays = _median_time(
                lambda: render(scene, cam, cfg, 0, mesh))
            results[n] = rays / dt
            base = results.get(1, results[n])
            eff = results[n] / (base * n)
            print(f"devices={n}: {rays / dt / 1e6:7.2f} Mrays/s  "
                  f"efficiency={eff:.1%}", flush=True)
            n *= 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
