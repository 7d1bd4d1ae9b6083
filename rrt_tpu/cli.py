"""Command-line renderer.

Covers the reference CLI (src/main.rs:12-46: -r/--resolution, -s/--samples,
-e/--seed, -m/--random) plus scene selection, output path, backend/driver
choice, checkpoint/resume, progress reporting and profiling — the config
surface the reference hard-codes (SURVEY.md §5.6).

Progressive rendering: samples are rendered in passes of `--spp-chunk`;
after each pass the accumulator can be checkpointed and the preview
updated. Per-(pixel, sample) keyed RNG makes resume exact.
"""

import argparse
import os
import sys
import time

import numpy as np


def parse_resolution(s: str):
    try:
        w, h = s.lower().split("x")
        w, h = int(w), int(h)
        if w <= 0 or h <= 0:
            raise ValueError
        return w, h
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"resolution must be WIDTHxHEIGHT with positive integers, "
            f"got {s!r}")


def build_parser():
    p = argparse.ArgumentParser(
        prog="rrt-tpu", description="Differentiable Monte Carlo path tracer")
    p.add_argument("-r", "--resolution", type=parse_resolution,
                   default=(1200, 800), help="WIDTHxHEIGHT (default "
                   "1200x800, the reference default)")
    p.add_argument("-s", "--samples", type=int, default=10,
                   help="samples per pixel (default 10)")
    p.add_argument("-e", "--seed", type=int, default=0,
                   help="render seed (default 0)")
    p.add_argument("-m", "--random", action="store_true",
                   help="use an entropy seed instead of --seed")
    p.add_argument("--scene", default="book2chap2",
                   help="scene name (see rrt_tpu.scenes.SCENES)")
    p.add_argument("-o", "--output", default="o.ppm",
                   help="output path; .png or .ppm by extension")
    p.add_argument("--max-depth", type=int, default=50)
    p.add_argument("--rr-depth", type=int, default=0,
                   help="Russian roulette from this bounce (0 = off, "
                   "the books' exact termination; unbiased, it shortens "
                   "the straggler tail at the cost of variance)")
    p.add_argument("--spp-chunk", type=int, default=-1,
                   help="samples per progressive pass (-1 = auto: "
                   "min(32, spp) so long renders report progress; "
                   "0 = all at once)")
    p.add_argument("--queue-size", type=int, default=131072)
    p.add_argument("--driver", choices=("auto", "queue", "batch"),
                   default="auto",
                   help="auto (default) = queue: compacted ray queue; "
                   "batch: the differentiable path's driver "
                   "(parity/debug)")
    p.add_argument("--cpu", action="store_true",
                   help="force the CPU backend")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file to save to / resume from")
    p.add_argument("--checkpoint-every", type=int, default=1,
                   help="checkpoint every N progressive passes")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a jax.profiler trace to DIR")
    p.add_argument("--texture", default=None, metavar="PATH",
                   help="image file for the scene's image texture "
                   "(earth / rttnw_final; e.g. the book's earthmap.jpg)."
                   " PPM decoded natively, other formats via PIL")
    p.add_argument("--texture-filter", choices=("nearest", "bilinear"),
                   default="nearest",
                   help="resampling for --texture images over "
                   "--texture-max or sharing a mixed-size atlas "
                   "(default nearest; bilinear smooths photos)")
    p.add_argument("--texture-max", type=parse_resolution,
                   default=(512, 256), metavar="WxH",
                   help="cap loaded textures to this size (default "
                   "512x256); larger images are resampled on the host")
    p.add_argument("--quiet", action="store_true")
    # Multi-process launch surface. Every process runs the SAME command
    # with its own --process-id. Localhost 2-process recipe (CPU backend,
    # 2 virtual devices each -> one 4-device mesh):
    #   for i in 0 1; do
    #     XLA_FLAGS=--xla_force_host_platform_device_count=2 \
    #     python -m rrt_tpu.cli --cpu --scene chap11 -r 64x36 -s 4 \
    #       --coordinator localhost:9876 --num-processes 2 \
    #       --process-id $i -o mp.png &
    #   done; wait
    # GPUs: with a localhost coordinator (several processes on one host)
    # process i opens only card i (parallel.mesh.initialize_distributed),
    # so a 4-card host runs 4 processes. Across hosts, run one process
    # per host; it opens every local card. A single process with no
    # coordinator also drives every local card (--mesh DPxSP).
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-host coordinator address (process 0's "
                   "host); enables jax.distributed")
    p.add_argument("--num-processes", type=int, default=None,
                   help="multi-host: total process count")
    p.add_argument("--process-id", type=int, default=None,
                   help="multi-host: this process's rank")
    p.add_argument("--mesh", default=None, metavar="DPxSP",
                   help="device mesh shape over ALL devices (default: "
                   "auto); single-process multi-device renders also "
                   "honor this")
    return p


def resolve_driver(driver: str) -> str:
    """`auto` (the CLI default) is the compacted-queue driver, the forward
    fast path; `queue`/`batch` are honored as-is."""
    return "queue" if driver == "auto" else driver


def _main_sharded(args, cfg, scene, camera, seed, log):
    """Multi-device / multi-host render: one pass over the global mesh
    (progressive chunking and checkpointing are single-process
    features). Every process calls this; process 0 writes the image."""
    import jax
    import jax.numpy as jnp

    import rrt_tpu
    from rrt_tpu import io as rio
    from rrt_tpu.parallel.mesh import (make_mesh,
                                       render_image_queue_sharded,
                                       render_image_sharded)

    dp = sp = None
    if args.mesh:
        dp, sp = parse_resolution(args.mesh)
    mesh = make_mesh(dp=dp, sp=sp)
    log(f"mesh {dict(mesh.shape)} over {jax.device_count()} devices, "
        f"{jax.process_count()} process(es)")
    t0 = time.time()
    if args.driver == "batch":
        img, nt = render_image_sharded(scene, camera, cfg, seed, mesh)
    else:
        img, nt = render_image_queue_sharded(scene, camera, cfg, seed,
                                             mesh)
    jax.block_until_ready(img)
    if jax.process_count() > 1:
        # Images are dp-sharded across processes; gather so process 0
        # holds every row.
        from jax.experimental import multihost_utils
        img = multihost_utils.process_allgather(img, tiled=True)
    dt = time.time() - t0
    total_rays = float(nt)
    if jax.process_index() == 0:
        rgb8 = np.asarray(rrt_tpu.tonemap(jnp.asarray(img)))
        rio.write_image(args.output, rgb8)
        log(f"wrote {args.output}  ({dt:.1f}s, {total_rays / 1e6:.1f}M "
            f"rays, {total_rays / max(dt, 1e-9) / 1e6:.1f} Mrays/s)")
    jax.effects_barrier()
    return 0


def main(argv=None):
    args = build_parser().parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    # Persistent compile cache (rrt_tpu.utils.cache): a second process
    # reuses the first one's compiled renderer.
    from .utils.cache import enable_persistent_cache
    enable_persistent_cache()

    dist_flags = (args.coordinator, args.num_processes, args.process_id)
    distributed = any(f is not None for f in dist_flags)
    if distributed:
        if any(f is None for f in dist_flags):
            # initialize_distributed silently drops rank args without a
            # coordinator (auto-detect path) — demand all three so a
            # typo'd launch fails loudly instead of hanging.
            print("multi-process mode needs ALL of --coordinator, "
                  "--num-processes and --process-id", file=sys.stderr)
            return 2
        # Must run before any other jax op on every process.
        from rrt_tpu.parallel.mesh import initialize_distributed
        initialize_distributed(args.coordinator, args.num_processes,
                               args.process_id)

    import rrt_tpu
    from rrt_tpu import io as rio
    from rrt_tpu.render import trace_queue
    from rrt_tpu.scenes import SCENES

    if args.scene not in SCENES:
        print(f"unknown scene {args.scene!r}; available: "
              f"{', '.join(sorted(SCENES))}", file=sys.stderr)
        return 2

    width, height = args.resolution
    seed = int(np.random.SeedSequence().entropy % (2 ** 31)) if args.random \
        else args.seed
    spp = args.samples
    log = (lambda *a: None) if args.quiet else (
        lambda *a: print(*a, file=sys.stderr, flush=True))

    log(f"rrt-tpu: {args.scene} {width}x{height} @ {spp}spp seed={seed} "
        f"depth={args.max_depth} driver={args.driver} "
        f"backend={jax.default_backend()}")

    build_kwargs = {}
    if args.texture:
        import inspect
        if "image" not in inspect.signature(
                SCENES[args.scene]).parameters:
            print(f"scene {args.scene!r} has no image texture; --texture"
                  " applies to: " + ", ".join(sorted(
                      n for n, fn in SCENES.items()
                      if "image" in inspect.signature(fn).parameters)),
                  file=sys.stderr)
            return 2
        img = rio.read_image(args.texture)
        max_w, max_h = args.texture_max
        if img.shape[0] > max_h or img.shape[1] > max_w:
            from rrt_tpu.scene import resample_image
            h2 = min(img.shape[0], max_h)
            w2 = min(img.shape[1], max_w)
            log(f"texture {args.texture}: {img.shape[0]}x"
                f"{img.shape[1]} -> {h2}x{w2} ({args.texture_filter}, "
                f"--texture-max)")
            img = resample_image(img, h2, w2, args.texture_filter)
        else:
            log(f"texture {args.texture}: "
                f"{img.shape[0]}x{img.shape[1]}")
        build_kwargs["image"] = img
        build_kwargs["image_resample"] = args.texture_filter

    t0 = time.time()
    scene, camera = SCENES[args.scene](width, height, **build_kwargs)
    log(f"scene built in {time.time() - t0:.2f}s "
        f"({scene.n_spheres} sphere slots, {scene.n_quads} quad slots, "
        f"{scene.n_boxes if scene.has_boxes else 0} box slots)")

    args.driver = resolve_driver(args.driver)

    cfg = rrt_tpu.RenderConfig(
        width=width, height=height, spp=spp, max_depth=args.max_depth,
        queue_size=min(args.queue_size, width * height * spp),
        samples_per_pass=min(4, spp), tile_pixels=16384,
        rr_depth=args.rr_depth)

    if distributed or args.mesh:
        return _main_sharded(args, cfg, scene, camera, seed, log)

    # One jit for all progressive chunks: sample bounds are dynamic args.
    if args.driver == "queue":
        trace_chunk = jax.jit(
            lambda sc, cm, x, y, k, lo, hi: trace_queue(sc, cm, x, y, cfg,
                                                        k, lo, hi))
    else:
        # Batch driver (parity/debug path): internally tiled by
        # render_image; progressive chunking is a queue-driver feature.
        # Samples [lo, hi) are rendered via pass_start so checkpoint
        # resume never re-renders (and double-counts) finished samples.
        from rrt_tpu.render import render_image

        def _batch_chunk(sc, cm, x, y, k, lo, hi):
            spc = cfg.samples_per_pass
            img, nt = render_image(sc, cm, cfg, k, pass_start=lo // spc,
                                   n_passes=(hi - lo) // spc)
            return img.reshape(-1, 3) * jnp.float32(hi - lo), nt

        import jax.numpy as jnp
        trace_chunk = jax.jit(_batch_chunk, static_argnums=(5, 6))

    if args.profile:
        jax.profiler.start_trace(args.profile)

    if args.spp_chunk < 0:  # auto: progress at least every 32 spp
        chunk = min(32, spp)
    else:
        chunk = args.spp_chunk if args.spp_chunk > 0 else spp
        if chunk > 32:
            # One device call = no progress until it returns (the
            # reference shows a 1 Hz bar, src/main.rs:78-94) — say so
            # instead of going silent.
            log(f"rendering all {spp} spp in one launch; no progress "
                f"until it completes (use --spp-chunk for updates)")
    if args.driver == "batch":
        spc = cfg.samples_per_pass
        if spp % spc:
            print("batch driver requires spp to be a multiple of "
                  f"samples_per_pass={spc}", file=sys.stderr)
            return 2
        if chunk != spp:
            log("note: --spp-chunk is a queue-driver feature; batch "
                "driver renders all samples in one pass")
            chunk = spp
    n_pix = width * height
    ids = np.arange(n_pix, dtype=np.int32)
    px = jax.numpy.asarray(ids % width)
    py = jax.numpy.asarray(ids // width)
    seed_key = jax.random.key(seed)

    acc = np.zeros((n_pix, 3), np.float32)
    spp_done = 0
    total_rays = 0.0
    # Everything that changes the rendered radiance must be in the
    # checkpoint meta, or resume silently AVERAGES two different
    # renders (e.g. 4 file-textured + 4 procedural-textured spp).
    ck_meta = {"scene": args.scene, "width": width, "height": height,
               "max_depth": args.max_depth, "rr_depth": args.rr_depth,
               "texture": args.texture or "",
               "texture_filter": args.texture_filter,
               "texture_max": "x".join(map(str, args.texture_max))}
    if args.checkpoint:
        try:
            acc_l, spp_done, seed_ck, meta = rio.load_checkpoint(
                args.checkpoint)
            compatible = (seed_ck == seed
                          and all(meta.get(k, v) == v
                                  for k, v in ck_meta.items())
                          and acc_l.shape[0] == n_pix)
            if compatible and args.driver == "batch" \
                    and spp_done % cfg.samples_per_pass:
                log("checkpoint spp_done not a multiple of the batch "
                    "driver's samples_per_pass; starting fresh")
                spp_done = 0
            elif compatible:
                acc = acc_l
                log(f"resumed checkpoint at {spp_done}/{spp} spp")
            else:
                log("checkpoint incompatible; starting fresh")
                spp_done = 0
        except FileNotFoundError:
            pass

    t_render = time.time()
    passes = 0
    while spp_done < spp:
        s_hi = min(spp_done + chunk, spp)
        rad, n_traced = trace_chunk(scene, camera, px, py, seed_key,
                                    spp_done, s_hi)
        jax.block_until_ready(rad)
        acc += np.asarray(rad)
        total_rays += float(n_traced)
        spp_done = s_hi
        passes += 1
        elapsed = time.time() - t_render
        log(f"  {spp_done}/{spp} spp  {elapsed:.1f}s  "
            f"{total_rays / max(elapsed, 1e-9) / 1e6:.1f} Mrays/s")
        if args.checkpoint and (passes % args.checkpoint_every == 0
                                or spp_done >= spp):
            rio.save_checkpoint(args.checkpoint, acc, spp_done, seed,
                                ck_meta)
        # Fault-injection hook (SURVEY §5.3): RRT_FAULT_AFTER_CHUNKS=N
        # hard-kills the process after N chunks, simulating a mid-render
        # crash. Recovery = restart with the same --checkpoint; the
        # counter-keyed RNG guarantees a bit-identical final image
        # (tests/test_io_cli.py::test_cli_crash_recovery_bit_exact).
        if passes == int(os.environ.get("RRT_FAULT_AFTER_CHUNKS", 0)):
            os._exit(17)

    if args.profile:
        jax.profiler.stop_trace()

    image = (acc / max(spp_done, 1)).reshape(height, width, 3)
    rgb8 = np.asarray(rrt_tpu.tonemap(jax.numpy.asarray(image)))
    rio.write_image(args.output, rgb8)
    dt = time.time() - t_render
    log(f"wrote {args.output}  ({dt:.1f}s, {total_rays / 1e6:.1f}M rays, "
        f"{total_rays / max(dt, 1e-9) / 1e6:.1f} Mrays/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
