"""Smoke run of the renderer on one NVIDIA GPU (or, with --four-gpus, the
sharded paths on four), through the entry points a user calls.

    python chip_smoke.py               # one GPU: phases 1-5
    python chip_smoke.py --four-gpus   # four GPUs: the sharded phase only

Phases (one output line each; any failure raises and exits non-zero):

  1. device      — JAX platform, device kind and count, nvidia-smi's name
                   and power limit; refuses to go on unless the platform
                   is "gpu".
  2. forward     — chap12 1200x800 @ 32 spp, depth 50, through
                   rrt_tpu.cli.main (PNG + checkpoint written, radiance
                   finite), then the same render through
                   render_image_queue for compile time, wall time, Mrays/s
                   and peak device memory; 4096 camera rays traced by
                   trace_batch on the GPU and on the CPU backend agree
                   (>= 99% of rays within 2e-3 + 1% |cpu|, the
                   tolerance of tests/test_golden.py: f32 near-tie
                   decisions flip whole paths).
  3. forward     — rttnw_final 400x267 @ 32 spp, depth 50 (every
                   primitive family, media, perlin, the image texture),
                   checked the same way.
  4. train       — chap12 1200x800 @ 8 spp, depth 50, three steps of
                   diff.make_train_step: finite losses and parameters,
                   the compiled step's memory analysis and step time;
                   GPU vs CPU gradients at 128x96 within 1e-2 relative L2
                   per parameter leaf (every gradient bound here holds on
                   the well-conditioned leaves, see WELL_CONDITIONED;
                   the others are reported).
  5. chunked     — chap12 1200x800 @ 32 spp, forced to 4 chunks: its
                   gradient matches the one-shot gradient within 1e-4
                   relative L2 (same rays; only the summation order
                   differs). Depth is cut to 16 so that the one-shot
                   reference's backward residual fits one card.
  6. --four-gpus — render_image_queue_sharded of chap12 1200x800 @ 32 spp
                   on (dp, sp) = (4,1), (2,2), (1,4) against one card
                   (max abs diff <= 1e-5 max), the sharded 8-spp gradient
                   against one card's (relative L2 <= 1e-4), shards on
                   four distinct devices, each with nonzero peak memory.

Every number printed is a smoke number from this one run, labelled with
the card it ran on. The last line is the JSON object
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rrt_tpu import cli, rng  # noqa: E402
from rrt_tpu.camera import generate_rays  # noqa: E402
from rrt_tpu.diff import (loss_and_grad_chunked, partition,  # noqa: E402
                          render_loss, resolve_spp_chunk,
                          make_train_step)
from rrt_tpu.io import load_checkpoint  # noqa: E402
from rrt_tpu.render import (RenderConfig, render_image_queue,  # noqa: E402
                            trace_batch)
from rrt_tpu.scenes import SCENES  # noqa: E402
from rrt_tpu.utils.cache import enable_persistent_cache  # noqa: E402
from rrt_tpu.utils.device import (NoGPUError, device_record,  # noqa: E402
                                  nvidia_smi)

# Per-ray GPU-vs-CPU agreement (tests/test_golden.py's tolerance).
RAY_ATOL, RAY_RTOL, RAY_MIN_MATCH = 2e-3, 0.01, 0.99
GRAD_CPU_RTOL = 1e-2      # GPU vs CPU gradient, relative L2 per leaf
GRAD_CHUNK_RTOL = 1e-4    # chunked or sharded vs one-shot, the same
SHARD_ATOL_REL = 1e-5     # sharded vs one-card image, x max radiance
# A gradient leaf is held to its bound only where the reference gradient
# moves by less than WELL_CONDITIONED (relative L2) when the camera moves
# by CAMERA_NUDGE, a change at the level of f32 rounding. Geometry and
# camera gradients of chap12 move by O(1) under it: a few grazing or
# refracting rays carry most of their magnitude and cancel, so neither
# another backend nor another summation order reproduces them. Those
# leaves are reported, not held; the colour leaves must always be held.
WELL_CONDITIONED = 0.5 * GRAD_CPU_RTOL
CAMERA_NUDGE = 1e-6
MUST_HOLD = ("[0]['tex_color1']", "[0]['bg_top']")


def report(phase: str, **fields):
    """One output line per phase."""
    print(f"[{phase}] " + json.dumps(fields), flush=True)


def peak_bytes(device) -> int | None:
    stats = device.memory_stats()
    return None if not stats else stats.get("peak_bytes_in_use")


def check_device(count: int = 1) -> dict:
    """Phase 1. Returns the device record; raises NoGPUError unless JAX's
    devices are GPUs (at least `count` of them)."""
    rec = device_record()
    smi = nvidia_smi()
    report("device", **rec, nvidia_smi=smi)
    for line in smi.splitlines():
        print(line, flush=True)
    if rec["platform"] != "gpu":
        raise NoGPUError(f"JAX found no GPU (platform {rec['platform']!r});"
                         f" this smoke run needs the card")
    if rec["count"] < count:
        raise NoGPUError(f"needs {count} GPUs, JAX found {rec['count']}")
    return rec


def _rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    nb = np.linalg.norm(b)
    diff = np.linalg.norm(a - b)
    if nb == 0.0:
        return 0.0 if diff == 0.0 else float("inf")
    return float(diff / nb)


def _grad_errors(ga, gb) -> dict:
    """Relative L2 error of every gradient leaf of ga against gb."""
    la, _ = jax.tree_util.tree_flatten_with_path(ga)
    lb = jax.tree_util.tree_leaves(gb)
    return {jax.tree_util.keystr(path): _rel_l2(a, b)
            for (path, a), b in zip(la, lb)}


def compare_rays(scene, camera, width, height, max_depth, n_rays=4096,
                 seed=7, cpu=None):
    """trace_batch on `n_rays` camera rays spread over the image, on the
    default device and on the CPU backend; returns the fraction of rays
    whose radiance agrees within RAY_ATOL + RAY_RTOL * |cpu|."""
    cpu = cpu or jax.devices("cpu")[0]
    n_pix = width * height
    ids = (np.arange(n_rays, dtype=np.int64) * n_pix // n_rays).astype(
        np.int32)
    px, py = jnp.asarray(ids % width), jnp.asarray(ids // width)
    keys = rng.sample_keys(jax.random.key(seed),
                           (py * width + px).astype(jnp.uint32), 0)
    o, d, tm = generate_rays(camera, px, py, width, height, keys)
    rays = jax.tree.map(np.asarray, (o, d, tm, keys))

    trace = jax.jit(lambda sc, o, d, tm, k: trace_batch(
        sc, o, d, tm, k, max_depth, 1e-3, differentiable=False)[0])

    def run(device):
        args = jax.device_put((scene,) + rays, device)
        r = trace(*args)
        return np.stack([np.asarray(r.x), np.asarray(r.y),
                         np.asarray(r.z)], axis=-1)

    acc = run(jax.devices()[0])
    ref = run(cpu)
    close = np.all(np.abs(acc - ref) <= RAY_ATOL + RAY_RTOL * np.abs(ref),
                   axis=-1)
    return float(close.mean()), float(np.abs(acc - ref).max())


def phase_forward(scene_name, width, height, spp, max_depth, out_dir,
                  n_rays=4096):
    """Phases 2-3: one forward render through the CLI and the library,
    and the per-ray GPU-vs-CPU comparison."""
    png = os.path.join(out_dir, f"{scene_name}.png")
    ck = os.path.join(out_dir, f"{scene_name}_ck.npz")
    t0 = time.time()
    rc = cli.main(["--scene", scene_name, "-r", f"{width}x{height}",
                   "-s", str(spp), "--max-depth", str(max_depth),
                   "-o", png, "--checkpoint", ck])
    cli_wall = time.time() - t0
    if rc != 0:
        raise RuntimeError(f"cli.main exited {rc}")
    if not os.path.getsize(png):
        raise RuntimeError(f"{png} is empty")
    acc, spp_done, _, _ = load_checkpoint(ck)
    if spp_done != spp or acc.shape != (width * height, 3):
        raise RuntimeError(f"checkpoint holds {spp_done} spp of shape "
                           f"{acc.shape}")
    if not np.isfinite(acc).all():
        raise FloatingPointError("CLI radiance is not finite")

    scene, camera = SCENES[scene_name](width, height)
    cfg = RenderConfig(width=width, height=height, spp=spp,
                       max_depth=max_depth,
                       queue_size=min(131072, width * height * spp))
    t0 = time.time()
    compiled = render_image_queue.lower(scene, camera, cfg, 0).compile()
    compile_s = time.time() - t0
    img1, n1 = jax.block_until_ready(compiled(scene, camera, 0))
    t0 = time.time()
    img2, n2 = jax.block_until_ready(compiled(scene, camera, 0))
    wall = time.time() - t0
    img1, img2 = np.asarray(img1), np.asarray(img2)
    if not np.isfinite(img2).all():
        raise FloatingPointError("render_image_queue radiance not finite")

    frac, worst = compare_rays(scene, camera, width, height, max_depth,
                               n_rays=n_rays)
    report(f"forward {scene_name}",
           size=f"{width}x{height}@{spp}spp depth {max_depth}",
           smoke_cli_wall_s_incl_compile=round(cli_wall, 3),
           smoke_compile_s=round(compile_s, 3),
           smoke_wall_s=round(wall, 4),
           smoke_mrays_per_s=round(float(n2) / wall / 1e6, 2),
           rays_traced=float(n2),
           smoke_peak_bytes_in_use=peak_bytes(jax.devices()[0]),
           same_seed_bitwise_equal=bool(np.array_equal(img1, img2)),
           rays_compared=n_rays, rays_within_tol=frac,
           worst_ray_abs_diff=worst)
    if frac < RAY_MIN_MATCH:
        raise AssertionError(f"only {frac:.2%} of rays agree with the CPU")


_loss_and_grad = jax.jit(jax.value_and_grad(render_loss, argnums=(0, 1)),
                         static_argnames=("cfg", "mesh"))


def grads_on(device, scene, camera, target, cfg):
    """(loss, (param grads, camera grads)) of the one-shot MSE on
    `device`, as numpy."""
    args = jax.device_put((partition(scene), camera, scene, target),
                          device)
    loss, g = _loss_and_grad(*args, cfg=cfg, seed=0)
    return float(loss), jax.tree.map(np.asarray, g)


def nudged(camera):
    return dataclasses.replace(
        camera, look_from=camera.look_from + jnp.float32(CAMERA_NUDGE))


def screened_compare(what, grads, ref, ref_nudged, tol):
    """Per-leaf relative L2 error of `grads` against `ref`, held to `tol`
    on the leaves whose reference is well conditioned (ref_nudged moves
    it by <= WELL_CONDITIONED). Returns the report fields; raises on a
    held leaf over `tol` or a MUST_HOLD leaf that is not held."""
    errs = _grad_errors(jax.tree.map(np.asarray, grads), ref)
    noise = _grad_errors(ref_nudged, ref)
    held = {k: errs[k] for k in errs if noise[k] <= WELL_CONDITIONED}
    fields = {"rel_l2_held": held,
              "not_held_rel_l2_and_nudge": {
                  k: [errs[k], noise[k]] for k in errs if k not in held}}
    report(what, **fields)
    missing = [k for k in MUST_HOLD if k not in held]
    if missing:
        raise AssertionError(f"{what}: {missing} not well conditioned "
                             f"({ {k: noise[k] for k in missing} })")
    bad = {k: v for k, v in held.items() if v > tol}
    if bad:
        raise AssertionError(f"{what}: gradient leaves over {tol}: {bad}")
    return fields


def phase_train(width, height, spp, max_depth, steps=3,
                compare_size=(128, 96)):
    """Phase 4: train steps through diff.make_train_step at full size,
    and GPU vs CPU gradients at compare_size."""
    scene, camera = SCENES["chap12"](width, height)
    cfg = RenderConfig(width=width, height=height, spp=spp,
                       max_depth=max_depth)
    target = jnp.full((height, width, 3), 0.25, jnp.float32)
    step = make_train_step(cfg)
    memory = None
    if hasattr(step, "lower"):  # the one-shot step is one jitted call
        t0 = time.time()
        compiled = step.lower(scene, camera, target, 0).compile()
        compile_s = time.time() - t0
        memory = str(compiled.memory_analysis())
    else:
        compile_s = None
    losses, walls = [], []
    for _ in range(steps):
        t0 = time.time()
        scene, camera, loss = jax.block_until_ready(
            step(scene, camera, target, 0))
        walls.append(time.time() - t0)
        losses.append(float(loss))
        finite = all(bool(jnp.all(jnp.isfinite(x))) for x in
                     jax.tree.leaves((partition(scene), camera)))
        if not (np.isfinite(losses[-1]) and finite):
            raise FloatingPointError("non-finite loss or parameters")

    cw, ch = compare_size
    sc_s, cm_s = SCENES["chap12"](cw, ch)
    cfg_s = RenderConfig(width=cw, height=ch, spp=spp, max_depth=max_depth)
    tgt_s = jnp.full((ch, cw, 3), 0.25, jnp.float32)
    report("train chap12",
           size=f"{width}x{height}@{spp}spp depth {max_depth}",
           spp_chunk=getattr(step, "spp_chunk", spp),
           losses=losses, smoke_step_walls_s=[round(w, 3) for w in walls],
           smoke_compile_s=None if compile_s is None else round(compile_s,
                                                                3),
           memory_analysis=memory,
           smoke_peak_bytes_in_use=peak_bytes(jax.devices()[0]),
           grad_compare_size=f"{cw}x{ch}")
    cpu = jax.devices("cpu")[0]
    _, g_acc = grads_on(jax.devices()[0], sc_s, cm_s, tgt_s, cfg_s)
    _, g_cpu = grads_on(cpu, sc_s, cm_s, tgt_s, cfg_s)
    _, g_nudged = grads_on(cpu, sc_s, nudged(cm_s), tgt_s, cfg_s)
    screened_compare(f"train chap12 {cw}x{ch}: GPU vs CPU gradient",
                     g_acc, g_cpu, g_nudged, GRAD_CPU_RTOL)


def phase_chunked(width, height, spp, max_depth, n_chunks=4):
    """Phase 5: the chunked gradient (n_chunks device calls) against the
    one-shot gradient."""
    scene, camera = SCENES["chap12"](width, height)
    cfg = RenderConfig(width=width, height=height, spp=spp,
                       max_depth=max_depth)
    target = jnp.full((height, width, 3), 0.25, jnp.float32)
    chunked = loss_and_grad_chunked(cfg, spp_chunk=spp // n_chunks)
    t0 = time.time()
    loss_c, g_c = jax.block_until_ready(chunked(scene, camera, target, 0))
    wall_c = time.time() - t0
    t0 = time.time()
    loss_1, g_1 = grads_on(jax.devices()[0], scene, camera, target, cfg)
    wall_1 = time.time() - t0
    report("chunked chap12",
           size=f"{width}x{height}@{spp}spp depth {max_depth}",
           chunks=spp // chunked.spp_chunk,
           auto_chunk_at_depth_50=resolve_spp_chunk(
               RenderConfig(width=width, height=height, spp=spp,
                            max_depth=50)),
           loss_chunked=float(loss_c), loss_one_shot=loss_1,
           smoke_wall_chunked_s_incl_compile=round(wall_c, 3),
           smoke_wall_one_shot_s_incl_compile=round(wall_1, 3),
           smoke_peak_bytes_in_use=peak_bytes(jax.devices()[0]))
    _, g_1n = grads_on(jax.devices()[0], scene, nudged(camera), target,
                       cfg)
    screened_compare("chunked chap12: chunked vs one-shot gradient", g_c,
                     g_1, g_1n, GRAD_CHUNK_RTOL)


def phase_four_gpus(width, height, spp, max_depth, train_spp,
                    train_depth=None, meshes=((4, 1), (2, 2), (1, 4))):
    """Phase 6: the sharded forward and train paths on four devices
    against one device."""
    from rrt_tpu.parallel.mesh import make_mesh, render_image_queue_sharded

    devices = jax.devices()[:4]
    if len(devices) < 4:
        raise NoGPUError(f"needs 4 devices, found {len(devices)}")
    scene, camera = SCENES["chap12"](width, height)
    cfg = RenderConfig(width=width, height=height, spp=spp,
                       max_depth=max_depth)
    single, n_single = jax.block_until_ready(
        render_image_queue(*jax.device_put((scene, camera), devices[0]),
                           cfg, 0))
    single = np.asarray(single)
    diffs, walls = {}, {}
    for dp, sp in meshes:
        mesh = make_mesh(devices=devices, dp=dp, sp=sp)
        img, nt = jax.block_until_ready(
            render_image_queue_sharded(scene, camera, cfg, 0, mesh))
        if len(img.sharding.device_set) != 4:
            raise AssertionError(f"({dp},{sp}) image sits on "
                                 f"{len(img.sharding.device_set)} devices")
        t0 = time.time()
        jax.block_until_ready(
            render_image_queue_sharded(scene, camera, cfg, 0, mesh))
        walls[f"{dp}x{sp}"] = round(time.time() - t0, 4)
        diffs[f"{dp}x{sp}"] = float(np.abs(np.asarray(img) - single).max())
    bound = SHARD_ATOL_REL * float(single.max())

    tcfg = RenderConfig(width=width, height=height, spp=train_spp,
                        max_depth=train_depth or max_depth)
    target = jnp.full((height, width, 3), 0.25, jnp.float32)
    _, g_1 = grads_on(devices[0], scene, camera, target, tcfg)
    _, g_1n = grads_on(devices[0], scene, nudged(camera), target, tcfg)
    mesh = make_mesh(devices=devices, dp=2, sp=2)
    _, g_m = jax.block_until_ready(_loss_and_grad(
        partition(scene), camera, scene, target, cfg=tcfg, seed=0,
        mesh=mesh))
    peaks = [peak_bytes(d) for d in devices]
    report("four_gpus chap12",
           size=f"{width}x{height}@{spp}spp depth {max_depth}",
           max_abs_diff_vs_one_card=diffs, bound=bound,
           smoke_sharded_wall_s=walls,
           train=f"{train_spp}spp depth {tcfg.max_depth} on (2,2)",
           devices=[str(d) for d in devices],
           smoke_peak_bytes_in_use=peaks)
    if any(v > bound for v in diffs.values()):
        raise AssertionError(f"sharded image differs: {diffs} > {bound}")
    screened_compare("four_gpus chap12: (2,2) vs one-card gradient", g_m,
                     g_1, g_1n, GRAD_CHUNK_RTOL)
    # The CPU backend reports no memory stats (None); a GPU must.
    busy = all(peaks) or devices[0].platform == "cpu"
    if len({d.id for d in devices}) != 4 or not busy:
        raise AssertionError(f"shards not on 4 busy devices: {peaks}")


def result_line(rec: dict) -> str:
    """The last output line: the run passed, on this device."""
    return json.dumps({"ok": True, "device": {
        "platform": rec["platform"], "kind": rec["kind"],
        "count": rec["count"]}})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the four-GPU sharded phase")
    args = ap.parse_args(argv)
    enable_persistent_cache()
    rec = check_device(count=4 if args.four_gpus else 1)
    if args.four_gpus:
        phase_four_gpus(1200, 800, 32, 50, train_spp=8)
    else:
        with tempfile.TemporaryDirectory() as out_dir:
            phase_forward("chap12", 1200, 800, 32, 50, out_dir)
            phase_forward("rttnw_final", 400, 267, 32, 50, out_dir)
        phase_train(1200, 800, 8, 50)
        phase_chunked(1200, 800, 32, 16)
    print(result_line(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
