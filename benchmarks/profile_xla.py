"""Profile the XLA wavefront paths on one GPU: where the device time goes.

Two programs, each warmed, then traced with jax.profiler over a short
window:
  * forward — chap12 1200x800 @ 32 spp, depth 50, render_image_queue;
  * train   — chap12 1200x800 @ 8 spp, depth 50, the one-shot
              diff.make_train_step (the batch driver's scan).

For each it prints the wall time of the traced window, the device busy
and idle share (union of the device's op intervals over the window), the
top device operations by total time, and, from the optimized HLO, every
fusion whose output holds a (rays x primitive slots) matrix — such a
fusion writes the intersection candidates to device memory instead of
reducing them in registers.

Run: python benchmarks/profile_xla.py [--hlo FILE] [--top 15]
The traces are written to a temporary directory and removed; --hlo keeps
the forward program's optimized HLO text.
"""

import argparse
import glob
import os
import re
import sys
import tempfile
import time
from collections import defaultdict

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))


def device_ops(trace_dir):
    """{line name: [(op name, start_ns, dur_ns), ...]} for the GPU device
    planes of the newest trace under trace_dir."""
    import jax
    paths = sorted(glob.glob(os.path.join(trace_dir, "plugins", "profile",
                                          "*", "*.xplane.pb")))
    if not paths:
        raise FileNotFoundError(f"no xplane trace under {trace_dir}")
    prof = jax.profiler.ProfileData.from_file(paths[-1])
    lines = {}
    for plane in prof.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            evs = [(e.name, e.start_ns, e.duration_ns) for e in line.events]
            if evs:
                lines[f"{plane.name} | {line.name}"] = evs
    return lines


def busy_share(events, t0, t1):
    """Union of event intervals clipped to [t0, t1], over t1 - t0."""
    iv = sorted((max(s, t0), min(s + d, t1)) for _, s, d in events
                if s + d > t0 and s < t1)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / max(t1 - t0, 1)


def summarize(name, trace_dir, wall_s, top):
    lines = device_ops(trace_dir)
    print(f"== {name}: traced window wall {wall_s:.4f} s", flush=True)
    for lname, evs in sorted(lines.items(), key=lambda kv: -len(kv[1])):
        t0 = min(s for _, s, _ in evs)
        t1 = max(s + d for _, s, d in evs)
        tot = defaultdict(float)
        cnt = defaultdict(int)
        for n, _, d in evs:
            tot[n] += d
            cnt[n] += 1
        total = sum(tot.values())
        print(f"-- {lname}: {len(evs)} events, span {(t1 - t0) / 1e9:.4f}"
              f" s, busy share over span {busy_share(evs, t0, t1):.4f}, "
              f"summed op time {total / 1e9:.4f} s")
        for n, d in sorted(tot.items(), key=lambda kv: -kv[1])[:top]:
            print(f"   {d / 1e6:10.3f} ms {100 * d / total:6.2f}% "
                  f"x{cnt[n]:<6d} {n[:110]}")


def wide_fusions(hlo_text, q, s_dims):
    """Fusion instructions with a result shape (of possibly several) that
    has a dimension equal to the ray batch `q` and another in `s_dims`
    (primitive slot counts)."""
    out = []
    pat = re.compile(r"^\s*(\S+) = (.+?) fusion\(")
    for line in hlo_text.splitlines():
        m = pat.match(line)
        if not m:
            continue
        for shape in re.findall(r"\[([\d,]+)\]", m.group(2)):
            dims = [int(x) for x in shape.split(",")]
            if q in dims and any(sd in dims for sd in s_dims):
                out.append(f"{m.group(1)} = {m.group(2)}")
                break
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--hlo", default=None,
                    help="write the forward program's optimized HLO here")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from rrt_tpu.diff import make_train_step
    from rrt_tpu.render import RenderConfig, render_image_queue
    from rrt_tpu.scenes import chap12_scene
    from rrt_tpu.utils.cache import enable_persistent_cache
    from rrt_tpu.utils.device import nvidia_smi, require_gpu

    enable_persistent_cache()
    print("device:", require_gpu(), "|", nvidia_smi(), flush=True)
    scene, cam = chap12_scene(1200, 800)
    s_dims = (scene.n_spheres, scene.n_quads)

    cfg = RenderConfig(width=1200, height=800, spp=32, max_depth=50)
    fwd = render_image_queue.lower(scene, cam, cfg, 0).compile()
    hlo = fwd.as_text()
    if args.hlo:
        with open(args.hlo, "w") as f:
            f.write(hlo)
    wide = wide_fusions(hlo, cfg.queue_size, s_dims)
    print(f"forward: {len(wide)} fusions output a (queue {cfg.queue_size}"
          f" x slots {s_dims}) matrix:")
    for w in wide[:20]:
        print("   ", w)
    jax.block_until_ready(fwd(scene, cam, 0))
    with tempfile.TemporaryDirectory() as d:
        jax.profiler.start_trace(d)
        t0 = time.time()
        jax.block_until_ready(fwd(scene, cam, 0))
        wall = time.time() - t0
        jax.profiler.stop_trace()
        summarize("forward chap12 1200x800@32spp (queue)", d, wall,
                  args.top)

    cfg8 = RenderConfig(width=1200, height=800, spp=8, max_depth=50)
    target = jnp.zeros((800, 1200, 3), jnp.float32)
    step = make_train_step(cfg8)
    comp = step.lower(scene, cam, target, 0).compile()
    hlo_t = comp.as_text()
    tile_rays = cfg8.tile_pixels * cfg8.samples_per_pass
    wide_t = wide_fusions(hlo_t, tile_rays, s_dims)
    print(f"train: {len(wide_t)} fusions output a (tile rays {tile_rays}"
          f" x slots {s_dims}) matrix:")
    for w in wide_t[:20]:
        print("   ", w)
    print("train memory:", comp.memory_analysis(), flush=True)
    jax.block_until_ready(comp(scene, cam, target, 0))
    with tempfile.TemporaryDirectory() as d:
        jax.profiler.start_trace(d)
        t0 = time.time()
        jax.block_until_ready(comp(scene, cam, target, 0))
        wall = time.time() - t0
        jax.profiler.stop_trace()
        summarize("train chap12 1200x800@8spp (scan)", d, wall, args.top)


if __name__ == "__main__":
    main()
