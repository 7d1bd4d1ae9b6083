"""Russian-roulette A/B on the queue driver, on one GPU.

Default mode: for each headline scene, renders the full image with
rr_depth in {0 (off), 4, 8} and reports wall time, Mrays/s, traced
rays, and the mean-abs image difference vs the exact-termination render
(RR is unbiased, so the diff is pure Monte-Carlo variance; the
adopt/reject call compares wall-time savings against that noise at
equal spp).

--curve mode: an error-vs-wall curve against a CONVERGED golden
(4100 spp, exact termination, independent seed) for chap12 and
rttnw_final: per rr_depth in {0, 4, 8}, the 32-spp render's wall time
and its MSE vs the golden, and the seconds per image at matched error.

Run: python benchmarks/rr_ab.py [--curve]
"""

import dataclasses
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from rrt_tpu.utils.cache import enable_persistent_cache  # noqa: E402
from rrt_tpu.utils.device import nvidia_smi, require_gpu  # noqa: E402


def sync(out):
    return jax.block_until_ready(out)


def timed(fn, n=3):
    """Warm + median of n (one helper for BOTH modes, so the timing
    discipline cannot drift between them)."""
    sync(fn())
    ts = []
    for _ in range(n):
        t0 = time.time()
        sync(fn())
        ts.append(time.time() - t0)
    return statistics.median(ts)


def main():
    from rrt_tpu.render import RenderConfig, render_image_queue
    from rrt_tpu.scenes import (book2chap2_scene, chap12_scene,
                                rttnw_final_scene)

    results = {}
    for name, builder, (w, h) in (
            ("chap12", chap12_scene, (1200, 800)),
            ("book2chap2", book2chap2_scene, (1200, 800)),
            ("rttnw_final", rttnw_final_scene, (400, 267))):
        scene, cam = builder(w, h)
        base = RenderConfig(width=w, height=h, spp=32, max_depth=50)
        row = {}
        img0 = None
        for rr in (0, 4, 8):
            cfg = dataclasses.replace(base, rr_depth=rr)

            def fn(cfg=cfg):
                return render_image_queue(scene, cam, cfg, 0)

            img, n = sync(fn())
            med = timed(fn)
            key = f"rr{rr}"
            row[key] = {
                "wall_s": round(med, 4),
                "mrays_per_s": round(float(n) / med / 1e6, 2),
                "traced_mrays": round(float(n) / 1e6, 2),
            }
            a = np.asarray(img)
            if rr == 0:
                img0 = a
                row[key]["img_mean"] = round(float(a.mean()), 5)
            else:
                row[key]["meandiff_vs_rr0"] = round(
                    float(np.abs(a - img0).mean()), 6)
                row[key]["relmeandiff"] = round(
                    float(np.abs(a - img0).mean() / max(img0.mean(),
                                                        1e-9)), 5)
                row[key]["speedup_vs_rr0"] = round(
                    row["rr0"]["wall_s"] / med, 3)
        results[name] = row
    print(json.dumps(results, indent=1))


def curve():
    """Error-vs-wall vs a converged golden."""
    from rrt_tpu.render import RenderConfig, render_image_queue, trace_queue
    from rrt_tpu.scenes import chap12_scene, rttnw_final_scene

    GOLDEN_SPP, CHUNK = 4100, 100  # 41 x 100-spp device calls
    results = {}
    for name, builder, (w, h) in (
            ("chap12", chap12_scene, (1200, 800)),
            ("rttnw_final", rttnw_final_scene, (400, 267))):
        scene, cam = builder(w, h)
        cfg_g = RenderConfig(width=w, height=h, spp=GOLDEN_SPP,
                             max_depth=50)
        ids = jnp.arange(w * h, dtype=jnp.int32)
        # Traced sample bounds: every chunk shares one compilation.
        chunk_fn = jax.jit(lambda lo, hi: trace_queue(
            scene, cam, ids % w, ids // w, cfg_g, jax.random.key(0), lo,
            hi))
        t0 = time.time()
        acc = None
        for lo in range(0, GOLDEN_SPP, CHUNK):
            r, _ = chunk_fn(lo, lo + CHUNK)
            r = np.asarray(r)  # sync + keep accumulation on host
            acc = r if acc is None else acc + r
        golden = (acc / GOLDEN_SPP).reshape(h, w, 3)
        row = {"golden_spp": GOLDEN_SPP,
               "golden_wall_s": round(time.time() - t0, 1)}
        base = RenderConfig(width=w, height=h, spp=32, max_depth=50)
        for rr in (0, 4, 8):
            cfg = dataclasses.replace(base, rr_depth=rr)

            def fn(cfg=cfg):
                # seed 7: independent of the golden's sample set, so
                # the MSE estimates the render's own variance without
                # shared-sample correlation.
                return render_image_queue(scene, cam, cfg, 7)

            img, n = sync(fn())
            med = timed(fn)
            mse = float(((np.asarray(img) - golden) ** 2).mean())
            row[f"rr{rr}"] = {
                "spp": 32, "wall_s": round(med, 4),
                "mse_vs_golden": round(mse, 8),
                "traced_mrays": round(float(n) / 1e6, 2),
            }
        for rr in (4, 8):
            row[f"rr{rr}"]["mse_ratio_vs_rr0"] = round(
                row[f"rr{rr}"]["mse_vs_golden"]
                / row["rr0"]["mse_vs_golden"], 4)
            row[f"rr{rr}"]["speedup_vs_rr0"] = round(
                row["rr0"]["wall_s"] / row[f"rr{rr}"]["wall_s"], 3)
            # seconds-per-image at matched error: RR is unbiased, so
            # MSE ~ variance/spp; scale the rr wall by the spp factor
            # that would equalize MSE with the exact render's.
            row[f"rr{rr}"]["matched_error_wall_s"] = round(
                row[f"rr{rr}"]["wall_s"]
                * row[f"rr{rr}"]["mse_ratio_vs_rr0"], 4)
            row[f"rr{rr}"]["matched_error_speedup"] = round(
                row["rr0"]["wall_s"]
                / row[f"rr{rr}"]["matched_error_wall_s"], 3)
        results[name] = row
    print(json.dumps(results, indent=1))


if __name__ == "__main__":
    enable_persistent_cache()
    print("device:", require_gpu(), "|", nvidia_smi(), flush=True)
    if "--curve" in sys.argv:
        curve()
    else:
        main()
