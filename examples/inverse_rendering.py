"""Inverse rendering demo: recover material parameters from a target image.

Renders a ground-truth image, perturbs both albedos, then optimizes them
back with Adam over the differentiable render. Material/texture gradients
are exact interior gradients; geometry gradients are silhouette-blind by
construction (detached sampling), so geometry recovery needs an edge-aware
loss and is out of scope for this demo. Run on CPU or GPU:

    python examples/inverse_rendering.py [--cpu]
"""

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--steps", type=int, default=120)
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import optax

    import rrt_tpu
    from rrt_tpu.camera import Camera
    from rrt_tpu.diff import combine, partition, render_loss
    from rrt_tpu.scene import SceneBuilder

    cfg = rrt_tpu.RenderConfig(width=48, height=32, spp=8, max_depth=5,
                               tile_pixels=48 * 32, samples_per_pass=4)

    def make_scene(albedo, center):
        b = SceneBuilder()
        b.sphere(center, 0.5, b.lambertian(albedo))
        b.sphere((0.0, -100.5, -1.0), 100.0, b.lambertian((0.5, 0.5, 0.5)))
        return b.build()

    cam = Camera.create(look_from=(0.0, 0.2, 1.0), look_at=(0.0, 0.0, -1.0),
                        fov_deg=55.0, aspect=cfg.width / cfg.height)

    truth = make_scene((0.7, 0.2, 0.1), (0.0, 0.0, -1.0))
    target, _ = rrt_tpu.render_image(truth, cam, cfg, 0)

    scene = make_scene((0.2, 0.5, 0.6), (0.0, 0.0, -1.0))
    full = partition(scene)
    params = {"tex_color1": full["tex_color1"]}  # optimize albedos only

    def loss_fn(p):
        return render_loss({**full, **p}, cam, scene, target, cfg, 0,
                           None)

    opt = optax.adam(5e-2)
    opt_state = opt.init(params)
    loss_grad = jax.jit(jax.value_and_grad(loss_fn))

    t0 = time.time()
    for i in range(args.steps):
        loss, g = loss_grad(params)
        updates, opt_state = opt.update(g, opt_state)
        params = optax.apply_updates(params, updates)
        params["tex_color1"] = jnp.clip(params["tex_color1"], 0.0, 1.0)
        if i % 20 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {float(loss):.6f}  "
                  f"albedo {np.asarray(params['tex_color1'][0]).round(3)}",
                  flush=True)

    albedo = np.asarray(params["tex_color1"][0])
    ground = np.asarray(params["tex_color1"][1])
    print(f"\nrecovered sphere albedo {albedo.round(3)} (truth 0.7 0.2 0.1)")
    print(f"recovered ground albedo {ground.round(3)} (truth 0.5 0.5 0.5)")
    print(f"{args.steps} fwd+bwd steps in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
