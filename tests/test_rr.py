"""Russian-roulette termination (RenderConfig.rr_depth).

Past rr_depth bounces a path continues with p = clamp(max throughput
component, 0.05, 1) and the survivor's throughput is divided by p — the
estimator stays unbiased while the depth-50 straggler tail is cut to the
throughput-weighted effective depth. Every driver honors it, including
the differentiable scan: the kill replays like any other discrete
decision and the 1/p weight is detached (gradient check in
test_grad_families.py). Default off: goldens keep exact
depth-termination.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from rrt_tpu.render import RenderConfig, render_image, render_image_queue
from rrt_tpu.scenes import SCENES, cornell_box_scene, diffuse_scene


def test_rr_unbiased_mean():
    """At high spp the RR image must converge to the exact-termination
    image: compare means over a small diffuse render. 256 spp gives
    sub-percent Monte-Carlo noise on this scene; the tolerance is set
    well above it but far below any systematic bias RR could introduce
    (a wrong 1/p weight shifts bounce-2+ energy by tens of percent)."""
    scene, cam = diffuse_scene(24, 14)
    base = RenderConfig(width=24, height=14, spp=256, max_depth=12,
                        tile_pixels=24 * 14, samples_per_pass=4)
    img0, _ = render_image(scene, cam, base, 0)
    import dataclasses
    rr = dataclasses.replace(base, rr_depth=2)
    img1, n1 = render_image(scene, cam, rr, 0)
    m0 = float(jnp.mean(img0))
    m1 = float(jnp.mean(img1))
    assert abs(m1 - m0) / m0 < 0.02, (m0, m1)
    # and RR actually fired: fewer rays traced at equal spp
    _, n0 = render_image(scene, cam, base, 0)
    assert float(n1) < float(n0)


@pytest.mark.parametrize("name", ["chap11", "cornell", "cornell_smoke"])
def test_rr_driver_parity(name):
    """With rr_depth set, the XLA queue driver and the batch driver
    produce the same image and trace the same rays — the RR draw is
    counter-addressed identically in both."""
    scene, cam = SCENES[name](16, 9)
    cfg = RenderConfig(width=16, height=9, spp=4, max_depth=8,
                       queue_size=256, tile_pixels=16 * 9,
                       samples_per_pass=4, rr_depth=2)
    img_q, n_q = render_image_queue(scene, cam, cfg, 0)
    img_b, n_b = render_image(scene, cam, cfg, 0)
    a, b = np.asarray(img_q), np.asarray(img_b)
    assert np.abs(a - b).max() < 1e-4, np.abs(a - b).max()
    assert int(n_q) == int(n_b)


def test_rr_reduces_traced_rays_on_cornell():
    """Cornell paths bounce until depth (enclosed box): RR must cut the
    traced-ray count substantially at rr_depth=3."""
    scene, cam = cornell_box_scene(12, 12)
    import dataclasses
    cfg = RenderConfig(width=12, height=12, spp=2, max_depth=20,
                       tile_pixels=144, samples_per_pass=2,
                       queue_size=288)
    _, n0 = render_image_queue(scene, cam, cfg, 0)
    _, n1 = render_image_queue(
        scene, cam, dataclasses.replace(cfg, rr_depth=3), 0)
    assert float(n1) < 0.8 * float(n0), (float(n0), float(n1))
