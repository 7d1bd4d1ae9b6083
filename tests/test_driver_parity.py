"""The two forward drivers agree on every book scene: the compacted queue
(render_image_queue) and the batch driver (render_image, the
differentiable path's driver) compute the identical radiance for every
(pixel, sample), because every random draw is keyed by (seed, pixel,
sample, bounce). With one sample per pixel the images compare sample by
sample; a queue smaller than the image forces refills and compaction."""

import numpy as np
import pytest

import rrt_tpu
from rrt_tpu.render import render_image_queue
from rrt_tpu.scenes import SCENES


@pytest.mark.parametrize("name", sorted(SCENES))
def test_queue_matches_batch_per_sample(name):
    cfg = rrt_tpu.RenderConfig(width=12, height=8, spp=1, max_depth=6,
                               tile_pixels=96, samples_per_pass=1,
                               queue_size=64)
    scene, cam = SCENES[name](cfg.width, cfg.height)
    img_b, n_b = rrt_tpu.render_image(scene, cam, cfg, 3)
    img_q, n_q = render_image_queue(scene, cam, cfg, 3)
    np.testing.assert_allclose(np.asarray(img_q), np.asarray(img_b),
                               atol=1e-5, rtol=1e-5)
    assert int(n_q) == int(n_b)
