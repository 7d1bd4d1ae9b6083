"""The chunked trainer (diff.loss_and_grad_chunked) and the memory budget
that decides when a train step chunks (diff.resolve_spp_chunk).

The image is linear in per-chunk radiance and every sample is keyed by
its global (pixel, sample) id, so the chunked loss and gradient equal the
one-shot ones up to f32 summation order, for any chunk count and any
("dp","sp") mesh."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rrt_tpu
from rrt_tpu import diff
from rrt_tpu.diff import (loss_and_grad_chunked, make_train_step,
                          partition, render_loss, resolve_spp_chunk)
from rrt_tpu.parallel.mesh import make_mesh
from rrt_tpu.render import CARRY_BYTES_PER_RAY, diff_residual_bytes
from rrt_tpu.scenes import chap11_scene

CFG = rrt_tpu.RenderConfig(width=16, height=8, spp=8, max_depth=3,
                           tile_pixels=64, samples_per_pass=2)


@pytest.fixture(scope="module")
def problem():
    scene, cam = chap11_scene(CFG.width, CFG.height)
    target = jnp.full((CFG.height, CFG.width, 3), 0.3, jnp.float32)
    loss, grads = jax.value_and_grad(render_loss, argnums=(0, 1))(
        partition(scene), cam, scene, target, CFG, 0, None)
    return scene, cam, target, float(loss), grads


def _assert_same(loss, grads, ref_loss, ref_grads):
    np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-5)
    total = 0.0
    for a, b in zip(jax.tree.leaves(grads), jax.tree.leaves(ref_grads)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-6)
        total += float(jnp.sum(jnp.abs(b)))
    assert total > 0.0  # gradients actually flowed


@pytest.mark.parametrize("n_chunks", [1, 2, 4])
def test_chunked_matches_oneshot(problem, n_chunks):
    scene, cam, target, ref_loss, ref_grads = problem
    fn = loss_and_grad_chunked(CFG, spp_chunk=CFG.spp // n_chunks)
    assert fn.spp_chunk * n_chunks == CFG.spp
    loss, grads = fn(scene, cam, target, 0)
    _assert_same(loss, grads, ref_loss, ref_grads)


@pytest.mark.parametrize("dp,sp", [(2, 1), (1, 2), (2, 2)])
def test_chunked_matches_oneshot_on_mesh(problem, dp, sp):
    scene, cam, target, ref_loss, ref_grads = problem
    mesh = make_mesh(devices=jax.devices()[:dp * sp], dp=dp, sp=sp)
    # Two chunks of 4 samples: each splits into 2 passes over sp.
    fn = loss_and_grad_chunked(CFG, spp_chunk=4, mesh=mesh)
    loss, grads = fn(scene, cam, target, 0)
    _assert_same(loss, grads, ref_loss, ref_grads)


# resolve_spp_chunk against a budget in units of one sample's residual.
BUDGET_CFG = rrt_tpu.RenderConfig(width=64, height=32, spp=32,
                                  max_depth=9, tile_pixels=512,
                                  samples_per_pass=4)
PER_SAMPLE = diff_residual_bytes(BUDGET_CFG, 1)


@pytest.mark.parametrize("budget,expected", [
    (None, 32),                      # no limit reported: one chunk
    (1000 * PER_SAMPLE, 32),         # everything fits
    (32 * PER_SAMPLE, 32),           # exactly fits
    (31 * PER_SAMPLE, 16),           # largest divisor of 32, x4, that fits
    (8.5 * PER_SAMPLE, 8),
    (4 * PER_SAMPLE, 4),
])
def test_resolve_spp_chunk_budget(budget, expected):
    assert resolve_spp_chunk(BUDGET_CFG, budget_bytes=budget) == expected


def test_resolve_spp_chunk_rejects_what_cannot_fit_or_divide():
    with pytest.raises(ValueError, match="budget"):
        resolve_spp_chunk(BUDGET_CFG, budget_bytes=3 * PER_SAMPLE)
    with pytest.raises(ValueError, match="spp_chunk=6"):
        resolve_spp_chunk(BUDGET_CFG, spp_chunk=6)
    assert resolve_spp_chunk(BUDGET_CFG, spp_chunk=8) == 8


def test_resolve_spp_chunk_per_device_on_mesh():
    """A (dp, sp) mesh splits pixels over dp and samples over sp, so each
    device holds a dp*sp-th of the residual; chunks stay multiples of
    samples_per_pass * sp."""
    mesh = make_mesh(devices=jax.devices()[:4], dp=2, sp=2)
    assert resolve_spp_chunk(BUDGET_CFG, mesh=mesh,
                             budget_bytes=8.5 * PER_SAMPLE) == 32
    assert resolve_spp_chunk(BUDGET_CFG, mesh=mesh,
                             budget_bytes=4 * PER_SAMPLE) == 16
    with pytest.raises(ValueError, match="spp_chunk=4"):
        resolve_spp_chunk(BUDGET_CFG, spp_chunk=4, mesh=mesh)


def test_diff_residual_bytes_formula():
    """Carry bytes x (max_depth + 1) x padded pixels x samples."""
    cfg = dataclasses.replace(BUDGET_CFG, width=60, height=10,
                              tile_pixels=256)
    padded = 3 * 256  # 600 pixels in three 256-pixel tiles
    assert diff_residual_bytes(cfg, 5) == (
        CARRY_BYTES_PER_RAY * (cfg.max_depth + 1) * padded * 5)
    # dp=2 pads the tile count to 4: two tiles per shard.
    assert diff_residual_bytes(cfg, 5, dp=2) == (
        CARRY_BYTES_PER_RAY * (cfg.max_depth + 1) * 512 * 5)


class _Dev:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("stats,expected", [
    ([None], None),                                    # the CPU
    ([{"bytes_in_use": 0}], None),
    ([{"bytes_limit": 60_000_000_000}], 30_000_000_000),
    ([{"bytes_limit": 60_000_000_000},
      {"bytes_limit": 40_000_000_000}], 20_000_000_000),  # smallest card
])
def test_residual_budget_from_bytes_limit(stats, expected):
    devs = [_Dev(s) for s in stats]
    assert diff.residual_budget_bytes(devs) == expected


@pytest.mark.parametrize("budget_samples,chunked", [(None, False),
                                                    (2, True)])
def test_make_train_step_chunks_when_residual_exceeds_budget(
        monkeypatch, problem, budget_samples, chunked):
    scene, cam, target, _, _ = problem
    budget = (None if budget_samples is None
              else budget_samples * diff_residual_bytes(CFG, 1))
    monkeypatch.setattr(diff, "residual_budget_bytes",
                        lambda devices=None: budget)
    step = make_train_step(CFG, lr=1e-3)
    if chunked:
        assert step.spp_chunk == 2
    else:
        assert hasattr(step, "lower")  # one jitted device call
    s2, c2, loss0 = step(scene, cam, target, 0)
    _, _, loss1 = step(s2, c2, target, 0)
    assert float(loss1) < float(loss0)
