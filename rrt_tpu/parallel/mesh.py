"""Distributed rendering: mesh construction + shard_map render step.

This module *is* the communication backend (SURVEY.md §2.3/§5.8): there is
no custom transport — sharding choices and XLA collectives live here so
every cross-device byte is visible in one place.

Mesh axes (SURVEY.md §2.2 mapping):
  "dp"  — data parallel over pixel tiles (embarrassing; no communication
           until image assembly, which stays sharded anyway);
  "sp"  — the tensor-parallel analog: the samples-per-pixel dimension.
           Every sp-rank renders the same pixels at spp/sp samples and the
           radiance accumulator is `psum`ed over "sp" on device.

The bounce chain itself is deliberately device-local (the
sequence-parallel non-decision, SURVEY.md §5.7): bounces are cheap and
sequential, so scaling rides the enormous (tiles x samples) batch axes
instead. Two more conscious non-decisions from the strategy inventory
(SURVEY.md §2.2): pipeline parallelism (staging bounce k of tile i against
bounce k-1 of tile i+1) buys nothing when there are no weights to
partition and every stage runs the same code; and expert parallelism
(materials-as-experts with cross-device dispatch) degenerates for five
material models into the branchless compute-all-and-select of
rrt_tpu.materials, with zero communication.

Every shard_map here runs with the static varying-manual-axes checker on
(check_vma=True): the shared drivers cast their loop-carry inits varying
(rrt_tpu.utils.vma.vary_for_mesh).

Determinism: tile/pass random keys are global ids, so the rendered image is
a pure function of (seed, tile grid, spp) — identical across any dp x sp
mesh factorization, up to f32 psum ordering.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..camera import Camera
from ..render import (RenderConfig, _as_key, _check_passes, render_tile,
                      tile_grid, trace_queue)
from ..scene import SceneArrays

_LOOPBACK_HOSTS = ("localhost", "127.0.0.1", "[::1]", "::1")


def initialize_distributed(coordinator_address: str, num_processes: int,
                           process_id: int, local_device_ids=None):
    """Multi-process bring-up (SURVEY.md §2.3): every process calls this
    before any other jax op; afterwards jax.devices() spans every
    process's devices and the same Mesh/shard_map code runs unchanged,
    with XLA inserting the collectives (NVLink within a host, the
    network across hosts).

    local_device_ids restricts the GPUs this process opens. A JAX process
    reserves most of each card's memory when it first uses it, so several
    processes on one host must not all open every card. When the
    coordinator is a loopback address every process runs on this host,
    and the default gives process i the card i — one process per card.
    Otherwise the default opens every local card (one process per host).
    On the CPU backend the ids are ignored."""
    if local_device_ids is None and num_processes > 1:
        host = coordinator_address.rsplit(":", 1)[0]
        if host in _LOOPBACK_HOSTS:
            local_device_ids = [process_id]
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=local_device_ids)


def make_mesh(devices=None, dp: int | None = None, sp: int | None = None):
    """Build a ("dp", "sp") mesh over the given devices.

    Defaults: all sample-parallel for a handful of devices would starve
    tile parallelism, so we split evenly-ish: sp = largest power-of-two
    <= sqrt.
    """
    devices = jax.devices() if devices is None else devices
    n = len(devices)
    if dp is None and sp is None:
        sp = 1
        while sp * 2 <= max(1, int(n ** 0.5)):
            sp *= 2
        dp = n // sp
    elif dp is None:
        dp = n // sp
    elif sp is None:
        sp = n // dp
    if dp * sp != n:
        raise ValueError(f"dp*sp={dp * sp} != device count {n}")
    return Mesh(np.asarray(devices).reshape(dp, sp), ("dp", "sp"))


@partial(jax.jit, static_argnames=("cfg", "mesh", "differentiable",
                                   "n_passes"))
def render_image_sharded(scene: SceneArrays, camera: Camera,
                         cfg: RenderConfig, seed, mesh: Mesh,
                         differentiable: bool = False, pass_start=0,
                         n_passes: int | None = None):
    """Render over the mesh through the batch driver. Returns
    (image (H,W,3) mean radiance over the rendered samples, n_traced).

    pass_start (traced) / n_passes select the sample sub-range, as in
    render.render_image; the passes split evenly over "sp".

    The returned image is materialized (unsharded) — callers that want to
    keep shards on-device (checkpointing, progressive preview) should use
    the tile-level API directly.
    """
    all_passes = _check_passes(cfg)
    if n_passes is None:
        n_passes = all_passes
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    if n_passes % sp != 0:
        raise ValueError(f"passes={n_passes} (spp/samples_per_pass) must "
                         f"be a multiple of the sp axis ({sp})")
    local_passes = n_passes // sp

    seed_key = _as_key(seed)
    px, py, n_tiles, tp = tile_grid(cfg, dp)
    local_tiles = n_tiles // dp

    def shard_fn(px_l, py_l, scene, camera, seed_key, pass_start):
        sp_rank = jax.lax.axis_index("sp")

        def do_tile(i):
            return render_tile(scene, camera, px_l[i], py_l[i], cfg,
                               seed_key,
                               pass_start=pass_start
                               + sp_rank * local_passes,
                               n_passes=local_passes,
                               differentiable=differentiable)

        # lax.scan, not lax.map: map's internal output buffer is an
        # invariant init written with varying tile results, which the vma
        # verifier rejects; scan's stacked ys take their type from the
        # body output directly.
        _, (rad, nt) = jax.lax.scan(
            lambda c, i: (c, do_tile(i)), jnp.zeros((), jnp.int32),
            jnp.arange(local_tiles, dtype=jnp.int32))
        # Sample-dimension reduction on device — the "TP" psum.
        rad = jax.lax.psum(rad, "sp")
        nt = jax.lax.psum(jnp.sum(nt), ("dp", "sp"))
        return rad, nt

    rad, n_traced = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P("dp"), P("dp"), P(), P(), P(), P()),
        out_specs=(P("dp"), P()))(
            px, py, scene, camera, seed_key,
            jnp.asarray(pass_start, jnp.int32))

    rad = rad.reshape(n_tiles * tp, 3)[: cfg.width * cfg.height]
    image = rad.reshape(cfg.height, cfg.width, 3) / jnp.float32(
        n_passes * cfg.samples_per_pass)
    return image, n_traced


def render_image_diff_sharded(scene: SceneArrays, camera: Camera,
                              cfg: RenderConfig, seed, mesh: Mesh):
    """Differentiable full-image render over the mesh (the
    rematerialized-scan batch driver). Scene and camera enter replicated,
    so the shard_map transpose all-reduces their gradients across the
    mesh. Returns (image (H,W,3) mean radiance, n_traced)."""
    return render_image_sharded(scene, camera, cfg, seed, mesh,
                                differentiable=True)


@partial(jax.jit, static_argnames=("cfg", "mesh"))
def render_image_queue_sharded(scene: SceneArrays, camera: Camera,
                               cfg: RenderConfig, seed, mesh: Mesh):
    """Multi-device forward rendering through the compacted-queue driver
    (the fast path): pixel rows shard over "dp", the spp range splits over
    "sp", radiance psums over "sp" on device.

    Per-sample keys are global (pixel, sample)-addressed, so the image
    equals the single-device queue render up to f32 summation order for
    any mesh factorization."""
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    if cfg.spp % sp != 0:
        raise ValueError(f"spp={cfg.spp} must be a multiple of sp={sp}")
    spp_local = cfg.spp // sp

    seed_key = _as_key(seed)
    n_pix = cfg.width * cfg.height
    n_pad = -(-n_pix // dp) * dp
    ids = jnp.minimum(jnp.arange(n_pad, dtype=jnp.int32), n_pix - 1)
    px = (ids % cfg.width).reshape(dp, n_pad // dp)
    py = (ids // cfg.width).reshape(dp, n_pad // dp)

    def shard_fn(px_l, py_l, scene, camera, seed_key):
        sp_rank = jax.lax.axis_index("sp")
        rad, nt = trace_queue(scene, camera, px_l[0], py_l[0], cfg,
                              seed_key, sp_rank * spp_local,
                              sp_rank * spp_local + spp_local,
                              queue_size=min(cfg.queue_size,
                                             (n_pad // dp) * spp_local))
        rad = jax.lax.psum(rad, "sp")
        nt = jax.lax.psum(nt, ("dp", "sp"))
        return rad[None], nt

    rad, n_traced = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P("dp"), P("dp"), P(), P(), P()),
        out_specs=(P("dp"), P()))(
            px, py, scene, camera, seed_key)

    rad = rad.reshape(n_pad, 3)[:n_pix]
    image = rad.reshape(cfg.height, cfg.width, 3) / jnp.float32(cfg.spp)
    return image, n_traced
