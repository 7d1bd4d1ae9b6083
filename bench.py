"""Benchmark of the renderer's main paths on one GPU.

Prints one JSON record line, re-emitted after EVERY phase (the consumer
takes the last parseable line), and exits non-zero if any phase failed or
the device is not a GPU. Every record names the device: JAX's platform,
device kind and device count, and nvidia-smi's name and power limit.

Phases (the XLA wavefront paths):
  - forward through the compacted-queue driver: chap12 1200x800 @ 32 spp,
    cornell 400x400 and rttnw_final 400x267 (exact and rr_depth=4);
  - the 8-spp train step (the batch driver's rematerialized scan) at
    1200x800, single-device and on a (dp=1, sp=1) mesh;
  - the 500-spp train step, exact and rr_depth=4, chunked by the device's
    memory (diff.make_train_step).

Every timing is the median of N post-warmup iterations with the min/max
spread reported; phases whose wall is under FAST_WALL_S get median-of-9.
A wall budget (RRT_BENCH_WALL_S, default 540 s) skips phases whose
estimated cost no longer fits, recording them in `skipped`; a SIGTERM
emits the record and exits non-zero.

RRT_BENCH_FORCE_CPU=1 runs on the CPU backend: a hook for tests only.
"""

import json
import os
import signal
import statistics
import sys
import time
import traceback

N_ITERS = 5
N_ITERS_FAST = 9  # phases whose wall is < FAST_WALL_S
FAST_WALL_S = 0.5
WALL_BUDGET_S = float(os.environ.get("RRT_BENCH_WALL_S", "540"))

# Cells: chap12 at the reference's default resolution, the other book
# scenes at the sizes BASELINE.json lists.
WIDTH, HEIGHT, SPP, MAX_DEPTH = 1200, 800, 32, 50
SCENE_SIZES = (("cornell", (400, 400)), ("rttnw_final", (400, 267)))
TRAIN_SPP = 8
NORTH_STAR_SPP = 500

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


class Recorder:
    """Accumulates detail fields as phases complete and re-emits the
    full (partial) JSON record line after every phase, so a kill at any
    point costs only the unfinished phase."""

    def __init__(self, wall_budget_s=WALL_BUDGET_S):
        self.device = {}
        self.detail = {}
        self.errors = {}
        self.skipped = []
        self.phase_walls = {}
        self.wall_budget_s = wall_budget_s
        self.t0 = time.time()
        self.current = None

    def elapsed(self):
        return time.time() - self.t0

    def budget_left(self):
        return self.wall_budget_s - self.elapsed()

    def phase(self, name, fn, est_s=0.0):
        """Run fn(). Returns its value, or None after recording the
        failure (in `errors`) or the budget skip (in `skipped`). The
        record line is re-emitted either way."""
        if est_s and self.budget_left() < est_s:
            self.skipped.append(name)
            self.emit()
            return None
        self.current = name
        t_phase = time.time()
        out, err_tb = None, None
        try:
            out = fn()
        except Exception as e:  # noqa: BLE001 — record, keep measuring
            # format_exc() must run INSIDE the except block — the
            # exception state is cleared when it exits.
            err_tb = traceback.format_exc()
            self.errors[name] = "%s: %s" % (type(e).__name__,
                                            str(e).split("\n")[0][:300])
        self.current = None
        self.phase_walls[name] = round(time.time() - t_phase, 3)
        self.emit()
        if err_tb is not None:
            sys.stderr.write("bench phase %r failed:\n%s\n"
                             % (name, err_tb))
        return out

    def emit(self):
        d = dict(self.detail)
        d["phase_walls"] = dict(self.phase_walls)
        d["elapsed_s"] = round(self.elapsed(), 1)
        if self.skipped:
            d["skipped"] = list(self.skipped)
        rec = {"device": self.device, "detail": d}
        if self.errors:
            rec["errors"] = self.errors
        print(json.dumps(rec), flush=True)

    def exit_code(self):
        return 1 if self.errors else 0


def install_signal_handlers(rec):
    """Emit the current record and exit non-zero on SIGTERM/SIGINT —
    timeout(1) sends SIGTERM first; without this the whole record dies
    with the process. os._exit skips interpreter teardown."""
    def handler(signum, frame):
        name = {signal.SIGTERM: "SIGTERM",
                signal.SIGINT: "SIGINT"}.get(signum, "signal %d" % signum)
        rec.errors["signal"] = "%s after %.1f s%s" % (
            name, rec.elapsed(),
            " during phase %r" % rec.current if rec.current else "")
        rec.emit()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    signal.signal(signal.SIGTERM, handler)
    signal.signal(signal.SIGINT, handler)


def _timed(fn, n=None):
    """Median, min and max of n runs of fn(), each synced with
    block_until_ready. Defaults to N_ITERS; when the first run is under
    FAST_WALL_S the count is raised to N_ITERS_FAST."""
    import jax
    ts = []
    t0 = time.time()
    jax.block_until_ready(fn())
    ts.append(time.time() - t0)
    total = n or N_ITERS
    if ts[0] < FAST_WALL_S:
        total = max(total, N_ITERS_FAST)
    for _ in range(total - 1):
        t0 = time.time()
        jax.block_until_ready(fn())
        ts.append(time.time() - t0)
    return statistics.median(ts), min(ts), max(ts)


def main():
    rec = Recorder()
    install_signal_handlers(rec)
    d = rec.detail

    import jax
    if os.environ.get("RRT_BENCH_FORCE_CPU"):
        jax.config.update("jax_platforms", "cpu")
    from rrt_tpu.utils.cache import enable_persistent_cache
    from rrt_tpu.utils.device import (NoGPUError, device_record,
                                      nvidia_smi, require_gpu)
    enable_persistent_cache()

    rec.device.update(device_record(), nvidia_smi=nvidia_smi())
    try:
        require_gpu()
    except NoGPUError as e:
        if not os.environ.get("RRT_BENCH_FORCE_CPU"):
            rec.errors["device"] = str(e)
            rec.emit()
            return 2

    import dataclasses

    import jax.numpy as jnp

    from rrt_tpu.diff import make_train_step
    from rrt_tpu.parallel.mesh import make_mesh
    from rrt_tpu.render import RenderConfig, render_image_queue
    from rrt_tpu.scenes import (chap12_scene, cornell_box_scene,
                                rttnw_final_scene)

    d["iters"] = N_ITERS
    d["wall_budget_s"] = rec.wall_budget_s
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, spp=SPP,
                       max_depth=MAX_DEPTH)

    def build():
        t0 = time.time()
        scene, cam = chap12_scene(WIDTH, HEIGHT)
        jax.block_until_ready(scene.sphere_c0)
        d["scene_build_s"] = round(time.time() - t0, 3)
        return scene, cam

    built = rec.phase("scene_build", build)
    if built is None:
        rec.emit()
        return rec.exit_code()
    scene, cam = built

    def forward(name, sc, cm, c):
        def run():
            def fwd():
                return render_image_queue(sc, cm, c, 0)
            t0 = time.time()
            img, n = jax.block_until_ready(fwd())  # compile + warm
            d[name + "_first_call_s"] = round(time.time() - t0, 3)
            if not bool(jnp.all(jnp.isfinite(img))):
                raise FloatingPointError(f"{name}: non-finite radiance")
            med, lo, hi = _timed(fwd)
            d[name + "_s_median"] = round(med, 4)
            d[name + "_s_spread"] = [round(lo, 4), round(hi, 4)]
            d[name + "_mrays_per_s"] = round(float(n) / med / 1e6, 2)
            d[name + "_rays"] = float(n)
        return run

    rec.phase("forward_chap12", forward("chap12", scene, cam, cfg))
    for name, (w2, h2) in SCENE_SIZES:
        builder = {"cornell": cornell_box_scene,
                   "rttnw_final": rttnw_final_scene}[name]
        sc, cm = builder(w2, h2)
        c2 = dataclasses.replace(cfg, width=w2, height=h2)
        rec.phase("forward_" + name, forward(name, sc, cm, c2))
        if name == "rttnw_final":
            rec.phase("forward_rttnw_final_rr4",
                      forward("rttnw_final_rr4", sc, cm,
                              dataclasses.replace(c2, rr_depth=4)))

    cfg8 = dataclasses.replace(cfg, spp=TRAIN_SPP)
    target = jnp.zeros((HEIGHT, WIDTH, 3), jnp.float32)

    def train(name, c, mesh=None, n=3):
        def run():
            step = make_train_step(c, mesh=mesh)
            t0 = time.time()
            _, _, loss = jax.block_until_ready(step(scene, cam, target, 0))
            d[name + "_first_call_s"] = round(time.time() - t0, 3)
            if not bool(jnp.isfinite(loss)):
                raise FloatingPointError(f"{name}: non-finite loss")
            med, lo, hi = _timed(lambda: step(scene, cam, target, 0),
                                 n=n)
            d[name + "_s_median"] = round(med, 3)
            d[name + "_s_spread"] = [round(lo, 3), round(hi, 3)]
            d[name + "_spp_chunk"] = getattr(step, "spp_chunk", c.spp)
        return run

    rec.phase("train_8spp", train("train_8spp", cfg8, n=3))
    rec.phase("train_8spp_sharded_1x1",
              train("train_8spp_sharded_1x1", cfg8,
                    mesh=make_mesh(devices=jax.devices()[:1], dp=1, sp=1)))

    # The 500-spp steps run last: they cost the most. Their estimate
    # scales the measured 8-spp step (warm + one timed step).
    cfg500 = dataclasses.replace(cfg, spp=NORTH_STAR_SPP)
    for name, c in (("north_star_500spp", cfg500),
                    ("north_star_500spp_rr4",
                     dataclasses.replace(cfg500, rr_depth=4))):
        est = 2.0 * d.get("train_8spp_s_median", 0.0) * (
            NORTH_STAR_SPP / TRAIN_SPP)
        rec.phase(name, train(name, c, n=1), est_s=est)

    rec.emit()
    return rec.exit_code()


if __name__ == "__main__":
    sys.exit(main())
