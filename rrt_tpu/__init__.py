"""rrt_tpu — a differentiable Monte Carlo path tracer in JAX.

A from-scratch JAX rebuild of the capabilities of jfroy/rrt (RTIOW +
RTTNW), designed wavefront-first: iterative bounce loops over megabatches
of rays with stream compaction, branchless material scatter,
counter-based threefry randomness, shard_map data/sample parallelism over
a device mesh, and path-replay-style rematerialized gradients. XLA
compiles it for the accelerator (an NVIDIA GPU) or the CPU.
"""

from .camera import Camera, generate_rays
from .geometry import Hit, intersect_all, make_hit
from .materials import Scatter, scatter
from .render import (RenderConfig, background_color, render_image,
                     render_image_diff, render_image_queue, render_tile,
                     tonemap, trace_batch, trace_queue)
from .scene import SceneArrays, SceneBuilder
from .vec import V3

__version__ = "0.1.0"
