"""BVH acceleration: host-side PBRT-style builder + flattened arrays +
batched stack traversal.

Parity component for the reference's `Bvh` (reference:
src/acceleration.rs:96-273): same Middle-partition build with EqualCount
fallback on degenerate splits, same conservative slab test padded by
1 + 2*gamma(3) (src/acceleration.rs:78, rrt_tpu.utils.fp), same
64-deep traversal stack with near-child-first ordering by direction sign
(src/acceleration.rs:221-272).

Design note (SURVEY.md §7 "hard parts" #1): a data-dependent stack walk
is hostile to a lockstep vector machine — every ray in a batch pays for
the deepest ray's walk, and the per-step node gathers are scalar-indexed.
The renderer's production path is therefore the dense (rays x slots)
sweep of geometry.intersect_all, plus the box primitive family for
box-heavy scenes. Whether per-ray traversal wins on a GPU at some scene
size is an open measurement (benchmarks/bvh_sweep.py; ROADMAP S5). This
module remains for (a) parity with the reference's component, and (b)
the CPU/test oracle ("keep the dead oracle alive", src/lib.rs:32-47
pattern — here BVH and brute force check each other).

Two improvements over the reference, made consciously:
  * the Middle->EqualCount fallback applies per split, not to the whole
    subtree (the reference permanently mutates `method` for the subtree,
    src/acceleration.rs:153,181);
  * leaves can hold up to `leaf_size` primitives (reference: exactly 1),
    which shrinks the tree ~4x.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .utils.fp import AABB_T_FAR_PAD
from .vec import V3

INF = 3.0e38


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BvhArrays:
    """Flattened BVH. Inner node: children in left/right, prim run empty.
    Leaf: left == -1, prims [prim_start, prim_start + prim_count)."""

    node_min: jax.Array  # (M,3)
    node_max: jax.Array  # (M,3)
    left: jax.Array  # (M,) i32, -1 for leaf
    right: jax.Array  # (M,) i32
    axis: jax.Array  # (M,) i32 split axis
    prim_start: jax.Array  # (M,) i32 into prim_order
    prim_count: jax.Array  # (M,) i32
    prim_order: jax.Array  # (P,) i32 primitive indices, leaf-contiguous

    @property
    def n_nodes(self) -> int:
        return self.left.shape[0]


def build_sphere_bvh(scene, leaf_size: int = 4,
                     method: str = "middle") -> BvhArrays:
    """Build over the scene's valid spheres (motion AABB = union of the
    endpoint boxes, reference src/sphere.rs:25-35)."""
    c0 = np.asarray(scene.sphere_c0)
    dc = np.asarray(scene.sphere_dc)
    r = np.abs(np.asarray(scene.sphere_radius))
    valid = np.asarray(scene.sphere_valid)
    ids = np.nonzero(valid)[0].astype(np.int32)
    lo = np.minimum(c0[ids] - r[ids, None], c0[ids] + dc[ids] - r[ids, None])
    hi = np.maximum(c0[ids] + r[ids, None], c0[ids] + dc[ids] + r[ids, None])
    return build_bvh(lo, hi, ids, leaf_size=leaf_size, method=method)


def build_bvh(prim_min: np.ndarray, prim_max: np.ndarray,
              prim_ids: np.ndarray, leaf_size: int = 4,
              method: str = "middle") -> BvhArrays:
    """Generic builder over primitive AABBs (host-side numpy, recursive —
    runs once per scene like the reference's Bvh::build,
    src/acceleration.rs:131-146)."""
    centroid = 0.5 * (prim_min + prim_max)
    n = len(prim_ids)
    nodes = []  # [min, max, left, right, axis, prim_start, prim_count]
    order: list[int] = []

    def emit(idx):
        nodes.append(idx)
        return len(nodes) - 1

    def rec(sel: np.ndarray) -> int:
        lo = prim_min[sel].min(axis=0)
        hi = prim_max[sel].max(axis=0)
        if len(sel) <= leaf_size:
            start = len(order)
            order.extend(prim_ids[sel].tolist())
            return emit([lo, hi, -1, -1, 0, start, len(sel)])
        cb_lo = centroid[sel].min(axis=0)
        cb_hi = centroid[sel].max(axis=0)
        axis = int(np.argmax(cb_hi - cb_lo))
        if method == "middle":
            mid = 0.5 * (cb_lo[axis] + cb_hi[axis])
            mask = centroid[sel, axis] < mid
            if mask.all() or not mask.any():
                # Degenerate split: per-split EqualCount fallback.
                ordr = np.argsort(centroid[sel, axis], kind="stable")
                half = len(sel) // 2
                left_sel = sel[ordr[:half]]
                right_sel = sel[ordr[half:]]
            else:
                left_sel = sel[mask]
                right_sel = sel[~mask]
        else:  # equal-count
            ordr = np.argsort(centroid[sel, axis], kind="stable")
            half = len(sel) // 2
            left_sel = sel[ordr[:half]]
            right_sel = sel[ordr[half:]]
        me = emit([lo, hi, -2, -2, axis, 0, 0])
        li = rec(left_sel)
        ri = rec(right_sel)
        nodes[me][2] = li
        nodes[me][3] = ri
        return me

    rec(np.arange(n))
    m = len(nodes)
    node_min = np.stack([nd[0] for nd in nodes]).astype(np.float32)
    node_max = np.stack([nd[1] for nd in nodes]).astype(np.float32)
    return BvhArrays(
        node_min=jnp.asarray(node_min), node_max=jnp.asarray(node_max),
        left=jnp.asarray([nd[2] for nd in nodes], dtype=jnp.int32),
        right=jnp.asarray([nd[3] for nd in nodes], dtype=jnp.int32),
        axis=jnp.asarray([nd[4] for nd in nodes], dtype=jnp.int32),
        prim_start=jnp.asarray([nd[5] for nd in nodes], dtype=jnp.int32),
        prim_count=jnp.asarray([nd[6] for nd in nodes], dtype=jnp.int32),
        prim_order=jnp.asarray(order, dtype=jnp.int32))


STACK_DEPTH = 64  # the reference proves 64 suffices (acceleration.rs:232)


def bvh_intersect_spheres(scene, bvh: BvhArrays, o: V3, d: V3, time,
                          t_min, t_max):
    """Closest sphere hit via batched BVH traversal.

    Each ray carries a STACK_DEPTH index stack; the loop runs until every
    ray's stack is empty. Contract identical to
    geometry.intersect_spheres: returns (t, idx) with t == INF for
    misses."""
    n = o.x.shape[0]
    inv_dx = 1.0 / d.x  # IEEE inf for zero components is correct here
    inv_dy = 1.0 / d.y
    inv_dz = 1.0 / d.z
    neg_x = inv_dx < 0.0
    neg_y = inv_dy < 0.0
    neg_z = inv_dz < 0.0

    c0 = V3.from_array(scene.sphere_c0)
    dc = V3.from_array(scene.sphere_dc)
    t0s = scene.sphere_t0
    inv_dt = scene.sphere_inv_dt
    radius = scene.sphere_radius

    # Static python int (the unrolled leaf-test count): computed on the
    # host copy so bvh can be closed over inside jit (ops on captured
    # constants are staged, not folded, so int(jnp.max(...)) would see a
    # tracer there).
    import numpy as _np
    max_leaf = int(_np.max(jax.device_get(bvh.prim_count)))

    def body(state):
        stack, sp, t_best, idx_best = state
        active = sp > 0
        sp_new = jnp.where(active, sp - 1, sp)
        node = stack[jnp.arange(n), jnp.maximum(sp_new, 0)]
        node = jnp.where(active, node, 0)

        nmin = V3.from_array(bvh.node_min).gather(node)
        nmax = V3.from_array(bvh.node_max).gather(node)
        # Conservative slab test (reference acceleration.rs:60-84).
        tx1 = (jnp.where(neg_x, nmax.x, nmin.x) - o.x) * inv_dx
        tx2 = (jnp.where(neg_x, nmin.x, nmax.x) - o.x) * inv_dx
        ty1 = (jnp.where(neg_y, nmax.y, nmin.y) - o.y) * inv_dy
        ty2 = (jnp.where(neg_y, nmin.y, nmax.y) - o.y) * inv_dy
        tz1 = (jnp.where(neg_z, nmax.z, nmin.z) - o.z) * inv_dz
        tz2 = (jnp.where(neg_z, nmin.z, nmax.z) - o.z) * inv_dz
        t_near = jnp.maximum(jnp.maximum(tx1, ty1),
                             jnp.maximum(tz1, t_min))
        t_far = jnp.minimum(
            jnp.minimum(tx2 * AABB_T_FAR_PAD, ty2 * AABB_T_FAR_PAD),
            jnp.minimum(tz2 * AABB_T_FAR_PAD,
                        jnp.minimum(t_max, t_best)))
        box_hit = active & (t_near <= t_far)

        is_leaf = bvh.left[node] == -1

        # --- leaf: test up to max_leaf primitives ------------------------
        do_leaf = box_hit & is_leaf
        start = bvh.prim_start[node]
        count = bvh.prim_count[node]
        t_b, i_b = t_best, idx_best
        for k in range(max_leaf):
            pid = bvh.prim_order[jnp.minimum(
                start + k, bvh.prim_order.shape[0] - 1)]
            use = do_leaf & (k < count)
            ci = V3(c0.x[pid], c0.y[pid], c0.z[pid])
            di = V3(dc.x[pid], dc.y[pid], dc.z[pid])
            f = (time - t0s[pid]) * inv_dt[pid]
            center = ci + di * f
            oc = o - center
            a = d.norm_sq()
            half_b = oc.dot(d)
            c_coef = oc.norm_sq() - radius[pid] ** 2
            disc = half_b * half_b - a * c_coef
            sq = jnp.sqrt(jnp.maximum(disc, 0.0))
            root0 = (-half_b - sq) / a
            root1 = (-half_b + sq) / a
            ok = use & (disc > 0.0)
            in0 = ok & (root0 > t_min) & (root0 < t_b)
            in1 = ok & (root1 > t_min) & (root1 < t_b)
            t_c = jnp.where(in0, root0, jnp.where(in1, root1, INF))
            better = t_c < t_b
            t_b = jnp.where(better, t_c, t_b)
            i_b = jnp.where(better, pid, i_b)

        # --- inner: push children, near child on top ---------------------
        do_inner = box_hit & ~is_leaf
        ax = bvh.axis[node]
        neg_axis = jnp.where(ax == 0, neg_x,
                             jnp.where(ax == 1, neg_y, neg_z))
        first = jnp.where(neg_axis, bvh.right[node], bvh.left[node])
        second = jnp.where(neg_axis, bvh.left[node], bvh.right[node])
        lanes = jnp.arange(n)
        push0 = jnp.where(do_inner, sp_new, -1)
        stack = stack.at[lanes, jnp.maximum(push0, 0)].set(
            jnp.where(do_inner, second, stack[lanes,
                                              jnp.maximum(push0, 0)]))
        push1 = jnp.where(do_inner, sp_new + 1, -1)
        stack = stack.at[lanes, jnp.maximum(push1, 0)].set(
            jnp.where(do_inner, first, stack[lanes,
                                             jnp.maximum(push1, 0)]))
        sp_out = jnp.where(do_inner, sp_new + 2, sp_new)
        return stack, sp_out, t_b, i_b

    def cond(state):
        return jnp.any(state[1] > 0)

    stack0 = jnp.zeros((n, STACK_DEPTH), jnp.int32)
    sp0 = jnp.ones((n,), jnp.int32)  # root (node 0) pre-pushed
    t0 = jnp.full((n,), INF, jnp.float32)
    i0 = jnp.zeros((n,), jnp.int32)
    _, _, t_best, idx_best = jax.lax.while_loop(
        cond, body, (stack0, sp0, t0, i0))
    return t_best, idx_best
