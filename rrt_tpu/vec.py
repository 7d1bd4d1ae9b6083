"""Component-SoA 3-vectors: the wavefront renderer's vector layout.

Vectors are stored as three separate `(N,)` arrays, bundled in this
NamedTuple so the physics code stays readable. Every elementwise op then
runs over the long batch dimension with unit-stride, unpadded loads, and
no op ever reduces or shuffles across a length-3 minor axis.

The reference's ultraviolet Vec4 (w-padded for 4-wide SIMD,
src/types.rs:6-7) is the same idea for a 4-lane CPU; on a wide vector
machine the batch dimension provides the lanes and per-component arrays
are the layout that doesn't waste them.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp


class V3(NamedTuple):
    x: jax.Array
    y: jax.Array
    z: jax.Array

    # -- arithmetic -------------------------------------------------------

    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    def dot(self, o: "V3"):
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "V3") -> "V3":
        return V3(self.y * o.z - self.z * o.y,
                  self.z * o.x - self.x * o.z,
                  self.x * o.y - self.y * o.x)

    def norm_sq(self):
        return self.dot(self)

    def norm(self):
        return jnp.sqrt(jnp.maximum(self.norm_sq(), 0.0))

    def normalized(self, eps: float = 1e-20) -> "V3":
        inv = jax.lax.rsqrt(jnp.maximum(self.norm_sq(), eps))
        return self * inv

    # -- structural -------------------------------------------------------

    @staticmethod
    def where(mask, a: "V3", b: "V3") -> "V3":
        return V3(jnp.where(mask, a.x, b.x), jnp.where(mask, a.y, b.y),
                  jnp.where(mask, a.z, b.z))

    @staticmethod
    def full(shape, value, dtype=jnp.float32) -> "V3":
        f = jnp.full(shape, value, dtype)
        return V3(f, f, f)

    @staticmethod
    def zeros(shape, dtype=jnp.float32) -> "V3":
        return V3.full(shape, 0.0, dtype)

    @staticmethod
    def ones(shape, dtype=jnp.float32) -> "V3":
        return V3.full(shape, 1.0, dtype)

    @staticmethod
    def from_array(a) -> "V3":
        """(..., 3) array -> V3 of (...,) components."""
        return V3(a[..., 0], a[..., 1], a[..., 2])

    @staticmethod
    def from_rows(rows) -> "V3":
        """(3, N) stacked rows -> V3."""
        return V3(rows[0], rows[1], rows[2])

    def to_array(self):
        """V3 -> (..., 3). Only for API boundaries — materializes the
        padded layout."""
        return jnp.stack([self.x, self.y, self.z], axis=-1)

    def gather(self, idx) -> "V3":
        return V3(self.x[idx], self.y[idx], self.z[idx])

    def astype(self, dtype) -> "V3":
        return V3(self.x.astype(dtype), self.y.astype(dtype),
                  self.z.astype(dtype))
