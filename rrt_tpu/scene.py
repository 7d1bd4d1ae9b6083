"""Scene representation: host-side builder -> SoA device arrays.

The reference stores a `Vec<Sphere>` of boxed trait objects and dispatches
`hit`/`scatter` through vtables per ray (reference: src/scene.rs:5-8,
src/hittable.rs:5-8). That shape is hostile to a vector machine, so this
design compiles the whole scene into structure-of-arrays tensors once on
the host:

  * primitives are grouped into *families* (spheres, quads, constant media),
    each an SoA block padded to a multiple of 128 slots; intersection is batched per
    family and merged by argmin over t;
  * materials/textures are tables indexed by integer ids carried in the hit
    record — no dynamic dispatch anywhere on device;
  * instancing (translate / rotate_y) is baked into primitive parameters at
    build time (a rotated box is just six transformed parallelograms), so the
    hot loop never sees a transform.

Boxes are a first-class primitive family (center, half extents, baked
y-rotation) intersected by one slab test instead of the books' 6-quad
decomposition (RTTNW ch. 6.2) — on a vector machine one box slot costs
~1.4 quad evaluations but replaces six, which is what makes the
400-ground-box RTTNW final scene tractable. Boxes carrying image textures
still fall back to 6 quads (the quad uv parameterization is the books'
box-face uv). Constant media keep their boundary as an analytic sphere or
oriented box so the entry/exit interval has a closed form.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np

# Material type ids.
MAT_LAMBERTIAN = 0
MAT_METAL = 1
MAT_DIELECTRIC = 2
MAT_DIFFUSE_LIGHT = 3
MAT_ISOTROPIC = 4

# Texture type ids.
TEX_SOLID = 0
TEX_CHECKER = 1
TEX_PERLIN = 2  # marble-style: 0.5*(1+sin(scale*z + 10*turb(p)))
TEX_IMAGE = 3

# Background modes.
BG_SKY = 0  # vertical lerp between bg_bottom and bg_top (the RTIOW sky)
BG_SOLID = 1  # constant bg_bottom (RTTNW "black" scenes use (0,0,0))

# Constant-medium boundary types.
BOUND_SPHERE = 0
BOUND_OBB = 1

# Pad SoA families to multiples of 128 slots: scenes of similar size
# share array shapes, and so compiled programs.
_LANE = 128


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SceneArrays:
    """Device-resident scene. Every field is a differentiable leaf unless
    it is an integer id/valid table."""

    # Sphere family (covers moving spheres; dc == 0 for stationary).
    sphere_c0: jax.Array  # (S,3) center at time0
    sphere_dc: jax.Array  # (S,3) center1 - center0
    sphere_t0: jax.Array  # (S,)
    sphere_inv_dt: jax.Array  # (S,) 1/(time1-time0)
    sphere_radius: jax.Array  # (S,) may be negative (hollow glass trick)
    sphere_mat: jax.Array  # (S,) i32
    sphere_valid: jax.Array  # (S,) bool

    # Quad family (parallelograms: point Q, edge vectors u, v).
    quad_q: jax.Array  # (Q,3)
    quad_u: jax.Array  # (Q,3)
    quad_v: jax.Array  # (Q,3)
    quad_mat: jax.Array  # (Q,) i32
    quad_valid: jax.Array  # (Q,) bool

    # Box family (axis-aligned box with a baked world-Y rotation;
    # rotate-then-translate instancing folded into center/cos/sin).
    box_center: jax.Array  # (B,3)
    box_half: jax.Array  # (B,3)
    box_cos: jax.Array  # (B,) cos of the world-from-box Y rotation
    box_sin: jax.Array  # (B,)
    box_mat: jax.Array  # (B,) i32
    box_valid: jax.Array  # (B,) bool

    # Constant-medium family.
    med_btype: jax.Array  # (D,) i32 BOUND_*
    med_center: jax.Array  # (D,3)
    med_radius: jax.Array  # (D,)
    med_half: jax.Array  # (D,3) obb half extents
    med_rot: jax.Array  # (D,3,3) world-from-box rotation
    med_neg_inv_density: jax.Array  # (D,)
    med_mat: jax.Array  # (D,) i32
    med_valid: jax.Array  # (D,) bool

    # Material table.
    mat_type: jax.Array  # (K,) i32
    mat_tex: jax.Array  # (K,) i32 texture id (albedo or emission)
    mat_fuzz: jax.Array  # (K,)
    mat_ior: jax.Array  # (K,)

    # Texture table.
    tex_type: jax.Array  # (T,) i32
    tex_color1: jax.Array  # (T,3)
    tex_color2: jax.Array  # (T,3)
    tex_scale: jax.Array  # (T,)
    tex_image: jax.Array  # (T,) i32 index into the image atlas

    # Image atlas: all image textures resampled onto one (I,AH,AW,3) block.
    images: jax.Array  # (I,AH,AW,3)

    # Background.
    bg_mode: jax.Array  # () i32
    bg_bottom: jax.Array  # (3,) color at t=0 (or the solid color)
    bg_top: jax.Array  # (3,) color at t=1

    # Static capability flags (pytree metadata, not leaves): lets the traced
    # render loop skip whole primitive families / texture machinery for
    # scenes that do not use them, without any runtime branching.
    has_quads: bool = dataclasses.field(
        default=False, metadata=dict(static=True))
    has_boxes: bool = dataclasses.field(
        default=False, metadata=dict(static=True))
    # Any box with a non-identity rotation (compile-time gate for the
    # in-kernel rotation math).
    has_rot_boxes: bool = dataclasses.field(
        default=False, metadata=dict(static=True))
    has_media: bool = dataclasses.field(
        default=False, metadata=dict(static=True))
    has_perlin: bool = dataclasses.field(
        default=False, metadata=dict(static=True))
    has_images: bool = dataclasses.field(
        default=False, metadata=dict(static=True))
    has_emissive: bool = dataclasses.field(
        default=False, metadata=dict(static=True))
    has_moving: bool = dataclasses.field(
        default=False, metadata=dict(static=True))
    # True (unpadded) constant-medium count. Medium arrays pad to 8
    # slots, but draws are per-slot counter-addressed, so the
    # intersection loops only the active slots without shifting any RNG
    # stream.
    n_media_active: int = dataclasses.field(
        default=0, metadata=dict(static=True))

    @property
    def n_spheres(self) -> int:
        return self.sphere_radius.shape[0]

    @property
    def n_quads(self) -> int:
        return self.quad_q.shape[0]

    @property
    def n_boxes(self) -> int:
        return self.box_half.shape[0]

    @property
    def n_media(self) -> int:
        return self.med_radius.shape[0]


def _pad_to(n: int, lane: int = _LANE) -> int:
    return max(lane, ((n + lane - 1) // lane) * lane)


def resample_image(im: np.ndarray, ah: int, aw: int,
                   method: str = "nearest") -> np.ndarray:
    """Host-side (h,w,3) -> (ah,aw,3) resample. "nearest" preserves
    exact texel values (what the golden oracle samples); "bilinear"
    smooths real photographs. Used for the shared texture atlas grid
    (SceneBuilder.build) and the CLI's --texture-max cap."""
    f32 = np.float32
    im = np.asarray(im, f32)
    h, w = im.shape[:2]
    if (h, w) == (ah, aw):
        return im
    if method == "bilinear":
        yf = (np.arange(ah, dtype=np.float64) + 0.5) * h / ah - 0.5
        xf = (np.arange(aw, dtype=np.float64) + 0.5) * w / aw - 0.5
        y0 = np.clip(np.floor(yf).astype(np.int64), 0, h - 1)
        x0 = np.clip(np.floor(xf).astype(np.int64), 0, w - 1)
        y1 = np.minimum(y0 + 1, h - 1)
        x1 = np.minimum(x0 + 1, w - 1)
        ty = np.clip(yf - y0, 0.0, 1.0).astype(f32)[:, None, None]
        tx = np.clip(xf - x0, 0.0, 1.0).astype(f32)[None, :, None]
        top = (im[y0[:, None], x0[None, :]] * (1 - tx)
               + im[y0[:, None], x1[None, :]] * tx)
        bot = (im[y1[:, None], x0[None, :]] * (1 - tx)
               + im[y1[:, None], x1[None, :]] * tx)
        return top * (1 - ty) + bot * ty
    yi = (np.arange(ah) * h // ah).clip(0, h - 1)
    xi = (np.arange(aw) * w // aw).clip(0, w - 1)
    return im[yi[:, None], xi[None, :]]


def _rot_y(deg: float) -> np.ndarray:
    r = math.radians(deg)
    c, s = math.cos(r), math.sin(r)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]],
                    dtype=np.float32)


class SceneBuilder:
    """Host-side scene construction; `build()` freezes to SceneArrays.

    Mirrors the constructive surface of the reference scene builders
    (reference: src/chap12.rs:9-115) plus the RTTNW feature set, but builds
    SoA arrays instead of boxed trait objects.
    """

    def __init__(self):
        self._spheres = []  # (c0, c1, t0, t1, radius, mat_id)
        self._quads = []  # (q, u, v, mat_id)
        self._boxes = []  # (center, half, cos, sin, mat_id)
        self._media = []  # (btype, center, radius, half, rot, nid, mat_id)
        self._materials = []  # (type, tex_id, fuzz, ior)
        self._textures = []  # (type, c1, c2, scale, image_idx)
        self._images = []  # list of (np (h,w,3) float array, resample)
        self.bg_mode = BG_SKY
        self.bg_bottom = (1.0, 1.0, 1.0)
        self.bg_top = (0.5, 0.7, 1.0)

    # -- textures ---------------------------------------------------------

    def _add_texture(self, ttype, c1=(0, 0, 0), c2=(0, 0, 0), scale=0.0,
                     image_idx=-1) -> int:
        self._textures.append((ttype, tuple(map(float, c1)),
                               tuple(map(float, c2)), float(scale),
                               int(image_idx)))
        return len(self._textures) - 1

    def solid(self, color) -> int:
        return self._add_texture(TEX_SOLID, c1=color)

    def checker(self, even, odd, scale: float = 10.0) -> int:
        return self._add_texture(TEX_CHECKER, c1=even, c2=odd, scale=scale)

    def perlin(self, scale: float = 1.0) -> int:
        return self._add_texture(TEX_PERLIN, c1=(1, 1, 1), scale=scale)

    def image(self, pixels: np.ndarray, resample: str = "nearest") -> int:
        """pixels: (h,w,3) float in [0,1]. `resample` picks how the image
        is fitted onto the shared atlas grid at build time when its
        dimensions differ from the atlas': "nearest" (default, preserves
        exact texel values — what the golden oracle samples) or
        "bilinear" (smoother for real photographs downsampled onto a
        small atlas)."""
        if resample not in ("nearest", "bilinear"):
            raise ValueError(f"resample must be nearest|bilinear, "
                             f"got {resample!r}")
        self._images.append((np.asarray(pixels, dtype=np.float32),
                             resample))
        return self._add_texture(TEX_IMAGE, image_idx=len(self._images) - 1)

    def _as_tex(self, color_or_tex) -> int:
        if isinstance(color_or_tex, int):
            return color_or_tex
        return self.solid(color_or_tex)

    # -- materials --------------------------------------------------------

    def _add_material(self, mtype, tex_id, fuzz=0.0, ior=1.0) -> int:
        self._materials.append((mtype, tex_id, float(fuzz), float(ior)))
        return len(self._materials) - 1

    def lambertian(self, albedo) -> int:
        return self._add_material(MAT_LAMBERTIAN, self._as_tex(albedo))

    def metal(self, albedo, fuzz: float = 0.0) -> int:
        return self._add_material(MAT_METAL, self._as_tex(albedo), fuzz=fuzz)

    def dielectric(self, ior: float) -> int:
        return self._add_material(MAT_DIELECTRIC, self.solid((1, 1, 1)),
                                  ior=ior)

    def diffuse_light(self, emit) -> int:
        return self._add_material(MAT_DIFFUSE_LIGHT, self._as_tex(emit))

    def isotropic(self, albedo) -> int:
        return self._add_material(MAT_ISOTROPIC, self._as_tex(albedo))

    # -- primitives -------------------------------------------------------

    def sphere(self, center, radius: float, mat_id: int):
        self._spheres.append((np.asarray(center, np.float32),
                              np.asarray(center, np.float32), 0.0, 1.0,
                              float(radius), mat_id))

    def moving_sphere(self, center0, center1, time0: float, time1: float,
                      radius: float, mat_id: int):
        self._spheres.append((np.asarray(center0, np.float32),
                              np.asarray(center1, np.float32), float(time0),
                              float(time1), float(radius), mat_id))

    def quad(self, q, u, v, mat_id: int, rotate_y_deg: float = 0.0,
             translate=(0.0, 0.0, 0.0)):
        """Parallelogram with corner q and edges u, v. Instance transforms
        are baked into the vertices (rotation about the world Y axis applied
        first, then translation — the book's `translate(rotate_y(...))`
        composition)."""
        q = np.asarray(q, np.float32)
        u = np.asarray(u, np.float32)
        v = np.asarray(v, np.float32)
        if rotate_y_deg:
            r = _rot_y(rotate_y_deg)
            q, u, v = r @ q, r @ u, r @ v
        q = q + np.asarray(translate, np.float32)
        self._quads.append((q, u, v, mat_id))

    def box(self, corner0, corner1, mat_id: int, rotate_y_deg: float = 0.0,
            translate=(0.0, 0.0, 0.0)):
        """Axis-aligned box [corner0, corner1], optionally instanced
        (rotate about world Y, then translate — the books' composition).

        Lands in the box primitive family (one slab test) unless its
        material carries an image texture, in which case it is emitted as
        the books' 6 quads so face uv matches RTTNW ch. 6.2 exactly."""
        if self._mat_has_image(mat_id):
            self._box_as_quads(corner0, corner1, mat_id, rotate_y_deg,
                               translate)
            return
        a = np.minimum(np.asarray(corner0, np.float32),
                       np.asarray(corner1, np.float32))
        b = np.maximum(np.asarray(corner0, np.float32),
                       np.asarray(corner1, np.float32))
        r = math.radians(rotate_y_deg)
        c, s = np.float32(math.cos(r)), np.float32(math.sin(r))
        center = _rot_y(rotate_y_deg) @ (0.5 * (a + b)) \
            + np.asarray(translate, np.float32)
        self._boxes.append((center.astype(np.float32),
                            (0.5 * (b - a)).astype(np.float32), c, s,
                            mat_id))

    def _mat_has_image(self, mat_id: int) -> bool:
        tex = self._materials[mat_id][1]
        return self._textures[tex][0] == TEX_IMAGE

    def _box_as_quads(self, corner0, corner1, mat_id, rotate_y_deg,
                      translate):
        """The books' box = 6 parallelograms decomposition
        (/root/reference has no box; RTTNW listing 6.2)."""
        a = np.minimum(np.asarray(corner0, np.float32),
                       np.asarray(corner1, np.float32))
        b = np.maximum(np.asarray(corner0, np.float32),
                       np.asarray(corner1, np.float32))
        dx = np.array([b[0] - a[0], 0, 0], np.float32)
        dy = np.array([0, b[1] - a[1], 0], np.float32)
        dz = np.array([0, 0, b[2] - a[2]], np.float32)
        # RTTNW listing 6.2 face corners. (Round 1 shipped the right
        # face at z=min and the back face in the z=max plane — a real
        # geometry bug masked by the golden sharing this builder.)
        faces = [
            (np.array([a[0], a[1], b[2]], np.float32), dx, dy),  # front
            (np.array([b[0], a[1], b[2]], np.float32), -dz, dy),  # right
            (np.array([a[0], a[1], a[2]], np.float32), dz, dy),  # left
            (np.array([b[0], a[1], a[2]], np.float32), -dx, dy),  # back
            (np.array([a[0], b[1], b[2]], np.float32), dx, -dz),  # top
            (np.array([a[0], a[1], a[2]], np.float32), dx, dz),  # bottom
        ]
        for q, u, v in faces:
            self.quad(q, u, v, mat_id, rotate_y_deg=rotate_y_deg,
                      translate=translate)

    def medium_sphere(self, center, radius: float, density: float,
                      albedo) -> None:
        mat = self.isotropic(albedo)
        self._media.append((BOUND_SPHERE, np.asarray(center, np.float32),
                            float(radius), np.zeros(3, np.float32),
                            np.eye(3, dtype=np.float32),
                            -1.0 / float(density), mat))

    def medium_box(self, corner0, corner1, density: float, albedo,
                   rotate_y_deg: float = 0.0,
                   translate=(0.0, 0.0, 0.0)) -> None:
        a = np.minimum(np.asarray(corner0, np.float32),
                       np.asarray(corner1, np.float32))
        b = np.maximum(np.asarray(corner0, np.float32),
                       np.asarray(corner1, np.float32))
        center = 0.5 * (a + b)
        half = 0.5 * (b - a)
        rot = _rot_y(rotate_y_deg) if rotate_y_deg else np.eye(
            3, dtype=np.float32)
        center = rot @ center + np.asarray(translate, np.float32)
        mat = self.isotropic(albedo)
        self._media.append((BOUND_OBB, center, 0.0, half, rot,
                            -1.0 / float(density), mat))

    # -- background -------------------------------------------------------

    def sky(self, bottom=(1.0, 1.0, 1.0), top=(0.5, 0.7, 1.0)):
        self.bg_mode = BG_SKY
        self.bg_bottom, self.bg_top = tuple(bottom), tuple(top)

    def solid_background(self, color=(0.0, 0.0, 0.0)):
        self.bg_mode = BG_SOLID
        self.bg_bottom = self.bg_top = tuple(color)

    # -- freeze -----------------------------------------------------------

    def build(self) -> SceneArrays:
        f32, i32 = np.float32, np.int32

        ns = _pad_to(len(self._spheres))
        sphere_c0 = np.zeros((ns, 3), f32)
        sphere_dc = np.zeros((ns, 3), f32)
        sphere_t0 = np.zeros((ns,), f32)
        sphere_inv_dt = np.ones((ns,), f32)
        sphere_radius = np.full((ns,), 1.0, f32)
        sphere_mat = np.zeros((ns,), i32)
        sphere_valid = np.zeros((ns,), bool)
        for i, (c0, c1, t0, t1, r, m) in enumerate(self._spheres):
            sphere_c0[i] = c0
            sphere_dc[i] = c1 - c0
            sphere_t0[i] = t0
            sphere_inv_dt[i] = 1.0 / (t1 - t0) if t1 != t0 else 0.0
            sphere_radius[i] = r
            sphere_mat[i] = m
            sphere_valid[i] = True

        nq = _pad_to(len(self._quads))
        quad_q = np.zeros((nq, 3), f32)
        quad_u = np.tile(np.array([1, 0, 0], f32), (nq, 1))
        quad_v = np.tile(np.array([0, 1, 0], f32), (nq, 1))
        quad_mat = np.zeros((nq,), i32)
        quad_valid = np.zeros((nq,), bool)
        for i, (q, u, v, m) in enumerate(self._quads):
            quad_q[i], quad_u[i], quad_v[i] = q, u, v
            quad_mat[i] = m
            quad_valid[i] = True

        nb = _pad_to(len(self._boxes))
        box_center = np.zeros((nb, 3), f32)
        box_half = np.zeros((nb, 3), f32)
        box_cos = np.ones((nb,), f32)
        box_sin = np.zeros((nb,), f32)
        box_mat = np.zeros((nb,), i32)
        box_valid = np.zeros((nb,), bool)
        for i, (c, h, cth, sth, m) in enumerate(self._boxes):
            box_center[i], box_half[i] = c, h
            box_cos[i], box_sin[i] = cth, sth
            box_mat[i] = m
            box_valid[i] = True

        nd = _pad_to(len(self._media), lane=8)
        med_btype = np.zeros((nd,), i32)
        med_center = np.zeros((nd, 3), f32)
        med_radius = np.ones((nd,), f32)
        med_half = np.ones((nd, 3), f32)
        med_rot = np.tile(np.eye(3, dtype=f32), (nd, 1, 1))
        med_nid = np.full((nd,), -1.0, f32)
        med_mat = np.zeros((nd,), i32)
        med_valid = np.zeros((nd,), bool)
        for i, (bt, c, r, h, rot, nidv, m) in enumerate(self._media):
            med_btype[i], med_center[i], med_radius[i] = bt, c, r
            med_half[i], med_rot[i], med_nid[i], med_mat[i] = h, rot, nidv, m
            med_valid[i] = True

        if not self._materials:
            self._add_material(MAT_LAMBERTIAN, self.solid((0.5, 0.5, 0.5)))
        nk = len(self._materials)
        mat_type = np.array([m[0] for m in self._materials], i32)
        mat_tex = np.array([m[1] for m in self._materials], i32)
        mat_fuzz = np.array([m[2] for m in self._materials], f32)
        mat_ior = np.array([m[3] for m in self._materials], f32)
        del nk

        nt = len(self._textures)
        tex_type = np.array([t[0] for t in self._textures], i32)
        tex_color1 = np.array([t[1] for t in self._textures], f32).reshape(
            nt, 3)
        tex_color2 = np.array([t[2] for t in self._textures], f32).reshape(
            nt, 3)
        tex_scale = np.array([t[3] for t in self._textures], f32)
        tex_image = np.array([t[4] for t in self._textures], i32)

        if self._images:
            ah = max(im.shape[0] for im, _ in self._images)
            aw = max(im.shape[1] for im, _ in self._images)
            images = np.zeros((len(self._images), ah, aw, 3), f32)
            for i, (im, resample) in enumerate(self._images):
                # Resample onto the atlas grid so uv lookups need no
                # per-image shape metadata on device.
                images[i] = resample_image(im, ah, aw, resample)
        else:
            images = np.zeros((1, 1, 1, 3), f32)

        dev = lambda x: jnp.asarray(x)
        return SceneArrays(
            sphere_c0=dev(sphere_c0), sphere_dc=dev(sphere_dc),
            sphere_t0=dev(sphere_t0), sphere_inv_dt=dev(sphere_inv_dt),
            sphere_radius=dev(sphere_radius), sphere_mat=dev(sphere_mat),
            sphere_valid=dev(sphere_valid),
            quad_q=dev(quad_q), quad_u=dev(quad_u), quad_v=dev(quad_v),
            quad_mat=dev(quad_mat), quad_valid=dev(quad_valid),
            box_center=dev(box_center), box_half=dev(box_half),
            box_cos=dev(box_cos), box_sin=dev(box_sin),
            box_mat=dev(box_mat), box_valid=dev(box_valid),
            med_btype=dev(med_btype), med_center=dev(med_center),
            med_radius=dev(med_radius), med_half=dev(med_half),
            med_rot=dev(med_rot), med_neg_inv_density=dev(med_nid),
            med_mat=dev(med_mat), med_valid=dev(med_valid),
            mat_type=dev(mat_type), mat_tex=dev(mat_tex),
            mat_fuzz=dev(mat_fuzz), mat_ior=dev(mat_ior),
            tex_type=dev(tex_type), tex_color1=dev(tex_color1),
            tex_color2=dev(tex_color2), tex_scale=dev(tex_scale),
            tex_image=dev(tex_image),
            images=dev(images),
            bg_mode=jnp.asarray(self.bg_mode, jnp.int32),
            bg_bottom=jnp.asarray(self.bg_bottom, jnp.float32),
            bg_top=jnp.asarray(self.bg_top, jnp.float32),
            has_quads=bool(self._quads),
            has_boxes=bool(self._boxes),
            has_rot_boxes=bool(
                any(abs(float(s)) > 0.0 for (_, _, _, s, _)
                    in self._boxes)),
            has_media=bool(self._media),
            has_perlin=bool((tex_type == TEX_PERLIN).any()),
            has_images=bool(self._images),
            has_emissive=bool((mat_type == MAT_DIFFUSE_LIGHT).any()),
            has_moving=bool(np.abs(sphere_dc).max() > 0.0)
            if len(self._spheres) else False,
            n_media_active=len(self._media),
        )

def boxes_as_quads(center, half, cos_t, sin_t, mat, valid):
    """Expand box-family slots into the books' 6-quad decomposition
    (host-side numpy). Used by the golden oracles, which keep the
    quad-only scene representation: a box hit by the device's slab test
    and the same box's six faces hit by the golden's quad test agree on
    (t, outward normal) up to f32 rounding.

    Returns (q, u, v, mat6, n_valid*6) arrays for the valid boxes."""
    center = np.asarray(center, np.float32)
    half = np.asarray(half, np.float32)
    cos_t = np.asarray(cos_t, np.float32)
    sin_t = np.asarray(sin_t, np.float32)
    mat = np.asarray(mat, np.int32)
    valid = np.asarray(valid, bool)
    qs, us, vs, ms = [], [], [], []
    for i in np.flatnonzero(valid):
        h = half[i]
        a = -h
        b = h
        dx = np.array([2 * h[0], 0, 0], np.float32)
        dy = np.array([0, 2 * h[1], 0], np.float32)
        dz = np.array([0, 0, 2 * h[2]], np.float32)
        faces = [
            (np.array([a[0], a[1], b[2]], np.float32), dx, dy),  # front
            (np.array([b[0], a[1], b[2]], np.float32), -dz, dy),  # right
            (np.array([a[0], a[1], a[2]], np.float32), dz, dy),  # left
            (np.array([b[0], a[1], a[2]], np.float32), -dx, dy),  # back
            (np.array([a[0], b[1], b[2]], np.float32), dx, -dz),  # top
            (np.array([a[0], a[1], a[2]], np.float32), dx, dz),  # bottom
        ]
        c, s = cos_t[i], sin_t[i]
        rot = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]],
                       np.float32)
        for q, u, v in faces:
            qs.append(rot @ q + center[i])
            us.append(rot @ u)
            vs.append(rot @ v)
            ms.append(mat[i])
    if not qs:
        z = np.zeros((0, 3), np.float32)
        return z, z, z, np.zeros((0,), np.int32)
    return (np.stack(qs).astype(np.float32),
            np.stack(us).astype(np.float32),
            np.stack(vs).astype(np.float32),
            np.asarray(ms, np.int32))


