"""RTTNW (book 2) scenes: emissive lights, textures, instanced boxes and
constant-medium volumes. These cover the gap inventory (SURVEY.md §2.4) —
none of them exist in the reference, so the geometry/constants follow the
book itself (BASELINE configs #3-#5)."""

import math

import numpy as np

from ..camera import Camera
from ..scene import SceneBuilder


def simple_light_scene(nx: int, ny: int):
    """Two perlin-marble spheres and a quad light on a black background
    (RTTNW ch. 7.1)."""
    b = SceneBuilder()
    b.solid_background((0.0, 0.0, 0.0))
    noise = b.perlin(scale=4.0)
    marble = b.lambertian(noise)
    b.sphere((0.0, -1000.0, 0.0), 1000.0, marble)
    b.sphere((0.0, 2.0, 0.0), 2.0, marble)
    light = b.diffuse_light((4.0, 4.0, 4.0))
    b.quad((3.0, 1.0, -2.0), (2.0, 0.0, 0.0), (0.0, 2.0, 0.0), light)
    b.sphere((0.0, 7.0, 0.0), 2.0, light)
    cam = Camera.create(look_from=(26.0, 3.0, 6.0), look_at=(0.0, 2.0, 0.0),
                        fov_deg=20.0, aspect=nx / ny)
    return b.build(), cam


def _cornell_walls(b: SceneBuilder, light_emit, light_q, light_u, light_v):
    red = b.lambertian((0.65, 0.05, 0.05))
    white = b.lambertian((0.73, 0.73, 0.73))
    green = b.lambertian((0.12, 0.45, 0.15))
    light = b.diffuse_light(light_emit)
    b.quad((555.0, 0.0, 0.0), (0.0, 555.0, 0.0), (0.0, 0.0, 555.0), green)
    b.quad((0.0, 0.0, 0.0), (0.0, 555.0, 0.0), (0.0, 0.0, 555.0), red)
    b.quad(light_q, light_u, light_v, light)
    b.quad((0.0, 0.0, 0.0), (555.0, 0.0, 0.0), (0.0, 0.0, 555.0), white)
    b.quad((555.0, 555.0, 555.0), (-555.0, 0.0, 0.0), (0.0, 0.0, -555.0),
           white)
    b.quad((0.0, 0.0, 555.0), (555.0, 0.0, 0.0), (0.0, 555.0, 0.0), white)
    return white


def _cornell_camera(nx: int, ny: int) -> Camera:
    return Camera.create(look_from=(278.0, 278.0, -800.0),
                         look_at=(278.0, 278.0, 0.0), fov_deg=40.0,
                         aspect=nx / ny)


def cornell_box_scene(nx: int, ny: int):
    """The standard Cornell box with two rotate_y-instanced boxes
    (RTTNW ch. 8.2); the boxes land in the box primitive family with
    the rotation baked into cos/sin."""
    b = SceneBuilder()
    b.solid_background((0.0, 0.0, 0.0))
    white = _cornell_walls(b, (15.0, 15.0, 15.0), (213.0, 554.0, 227.0),
                           (130.0, 0.0, 0.0), (0.0, 0.0, 105.0))
    b.box((0.0, 0.0, 0.0), (165.0, 330.0, 165.0), white, rotate_y_deg=15.0,
          translate=(265.0, 0.0, 295.0))
    b.box((0.0, 0.0, 0.0), (165.0, 165.0, 165.0), white, rotate_y_deg=-18.0,
          translate=(130.0, 0.0, 65.0))
    return b.build(), _cornell_camera(nx, ny)


def cornell_smoke_scene(nx: int, ny: int):
    """Cornell box with the boxes swapped for smoke/fog constant media
    (RTTNW ch. 9.2)."""
    b = SceneBuilder()
    b.solid_background((0.0, 0.0, 0.0))
    _cornell_walls(b, (7.0, 7.0, 7.0), (113.0, 554.0, 127.0),
                   (330.0, 0.0, 0.0), (0.0, 0.0, 305.0))
    b.medium_box((0.0, 0.0, 0.0), (165.0, 330.0, 165.0), density=0.01,
                 albedo=(0.0, 0.0, 0.0), rotate_y_deg=15.0,
                 translate=(265.0, 0.0, 295.0))
    b.medium_box((0.0, 0.0, 0.0), (165.0, 165.0, 165.0), density=0.01,
                 albedo=(1.0, 1.0, 1.0), rotate_y_deg=-18.0,
                 translate=(130.0, 0.0, 65.0))
    return b.build(), _cornell_camera(nx, ny)


def _default_earth_image() -> np.ndarray:
    """Procedural stand-in for the book's earthmap.jpg (no bundled assets):
    latitude-banded colors so uv mapping is visually verifiable."""
    h, w = 128, 256
    v, u = np.mgrid[0:h, 0:w].astype(np.float32)
    u, v = u / (w - 1), v / (h - 1)
    land = (np.sin(u * 19.0) * np.sin(v * 13.0 + 2.0)) > 0.2
    img = np.empty((h, w, 3), np.float32)
    img[..., 0] = np.where(land, 0.2, 0.05)
    img[..., 1] = np.where(land, 0.55, 0.15)
    img[..., 2] = np.where(land, 0.2, 0.5)
    return img


def earth_scene(nx: int, ny: int, image: np.ndarray | None = None,
                image_resample: str = "nearest"):
    """A single image-textured sphere (RTTNW ch. 6). `image` replaces
    the procedural stand-in with a real (h,w,3) float [0,1] array (CLI:
    --texture earthmap.jpg); `image_resample` picks the atlas fit."""
    b = SceneBuilder()
    tex = b.image(_default_earth_image() if image is None else image,
                  resample=image_resample)
    b.sphere((0.0, 0.0, 0.0), 2.0, b.lambertian(tex))
    cam = Camera.create(look_from=(13.0, 2.0, 3.0), look_at=(0.0, 0.0, 0.0),
                        fov_deg=20.0, aspect=nx / ny)
    return b.build(), cam


def rttnw_final_scene(nx: int, ny: int, seed: int = 0,
                      image: np.ndarray | None = None,
                      ablate: frozenset = frozenset(),
                      image_resample: str = "nearest"):
    """RTTNW ch. 10 final scene: ground of random-height boxes, quad light,
    motion blur, glass/metal/subsurface spheres, earth and perlin textures,
    global fog, and a rotated-translated cloud of 1000 spheres.

    `ablate` (any of {"earth", "perlin", "media", "boxes", "cloud"})
    drops a feature while keeping every RNG draw, for per-feature
    step-cost attribution (benchmarks/rttnw_ablation.py) — NOT a
    rendering mode. Texture ablations substitute solid colors so the
    kernel's has_images/has_perlin flags go statically false."""
    rs = np.random.RandomState(seed)
    b = SceneBuilder()
    b.solid_background((0.0, 0.0, 0.0))

    ground = b.lambertian((0.48, 0.83, 0.53))
    for i in range(20):
        for j in range(20):
            w = 100.0
            x0, z0 = -1000.0 + i * w, -1000.0 + j * w
            y1 = float(rs.uniform(1.0, 101.0))
            if "boxes" not in ablate:
                b.box((x0, 0.0, z0), (x0 + w, y1, z0 + w), ground)

    light = b.diffuse_light((7.0, 7.0, 7.0))
    b.quad((123.0, 554.0, 147.0), (300.0, 0.0, 0.0), (0.0, 0.0, 265.0),
           light)

    b.moving_sphere((400.0, 400.0, 200.0), (430.0, 400.0, 200.0), 0.0, 1.0,
                    50.0, b.lambertian((0.7, 0.3, 0.1)))
    glass = b.dielectric(1.5)
    b.sphere((260.0, 150.0, 45.0), 50.0, glass)
    b.sphere((0.0, 150.0, 145.0), 50.0, b.metal((0.8, 0.8, 0.9), fuzz=1.0))

    # Subsurface sphere: glass boundary + interior constant medium.
    b.sphere((360.0, 150.0, 145.0), 70.0, glass)
    if "media" not in ablate:
        b.medium_sphere((360.0, 150.0, 145.0), 70.0, density=0.2,
                        albedo=(0.2, 0.4, 0.9))
        # Global fog over the whole scene.
        b.medium_sphere((0.0, 0.0, 0.0), 5000.0, density=1.0e-4,
                        albedo=(1.0, 1.0, 1.0))

    earth_tex = (b.lambertian((0.4, 0.3, 0.2)) if "earth" in ablate
                 else b.lambertian(b.image(
                     _default_earth_image() if image is None else image,
                     resample=image_resample)))
    b.sphere((400.0, 200.0, 400.0), 100.0, earth_tex)
    per_tex = (b.lambertian((0.5, 0.5, 0.5)) if "perlin" in ablate
               else b.lambertian(b.perlin(scale=0.1)))
    b.sphere((220.0, 280.0, 300.0), 80.0, per_tex)

    # 1000-sphere cloud, instanced rotate_y(15) + translate(-100,270,395):
    # baked into the centers (a rotated sphere is a sphere).
    white = b.lambertian((0.73, 0.73, 0.73))
    ang = math.radians(15.0)
    c, s = math.cos(ang), math.sin(ang)
    for _ in range(1000):
        x, y, z = rs.uniform(0.0, 165.0, size=3)
        if "cloud" in ablate:
            continue
        rx = c * x + s * z - 100.0
        rz = -s * x + c * z + 395.0
        b.sphere((float(rx), float(y + 270.0), float(rz)), 10.0, white)

    cam = Camera.create(look_from=(478.0, 278.0, -600.0),
                        look_at=(278.0, 278.0, 0.0), fov_deg=40.0,
                        aspect=nx / ny, time0=0.0, time1=1.0)
    return b.build(), cam
