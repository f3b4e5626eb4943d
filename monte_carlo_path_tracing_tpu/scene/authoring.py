"""Procedural authoring of cg23-format scenes (OBJ + MTL + XML).

The reference's scene assets are not in its repo (quirk Q14: the
example-scenes zip is a stripped blob), so the required scenes are authored
here in the documented cg23 format: a cornell-box (BASELINE configs[0]) and a
Veach-MIS-style scene — four plates of increasing shininess lit by four
emitters of varying size — at the reference's ~3,092-facet scale
(README.md:212). Output is plain text written by scripts/make_scenes.py and
committed under scenes/; the loaders treat authored and external cg23 scenes
identically.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Sequence, Tuple

Vec3 = Tuple[float, float, float]


class MeshWriter:
    """Accumulates v/vn/f records grouped by material and emits OBJ text."""

    def __init__(self) -> None:
        self.vertices: List[Vec3] = []
        self.normals: List[Vec3] = []
        self.faces: List[Tuple[str, Tuple[int, int, int], Tuple[int, int, int]]] = []

    def add_vertex(self, p: Vec3, n: Vec3) -> int:
        self.vertices.append(p)
        self.normals.append(n)
        return len(self.vertices)  # 1-based

    def add_tri(self, mtl: str, vi: Tuple[int, int, int], ni: Tuple[int, int, int]) -> None:
        self.faces.append((mtl, vi, ni))

    def add_quad_grid(
        self, mtl: str, origin: Vec3, du: Vec3, dv: Vec3, nu: int, nv: int
    ) -> None:
        """Tessellated parallelogram origin + s*du + t*dv, s,t in [0,1].

        Normal = normalize(du x dv); 2*nu*nv triangles.
        """
        n = _normalize(_cross(du, dv))
        idx = {}
        for j in range(nv + 1):
            for i in range(nu + 1):
                p = tuple(
                    origin[k] + du[k] * (i / nu) + dv[k] * (j / nv) for k in range(3)
                )
                idx[(i, j)] = self.add_vertex(p, n)  # type: ignore[arg-type]
        for j in range(nv):
            for i in range(nu):
                a, b = idx[(i, j)], idx[(i + 1, j)]
                c, d = idx[(i + 1, j + 1)], idx[(i, j + 1)]
                self.add_tri(mtl, (a, b, c), (a, b, c))
                self.add_tri(mtl, (a, c, d), (a, c, d))

    def add_icosphere(self, mtl: str, center: Vec3, radius: float, subdiv: int) -> None:
        verts, tris = _icosphere(subdiv)
        base = len(self.vertices)
        for v in verts:
            p = tuple(center[k] + radius * v[k] for k in range(3))
            self.add_vertex(p, v)  # type: ignore[arg-type]  # normal = unit position
        for (a, b, c) in tris:
            vi = (base + a + 1, base + b + 1, base + c + 1)
            self.add_tri(mtl, vi, vi)

    def obj_text(self, mtllib: str) -> str:
        out = [f"mtllib {mtllib}"]
        out += [f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}" for p in self.vertices]
        out += [f"vn {n[0]:.6f} {n[1]:.6f} {n[2]:.6f}" for n in self.normals]
        cur = None
        for mtl, vi, ni in self.faces:
            if mtl != cur:
                out.append(f"usemtl {mtl}")
                cur = mtl
            out.append(
                "f "
                + " ".join(f"{vi[k]}//{ni[k]}" for k in range(3))
            )
        return "\n".join(out) + "\n"


def _cross(a: Vec3, b: Vec3) -> Vec3:
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def _normalize(a: Vec3) -> Vec3:
    n = math.sqrt(sum(x * x for x in a)) or 1.0
    return (a[0] / n, a[1] / n, a[2] / n)


def _icosphere(subdiv: int):
    """Unit icosphere: icosahedron subdivided `subdiv` times (20*4^s tris)."""
    t = (1.0 + math.sqrt(5.0)) / 2.0
    verts = [
        (-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
        (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
        (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1),
    ]
    verts = [_normalize(v) for v in verts]
    tris = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    for _ in range(subdiv):
        cache: Dict[Tuple[int, int], int] = {}

        def midpoint(a: int, b: int) -> int:
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = _normalize(tuple((verts[a][k] + verts[b][k]) / 2 for k in range(3)))
                verts.append(m)
                cache[key] = len(verts) - 1
            return cache[key]

        new_tris = []
        for (a, b, c) in tris:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_tris += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        tris = new_tris
    return verts, tris


def _mtl_text(mats: Sequence[Tuple[str, Vec3, Vec3, float]]) -> str:
    out = []
    for name, kd, ks, ns in mats:
        out += [
            f"newmtl {name}",
            f"Kd {kd[0]} {kd[1]} {kd[2]}",
            f"Ks {ks[0]} {ks[1]} {ks[2]}",
            f"Ns {ns}",
            "",
        ]
    return "\n".join(out)


def _xml_text(
    camera: Tuple[Vec3, Vec3, Vec3, float, int, int],
    lights: Sequence[Tuple[str, Vec3]],
) -> str:
    eye, lookat, up, fovy, w, h = camera
    out = [
        f'<camera type="perspective" width="{w}" height="{h}" fovy="{fovy}">',
        f'\t<eye x="{eye[0]}" y="{eye[1]}" z="{eye[2]}"/>',
        f'\t<lookat x="{lookat[0]}" y="{lookat[1]}" z="{lookat[2]}"/>',
        f'\t<up x="{up[0]}" y="{up[1]}" z="{up[2]}"/>',
        "</camera>",
    ]
    for name, rad in lights:
        out.append(f'<light mtlname="{name}" radiance="{rad[0]},{rad[1]},{rad[2]}"/>')
    return "\n".join(out) + "\n"


def author_cornell_box() -> Dict[str, str]:
    """Cornell-box-style scene, BASELINE configs[0] (256x256, 16 spp ref).

    All quad normals (= cross(du, dv)) face the box interior; the light
    quad faces down (-y).
    """
    w = MeshWriter()
    # 2x2x2 box centred on origin-ish: x,z in [-1,1], y in [0,2]
    w.add_quad_grid("white_floor", (-1, 0, -1), (0, 0, 2), (2, 0, 0), 4, 4)
    w.add_quad_grid("white_ceiling", (-1, 2, -1), (2, 0, 0), (0, 0, 2), 4, 4)
    w.add_quad_grid("white_back", (-1, 0, -1), (2, 0, 0), (0, 2, 0), 4, 4)
    w.add_quad_grid("red_left", (-1, 0, 1), (0, 0, -2), (0, 2, 0), 4, 4)
    w.add_quad_grid("green_right", (1, 0, -1), (0, 0, 2), (0, 2, 0), 4, 4)
    # Tall box (rotated 17 deg) and short box (rotated -18 deg)
    _add_box(w, "white_box", (-0.35, 0.0, -0.35), 0.3, 1.2, math.radians(17))
    _add_box(w, "mirror_box", (0.4, 0.0, 0.35), 0.3, 0.6, math.radians(-18))
    # Ceiling light, facing down
    w.add_quad_grid("Light", (-0.25, 1.999, -0.25), (0.5, 0, 0), (0, 0, 0.5), 1, 1)

    mats = [
        ("white_floor", (0.73, 0.73, 0.73), (0, 0, 0), 1.0),
        ("white_ceiling", (0.73, 0.73, 0.73), (0, 0, 0), 1.0),
        ("white_back", (0.73, 0.73, 0.73), (0, 0, 0), 1.0),
        ("red_left", (0.65, 0.05, 0.05), (0, 0, 0), 1.0),
        ("green_right", (0.12, 0.45, 0.15), (0, 0, 0), 1.0),
        ("white_box", (0.73, 0.73, 0.73), (0, 0, 0), 1.0),
        ("mirror_box", (0.1, 0.1, 0.1), (0.7, 0.7, 0.7), 500.0),
        ("Light", (0.0, 0.0, 0.0), (0, 0, 0), 1.0),
    ]
    cam = ((0.0, 1.0, 3.6), (0.0, 1.0, 0.0), (0.0, 1.0, 0.0), 39.0, 256, 256)
    return {
        "cornell.obj": w.obj_text("cornell.mtl"),
        "cornell.mtl": _mtl_text(mats),
        "cornell.xml": _xml_text(cam, [("Light", (34.0, 24.0, 8.0))]),
    }


def _add_box(w: MeshWriter, mtl: str, base: Vec3, half: float, height: float, ang: float):
    """Axis-aligned box rotated `ang` about +y; outward normals (corners
    ordered clockwise viewed from above so cross(du_side, +y) faces out)."""
    c, s = math.cos(ang), math.sin(ang)

    def rot(x: float, z: float) -> Tuple[float, float]:
        return (c * x + s * z, -s * x + c * z)

    bx, by, bz = base
    corners = []
    for (x, z) in [(-half, -half), (-half, half), (half, half), (half, -half)]:
        rx, rz = rot(x, z)
        corners.append((bx + rx, bz + rz))
    for k in range(4):
        x0, z0 = corners[k]
        x1, z1 = corners[(k + 1) % 4]
        w.add_quad_grid(mtl, (x0, by, z0), (x1 - x0, 0, z1 - z0), (0, height, 0), 1, 1)
    w.add_quad_grid(
        mtl,
        (corners[0][0], by + height, corners[0][1]),
        (corners[1][0] - corners[0][0], 0, corners[1][1] - corners[0][1]),
        (corners[3][0] - corners[0][0], 0, corners[3][1] - corners[0][1]),
        1, 1,
    )


def author_veach_mis(
    tess: float = 1.0,
    sphere_subdiv: int = 1,
    lamp_y: float = 8.0,
    radii_scale: float = 1.0,
    lamp_zs: Tuple[float, float, float, float] = (-7.5, -2.5, 2.5, 7.5),
    plate_y0: float = -1.2,
) -> Dict[str, str]:
    """Veach-MIS-style scene at the reference's facet scale (~3,092 tris,
    README.md:212): four long plates of increasing shininess, four spherical
    emitters of decreasing size / increasing radiance, floor + back wall.
    Camera pose matches the reference XML (README.md:338-344).

    ``tess`` scales the quad-grid tessellation density (triangle count of
    the flat surfaces grows ~tess^2) and ``sphere_subdiv`` the emitter
    icospheres — same geometry at any setting, so renders are equal-work
    comparisons across scales — the workload for measuring where an
    acceleration structure starts to pay (the capability the reference's
    uniform grid exists for, Myobj.cpp:110-162): tess 1/1.8/3.2/5.9 gives
    ~3k/10k/30k/100k triangles.
    ``lamp_y`` / ``radii_scale`` move and scale the emitter row: the
    default layout hangs the emitters at y=8 so the *un-bugged* camera
    frames the classic arrangement; the golden-compat variant
    (:func:`author_veach_mis_golden`) lowers them into the Q2
    degrees-as-radians window (quirk Q2, main.cpp:547 — ~6.4 deg vertical
    => visible y in ~[1.2, 4.4] at 1x distance) so compat renders show the
    emitter row + streaks like the reference's test.bmp.
    """
    w = MeshWriter()
    gq = lambda n: max(1, round(n * tess))
    # The cg23 camera (README.md:338-344) sits at x=+28 looking down -x, so
    # the classic arrangement is laid out along the x axis: floor at y=-2
    # (normal +y), backdrop wall at x=-12 (normal +x), plates running along
    # z and tilted up toward the camera, emitters hanging above/behind.
    w.add_quad_grid("floor", (-12, -2, -12), (0, 0, 24), (32, 0, 0), gq(24), gq(24))
    w.add_quad_grid("wall", (-12, -2, -12), (0, 20, 0), (0, 0, 24), gq(24), gq(24))

    # Four plates: long thin slabs (long axis = z), nearer plates lower,
    # shininess increasing back to front. Each plate's tilt is solved so the
    # mirror direction at its centre sends the emitter row (hanging at
    # L=(-4,8,z)) into the eye (the classic Veach streak geometry).
    plate_ns = [60.0, 400.0, 2000.0, 10000.0]
    depth = 2.5
    eye = (28.2792, 5.2, 0.0)
    lamp = (-4.0, lamp_y, 0.0)
    for i in range(4):
        x0 = 3.0 + 2.8 * i
        y0 = plate_y0 + 1.0 * i
        cx, cy = x0 - 0.5 * depth, y0 + 0.4  # rough centre (refined below)
        to_l = _normalize((lamp[0] - cx, lamp[1] - cy, 0.0))
        to_e = _normalize((eye[0] - cx, eye[1] - cy, 0.0))
        nrm = _normalize((to_l[0] + to_e[0], to_l[1] + to_e[1], 0.0))
        tilt = math.atan2(nrm[0], nrm[1])  # rotation of +y normal toward +x
        du = (-depth * math.cos(tilt), depth * math.sin(tilt), 0.0)
        w.add_quad_grid(f"plate{i}", (x0, y0, -10.0), du, (0, 0, 20.0), gq(8), gq(8))

    # Four spherical emitters above/behind the plates, radius halving,
    # power ~constant (radiance ~ 1/r^2 like Veach's original).
    radii = [radii_scale * r for r in (1.2, 0.6, 0.3, 0.15)]
    zs = list(lamp_zs)
    for i, (r, z) in enumerate(zip(radii, zs)):
        w.add_icosphere(f"light{i}", (-4.0, lamp_y, z), r, sphere_subdiv)

    mats = [
        ("floor", (0.4, 0.4, 0.4), (0, 0, 0), 1.0),
        ("wall", (0.3, 0.32, 0.36), (0, 0, 0), 1.0),
    ]
    for i, ns in enumerate(plate_ns):
        mats.append((f"plate{i}", (0.07, 0.07, 0.07), (0.85, 0.85, 0.85), ns))
    tints = [(1.0, 0.45, 0.35), (0.95, 0.82, 0.38), (0.45, 0.9, 0.5), (0.4, 0.6, 1.0)]
    lights = []
    for i, (r, tint) in enumerate(zip(radii, tints)):
        mats.append((f"light{i}", (0, 0, 0), (0, 0, 0), 1.0))
        power = 40.0 / (r * r)  # constant total power across sizes
        lights.append((f"light{i}", tuple(power * t for t in tint)))

    cam = (
        (28.2792, 5.2, 1.23612e-06), (0.0, 2.8, 0.0), (0.0, 1.0, 0.0),
        20.1143, 1280, 720,
    )
    return {
        "veach-mis.obj": w.obj_text("veach-mis.mtl"),
        "veach-mis.mtl": _mtl_text(mats),
        "veach-mis.xml": _xml_text(cam, lights),
    }


def write_scene(files: Dict[str, str], out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    for name, text in files.items():
        with open(os.path.join(out_dir, name), "w") as f:
            f.write(text)


def author_veach_mis_golden() -> Dict[str, str]:
    """Golden-compat veach variant: emitter row inside the Q2 window.

    The reference's committed BMPs (test.bmp, exp_report/*.bmp,
    README.md:346-391) show the emitter row + specular streaks because its
    (lost, quirk Q14) scene put the emitters where the degrees-as-radians
    camera (quirk Q2, main.cpp:547) could see them. The default authored
    layout targets the un-bugged camera (emitters at y=8, outside the
    ~6.4 deg compat window); this variant lowers the row to y=3.8 and
    scales the discs so the full classic composition — four emitter discs
    upper half, streak bands below — lands inside the Q2 window at both
    1x and 2x distance (docs/GOLDEN.md)."""
    return author_veach_mis(
        lamp_y=3.8, radii_scale=0.45,
        lamp_zs=(-2.4, -0.9, 0.6, 2.1), plate_y0=0.2,
    )


def author_bathroom(tess: float = 1.9) -> Dict[str, str]:
    """Bathroom-style interior — the reference's third scene slot
    (`".\\Debug\\bathroom\\bathroom.obj"` is a commented constant in
    main.cpp:19-21; the cg23 assignment shipped cornell-box / veach-mis /
    bathroom, all lost with the asset zip, quirk Q14). Authored here in
    the same cg23 format: a tiled room with a large mirror, a tub, a
    counter with a spherical basin, ornament spheres, and a ceiling panel
    + warm window emitter. At the default tessellation the scene lands at
    ~28k triangles, ten times the other bundled scenes."""
    w = MeshWriter()
    gq = lambda n: max(1, round(n * tess))
    # Room shell: x in [0,4], y in [0,2.6], z in [0,3]. Inward normals.
    w.add_quad_grid("wall_plaster", (0, 0, 0), (4, 0, 0), (0, 2.6, 0), gq(24), gq(20))   # back (z=0), normal +z
    w.add_quad_grid("wall_plaster", (0, 0, 3), (0, 2.6, 0), (4, 0, 0), gq(20), gq(24))   # front (z=3), normal -z
    w.add_quad_grid("wall_plaster", (0, 0, 0), (0, 2.6, 0), (0, 0, 3), gq(20), gq(20))   # left (x=0), normal +x
    w.add_quad_grid("wall_tile", (4, 0, 0), (0, 0, 3), (0, 2.6, 0), gq(20), gq(20))      # right (x=4), normal -x
    w.add_quad_grid("ceiling", (0, 2.6, 0), (4, 0, 0), (0, 0, 3), gq(22), gq(20))        # -y
    # Checkered floor: 8x6 tiles, each tessellated
    for i in range(8):
        for j in range(6):
            mtl = "tile_white" if (i + j) % 2 == 0 else "tile_teal"
            w.add_quad_grid(mtl, (0.5 * i, 0.0, 0.5 * j),
                            (0, 0, 0.5), (0.5, 0, 0), gq(5), gq(5))
    # Mirror on the back wall (facing +z, toward the camera) with a frame
    w.add_quad_grid("mirror", (0.8, 0.9, 0.02), (1.8, 0, 0), (0, 1.3, 0), gq(8), gq(8))
    _add_box(w, "frame", (1.7, 0.82, 0.05), 0.05, 0.08, 0.0)
    _add_box(w, "frame", (1.7, 2.2, 0.05), 0.05, 0.08, 0.0)
    # Counter under the mirror with a spherical basin + tap ornament
    _add_box(w, "counter", (1.7, 0.0, 0.35), 0.45, 0.85, 0.0)
    w.add_icosphere("basin", (1.7, 0.88, 0.35), 0.28, 3)
    w.add_icosphere("chrome", (1.95, 1.02, 0.18), 0.06, 2)
    # Tub along the right wall
    _add_box(w, "tub", (3.4, 0.0, 1.5), 0.55, 0.55, 0.0)
    _add_box(w, "tub_rim", (3.4, 0.55, 1.5), 0.6, 0.06, 0.0)
    # Ornament spheres on the floor / shelf
    w.add_icosphere("chrome", (0.5, 0.18, 2.3), 0.18, 3)
    w.add_icosphere("soap", (1.35, 0.93, 0.55), 0.07, 2)
    w.add_icosphere("soap", (2.1, 0.93, 0.5), 0.05, 2)
    # Lights: ceiling panel (down) + warm window strip high on the left wall
    w.add_quad_grid("LightPanel", (1.4, 2.59, 1.1), (1.2, 0, 0), (0, 0, 0.9), 2, 2)
    w.add_quad_grid("LightWindow", (0.01, 1.6, 0.9), (0, 0.8, 0), (0, 0, 1.2), 2, 2)

    mats = [
        ("wall_plaster", (0.62, 0.60, 0.56), (0, 0, 0), 1.0),
        ("wall_tile", (0.55, 0.66, 0.70), (0.10, 0.10, 0.10), 40.0),
        ("ceiling", (0.70, 0.70, 0.70), (0, 0, 0), 1.0),
        ("tile_white", (0.72, 0.72, 0.70), (0.08, 0.08, 0.08), 80.0),
        ("tile_teal", (0.15, 0.42, 0.45), (0.08, 0.08, 0.08), 80.0),
        ("mirror", (0.03, 0.03, 0.03), (0.85, 0.85, 0.85), 8000.0),
        ("frame", (0.25, 0.18, 0.10), (0.05, 0.05, 0.05), 20.0),
        ("counter", (0.35, 0.30, 0.28), (0.12, 0.12, 0.12), 120.0),
        ("basin", (0.65, 0.67, 0.68), (0.20, 0.20, 0.20), 300.0),
        ("chrome", (0.05, 0.05, 0.05), (0.75, 0.78, 0.80), 2500.0),
        ("tub", (0.68, 0.70, 0.72), (0.15, 0.15, 0.15), 200.0),
        ("tub_rim", (0.68, 0.70, 0.72), (0.15, 0.15, 0.15), 200.0),
        ("soap", (0.75, 0.55, 0.50), (0.10, 0.10, 0.10), 60.0),
        ("LightPanel", (0, 0, 0), (0, 0, 0), 1.0),
        ("LightWindow", (0, 0, 0), (0, 0, 0), 1.0),
    ]
    lights = [
        ("LightPanel", (22.0, 22.0, 20.0)),
        ("LightWindow", (30.0, 24.0, 14.0)),
    ]
    cam = (
        (2.1, 1.35, 2.85), (1.8, 1.25, 0.0), (0.0, 1.0, 0.0),
        55.0, 1280, 720,
    )
    return {
        "bathroom.obj": w.obj_text("bathroom.mtl"),
        "bathroom.mtl": _mtl_text(mats),
        "bathroom.xml": _xml_text(cam, lights),
    }
