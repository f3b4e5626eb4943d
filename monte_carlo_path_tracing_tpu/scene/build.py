"""Build a device Scene pytree from parsed host-side data.

Covers the reference's startup pipeline (SURVEY.md §3.1): OBJ/MTL parse →
XML lights parse → gather_light_triangles (Mylight.cpp:32-100) → per-facet
attribute caches (Myobj.cpp:626-709). There is no grid build — the default
intersection engine is a tiled all-pairs test (see ops/), so the uniform-grid
accelerator (Myobj.cpp:78-162, quirk Q7) has no counterpart here.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import jax.numpy as jnp

from monte_carlo_path_tracing_tpu.scene.objparse import ParsedMesh, parse_obj
from monte_carlo_path_tracing_tpu.scene.types import Camera, Materials, Scene
from monte_carlo_path_tracing_tpu.scene.xmlparse import ParsedSceneXML, parse_scene_xml


def _normalize_np(v: np.ndarray, axis=-1) -> np.ndarray:
    n = np.linalg.norm(v, axis=axis, keepdims=True)
    return v / np.maximum(n, 1e-20)


def build_scene(
    mesh: ParsedMesh,
    scene_xml: ParsedSceneXML,
    camera: Optional[Camera] = None,
    fov_bug_compat: bool = False,
) -> Scene:
    verts = mesh.vertices
    fv = mesh.face_v            # [T,3]
    fvn = mesh.face_vn          # [T,3]
    T = fv.shape[0]
    if T == 0:
        raise ValueError("scene has no triangles")

    a = verts[fv[:, 0]]
    b = verts[fv[:, 1]]
    c = verts[fv[:, 2]]
    e1 = b - a
    e2 = c - a

    # Geometric normal with majority-vote orientation against the vertex
    # normals (reference get_unique_normal_of_facet, Myobj.cpp:680-709).
    gn = _normalize_np(np.cross(e1, e2))

    has_vn = (fvn >= 0).all(axis=1) & (mesh.normals.shape[0] > 0)
    if mesh.normals.shape[0] > 0:
        vn = _normalize_np(mesh.normals[np.clip(fvn, 0, None)])  # [T,3,3]
    else:
        vn = np.repeat(gn[:, None, :], 3, axis=1)
    # Faces without normals: fall back to the geometric normal.
    vn = np.where(has_vn[:, None, None], vn, gn[:, None, :])

    votes = np.sum(np.einsum("tij,tj->ti", vn, gn) > 0.0, axis=1)
    flip = votes < 2  # majority of the 3 vertex normals disagrees -> flip
    gn = np.where(flip[:, None], -gn, gn)

    # Material table. Unnamed/missing materials get matte grey defaults.
    mat_names = list(mesh.material_names) if mesh.material_names else [""]
    M = len(mat_names)
    kd = np.zeros((M, 3), np.float32)
    ks = np.zeros((M, 3), np.float32)
    ns = np.ones((M,), np.float32)
    emission = np.zeros((M, 3), np.float32)
    for i, name in enumerate(mat_names):
        pm = mesh.materials.get(name)
        if pm is not None:
            kd[i], ks[i], ns[i] = pm.kd, pm.ks, max(pm.ns, 1.0)
        else:
            kd[i] = (0.5, 0.5, 0.5)
        if name in scene_xml.lights:
            emission[i] = scene_xml.lights[name]

    tri_mat = np.where(mesh.face_mat >= 0, mesh.face_mat, 0).astype(np.int32)

    # Emissive gather (reference Mylight.cpp:32-100): class = light mtlname,
    # area = half parallelogram area (Mylight.cpp:66-71,80).
    light_class_names = [n for n in mat_names if n in scene_xml.lights]
    class_of_mat = {mat_names.index(n): k for k, n in enumerate(light_class_names)}
    is_light = np.isin(tri_mat, list(class_of_mat.keys()))
    light_ids = np.nonzero(is_light)[0].astype(np.int32)
    light_area = 0.5 * np.linalg.norm(
        np.cross(e1[light_ids], e2[light_ids]), axis=-1
    ).astype(np.float32)
    light_class = np.asarray(
        [class_of_mat[int(m)] for m in tri_mat[light_ids]], dtype=np.int32
    ).reshape(-1)

    if camera is None:
        if scene_xml.camera is None:
            raise ValueError("no camera in scene XML and none supplied")
        pc = scene_xml.camera
        camera = Camera(
            eye=jnp.asarray(pc.eye, jnp.float32),
            lookat=jnp.asarray(pc.lookat, jnp.float32),
            up=jnp.asarray(pc.up, jnp.float32),
            fovy_deg=jnp.asarray(pc.fovy, jnp.float32),
            width=pc.width,
            height=pc.height,
            fov_bug_compat=fov_bug_compat,
        )

    return Scene(
        tri_v0=jnp.asarray(a),
        tri_e1=jnp.asarray(e1),
        tri_e2=jnp.asarray(e2),
        tri_vn=jnp.asarray(vn),
        geo_n=jnp.asarray(gn),
        tri_mat_id=jnp.asarray(tri_mat),
        materials=Materials(
            kd=jnp.asarray(kd), ks=jnp.asarray(ks), ns=jnp.asarray(ns),
            emission=jnp.asarray(emission),
        ),
        is_light=jnp.asarray(is_light),
        light_tri_ids=jnp.asarray(light_ids),
        light_area=jnp.asarray(light_area),
        light_class=jnp.asarray(light_class),
        num_classes=jnp.asarray(len(light_class_names), jnp.int32),
        camera=camera,
    )


def load_scene(obj_path: str, xml_path: Optional[str] = None, **kw) -> Scene:
    """Load a cg23 scene: ``<name>.obj`` (+``.mtl`` via mtllib) + ``<name>.xml``.

    Uses the native C++ loader (native/loader.cpp via ctypes) when built,
    falling back to the pure-Python parser.
    """
    if xml_path is None:
        xml_path = os.path.splitext(obj_path)[0] + ".xml"
    from monte_carlo_path_tracing_tpu.scene import native_loader

    if native_loader.native_available():
        mesh = native_loader.parse_obj_native(obj_path)
    else:
        mesh = parse_obj(obj_path)
    scene_xml = parse_scene_xml(xml_path)
    return build_scene(mesh, scene_xml, **kw)
