"""Scene, camera and material pytrees (SoA device arrays).

The batched replacement for the reference's global ``Myobj``/``Mylight``
objects (Myobj.h:44-90, Mylight.h:10-120): instead of tinyobj arrays + maps
memoised per triangle, the whole scene is a flat struct-of-arrays pytree that
jits, vmaps and shards. Triangles are identified by a single flat index
``tri_id`` in [0, T) (the reference's (s, f) pair, Myobj.h:44-66, is
flattened at build time; the mapping is kept for parity debugging).

Materials live in a table indexed by ``tri_mat_id`` — the reference reaches
directly into tinyobj's ``material_t`` per face (main.cpp:292). The table
(kd/ks/ns/emission) is the differentiability surface: pixel gradients flow
into these arrays (BASELINE.json north star).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp


def _pytree_dataclass(cls=None, *, static_fields=()):
    if cls is None:
        return partial(_pytree_dataclass, static_fields=static_fields)
    cls = dataclasses.dataclass(frozen=True)(cls)
    data_fields = [f.name for f in dataclasses.fields(cls) if f.name not in static_fields]
    jax.tree_util.register_dataclass(
        cls, data_fields=data_fields, meta_fields=list(static_fields)
    )
    return cls


@_pytree_dataclass(static_fields=("width", "height", "fov_bug_compat"))
class Camera:
    """Pinhole camera in the reference's convention (main.cpp:507-553).

    ``fov_bug_compat`` reproduces quirk Q2 (main.cpp:547): the half-fovy in
    *degrees* is passed to tan() as radians and the pixel scale divides by a
    constant 360 regardless of resolution. Default is a correct perspective
    model: pixel_len = tan(radians(fovy)/2) * dist / (height/2).
    """

    eye: jnp.ndarray        # [3]
    lookat: jnp.ndarray     # [3]
    up: jnp.ndarray         # [3]
    fovy_deg: jnp.ndarray   # scalar, full vertical fov in degrees
    width: int = 1280
    height: int = 720
    fov_bug_compat: bool = False


@_pytree_dataclass
class Materials:
    """Phong material table — tinyobj material_t fields the reference uses
    (diffuse=Kd, specular=Ks, shininess=Ns; main.cpp:292,313,331)."""

    kd: jnp.ndarray        # [M, 3]
    ks: jnp.ndarray        # [M, 3]
    ns: jnp.ndarray        # [M]
    emission: jnp.ndarray  # [M, 3] radiance from the scene XML (Mylight.cpp:21-28)


@_pytree_dataclass
class Scene:
    """Flat SoA scene. T = #triangles, L = #light (emissive) triangles,
    M = #materials."""

    # Geometry
    tri_v0: jnp.ndarray      # [T, 3]
    tri_e1: jnp.ndarray      # [T, 3]  v1 - v0
    tri_e2: jnp.ndarray      # [T, 3]  v2 - v0
    tri_vn: jnp.ndarray      # [T, 3, 3] per-vertex shading normals (unit)
    geo_n: jnp.ndarray       # [T, 3] unit geometric normal, vote-oriented (Myobj.cpp:680-709)

    # Material binding + table
    tri_mat_id: jnp.ndarray  # [T] int32 into Materials
    materials: Materials

    # Emissive set (reference islight / lightsTriangles, Mylight.cpp:32-100)
    is_light: jnp.ndarray        # [T] bool
    light_tri_ids: jnp.ndarray   # [L] int32 tri indices
    light_area: jnp.ndarray      # [L] triangle areas (Mylight.cpp:66-71)
    light_class: jnp.ndarray     # [L] int32 light-class (mtlname) id per light tri
    num_classes: jnp.ndarray     # scalar int32 (#light classes)

    camera: Camera

    @property
    def num_tris(self) -> int:
        return self.tri_v0.shape[0]

    @property
    def num_lights(self) -> int:
        return self.light_tri_ids.shape[0]

    def tri_emission(self) -> jnp.ndarray:
        """[T,3] emitted radiance per triangle (zero for non-lights)."""
        return self.materials.emission[self.tri_mat_id]

    def light_emission(self) -> jnp.ndarray:
        """[L,3] emitted radiance per light triangle."""
        return self.tri_emission()[self.light_tri_ids]

    def light_verts(self) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
        """([L,3],[L,3],[L,3]) world-space vertices of the light triangles."""
        v0 = self.tri_v0[self.light_tri_ids]
        e1 = self.tri_e1[self.light_tri_ids]
        e2 = self.tri_e2[self.light_tri_ids]
        return v0, v0 + e1, v0 + e2

    def with_materials(self, materials: Materials) -> "Scene":
        return dataclasses.replace(self, materials=materials)
