"""Scene -> struct-of-arrays torch tensors.

The jax-free twin of ``spectral_tpu.scene.flatten``. The tables are built
on the host in float32 numpy with the reference package's exact operation
order (``flatten_numpy`` is its ``flatten_scene`` body, line for line), so
every table is bitwise equal to the reference's ``arrays.host.np_fields``;
``SceneTensors`` then holds them as tensors on one device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spectral_tpu_torch.runtime.trace import span
from spectral_tpu_torch.scene.schema import (
    Mesh,
    PlainBox,
    RotatedBox,
    Scene,
    Sphere,
)
from spectral_tpu_torch.spectral import cie

F32 = np.float32

# Object type tags (same values as the reference package).
OBJ_PLAIN_BOX = 0
OBJ_SPHERE = 1
OBJ_ROTATED_BOX = 2
OBJ_TRIANGLE = 3

# Conservative padding on triangle world AABBs (see the reference module).
_TRI_AABB_PAD = F32(1e-4)

# The SceneArrays fields, in the reference's order. ``sky`` may be None.
FIELDS = (
    "obj_type", "slab_min", "slab_max", "shift", "inv_rot", "rot",
    "aabb_min", "aabb_max", "center", "half_dim", "sphere_pos", "radius",
    "metallicness", "roughness", "albedo", "transmission", "ior", "cauchy_b",
    "tex_scale", "tex_low", "emission", "lambda_grid", "mat_id",
    "mat_albedo", "mat_emission", "mat_scalars", "light_pos", "light_spec",
    "sky", "cam_pos", "cam_dir", "cam_up", "fov_y_deg", "cam_aperture",
    "cam_focus", "xyz_weights", "xyz_to_rgb",
)


def euler_to_rotation_matrix(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """nalgebra ``Rotation3::from_euler_angles`` (R = Rz @ Ry @ Rx), closed
    form in float32."""
    sr, cr = F32(np.sin(F32(roll))), F32(np.cos(F32(roll)))
    sp, cp = F32(np.sin(F32(pitch))), F32(np.cos(F32(pitch)))
    sy, cy = F32(np.sin(F32(yaw))), F32(np.cos(F32(yaw)))
    return np.array(
        [
            [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
            [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
            [-sp, cp * sr, cp * cr],
        ],
        dtype=F32,
    )


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render parameters (the reference package's ``RenderConfig``)."""

    width: int
    height: int
    n_samples: int
    max_bounces: int
    intended_frames: int
    n_objects: int
    n_lights: int
    lambda_lo: float = 380.0
    lambda_hi: float = 780.0
    n_materials: int = 0
    has_dof: bool = False


@dataclasses.dataclass
class SceneTensors:
    """The ``SceneArrays`` tables as tensors on one device.

    ``obj_type`` and ``mat_id`` are int32, everything else float32;
    ``sky`` is None for sky-less scenes. ``np_fields`` keeps the host
    numpy tables they were made from (read by kernel packing and by
    feature checks without a device readback). ``smooth_tri`` is the
    reference's ``smooth_tri_static``: some mesh carries vertex normals,
    so triangle normals are interpolated (flat meshes keep the stored
    winding normal)."""

    obj_type: torch.Tensor  # i32 [O]
    slab_min: torch.Tensor  # [O, 3]
    slab_max: torch.Tensor  # [O, 3]
    shift: torch.Tensor  # [O, 3]
    inv_rot: torch.Tensor  # [O, 3, 3]
    rot: torch.Tensor  # [O, 3, 3]
    aabb_min: torch.Tensor  # [O, 3]
    aabb_max: torch.Tensor  # [O, 3]
    center: torch.Tensor  # [O, 3]
    half_dim: torch.Tensor  # [O, 3]
    sphere_pos: torch.Tensor  # [O, 3]
    radius: torch.Tensor  # [O]
    metallicness: torch.Tensor  # [O]
    roughness: torch.Tensor  # [O]
    albedo: torch.Tensor  # [O, S]
    transmission: torch.Tensor  # [O]
    ior: torch.Tensor  # [O]
    cauchy_b: torch.Tensor  # [O]
    tex_scale: torch.Tensor  # [O]
    tex_low: torch.Tensor  # [O]
    emission: torch.Tensor  # [O, S]
    lambda_grid: torch.Tensor  # [S]
    mat_id: torch.Tensor  # i32 [O]
    mat_albedo: torch.Tensor  # [M, S]
    mat_emission: torch.Tensor  # [M, S]
    mat_scalars: torch.Tensor  # [M, 8]
    light_pos: torch.Tensor  # [L, 3]
    light_spec: torch.Tensor  # [L, S]
    sky: torch.Tensor | None  # [S]
    cam_pos: torch.Tensor  # [3]
    cam_dir: torch.Tensor  # [3]
    cam_up: torch.Tensor  # [3]
    fov_y_deg: torch.Tensor  # scalar
    cam_aperture: torch.Tensor  # scalar
    cam_focus: torch.Tensor  # scalar
    xyz_weights: torch.Tensor  # [S, 3]
    xyz_to_rgb: torch.Tensor  # [3, 3]
    np_fields: dict = dataclasses.field(repr=False, default_factory=dict)
    smooth_tri: bool = False

    @property
    def device(self) -> torch.device:
        return self.albedo.device

    @property
    def obj_types(self) -> tuple[int, ...]:
        return tuple(int(t) for t in self.np_fields["obj_type"])

    @property
    def has_triangles(self) -> bool:
        return bool((self.np_fields["obj_type"] == OBJ_TRIANGLE).any())


def _sphere_tables(center, radius_in):
    """Reference derivation chain (src/shader.rs:108-115, 305-306) in f32."""
    c = np.asarray(center, dtype=F32)
    r = F32(radius_in)
    amin = (c - r).astype(F32)
    amax = (c + r).astype(F32)
    sphere_pos = ((amin + amax) * F32(0.5)).astype(F32)
    radius = F32(amax[0] - sphere_pos[0])
    return amin, amax, sphere_pos, radius


def _rotated_box_world_aabb(center, half, rot):
    """World AABB of a rotated box from its 8 corners."""
    c = np.asarray(center, dtype=F32)
    corners = []
    for sx in (-1, 1):
        for sy in (-1, 1):
            for sz in (-1, 1):
                local = np.array(
                    [sx * half[0], sy * half[1], sz * half[2]], dtype=F32
                )
                corners.append((c + (rot @ local).astype(F32)).astype(F32))
    corners = np.stack(corners)
    return corners.min(axis=0).astype(F32), corners.max(axis=0).astype(F32)


def _lambda_grid(scene: Scene, n: int) -> np.ndarray:
    """Sample wavelengths, same f32 walk as ``Spectrum.get_wavelengths``."""
    lo = F32(scene.spectrum_lower_bound)
    hi = F32(scene.spectrum_upper_bound)
    step = F32(F32(hi - lo) / F32(n - 1))
    return np.array([F32(lo + F32(step * F32(i))) for i in range(n)], dtype=F32)


def flatten_numpy(scene: Scene) -> tuple[dict, RenderConfig]:
    """Snapshot a validated scene into host numpy tables (hidden objects
    and lights filtered out). Returns ``(np_fields, config)``."""
    scene.validate()
    n_samples = scene.spectrum_number_of_samples
    objects = scene.visible_objects()
    lights = scene.visible_lights()

    # meshes expand: each face becomes one first-class object row
    rows: list[tuple] = []
    for obj in objects:
        if isinstance(obj.object_type, Mesh):
            rows.extend((obj, f) for f in range(len(obj.object_type.faces)))
        else:
            rows.append((obj, None))

    n_obj = len(rows)
    obj_type = np.zeros(n_obj, dtype=np.int32)
    slab_min = np.zeros((n_obj, 3), dtype=F32)
    slab_max = np.zeros((n_obj, 3), dtype=F32)
    shift = np.zeros((n_obj, 3), dtype=F32)
    inv_rot = np.tile(np.eye(3, dtype=F32), (n_obj, 1, 1))
    rot = np.tile(np.eye(3, dtype=F32), (n_obj, 1, 1))
    aabb_min = np.zeros((n_obj, 3), dtype=F32)
    aabb_max = np.zeros((n_obj, 3), dtype=F32)
    center = np.zeros((n_obj, 3), dtype=F32)
    half_dim = np.zeros((n_obj, 3), dtype=F32)
    sphere_pos = np.zeros((n_obj, 3), dtype=F32)
    radius = np.zeros(n_obj, dtype=F32)
    metallicness = np.zeros(n_obj, dtype=F32)
    roughness = np.zeros(n_obj, dtype=F32)
    albedo = np.zeros((n_obj, n_samples), dtype=F32)
    transmission = np.zeros(n_obj, dtype=F32)
    ior = np.full(n_obj, F32(1.5), dtype=F32)
    cauchy_b = np.zeros(n_obj, dtype=F32)
    tex_scale = np.zeros(n_obj, dtype=F32)
    tex_low = np.ones(n_obj, dtype=F32)
    emission = np.zeros((n_obj, n_samples), dtype=F32)
    mat_id = np.zeros(n_obj, dtype=np.int32)
    material_index: dict[int, int] = {}
    material_list: list[int] = []

    for i, (obj, face) in enumerate(rows):
        pos = np.asarray(obj.position, dtype=F32)
        center[i] = pos
        t = obj.object_type
        if face is not None:
            # triangle row: shift = v0, slab_min = e1, slab_max = e2,
            # inv_rot rows = (n0, n1-n0, n2-n0)
            i0, i1, i2 = t.faces[face]
            v0 = (pos + np.asarray(t.vertices[i0], F32)).astype(F32)
            v1 = (pos + np.asarray(t.vertices[i1], F32)).astype(F32)
            v2 = (pos + np.asarray(t.vertices[i2], F32)).astype(F32)
            e1 = (v1 - v0).astype(F32)
            e2 = (v2 - v0).astype(F32)
            obj_type[i] = OBJ_TRIANGLE
            shift[i] = v0
            slab_min[i] = e1
            slab_max[i] = e2
            inv_rot[i] = 0.0
            if t.normals:
                def _unit(idx):
                    n_ = np.asarray(t.normals[idx], np.float64)
                    ln_ = np.linalg.norm(n_)
                    return (n_ / ln_ if ln_ > 0.0 else n_).astype(F32)

                n0_, n1_, n2_ = _unit(i0), _unit(i1), _unit(i2)
                inv_rot[i, 0] = n0_
                inv_rot[i, 1] = (n1_ - n0_).astype(F32)
                inv_rot[i, 2] = (n2_ - n0_).astype(F32)
            else:
                nrm = np.cross(e1.astype(np.float64), e2.astype(np.float64))
                ln = np.linalg.norm(nrm)
                if ln > 0.0:
                    inv_rot[i, 0] = (nrm / ln).astype(F32)
            vs = np.stack([v0, v1, v2])
            aabb_min[i] = (vs.min(axis=0) - _TRI_AABB_PAD).astype(F32)
            aabb_max[i] = (vs.max(axis=0) + _TRI_AABB_PAD).astype(F32)
            center[i] = ((v0 + v1 + v2) / F32(3.0)).astype(F32)
        elif isinstance(t, PlainBox):
            obj_type[i] = OBJ_PLAIN_BOX
            half = np.array(
                [F32(t.x_length) / 2, F32(t.y_length) / 2, F32(t.z_length) / 2],
                dtype=F32,
            )
            half_dim[i] = half
            aabb_min[i] = (pos - half).astype(F32)
            aabb_max[i] = (pos + half).astype(F32)
            slab_min[i], slab_max[i] = aabb_min[i], aabb_max[i]
        elif isinstance(t, Sphere):
            obj_type[i] = OBJ_SPHERE
            amin, amax, spos, rad = _sphere_tables(pos, t.radius)
            aabb_min[i], aabb_max[i] = amin, amax
            slab_min[i], slab_max[i] = amin, amax
            sphere_pos[i], radius[i] = spos, rad
        elif isinstance(t, RotatedBox):
            obj_type[i] = OBJ_ROTATED_BOX
            half = np.array(
                [F32(t.x_length) / 2, F32(t.y_length) / 2, F32(t.z_length) / 2],
                dtype=F32,
            )
            half_dim[i] = half
            r = euler_to_rotation_matrix(t.x_rotation, t.y_rotation, t.z_rotation)
            rot[i] = r
            inv_rot[i] = r.T
            shift[i] = pos
            slab_min[i], slab_max[i] = (-half).astype(F32), half
            aabb_min[i], aabb_max[i] = _rotated_box_world_aabb(pos, half, r)
        else:
            raise TypeError(f"unknown object type {t!r}")

        mat = obj.material
        metallicness[i] = F32(mat.metallicness)
        roughness[i] = F32(mat.roughness)
        albedo[i] = mat.spectrum.render_spectrum().values
        transmission[i] = F32(mat.transmission)
        ior[i] = F32(mat.ior)
        cauchy_b[i] = F32(mat.cauchy_b_um2)
        if mat.texture is not None:
            tex_scale[i] = F32(mat.texture.scale)
            tex_low[i] = F32(mat.texture.low)
        if mat.emission is not None:
            emission[i] = mat.emission.spectrum.values
        if id(mat) not in material_index:
            material_index[id(mat)] = len(material_list)
            material_list.append(i)
        mat_id[i] = material_index[id(mat)]

    n_lights = len(lights)
    light_pos = np.zeros((n_lights, 3), dtype=F32)
    light_spec = np.zeros((n_lights, n_samples), dtype=F32)
    for i, light in enumerate(lights):
        light_pos[i] = np.asarray(light.position, dtype=F32)
        light_spec[i] = light.spectrum.spectrum.values

    w = cie.xyz_integration_weights(
        scene.spectrum_lower_bound, scene.spectrum_upper_bound, n_samples
    )
    xyz_weights = np.zeros((n_samples, 3), dtype=F32)
    k = min(len(w), n_samples)
    xyz_weights[:k] = w[:k]

    np_fields = dict(
        obj_type=obj_type,
        slab_min=slab_min,
        slab_max=slab_max,
        shift=shift,
        inv_rot=inv_rot,
        rot=rot,
        aabb_min=aabb_min,
        aabb_max=aabb_max,
        center=center,
        half_dim=half_dim,
        sphere_pos=sphere_pos,
        radius=radius,
        metallicness=metallicness,
        roughness=roughness,
        albedo=albedo,
        transmission=transmission,
        ior=ior,
        cauchy_b=cauchy_b,
        tex_scale=tex_scale,
        tex_low=tex_low,
        emission=emission,
        lambda_grid=_lambda_grid(scene, n_samples),
        mat_id=mat_id,
        mat_albedo=albedo[material_list].reshape(-1, n_samples),
        mat_emission=emission[material_list].reshape(-1, n_samples),
        mat_scalars=(
            np.stack(
                [
                    metallicness[material_list],
                    roughness[material_list],
                    transmission[material_list],
                    ior[material_list],
                    cauchy_b[material_list],
                    tex_scale[material_list],
                    tex_low[material_list],
                    np.zeros(len(material_list), F32),
                ],
                axis=1,
            ).astype(F32)
            if material_list
            else np.zeros((0, 8), F32)
        ),
        light_pos=light_pos,
        light_spec=light_spec,
        sky=(
            scene.sky.spectrum.values.astype(F32)
            if scene.sky is not None
            else None
        ),
        cam_pos=np.asarray(scene.camera.position, dtype=F32),
        cam_dir=np.asarray(scene.camera.direction, dtype=F32),
        cam_up=np.asarray(scene.camera.up, dtype=F32),
        fov_y_deg=F32(scene.camera.fov_y_deg),
        cam_aperture=F32(scene.camera.aperture_radius),
        cam_focus=F32(scene.camera.focus_distance),
        xyz_weights=xyz_weights,
        xyz_to_rgb=cie.XYZ_TO_RGB_MATRIX,
    )
    config = RenderConfig(
        width=scene.width,
        height=scene.height,
        n_samples=n_samples,
        max_bounces=scene.nbr_of_ray_bounces,
        intended_frames=scene.nbr_of_iterations,
        n_objects=n_obj,
        n_lights=n_lights,
        lambda_lo=float(scene.spectrum_lower_bound),
        lambda_hi=float(scene.spectrum_upper_bound),
        n_materials=len(material_list),
        has_dof=scene.camera.aperture_radius > 0.0,
    )
    return np_fields, config


def smooth_triangles(scene: Scene) -> bool:
    """The reference's ``smooth_tri_static``: a visible mesh carries
    vertex normals."""
    return any(isinstance(o.object_type, Mesh) and bool(o.object_type.normals)
               for o in scene.visible_objects())


def from_numpy(
    np_fields: dict, config: RenderConfig, device: str | torch.device,
    smooth_tri: bool = False,
) -> tuple[SceneTensors, RenderConfig]:
    """Tables from host numpy (this module's ``flatten_numpy`` or the
    reference package's ``arrays.host.np_fields``) as tensors on
    ``device``. Values are copied bit for bit. ``smooth_tri``: see
    ``SceneTensors`` (``smooth_triangles`` of the scene)."""
    device = torch.device(device)
    host = {
        name: None if np_fields[name] is None
        else torch.from_numpy(np.array(np_fields[name], copy=True))
        for name in FIELDS
    }
    # each table is one copy from pageable host memory: on the card, a wait
    with span("wait.upload", arg=sum(t is not None for t in host.values())):
        tensors = {name: None if t is None else t.to(device) for name, t in host.items()}
    return SceneTensors(**tensors, np_fields=dict(np_fields),
                        smooth_tri=bool(smooth_tri)), config


def flatten_scene(
    scene: Scene, device: str | torch.device
) -> tuple[SceneTensors, RenderConfig]:
    """Snapshot a validated scene into tensors on ``device``."""
    np_fields, config = flatten_numpy(scene)
    return from_numpy(np_fields, config, device, smooth_triangles(scene))
