"""Host side of the bounce kernels (``ops/csrc``).

The counterpart of the reference package's
``spectral_tpu.ops.pallas.megakernel`` entry points ``run`` (``kernel``),
``run_regen`` (``kernel_regen``), ``run_persist`` (``kernel_persist``),
``run_cost`` (``kernel_cost``) and ``run_seg`` (``kernel_seg``):

* ``pack_tables`` packs the scene into the kernels' own struct-of-arrays
  layout (the ``pack_geometry``/``pack_camera`` counterparts; rows listed
  in ``csrc/megakernel.cuh``), with the material albedo table, the object
  walk of the cluster plan (``ops/clusters.py``) and the scene-feature
  tables;
* ``run_mono`` / ``run_regen`` / ``run_persist`` / ``run_cost`` /
  ``run_seg`` launch the CUDA kernels on CUDA tensors and count their
  launches (``runtime.trace``'s ``launch.mono`` ... ``launch.seg``);
* ``run_mono_plain`` / ``run_regen_plain`` / ``run_persist_plain`` /
  ``run_cost_plain`` / ``run_seg_plain`` take the same arguments and run
  the eager PyTorch bounce loop (``render.integrator``);
* ``run_mono_variant`` / ``run_cost_variant`` / ``run_regen_variant`` /
  ``run_persist_variant`` / ``run_seg_variant`` launch a diagnostic build
  of a kernel (``runtime.build.VARIANTS``: the earlier design's grid, the
  counters of ``tools/lane_stats.py``) for the measurement tools.

The wrappers take the plain path only for tensors on the CPU. For CUDA
tensors they launch the kernel or raise; there is no fallback. Each
launch takes the library of its kernel's source that its tables need
(``library_for``): a scene with a feature (``integrator.scene_features``:
sky, checker texture, emission, dielectric) the feature build, a lens
scene's regeneration the lens build, triangles at S = 16 or 64 the wide
triangle build, tables ``with_shadow_interval`` the shadow-interval
build, any other the default; a persist launch takes the register build
of its library where the spectral state in shared memory loses
(``persist_library``). A launch of another kind is refused.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from spectral_tpu_torch.ops import clusters as cl
from spectral_tpu_torch.ops.vecmath import Vec3
from spectral_tpu_torch.render.camera import CAM_BASIS, primary_directions, primary_origin
from spectral_tpu_torch.render.integrator import (
    FX_EMISSION,
    FX_SKY,
    FX_TEXTURE,
    FX_TRANSMISSION,
    PersistState,
    Wavefront,
    bounce_loop,
    bounce_loop_cost,
    persist_iterations,
    scene_features,
    segment_iterations,
)
from spectral_tpu_torch.runtime import build, trace
from spectral_tpu_torch.scene.flatten import (
    OBJ_PLAIN_BOX,
    OBJ_ROTATED_BOX,
    OBJ_SPHERE,
    OBJ_TRIANGLE,
    RenderConfig,
    SceneTensors,
)

SUPPORTED_SAMPLES = (8, 16, 32, 64)
OBJECT_TYPES = (OBJ_PLAIN_BOX, OBJ_SPHERE, OBJ_ROTATED_BOX, OBJ_TRIANGLE)
BLOCK = 128  # threads (pixel-lanes) per block, csrc/megakernel.cuh
SMEM_OBJECTS = 64  # geometry in shared memory up to this many objects
MAX_SMEM = 232448  # bytes of shared memory a block may use on Hopper
# the packed walk records stay in shared memory while a block's tables
# take at most this much: 4 blocks of 128 lanes (the register limit of
# the S = 32 kernels) then still fit an SM's 228 KB
PACKED_SMEM_LIMIT = 56 * 1024

# geom rows, mirroring csrc/megakernel.cuh: (field, first row, width)
GEOM_LAYOUT = (
    ("obj_type", 0, 1),
    ("slab_min", 1, 3),
    ("slab_max", 4, 3),
    ("shift", 7, 3),
    ("inv_rot", 10, 9),
    ("rot", 19, 9),
    ("aabb_min", 28, 3),
    ("aabb_max", 31, 3),
    ("center", 34, 3),
    ("half_dim", 37, 3),
    ("sphere_pos", 40, 3),
    ("radius", 43, 1),
    ("metallicness", 44, 1),
    ("roughness", 45, 1),
    ("mat_id", 46, 1),
)
GEOM_ROWS = 47
# mat_fx columns (csrc/megakernel.cuh MF_*): the mat_scalars columns
# transmission, ior, cauchy_b, tex_scale, tex_low
MAT_FX_SCALARS = slice(2, 7)
MAT_FX_COLS = 5


@dataclasses.dataclass
class KernelTables:
    """Everything a bounce kernel reads besides the lane planes, on one
    device. ``scene``/``config`` are the tables the plain versions read;
    ``clusters`` is the cluster plan (None: one run over every object)."""

    geom: torch.Tensor  # f32 [GEOM_ROWS, O]
    mat_albedo: torch.Tensor  # f32 [M, S]
    order: torch.Tensor  # i32 [O]: object indices in visit order
    runs: torch.Tensor  # f32 [R, RUN_COLS]
    lpos: torch.Tensor  # f32 [L, 4]
    lspec: torch.Tensor  # f32 [L, S]
    cam: torch.Tensor  # f32 [4]: camera position, pad
    packed: torch.Tensor  # f32 [P, 4]: the walk's packed records
    mat_fx: torch.Tensor  # f32 [M, MAT_FX_COLS]: the feature scalars
    mat_emission: torch.Tensor  # f32 [M, S]
    lam: torch.Tensor  # f32 [S]: the wavelength grid, nm
    sky: torch.Tensor  # f32 [S]: zeros without a sky
    scene: SceneTensors
    config: RenderConfig
    clusters: tuple | None = None
    triangles: int = 0
    packed_shared: bool = False  # the records go to shared memory
    features: int = 0  # integrator.FX_* bits; nonzero: the feature builds
    shadow_interval: bool = False  # the sqrt-free sphere shadow test (with_shadow_interval)

    def many_objects(self) -> bool:
        """Whether the kernels take their many-object instantiation
        (``csrc/bounce.cuh:many_objects``): geometry in global memory and
        the run walk, instead of shared geometry in index order."""
        return self.config.n_objects > SMEM_OBJECTS or self.runs.shape[0] > 1

    def unpacked(self) -> "KernelTables":
        """These tables without packed walk records: every run reads the
        47-row table through ``order``, the walk of the kernels before
        the records (for measurements against it)."""
        runs = self.runs.clone()
        runs[:, cl.RUN_PACK] = -1.0
        return dataclasses.replace(self, runs=runs, packed=self.packed[:0])

    def _floats(self) -> tuple[int, int, int]:
        """Floats of shared memory of every table but the material rows,
        of the material rows, and of the staging slots that take their
        place where they stay in global memory (``csrc/bounce.cuh:
        smem_bytes``, ``stage_stride``)."""
        o, s = self.config.n_objects, self.config.n_samples
        n_l = self.config.n_lights
        walk = o + self.runs.numel() if self.many_objects() else GEOM_ROWS * o
        if self.many_objects() and self.packed_shared:
            walk += self.packed.numel()
        n_mat = self.mat_albedo.shape[0]
        per_mat = s + MAT_FX_COLS + s if self.features else s
        tables = walk + 4 * n_l + n_l * s + (2 * s if self.features else 0) + n_l * BLOCK
        stage = BLOCK * (2 * s + MAT_FX_COLS if self.features else s + 1)
        return tables, n_mat * per_mat, stage

    def materials_shared(self) -> bool:
        """Whether the kernels copy the material rows to shared memory:
        while the whole table fits ``MAX_SMEM``; else they stay in global
        memory, and each bounce copies its material's rows into its
        thread's staging slot (``csrc/bounce.cuh:smem_bytes``; the launch
        passes the choice as ``mat_rows`` and ``stage_floats``)."""
        tables, materials, _stage = self._floats()
        return 4 * (tables + materials) <= MAX_SMEM

    def smem_bytes(self) -> int:
        """The kernels' dynamic shared memory for these tables
        (``csrc/bounce.cuh:smem_bytes``)."""
        tables, materials, stage = self._floats()
        return 4 * (tables + (materials if self.materials_shared() else stage))

    def feature_gates(self) -> dict:
        """The features as ``flops.kernel_ops``' gates."""
        return dict(has_transmission=bool(self.features & FX_TRANSMISSION),
                    has_emission=bool(self.features & FX_EMISSION),
                    has_texture=bool(self.features & FX_TEXTURE),
                    has_sky=bool(self.features & FX_SKY))


def pack_tables(scene: SceneTensors, config: RenderConfig,
                accel: str = "auto") -> KernelTables:
    """Pack the scene for the kernels (host numpy, then one copy to the
    scene's device). ``accel``: "auto" plans 64-object clusters above 64
    objects (``clusters.renderer_plan``), "none" walks every object. Any
    material count packs: the kernels keep the material rows in shared
    memory while the whole table fits a block's, else in global memory
    (``KernelTables.materials_shared``). Raises for an object type tag
    that no kernel branch knows, and for tables whose other rows (the
    lights) exceed a block's shared memory."""
    plan = cl.renderer_plan(scene.np_fields, config.n_objects, accel)
    return _pack(scene, config, plan, scene_features(scene))


def repack_tables(tables: KernelTables, scene: SceneTensors) -> KernelTables:
    """``tables``' cluster plan and feature build over ``scene``, another
    snapshot of the same configuration (a motion-blur frame): the visit
    order and the runs stay the plan's, while the geometry, the runs'
    union AABBs and the packed records are ``scene``'s own, so an object
    that moved out of its cluster's first bound is still found. Raises
    ``ValueError`` for a snapshot with a feature the build lacks."""
    extra = scene_features(scene) & ~tables.features
    if extra:
        raise ValueError(
            f"the scene snapshot has feature bits {extra} that the tables' "
            f"build ({tables.features}) lacks"
        )
    return _pack(scene, tables.config, tables.clusters, tables.features)


def with_features(tables: KernelTables, features: int) -> KernelTables:
    """These tables on the feature build that also holds ``features``
    (``integrator.FX_*`` bits): a scene schedule whose tracks can switch a
    feature on takes that build from its first frame."""
    if not features & ~tables.features:
        return tables
    return _pack(tables.scene, tables.config, tables.clusters, tables.features | features)


def _pack(scene: SceneTensors, config: RenderConfig, plan, features: int) -> KernelTables:
    f = scene.np_fields
    unknown = set(np.unique(f["obj_type"]).tolist()) - set(OBJECT_TYPES)
    if unknown:
        raise ValueError(f"unknown object type tag(s) {sorted(unknown)}")
    n_obj = config.n_objects
    geom = np.zeros((GEOM_ROWS, n_obj), np.float32)
    for name, row, width in GEOM_LAYOUT:
        geom[row:row + width] = np.asarray(f[name], np.float32).reshape(n_obj, width).T
    lpos = np.zeros((config.n_lights, 4), np.float32)
    lpos[:, :3] = f["light_pos"]
    cam = np.zeros(4, np.float32)
    cam[:3] = f["cam_pos"]
    order, runs = cl.run_tables(f, n_obj, plan)
    packed = cl.pack_walk(f, order, runs)
    dev = scene.device

    def t(a, dtype=np.float32):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    sky = f["sky"] if f["sky"] is not None else np.zeros(config.n_samples, np.float32)
    tables = KernelTables(
        geom=t(geom), mat_albedo=t(f["mat_albedo"]), order=t(order, np.int32),
        runs=t(runs), lpos=t(lpos), lspec=t(f["light_spec"]), cam=t(cam),
        packed=t(packed), mat_fx=t(f["mat_scalars"][:, MAT_FX_SCALARS]),
        mat_emission=t(f["mat_emission"]), lam=t(f["lambda_grid"]), sky=t(sky),
        scene=scene, config=config, clusters=plan,
        triangles=(2 if scene.smooth_tri else 1) if scene.has_triangles else 0,
        features=features,
    )
    # the packed records go to shared memory where the block then still
    # fits PACKED_SMEM_LIMIT, else the walk streams them from global memory
    tables.packed_shared = True
    tables.packed_shared = tables.smem_bytes() <= PACKED_SMEM_LIMIT
    if n_obj and tables.smem_bytes() > MAX_SMEM:
        raise NotImplementedError(
            f"the scene's kernel tables take {tables.smem_bytes()} bytes of "
            f"shared memory, more than a block's {MAX_SMEM}"
        )
    return tables


def with_shadow_interval(tables: KernelTables) -> KernelTables:
    """These tables with the opt-in sqrt-free sphere shadow test (the
    reference's ``shadow_interval``, ``megakernel.py:390-411``): the
    many-object loop's shadow rays decide "does the sphere's chosen root
    lie in (0, maxd]" by sign tests on the quadratic, not by the root.
    Not bit-identical to the root test (a blocker within rounding of t = 0
    or t = maxd can flip), so it is never a default. It runs on
    ``cuda_mono``, ``cuda_cost`` and ``cuda_regen`` (the ``mono_si`` and
    ``regen_si`` libraries) and their plain versions. Raises
    ``ValueError`` for a scene without the many-object loop, as the
    reference refuses its unrolled loop, and for a scene with features,
    which has no such build."""
    if not tables.many_objects():
        raise ValueError(
            "shadow_interval is an option of the many-object loop (more than "
            f"{SMEM_OBJECTS} objects or a cluster plan); the small-scene loop "
            "keeps the division form"
        )
    if tables.features:
        raise ValueError(
            "shadow_interval has no feature build: a scene with a sky, checker "
            "texture, emission or a dielectric renders without it"
        )
    return dataclasses.replace(tables, shadow_interval=True)


def _refuse_shadow_interval(tables: KernelTables, kernel: str) -> None:
    if tables.shadow_interval:
        raise ValueError(f"shadow_interval runs on cuda_mono, cuda_cost and "
                         f"cuda_regen only, not on {kernel}")


# ------------------------------------------------------------ plain versions


def run_mono_plain(ox, oy, oz, dx, dy, dz, px, py, frame_id: int,
                   tables: KernelTables) -> torch.Tensor:
    """One frame's radiance ``[S, n]`` from the given primary lanes: the
    eager bounce loop on the same inputs as ``run_mono``."""
    rad = bounce_loop(
        Vec3(ox, oy, oz), Vec3(dx, dy, dz), px.long(), py.long(), frame_id,
        tables.scene, tables.config, shadow_interval=tables.shadow_interval,
    )
    return rad.T.contiguous()


def run_regen_plain(px, py, first_frame: int, camera, offsets, lens,
                    tables: KernelTables) -> torch.Tensor:
    """The SUM of K frames' radiance ``[S, n]``: frame j traces from the
    camera (moved by row j of the lens table, if any) along
    ``camera.primary_directions`` at the lane's pixel with offsets row j.
    One radiance accumulator is carried through the K frames, bounce by
    bounce, in the kernel's order, so the sum is ``run_regen``'s bit for
    bit (a sum of K separate frames differs in the last bits)."""
    n = px.shape[0]
    px, py = px.long(), py.long()
    rad = None
    for j in range(offsets.shape[0]):
        row = None if lens is None else lens[j]
        pos = primary_origin(camera, row)
        origin = Vec3(pos.x.expand(n), pos.y.expand(n), pos.z.expand(n))
        d = primary_directions(px, py, camera, offsets[j, 0], offsets[j, 1], row)
        rad = bounce_loop(origin, d, px, py, first_frame + j, tables.scene,
                          tables.config, radiance=rad,
                          shadow_interval=tables.shadow_interval)
    return rad.T.contiguous()


def run_cost_plain(ox, oy, oz, dx, dy, dz, px, py, frame_id: int,
                   tables: KernelTables):
    """``run_mono_plain`` plus each lane's path cost: ``(rad [S, n],
    cost [n] f32)`` with ``cost = max_bounces + 1 - bounces_left``."""
    rad, cost = bounce_loop_cost(
        Vec3(ox, oy, oz), Vec3(dx, dy, dz), px.long(), py.long(), frame_id,
        tables.scene, tables.config, shadow_interval=tables.shadow_interval,
    )
    return rad.T.contiguous(), cost


def run_persist_plain(state: PersistState, lead: int, end: int,
                      tables: KernelTables, cam: torch.Tensor, ring=None,
                      stop=None, budget: int = 1) -> None:
    """``budget`` bounce iterations over the carried lane state, updated
    IN PLACE (``integrator.persist_iterations``); same contract as
    ``run_persist``."""
    _refuse_shadow_interval(tables, "cuda_persist")
    persist_iterations(state, lead, end, tables.scene, tables.config, cam,
                       ring=ring, stop=stop, budget=budget)


def run_seg_plain(wf: Wavefront, b_start: int, b_stop: int, frame_id: int,
                  tables: KernelTables) -> None:
    """Bounces ``[b_start, b_stop)`` of the wavefront's live lanes, IN
    PLACE (``integrator.segment_iterations``); same contract as
    ``run_seg``."""
    _refuse_shadow_interval(tables, "cuda_seg")
    segment_iterations(wf, b_start, b_stop, frame_id, tables.scene, tables.config)


# ------------------------------------------------------------------ kernels


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _check_lanes(planes: dict, ints: dict, tables: KernelTables, n: int) -> None:
    dev = tables.geom.device
    for name, t in {**planes, **ints}.items():
        want = torch.int32 if name in ints else torch.float32
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the tables on {dev}")
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.shape[-1] != n:
            raise ValueError(f"{name} has {t.shape[-1]} lanes, expected {n}")
    s = tables.config.n_samples
    if s not in SUPPORTED_SAMPLES:
        raise ValueError(
            f"the CUDA kernels are built for S in {SUPPORTED_SAMPLES}, got {s}"
        )
    if tables.config.n_objects < 1:
        raise ValueError("the CUDA kernels need at least one object")


def _check_spectral(state, n: int, s: int) -> None:
    for name in ("thr", "rad"):
        t = getattr(state, name)
        if t.shape != (s, n) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 [{s}, {n}]")


def _check_camera(camera, offsets, lens, dev) -> None:
    k = offsets.shape[0]
    tabs = [("camera", camera, (CAM_BASIS,)), ("offsets", offsets, (k, 2))]
    if lens is not None:
        tabs.append(("lens", lens, (k, 4)))
    for name, t, shape in tabs:
        if (t.device != dev or t.dtype != torch.float32 or not t.is_contiguous()
                or tuple(t.shape) != shape):
            raise ValueError(f"{name} must be a contiguous float32 {list(shape)} "
                             "table on the lanes' device")


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"no bounce kernel for device {t.device}")


# the table arguments of every C entry point (csrc/bounce.cuh:
# SPECTRAL_TABLE_PARAMS): 9 ints, 7 pointers, and in a feature build the
# feature mask and 4 pointers
_TABLE_ARGTYPES = [ctypes.c_int] * 9 + [ctypes.c_void_p] * 7
_FEATURE_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 4


def _table_args(tables: KernelTables) -> tuple:
    cfg = tables.config
    n_mat = tables.mat_albedo.shape[0]
    shared = tables.materials_shared()
    args = (cfg.n_objects, n_mat, tables.runs.shape[0],
            cfg.n_lights, tables.triangles, tables.packed.shape[0],
            int(tables.packed_shared), n_mat if shared else 0,
            0 if shared else tables._floats()[2],
            *map(_ptr, (tables.geom, tables.mat_albedo, tables.order,
                        tables.runs, tables.lpos, tables.lspec, tables.packed)))
    if tables.features:
        args += (tables.features, *map(_ptr, (tables.mat_fx, tables.mat_emission,
                                              tables.lam, tables.sky)))
    return args


_SIGNATURES = {  # entry point: (source, argument types after the tables' split)
    "spectral_mono": ("mono", ([ctypes.c_int] * 3 + [ctypes.c_uint], 11)),
    "spectral_cost": ("mono", ([ctypes.c_int] * 3 + [ctypes.c_uint], 12)),
    "spectral_regen": ("regen", ([ctypes.c_int] * 3 + [ctypes.c_uint, ctypes.c_int], 8)),
    "spectral_persist": ("persist", ([ctypes.c_int] * 4 + [ctypes.c_uint] * 2
                                     + [ctypes.c_int], 21)),
    "spectral_seg": ("seg", ([ctypes.c_int] * 5 + [ctypes.c_uint], 14)),
}


# the S the default libraries build with triangles (csrc/bounce.cuh:
# tri_built); the others are in the wide triangle libraries
DEFAULT_TRIANGLE_SAMPLES = (8, 32)


def library_for(src: str, tables: KernelTables, lens: bool = False) -> str:
    """The library of bounce source ``src`` that ``tables`` launch
    (``runtime/build.py``): the shadow-interval build for tables
    ``with_shadow_interval``; else, with the scene-feature branches for a
    scene with features (``_fx``), the lens build of ``regen`` for a lens
    table (``_lens``), the wide triangle build for triangles at S = 16 or
    64 (``_tri``), or the default; ``persist`` in its register build
    (``_reg``: the spectral state in registers) for many-object tables
    whose packed records stay in global memory, and for tables that leave
    the state no room in a block's shared memory. ``persist_library``
    may take the register build for other tables too."""
    if tables.shadow_interval:
        return f"{src}_si"
    name = f"{src}_fx" if tables.features else src
    if lens:
        return f"{name}_lens"
    if tables.triangles and tables.config.n_samples not in DEFAULT_TRIANGLE_SAMPLES:
        name = f"{name}_tri"
    if src == "persist" and (
            (tables.many_objects() and not tables.packed_shared)
            or tables.smem_bytes() + persist_state_bytes(tables.config.n_samples) > MAX_SMEM):
        name = f"{name}_reg"
    return name


def persist_state_bytes(n_samples: int) -> int:
    """Shared memory the spectral state takes after the tables in the
    default persist builds (``csrc/persist.cu``): ``[2S][BLOCK]`` floats."""
    return 4 * 2 * n_samples * BLOCK


def persist_library(tables: KernelTables) -> str:
    """The library a ``cuda_persist`` launch on the card takes:
    ``library_for``'s, or its register build (``_reg``) where the tables
    leave the spectral state in shared memory no more blocks per SM than
    the register build holds (the occupancy API's count for each, in
    the free-running form). Tables that cost the shared state no block
    keep the default build without loading the other."""
    name = library_for("persist", tables)
    if name.endswith("_reg"):
        return name
    shared = _persist_blocks(name, tables, tables.smem_bytes())
    if shared >= _persist_blocks(name, tables, 0):
        return name
    reg = f"{name}_reg"
    return reg if _persist_blocks(reg, tables, tables.smem_bytes()) >= shared else name


def _persist_blocks(library: str, tables: KernelTables, smem: int) -> int:
    """Resident blocks per SM of the free-running persist instantiation
    ``tables`` take in ``library`` at ``smem`` bytes of tables (plus the
    library's spectral state)."""
    out = (ctypes.c_int * 3)()
    _raise_on(_persist_info(library)(tables.config.n_samples, int(tables.many_objects()),
                                     int(tables.triangles), 0, smem, out),
              f"spectral_persist_info of {library}")
    return out[0]


@functools.cache
def _persist_info(library: str):
    build.build_all(build.kind_of(library) + (library,))
    f = build.load(library).spectral_persist_info
    f.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def _entry(fn: str, tables: KernelTables, library: str | None = None, lens: bool = False):
    """Entry point ``fn`` for ``tables`` (``lens``: with a lens table):
    of the library ``library_for`` picks (``persist_library`` for
    ``cuda_persist``), or of the diagnostic
    ``library`` built from that source (``build.VARIANTS``). Raises when
    ``library`` and the tables disagree on features, on the shadow test
    or on the lens."""
    src = _SIGNATURES[fn][0]
    if library is None:
        library = persist_library(tables) if src == "persist" else library_for(src, tables, lens)
    if lens and not build.has_lens(library):
        raise ValueError(f"library {library} has no lens: a lens scene runs on "
                         f"the lens builds only")
    if build.has_features(library) != bool(tables.features):
        raise ValueError(
            f"library {library} is {'' if build.has_features(library) else 'not '}"
            f"a feature build, and the scene has features {tables.features}: "
            "a feature scene runs on the feature builds only, and the reverse"
        )
    if build.has_shadow_interval(library) != tables.shadow_interval:
        raise ValueError(
            f"library {library} is {'' if build.has_shadow_interval(library) else 'not '}"
            "a shadow-interval build, and the tables ask "
            f"shadow_interval={tables.shadow_interval}"
        )
    return _load_entry(fn, library)


@functools.cache
def _load_entry(fn: str, library: str):
    """Entry point ``fn`` of ``library`` with its C signature declared.
    The first call into a library builds it with the others of its kind
    (``build.kind_of``: the main libraries together, the feature builds
    together, and so on)."""
    _src, (head, n_ptrs) = _SIGNATURES[fn]
    build.build_all(build.kind_of(library) + (library,))
    f = getattr(build.load(library), fn)
    f.argtypes = (head + _TABLE_ARGTYPES
                  + (_FEATURE_ARGTYPES if build.has_features(library) else [])
                  + [ctypes.c_void_p] * n_ptrs)
    f.restype = ctypes.c_int
    return f


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed to launch: cudaError_t {err}")


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def run_mono(ox, oy, oz, dx, dy, dz, px, py, frame_id: int,
             tables: KernelTables) -> torch.Tensor:
    """One progressive frame's radiance ``[S, n]`` from the primary lanes
    (``ox..dz`` f32 ``[n]``, ``px``/``py`` int32 ``[n]``). Launches
    ``cuda_mono`` for CUDA tensors, runs the plain version for CPU ones."""
    if not _on_cuda(ox):
        return run_mono_plain(ox, oy, oz, dx, dy, dz, px, py, frame_id, tables)
    out = _launch_mono(_entry("spectral_mono", tables), ox, oy, oz, dx, dy, dz, px, py,
                       frame_id, tables)[0]
    trace.count("launch.mono")
    return out


def run_mono_variant(library: str, ox, oy, oz, dx, dy, dz, px, py, frame_id: int,
                     tables: KernelTables) -> torch.Tensor:
    """``run_mono`` through a diagnostic build of ``mono.cu``
    (``build.VARIANTS``: the earlier design's grid, the stats build), for
    the measurement tools. CUDA tensors only; not counted."""
    return _launch_mono(_entry("spectral_mono", tables, library), ox, oy, oz, dx, dy, dz,
                        px, py, frame_id, tables)[0]


def _launch_mono(fn, ox, oy, oz, dx, dy, dz, px, py, frame_id, tables, cost=False):
    """One ``mono.cu`` launch: the radiance, and with ``cost`` the cost
    plane (else None)."""
    n = ox.shape[0]
    _check_lanes(dict(ox=ox, oy=oy, oz=oz, dx=dx, dy=dy, dz=dz),
                 dict(px=px, py=py), tables, n)
    cfg = tables.config
    out = torch.empty((cfg.n_samples, n), dtype=torch.float32, device=ox.device)
    planes = [out]
    if cost:
        planes.append(torch.empty((n,), dtype=torch.float32, device=ox.device))
    counter = torch.empty((1,), dtype=torch.int32, device=ox.device)  # zeroed by the launch
    err = fn(
        n, cfg.n_samples, cfg.max_bounces, int(frame_id) & 0xFFFFFFFF,
        *_table_args(tables),
        *map(_ptr, (ox, oy, oz, dx, dy, dz, px, py, *planes, counter)), _stream(ox),
    )
    _raise_on(err, "cuda_cost" if cost else "cuda_mono")
    return out, (planes[1] if cost else None)


def run_regen(px, py, first_frame: int, camera, offsets, lens,
              tables: KernelTables) -> torch.Tensor:
    """The SUM of K progressive frames' radiance ``[S, n]`` in one launch.
    Lane ``i`` traces pixel ``(px[i], py[i])`` (int32 ``[n]``); frame j
    (``first_frame + j``) starts from the camera along the direction the
    kernel computes from ``camera`` (``camera.camera_basis_table``, f32
    ``[20]``) and row j of ``offsets`` (``camera.hammersley_table``, f32
    ``[K, 2]``, K >= 2); with depth of field, from the camera moved by row
    j of ``lens`` (``camera.lens_table``, f32 ``[K, 4]``; None: the
    pinhole) and re-aimed at the focus plane. Launches ``cuda_regen`` for
    CUDA tensors, runs the plain version for CPU ones."""
    if offsets.shape[0] < 2:
        raise ValueError("regen wants k >= 2 (use run_mono)")
    if not _on_cuda(px):
        return run_regen_plain(px, py, first_frame, camera, offsets, lens, tables)
    out = _launch_regen(_entry("spectral_regen", tables, lens=lens is not None), px, py,
                        first_frame, camera, offsets, lens, tables)
    trace.count("launch.regen")
    return out


def run_regen_variant(library: str, px, py, first_frame: int, camera, offsets, lens,
                      tables: KernelTables) -> torch.Tensor:
    """``run_regen`` through a diagnostic build of ``regen.cu``
    (``build.VARIANTS``: the earlier design's grid, the stats build), for
    the measurement tools. CUDA tensors only; not counted."""
    return _launch_regen(_entry("spectral_regen", tables, library, lens is not None), px, py,
                         first_frame, camera, offsets, lens, tables)


def _launch_regen(fn, px, py, first_frame, camera, offsets, lens, tables):
    n = px.shape[0]
    _check_lanes({}, dict(px=px, py=py), tables, n)
    _check_camera(camera, offsets, lens, px.device)
    cfg = tables.config
    out = torch.empty((cfg.n_samples, n), dtype=torch.float32, device=px.device)
    counter = torch.empty((1,), dtype=torch.int32, device=px.device)  # zeroed by the launch
    err = fn(
        n, cfg.n_samples, cfg.max_bounces, int(first_frame) & 0xFFFFFFFF,
        offsets.shape[0], *_table_args(tables),
        *map(_ptr, (px, py, camera, offsets)), None if lens is None else _ptr(lens),
        *map(_ptr, (out, counter)), _stream(px),
    )
    _raise_on(err, "cuda_regen")
    return out


def run_cost(ox, oy, oz, dx, dy, dz, px, py, frame_id: int,
             tables: KernelTables):
    """One frame's radiance ``[S, n]`` and per-lane path cost ``[n]`` f32
    (live bounce iterations: 1 for a lane that dies on its primary trace,
    ``max_bounces`` for one that spends its budget). Launches
    ``cuda_cost`` for CUDA tensors, runs the plain version for CPU ones.
    The radiance is ``run_mono``'s bit for bit."""
    if not _on_cuda(ox):
        return run_cost_plain(ox, oy, oz, dx, dy, dz, px, py, frame_id, tables)
    out = _launch_mono(_entry("spectral_cost", tables), ox, oy, oz, dx, dy, dz, px, py,
                       frame_id, tables, cost=True)
    trace.count("launch.cost")
    return out


def run_cost_variant(library: str, ox, oy, oz, dx, dy, dz, px, py, frame_id: int,
                     tables: KernelTables):
    """``run_cost`` through a diagnostic build of ``mono.cu``
    (``build.VARIANTS``), for the measurement tools. CUDA tensors only;
    not counted."""
    return _launch_mono(_entry("spectral_cost", tables, library), ox, oy, oz, dx, dy, dz,
                        px, py, frame_id, tables, cost=True)


def run_persist(state: PersistState, lead: int, end: int,
                tables: KernelTables, cam: torch.Tensor, ring=None,
                stop: torch.Tensor | None = None, budget: int = 1) -> None:
    """Exactly ``budget`` bounce iterations over the carried lane state
    ``state``, which is updated IN PLACE: the counterpart of the
    reference's ``input_output_aliases`` (``megakernel.py:2242-2245``).
    Lanes restart their pixel's next frame while ``fid + 1 < end``. The
    variant follows from the arguments: ``ring = (x, y, z)`` direction
    planes ``[W, n]`` (W a power of two) give the ring, whose restarts
    are also gated by ``fid + 1 < lead`` and whose ``cam`` needs only the
    camera position; otherwise ``cam`` is the ``[20]`` camera table
    (``camera.camera_basis_table``) and restarts recompute raygen, with
    ``stop`` (f32 ``[n]``, > 0 holds a lane's restarts) for lane-stop.
    Launches ``cuda_persist`` for CUDA tensors, runs the plain version
    for CPU ones."""
    if not _on_cuda(state.ox):
        return run_persist_plain(state, lead, end, tables, cam, ring=ring,
                                 stop=stop, budget=budget)
    _refuse_shadow_interval(tables, "cuda_persist")
    _launch_persist(_entry("spectral_persist", tables), state, lead, end, tables, cam,
                    ring, stop, budget)
    trace.count("launch.persist")


def run_persist_variant(library: str, state: PersistState, lead: int, end: int,
                        tables: KernelTables, cam: torch.Tensor, ring=None,
                        stop: torch.Tensor | None = None, budget: int = 1) -> None:
    """``run_persist`` through a diagnostic build of ``persist.cu``
    (``build.VARIANTS``: the earlier design's registers, the stats
    build), for the measurement tools. CUDA tensors only; not counted."""
    _refuse_shadow_interval(tables, "cuda_persist")
    _launch_persist(_entry("spectral_persist", tables, library), state, lead, end, tables,
                    cam, ring, stop, budget)


def _launch_persist(fn, state, lead, end, tables, cam, ring, stop, budget):
    n = state.ox.shape[0]
    cfg = tables.config
    planes = {k: v for k, v in state.planes().items() if k not in ("thr", "rad")}
    ints = {k: planes.pop(k) for k in ("bl", "fid", "px", "py")}
    if stop is not None:
        planes["stop"] = stop
    _check_lanes(planes, ints, tables, n)
    _check_spectral(state, n, cfg.n_samples)
    ring_w = 0
    ring_ptrs = (None, None, None)
    if ring is not None:
        if stop is not None:
            raise ValueError("the ring variant takes no stop mask")
        ring_w = ring[0].shape[0]
        if ring_w < 2 or ring_w & (ring_w - 1):
            raise ValueError(f"the ring needs a power-of-two W >= 2, got {ring_w}")
        _check_lanes(dict(ringx=ring[0], ringy=ring[1], ringz=ring[2]), {}, tables, n)
        if any(r.shape != (ring_w, n) for r in ring):
            raise ValueError(f"ring planes must be [{ring_w}, {n}]")
        ring_ptrs = tuple(_ptr(r) for r in ring)
    want = 3 if ring is not None else CAM_BASIS
    if (cam.device != state.ox.device or cam.dtype != torch.float32
            or not cam.is_contiguous() or cam.numel() < want):
        raise ValueError(f"cam must be a contiguous float32 table of >= {want} "
                         "values on the lanes' device")
    if int(budget) < 1:
        raise ValueError("budget must be >= 1")
    carried = [getattr(state, k) for k in (
        "ox", "oy", "oz", "dx", "dy", "dz", "alive", "gate", "hero", "bl", "fid",
        "px", "py")]
    err = fn(
        n, cfg.n_samples, cfg.max_bounces, int(budget),
        int(lead) & 0xFFFFFFFF, int(end) & 0xFFFFFFFF, ring_w,
        *_table_args(tables),
        *map(_ptr, carried), None if stop is None else _ptr(stop), _ptr(cam),
        *ring_ptrs, _ptr(state.thr), _ptr(state.rad), _stream(state.ox),
    )
    _raise_on(err, "cuda_persist")


def run_seg(wf: Wavefront, b_start: int, b_stop: int, frame_id: int,
            tables: KernelTables) -> None:
    """Bounces ``[b_start, b_stop)`` of one frame's wavefront ``wf``,
    updated IN PLACE: a live lane enters with ``max_bounces - b_start``
    bounces left and the frame id ``frame_id``, and carries its ray,
    gate, throughput and radiance (the reference's ``run_seg``,
    ``megakernel.py:2342``). Launches ``cuda_seg`` for CUDA tensors, runs
    the plain version for CPU ones."""
    cfg = tables.config
    b_start, b_stop = int(b_start), int(b_stop)
    if not 0 <= b_start < b_stop <= cfg.max_bounces:
        raise ValueError(f"segment [{b_start}, {b_stop}) is not inside "
                         f"[0, {cfg.max_bounces})")
    if not _on_cuda(wf.ox):
        return run_seg_plain(wf, b_start, b_stop, frame_id, tables)
    _refuse_shadow_interval(tables, "cuda_seg")
    _launch_seg(_entry("spectral_seg", tables), wf, b_start, b_stop, frame_id, tables)
    trace.count("launch.seg")


def run_seg_variant(library: str, wf: Wavefront, b_start: int, b_stop: int,
                    frame_id: int, tables: KernelTables) -> None:
    """``run_seg`` through a diagnostic build of ``seg.cu``
    (``build.VARIANTS``), for the measurement tools. CUDA tensors only;
    not counted."""
    _launch_seg(_entry("spectral_seg", tables, library), wf, int(b_start), int(b_stop),
                frame_id, tables)


def _launch_seg(fn, wf, b_start, b_stop, frame_id, tables):
    cfg = tables.config
    n = wf.ox.shape[0]
    planes = {k: v for k, v in wf.planes().items() if k not in ("thr", "rad")}
    ints = {k: planes.pop(k) for k in ("px", "py")}
    _check_lanes(planes, ints, tables, n)
    _check_spectral(wf, n, cfg.n_samples)
    err = fn(
        n, cfg.n_samples, cfg.max_bounces, b_start, b_stop,
        int(frame_id) & 0xFFFFFFFF, *_table_args(tables),
        *map(_ptr, (wf.ox, wf.oy, wf.oz, wf.dx, wf.dy, wf.dz, wf.alive,
                    wf.gate, wf.hero, wf.px, wf.py, wf.thr, wf.rad)), _stream(wf.ox),
    )
    _raise_on(err, "cuda_seg")
