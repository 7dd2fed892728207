// Table layout shared by the bounce kernels (bounce.cuh and the kernel
// sources beside it) and their host packer
// (spectral_tpu_torch/ops/megakernel.py, which mirrors these rows).
//
// geom: float32 [GEOM_ROWS][n_obj], one row per field, struct of arrays:
// a block's cooperative load into shared memory is contiguous, and in
// global memory the rows a loop reads for consecutive objects share
// cache lines.
#pragma once

namespace spectral {

constexpr int OBJ_PLAIN_BOX = 0;
constexpr int OBJ_SPHERE = 1;
constexpr int OBJ_ROTATED_BOX = 2;
constexpr int OBJ_TRIANGLE = 3;

constexpr int G_TYPE = 0;        // object type tag, as float
constexpr int G_SLAB_MIN = 1;    // 1-3: slab minimum in the object frame
constexpr int G_SLAB_MAX = 4;    // 4-6: slab maximum in the object frame
constexpr int G_SHIFT = 7;       // 7-9: world -> object translation
constexpr int G_INV_ROT = 10;    // 10-18: world -> object rotation, row-major
constexpr int G_ROT = 19;        // 19-27: object -> world rotation, row-major
constexpr int G_AABB_MIN = 28;   // 28-30: world AABB (plain-box normals)
constexpr int G_AABB_MAX = 31;   // 31-33
constexpr int G_CENTER = 34;     // 34-36: rotated-box centre (normals)
constexpr int G_HALF = 37;       // 37-39: rotated-box half extents (normals)
constexpr int G_SPHERE_POS = 40; // 40-42: sphere centre
constexpr int G_RADIUS = 43;
constexpr int G_METAL = 44;
constexpr int G_ROUGH = 45;
constexpr int G_MATID = 46;      // material id, as float (mat_albedo row)
constexpr int GEOM_ROWS = 47;
// A triangle row (a mesh face) reuses the box rows: G_SHIFT holds v0,
// G_SLAB_MIN e1 = v1 - v0, G_SLAB_MAX e2 = v2 - v0, and the three
// G_INV_ROT rows the shading normal as n0, n1 - n0, n2 - n0 (zero deltas
// for a flat mesh).

// mat_albedo: float32 [n_mat][S], read through the winner's material id;
// lpos: float32 [n_lights][4] (x, y, z, pad); lspec: float32
// [n_lights][S]; cam: float32 [4] (camera position, pad).
//
// The object loop walks runs of objects: order: int32 [n_obj], object
// indices in visit order; runs: float32 [n_runs][RUN_COLS], each run the
// members order[start, stop). A culled run (a cluster) is skipped by a
// ray that cannot enter its union AABB before its current best hit; an
// unculled run is always visited. A run of a cluster plan holds one
// object type (RUN_TYPE); the one run of an unclustered walk has -1 and
// its members say their own type.
constexpr int RUN_MIN = 0;    // 0-2: union AABB minimum
constexpr int RUN_MAX = 3;    // 3-5: union AABB maximum
constexpr int RUN_START = 6;  // first member slot in order[], as float
constexpr int RUN_STOP = 7;   // one past the last member slot, as float
constexpr int RUN_CULL = 8;   // 1.0: a cluster (pre-tested), 0.0: always visited
constexpr int RUN_TYPE = 9;   // the members' object type, as float; -1: mixed
constexpr int RUN_PACK = 10;  // first packed record of the run, as float; -1: none
constexpr int RUN_COLS = 11;

// packed: float4 [n_packed], the intersection fields of the members of
// every sphere and triangle run, in visit order (ops/megakernel.py:
// pack_walk): a sphere as (centre, radius), a triangle as (v0, 0),
// (e1, 0), (e2, 0); run R's member at slot k is record RUN_PACK + (k -
// RUN_START) (times three for triangles). Boxes and an unclustered mixed
// run have none and read the 47-row table. The host puts the records in
// shared memory when they fit (packed_shared), else the walk reads them
// from global memory, 16 bytes a load.

// The scene-feature tables, read only by the feature builds (bounce.cuh:
// SPECTRAL_FX): features, a mask of the FX_* bits the scene uses (the
// reference's static gates has_transmission, has_emission,
// textured_static and sky); mat_fx: float32 [n_mat][MAT_FX_COLS], read
// through the winner's material id as mat_albedo is; mat_emission:
// float32 [n_mat][S]; lambda: float32 [S], the wavelength grid in nm;
// sky: float32 [S] (zeros without FX_SKY).
constexpr int FX_TRANSMISSION = 1;
constexpr int FX_EMISSION = 2;
constexpr int FX_TEXTURE = 4;
constexpr int FX_SKY = 8;
constexpr int MF_TRANSMISSION = 0;  // probability of the dielectric branch
constexpr int MF_IOR = 1;           // base index of refraction
constexpr int MF_CAUCHY = 2;        // Cauchy B in um^2 (> 0: dispersive)
constexpr int MF_TEX_SCALE = 3;     // checker cell side (0: untextured)
constexpr int MF_TEX_LOW = 4;       // checker factor of the odd cells
constexpr int MAT_FX_COLS = 5;

// The camera basis of the regeneration kernel and the free-running
// persist kernel, float32 [CAM_BASIS] (the TPU kernel's pack_camera_basis
// columns; packed by spectral_tpu_torch/render/camera.py:
// camera_basis_table). With depth of field the regeneration kernel also
// takes a [K][4] table of per-frame lens shifts (x, y, z, pad;
// camera.py:lens_table).
constexpr int CB_POS = 0;      // 0-2: camera position
constexpr int CB_FWD = 3;      // 3-5: forward
constexpr int CB_RIGHT = 6;    // 6-8: right
constexpr int CB_UP = 9;       // 9-11: true up
constexpr int CB_FOCAL = 12;   // focal distance
constexpr int CB_ASPECT = 13;  // aspect ratio
constexpr int CB_WIDTH = 14;   // image width, as float
constexpr int CB_HEIGHT = 15;  // image height, as float
constexpr int CB_FRAMES = 16;  // intended frames (Hammersley N), as float
constexpr int CB_FOCUS = 17;   // focus distance with depth of field (else 0)
constexpr int CAM_BASIS = 20;  // 18-19: pad

// scenes of up to SMEM_OBJECTS objects keep geom in shared memory; larger
// ones read it from global memory through L1 (every lane of a warp reads
// the same object, so each load is a broadcast)
constexpr int SMEM_OBJECTS = 64;
constexpr int BLOCK = 128;       // threads per block, one pixel-lane each
constexpr int MAX_SMEM = 232448;  // bytes of shared memory a block may use

}  // namespace spectral
