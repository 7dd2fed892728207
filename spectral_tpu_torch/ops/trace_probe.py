"""The nearest ray-sphere hit as a scalar loop and as matrix products: the
port of the JAX package's trace probe (``tools/mxu_trace_probe.py``), its
two TPU kernels and their inputs.

* ``make_inputs`` builds the probe's numpy inputs from a seed, op for op
  as the reference tool does (``tools/mxu_trace_probe.py:208-234``);
* ``probe_fori_plain`` / ``probe_mma_plain`` are the plain PyTorch
  versions of its two kernels (``build_a`` :40, ``build_b`` :104);
* ``probe_exact`` evaluates kernel B's formula in float64, and
  ``error_bound`` bounds each ray's float32 error against it from the
  error of its two dot products (``compare`` reports both);
* ``cuda_probe_fori`` / ``cuda_probe_mma`` launch their CUDA kernels
  (``ops/csrc/probe.cu``) on CUDA tensors and count their launches
  (``runtime.trace``'s ``launch.probe_fori``, ``launch.probe_mma``), and run the plain version on CPU tensors;
  ``probe_layout`` reads from a build how many spheres its kernels hold
  (the wrappers refuse more before any launch);
* ``fori_root_pairs`` / ``mma_root_pairs`` count the pairs whose
  discriminant is positive, the pairs that need the root stage
  (``utils/flops.py``: ``probe_terms``).

The contract of both (the probe's, not the bounce kernels'): a sphere is
hit where ``disc > 0`` and the chosen root is ``> 0`` (strict), the roots
are ``(-b -+ sqrt(disc)) * inv2a`` with the reciprocal ``inv2a = 1 / 2a``,
the nearer positive root wins, and the nearest sphere wins with ties to
the lowest index. ``t`` is +inf and the winner -1.0 (f32) on a miss.

Rounding. The reference's kernels, as XLA builds them for the CPU where
the JAX package's tests run them, contract multiply-add pairs into fused
multiply-adds (XLA's CPU compiler always allows it): each 3-term dot
product is ``fma(x2, y2, fma(x0, y0, x1 * y1))``, kernel B's products a
chain ``fma(x_k, y_k, acc)`` from ``x0 * y0``, and ``disc`` is ``fma(b,
b, -(4a * c))``. Those roundings decide t where ``b^2`` and ``4ac``
cancel, so the plain versions (``fma``) and the CUDA kernels (``fmaf``)
take the same ones, and the three agree bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from spectral_tpu_torch.ops.vecmath import sqrt
from spectral_tpu_torch.runtime import build, trace

LANE = 128
R8 = 32  # ray rows per tile of kernel A: 4096 rays per tile
N_RAYS = R8 * LANE
N_OBJ = 1024
N_TILES = 48  # 196,608 rays at the tool's full shape
BLOCK_OBJ = 128  # objects per block of kernel B (its lane argmin)
INF = float("inf")
# How close ``cuda_probe_mma`` (3xTF32) must come, as the card tests and
# ``chip_smoke.py`` hold it: the plain version's winners on this share of
# rays, and against ``probe_exact`` (float64) every hit within its own
# ``error_bound`` at ``MMA_DOT_GAMMA`` and at least this share of hits
# within 1e-5. The formula cancels (``b = 2 (d.o - d.c)``), so no float32
# evaluation is within 1e-5 of float64 on every hit (the plain version:
# 99.3-99.99% of hits), nor of another float32 evaluation. The share and
# the winners were read with the probe tool's ``accuracy`` lines on an
# H100 (196,608 rays, 40 seeds at 256 to 3,072 spheres: the kernel's share
# 98.23-99.99%, its winners 99.997-100%; PERF.md).
MMA_WINNERS_MIN = 0.9999
MMA_SHARE_1E5_MIN = 0.98

U32 = 2.0 ** -24  # float32's unit roundoff
# the error of a 3-term dot product, as a multiple of the sum of its terms'
# magnitudes (``error_bound``): the plain version's chain of fused
# multiply-adds rounds three times; 3xTF32 drops lo*lo and rounds both
# residuals to TF32 (at most 4 U32 each, 12 in all), and the last of the
# three MMAs adds four terms in float32, truncating each to the largest
# one's ulp and its sum once more (10 U32)
PLAIN_DOT_GAMMA = 3 * U32
MMA_DOT_GAMMA = 22 * U32


def make_inputs(seed: int = 0, n_tiles: int = N_TILES, n_obj: int = N_OBJ) -> dict:
    """The probe's inputs as numpy float32, in the reference tool's op
    order: ``"fori"`` is kernel A's ``(geom [n_obj, 4], ox, oy, oz, dx,
    dy, dz [n_tiles * 32, 128])``, ``"mma"`` kernel B's ``(dmat, omat
    [n, 8], cmat [8, n_obj], cc [1, n_obj], do, oo, a [n, 1])``."""
    rng = np.random.default_rng(seed)
    n_total = n_tiles * N_RAYS
    o = rng.uniform(-1, 1, (n_total, 3)).astype(np.float32)
    d = rng.normal(size=(n_total, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    centers = rng.uniform(-30, 30, (n_obj, 3)).astype(np.float32)
    radii = rng.uniform(0.5, 2.0, (n_obj,)).astype(np.float32)
    geom = np.concatenate([centers, (radii ** 2)[:, None]], axis=1)

    def lanes(v):
        return np.ascontiguousarray(v.reshape(n_tiles * R8, LANE))

    def pad8(m):
        return np.pad(m, ((0, 0), (0, 8 - m.shape[1])))

    fori = (geom,) + tuple(lanes(v) for v in (o[:, 0], o[:, 1], o[:, 2],
                                               d[:, 0], d[:, 1], d[:, 2]))
    mma = (
        pad8(d), pad8(o), np.ascontiguousarray(pad8(centers).T),
        ((centers ** 2).sum(axis=1) - radii ** 2)[None, :],
        (d * o).sum(axis=1, keepdims=True), (o * o).sum(axis=1, keepdims=True),
        (d * d).sum(axis=1, keepdims=True),
    )
    return {"fori": fori, "mma": tuple(np.ascontiguousarray(a, np.float32) for a in mma)}


def fma(x, y, z):
    """float32 ``x * y + z`` with one rounding: the product of two float32
    values is exact in float64, and the sum is rounded to float64 and
    then to float32 (the same as one rounding but where the float64 sum
    lands on a float32 tie, about 2^-29 of inputs)."""
    return (x.double() * y.double() + z.double()).float()


def dot3(x0, x1, x2, y0, y1, y2):
    """A 3-term dot product as the reference's CPU build contracts it."""
    return fma(x2, y2, fma(x0, y0, x1 * y1))


def _roots(b, c, foura, inv2a):
    """The probe's quadratic: the nearer positive root, +inf where
    ``disc <= 0`` or no root is positive."""
    disc = fma(b, b, -(foura * c))
    sq = sqrt(torch.clamp_min(disc, 0.0))
    t1 = (-b - sq) * inv2a
    t2 = (-b + sq) * inv2a
    t = torch.where(t1 > 0.0, t1, t2)
    return torch.where((disc > 0.0) & (t > 0.0), t, INF)


def _first_min(t: torch.Tensor):
    """Row minimum and the lowest column attaining it."""
    tb, _ = torch.min(t, dim=1)
    col = torch.arange(t.shape[1], device=t.device, dtype=torch.float32)
    idx = torch.min(torch.where(t == tb[:, None], col, float(t.shape[1])), dim=1)[0]
    return tb, idx


def _fori_blocks(geom, ox, oy, oz, dx, dy, dz):
    """Kernel A's quadratic per block of ``BLOCK_OBJ`` spheres, op for op
    as its loop: ``(first sphere, b, c, 4a, 1 / 2a)``, ``b`` and ``c``
    ``[n, block]``."""
    ox, oy, oz, dx, dy, dz = (v.reshape(-1, 1) for v in (ox, oy, oz, dx, dy, dz))
    a = dot3(dx, dy, dz, dx, dy, dz)
    inv2a = 1.0 / (2.0 * a)
    foura = 4.0 * a
    for lo in range(0, geom.shape[0], BLOCK_OBJ):
        g = geom[lo:lo + BLOCK_OBJ]
        rx, ry, rz = ox - g[None, :, 0], oy - g[None, :, 1], oz - g[None, :, 2]
        b = 2.0 * dot3(dx, dy, dz, rx, ry, rz)
        c = dot3(rx, ry, rz, rx, ry, rz) - g[None, :, 3]
        yield lo, b, c, foura, inv2a


def probe_fori_plain(geom, ox, oy, oz, dx, dy, dz):
    """Kernel A (``build_a``): every ray against every sphere of ``geom``
    (``[n_obj, 4]``: cx, cy, cz, r^2) in index order, strict ``<``.
    Returns ``(t_best, winner)`` shaped like ``ox``. The spheres are
    taken in blocks of 128 (per-element ops as the loop's; a block's
    first minimum, then strict ``<`` across blocks, is the loop's
    winner)."""
    t_best = torch.full((ox.numel(),), INF, dtype=torch.float32, device=ox.device)
    win = torch.full_like(t_best, -1.0)
    for lo, b, c, foura, inv2a in _fori_blocks(geom, ox, oy, oz, dx, dy, dz):
        tb, idx = _first_min(_roots(b, c, foura, inv2a))
        closer = tb < t_best
        t_best = torch.where(closer, tb, t_best)
        win = torch.where(closer, idx + float(lo), win)
    return t_best.reshape(ox.shape), win.reshape(ox.shape)


def fori_root_pairs(geom, ox, oy, oz, dx, dy, dz) -> int:
    """The ray-sphere pairs of kernel A's inputs whose discriminant is
    positive (``disc > 0`` as the plain version computes it): the pairs
    that need the root stage."""
    return sum(int((fma(b, b, -(foura * c)) > 0.0).sum())
               for _lo, b, c, foura, _inv in _fori_blocks(geom, ox, oy, oz, dx, dy, dz))


def _mma_blocks(dmat, omat, cmat, cc, do, oo, a):
    """Kernel B's quadratic per block of ``BLOCK_OBJ`` spheres: ``(first
    sphere, b, c, 4a, 1 / 2a)``, ``d.c`` and ``o.c`` as float32 products
    over the 8 padded components (a chain of fused multiply-adds)."""
    inv2a = 1.0 / (2.0 * a)
    foura = 4.0 * a
    for lo in range(0, cmat.shape[1], BLOCK_OBJ):
        cblk = cmat[:, lo:lo + BLOCK_OBJ]
        dc = dmat[:, 0:1] * cblk[0]
        oc = omat[:, 0:1] * cblk[0]
        for k in range(1, cmat.shape[0]):
            dc = fma(dmat[:, k:k + 1], cblk[k], dc)
            oc = fma(omat[:, k:k + 1], cblk[k], oc)
        b = 2.0 * (do - dc)
        c = oo - 2.0 * oc + cc[:, lo:lo + BLOCK_OBJ]
        yield lo, b, c, foura, inv2a


def probe_mma_plain(dmat, omat, cmat, cc, do, oo, a):
    """Kernel B (``build_b``): per block of 128 spheres, ``d.c`` and
    ``o.c`` as float32 products over the 8 padded components, the
    quadratic elementwise, the block's first minimum, then strict ``<``
    across blocks. Returns ``(t_best, winner)`` ``[n, 1]``."""
    t_best = torch.full((dmat.shape[0], 1), INF, dtype=torch.float32, device=dmat.device)
    win = torch.full_like(t_best, -1.0)
    for lo, b, c, foura, inv2a in _mma_blocks(dmat, omat, cmat, cc, do, oo, a):
        tb, idx = _first_min(_roots(b, c, foura, inv2a))
        closer = tb[:, None] < t_best
        t_best = torch.where(closer, tb[:, None], t_best)
        win = torch.where(closer, idx[:, None] + float(lo), win)
    return t_best, win


def mma_root_pairs(dmat, omat, cmat, cc, do, oo, a) -> int:
    """The ray-sphere pairs of kernel B's inputs whose discriminant is
    positive, as its plain version computes it."""
    return sum(int((fma(b, b, -(foura * c)) > 0.0).sum())
               for _lo, b, c, foura, _inv in _mma_blocks(dmat, omat, cmat, cc, do, oo, a))


def probe_exact(dmat, omat, cmat, cc, do, oo, a):
    """Kernel B's formula in float64 (the inputs widened, no rounding
    between the steps): the yardstick of both float32 forms. Returns
    ``(t_best, winner)`` ``[n, 1]`` float64, ties to the lowest index.
    Both float32 forms sit about 1e-4 relative from it at worst: ``b =
    2 (d.o - d.c)`` cancels, so one rounding of ``d.c`` moves the root of a
    grazing ray by many ulps."""
    dmat, omat, cmat, cc, do, oo, a = (x.double() for x in (dmat, omat, cmat, cc, do, oo, a))
    n = dmat.shape[0]
    t_best = torch.full((n, 1), INF, dtype=torch.float64, device=dmat.device)
    win = torch.full_like(t_best, -1.0)
    for lo in range(0, cmat.shape[1], BLOCK_OBJ):
        cblk = cmat[:, lo:lo + BLOCK_OBJ]
        b = 2.0 * (do - dmat @ cblk)
        c = oo - 2.0 * (omat @ cblk) + cc[:, lo:lo + BLOCK_OBJ]
        disc = b * b - 4.0 * a * c
        sq = torch.sqrt(torch.clamp_min(disc, 0.0))
        t1, t2 = (-b - sq) / (2.0 * a), (-b + sq) / (2.0 * a)
        t = torch.where(t1 > 0.0, t1, t2)
        tb, idx = _first_min(torch.where((disc > 0.0) & (t > 0.0), t, INF))
        closer = tb[:, None] < t_best
        t_best = torch.where(closer, tb[:, None], t_best)
        win = torch.where(closer, idx[:, None].double() + float(lo), win)
    return t_best, win


def error_bound(dmat, omat, cmat, cc, do, oo, a, win, dot_gamma: float) -> torch.Tensor:
    """A first-order bound on ``|t - t_exact|`` for a float32 evaluation of
    kernel B's formula at sphere ``win`` of each ray (float64 ``[n]``;
    meaningless where ``win < 0``). Its two dot products err by at most
    ``dot_gamma`` times the sum of their terms' magnitudes; every later
    step (``b``, ``c``, ``4ac``, the fused ``disc``, the square root, the
    root and its product with ``1 / 2a``) rounds once, as the plain
    version and the kernel do. ``b = 2 (d.o - d.c)`` cancels, so the bound
    follows each ray's own conditioning: it grows as ``sqrt(disc)`` goes to
    0, where the root's error is at most the square root of the error of
    ``disc``."""
    u = U32
    j = win.reshape(-1).clamp_min(0).long()
    cw = cmat.double()[:3, j].T  # the winner's centre; components 3-7 are padding
    dxc, oxc = dmat.double()[:, :3] * cw, omat.double()[:, :3] * cw
    dc, oc = dxc.sum(1), oxc.sum(1)
    a, do, oo = (x.double().reshape(-1) for x in (a, do, oo))
    ccw = cc.double().reshape(-1)[j]
    b, c = 2.0 * (do - dc), oo - 2.0 * oc + ccw
    sq = torch.sqrt(torch.clamp_min(b * b - 4.0 * a * c, 0.0))
    e_dc, e_oc = dot_gamma * dxc.abs().sum(1), dot_gamma * oxc.abs().sum(1)
    db = 2.0 * (e_dc + u * (do.abs() + dc.abs() + e_dc))
    dcc = 2.0 * e_oc + 2.0 * u * (oo.abs() + 2.0 * (oxc.abs().sum(1) + e_oc) + ccw.abs())
    d4ac = 4.0 * a * (dcc + u * (c.abs() + dcc))
    ddisc = (2.0 * b.abs() * db + db * db + d4ac
             + u * ((b.abs() + db) ** 2 + 4.0 * a * (c.abs() + dcc)))
    dsq = torch.minimum(ddisc / sq, torch.sqrt(ddisc))
    dsq = dsq + u * (sq + dsq)
    return (db + dsq + 3.0 * u * (b.abs() + sq + db + dsq)) / (2.0 * a)


def compare(t, win, t_ref, win_ref, bound=None) -> dict:
    """Winner agreement (a miss agrees with a miss) and the relative t
    difference on rays that both hit with the same winner; with a per-ray
    ``bound`` on ``|t - t_ref|`` (``error_bound``), also the largest ratio
    of a hit's error to its bound."""
    t, win, t_ref, win_ref = (x.reshape(-1).double() for x in (t, win, t_ref, win_ref))
    same = win == win_ref
    both = same & torch.isfinite(t) & torch.isfinite(t_ref)
    err = (t - t_ref).abs()[both]
    rel = err / t_ref.abs()[both]
    out = dict(winner_agreement=float(same.double().mean()),
               max_t_rel=float(rel.max()) if rel.numel() else 0.0,
               hits=int(both.sum()),
               share_within_1e5=float((rel <= 1e-5).double().mean()) if rel.numel() else 1.0)
    if bound is not None:
        ratio = err / bound.reshape(-1).double()[both]
        out["max_err_over_bound"] = float(ratio.max()) if ratio.numel() else 0.0
    return out


# ------------------------------------------------------------------ kernels


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _check(tensors: dict, shapes: dict) -> torch.device:
    dev = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 on {dev}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} is {tuple(t.shape)}, expected {shapes[name]}")
    if dev.type != "cuda":
        raise ValueError(f"no probe kernel for device {dev}")
    return dev


@functools.cache
def _lib(name: str = "probe") -> ctypes.CDLL:
    """``probe.cu`` built as library ``name`` (``build.LIBRARIES``)."""
    lib = build.load(name)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.spectral_probe_fori.argtypes = [ci, ci] + [vp] * 10
    lib.spectral_probe_mma.argtypes = [ci, ci] + [vp] * 11
    lib.spectral_probe_info.argtypes = [ci, vp]
    lib.spectral_probe_fori.restype = lib.spectral_probe_mma.restype = ci
    lib.spectral_probe_info.restype = ci
    return lib


def probe_layout(library: str, n_obj: int) -> dict:
    """What the build ``library`` of ``probe.cu`` holds (its
    ``spectral_probe_info``, so the layout has one source): the most
    spheres a block of each kernel keeps in shared memory (``"fori"``,
    ``"mma"``), and the floats of the tensor-core kernel's scratch at
    ``n_obj`` spheres (``"mma_scratch"``: its split table and tile
    counter)."""
    out = (ctypes.c_int * 3)()
    err = _lib(library).spectral_probe_info(n_obj, out)
    if err != 0:
        raise RuntimeError(f"spectral_probe_info failed: cudaError_t {err}")
    return {"fori": out[0], "mma": out[1], "mma_scratch": out[2]}


def _layout(kernel: str, n_obj: int) -> dict:
    """``probe_layout``; raises before any launch where a block of
    ``kernel`` cannot hold ``n_obj`` spheres."""
    layout = probe_layout("probe", n_obj)
    if n_obj > layout[kernel]:
        raise ValueError(f"{n_obj} spheres need more shared memory than a block of "
                         f"cuda_probe_{kernel} has: it holds {layout[kernel]}")
    return layout


def _stream(dev) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _launch_fori(geom, ox, oy, oz, dx, dy, dz):
    n_obj = geom.shape[0]
    planes = dict(ox=ox, oy=oy, oz=oz, dx=dx, dy=dy, dz=dz)
    dev = _check({"geom": geom, **planes},
                 {"geom": (n_obj, 4), **{k: tuple(ox.shape) for k in planes}})
    _layout("fori", n_obj)
    t = torch.empty_like(ox)
    win = torch.empty_like(ox)
    err = _lib().spectral_probe_fori(ox.numel(), n_obj, _ptr(geom),
                                     *map(_ptr, planes.values()), _ptr(t), _ptr(win),
                                     _stream(dev))
    if err != 0:
        raise RuntimeError(f"cuda_probe_fori failed to launch: cudaError_t {err}")
    return t, win


def _launch_mma(dmat, omat, cmat, cc, do, oo, a):
    n, n_obj = dmat.shape[0], cmat.shape[1]
    if n_obj < 8 or n_obj % 8:
        raise ValueError(f"the sphere count must be a positive multiple of 8, got {n_obj}")
    args = dict(dmat=dmat, omat=omat, cmat=cmat, cc=cc, do=do, oo=oo, a=a)
    dev = _check(args, dict(dmat=(n, 8), omat=(n, 8), cmat=(8, n_obj), cc=(1, n_obj),
                            do=(n, 1), oo=(n, 1), a=(n, 1)))
    layout = _layout("mma", n_obj)
    t = torch.empty((n, 1), dtype=torch.float32, device=dev)
    win = torch.empty_like(t)
    # the split table (written by the launch's prologue) and the tile counter
    scratch = torch.empty((layout["mma_scratch"],), dtype=torch.float32, device=dev)
    err = _lib().spectral_probe_mma(n, n_obj, *map(_ptr, args.values()), _ptr(scratch),
                                    _ptr(t), _ptr(win), _stream(dev))
    if err != 0:
        raise RuntimeError(f"cuda_probe_mma failed to launch: cudaError_t {err}")
    return t, win


def cuda_probe_fori(geom, ox, oy, oz, dx, dy, dz):
    """Kernel A's contract; launches the scalar-loop kernel for CUDA
    tensors, runs ``probe_fori_plain`` for CPU ones."""
    if ox.device.type == "cpu":
        return probe_fori_plain(geom, ox, oy, oz, dx, dy, dz)
    out = _launch_fori(geom, ox, oy, oz, dx, dy, dz)
    trace.count("launch.probe_fori")
    return out


def cuda_probe_mma(dmat, omat, cmat, cc, do, oo, a):
    """Kernel B's contract; launches the tensor-core kernel for CUDA
    tensors, runs ``probe_mma_plain`` for CPU ones. The products run as
    TF32 split three ways (3xTF32), close to float32 but not its bits."""
    if dmat.device.type == "cpu":
        return probe_mma_plain(dmat, omat, cmat, cc, do, oo, a)
    out = _launch_mma(dmat, omat, cmat, cc, do, oo, a)
    trace.count("launch.probe_mma")
    return out

