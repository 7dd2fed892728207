"""The trace probe's plain versions (``spectral_tpu_torch/ops/trace_probe.py``)
against the JAX package's probe kernels (``tools/mxu_trace_probe.py``:
``build_a``, the scalar loop over spheres, and ``build_b``, the 128-sphere
blocks of matrix products), run here in Pallas interpret mode at a small
size: the tool's module is imported as it is and its ``pl`` and sizes are
replaced for the test (``N_TILES = 2``, ``N_OBJ = 256``).

Tolerances: winners exact; kernel A's t within 1 ulp, kernel B's hit t
within 1e-6 relative. Both plain versions take the reference's float32
ops and the fused multiply-adds of its CPU build (``trace_probe``'s
docstring), so both agree to the bit here; the bounds leave room for an
XLA that contracts otherwise. The per-ray error bound that the tensor-core
kernel is held to on the card (``error_bound``) is checked here against
the plain version and against dot products of TF32-rounded operands.
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from spectral_tpu_torch.ops import trace_probe as tp

torch.set_num_threads(1)

TOOL = Path(__file__).resolve().parents[1] / "tools" / "mxu_trace_probe.py"
N_TILES, N_OBJ = 2, 256


class _InterpretPallas:
    """``pallas`` with every ``pallas_call`` in interpret mode."""

    pallas_call = staticmethod(functools.partial(pl.pallas_call, interpret=True))

    def __getattr__(self, name):
        return getattr(pl, name)


@pytest.fixture(scope="module")
def probe():
    spec = importlib.util.spec_from_file_location("mxu_trace_probe_under_test", TOOL)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    tool.pl = _InterpretPallas()
    tool.N_TILES, tool.N_OBJ = N_TILES, N_OBJ
    tool.N_TILES_B = N_TILES * tool.N_RAYS // tool.NRB
    inputs = tp.make_inputs(0, N_TILES, N_OBJ)
    ta, ia = tool.build_a()(*map(jnp.asarray, inputs["fori"]))
    tb, ib = tool.build_b()(*map(jnp.asarray, inputs["mma"]))
    jax.block_until_ready((ta, tb))
    return inputs, tuple(np.asarray(x) for x in (ta, ia, tb, ib))


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def test_make_inputs_shapes_and_tool_constants():
    spec = importlib.util.spec_from_file_location("mxu_trace_probe_constants", TOOL)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert (tp.LANE, tp.R8, tp.N_OBJ, tp.N_TILES) == (tool.LANE, tool.R8, tool.N_OBJ,
                                                      tool.N_TILES)
    inp = tp.make_inputs(0, N_TILES, N_OBJ)
    n = N_TILES * tp.N_RAYS
    assert [a.shape for a in inp["fori"]] == [(N_OBJ, 4)] + [(N_TILES * 32, 128)] * 6
    assert [a.shape for a in inp["mma"]] == [(n, 8), (n, 8), (8, N_OBJ), (1, N_OBJ),
                                             (n, 1), (n, 1), (n, 1)]
    assert all(a.dtype == np.float32 for a in inp["fori"] + inp["mma"])


def test_probe_fori_plain_matches_kernel_a(probe):
    inputs, (ta, ia, _tb, _ib) = probe
    t, win = tp.probe_fori_plain(*map(torch.from_numpy, inputs["fori"]))
    assert t.shape == ta.shape and win.shape == ia.shape
    assert np.array_equal(win.numpy(), ia)
    hit = np.isfinite(ta)
    assert 0.05 < hit.mean() < 0.95
    assert np.array_equal(np.isfinite(t.numpy()), hit)
    assert int(_ulps(t.numpy()[hit], ta[hit]).max()) <= 1


def test_probe_mma_plain_matches_kernel_b(probe):
    inputs, (ta, ia, tb, ib) = probe
    t, win = tp.probe_mma_plain(*map(torch.from_numpy, inputs["mma"]))
    assert t.shape == tb.shape == (N_TILES * tp.N_RAYS, 1)
    assert np.array_equal(win.numpy(), ib)
    hit = np.isfinite(tb)
    assert np.array_equal(np.isfinite(t.numpy()), hit)
    rel = np.abs(t.numpy()[hit] - tb[hit]) / np.abs(tb[hit])
    assert float(rel.max()) <= 1e-6
    # the two kernels agree with each other (the tool's crosscheck)
    assert float((ia.reshape(-1) == ib.reshape(-1)).mean()) == 1.0


def test_wrappers_take_the_plain_path_on_cpu():
    inputs = tp.make_inputs(3, 1, 64)
    fori = tuple(map(torch.from_numpy, inputs["fori"]))
    mma = tuple(map(torch.from_numpy, inputs["mma"]))
    before = (tp.cuda_probe_fori.launches, tp.cuda_probe_mma.launches)
    for wrapper, plain, args in ((tp.cuda_probe_fori, tp.probe_fori_plain, fori),
                                 (tp.cuda_probe_mma, tp.probe_mma_plain, mma)):
        got, want = wrapper(*args), plain(*args)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (tp.cuda_probe_fori.launches, tp.cuda_probe_mma.launches) == before
    # the scalar loop and the block form give the same winners here
    assert np.array_equal(tp.probe_fori_plain(*fori)[1].numpy().reshape(-1),
                          tp.probe_mma_plain(*mma)[1].numpy().reshape(-1))


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits, to nearest, ties away from
    zero), as the tensor cores' ``cvt.rna.tf32.f32`` rounds."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("seed,n_obj", [(0, 256), (9, 1024), (4, 128)])
def test_error_bound_holds_the_plain_version_and_catches_tf32(seed, n_obj):
    """Every hit of the plain version lies within its own first-order bound
    (``error_bound`` at ``PLAIN_DOT_GAMMA``) of a float64 evaluation. The
    bound the tensor-core kernel is held to (``MMA_DOT_GAMMA``, 3xTF32) is
    broken by dot products of TF32-rounded operands, which err by about
    2^-11 of a term: it tells 3xTF32 from a single TF32 product."""
    args = tuple(map(torch.from_numpy, tp.make_inputs(seed, 1, n_obj)["mma"]))
    et, ew = tp.probe_exact(*args)
    pt, pw = tp.probe_mma_plain(*args)
    plain = tp.compare(pt, pw, et, ew, tp.error_bound(*args, ew, tp.PLAIN_DOT_GAMMA))
    assert plain["hits"] > 100 and plain["max_err_over_bound"] <= 1.0
    assert _tf32(torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 3 * 2.0 ** -12)])).tolist() == [
        1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]
    tt, tw = tp.probe_mma_plain(*map(_tf32, args[:3]), *args[3:])
    kernel_bound = tp.error_bound(*args, ew, tp.MMA_DOT_GAMMA)
    assert tp.compare(tt, tw, et, ew, kernel_bound)["max_err_over_bound"] > 1.0


@pytest.mark.parametrize("seed,n_tiles,n_obj", [(0, 1, 256), (5, 1, 200)])
def test_root_pair_counts_match_a_direct_count(seed, n_tiles, n_obj):
    """The host's count of the pairs that need the root stage
    (``fori_root_pairs`` / ``mma_root_pairs``, which ``chip_smoke.py``
    feeds to ``flops.probe_terms``) against the discriminants of every
    pair at once, computed directly with each plain version's ops."""
    inputs = tp.make_inputs(seed, n_tiles, n_obj)
    geom, ox, oy, oz, dx, dy, dz = (torch.from_numpy(a) for a in inputs["fori"])
    o = [v.reshape(-1, 1) for v in (ox, oy, oz)]
    d = [v.reshape(-1, 1) for v in (dx, dy, dz)]
    r = [o[k] - geom[None, :, k] for k in range(3)]
    b = 2.0 * tp.dot3(*d, *r)
    c = tp.dot3(*r, *r) - geom[None, :, 3]
    disc = tp.fma(b, b, -((4.0 * tp.dot3(*d, *d)) * c))
    want_fori = int((disc > 0.0).sum())
    assert tp.fori_root_pairs(geom, ox, oy, oz, dx, dy, dz) == want_fori
    dmat, omat, cmat, cc, do, oo, a = (torch.from_numpy(x) for x in inputs["mma"])
    dc, oc = dmat[:, 0:1] * cmat[0], omat[:, 0:1] * cmat[0]
    for k in range(1, 8):
        dc, oc = tp.fma(dmat[:, k:k + 1], cmat[k], dc), tp.fma(omat[:, k:k + 1], cmat[k], oc)
    bm = 2.0 * (do - dc)
    cm = oo - 2.0 * oc + cc
    want_mma = int((tp.fma(bm, bm, -((4.0 * a) * cm)) > 0.0).sum())
    assert tp.mma_root_pairs(dmat, omat, cmat, cc, do, oo, a) == want_mma
    # few pairs need the roots: the probe's rays pass near 0.1-0.3% of spheres
    n_pairs = ox.numel() * n_obj
    assert 0.0005 * n_pairs < want_fori < 0.005 * n_pairs
    assert abs(want_mma - want_fori) <= 0.01 * want_fori


def test_probe_bound_terms():
    """``flops.probe_terms``: 20 FP32 operations per pair for kernel A's
    test, 10 for kernel B's, 15 per root stage, kernel B's 3xTF32 products
    over 3 components (36 flops a pair) at the TF32 tensor rate; the
    largest term bounds each kernel: the FP32 work, for kernel B too."""
    from spectral_tpu_torch.utils import flops

    n, roots, n_bytes = 2.0e8, 3.4e5, 6.3e6
    fori = flops.probe_terms("fori", n, roots, n_bytes)
    mma = flops.probe_terms("mma", n, roots, n_bytes)
    assert fori["fp32"] == pytest.approx(1e3 * (20 * n + 15 * roots) / 67e12)
    assert mma["fp32"] == pytest.approx(1e3 * (10 * n + 15 * roots) / 67e12)
    assert fori["tf32"] == 0.0 and mma["tf32"] == pytest.approx(1e3 * 36 * n / 495e12)
    assert fori["bytes"] == mma["bytes"] == pytest.approx(1e3 * n_bytes / 3.35e12)
    assert flops.probe_bound_ms("fori", n, roots, n_bytes) == (fori["fp32"], "operations",
                                                               "fp32")
    assert flops.probe_bound_ms("mma", n, roots, n_bytes) == (mma["fp32"], "operations",
                                                              "fp32")
    assert flops.probe_bound_ms("fori", 1.0, 0.0, 1e9)[1:] == ("bytes", "bytes")


def test_mma_table_padding_never_wins_nor_makes_nan():
    """``cuda_probe_mma`` pads its sphere table to a multiple of 32 with
    spheres at the origin and cc = +inf (``probe.cu``: ``split_kernel``):
    through the plain version, such spheres never pass the test, never win
    and make no NaN, so the padded table gives the unpadded one's hits."""
    args = list(map(torch.from_numpy, tp.make_inputs(2, 1, 1000)["mma"]))
    n_pad = 1024
    padded = list(args)
    padded[2] = torch.cat([args[2], torch.zeros(8, n_pad - 1000)], dim=1)
    padded[3] = torch.cat([args[3], torch.full((1, n_pad - 1000), tp.INF)], dim=1)
    want_t, want_w = tp.probe_mma_plain(*args)
    got_t, got_w = tp.probe_mma_plain(*padded)
    assert torch.equal(got_t, want_t) and torch.equal(got_w, want_w)
    assert not torch.isnan(got_t).any() and int(got_w.max()) < 1000
    assert tp.mma_root_pairs(*padded) == tp.mma_root_pairs(*args)


@pytest.mark.parametrize("seed", [0, 3])
def test_probe_tensor_flops_count_the_components_the_inputs_carry(seed):
    """Kernel B's 3xTF32 products are counted over the components its
    inputs carry (``flops.PROBE_DOT_COMPONENTS``), not over the 8 of its
    padded rows: the rays' and centres' later components are zeros, which
    add nothing to d.c or o.c."""
    from spectral_tpu_torch.utils import flops

    dmat, omat, cmat = tp.make_inputs(seed, 1, 64)["mma"][:3]
    k = flops.PROBE_DOT_COMPONENTS
    for m in (dmat, omat, cmat.T):
        assert m.shape[1] == 8 and not m[:, k:].any() and m[:, :k].all()
    assert flops.PROBE_MMA_TENSOR_FLOPS == 3 * 2 * k * 2
