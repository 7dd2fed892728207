"""AOV-guided edge-avoiding à-trous wavelet denoiser (the port of
``spectral_tpu.render.denoise``).

A feature-guided spatial filter in the family of Dammertz et al. 2010
("Edge-Avoiding A-Trous Wavelet Transform for fast Global Illumination
Filtering") with the variance-guided colour stop of SVGF (Schied et al.
2017, without its temporal stage): it removes residual Monte-Carlo noise
from a progressive render, with the first-hit G-buffers
(``render/aov.py``) as edge stops. Albedo is divided out before filtering
and multiplied back after, so texture and material detail never blur.

The reference's filter is a plain jnp program outside any Pallas kernel;
its port is eager PyTorch on the image's device in the same op order:
each level is a 5x5 stencil at stride ``2^level`` over an edge-padded
tensor (``F.pad(..., mode="replicate")``) read as 25 shifted slices. The
filter runs on the linear accumulated radiance and never touches the
render or its checkpoints.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["atrous_filter", "atrous_denoise", "filter_inputs", "denoise_rgb", "denoise_render"]

# B3-spline coefficients of the a-trous wavelet kernel (outer product
# gives the 5x5 stencil); the center weight (3/8)^2 keeps the total tap
# weight strictly positive even when every edge-stop rejects.
_B3 = (1.0 / 16.0, 1.0 / 4.0, 3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)

_MISS_DEPTH = 1.0e8  # finite sentinel for no-hit pixels (depth aov is +inf)

# Rec.709 luminance weights for the variance-guided color stop
_LUM = (0.2126, 0.7152, 0.0722)


def _luminance(rgb):
    return (
        _LUM[0] * rgb[..., 0] + _LUM[1] * rgb[..., 1] + _LUM[2] * rgb[..., 2]
    )


def _taps(a, stride, h, w):
    """The 25 ``(weight, view)`` pairs of ``a`` (``[H, W]`` or ``[H, W,
    C]``) for a 5x5 stencil at ``stride``: shifted slices of one
    edge-padded copy."""
    pad = 2 * stride
    chw = a[None, None] if a.ndim == 2 else a.permute(2, 0, 1)[None]
    ap = F.pad(chw, (pad, pad, pad, pad), mode="replicate")[0]
    ap = ap[0] if a.ndim == 2 else ap.permute(1, 2, 0)
    out = []
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            oy, ox = pad + dy * stride, pad + dx * stride
            out.append((_B3[dy + 2] * _B3[dx + 2], ap[oy:oy + h, ox:ox + w]))
    return out


def atrous_filter(illum, normal, depth, iterations: int, sigmas):
    """Variance-guided a-trous cascade over ``illum`` ``[H, W, 3]`` on its
    device (the reference's ``_atrous_filter``, same op order).

    ``normal`` ``[H, W, 3]`` must be unit-length everywhere (miss pixels
    substituted before the call), ``depth`` ``[H, W]`` finite, ``sigmas``
    a float32 ``[3]`` tensor (color, normal power, depth). The color stop
    divides the luminance difference by a local noise estimate: a
    per-pixel variance plane, bootstrapped from the 3x3 spatial variance
    and carried through each level with squared weights.
    """
    h, w = illum.shape[0], illum.shape[1]
    sigma_c, sigma_n, sigma_d = sigmas[0], sigmas[1], sigmas[2]

    # bootstrap the noise estimate: 3x3 spatial luminance variance
    lum0 = _luminance(illum)
    m1 = torch.zeros((h, w), dtype=illum.dtype, device=illum.device)
    m2 = torch.zeros_like(m1)
    all_taps = _taps(lum0, 1, h, w)
    inner3x3 = all_taps[6:9] + all_taps[11:14] + all_taps[16:19]
    for _k, lq in inner3x3:
        m1 = m1 + lq
        m2 = m2 + lq * lq
    m1, m2 = m1 / 9.0, m2 / 9.0
    var = torch.clamp_min(m2 - m1 * m1, 0.0)

    for level in range(iterations):
        stride = 1 << level

        # 3x3 blur of the variance plane stabilizes the noise estimate
        gvar = torch.zeros_like(var)
        gw = 0.0
        for kk, vq in _taps(var, 1, h, w):
            gvar = gvar + kk * vq
            gw = gw + kk
        gvar = gvar / gw
        lum_p = _luminance(illum)
        inv_cdenom = 1.0 / (sigma_c * torch.sqrt(gvar) + 1e-4)

        num = torch.zeros_like(illum)
        num_v = torch.zeros_like(var)
        den = torch.zeros_like(var)
        tap_i = _taps(illum, stride, h, w)
        tap_n = _taps(normal, stride, h, w)
        tap_d = _taps(depth, stride, h, w)
        tap_v = _taps(var, stride, h, w)
        for (k, iq), (_, nq), (_, dq), (_, vq) in zip(tap_i, tap_n, tap_d, tap_v):
            w_color = torch.exp(-torch.abs(lum_p - _luminance(iq)) * inv_cdenom)
            # the 3-term dot product summed left to right, on any device
            dot = (normal[..., 0] * nq[..., 0] + normal[..., 1] * nq[..., 1]
                   + normal[..., 2] * nq[..., 2])
            w_normal = torch.pow(torch.clamp_min(dot, 0.0), sigma_n)
            # relative depth stop, stride-scaled so coarse levels
            # tolerate the larger depth span they legitimately cover
            w_depth = torch.exp(
                -torch.abs(depth - dq)
                / (sigma_d * stride * (torch.abs(depth) + 1.0) + 1e-6)
            )
            wt = k * w_color * w_normal * w_depth
            num = num + wt[..., None] * iq
            num_v = num_v + wt * wt * vq
            den = den + wt
        illum = num / den[..., None]
        var = num_v / (den * den)
    return illum


def atrous_denoise(
    rgb,
    depth,
    normal,
    albedo,
    *,
    iterations: int = 5,
    sigma_color: float = 4.0,
    sigma_normal: float = 128.0,
    sigma_depth: float = 0.05,
    demodulate: bool = True,
    device: str | torch.device = "cuda",
):
    """Denoise a linear-RGB image guided by first-hit feature buffers, on
    ``device``.

    Args:
      rgb: ``[H, W, 3]`` linear radiance (the accumulated framebuffer).
      depth: ``[H, W]`` first-hit ray distance, ``+inf`` on miss
        (``compute_aovs()['depth']``).
      normal: ``[H, W, 3]`` unit shading normal, zeros on miss.
      albedo: ``[H, W, 3]`` linear first-hit reflectance, zeros on miss.
      iterations: a-trous levels; level ``i`` filters at stride ``2^i``,
        so 5 levels cover a ~64-pixel footprint.
      sigma_color: luminance edge-stop in units of the local noise
        standard deviation — lower keeps more lighting detail.
      sigma_normal: exponent on ``max(0, n_p . n_q)`` — higher keeps
        creases sharper.
      sigma_depth: relative depth edge-stop per unit stride.
      demodulate: divide out albedo before filtering (and re-multiply
        after) so material texture is preserved exactly.
      device: where the filter runs; numpy inputs are copied there.

    Returns an ``[H, W, 3]`` float32 numpy array.
    """
    sig = (sigma_color, sigma_normal, sigma_depth)
    illum, normal_eff, depth_eff, sigmas, safe = filter_inputs(
        rgb, depth, normal, albedo, sig, demodulate, device)
    out = atrous_filter(illum, normal_eff, depth_eff, int(iterations), sigmas)
    return (out * safe).cpu().numpy()


def filter_inputs(rgb, depth, normal, albedo, sigmas=(4.0, 128.0, 0.05),
                  demodulate: bool = True, device: str | torch.device = "cuda"):
    """``atrous_filter``'s inputs on ``device`` from the guide buffers
    (numpy arrays or tensors): ``(illum, normal, depth, sigmas, safe)``,
    the miss pixels on their constant plane and ``illum = rgb / safe``;
    the filter's output times ``safe`` is the denoised image."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("atrous_denoise(device='cuda') needs a CUDA GPU; pass device='cpu'")

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32) if not torch.is_tensor(a) else a,
                               dtype=torch.float32, device=device)

    rgb, depth, normal, albedo = map(dev, (rgb, depth, normal, albedo))
    if rgb.ndim != 3 or rgb.shape[-1] != 3:
        raise ValueError(f"rgb must be [H, W, 3], got {tuple(rgb.shape)}")
    if depth.shape != rgb.shape[:2]:
        raise ValueError(
            f"depth shape {tuple(depth.shape)} != image {tuple(rgb.shape[:2])}"
        )

    hit = torch.isfinite(depth)
    # miss pixels share a constant plane (sentinel depth + a fixed unit
    # normal) so sky averages with sky and never with geometry — the
    # depth stop separates the two populations
    depth_eff = torch.where(hit, depth, _MISS_DEPTH)
    miss_n = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32, device=device)
    normal_eff = torch.where(hit[..., None], normal, miss_n)

    if demodulate:
        # per-channel: only channels with meaningful reflectance are
        # divided (out-of-gamut negative albedo and miss pixels pass
        # through), and the same `safe` tensor re-modulates — an exact
        # inverse wherever demodulation was skipped
        safe = torch.where(albedo > 1e-3, albedo, 1.0)
    else:
        safe = torch.ones_like(rgb)
    sig = torch.tensor(sigmas, dtype=torch.float32, device=device)
    return rgb / safe, normal_eff, depth_eff, sig, safe


def denoise_rgb(scene, rgb, device: str | torch.device = "cuda", **kwargs):
    """Denoise ``rgb`` using AOVs computed from ``scene`` (a schema
    ``Scene``), both on ``device``. Convenience wrapper over
    :func:`atrous_denoise`."""
    from spectral_tpu_torch.render.aov import compute_aovs

    aovs = compute_aovs(scene, device)
    return atrous_denoise(
        rgb, aovs["depth"], aovs["normal"], aovs["albedo"], device=device, **kwargs
    )


def denoise_render(scene, rgba, device: str | torch.device = "cuda", **kwargs):
    """Denoise a rendered ``[H, W, 4]`` RGBA framebuffer; alpha passes
    through untouched. Returns float32 RGBA."""
    rgba = np.asarray(rgba, np.float32)
    out = denoise_rgb(scene, rgba[..., :3], device=device, **kwargs)
    return np.concatenate([out, rgba[..., 3:4]], axis=-1)
