"""``cuda_regen``'s share of its roofline in the hero frame's cells: the
least time of the frames its launches rendered over ``regen_kernel``'s
device time. An image of ``n`` frames at K frames a launch is ``n // K``
launches and a tail of ``n % K`` frames on the mono kernel, so only the
launches' frames and bytes are counted (``work.regen_roofline_pct``
counts every frame of the image)."""

from benchmark.metrics import work


def read(view):
    kernel_s = view.kernel_seconds("regen_kernel")
    if not kernel_s:
        return None
    frame_ops, cfg = work.per_frame_ops(view)
    chunk = view.driver.chunk
    launches = len(view.driver.images) * (cfg.intended_frames // chunk)
    n_bytes = launches * cfg.width * cfg.height * (8 + 4 * cfg.n_samples)
    return work.roofline_pct("regen.roofline_pct.hero", launches * chunk * frame_ops, n_bytes,
                             kernel_s)
