"""``cuda_persist`` and ``cuda_cost`` together: their least time over
their device time in the window. Operations: every frame's live
iterations (persist) and one frame's per render (the cost probe); bytes:
each persist launch reads and writes the carried lane state, each probe
reads its lanes and writes radiance and cost."""

from benchmark.metrics import work


def read(view):
    kernel_s = view.kernel_seconds("persist_kernel", "mono_kernel")
    if not kernel_s:
        return None
    frame_ops, cfg = work.per_frame_ops(view)
    images = view.driver.images
    frames = view.driver.frames_rendered()
    pixels = cfg.width * cfg.height
    s4 = 4 * cfg.n_samples
    launches = sum(im[3] or 0 for im in images)
    n_bytes = launches * 2 * pixels * (4 * 13 + 2 * s4) + len(images) * pixels * (32 + s4 + 4)
    ops = (frames + len(images)) * frame_ops
    return work.roofline_pct("persist.roofline_pct", ops, n_bytes, kernel_s)
