"""``cuda_regen``'s share of its roofline in the prism's cells: the least
time of the window's frames over ``regen_kernel``'s device time, as
``work.regen_roofline_pct`` counts it, with the operations of the feature
build. The op table's feature terms (``ops_table.kernel_ops``: the sky,
emission and hero-collapse shading per wavelength, the dielectric's and
the checker's continuation) are taken as the reference's
``scene_features`` bits say and added for every lane-bounce the reference
counted on its sample; they do not depend on the walk, so the
feature-less count (``work.per_frame_ops``) gains their difference."""

from benchmark.harness import scene
from benchmark.metrics import ops_table, work
from benchmark.reference import bounce, paths


def feature_lane_bounce_ops(st, cfg) -> float:
    """The op table's per-lane-bounce operations that the scene's features
    add to the feature-less count."""
    fx = bounce.scene_features(st)
    flags = dict(has_transmission=bool(fx & bounce.FX_TRANSMISSION),
                 has_emission=bool(fx & bounce.FX_EMISSION),
                 has_sky=bool(fx & bounce.FX_SKY),
                 has_texture=bool(fx & bounce.FX_TEXTURE))
    plain = ops_table.kernel_ops(cfg, st.obj_types, cfg.n_materials)
    return ops_table.kernel_ops(cfg, st.obj_types, cfg.n_materials,
                                **flags).per_lane_bounce - plain.per_lane_bounce


def read(view):
    kernel_s = view.kernel_seconds("regen_kernel")
    if not kernel_s:
        return None
    frame_ops, cfg = work.per_frame_ops(view)
    st, _ = paths.tables(scene.scene_dict(view.cell.config), "cpu")
    iters = view.work.iterations / view.work.lanes
    frame_ops += cfg.width * cfg.height * iters * feature_lane_bounce_ops(st, cfg)
    frames = view.driver.frames_rendered()
    launches = len(view.driver.images) * -(-cfg.intended_frames // view.driver.chunk)
    n_bytes = launches * cfg.width * cfg.height * (8 + 4 * cfg.n_samples)
    return work.roofline_pct("regen.roofline_pct.prism", frames * frame_ops, n_bytes, kernel_s)
