"""Scene builders shared by the port's tests.

Each builder takes the scene modules it builds with: the JAX package's
(``spectral_tpu.scene.schema`` / ``presets``) or the port's own copies
(``spectral_tpu_torch.scene.schema`` / ``presets``), so that a test that
compares the two packages builds the same scene in each. This module
imports neither package at import time, so the jax-free card tests can
use it; ``feature_kernel_checks`` imports the port when called.
"""

from __future__ import annotations

import math


def preset(presets, name, w, h, bounces, iters=2, samples=8):
    """A named preset at a test size."""
    scene = presets.PRESETS[name](n_samples=samples)
    scene.width, scene.height = w, h
    scene.nbr_of_ray_bounces, scene.nbr_of_iterations = bounces, iters
    return scene


def periscope(schema, presets, bounces=3, samples=8, iters=2):
    """The deterministic 3-bounce periscope of tests/test_pallas_megakernel.py
    (``_periscope_scene``): mirror -> mirror -> diffuse wall, no self-hit
    coin on any lane."""
    S = schema
    base = presets.default_scene()
    refl = [sp for sp in base.spectra if sp.effect_type.name == "REFLECTIVE"][0]
    emis = [sp for sp in base.spectra if sp.effect_type.name == "EMISSIVE"][0]
    mirror = S.Material(1.0, 0.0, refl, "mirror")
    diffuse = S.Material(0.0, 0.0, refl, "wall")
    quarter = float(math.pi / 4)
    scene = S.Scene(
        width=12, height=8, nbr_of_iterations=iters, nbr_of_ray_bounces=bounces,
        camera=S.Camera(position=(0.0, 0.0, 0.0), direction=(0.0, 0.0, 1.0),
                        up=(0.0, 1.0, 0.0), fov_y_deg=30.0),
        lights=[S.Light((0.0, 4.0, 9.0), emis, "lamp")],
        objects=[
            S.SceneObject((0.0, 0.0, 6.0),
                          S.RotatedBox(4.0, 4.0, 0.2, quarter, 0.0, 0.0), mirror, "M1"),
            S.SceneObject((0.0, 4.0, 6.0),
                          S.RotatedBox(4.0, 4.0, 0.2, quarter, 0.0, 0.0), mirror, "M2"),
            S.SceneObject((0.0, 4.0, 12.0), S.PlainBox(8.0, 8.0, 0.2), diffuse, "wall"),
        ],
        spectra=base.spectra, materials=[mirror, diffuse],
        spectrum_number_of_samples=samples,
    )
    scene.update_all_spectrum_sample_sizes()
    scene.validate()
    return scene


def regen_scene(presets):
    """The regeneration check's scene (tests/test_pallas_megakernel.py
    ``_regen_scene``): the default scene at 16x128, 8 wavelengths, 4
    bounces, 3 iterations."""
    sc = presets.default_scene()
    sc.spectrum_number_of_samples = 8
    sc.update_all_spectrum_sample_sizes()
    sc.width, sc.height = 16, 128
    sc.nbr_of_ray_bounces = 4
    sc.nbr_of_iterations = 3
    return sc


def sphere_field(presets, n_spheres, w, h, bounces, iters=2, samples=8):
    """The many-object preset (``presets.sphere_field``: a seeded field of
    spheres on a plain-box floor) at a test size."""
    scene = presets.sphere_field(n_spheres=n_spheres, n_samples=samples)
    scene.width, scene.height = w, h
    scene.nbr_of_ray_bounces, scene.nbr_of_iterations = bounces, iters
    return scene


def smooth_mesh(presets, mesh, w, h, bounces, subdivisions=1, iters=2, samples=8):
    """``presets.mesh_demo`` with its mirror icosphere swapped for a
    DIFFUSE icosphere of ``subdivisions`` carrying vertex normals
    (``mesh.icosphere(..., smooth=True)``; ``mesh`` is the scene.mesh
    module of the same package), beside the flat icosahedron: a smooth
    and a flat mesh in one scene. Subdivision 0 keeps the scene at 45
    objects (the kernels' small-scene build), 1 gives 105 (clusters)."""
    scene = presets.mesh_demo(n_samples=samples)
    ball, blue = scene.objects[5], scene.objects[6]
    ball.object_type = mesh.icosphere(0.55, subdivisions, smooth=True)
    ball.material = blue.material
    scene.width, scene.height = w, h
    scene.nbr_of_ray_bounces, scene.nbr_of_iterations = bounces, iters
    scene.validate()
    return scene


def open_sky(schema, n=16, bounces=3, w=24, h=16, iters=2, with_sky=True,
             metallic=0.0):
    """tests/test_sky.py's ``_open_scene``: a lone grey sphere before the
    camera, one lamp, and a 6500 K sky behind (``with_sky``)."""
    S = schema
    sky = S.SceneSpectrum.new("sky", S.Temperature(6500.0, 0.8),
                              S.SpectrumEffectType.EMISSIVE, n=n)
    grey = S.SceneSpectrum.new("grey", S.PlainReflective(0.6),
                               S.SpectrumEffectType.REFLECTIVE, n=n)
    lamp = S.SceneSpectrum.new("lamp", S.Temperature(5000.0, 3.0),
                               S.SpectrumEffectType.EMISSIVE, n=n)
    mat = S.Material(metallic, 0.1, grey, "grey mat")
    scene = S.Scene(
        width=w, height=h, nbr_of_iterations=iters, nbr_of_ray_bounces=bounces,
        camera=S.Camera(position=(0.0, 0.0, -4.0)),
        lights=[S.Light((3.0, 4.0, -3.0), lamp, "lamp")],
        objects=[S.SceneObject((0.0, 0.0, 2.0), S.Sphere(1.2), mat, "ball")],
        spectra=[sky, grey, lamp], materials=[mat], spectrum_number_of_samples=n,
    )
    if with_sky:
        scene.sky = sky
    return scene


def textured(schema, presets, samples=8, bounces=1, w=24, h=16, iters=2):
    """tests/test_texture.py's ``_textured_scene``: the default scene with
    a checker (cells of 0.7, odd cells at 0.2) on its floor."""
    scene = presets.default_scene(n_samples=samples)
    scene.width, scene.height = w, h
    scene.nbr_of_ray_bounces, scene.nbr_of_iterations = bounces, iters
    floor = next(o for o in scene.objects if o.name == "Floor")
    floor.material.texture = schema.Checker(scale=0.7, low=0.2)
    return scene


def emissive_panel(schema, n=16, bounces=1):
    """tests/test_dispersion.py's ``_emissive_panel_scene``: a black
    5000 K emissive panel filling the view, no lights."""
    S = schema
    emis = S.SceneSpectrum.new("emit", S.Temperature(5000.0, 2.0),
                               S.SpectrumEffectType.EMISSIVE, n=n)
    black = S.SceneSpectrum.new("black", S.PlainReflective(0.0),
                                S.SpectrumEffectType.REFLECTIVE, n=n)
    panel = S.Material(0.0, 0.0, black, "panel", emission=emis)
    return S.Scene(
        width=8, height=6, nbr_of_iterations=2, nbr_of_ray_bounces=bounces,
        camera=S.Camera(position=(0.0, 0.0, -2.0)), lights=[],
        objects=[S.SceneObject((0.0, 0.0, 2.0), S.PlainBox(8.0, 8.0, 1.0), panel, "panel")],
        spectra=[emis, black], materials=[panel], spectrum_number_of_samples=n,
    )


def glass_meshes(schema, presets, name, w, h, bounces, samples=8, iters=2,
                 transmission=0.9):
    """A mesh preset with ``transmission`` on its meshes' materials: the
    triangle builds' dielectric."""
    scene = preset(presets, name, w, h, bounces, iters, samples)
    for obj in scene.objects:
        if isinstance(obj.object_type, schema.Mesh):
            obj.material.transmission = transmission
    return scene


def many_lights(schema, presets, name, n_lights, w, h, bounces, samples=8, iters=2):
    """A preset with ``n_lights`` copies of its first light, each a little
    lower than the one before: tables that fill a block's shared memory."""
    scene = preset(presets, name, w, h, bounces, iters, samples)
    first = scene.lights[0]
    x, y, z = first.position
    scene.lights = [schema.Light((x, y - 1e-3 * i, z), first.spectrum, f"lamp {i}")
                    for i in range(n_lights)]
    return scene


def with_lens(scene, aperture=0.05, focus=2.0):
    """``scene`` with a thin-lens camera (depth of field)."""
    scene.camera.aperture_radius, scene.camera.focus_distance = aperture, focus
    return scene


def feature_kernel_checks(tables, **kw):
    """``kernel_checks`` of a feature scene's tables: each bounce kernel's
    feature build against its plain version."""
    assert tables.features, "not a feature scene"
    return kernel_checks(tables, **kw)


def kernel_checks(tables, frame=1, regen_k=3, split=2, lane_perm=None,
                  persist_launches=2, persist_budget=7, persist_stop=3,
                  timed=None):
    """Each bounce kernel against its plain version on the card, bit for
    bit (``torch.equal``), on the scene of ``tables`` (with its features,
    its lens, its triangles: the build those tables take):

    - ``mono`` and ``cost`` on frame ``frame``'s primaries (the cost
      kernel's radiance also equal to the mono frame's);
    - ``regen``: K = ``regen_k`` frames from ``frame``, lanes in the order
      ``lane_perm`` (the Renderer's layout; None: row-major);
    - ``seg``: bounces [0, ``split``) on the whole wavefront, then [split,
      B) on its compacted survivors with the hero bins they carry, as the
      cascade runs them; scattered back, the frame equals the mono frame;
    - ``persist``: ``persist_launches`` launches of ``persist_budget``
      iterations, lane-stop with every ``persist_stop``-th lane stopped,
      or free-running (``persist_stop=0``, as ``Renderer(persist=True)``
      launches it); none with ``persist_launches=0`` (a lens scene,
      which persist refuses).

    ``timed(key, fn)``, if given, runs each launch (kernel ``key``, its
    plain version ``key + "_plain"``) and returns fn's result: the caller's
    timer. Returns ``(checks, info)``: a bool per kernel, and the
    survivor and hero counts."""
    import torch

    from spectral_tpu_torch.ops import megakernel as mk
    from spectral_tpu_torch.render import cuda_integrator as ci
    from spectral_tpu_torch.render.camera import camera_basis_table

    port, cfg = tables.scene, tables.config

    def run(key, fn):
        return timed(key, fn) if timed else fn()

    def same(a, b):
        return all(torch.equal(x, getattr(b, k)) for k, x in a.planes().items())

    planes, px, py = ci.primary_lanes(port, cfg, frame)
    mono = run("mono", lambda: mk.run_mono(*planes, px, py, frame, tables))
    plain = run("mono_plain", lambda: mk.run_mono_plain(*planes, px, py, frame, tables))
    checks = dict(mono=torch.equal(mono, plain))
    del plain
    rad, cost = run("cost", lambda: mk.run_cost(*planes, px, py, frame, tables))
    prad, pcost = run("cost_plain", lambda: mk.run_cost_plain(*planes, px, py, frame, tables))
    checks["cost"] = (torch.equal(rad, mono) and torch.equal(rad, prad)
                      and torch.equal(cost, pcost))
    del rad, prad, planes
    args = (*ci.regen_args(port, cfg, frame, regen_k, lane_perm), tables)
    got = run("regen", lambda: mk.run_regen(*args))
    checks["regen"] = torch.equal(got, run("regen_plain", lambda: mk.run_regen_plain(*args)))
    del got, args
    split = min(split, cfg.max_bounces)
    wf, pwf = ci.frame_wavefront(port, cfg, frame), ci.frame_wavefront(port, cfg, frame)
    run("seg", lambda: mk.run_seg(wf, 0, split, frame, tables))
    run("seg_plain", lambda: mk.run_seg_plain(pwf, 0, split, frame, tables))
    seg_ok = same(wf, pwf)
    live = torch.nonzero(wf.alive > 0)[:, 0]
    cwf, cpwf = ci._gather(wf, live), ci._gather(pwf, live)
    info = dict(survivors=int(live.numel()), survivors_with_hero=int((cwf.hero >= 0).sum()))
    if split < cfg.max_bounces:
        run("seg_tail", lambda: mk.run_seg(cwf, split, cfg.max_bounces, frame, tables))
        run("seg_tail_plain",
            lambda: mk.run_seg_plain(cpwf, split, cfg.max_bounces, frame, tables))
    wf.rad[..., live] = cwf.rad
    checks["seg"] = seg_ok and same(cwf, cpwf) and torch.equal(wf.rad, mono)
    del wf, pwf, cwf, cpwf, mono
    if not persist_launches:
        torch.cuda.synchronize()
        return {k: bool(v) for k, v in checks.items()}, info
    n = cfg.width * cfg.height
    stop = ((torch.arange(n, device=px.device) % persist_stop == 0).float()
            if persist_stop else None)
    cam = camera_basis_table(port, cfg)
    a, b = ci.persist_init(port, cfg), ci.persist_init(port, cfg)
    frames = cfg.intended_frames
    for _ in range(persist_launches):
        run("persist", lambda: mk.run_persist(a, frames, frames, tables, cam, stop=stop,
                                              budget=persist_budget))
        run("persist_plain", lambda: mk.run_persist_plain(b, frames, frames, tables, cam,
                                                          stop=stop, budget=persist_budget))
    checks["persist"] = same(a, b)
    info["persist_heroes"] = int((a.hero >= 0).sum())
    torch.cuda.synchronize()
    return {k: bool(v) for k, v in checks.items()}, info


def one_material_each(schema, scene, own_spectra=True):
    """``scene`` with a material of its own for every object: a copy of
    the object's material with a reflective spectrum of its own (a plain
    reflectance that differs from object to object), so that the kernels
    see as many distinct albedo rows as objects (``sphere_field(300)``:
    301 materials). ``own_spectra=False`` keeps each copy's spectrum: the
    same image as ``scene``, its rows relabeled."""
    S = schema
    n = scene.spectrum_number_of_samples
    for i, obj in enumerate(scene.objects):
        mat = obj.material.copy()
        mat.name = f"{mat.name} {i}"
        if own_spectra:
            value = 0.2 + 0.75 * ((i * 0.6180339887) % 1.0)
            mat.spectrum = S.SceneSpectrum.new(f"albedo {i}", S.PlainReflective(value),
                                               S.SpectrumEffectType.REFLECTIVE, n=n)
            scene.spectra.append(mat.spectrum)
        obj.material = mat
        scene.materials.append(mat)
    scene.validate()
    return scene


def random_scene(schema, seed, bounces=1):
    """The seeded random scene of ``tests/test_fuzz_scenes.py``
    (``_random_scene``: spheres, boxes and rotated boxes with random
    materials and one or two lights, 10x8, 8 wavelengths), built with
    ``schema``: the same draws in the same order, so each package's copy
    flattens to the same tables."""
    import numpy as np

    S = schema
    rng = np.random.default_rng(seed)
    emis = S.SceneSpectrum.new("sun", S.Solar(float(rng.uniform(0.5, 2.0))),
                               S.SpectrumEffectType.EMISSIVE, n=8)
    spectra, materials = [emis], []
    for i in range(int(rng.integers(2, 4))):
        refl = S.SceneSpectrum.new(f"refl{i}", S.PlainReflective(float(rng.uniform(0.2, 0.95))),
                                   S.SpectrumEffectType.REFLECTIVE, n=8)
        spectra.append(refl)
        materials.append(S.Material(
            metallicness=float(rng.choice([0.0, 1.0, rng.uniform()])),
            roughness=float(rng.uniform(0.0, 0.5)), spectrum=refl, name=f"m{i}"))
    objects = []
    for i in range(int(rng.integers(3, 7))):
        pos = tuple(float(v) for v in rng.uniform([-4, -3, 2], [4, 3, 10]))
        kind = int(rng.integers(0, 3))
        if kind == 0:
            ot = S.Sphere(radius=float(rng.uniform(0.3, 1.5)))
        elif kind == 1:
            ot = S.PlainBox(*(float(v) for v in rng.uniform(0.5, 2.5, 3)))
        else:
            ot = S.RotatedBox(*(float(v) for v in rng.uniform(0.5, 2.5, 3)),
                              *(float(v) for v in rng.uniform(-1.5, 1.5, 3)))
        objects.append(S.SceneObject(pos, ot, materials[int(rng.integers(len(materials)))],
                                     name=f"o{i}"))
    lights = [S.Light(tuple(float(v) for v in rng.uniform([-6, 2, -2], [6, 8, 12])), emis, f"L{j}")
              for j in range(int(rng.integers(1, 3)))]
    scene = S.Scene(
        width=10, height=8, nbr_of_iterations=4, nbr_of_ray_bounces=bounces,
        camera=S.Camera((0.0, 0.0, -3.0), (0.0, 0.0, 1.0), (0.0, 1.0, 0.0), 55.0),
        lights=lights, objects=objects, spectra=spectra, materials=materials,
        spectrum_number_of_samples=8)
    scene.validate()
    return scene


def _disc32(o, d, centre, radius):
    """The sphere test's discriminant in float32, in the op order of the
    kernels' ``sphere_t`` and the plain ``geometry.sphere_nearest_t``
    (one rounding per operation, no contraction)."""
    import numpy as np

    f = np.float32
    ocx, ocy, ocz = f(o[0]) - f(centre[0]), f(o[1]) - f(centre[1]), f(o[2]) - f(centre[2])
    dx, dy, dz = f(d[0]), f(d[1]), f(d[2])
    a = dx * dx + dy * dy + dz * dz
    b = f(2.0) * (ocx * dx + ocy * dy + ocz * dz)
    c = (ocx * ocx + ocy * ocy + ocz * ocz) - f(radius) * f(radius)
    return b * b - f(4.0) * a * c


def _tangent_sphere(o, d, s, h):
    """A scene sphere's centre and radius (float32 values) whose table
    entries (``flatten._sphere_tables``) give the ray ``(o, d)`` a
    discriminant of exactly 0 with its root near ``s`` along the ray:
    radius about ``h``, its centre off the ray across it. Sweeps the
    radius an ulp at a time, and nudges the centre where no radius does."""
    import numpy as np

    from spectral_tpu_torch.scene.flatten import _sphere_tables

    o64, d64 = np.asarray(o, np.float64), np.asarray(d, np.float64)
    dn = d64 / np.linalg.norm(d64)
    axis = np.eye(3)[int(np.argmin(np.abs(dn)))]
    perp = np.cross(dn, axis)
    perp /= np.linalg.norm(perp)
    rng = np.random.default_rng(0)
    for attempt in range(64):
        centre = (o64 + dn * s + perp * h + rng.normal(0.0, 1e-4 * h, 3) * (attempt > 0)
                  ).astype(np.float32)
        oc = o64 - centre.astype(np.float64)
        bits = int(np.float32(np.sqrt(oc @ oc - (oc @ dn) ** 2)).view(np.int32))
        for k in range(4096):  # outwards from the tangent radius, an ulp at a time
            r = np.int32(bits + (k + 1) // 2 * (1 if k % 2 else -1)).view(np.float32)
            _lo, _hi, pos, rad = _sphere_tables(centre, r)
            if _disc32(o, d, pos, rad) == 0.0:
                return tuple(float(v) for v in centre), float(r)
    raise AssertionError("no float32 radius makes the ray tangent")


def tangent_field(presets, device, w=32, h=16, bounces=3, iters=4, samples=8, frame=1):
    """The 100-sphere field with two matte spheres added, so that in the
    many-object walk one warp's vote meets lanes with no root, a lane
    with a root of exactly disc == 0 and lanes that hit: sphere A
    tangent to the primary ray of frame ``frame`` of a lane whose warp (32
    consecutive row-major lanes) holds lanes that hit other spheres, in
    front of the lane's own hit, so A wins its nearest trace; sphere B
    tangent to the first shadow ray (bounce 0, light 0) of a lane whose
    ray nothing blocked before, in a warp with shadow rays that spheres
    block, so B alone blocks it. Built and checked on the plain path on
    ``device`` (the discriminants read exactly 0 there, in float32).
    Returns ``(scene, info)``: ``lane`` and ``shadow_lane``, the objects
    ``tangent`` and ``shadow_tangent``, and ``shadow_rays``, the origins
    and directions ``[n, 3]`` of every lane's shadow ray."""
    import copy

    import numpy as np
    import torch

    from spectral_tpu_torch.ops import geometry
    from spectral_tpu_torch.ops.vecmath import Vec3
    from spectral_tpu_torch.render import integrator
    from spectral_tpu_torch.render.launch_inputs import primary_lanes
    from spectral_tpu_torch.scene import schema
    from spectral_tpu_torch.scene.flatten import OBJ_SPHERE, flatten_scene

    def rows(v):
        return torch.stack(tuple(v), 1).cpu().numpy()

    def look(scene):
        """Every lane's frame-``frame`` primary ray and nearest hit, and its
        bounce-0 shadow ray to light 0, its nearest hit and whether it is
        blocked, on the plain path."""
        port, cfg = flatten_scene(scene, device)
        planes, px, py = primary_lanes(port, cfg, frame)
        o, d = Vec3(*planes[:3]), Vec3(*planes[3:])
        first = geometry.trace(o, d, port)
        seen = []
        real = integrator.trace_shadow

        def spy(origin, direction, max_distance, sc, interval=False):
            blocked = real(origin, direction, max_distance, sc, interval=interval)
            if not seen:
                seen.append((origin, direction, max_distance, blocked))
            return blocked

        integrator.trace_shadow = spy
        try:
            integrator.bounce_loop(o, d, px, py, frame, port, cfg)
        finally:
            integrator.trace_shadow = real
        so, sd, dist, blocked = seen[0]
        shadow = geometry.trace(so, sd, port)
        sphere = port.np_fields["obj_type"] == OBJ_SPHERE
        return dict(port=port, o=rows(o), d=rows(d), obj=first.obj_idx.cpu().numpy(),
                    t=first.t.cpu().numpy(), hit=first.hit.cpu().numpy(), so=rows(so),
                    sd=rows(sd), dist=dist.cpu().numpy(), blocked=blocked.cpu().numpy(),
                    sobj=shadow.obj_idx.cpu().numpy(), sphere=sphere,
                    matte=port.metallicness.cpu().numpy() == 0.0)

    def disc(port, o, d, i):
        """Object i's discriminant for the ray (o, d), in torch on the
        device, from its flattened table values."""
        c, r = port.sphere_pos[i], port.radius[i]
        f = lambda v: torch.tensor(v, dtype=torch.float32, device=c.device)
        oc = Vec3(f(o[0]) - c[0], f(o[1]) - c[1], f(o[2]) - c[2])
        dv = Vec3(f(d[0]), f(d[1]), f(d[2]))
        a, b = dv.dot(dv), 2.0 * oc.dot(dv)
        cc = oc.dot(oc) - r * r
        return float(b * b - 4.0 * a * cc)

    base = sphere_field(presets, 100, w, h, bounces, iters=iters, samples=samples)
    before = look(base)
    n = len(before["t"])
    warp = np.arange(n) // 32
    hits_sphere = before["hit"] & before["sphere"][before["obj"]]
    lit = before["hit"] & before["matte"][before["obj"]]  # a diffuse hit sends shadow rays
    shade_sphere = lit & before["blocked"] & before["sphere"][before["sobj"]]
    firsts = [i for i in range(n) if before["hit"][i] and not hits_sphere[i]
              and hits_sphere[warp == warp[i]].sum() >= 2]
    seconds = [i for i in range(n) if lit[i] and not before["blocked"][i]
               and shade_sphere[warp == warp[i]].any()]
    assert firsts and seconds, "the field has no warp of the three cases"
    grey = next(m for m in base.materials if m.metallicness == 0.0)
    a_idx, b_idx = len(base.objects), len(base.objects) + 1
    for lane, shadow_lane in zip(firsts[::3], seconds[::3]):
        if lane == shadow_lane:
            continue
        s = 0.5 * float(before["t"][lane])
        ca, ra = _tangent_sphere(before["o"][lane], before["d"][lane], s, min(0.3, 0.25 * s))
        s2 = min(1.0, 0.5 * float(before["dist"][shadow_lane]))
        cb, rb = _tangent_sphere(before["so"][shadow_lane], before["sd"][shadow_lane], s2, 0.25)
        scene = copy.copy(base)
        scene.objects = list(base.objects) + [
            schema.SceneObject(ca, schema.Sphere(ra), grey, "Tangent"),
            schema.SceneObject(cb, schema.Sphere(rb), grey, "Shadow tangent")]
        after = look(scene)
        port = after["port"]
        same = all(np.array_equal(before[k][shadow_lane], after[k][shadow_lane])
                   for k in ("so", "sd", "dist"))
        if not (same and after["obj"][lane] == a_idx and after["sobj"][shadow_lane] == b_idx
                and after["blocked"][shadow_lane]):
            continue
        if disc(port, after["o"][lane], after["d"][lane], a_idx) != 0.0:
            continue
        if disc(port, after["so"][shadow_lane], after["sd"][shadow_lane], b_idx) != 0.0:
            continue
        # B alone blocks the shadow ray within its light distance
        so = Vec3(*(torch.tensor(after["so"][shadow_lane:shadow_lane + 1, k], device=device)
                    for k in range(3)))
        sd = Vec3(*(torch.tensor(after["sd"][shadow_lane:shadow_lane + 1, k], device=device)
                    for k in range(3)))
        t_all = geometry.candidates(so, sd, port)[0].cpu().numpy()
        if np.nonzero(t_all <= after["dist"][shadow_lane])[0].tolist() != [b_idx]:
            continue
        # the other cases in the two warps: lanes with no root, lanes that hit
        mates = np.nonzero(warp == warp[lane])[0]
        misses = [i for i in mates if disc(port, after["o"][i], after["d"][i], a_idx) < 0.0]
        hitters = [i for i in mates if after["hit"][i] and after["sphere"][after["obj"][i]]
                   and after["obj"][i] != a_idx]
        smates = np.nonzero(warp == warp[shadow_lane])[0]
        slit = after["hit"] & after["matte"][after["obj"]]
        sblock = [i for i in smates if slit[i] and after["blocked"][i]
                  and after["sphere"][after["sobj"][i]] and after["sobj"][i] != b_idx]
        smiss = [i for i in smates
                 if disc(port, after["so"][i], after["sd"][i], b_idx) < 0.0]
        if misses and len(hitters) >= 2 and sblock and smiss:
            return scene, dict(lane=int(lane), shadow_lane=int(shadow_lane),
                               tangent=a_idx, shadow_tangent=b_idx,
                               shadow_rays=(after["so"], after["sd"]))
    raise AssertionError("no lane pair gave the tangent field")
