"""The port's live viewer (``spectral_tpu_torch/utils/viewer.py``) and
``python -m spectral_tpu_torch render --serve``: twins of the six cases of
``tests/test_viewer.py``, on the CPU.

The viewer is the reference's copy with its imports changed, so it is
also held to its original, each on its own port in this process: the same
``/``, ``/scene``, ``/spectra`` and ``/objects`` bytes for every preset,
the same ``/spectrum/preview`` answer, the same 400 texts for the same
illegal edits, and the same PNG bytes from ``update()`` for one seeded
framebuffer. Every HTTP call has a 10 s timeout, every server is closed in
``finally``, and every subprocess (``tests/torch_live.py``) has its own
deadline and is killed on the way out, so no case can hang the suite.
"""

import io
import json
import urllib.error

import numpy as np
import pytest

from spectral_tpu.scene import presets as jax_presets
from spectral_tpu.scene import schema as jax_schema
from spectral_tpu.utils.viewer import LiveViewer as JaxViewer
from spectral_tpu_torch.scene import presets, schema
from spectral_tpu_torch.utils import sceneio
from spectral_tpu_torch.utils.viewer import LiveViewer
from tests.torch_live import LiveRender, http_get, http_post

DEADLINE_S = 120  # each subprocess case, start to exit
SMALL = ["--preset", "default", "--width", "16", "--height", "8", "--iterations", "100000",
         "--bounces", "2", "--samples", "8", "--device", "cpu", "--serve", "0", "--quiet"]
_get, _post = http_get, http_post


def _status_code(url):
    try:
        return _get(url)[0]
    except urllib.error.HTTPError as e:
        return e.code


def _render(out, *extra):
    """``render --device cpu --serve 0`` of the default scene at 16x8 with
    an iteration count it cannot finish."""
    return LiveRender([*SMALL, "--out", out, *extra], DEADLINE_S)


def test_viewer_serves_frames_and_abort():
    """The page, no frame before the first update, the PNG of an update
    (the same bytes as the reference's viewer gives for the same seeded
    framebuffer), the status and the abort button."""
    v, ref = LiveViewer(port=0), JaxViewer(port=0)
    try:
        status, body = _get(v.url)
        assert status == 200 and b"Abort" in body
        assert body == _get(ref.url)[1]
        assert _status_code(v.url + "frame.png") == 404

        accum = np.zeros((8, 8, 4), np.float32)
        accum[..., 1] = 0.5
        accum[..., 3] = 1.0
        v.update(accum, frame=3, total=10, elapsed_s=1.5)
        status, png = _get(v.url + "frame.png")
        assert status == 200 and png[:8] == b"\x89PNG\r\n\x1a\n"
        from PIL import Image

        img = np.asarray(Image.open(io.BytesIO(png)))
        assert img.shape == (8, 8, 4) and img[0, 0, 1] == 127

        seeded = np.random.default_rng(11).uniform(-0.2, 1.4, (24, 32, 4)).astype(np.float32)
        v.update(seeded, frame=5, total=9, elapsed_s=2.25)
        ref.update(seeded, frame=5, total=9, elapsed_s=2.25)
        assert _get(v.url + "frame.png")[1] == _get(ref.url + "frame.png")[1]
        assert _get(v.url + "status")[1] == _get(ref.url + "status")[1]

        s = json.loads(_get(v.url + "status")[1])
        assert s["frame"] == 5 and s["total"] == 9 and not s["aborting"]
        assert not v.abort_requested()
        assert _post(v.url + "abort", b"")[0] == 200
        assert v.abort_requested()
        assert json.loads(_get(v.url + "status")[1])["aborting"]
    finally:
        v.close()
        ref.close()


@pytest.mark.parametrize("name", sorted(presets.PRESETS))
def test_endpoints_answer_as_the_reference_for_every_preset(name):
    """``/``, ``/scene``, ``/spectra`` and ``/objects`` of each preset,
    built by each package, byte for byte."""
    v, ref = LiveViewer(port=0), JaxViewer(port=0)
    try:
        v.publish_scene(presets.PRESETS[name]())
        ref.publish_scene(jax_presets.PRESETS[name]())
        for path in ("", "scene", "spectra", "objects"):
            got, want = _get(v.url + path), _get(ref.url + path)
            assert got == want, (name, path)
    finally:
        v.close()
        ref.close()


def test_cli_serve_end_to_end(tmp_path):
    """Render with --serve, watch progress over HTTP, press the Abort
    button: a clean chunk-granular abort with the image and a checkpoint.
    Then resume from it, served again, and abort a few chunks later: the
    render continued from the checkpoint's frame."""
    out = tmp_path / "img.png"
    with _render(out) as r:
        url = r.url()
        r.wait_status(url, lambda s: s["frame"] > 0)
        status, png = _get(url + "frame.png")
        assert status == 200 and png[:8] == b"\x89PNG\r\n\x1a\n"
        assert _post(url + "abort", b"")[0] == 200
        text = r.finish()
    assert r.proc.returncode == 0, text
    assert "aborted after" in text and out.exists()
    ckpt = tmp_path / "img.png.ckpt.npz"
    assert ckpt.exists(), text
    done = int(np.load(ckpt)["next_frame"])
    assert done > 0

    with _render(out, "--resume", ckpt) as r:
        url = r.url()
        assert f"resumed at frame {done}" in r.text
        r.wait_status(url, lambda s: s["frame"] >= done + 48)
        assert _post(url + "abort", b"")[0] == 200
        text = r.finish()
    assert r.proc.returncode == 0, text
    resumed = np.load(ckpt)
    assert int(resumed["next_frame"]) >= done + 48
    assert np.isfinite(resumed["accum"]).all() and float(resumed["accum"][..., :3].max()) > 0


def test_viewer_scene_edit_endpoints():
    """GET /scene serves the published scene; POST /scene validates (400
    on a legality error, with the reference's text) and queues the edit
    for the render loop."""
    v, ref = LiveViewer(port=0), JaxViewer(port=0)
    try:
        assert _status_code(v.url + "scene") == 404
        scene = presets.default_scene()
        v.publish_scene(scene)
        ref.publish_scene(jax_presets.default_scene())
        status, body = _get(v.url + "scene")
        assert status == 200
        d = json.loads(body)
        assert d["settings"]["width"] == scene.width

        bad = json.loads(body)
        bad["settings"]["iterations"] = 0
        status, msg = _post(v.url + "scene", json.dumps(bad).encode())
        assert status == 400 and b"iterations" in msg
        assert (status, msg) == _post(ref.url + "scene", json.dumps(bad).encode())
        assert not v.scene_edit_pending()
        assert _post(v.url + "scene", b"{not json") == _post(ref.url + "scene", b"{not json")

        good = json.loads(body)
        good["settings"]["width"] = 24
        status, msg = _post(v.url + "scene", json.dumps(good).encode())
        assert status == 200
        assert (status, msg) == _post(ref.url + "scene", json.dumps(good).encode())
        assert v.scene_edit_pending()
        edited = v.take_scene_edit()
        assert edited.width == 24 and isinstance(edited, schema.Scene)
        assert v.take_scene_edit() is None
        assert sceneio.scene_to_dict(edited)["settings"]["width"] == 24
    finally:
        v.close()
        ref.close()


def test_cli_serve_scene_edit_restarts(tmp_path):
    """A scene edit over HTTP restarts the render with the new scene at a
    chunk boundary (the reference's edit-then-Start cycle): the served
    scene flips, the frame count starts again, and the saved image has
    the edited height. A per-object edit restarts it too."""
    out = tmp_path / "img.png"
    with _render(out) as r:
        url = r.url()
        # two seconds and four chunks in: the count and the seconds after a
        # restart read lower for a while (the page updates once a second)
        before = r.wait_status(url, lambda s: s["elapsed_s"] >= 2.0 and s["frame"] >= 64)
        d = json.loads(_get(url + "scene")[1])
        d["settings"]["height"] = 16
        assert _post(url + "scene", json.dumps(d).encode())[0] == 200
        r.wait(lambda: json.loads(_get(url + "scene")[1])["settings"]["height"] == 16,
               "the edited scene")
        r.wait_status(url, lambda s: s["frame"] < before["frame"]
                      and s["elapsed_s"] < before["elapsed_s"])

        objects = json.loads(_get(url + "objects")[1])["objects"]
        moved = [c + 0.25 for c in objects[0]["position"]]
        status, msg = _post(url + "object", json.dumps(
            {"kind": "object", "index": 0, "action": "update",
             "fields": {"position": moved}}).encode())
        assert status == 200, msg
        # the page republishes an accepted object edit at once; the render
        # takes it at its next chunk
        r.wait(lambda: r.text.count("restarting render") == 2, "the second restart")
        assert json.loads(_get(url + "objects")[1])["objects"][0]["position"] == moved
        assert _post(url + "abort", b"")[0] == 200
        text = r.finish()
    assert r.proc.returncode == 0, text
    assert text.count("restarting render") == 2
    from PIL import Image

    assert np.asarray(Image.open(out)).shape[0] == 16  # the edited height


def _custom_scene(S, P):
    scene = P.default_scene()
    custom = S.SceneSpectrum.new(
        "my custom", S.Custom(), S.SpectrumEffectType.REFLECTIVE,
        n=scene.spectrum_number_of_samples,
        values=np.full(scene.spectrum_number_of_samples, 0.25, np.float32))
    scene.spectra.append(custom)
    return scene


def test_viewer_spectrum_editor_endpoints():
    """GET /spectra lists the editor state; POST /spectrum/preview
    computes colors without touching the scene (the reference's answer,
    byte for byte); POST /spectrum validates and queues the edit."""
    v, ref = LiveViewer(port=0), JaxViewer(port=0)
    try:
        scene = _custom_scene(schema, presets)
        v.publish_scene(scene)
        ref.publish_scene(_custom_scene(jax_schema, jax_presets))
        status, body = _get(v.url + "spectra")
        assert status == 200 and body == _get(ref.url + "spectra")[1]
        spectra = json.loads(body)
        assert len(spectra) == len(scene.spectra)
        mine = spectra[-1]
        assert mine["name"] == "my custom" and mine["editable"]
        assert len(mine["wavelengths"]) == len(mine["values"])
        assert mine["slider_max"] == 1.0
        assert set(mine["previews"]) == {"observed", "normalized", "reflected"}
        assert not spectra[0]["editable"] and spectra[0]["slider_max"] > 0.01

        cand = [min(1.0, 2 * x) for x in mine["values"]]
        preview = json.dumps({"index": len(spectra) - 1, "values": cand}).encode()
        status, got = _post(v.url + "spectrum/preview", preview)
        assert status == 200 and got == _post(ref.url + "spectrum/preview", preview)[1]
        p = json.loads(got)
        assert p["previews"]["reflected"][1] > mine["previews"]["reflected"][1]
        assert json.loads(_get(v.url + "spectra")[1])[-1]["values"] == mine["values"]
        short = json.dumps({"index": len(spectra) - 1, "values": cand[:3]}).encode()
        status, msg = _post(v.url + "spectrum/preview", short)
        assert status == 400 and (status, msg) == _post(ref.url + "spectrum/preview", short)

        bad = list(mine["values"])
        bad[0] = 2.0
        for edit in ({"index": len(spectra) - 1, "values": bad}, {"index": 0, "values": cand}):
            body = json.dumps(edit).encode()
            status, msg = _post(v.url + "spectrum", body)
            assert status == 400 and (status, msg) == _post(ref.url + "spectrum", body)
        assert not v.scene_edit_pending()

        status, _ = _post(v.url + "spectrum", preview)
        assert status == 200 and v.scene_edit_pending()
        edited = v.take_scene_edit()
        np.testing.assert_allclose(edited.spectra[-1].spectrum.values,
                                   np.asarray(cand, np.float32))
        assert json.loads(_get(v.url + "spectra")[1])[-1]["values"] == [
            float(np.float32(x)) for x in cand]
    finally:
        v.close()
        ref.close()


def test_viewer_per_object_editor_endpoints():
    """The per-object editor: GET /objects, and POST /object update, copy,
    toggle_hidden and delete for objects, lights and materials; every
    accepted edit is queued, every illegal one refused with the
    reference's 400 text and nothing queued."""
    v, ref = LiveViewer(port=0), JaxViewer(port=0)
    try:
        scene = presets.cornell_box()
        v.publish_scene(scene)
        ref.publish_scene(jax_presets.cornell_box())
        status, body = _get(v.url + "objects")
        state = json.loads(body)
        assert status == 200 and body == _get(ref.url + "objects")[1]
        n_obj, n_lights = len(state["objects"]), len(state["lights"])
        assert n_obj == len(scene.objects) and state["materials"]
        first = state["objects"][0]
        assert first["material"] in state["material_names"]

        def post(edit, expect_ok=True):
            body = json.dumps(edit).encode()
            status, msg = _post(v.url + "object", body)
            assert (status, msg) == _post(ref.url + "object", body), edit
            assert (status == 200) == expect_ok, msg
            return msg

        new_pos = [p + 0.25 for p in first["position"]]
        params = {k: float(first["params"][k]) * 1.5 for k in first["editable_params"]}
        msg = post({"kind": "object", "index": 0, "action": "update",
                    "fields": {"name": "edited-obj", "position": new_pos,
                               "params": params, "material": first["material"]}})
        assert b"edited-obj" in msg
        edited = v.take_scene_edit()
        ref.take_scene_edit()
        assert edited.objects[0].name == "edited-obj"
        assert edited.objects[0].position[0] == new_pos[0]
        assert json.loads(_get(v.url + "objects")[1])["objects"][0]["name"] == "edited-obj"

        post({"kind": "object", "index": 1, "action": "copy"})
        objs = json.loads(_get(v.url + "objects")[1])["objects"]
        assert len(objs) == n_obj + 1 and objs[-1]["name"].endswith(" copy")
        post({"kind": "object", "index": n_obj, "action": "delete"})
        assert len(json.loads(_get(v.url + "objects")[1])["objects"]) == n_obj
        post({"kind": "object", "index": 0, "action": "toggle_hidden"})
        assert json.loads(_get(v.url + "objects")[1])["objects"][0]["hidden"]
        post({"kind": "object", "index": 0, "action": "toggle_hidden"})

        li = json.loads(_get(v.url + "objects")[1])["lights"][0]
        post({"kind": "light", "index": 0, "action": "update",
              "fields": {"position": [0.0, 0.9, 0.5], "spectrum": li["spectrum"]}})
        lights = json.loads(_get(v.url + "objects")[1])["lights"]
        assert lights[0]["position"][1] == 0.9 and len(lights) == n_lights
        post({"kind": "material", "index": 0, "action": "update",
              "fields": {"metallicness": 0.75, "roughness": 0.3}})
        m0 = json.loads(_get(v.url + "objects")[1])["materials"][0]
        assert m0["metallicness"] == 0.75 and m0["roughness"] == 0.3
        assert _get(v.url + "objects")[1] == _get(ref.url + "objects")[1]

        v.take_scene_edit()
        ref.take_scene_edit()
        for edit in ({"kind": "object", "index": 0, "action": "update",
                      "fields": {"material": "no-such-material"}},
                     {"kind": "object", "index": 99, "action": "delete"},
                     {"kind": "material", "index": 0, "action": "update",
                      "fields": {"transmission": 2.0}},
                     {"kind": "material", "index": 0, "action": "delete"},
                     {"kind": "nothing", "index": 0}):
            post(edit, expect_ok=False)
        assert not v.scene_edit_pending()
    finally:
        v.close()
        ref.close()
