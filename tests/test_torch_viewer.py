"""The port's live viewer against the JAX package's, on the CPU.

``gsplat_tpu_torch.interact.viewer``, ``cli/view.py`` and ``assets/ade20k.py``
against ``gsplat_tpu.interact.viewer`` on the scene of ``test_viewer.py``'s
fixture (200 gaussians, ``seed=3``, 64x48, 4 orbit cameras): each server
runs in a thread on a free port and both get the same requests. The JAX
viewer serves JPEG, so its frames are taken from the array it hands to
``PIL.Image.fromarray``; the port's are PNG, decoded by ``io/png.py``.
"""

import json
import sys
import threading
from http.client import HTTPConnection
from http.server import ThreadingHTTPServer

import numpy as np
import PIL.Image
import pytest
import torch

from gsplat_tpu.assets import ade20k as jade20k
from gsplat_tpu.interact import viewer as jviewer
from gsplat_tpu.io import cameras as jcameras
from gsplat_tpu.io import ply as jply
from gsplat_tpu.io import synthetic as jsynthetic
from gsplat_tpu_torch.assets import ade20k as tade20k
from gsplat_tpu_torch.cli import view as tcli
from gsplat_tpu_torch.interact import edit as tedit
from gsplat_tpu_torch.interact import viewer as tviewer
from gsplat_tpu_torch.io import cameras as tcameras
from gsplat_tpu_torch.io import png as tpng
from gsplat_tpu_torch.render import api as tapi
from gsplat_tpu_torch.scene import FIELDS, scene_from_numpy

torch.set_num_threads(2)

CPU = "cpu"
W, H = 64, 48
POSE = "theta=0.5&phi=0.2&r=3"


def _jax_scene(n=200, seed=3, labels=4):
    return jsynthetic.random_scene(n, seed=seed, extent=1.0,
                                   scale_range=(0.05, 0.1), num_labels=labels)


def _port_scene(jscene):
    s = jscene.to_numpy()
    return scene_from_numpy(**{f: np.asarray(getattr(s, f)) for f in FIELDS},
                            device=CPU)


def _port_cameras(jcams):
    return [tcameras.Camera.from_json(c.to_json()) for c in jcams]


def _serve(srv):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), srv.make_handler())
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def _request(port, method, path, body=None):
    conn = HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path, body=body)
        r = conn.getresponse()
        return r.status, r.getheader("Content-Type"), r.read()
    finally:
        conn.close()


class Pair:
    """A JAX viewer and the port's on the same scene, cameras and session
    file name, each serving on its own port."""

    def __init__(self, tmp, jscene, jcams):
        self.jax = jviewer.ViewerServer(
            jscene, width=W, height=H, cameras=jcams,
            session_path=str(tmp / "jax_session.json"))
        self.port = tviewer.ViewerServer(
            _port_scene(jscene), width=W, height=H,
            cameras=_port_cameras(jcams),
            session_path=str(tmp / "port_session.json"), device=CPU)
        self._httpd = [_serve(self.jax), _serve(self.port)]
        self.ports = [h.server_address[1] for h in self._httpd]

    def get(self, path, method="GET", body=None):
        """(JAX answer, port answer), each (status, content type, body)."""
        return tuple(_request(p, method, path, body) for p in self.ports)

    def frames(self, path, monkeypatch):
        """(JAX frame, port frame) as [H, W, 3] uint8 arrays."""
        seen = []
        fromarray = PIL.Image.fromarray

        def record(arr, *a, **k):
            seen.append(np.array(arr))
            return fromarray(arr, *a, **k)

        with monkeypatch.context() as m:
            m.setattr(PIL.Image, "fromarray", record)
            (js, jt, _), (ps, pt, body) = self.get(path)
        assert (js, jt) == (200, "image/jpeg") and len(seen) == 1
        assert (ps, pt) == (200, "image/png") and body[:8] == tpng.SIGNATURE
        return seen[0], tpng.decode_png(body)

    def close(self):
        for h in self._httpd:
            h.shutdown()
            h.server_close()


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    p = Pair(tmp_path_factory.mktemp("viewer"), _jax_scene(),
             jcameras.orbit_cameras(4, 3.0, width=W, img_height=H))
    yield p
    p.close()


def _close_frames(want, got):
    """The render's bar, 5e-3, after truncation to uint8: at most 2 apart,
    and at least 99.9% of values equal."""
    assert want.shape == got.shape == (H, W, 3)
    diff = np.abs(want.astype(np.int32) - got.astype(np.int32))
    assert diff.max() <= 2
    assert (diff == 0).mean() >= 0.999


def test_ade20k_matches_jax():
    assert tade20k.id2label() == jade20k.id2label()
    assert tade20k.ADE20K_CLASSES == jade20k.ADE20K_CLASSES
    assert tade20k.label_name(7) == "bed "
    assert tade20k.label_name(-1) == "unlabeled"
    assert tade20k.label_name(999) == "999"


def test_cameras_and_campose_match_jax(pair):
    (js, _, jb), (ps, _, pb) = pair.get("/cameras")
    assert js == ps == 200 and json.loads(jb) == json.loads(pb) == {
        "count": 4}
    for cam in range(4):
        (js, _, jb), (ps, _, pb) = pair.get(f"/campose?cam={cam}")
        want, got = json.loads(jb), json.loads(pb)
        assert js == ps == 200 and set(got) == set(want)
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-6, k
    assert pair.port.center.dtype == np.float32
    np.testing.assert_array_equal(pair.port.center, pair.jax.center)
    assert pair.port.radius == pair.jax.radius


def test_select_payloads_match_jax(pair):
    points = ["x=0.5&y=0.5&theta=0&phi=0&r=3",
              "x=0.3&y=0.6&theta=0.5&phi=0.2&r=3",
              "x=0.7&y=0.4&theta=2&phi=-0.3&r=2.5",
              "x=0.5&y=0.5&cam=2&r=3",
              "x=-4&y=-4&theta=0&phi=0&r=3"]    # off the frame: a miss
    got = []
    for q in points:
        (js, _, jb), (ps, _, pb) = pair.get("/select?" + q)
        assert js == ps == 200
        assert json.loads(pb) == json.loads(jb)
        got.append(json.loads(pb))
    assert got[-1] == {"label": None, "name": "", "count": 0}
    hits = [g for g in got if g["label"] is not None]
    assert len(hits) >= 3
    labels = pair.port.scene.labels
    for g in hits:
        assert g["count"] == int((labels == g["label"]).sum())
        assert g["name"] == tade20k.label_name(g["label"])


def test_frames_match_jax_through_edits(pair, monkeypatch):
    """Frames with and without labels, then after a select and sel=1,
    set_color, hide and displace, against the JAX viewer's; the port's
    session file holds the JAX viewer's JSON after each edit."""
    views = [f"/render?{POSE}", f"/render?{POSE}&labels=1",
             "/render?cam=1&r=3&labels=1"]
    for v in views:
        _close_frames(*pair.frames(v, monkeypatch))
    (js, _, jb), (ps, _, pb) = pair.get("/select?x=0.5&y=0.5&" + POSE)
    lab = json.loads(pb)["label"]
    assert lab is not None and json.loads(jb)["label"] == lab
    edits = [f"action=set_color&label={lab}&r=1&g=0&b=0.5",
             f"action=hide&label={(lab + 1) % 4}",
             f"action=displace&label={lab}&dx=1&dy=0&dz=0"]
    for e in ["", *edits]:
        if e:
            (js, _, _), (ps, _, pb) = pair.get("/edit?" + e)
            assert js == ps == 200 and pb == b"{}"
            with open(pair.port.session_path) as f:
                got = f.read()
            with open(pair.jax.session_path) as f:
                assert json.loads(got) == json.loads(f.read())
            assert got == pair.port.edits.to_json()
        _close_frames(*pair.frames(f"/render?{POSE}&sel=1", monkeypatch))
    _close_frames(*pair.frames(f"/render?{POSE}&labels=1&sel=1",
                               monkeypatch))
    for e in ("reset_disp", "reset_vis", "reset_color"):
        pair.get("/edit?action=" + e)
    assert pair.port.edits.to_json() == tedit.EditState(
        selected_label=lab, selection_mode=True).to_json()


@pytest.mark.parametrize("labels", [False, True])
def test_frame_pixels_is_the_numpy_formula(pair, labels):
    """``frame_pixels`` against ``viewer.py:341-350``'s numpy lines on the
    port's own float image, bit for bit."""
    srv = pair.port
    with srv.lock:
        srv.edits.selection_mode = False
        cam = srv._camera(0.5, 0.2, 3.0)
        out = tapi.render(tedit.apply_edits(srv.scene, srv.edits), cam,
                          srv.cfg, with_labels=labels, device=CPU)
    img = np.clip(out["image"].numpy(), 0, 1)
    if labels:
        lm = out["label_map"].numpy()
        palette = np.random.default_rng(0).uniform(0.25, 1.0, size=(256, 3))
        overlay = palette[np.abs(lm) % 256] * (lm != -1)[..., None]
        img = 0.4 * img + 0.6 * overlay
    want = (img * 255).astype(np.uint8)
    got = srv.frame_pixels(0.5, 0.2, 3.0, labels, selection=False)
    assert got.dtype == np.uint8 and got.shape == (H, W, 3)
    np.testing.assert_array_equal(got, want)


def test_selection_toggle_gives_back_the_frame(pair):
    """sel=1 mixes the selected label red; sel=0 afterwards gives the first
    frame back bit for bit (PNG is lossless)."""
    srv = pair.port
    port = pair.ports[1]
    with srv.lock:
        srv.edits.selected_label = int(srv.scene.labels[0])
    frames = [tpng.decode_png(_request(port, "GET",
                                       f"/render?{POSE}&sel={s}")[2])
              for s in (0, 1, 0)]
    np.testing.assert_array_equal(frames[2], frames[0])
    diff = frames[1].astype(np.int64) - frames[0]
    assert np.abs(diff).max() > 5
    assert diff[..., 0].sum() > max(diff[..., 1].sum(), diff[..., 2].sum())
    assert not srv.edits.selection_mode


def test_errors_match_jax(pair):
    for method, path, body in (("GET", "/nope", None),
                               ("POST", "/nope", b"x"),
                               ("GET", "/campose?cam=99", None),
                               ("GET", "/select?y=0.5", None),
                               ("GET", "/render?theta=abc", None),
                               ("POST", "/load", b"not a scene")):
        (js, jt, _), (ps, pt, _) = pair.get(path, method, body)
        assert (ps, pt) == (js, jt), path
        assert ps in (404, 500)
    status, ctype, body = _request(pair.ports[1], "GET", "/")
    assert (status, ctype) == (200, "text/html")
    assert body == jviewer._PAGE.encode()


def test_load_ply_and_cameras_match_jax(tmp_path):
    jscene = _jax_scene(100, seed=5, labels=3)
    pair = Pair(tmp_path, jscene,
                jcameras.orbit_cameras(4, 3.0, width=W, img_height=H))
    try:
        small = _jax_scene(50, seed=9, labels=2)
        ply = tmp_path / "s.ply"
        jply.scene_to_ply(str(ply), small)
        (js, _, jb), (ps, _, pb) = pair.get("/load", "POST", ply.read_bytes())
        assert js == ps == 200
        assert json.loads(pb) == json.loads(jb) == {"gaussians": 50}
        want = _port_scene(small)
        for f in FIELDS:
            assert torch.equal(getattr(pair.port.scene, f), getattr(want, f))
        np.testing.assert_array_equal(pair.port.center, pair.jax.center)
        assert pair.port.radius == pair.jax.radius

        cams = tmp_path / "c.json"
        jcameras.save_cameras(str(cams),
                              jcameras.orbit_cameras(7, 2.0, width=W,
                                                     img_height=H))
        (js, _, jb), (ps, _, pb) = pair.get("/load", "POST",
                                            cams.read_bytes())
        assert json.loads(pb) == json.loads(jb) == {"cameras": 7}
        assert [c.to_json() for c in pair.port.cameras] == [
            c.to_json() for c in pair.jax.cameras]
        status, ctype, body = _request(pair.ports[1], "GET",
                                       "/render?cam=6&r=2")
        assert (status, ctype) == (200, "image/png")
        assert tpng.decode_png(body).shape == (H, W, 3)
    finally:
        pair.close()


def test_concurrent_requests_lose_no_edit(tmp_path):
    """Each request runs on a thread of its own: 12 threads of 10
    displacements each, with frames beside them, under a short switch
    interval, leave the displacement 120 steps long and the session file
    equal to the edit state."""
    srv = tviewer.ViewerServer(_port_scene(_jax_scene()), width=W, height=H,
                               session_path=str(tmp_path / "s.json"),
                               device=CPU)
    httpd = _serve(srv)
    port = httpd.server_address[1]
    answers = []

    def client(path, times):
        for _ in range(times):
            answers.append(_request(port, "GET", path)[0])

    threads = [threading.Thread(target=client, args=(
        "/edit?action=displace&label=1&dx=1&dy=0&dz=0", 10))
        for _ in range(12)]
    threads += [threading.Thread(target=client, args=(f"/render?{POSE}", 2))
                for _ in range(2)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
        httpd.shutdown()
        httpd.server_close()
    assert not any(t.is_alive() for t in threads)
    assert answers == [200] * 124
    want = tedit.EditState()
    for _ in range(120):
        want.displace(1, (1.0, 0.0, 0.0),
                      step=srv.cfg.interact.displacement_step)
    assert srv.edits.displacements == want.displacements
    with open(srv.session_path) as f:
        assert f.read() == srv.edits.to_json()


def test_viewer_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tviewer.ViewerServer(_port_scene(_jax_scene(10)))


def test_cli_loads_prewarms_and_serves(tmp_path, monkeypatch, capsys):
    ply = tmp_path / "s.ply"
    jply.scene_to_ply(str(ply), _jax_scene())
    cams = tmp_path / "c.json"
    jcameras.save_cameras(str(cams), jcameras.orbit_cameras(
        3, 3.0, width=W, img_height=H))
    calls = {}
    prewarm = tviewer.ViewerServer.prewarm

    def record_prewarm(self):
        calls["prewarm"] = self
        prewarm(self)

    def record_serve(self, host, port):
        calls["serve"] = (self, host, port)

    monkeypatch.setattr(tviewer.ViewerServer, "prewarm", record_prewarm)
    monkeypatch.setattr(tviewer.ViewerServer, "serve", record_serve)
    assert tcli.main(["--ply_file", str(ply), "--camera_file", str(cams),
                      "--port", "0", "--width", str(W), "--height", str(H),
                      "--session", str(tmp_path / "e.json"),
                      "--device", "cpu"]) == 0
    assert "loaded 200 gaussians" in capsys.readouterr().out
    srv, host, port = calls["serve"]
    assert calls["prewarm"] is srv
    assert (host, port) == ("127.0.0.1", 0)
    assert srv.device == torch.device(CPU) and len(srv.cameras) == 3
    assert (srv.width, srv.height) == (W, H)
    for f in FIELDS:
        assert torch.equal(getattr(srv.scene, f),
                           getattr(_port_scene(_jax_scene()), f))
