"""The port's live preview (io/preview.py, a copy of the JAX package's) and
the CLI's --preview and --serve, on the CPU: the cases of
tests/test_preview.py against the port."""

import json
import os
import urllib.error
import urllib.request

import numpy as np
import torch
from PIL import Image

from raysnail_tpu_torch import cli, ir
from raysnail_tpu_torch.camera import build_camera
from raysnail_tpu_torch.config import RenderConfig
from raysnail_tpu_torch.io.preview import PreviewServer
from raysnail_tpu_torch.render import render_passes
from raysnail_tpu_torch.scene import SceneBuilder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as r:
        return r.status, r.read()


def test_preview_serves_page_frame_status_and_cancel():
    srv = PreviewServer(port=0)  # ephemeral port
    try:
        status, body = _get(srv.port, "/")
        assert status == 200 and b"raysnail-tpu" in body

        try:  # no frame yet
            _get(srv.port, "/frame.png")
            raise AssertionError("a frame before the first update")
        except urllib.error.HTTPError as e:
            assert e.code == 404

        img = np.linspace(0, 1, 8 * 6 * 3, dtype=np.float32).reshape(6, 8, 3)
        assert srv.target(5, 16, img, pass_index=1, mrays=1.5) is True

        status, png = _get(srv.port, "/frame.png")
        assert status == 200 and png[:8] == b"\x89PNG\r\n\x1a\n"

        status, body = _get(srv.port, "/status")
        s = json.loads(body)
        assert s["done"] == 5 and s["total"] == 16 and s["pass"] == 1

        # DELETE cancels: target starts returning False
        req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/", method="DELETE")
        with urllib.request.urlopen(req, timeout=5) as r:
            assert r.status == 200
        assert srv.target(6, 16, img) is False
    finally:
        srv.close()


def test_render_passes_honors_cancel():
    """progress returning False stops further passes. noise_threshold 0
    redoes every pixel (the JAX package's case uses -1, which the port's
    config refuses; every noise is >= 0, so both redo them all)."""
    torch.set_num_threads(1)
    b = SceneBuilder()
    b.add(ir.Sphere((0, 0, -2), 0.5, ir.Lambertian(ir.Constant((0.5, 0.5, 0.5)))))
    b.set_background((1, 1, 1), (1, 1, 1))
    scene = b.compile(device="cpu")
    cfg = RenderConfig(width=16, height=10, samples=4, max_depth=2, passes=4,
                       noise_threshold=0.0)
    cam = build_camera(look_from=(0, 0, 0), look_at=(0, 0, -1), fov=60, width=16, height=10,
                       device="cpu")
    calls = []

    def cancel_after_two(done, total, img):
        calls.append(done)
        return len(calls) < 2

    render_passes(scene, cam, cfg, seed=0, progress=cancel_after_two)
    assert len(calls) == 2  # pass 3 and 4 never ran


def test_cli_preview_rewrites_the_png_and_serve_starts_and_stops(tmp_path, capsys):
    out = tmp_path / "preview.png"
    rc = cli.main(["--scene", os.path.join(REPO, "sdl", "example.sdl"), "-w", "16",
                   "--height", "10", "--samples", "4", "--passes", "2", "--device", "cpu",
                   "--preview", "--serve", "0", "-o", str(out)])
    assert rc == 0
    text = capsys.readouterr().out
    assert "live preview at http://127.0.0.1:" in text and "4/8 samples" in text
    assert np.asarray(Image.open(out)).shape == (10, 16, 3)
    port = int(text.split("live preview at http://127.0.0.1:")[1].split("/")[0])
    try:  # the server was shut down with the render
        _get(port, "/status")
        raise AssertionError("the preview server outlived the render")
    except urllib.error.URLError:
        pass
