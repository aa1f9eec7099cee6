"""The port's live viewer (``webviewer.LiveViewer``) and the CLI's served
loop (``--serve``) against the JAX package's.

JAX's viewer cases (``tests/test_webviewer.py``) run on the port's viewer,
which binds the loopback interface and ends its streams when stopped. A
served CLI run with no control requests logs the unserved run's X/Y/Z
exactly and JAX's served run's within 2e-3 m (``tests/test_dist.py:83``'s
bound). Pause, resume, the static view and reset are driven over HTTP
while the CLI runs in a daemon thread; every request has a timeout and
every wait a deadline, and the viewers are stopped in ``finally``.
"""

import contextlib
import io
import json
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from supereight_tpu import cli as jax_cli
from supereight_tpu import webviewer as jax_webviewer
from supereight_tpu_torch import cli, webviewer
from supereight_tpu_torch.pipeline import DenseSLAMSystem

DEADLINE = 120.0   # s for any one state the served run must reach
SERVED_ARGS = ["--synthetic", "8", "-v", "64", "-z", "2"]


@pytest.fixture()
def viewer():
    v = webviewer.LiveViewer(port=0)          # ephemeral port
    v.start()
    yield v
    v.stop()


def _get(port, path, timeout=10):
    return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                  timeout=timeout)


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_page_stats_and_controls(viewer):
    assert b"supereight-tpu" in _get(viewer.port, "/").read()

    viewer.push(np.zeros((4, 4, 4), np.uint8), stats={"frame": 7})
    st = json.loads(_get(viewer.port, "/stats").read())
    assert st["frame"] == 7.0

    assert not viewer.paused
    _get(viewer.port, "/ctl?cmd=pause")
    assert viewer.paused
    _get(viewer.port, "/ctl?cmd=resume")
    assert not viewer.paused

    assert viewer.view_mode == "follow"
    _get(viewer.port, "/ctl?cmd=view=static")
    assert viewer.view_mode == "static"

    assert not viewer.reset_pending
    _get(viewer.port, "/ctl?cmd=reset")
    assert viewer.reset_pending
    assert viewer.take_reset()
    assert not viewer.take_reset()   # one-shot

    with pytest.raises(urllib.error.HTTPError, match="404"):
        _get(viewer.port, "/nowhere")


def test_stream_serves_pushed_jpeg(viewer):
    rgba = np.zeros((8, 8, 4), np.uint8)
    rgba[..., 0] = 200
    viewer.push(rgba)
    r = _get(viewer.port, "/stream")
    assert "multipart/x-mixed-replace" in r.headers["Content-Type"]
    # one multipart frame: boundary, jpeg header, payload
    assert r.readline().strip() == b"--se8frame"
    assert b"image/jpeg" in r.readline()
    n = int(r.readline().split(b":")[1])
    r.readline()
    jpeg = r.read(n)
    assert jpeg[:2] == b"\xff\xd8"   # JPEG SOI marker
    im = Image.open(io.BytesIO(jpeg))
    assert im.size == (8, 8)
    r.close()


def test_binds_loopback_and_stop_ends_streams():
    """JAX's binds 0.0.0.0 with unauthenticated controls; the port's
    binds 127.0.0.1 unless told otherwise, and stop() ends a stream that
    waits for a frame."""
    v = webviewer.LiveViewer(port=0)
    v.start()
    try:
        assert v._server.server_address[0] == "127.0.0.1"
        v.push(np.zeros((4, 4, 3), np.uint8))
        r = _get(v.port, "/stream")
        assert r.readline().strip() == b"--se8frame"
        r.readline()
        n = int(r.readline().split(b":")[1])
        r.readline()
        r.read(n + 2)
    finally:
        t0 = time.perf_counter()
        v.stop()
    assert r.read() == b""           # the stream ended
    assert time.perf_counter() - t0 < 5.0
    r.close()
    assert webviewer.LiveViewer(port=0, host="localhost")._host == \
        "localhost"


def log_xyz(path):
    lines = open(path).read().splitlines()
    assert lines[0] == cli.LOG_HEADER
    return np.array([[float(v) for v in r.split("\t")] for r in lines[1:]])


@pytest.fixture()
def jax_viewers(monkeypatch):
    """JAX's CLI never stops its viewer: record each one to stop it."""
    made = []

    class Recorded(jax_webviewer.LiveViewer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)
    monkeypatch.setattr(jax_webviewer, "LiveViewer", Recorded)
    yield made
    for v in made:
        v.stop()


def test_served_run_equals_unserved_and_jax(tmp_path, jax_viewers):
    torch.set_num_threads(1)
    logs = {}
    for name, main, serve in (("plain", cli.main, []),
                              ("served", cli.main, ["--serve"]),
                              ("jax", jax_cli.main, ["--serve"])):
        logs[name] = str(tmp_path / f"{name}.log")
        argv = SERVED_ARGS + ["-o", logs[name]]
        if serve:
            argv += ["--serve", str(free_port())]
        if main is cli.main:
            argv += ["--platform", "cpu"]
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            assert main(argv) == 0
        assert ("# live view" in err.getvalue()) == bool(serve)
    plain, served, jax = (log_xyz(logs[n]) for n in ("plain", "served",
                                                      "jax"))
    assert plain.shape == served.shape == jax.shape == (8, 14)
    np.testing.assert_array_equal(served[:, 9:], plain[:, 9:])
    np.testing.assert_allclose(served[:, 9:12], jax[:, 9:12], atol=2e-3)
    np.testing.assert_array_equal(served[:, 12:], jax[:, 12:])
    assert len(jax_viewers) == 1


class Session:
    """A served CLI run in a daemon thread, its viewer started paused so
    the test sets the pace; stats and controls go over HTTP."""

    def __init__(self, monkeypatch, argv):
        self.viewers = []
        self.volumes = []   # view_pose of each rendered frame's volume
        session = self

        class Paused(webviewer.LiveViewer):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                self.paused = True
                session.viewers.append(self)
        monkeypatch.setattr(webviewer, "LiveViewer", Paused)
        render_views = DenseSLAMSystem.render_views

        def spy(pipe, view_pose=None):
            self.volumes.append(None if view_pose is None
                                else np.array(view_pose))
            return render_views(pipe, view_pose)
        monkeypatch.setattr(DenseSLAMSystem, "render_views", spy)
        self.port = free_port()
        self.result = {}
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       args=(argv + ["--serve",
                                                     str(self.port)],))

    def _run(self, argv):
        try:
            self.result["pipe"] = cli.run(argv)
        except BaseException as e:   # reported by the test's thread
            self.result["error"] = e

    def stats(self):
        return json.loads(_get(self.port, "/stats").read())

    def ctl(self, cmd):
        assert _get(self.port, "/ctl?cmd=" + cmd).status == 204

    def wait(self, cond, what):
        end = time.perf_counter() + DEADLINE
        while time.perf_counter() < end:
            assert "error" not in self.result, self.result["error"]
            got = cond()
            if got:
                return got
            time.sleep(0.02)
        raise AssertionError(f"served run: timed out waiting for {what}")

    def up(self):
        def answering():
            try:
                return self.viewers and self.stats() == {}
            except OSError:
                return False
        return self.wait(answering, "the server")

    def frame_at_least(self, n):
        return self.wait(lambda: (s := self.stats()).get("frame", -1) >= n
                         and s, f"frame {n}")

    def settle(self):
        """Wait until a paused run has pushed its last frame."""
        def still():
            a = self.stats()
            time.sleep(0.3)
            return a == self.stats() and a
        return self.wait(still, "the pause")


def test_controls_over_http(tmp_path, monkeypatch):
    """Pause holds the frame count for over a second and resume lets it
    go on; the stream's JPEG decodes to the composite's size; the static
    view renders every volume from one pose, captured at the switch; a
    reset makes the block count fall, then rise."""
    torch.set_num_threads(1)
    s = Session(monkeypatch, ["--synthetic", "24", "-v", "64", "-z", "2",
                              "-r", "1", "--groundtruth-mode", "--platform",
                              "cpu", "-o", str(tmp_path / "log")])
    s.thread.start()
    try:
        s.up()
        time.sleep(0.5)
        assert s.stats() == {} and not s.volumes   # paused at frame 0
        s.ctl("resume")
        s.frame_at_least(6)
        s.ctl("pause")
        held = s.settle()
        time.sleep(1.0)
        assert s.stats() == held
        assert held["tracked"] == 1 and held["blocks"] > 0
        assert set(held) >= {"frame", "tracked", "blocks", "alloc_overflow",
                             "ray_overflow"}

        r = _get(s.port, "/stream")
        assert r.readline().strip() == b"--se8frame"
        r.readline()
        n = int(r.readline().split(b":")[1])
        r.readline()
        assert Image.open(io.BytesIO(r.read(n))).size == (320, 240)
        r.close()

        n_follow = len(s.volumes)
        assert n_follow >= 2 and all(v is None for v in s.volumes)
        s.ctl("view=static")
        s.ctl("resume")
        s.frame_at_least(held["frame"] + 6)
        s.ctl("pause")
        s.ctl("view=follow")
        before = s.settle()
        static = s.volumes[n_follow:]
        assert len(static) >= 2
        for v in static:
            assert v is not None
            np.testing.assert_array_equal(v, static[0])

        s.ctl("reset")
        s.ctl("resume")
        fell = s.wait(lambda: (st := s.stats())["frame"] > before["frame"]
                      and st, "a frame after the reset")
        assert fell["blocks"] < before["blocks"], (fell, before)
        s.wait(lambda: s.stats()["blocks"] > fell["blocks"],
               "the blocks to rise after the reset")
        s.thread.join(DEADLINE)
        assert not s.thread.is_alive()
        assert "error" not in s.result
        assert s.volumes[-1] is None
    finally:
        for v in s.viewers:
            v.paused = False
        s.thread.join(DEADLINE)
        for v in s.viewers:
            v.stop()
