"""The port's CLI (``python -m supereight_tpu_torch.cli``) against the JAX
package's, end to end from a ``.raw`` file to ATE.

``io/convert.synthetic2raw`` writes small sequences (640x480 with their
TUM ground truth); both CLIs run them through ``main(argv)`` (the port
with ``--platform cpu``, JAX on the CPU): the orbit (eight frames at
``-c 2 -v 128``, ICP from frame 4), the closed loop (six frames at ``-c 4
-v 64``, a whole circle: the plumbing of its ground-truth alignment) and
``--synthetic 6``. The frame logs' X/Y/Z agree to 2e-3 m and their tracked and
integrated columns exactly, the TUM trajectories to 2e-3 (time stamps
exactly), the ``# ATE RMSE`` lines to 2e-3 m and the drop-counter lines
exactly; the 2x2 renders' depth quadrant is equal byte for byte. With
``--keyframe-rate`` both close a loop over an orbit that goes out and
comes back, and their post-BA trajectories agree to 2e-3 and their ATE
to 1 mm. The options whose modules are not ported exit naming their
ROADMAP item, and the module entry points run.
"""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from supereight_tpu import cli as jax_cli
from supereight_tpu_torch import cli
from supereight_tpu_torch.io.convert import synthetic2raw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAW_ARGS = ["-s", "4.8", "-p", "0.5,0.4583,0.18", "-r", "1"]
# the loop at the size of a few frames; the orbit where its ICP is well
# conditioned: at -c 4 it tracks from a pose four frames old, and the
# inlier gate's flips amplify the last bits of the Gram sums (f64 in the
# port, f32 in JAX) to 2.8 mm by frame 7 at -v 128 (ROADMAP.md Queue 3)
LOOP_ARGS = ["-c", "4", "-v", "64"] + RAW_ARGS
ORBIT_ARGS = ["-c", "2", "-v", "128"] + RAW_ARGS


def run(main, argv, tmp, tag):
    """Run a CLI's main; returns (frame log rows, trajectory rows, stderr
    lines)."""
    log, traj = str(tmp / f"{tag}.log"), str(tmp / f"{tag}.traj")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert main(argv + ["-o", log, "--trajectory-out", traj]) == 0
    lines = open(log).read().splitlines()
    assert lines[0] == cli.LOG_HEADER == jax_cli.LOG_HEADER
    rows = np.array([[float(v) for v in r.split("\t")] for r in lines[1:]])
    tr = np.loadtxt(traj, ndmin=2)
    return rows, tr, err.getvalue().splitlines()


def stderr_line(lines, prefix):
    found = [ln for ln in lines if ln.startswith(prefix)]
    assert len(found) == 1, (prefix, lines)
    return found[0]


def compare(tmp, argv, min_tracked, extra=None):
    """Both CLIs on ``argv`` (plus ``extra[name]`` each), compared."""
    torch.set_num_threads(1)
    extra = extra or {}
    jr, jt, je = run(jax_cli.main, argv + extra.get("jax", []), tmp, "jax")
    tr, tt, te = run(cli.main, argv + ["--platform", "cpu"]
                     + extra.get("port", []), tmp, "port")
    assert tr.shape == jr.shape
    np.testing.assert_array_equal(tr[:, 0], jr[:, 0])
    np.testing.assert_allclose(tr[:, 9:12], jr[:, 9:12], atol=2e-3)
    np.testing.assert_array_equal(tr[:, 12:], jr[:, 12:])
    assert tr[:, 12].sum() >= min_tracked
    np.testing.assert_array_equal(tt[:, 0], jt[:, 0])
    np.testing.assert_allclose(tt[:, 1:], jt[:, 1:], atol=2e-3)
    assert stderr_line(te, "# drop counters") == \
        stderr_line(je, "# drop counters")
    ate = [float(stderr_line(e, "# ATE RMSE").split()[3]) for e in (te, je)]
    assert abs(ate[0] - ate[1]) <= 2e-3, ate
    return tr, ate


def test_raw_orbit_matches_jax(tmp_path):
    """The orbit .raw, tracked from frame 4: the port's CLI follows
    JAX's, and both dump the same depth renders."""
    raw = str(tmp_path / "orbit.raw")
    synthetic2raw(raw, 8, scene="orbit")
    argv = ["-i", raw, "-g", raw + ".gt.txt"] + ORBIT_ARGS
    renders = {n: str(tmp_path / f"renders_{n}") for n in ("jax", "port")}
    compare(tmp_path, argv, 4,
            {n: ["--dump-renders", d] for n, d in renders.items()})
    files = sorted(os.listdir(renders["jax"]))
    assert files == sorted(os.listdir(renders["port"])) == ["frame00004.ppm"]
    a, b = (open(os.path.join(renders[n], files[0]), "rb").read()
            for n in ("jax", "port"))
    header = b"P6\n640 480\n255\n"
    assert a[:len(header)] == b[:len(header)] == header
    ia = np.frombuffer(a[len(header):], np.uint8).reshape(480, 640, 3)
    ib = np.frombuffer(b[len(header):], np.uint8).reshape(480, 640, 3)
    np.testing.assert_array_equal(ia[:240, 320:], ib[:240, 320:])
    assert (ia == ib).all(-1).mean() >= 0.99


def test_raw_loop_matches_jax(tmp_path):
    """Six frames of the closed loop: a whole circle, too fast to track,
    scored against its aligned ground truth by both CLIs alike."""
    raw = str(tmp_path / "loop.raw")
    synthetic2raw(raw, 6, scene="loop")
    compare(tmp_path, ["-i", raw, "-g", raw + ".gt.txt"] + LOOP_ARGS, 0)


def test_synthetic_matches_jax(tmp_path):
    compare(tmp_path, ["--synthetic", "6", "-v", "64"], 2)


@pytest.mark.parametrize("flag,item", [
    (["--serve", "8080"], "Queue 1 item 4b"),
    (["--plot-out", "p.png"], "Queue 1 item 4b"),
    (["--keyframe-rate", "2", "--synthetic", "6", "-v", "64"], None)])
def test_unported_options_exit_naming_their_item(flag, item, tmp_path):
    """The options whose modules are not ported exit naming their ROADMAP
    item; ``--keyframe-rate`` (item None), ported since, runs: the pose
    graph records keyframes."""
    argv = ["--synthetic", "2", "--platform", "cpu"] + flag
    if item is None:
        torch.set_num_threads(1)
        pipe = cli.run(argv + ["-o", str(tmp_path / "log")])
        assert pipe.keyframes is not None
        assert pipe.keyframes.frames == [4]
        return
    with pytest.raises(SystemExit, match=item):
        cli.main(argv)


def test_keyframe_rate_matches_jax(tmp_path):
    """Both CLIs with ``--keyframe-rate 2`` over the orbit that goes out
    and comes back (``tests/test_torch_pipeline.py``), where both close
    the loop at frame 10: the frame logs and the post-BA TUM trajectories
    agree to 2e-3 and the ATE lines to 1 mm."""
    from test_torch_pipeline import write_there_and_back
    raw = write_there_and_back(str(tmp_path / "orbit.raw"))
    argv = ["-i", raw, "-g", raw + ".gt.txt", "--keyframe-rate", "2"] \
        + ORBIT_ARGS
    _, ate = compare(tmp_path, argv, 7)
    assert abs(ate[0] - ate[1]) <= 1e-3, ate


def test_default_platform_is_the_card(tmp_path):
    """Without --platform the CLI runs on the card: on a host without one
    it raises rather than falling back to the CPU."""
    argv = ["--synthetic", "1", "-v", "32", "-o", str(tmp_path / "log")]
    if torch.cuda.is_available():
        assert cli.run(argv).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            cli.main(argv)


def test_module_entry_points(tmp_path):
    """``python -m`` runs the converter and the CLI."""
    env = dict(os.environ, PYTHONPATH=REPO)
    raw = str(tmp_path / "seq.raw")
    out = subprocess.run(
        [sys.executable, "-m", "supereight_tpu_torch.io.convert",
         "synthetic", raw, "--frames", "2"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "wrote 2 frames" in out.stderr
    out = subprocess.run(
        [sys.executable, "-m", "supereight_tpu_torch.cli", "-i", raw, "-g",
         raw + ".gt.txt", "--platform", "cpu"] + LOOP_ARGS, cwd=REPO,
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.splitlines()[0] == cli.LOG_HEADER
    assert len(out.stdout.splitlines()) == 3
    assert "# ATE RMSE" in out.stderr
