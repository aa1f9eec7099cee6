"""The port runs without JAX, and its GPU smoke refuses to run without a GPU.

The port's host (a machine with an NVIDIA GPU) has no JAX: in a
subprocess where importing ``jax``, ``jaxlib`` or ``supereight_tpu``
raises, ``supereight_tpu_torch`` must import every module (the class
pipeline, the CLI, IO, evaluation and the tools among them) and run
``frame_step`` for both fields, the headline bench's frame callable
(``tools/bench.py``) for 2 frames, the gather-form probe, and the CLI from a
``.raw`` file made by its converter, with a fresh-view render, a
checkpoint round trip, the mesh export and the library surface's
queries, a synthetic CLI run with ``--keyframe-rate`` (the pose
graph), the host-side modules (the native library built from
``native/src``, the ``.scf`` reader, the debug dumps, telemetry, the
plots and the live viewer, the CLI's ``--serve`` and ``--plot-out``
among them), and the sharded step (``parallel/dist_step.py``) for 4 frames in
a world of one Gloo rank, in that process, on the CPU (ranks it spawned
would not inherit the import blocker).
"""

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NO_JAX = r'''
import importlib.abc, json, sys

BLOCKED = ("jax", "jaxlib", "supereight_tpu")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import importlib, pkgutil
import numpy as np
import torch
torch.set_num_threads(1)
import supereight_tpu_torch
for m in pkgutil.walk_packages(supereight_tpu_torch.__path__,
                               "supereight_tpu_torch."):
    importlib.import_module(m.name)
from supereight_tpu_torch.core.map import MapGeometry
from supereight_tpu_torch.fields import OFUSION, TSDF
from supereight_tpu_torch.io import synthetic
from supereight_tpu_torch.parallel import step
from supereight_tpu_torch.tools import probe_gather

K = (48.0, 48.0, 32.0, 24.0)
depths, poses = synthetic.orbit_sequence(
    5, K, width=64, height=48, radius=0.8, center=(1.0,) * 3,
    sphere_radius=0.3, angle_span=0.3, room=((0.15,) * 3, (1.85,) * 3))
geom = MapGeometry(size=32, dim=2.0, capacity=256)
out = {}
for field, mu in ((TSDF, 0.1), (OFUSION, 0.008)):
    state = step.init_frame_state(geom, field, (64, 48), poses[0], "cpu")
    for i in range(5):
        state, aux = step.frame_step(
            geom, field, state, torch.from_numpy(depths[i]),
            torch.tensor(K), i, frame_size=(64, 48), iterations=(3, 2),
            mu=mu, icp_threshold=1e-5, neg_y=False, filter_input=False,
            integration_rate=1, budget=256)
    out[field.name] = {"n_blocks": int(aux["n_blocks"]),
                       "finite": bool(torch.isfinite(state.pose).all()),
                       "keys": sorted(aux)}
out["probe"] = all(ok for _, ok, _ in probe_gather.run(torch.device("cpu")))

# the headline bench's frame callable, 2 frames at a test size
from supereight_tpu_torch.tools import bench
b = bench.config("ofusion", "cpu", size=32, dim=3.0, capacity=256,
                 frame_size=(64, 48), n_frames=2)
bstate = b.init()
for i in range(2):
    bstate, baux = b.frame(bstate, i)
out["bench"] = {"n_blocks": int(bstate.map.n_blocks),
                "finite": bool(torch.isfinite(bstate.pose).all()),
                "drops": sum(int(baux[c]) for c in bench.DROPS),
                "modules": sorted(m for m in sys.modules if m in (
                    "supereight_tpu_torch.tools.bench",
                    "supereight_tpu_torch.utils.deviceprof"))}

import os, tempfile
from supereight_tpu_torch import cli
from supereight_tpu_torch.io.convert import synthetic2raw
tmp = tempfile.mkdtemp()
raw = os.path.join(tmp, "seq.raw")
synthetic2raw(raw, 5, scene="orbit")
import socket
with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
pipe = cli.run(["-i", raw, "-g", raw + ".gt.txt", "-c", "8", "-v", "32",
                "-s", "4.8", "-r", "1", "--platform", "cpu", "-o",
                os.path.join(tmp, "log"), "--dump-renders", tmp,
                "--serve", str(port), "--plot-out",
                os.path.join(tmp, "plot.png")])
view = pipe.get_pose()
view[:3, 3] -= 0.5 * view[:3, 2]
lit = int((pipe.render_volume(view)[..., :3] > 0).any(-1).sum())
pipe.save_checkpoint(os.path.join(tmp, "ckpt.npz"))
pipe.load_checkpoint(os.path.join(tmp, "ckpt.npz"))
tris = pipe.dump_mesh(os.path.join(tmp, "mesh.obj"))
from supereight_tpu_torch.core import geometry, volume
vol = volume.Volume(pipe.geom, pipe.map, pipe.field)
pts = pipe.get_pose()[:3, 3] + np.zeros((4, 3), np.float32)
out["cli"] = {"blocks": pipe.block_count(), "lit": lit,
              "renders": sorted(f for f in os.listdir(tmp)
                                if f.endswith(".ppm")),
              "keyframes": cli.run([
                  "--synthetic", "6", "-v", "64", "--keyframe-rate", "2",
                  "--platform", "cpu", "-o", os.path.join(tmp, "kf.log")
              ]).keyframes.frames, "triangles": len(tris),
              "interp": bool(torch.isfinite(vol.interp(pts)).all()),
              "collision": int(geometry.collides_with(
                  pipe.geom, pipe.map, pipe.field, (0, 0, 0), (4, 4, 4)))}

# the host-side modules
import urllib.request
from supereight_tpu_torch import plots, webviewer
from supereight_tpu_torch.io import debug_io, meshing, native, scf
from supereight_tpu_torch.utils.telemetry import DeviceMonitor
reader = native.NativeRawReader(raw)
frames = [reader.read_frame(i)[0] for i in range(reader.num_frames)]
with open(os.path.join(tmp, "run.scf"), "w") as f:
    f.write("volume_resolution = 64\npyramid = 3,2\n")
cfg = scf.parse_scf(os.path.join(tmp, "run.scf"))
debug_io.save_3d_slice(os.path.join(tmp, "slice.vtk"), pipe.geom, pipe.map,
                       pipe.field, (0, 0, 0), (8, 8, 8))
debug_io.save_block_list(os.path.join(tmp, "blocks.txt"), pipe.geom,
                         pipe.map)
debug_io.save_point_cloud(os.path.join(tmp, "pc.vtk"), np.zeros((3, 3)))
debug_io.print_normals(os.path.join(tmp, "n.ppm"), pipe.normal)
plots.plot_log_file(os.path.join(tmp, "log"), os.path.join(tmp, "p2.png"))
live = webviewer.LiveViewer(0)
live.start()
live.push(np.zeros((4, 4, 4), np.uint8), {"frame": 1})
served = json.loads(urllib.request.urlopen(
    f"http://127.0.0.1:{live.port}/stats", timeout=10).read())
live.stop()
out["host"] = {"native": native.available(), "frames": len(frames),
               "writes": meshing.WRITES,
               "scf": [cfg.volume_resolution, list(cfg.pyramid)],
               "blocks_listed": len(open(os.path.join(
                   tmp, "blocks.txt")).read().splitlines()) - 1,
               "telemetry": dict(DeviceMonitor().sample().series),
               "plots": [os.path.getsize(os.path.join(tmp, n)) > 0
                         for n in ("plot.png", "p2.png")],
               "served": served}

# the sharded step in a world of one Gloo rank, in this process
from supereight_tpu_torch.parallel import dist_step, distributed
distributed.initialize("gloo", "cpu",
                       init_method="file://" + os.path.join(tmp, "store"),
                       world_size=1, rank=0)
dstep = dist_step.make_dist_step(None, geom, TSDF, frame_size=(64, 48),
                                 iterations=(3, 2), mu=0.1,
                                 icp_threshold=1e-5)
ds = dist_step.init_dist_state(None, geom, TSDF, (64, 48), poses[0], "cpu")
for i in range(4):
    ds, daux = dstep(ds, torch.from_numpy(depths[i]), torch.tensor(K), i)
out["dist"] = {"blocks": daux["n_blocks_dev"].tolist(),
               "halo": int(daux["halo_blocks"]),
               "finite": bool(torch.isfinite(ds.pose).all()),
               "keys": sorted(daux), "primary": distributed.is_primary(),
               "scaling": distributed.scaling_report(2.0, 4)}
torch.distributed.destroy_process_group()
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print(json.dumps(out))
'''


def _env():
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("PYTHONSTARTUP", None)
    return env


def test_port_runs_without_jax():
    out = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    out = json.loads(out.stdout.strip().splitlines()[-1])
    assert out.pop("probe")
    res = out.pop("bench")
    assert res["finite"] and res["n_blocks"] > 0 and res["drops"] == 0
    assert res["modules"] == ["supereight_tpu_torch.tools.bench",
                              "supereight_tpu_torch.utils.deviceprof"]
    dist = out.pop("dist")
    assert dist["finite"] and dist["blocks"][0] > 0
    assert 0 < dist["halo"] <= dist["blocks"][0]
    assert dist["primary"]
    assert dist["scaling"] == {"fps": 2.0, "ranks": 1, "fps_per_rank": 2.0}
    assert dist["keys"] == sorted(
        ["tracked", "integrated", "reduction", "n_blocks_dev",
         "alloc_overflow", "blocks_truncated", "ray_overflow",
         "halo_overflow", "halo_blocks"])
    host = out.pop("host")
    assert host["native"] and host["frames"] == 5
    assert host["writes"] == {"native": 1, "python": 0}
    assert host["scf"] == [64, [3, 2]]
    assert host["blocks_listed"] == out["cli"]["blocks"]
    assert host["telemetry"] == {}
    assert host["plots"] == [True, True]
    assert host["served"] == {"frame": 1.0}
    res = out.pop("cli")
    assert res["blocks"] > 0 and res["lit"] > 0
    assert res["renders"] == ["frame00004.ppm"]
    assert res["keyframes"] == [4] and res["triangles"] > 0
    assert res["interp"] and res["collision"] in (0, 1, 2)
    assert sorted(out) == ["ofusion", "tsdf"]
    for res in out.values():
        assert res["finite"] and res["n_blocks"] > 0
        assert res["keys"] == sorted(
            ["tracked", "integrated", "reduction", "track_result",
             "n_blocks", "alloc_overflow", "blocks_truncated",
             "patch_skipped", "mip_skipped", "ray_overflow",
             "pool_bucket_overflow"])


def _smoke(cwd):
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_gpu():
    out = _smoke(REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo
    (and no GPU here) it fails without a result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = _env()
    env.pop("PYTHONPATH")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
