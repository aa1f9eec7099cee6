"""Run the sharded frame step (``parallel/dist_step.py``) as D ranks.

    python -m supereight_tpu_torch.tools.dist_run --world 4 --backend gloo \\
        --device cuda|cpu [--scene test|SCENE.json] --field tsdf|ofusion \\
        [--halo exact|frustum] [--gt] [--frames N] [--halo-budget N] \\
        [--save-map] [--cases CASES.json] --out DIR

Spawns ``--world`` rank processes (``python -m`` this module with
``--rank``) that meet through a ``file://`` store in a temporary directory
(no port to collide with another run), runs a list of cases in that one
process group, so that process start-up is paid once, and writes each
rank's results to ``DIR/rank<r>.npz``. If any rank fails, the others are
killed and the run exits non-zero. A rank asked for ``cuda`` on a host
with no card raises; nothing falls back to the CPU. Ranks under Gloo on
``cuda`` share card 0 (NCCL refuses two ranks on one card), which proves
the sharded program on the card but measures no scaling.

A scene is the orbit every rank renders, with the map and tracking it is
run at: the keys of :data:`SCENES`' one built-in scene, ``test``, the JAX
package's sharded-step test (``tests/test_dist.py``: 64x48, 64^3 voxels
over 2 m, 1,024 blocks over the ranks (256 a rank at D = 4), ICP 3/2, 6
frames). ``--scene`` also takes a JSON file of such a dict, and
:func:`launch` the dict itself (``chip_smoke.py`` passes its bench scene).

A case (one entry of ``--cases``, a JSON list; the flags make one) has a
``name`` and any of: ``field``, ``frustum_halo`` (default true),
``use_gt_pose``, ``frames``, ``halo_budget``, ``save_map`` (the final
local map into the results), ``save_at`` (a checkpoint after that frame,
under ``DIR/ckpt_<name>``), ``resume`` (the name of an earlier case whose
checkpoint to load; the case then runs from the frame after its
``save_at``) and ``capture`` (a frame: rank 1, or rank 0 of a world of
one, writes to ``DIR/capture_<name>.pt`` a copy of the arguments of every
kernel wrapper and op the step calls at that frame (:data:`CAPTURED`), for
their check against their twins).

Per case and rank the results hold the poses, every aux counter a frame,
the launch counts, each frame's milliseconds (CUDA events on a card, the
host clock on the CPU), the host seconds blocked in collectives a frame
and the collectives' calls and bytes by kind.
"""
import argparse
import contextlib
import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SCENES = {
    "test": dict(width=64, height=48, k=(48.0, 48.0, 32.0, 24.0),
                 size=64, dim=2.0, capacity=4 * 256, iterations=(3, 2),
                 frames=6, radius=0.8, center=1.0, sphere_radius=0.3,
                 angle_span=0.3, room=(0.15, 1.85)),
}
MU = {"tsdf": 0.1, "ofusion": 0.008}
ICP_THRESHOLD = 1e-5
TIMEOUT_S = 1200
# the calls a capture frame records, by the module the sharded step reaches
# each through and their names there; nav_grid's result is kept too
CAPTURED = (("supereight_tpu_torch.parallel.dist_step",
             ("touched_mask", "touched_masks_of", "alloc_assign",
              "halo_pack", "nav_grid", "raycast_rays")),
            ("supereight_tpu_torch.ops.tracking", ("track",)),
            ("supereight_tpu_torch.ops.integration", ("integrate",)))
KEEP_RESULT = ("nav_grid",)


def load_scene(scene):
    """A scene's dict from its name in :data:`SCENES`, a JSON file's path
    or the dict itself."""
    if isinstance(scene, dict):
        return scene
    if scene in SCENES:
        return SCENES[scene]
    with open(scene) as f:
        return json.load(f)


def scene_frames(scene):
    """(depths [N, H, W], poses [N, 4, 4]) of a scene's orbit (a name, a
    path or a dict, :func:`load_scene`), all its frames (a case that runs
    fewer takes the first ones)."""
    from supereight_tpu_torch.io import synthetic
    s = load_scene(scene)
    return synthetic.orbit_sequence(
        s["frames"], s["k"], width=s["width"], height=s["height"],
        radius=s["radius"], center=(s["center"],) * 3,
        sphere_radius=s["sphere_radius"], angle_span=s["angle_span"],
        room=((s["room"][0],) * 3, (s["room"][1],) * 3))


def capture_rank(world):
    return 1 if world > 1 else 0


def _copy(v):
    """A copy of a call's argument: tensors cloned, through tuples, named
    tuples, lists and dicts; anything else as it is."""
    import torch
    if isinstance(v, torch.Tensor):
        return v.clone()
    if isinstance(v, tuple) and hasattr(v, "_fields"):
        return type(v)(*map(_copy, v))
    if isinstance(v, (tuple, list)):
        return type(v)(map(_copy, v))
    if isinstance(v, dict):
        return {k: _copy(x) for k, x in v.items()}
    return v


@contextlib.contextmanager
def capturing(calls):
    """Within: each call of :data:`CAPTURED` puts a copy of its arguments,
    taken before the call (the step updates the map in place), into
    ``calls[name]`` as ``{"args", "kwargs", "result"}``. A ``group``
    argument (the process group) is left out."""
    saved = []
    for module, names in CAPTURED:
        mod = importlib.import_module(module)
        for name in names:
            fn = getattr(mod, name)

            def wrapped(*args, _fn=fn, _name=name, **kwargs):
                entry = {"args": _copy(args), "result": None,
                         "kwargs": {k: _copy(v) for k, v in kwargs.items()
                                    if k != "group"}}
                out = _fn(*args, **kwargs)
                if _name in KEEP_RESULT:
                    entry["result"] = _copy(out)
                calls[_name] = entry
                return out
            saved.append((mod, name, fn))
            setattr(mod, name, wrapped)
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _np(t):
    return t.detach().cpu().numpy()


def run_case(case, args, comm, dev, out, ckpts, frames):
    """One case on this rank over the scene's ``frames`` (depths,
    poses); returns its result arrays."""
    import numpy as np
    import torch

    from supereight_tpu_torch.core.map import MapGeometry
    from supereight_tpu_torch.fields import get_field
    from supereight_tpu_torch.kernels import _lib
    from supereight_tpu_torch.parallel import dist_ckpt, dist_step

    s = load_scene(args.scene)
    name = case["name"]
    field = get_field(case.get("field", "tsdf"))
    n_frames = case.get("frames", s["frames"])
    depths, poses = frames
    geom = MapGeometry(size=s["size"], dim=s["dim"],
                       capacity=s["capacity"] // comm.world)
    frame_size = (s["width"], s["height"])
    use_gt = case.get("use_gt_pose", False)
    step = dist_step.make_dist_step(
        comm, geom, field, frame_size=frame_size,
        iterations=tuple(s["iterations"]), mu=MU[field.name],
        icp_threshold=ICP_THRESHOLD, use_gt_pose=use_gt,
        halo_budget=case.get("halo_budget"),
        frustum_halo=case.get("frustum_halo", True))
    k = torch.tensor(s["k"], dtype=torch.float32).to(dev)
    depths_t = [torch.from_numpy(d).to(dev) for d in depths]
    gts = [torch.from_numpy(p.astype(np.float32)).to(dev) for p in poses]
    state = dist_step.init_dist_state(comm, geom, field, frame_size,
                                      poses[0], dev)
    first = 0
    if case.get("resume"):
        src = ckpts[case["resume"]]
        state = dist_ckpt.load_dist_checkpoint(src["path"], comm, state,
                                               geom, field)
        first = src["save_at"] + 1
    cuda = dev.type == "cuda"
    marks = []
    traj, auxes, comm_s = [], [], []
    comm.reset()
    _lib.reset_launches()
    if cuda:
        torch.cuda.synchronize(dev)
    for i in range(first, n_frames):
        calls = {} if i == case.get("capture") and comm.rank == \
            capture_rank(comm.world) else None
        if cuda:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        else:
            marks.append(time.perf_counter())
        c0 = comm.seconds
        with capturing(calls) if calls is not None \
                else contextlib.nullcontext():
            state, aux = step(state, depths_t[i], k, i, gts[i] if use_gt
                              else None)
        comm_s.append(comm.seconds - c0)
        traj.append(state.pose.clone())
        auxes.append(aux)
        if calls is not None:
            torch.save(dict(calls=calls, frame=i, field=field.name,
                            world=comm.world, rank=comm.rank),
                       os.path.join(out, f"capture_{name}.pt"))
        if i == case.get("save_at"):
            path = os.path.join(out, f"ckpt_{name}")
            dist_ckpt.save_dist_checkpoint(path, state, comm, geom, field)
            ckpts[name] = {"path": path, "save_at": i}
    if cuda:
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        torch.cuda.synchronize(dev)
        ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        marks.append(time.perf_counter())
        ms = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    res = {"poses": np.stack([_np(p) for p in traj]),
           "frames": np.arange(first, n_frames),
           "ms": np.asarray(ms), "comm_s": np.asarray(comm_s),
           "launches": np.asarray(json.dumps(dict(_lib.LAUNCHES))),
           "comm_calls": np.asarray(json.dumps(dict(comm.calls))),
           "comm_bytes": np.asarray(json.dumps(dict(comm.bytes))),
           "halo_budget": np.asarray(step.halo_budget)}
    for key in auxes[0]:
        res["aux." + key] = np.stack([_np(a[key]) for a in auxes])
    if case.get("save_map"):
        for key, v in state.map._asdict().items():
            if isinstance(v, tuple):
                for lvl, t in enumerate(v):
                    res[f"map.{key}.{lvl}"] = _np(t)
            else:
                res["map." + key] = _np(v)
    return {f"{name}.{k}": v for k, v in res.items()}


def rank_main(args):
    """One rank: join the group, run every case, write the results."""
    import numpy as np
    import torch

    from supereight_tpu_torch.parallel import distributed

    if args.device == "cpu":
        torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = distributed.initialize(
        args.backend, args.device,
        init_method="file://" + os.path.join(args.store, "rendezvous"),
        world_size=args.world, rank=args.rank)
    comm = distributed.Collectives()
    results, ckpts = {}, {}
    frames = scene_frames(args.scene)
    for case in load_cases(args):
        results.update(run_case(case, args, comm, dev, args.out, ckpts,
                                frames))
    np.savez(os.path.join(args.out, f"rank{args.rank}.npz"), **results)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def load_cases(args):
    if args.cases:
        with open(args.cases) as f:
            return json.load(f)
    case = {"name": args.field, "field": args.field,
            "frustum_halo": args.halo == "frustum", "use_gt_pose": args.gt,
            "save_map": args.save_map}
    if args.frames is not None:
        case["frames"] = args.frames
    if args.halo_budget is not None:
        case["halo_budget"] = args.halo_budget
    return [case]


def launch(world, backend, device, out, scene="test", cases=None,
           timeout=TIMEOUT_S, extra=()):
    """Run ``world`` ranks of this module over ``cases`` (a list of case
    dicts) on ``scene`` (a name, a JSON file or a dict, :func:`load_scene`)
    into ``out``; returns each rank's results (dicts of arrays).
    Raises if any rank fails, after killing the others."""
    import numpy as np
    os.makedirs(out, exist_ok=True)
    store = tempfile.mkdtemp(prefix="dist_run_")
    if isinstance(scene, dict):
        path = os.path.join(store, "scene.json")
        with open(path, "w") as f:
            json.dump(scene, f)
        scene = path
    argv = ["--world", str(world), "--backend", backend, "--device", device,
            "--scene", scene, "--out", out, "--store", store, *extra]
    if cases is not None:
        path = os.path.join(store, "cases.json")
        with open(path, "w") as f:
            json.dump(cases, f)
        argv += ["--cases", path]
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "supereight_tpu_torch.tools.dist_run",
         *argv, "--rank", str(r)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = [tempfile.TemporaryFile("w+") for _ in procs]
    readers = [_drain(p, log) for p, log in zip(procs, logs)]
    failed = None
    t0 = time.monotonic()
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
                break
            if time.monotonic() - t0 > timeout:
                failed = f"timed out after {timeout} s"
                break
            time.sleep(0.05)
        else:
            bad = [r for r, p in enumerate(procs) if p.returncode != 0]
            if bad:
                failed = f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for t in readers:
            t.join()
        shutil.rmtree(store, ignore_errors=True)
    if failed:
        text = []
        for r, log in enumerate(logs):
            log.seek(0)
            text.append(f"--- rank {r} ---\n" + log.read()[-4000:])
        raise RuntimeError(f"dist_run: {failed}\n" + "\n".join(text))
    return [dict(np.load(os.path.join(out, f"rank{r}.npz")))
            for r in range(world)]


def _drain(proc, log):
    """A thread copying a rank's output into ``log`` (a full pipe would
    stall the rank)."""
    import threading

    def copy():
        for line in proc.stdout:
            log.write(line)
    t = threading.Thread(target=copy, daemon=True)
    t.start()
    return t


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--backend", choices=("gloo", "nccl"), required=True)
    ap.add_argument("--device", required=True)
    ap.add_argument("--scene", default="test",
                    help="a built-in scene (test) or a JSON file of one")
    ap.add_argument("--field", choices=sorted(MU), default="tsdf")
    ap.add_argument("--halo", choices=("exact", "frustum"),
                    default="frustum")
    ap.add_argument("--gt", action="store_true",
                    help="ground-truth poses instead of tracking")
    ap.add_argument("--frames", type=int)
    ap.add_argument("--halo-budget", type=int)
    ap.add_argument("--save-map", action="store_true",
                    help="the final local map into the results")
    ap.add_argument("--cases", help="a JSON list of cases")
    ap.add_argument("--out", required=True)
    ap.add_argument("--timeout", type=float, default=TIMEOUT_S)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--store", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        rank_main(args)
        return 0
    extra = ["--field", args.field, "--halo", args.halo]
    for flag in ("gt", "save_map"):
        if getattr(args, flag):
            extra.append("--" + flag.replace("_", "-"))
    if args.frames is not None:
        extra += ["--frames", str(args.frames)]
    if args.halo_budget is not None:
        extra += ["--halo-budget", str(args.halo_budget)]
    cases = None
    if args.cases:
        with open(args.cases) as f:
            cases = json.load(f)
    results = launch(args.world, args.backend, args.device, args.out,
                     args.scene, cases, args.timeout, extra)
    for r, res in enumerate(results):
        for key in sorted(k for k in res if k.endswith(".aux.n_blocks_dev")):
            print(f"rank {r} {key[:-len('.aux.n_blocks_dev')]}: blocks "
                  f"{res[key][-1].tolist()}, final pose "
                  f"{res[key.replace('aux.n_blocks_dev', 'poses')][-1][:3, 3]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
