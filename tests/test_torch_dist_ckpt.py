"""Checkpoint and resume of the port's sharded step
(``parallel/dist_ckpt.py``), four Gloo ranks on the CPU through
``tools/dist_run.py``: a run saved after frame 2 and resumed in the same
process group gives frames 3-5 of the uninterrupted run bit for bit, for
both fields (every rank's mips are saved; JAX's orbax checkpoint keeps one
copy of them, so its own test, ``tests/test_dist.py:133``, is TSDF only).
A checkpoint of another world size or geometry is refused.
"""

import numpy as np
import pytest

from supereight_tpu_torch.core.map import MapGeometry
from supereight_tpu_torch.fields import TSDF
from supereight_tpu_torch.parallel import dist_ckpt, dist_step
from supereight_tpu_torch.parallel.distributed import Collectives
from supereight_tpu_torch.tools import dist_run

D = 4
SAVE_AT = 2


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ckpt"))
    cases = []
    for f in ("tsdf", "ofusion"):
        cases += [{"name": f + "_full", "field": f, "save_at": SAVE_AT,
                   "save_map": True},
                  {"name": f + "_resumed", "field": f,
                   "resume": f + "_full", "save_map": True}]
    return out, dist_run.launch(D, "gloo", "cpu", out, "test", cases)


@pytest.mark.parametrize("field", ["tsdf", "ofusion"])
def test_resume_equals_the_uninterrupted_run(runs, field):
    _, res = runs
    full, resumed = field + "_full", field + "_resumed"
    for r, rr in enumerate(res):
        np.testing.assert_array_equal(rr[resumed + ".frames"],
                                      np.arange(SAVE_AT + 1, 6))
        np.testing.assert_array_equal(rr[resumed + ".poses"],
                                      rr[full + ".poses"][SAVE_AT + 1:])
        for key in [k[len(full) + 1:] for k in rr
                    if k.startswith(full + ".aux.")
                    or k.startswith(full + ".map.")]:
            a, b = rr[f"{resumed}.{key}"], rr[f"{full}.{key}"]
            if key.startswith("aux."):
                b = b[SAVE_AT + 1:]
            np.testing.assert_array_equal(a, b, err_msg=f"rank {r} {key}")
        assert int(rr[full + ".map.n_blocks"]) > 0
        assert rr[resumed + ".aux.halo_blocks"][-1] > 0


def _stub(world, rank=0):
    c = Collectives.__new__(Collectives)
    c.group, c.world, c.rank = None, world, rank
    c.reset()
    return c


def test_another_world_or_geometry_is_refused(runs):
    out, _ = runs
    path = f"{out}/ckpt_tsdf_full"
    s = dist_run.SCENES["test"]
    geom = MapGeometry(size=s["size"], dim=s["dim"],
                       capacity=s["capacity"] // D)
    like = dist_step.init_dist_state(_stub(D), geom, TSDF,
                                     (s["width"], s["height"]), np.eye(4),
                                     "cpu")
    with pytest.raises(ValueError, match="world_size"):
        dist_ckpt.load_dist_checkpoint(path, _stub(2), like)
    other = MapGeometry(size=s["size"], dim=2 * s["dim"],
                        capacity=geom.capacity)
    with pytest.raises(ValueError, match="geometry"):
        dist_ckpt.load_dist_checkpoint(path, _stub(D), like, other, TSDF)
