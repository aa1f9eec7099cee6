"""The gather-form probe (K8), the counterpart of the Pallas kernels of
``tools/probe_pallas_gather.py``.

The probe runs at import on a TPU (``pltpu`` memory spaces), so its numpy
expressions are its plain reference: each form's twin, and its wrapper
(which takes the twin for CPU tensors), must equal them bit for bit on
the probe's own inputs (``probe_inputs``: one generator seeded 0, forms
A-D in the probe's order and shapes), and at any width and at the brick
pool's shapes (``pool_inputs``, cut by its ``scale``). The entry point
and its timing mode run on a CUDA device only; the timing's cases,
bounds and lines are checked here with a stand-in timer.
"""

import contextlib

import numpy as np
import pytest
import torch

from supereight_tpu_torch.kernels import _lib
from supereight_tpu_torch.kernels import gather_probe as gp
from supereight_tpu_torch.tools import probe_gather

SHAPES = [((512, 128), (256,), (256, 128)),
          ((512, 128), (256, 128), (256, 128)),
          ((256, 512), (256, 128), (256, 128)),
          ((512, 128), (64,), (64, 128))]


def test_probe_inputs_have_the_probe_shapes():
    inputs = gp.probe_inputs()
    for (t, i), (ts, is_, _) in zip(inputs, SHAPES):
        assert t.shape == ts and t.dtype == np.float32
        assert i.shape == is_ and i.dtype == np.int32
        assert 0 <= i.min() and i.max() < 512
    # the probe's first draw: normal(size=(512, 128)) of default_rng(0)
    first = np.random.default_rng(0).normal(size=(512, 128))
    np.testing.assert_array_equal(inputs[0][0], first.astype(np.float32))


@pytest.mark.parametrize("form", range(4), ids="ABCD")
def test_form_matches_numpy(form):
    name, kernel, plain, expect = gp.FORMS[form]
    t, i = gp.probe_inputs()[form]
    want = expect(t, i)
    assert want.shape == SHAPES[form][2]
    tt, it = torch.from_numpy(t), torch.from_numpy(i)
    before = dict(_lib.LAUNCHES)
    np.testing.assert_array_equal(plain(tt, it).numpy(), want)
    np.testing.assert_array_equal(kernel(tt, it).numpy(), want)
    assert _lib.LAUNCHES == before   # the CPU takes the twin


def test_run_reports_the_probe_lines():
    assert probe_gather.run(torch.device("cpu")) == [
        (f[0], True, "OK match=True") for f in gp.FORMS]


def test_entry_point_needs_a_cuda_device(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert probe_gather.main() == 2
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def test_wrappers_check_arguments():
    t = torch.zeros((4, 3))
    with pytest.raises(TypeError):
        gp.take_rows(t, torch.zeros(2))             # float indices
    with pytest.raises(ValueError, match="2-D"):
        gp.take_rows(torch.zeros(4), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="unsupported device"):
        gp.take_along_cols(t.to("meta"),
                           torch.zeros((4, 2), dtype=torch.int32,
                                       device="meta"))


POOL_SCALE = 64   # pool_inputs' rows cut 64-fold: a 576-brick pool


def test_pool_inputs_have_the_pool_shapes():
    torch.set_num_threads(1)
    got = gp.pool_inputs(seed=3, scale=POOL_SCALE)
    again = gp.pool_inputs(seed=3, scale=POOL_SCALE)
    rows, n = 36864 // POOL_SCALE, 8192 // POOL_SCALE
    want = [((rows, 512), (n,), rows), ((rows, 512), (n, 512), rows),
            ((n, 512), (n, 512), 512), ((rows, 512), (n,), rows)]
    for (t, i), (t2, i2), (ts, is_, hi) in zip(got, again, want):
        assert t.shape == ts and t.dtype == np.float32
        assert i.shape == is_ and i.dtype == np.int32
        assert 0 <= i.min() and i.max() < hi
        np.testing.assert_array_equal(t, t2)
        np.testing.assert_array_equal(i, i2)
    assert len(np.unique(got[0][1])) == n          # distinct bricks
    assert got[0][0] is got[1][0] is got[3][0]     # one pool
    assert got[0][1] is got[3][1]
    other = gp.pool_inputs(seed=4, scale=POOL_SCALE)
    assert not np.array_equal(other[1][1], got[1][1])


def test_moved_bytes_counts_distinct_reads():
    t = torch.zeros((6, 4))
    rows = torch.tensor([5, 1, 5], dtype=torch.int32)
    # two distinct rows of 4 read, 3 indices, 3 rows of 4 written
    assert gp.moved_bytes("gather_a", t, rows) == 4 * (8 + 3 + 12)
    assert gp.moved_bytes("gather_d", t, rows) == 4 * (8 + 3 + 12)
    along = torch.tensor([[0, 0, 2, 2], [0, 1, 2, 3]], dtype=torch.int32)
    # (0, 0) twice and (2, 2) twice: 6 distinct elements
    assert gp.moved_bytes("gather_b", t, along) == 4 * (6 + 8 + 8)
    within = torch.tensor([[1, 1, 3]] * 6, dtype=torch.int32)
    assert gp.moved_bytes("gather_c", t, within) == 4 * (12 + 18 + 18)
    # C's sector floor: rows 0-1, 2-3 and 4-5 each touch one sector
    assert gp.sector_bytes(t, within) == 32 * 3 + 8 * 18


def _inputs(form, width, n, seed=0, j=None):
    """Form ``form``'s numpy (table, idx) at row width ``width`` and
    ``n`` output rows: a 96-row table (C: n rows, and ``j`` indices a row,
    default ``width``), in-range indices."""
    rng = np.random.default_rng(seed)
    rows = n if form == 2 else 96
    t = rng.standard_normal((rows, width), dtype=np.float32)
    hi = width if form == 2 else rows
    shape = (n,) if form in (0, 3) else (n, width if j is None else j)
    return t, rng.integers(0, hi, shape, dtype=np.int32)


WIDTHS = [(w, 37) for w in (1, 3, 4, 5, 128, 130)] + [(128, 1)]
# form C's (table width, indices a row, rows), as the card test's C-only
# cases: indices below and above the width and not a multiple of 4, a row
# wider than the kernel stages in shared memory, one row, and a width
# that is not a multiple of 4 under indices that are
C_WIDTHS = [(512, 7, 40), (512, 1030, 40), (16387, 64, 3), (512, 512, 1),
            (130, 64, 40)]
ANY_WIDTH = [(f, w, w, n) for f in range(4) for w, n in WIDTHS] + [
    (2, w, j, n) for w, j, n in C_WIDTHS]


@pytest.mark.parametrize(
    "form,width,j,n", ANY_WIDTH, ids=[
        f"{'ABCD'[f]}-w{w}-" + (f"j{j}-" if j != w else "") + f"n{n}"
        for f, w, j, n in ANY_WIDTH])
def test_form_matches_numpy_at_any_width(form, width, j, n):
    """Every wrapper on the CPU (its twin) equals the form's numpy
    expression bit for bit at widths that take a kernel's vector path
    (4, 128), its scalar path (1, 3, 5, 130) and one output row; form C
    also at :data:`C_WIDTHS`."""
    torch.set_num_threads(1)
    _, kernel, plain, expect = gp.FORMS[form]
    t, i = _inputs(form, width, n, seed=form, j=j)
    want = expect(t, i)
    tt, it = torch.from_numpy(t), torch.from_numpy(i)
    np.testing.assert_array_equal(kernel(tt, it).numpy(), want)
    np.testing.assert_array_equal(plain(tt, it).numpy(), want)


def test_time_mode_cases_and_lines():
    """``probe_gather``'s timing: the four forms and D on A's inputs at the
    probe's shapes; the four forms and A, C and D cold at the pool's, a
    cold case's calls taking its disjoint brick sets (A, D) or its
    disjoint views of one table and one index (C) in turn; each case's
    bytes bound (C's also its sector floor), its kernel equal to its twin,
    and one printed line."""
    torch.set_num_threads(1)
    seen = []

    def timer(fn, kernel, per_call=1):
        for _ in range(4):
            fn()
        seen.append((kernel, per_call))
        return 2.0, 1.0, 3.0
    shapes = {"probe": gp.probe_inputs(),
              "pool": gp.pool_inputs(scale=POOL_SCALE)}
    res, ok = probe_gather.time_all(torch.device("cpu"), shapes=shapes,
                                    timer=timer)
    assert ok
    assert list(res["probe"]) == list(gp.KEYS) + ["gather_d_on_a"]
    assert list(res["pool"]) == list(gp.KEYS) + [
        "gather_a_cold", "gather_c_cold", "gather_d_cold"]
    a = res["probe"]["gather_a"]
    assert a["bytes"] == gp.moved_bytes(
        "gather_a", *map(torch.from_numpy, gp.probe_inputs()[0]))
    assert a["bound_us"] == pytest.approx(a["bytes"] / 3.35e6)
    assert res["probe"]["gather_d_on_a"]["builds"]["change"][0]["sha256"] \
        == a["builds"]["change"][0]["sha256"]
    cold = res["pool"]["gather_a_cold"]
    assert cold["sets"] == probe_gather.COLD_SETS
    sets = probe_gather.cold_bricks(36864 // POOL_SCALE,
                                    8192 // POOL_SCALE)
    assert len(np.unique(sets)) == sets.size
    c = res["pool"]["gather_c_cold"]
    assert c["sets"] == probe_gather.COLD_SETS
    assert c["table"] == c["idx"] == [8192 // POOL_SCALE, 512]
    assert c["bound_us"] < c["sector_us"]
    pairs = probe_gather.cold_tables(torch.device("cpu"), 8192 // POOL_SCALE)
    assert len(pairs) == probe_gather.COLD_SETS
    for k in (0, 1):   # views of one table and one index, disjoint rows
        base = pairs[0][k]._base
        spans = sorted((p[k].data_ptr(), p[k].data_ptr() + p[k].nbytes)
                       for p in pairs)
        assert all(p[k]._base is base for p in pairs)
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert all(0 <= int(i.min()) and int(i.max()) < 512 for _, i in pairs)
    assert seen[:3] == [("", None), ("", None), ("gather_a_kernel", 1)]
    for shape, rows in res.items():
        for case, r in rows.items():
            line = probe_gather.summary(shape, case, r, 1.0)
            assert line.startswith(f"{shape} {case}: ") and "\n" not in line


def test_time_mode_turns_parent_and_side_builds(monkeypatch):
    """With a parent library each case's kernel is timed parent, this,
    this, parent; a side build only on the kernel its name starts with,
    and one that does not fit the sources not at all."""
    from supereight_tpu_torch.tools import sharded_kernels as sk
    used = []
    monkeypatch.setattr(sk, "using", lambda lib: (
        used.append(lib), contextlib.nullcontext())[-1])
    parent, side = object(), object()
    assert probe_gather.builds_for("gather_b", parent, {
        "gather_b_x": side, "gather_a_y": side, "gather_b_z": None}) == [
        ("parent", parent), ("change", None), ("change", None),
        ("parent", parent), ("gather_b_x", side)]
    t, i = map(torch.from_numpy, gp.probe_inputs()[1])
    r = probe_gather.time_case(
        "gather_b", gp.take_along_rows, gp.take_along_rows_plain, t, i,
        probe_gather.builds_for("gather_b", parent, {}),
        lambda fn, kernel, per_call=1: (fn(), (1.0, 1.0, 1.0))[-1])
    assert [len(r["builds"][k]) for k in ("parent", "change")] == [2, 2]
    assert used == [parent, parent]
