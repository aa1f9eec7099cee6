"""The gather-form probe on the card: forms A-D of
``tools/probe_pallas_gather.py`` through the K8 kernels, and their times.

    python -m supereight_tpu_torch.tools.probe_gather
    python -m supereight_tpu_torch.tools.probe_gather --time [--split]
        [--parent CHECKOUT]

Without ``--time``: draws the probe's inputs
(``kernels/gather_probe.probe_inputs``), runs each form's kernel on the
first CUDA device and prints one line per form, ``<name>: OK
match=True`` when the result equals the probe's numpy expectation bit
for bit (``match=False`` otherwise, or ``FAIL`` with the error). Exits 1
unless every form matches, and 2 without a CUDA device.

``--time``: each form at the probe's shapes (``probe_inputs``) and at
the brick pool's (``pool_inputs``: the bench config's 36,864 bricks of
512 voxels and its budget of 8,192 blocks), and ``gather_d``'s kernel
on form A's probe inputs (``gather_d_on_a``; at the pool's shapes D's
inputs are A's). Back to back, a pool launch of A or D finds the rows it
reads in L2 (16.8 MB of the 50 MB), and one of C its whole 33.6 MB of
table and index; the cold cases ``gather_a_cold`` and ``gather_d_cold``
take COLD_SETS disjoint brick sets in turn (:func:`cold_bricks`), and
``gather_c_cold`` COLD_SETS disjoint (table, index) pairs
(:func:`cold_tables`), so their reads come from device memory. For
each: the device
microseconds of the kernel, its twin and the one PyTorch call of the
same function (``index_select`` or ``gather``, the index as int64 made
before the timing), each the median of 20 calls with the fastest and
slowest (``tools/sharded_kernels.kernel_us``; a call of several launches
is their sum); the launch floor (a one-element ``zero_()``); the bytes
bound (``gather_probe.moved_bytes``: the distinct table elements read,
the index and the output, over 3.35 TB/s) and the kernel's share of it
(for C also the sector floor, ``gather_probe.sector_bytes``: the
32-byte sectors of the table that its indices touch, the index and the
output);
whether the kernel equals its twin bit for bit; and the first 16 hex
digits of the SHA-256 of its output (``tools/noise_kernels.digest``).
``--split`` adds the side builds of ``tools/sharded_kernels.SIDE`` whose
names start with ``gather``, each timed on the kernel its name starts
with (``gather_b_...`` on ``gather_b``). ``--parent CHECKOUT`` adds
CHECKOUT's ``supereight_tpu_torch/csrc/gather_probe.cu`` (for example
the parent commit unpacked by ``git archive``), built with this
checkout's headers and flags as a library of its own and timed in turns,
parent, this, this, parent, on the same inputs; its outputs' digests are
printed beside these, and the run fails where they differ. One line a
case, then one JSON line of them all with the card's name and power
limit. Exits 1 where a kernel differs from its twin or from the parent,
and 2 without a CUDA device.
"""

import argparse
import contextlib
import itertools
import json
import pathlib
import sys

import numpy as np
import torch

from supereight_tpu_torch.kernels import gather_probe as gp
from supereight_tpu_torch.kernels.gather_probe import FORMS, probe_inputs

HBM_BYTES_PER_S = 3.35e12  # the H100 SXM's device memory rate
# the pool's cold cases: A and D take COLD_SETS disjoint brick sets in
# turn, so a launch's 16.8 MB of rows were last read COLD_SETS - 1
# launches (100 MB of traffic) before, out of the 50 MB L2; C takes
# COLD_SETS disjoint (table, index) pairs, its 33.6 MB last read 100 MB
# of its own inputs (and 50 MB of outputs) before
COLD_SETS = 4
# the one PyTorch call of each form's function; the port never calls it
LIBRARY = {
    "gather_a": lambda t, i, i64: torch.index_select(t, 0, i),
    "gather_b": lambda t, i, i64: torch.gather(t, 0, i64),
    "gather_c": lambda t, i, i64: torch.gather(t, 1, i64),
    "gather_d": lambda t, i, i64: torch.index_select(t, 0, i)}


def run(device):
    """[(name, ok, message)] of the four forms on ``device``."""
    results = []
    for (name, kernel, _, expect), (t, i) in zip(FORMS, probe_inputs()):
        try:
            out = kernel(torch.from_numpy(t).to(device),
                         torch.from_numpy(i).to(device))
            ok = bool(np.array_equal(out.cpu().numpy(), expect(t, i)))
            results.append((name, ok, f"OK match={ok}"))
        except Exception as e:  # reported per form, like the TPU probe
            msg = str(e).split("\n")[0][:160]
            results.append((name, False, f"FAIL {type(e).__name__}: {msg}"))
    return results


def cold_bricks(rows=gp.POOL_BRICKS, n=gp.POOL_BUDGET, sets=COLD_SETS,
                seed=1):
    """``sets`` disjoint i32[n] sets of distinct bricks of a pool of
    ``rows``, for the pool's cold cases."""
    perm = np.random.default_rng(seed).permutation(rows)[:sets * n]
    return perm.reshape(sets, n).astype(np.int32)


def cold_tables(device, n=gp.POOL_BUDGET, sets=COLD_SETS, seed=2):
    """``sets`` disjoint (table f32[n, 512], idx i32[n, 512] in [0, 512))
    pairs for C's cold case: row slices of one seeded table and one
    seeded index, copied to ``device`` once, views with no copy."""
    rng = np.random.default_rng(seed)
    shape = (sets * n, gp.BRICK_VOXELS)
    table = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    idx = torch.from_numpy(rng.integers(0, gp.BRICK_VOXELS, shape,
                                        dtype=np.int32))
    table, idx = table.to(device), idx.to(device)
    return [(table[k * n:(k + 1) * n], idx[k * n:(k + 1) * n])
            for k in range(sets)]


def pairs(t, i):
    """A case's (table, idx) calls: ``t`` and ``i`` each one tensor or a
    list of them, taken in turn."""
    sets = i if isinstance(i, list) else [i]
    tables = t if isinstance(t, list) else [t] * len(sets)
    return list(zip(tables, sets))


def cases(device, shapes=None):
    """(shape, case, launch name, kernel wrapper, twin, table, idx) of
    each timed case on ``device``: the four forms and ``gather_d`` on
    form A's inputs, at each of ``shapes`` (name -> the numpy inputs of
    the four forms; default the probe's and the pool's), the last where
    D's inputs are not A's; at the pool's, also A, C and D cold
    (``gather_a_cold``, ``gather_d_cold``: ``idx`` a list of
    :func:`cold_bricks`; ``gather_c_cold``: ``table`` and ``idx`` lists of
    :func:`cold_tables`' pairs; taken in turn, :func:`pairs`). A numpy
    array that several forms share is copied to the device once."""
    shapes = shapes or {"probe": probe_inputs(), "pool": gp.pool_inputs()}
    out = []
    for shape, arrays in shapes.items():
        on_dev = {}
        tensors = [tuple(on_dev.setdefault(id(a), torch.from_numpy(a).to(
            device)) for a in pair) for pair in arrays]
        for key, form, (t, i) in zip(gp.KEYS, FORMS, tensors):
            out.append((shape, key, key, form[1], form[2], t, i))
        if any(a is not b for a, b in zip(arrays[0], arrays[3])):
            out.append((shape, "gather_d_on_a", "gather_d", FORMS[3][1],
                        FORMS[3][2], *tensors[0]))
        if shape == "pool":
            t = tensors[0][0]
            sets = list(torch.from_numpy(cold_bricks(t.shape[0], len(
                tensors[0][1]))).to(device))
            tables, idx = map(list, zip(*cold_tables(
                device, len(tensors[2][0]))))
            for key in ("gather_a", "gather_c", "gather_d"):
                form = FORMS[gp.KEYS.index(key)]
                out.append((shape, key + "_cold", key, form[1], form[2],
                            *((tables, idx) if key == "gather_c"
                              else (t, sets))))
    return out


def default_timer(fn, kernel, per_call=1):
    from supereight_tpu_torch.tools import sharded_kernels as sk
    return sk.kernel_us(fn, kernel, per_call=per_call)


def time_case(launch, kernel, plain, t, i, builds, timer=default_timer):
    """One case's numbers: its bytes bound, the kernel's output against
    its twin, and device us (``timer(fn, kernel name, launches a call)``:
    median, fastest, slowest) of the twin, the library call and the
    kernel, each call on the next of the case's :func:`pairs` where
    ``t`` or ``i`` is a list, under each of ``builds`` ([(name, library
    or None for this checkout's)], timed in that order; a name that comes
    twice keeps both times), each build with its output's digest and
    whether it equals the twin (on the first pair, as the bounds)."""
    from supereight_tpu_torch.tools import sharded_kernels as sk
    from supereight_tpu_torch.tools.noise_kernels import digest
    calls = pairs(t, i)
    t, i = calls[0]
    twin = plain(t, i)
    n_bytes = gp.moved_bytes(launch, t, i)
    r = dict(table=list(t.shape), idx=list(i.shape), sets=len(calls),
             bytes=n_bytes, bound_us=n_bytes / HBM_BYTES_PER_S * 1e6,
             builds={})
    if launch == "gather_c":
        r["sector_us"] = gp.sector_bytes(t, i) / HBM_BYTES_PER_S * 1e6

    def turns(call):
        """A call of ``call(table, idx, idx as int64)`` on the next pair
        in turn."""
        cycle = itertools.cycle([(t, s, s.long()) for t, s in calls])
        return lambda: call(*next(cycle))
    r["twin"] = timer(turns(lambda t, i, _: plain(t, i)), "", None)
    r["library"] = timer(turns(LIBRARY[launch]), "", None)
    for name, lib in builds:
        with sk.using(lib) if lib is not None else \
                contextlib.nullcontext():
            got = kernel(t, i)
            us = timer(turns(lambda t, i, _: kernel(t, i)),
                       launch + "_kernel")
        r["builds"].setdefault(name, []).append(dict(
            us=us, sha256=digest(got), exact=bool(torch.equal(got, twin))))
    return r


def parent_library(checkout):
    """CHECKOUT's ``csrc/gather_probe.cu`` built as a side library
    (``tools/sharded_kernels.build_sources``)."""
    from supereight_tpu_torch.tools import sharded_kernels as sk
    src = (pathlib.Path(checkout) / "supereight_tpu_torch" / "csrc"
           / "gather_probe.cu").read_text()
    return sk.build_sources({"parent": ("gather_probe.cu", src)})["parent"]


def builds_for(launch, parent, side):
    """The builds a case of kernel ``launch`` is timed under: parent, this
    checkout's, this checkout's, parent where ``parent`` is a library,
    else this checkout's once; then each side build of ``side`` (name ->
    library, or None where it does not fit the sources) whose name starts
    with ``launch``."""
    own = [("change", None)]
    out = ([("parent", parent)] + own * 2 + [("parent", parent)]
           if parent is not None else own)
    return out + [(name, lib) for name, lib in side.items()
                  if lib is not None and name.startswith(launch + "_")]


def summary(shape, case, r, floor):
    """One printed line of a case."""
    b = r["builds"]

    def us(build):
        return ", ".join(f"{m['us'][0]:.2f}" for m in b[build])
    ch = b["change"]
    best = min(m["us"][0] for m in ch)
    _, lo, hi = ch[0]["us"]
    sets = f" x {r['sets']} in turn" if r["sets"] > 1 else ""
    line = (f"{shape} {case}: table {r['table']}, idx {r['idx']}{sets}; "
            f"kernel {us('change')} us ({lo:.2f}-{hi:.2f})"
            f", twin {r['twin'][0]:.2f}, library {r['library'][0]:.2f}; "
            f"floor {floor:.2f}; bound {r['bound_us']:.3f} us "
            f"({r['bytes']} B), share {r['bound_us'] / best:.1%}"
            + (f", sector floor {r['sector_us']:.3f} us"
               if "sector_us" in r else "") + "; "
            f"bit-equal to its twin {ch[0]['exact']}; sha256 "
            f"{ch[0]['sha256']}")
    for build, runs in b.items():
        if build != "change":
            line += (f"; {build} {us(build)} us, sha256 {runs[0]['sha256']}"
                     + (f" (equal {runs[0]['sha256'] == ch[0]['sha256']})"
                        if build == "parent" else ""))
    return line


def time_all(device, parent=None, side=None, shapes=None,
             timer=default_timer):
    """:func:`time_case` of every case of :func:`cases`: (results as
    shape -> case -> numbers, all bit-equal to their twins and to the
    parent's)."""
    res, ok = {}, True
    for shape, case, launch, kernel, plain, t, i in cases(device, shapes):
        r = time_case(launch, kernel, plain, t, i,
                      builds_for(launch, parent, side or {}), timer)
        res.setdefault(shape, {})[case] = r
        b = r["builds"]
        ok &= all(m["exact"] for m in b["change"])
        ok &= all(m["sha256"] == b["change"][0]["sha256"]
                  for m in b.get("parent", []))
    return res, ok


def main(argv=()):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--time", action="store_true",
                   help="time every form at the probe's and the pool's "
                   "shapes")
    p.add_argument("--split", action="store_true",
                   help="with --time: also the gather side builds")
    p.add_argument("--parent", metavar="CHECKOUT",
                   help="with --time: also CHECKOUT's gather kernels, in "
                   "turns with these")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_gather: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    print(f"device: {device} {torch.cuda.get_device_name(device)}",
          flush=True)
    if not args.time:
        results = run(device)
        for form, _, msg in results:
            print(f"{form}: {msg}", flush=True)
        return 0 if all(ok for _, ok, _ in results) else 1
    from supereight_tpu_torch.tools import sharded_kernels as sk
    from supereight_tpu_torch.tools.bench import card
    side = sk.build_side(tuple(n for n in sk.SIDE if n.startswith(
        "gather"))) if args.split else {}
    for name, lib in side.items():
        if lib is None:
            print(f"{name}: no such side build of these sources", flush=True)
    parent = parent_library(args.parent) if args.parent else None
    floor = sk.launch_floor_us()
    print(f"# {card()}; launch floor (a one-element zero_()) {floor:.2f} "
          f"device us", flush=True)
    res, ok = time_all(device, parent, side)
    for shape, rows in res.items():
        for case, r in rows.items():
            print(summary(shape, case, r, floor), flush=True)
    print(json.dumps({"card": card(), "launch_floor_us": floor,
                      "side_builds": {k: v is not None
                                      for k, v in side.items()},
                      "probe_gather": res}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
