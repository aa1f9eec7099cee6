"""The gather-form probe (K8) held to the probe's own Pallas kernels.

``tools/probe_pallas_gather.py`` runs its four forms at import on a TPU,
so its kernel bodies are copied here as they stand there (formA's at
:23-24, formB's :35-36, formC's :48-49, formD's :61-65), each run in
``pl.pallas_call`` with the probe's memory spaces and ``interpret=True``
on the CPU. Each port wrapper on CPU tensors (its twin) must equal the
Pallas output bit for bit on the probe's inputs
(``gather_probe.probe_inputs``), and form C also at the brick pool's
shapes cut 64-fold (``gather_probe.pool_inputs(scale=64)``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from supereight_tpu_torch.kernels import gather_probe as gp


def body_a(tr, ir, o):
    o[:] = jnp.take(tr[:], ir[:], axis=0)


def body_b(tr, ir, o):
    o[:] = jnp.take_along_axis(tr[:], ir[:], axis=0)


def body_c(tr, ir, o):
    o[:] = jnp.take_along_axis(tr[:], ir[:], axis=1)


def make_body_d(n):
    def body_d(tr, ir, o):
        def body(i, _):
            o[i, :] = tr[ir[i], :]
            return 0
        jax.lax.fori_loop(0, n, body, 0)
    return body_d


def pallas_form(form, t, i):
    """Form ``form`` (0-3: A-D) of the probe on numpy (table, idx), its
    kernel body in interpret mode with the probe's memory spaces (D's
    indices in SMEM)."""
    cols = t.shape[1]
    shape = (i.shape[0], cols) if form in (0, 3) else i.shape
    body = (body_a, body_b, body_c, make_body_d(i.shape[0]))[form]
    idx_space = pltpu.SMEM if form == 3 else pltpu.VMEM
    out = pl.pallas_call(
        body, out_shape=jax.ShapeDtypeStruct(shape, jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=idx_space)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True)(jnp.asarray(t), jnp.asarray(i))
    return np.asarray(out)


CASES = [(f, "probe") for f in range(4)] + [(2, "pool")]


@pytest.mark.parametrize("form,shape", CASES, ids=[
    f"{'ABCD'[f]}-{s}" for f, s in CASES])
def test_wrapper_matches_the_probe_pallas_body(form, shape):
    """The port's wrapper of each form equals the probe's Pallas body,
    run in interpret mode, bit for bit."""
    torch.set_num_threads(1)
    t, i = (gp.probe_inputs() if shape == "probe"
            else gp.pool_inputs(scale=64))[form]
    want = pallas_form(form, t, i)
    got = gp.FORMS[form][1](torch.from_numpy(t), torch.from_numpy(i))
    assert want.shape == tuple(got.shape)
    assert want.tobytes() == got.numpy().tobytes()
