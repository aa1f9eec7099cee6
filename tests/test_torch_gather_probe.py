"""The gather-form probe (K8), the counterpart of the Pallas kernels of
``tools/probe_pallas_gather.py``.

The probe runs at import on a TPU (``pltpu`` memory spaces), so its numpy
expressions are its plain reference: each form's twin, and its wrapper
(which takes the twin for CPU tensors), must equal them bit for bit on
the probe's own inputs (``probe_inputs``: one generator seeded 0, forms
A-D in the probe's order and shapes). The entry point runs on a CUDA
device only.
"""

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
