"""The port's utilities (``pydynet_tpu_torch/utils``: ``debug``,
``profiler``) against the JAX package's (``tests/test_utils_examples.py``'s
``check_finite`` and ``StepTimer`` cases), on the CPU."""
import os

import numpy as np
import pytest
import torch

import pydynet_tpu as pdn
from pydynet_tpu import nn as jnn
from pydynet_tpu import utils as jutils

from pydynet_tpu_torch import nn as tnn
from pydynet_tpu_torch import utils as tutils

torch.set_num_threads(1)  # six test workers share the CPU: one thread each


def test_check_finite():
    """The same names and the same error as the JAX package's, gradients
    included."""
    jnet, tnet = jnn.Linear(2, 2), tnn.Linear(2, 2)
    assert tutils.check_finite(tnet) == jutils.check_finite(jnet) == []
    jnet.weight.data[0, 0] = np.nan
    with torch.no_grad():
        tnet.weight[0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="non-finite"):
        tutils.check_finite(tnet)
    assert tutils.check_finite(tnet, raise_on_fail=False) == \
        jutils.check_finite(jnet, raise_on_fail=False) == ["weight"]
    with torch.no_grad():
        tnet.weight[0, 0] = 0.0
    tnet.bias.grad = torch.tensor([float("inf"), 0.0])
    assert tutils.check_finite(tnet, raise_on_fail=False) == ["bias.grad"]


def test_step_timer_report():
    t, j = tutils.StepTimer(), jutils.StepTimer()
    t.step(100)
    j.step(100)
    rep = t.report("tokens")
    assert "Token" in rep and "tokens/s" in rep
    assert rep.split(",")[0] == j.report("tokens").split(",")[0] == \
        "Tokens count: 100"
    assert t.rate > 0 and t.elapsed >= 0


def test_debug_nans_traps_the_op():
    """The first op whose output holds a NaN raises, named; without the
    trap (or with it switched off inside) the NaN flows on."""
    x = torch.tensor([-1.0, 4.0])
    assert torch.isnan(torch.log(x)).any()
    with tutils.debug_nans():
        assert torch.sqrt(torch.tensor([4.0])).item() == 2.0
        with pytest.raises(FloatingPointError, match="aten.log"):
            torch.log(x)
        with tutils.debug_nans(False):
            assert torch.isnan(torch.log(x)).any()
        with pytest.raises(FloatingPointError):
            torch.log(x)
    assert torch.isnan(torch.log(x)).any()


def test_debug_nans_matches_jax_trap():
    """Both packages trap a NaN made inside a step, and neither traps
    ``inf`` or integer ops."""
    with jutils.debug_nans():
        with pytest.raises(FloatingPointError):
            pdn.log(pdn.Tensor(np.array([-1.0]))).numpy()
    with tutils.debug_nans():
        with pytest.raises(FloatingPointError):
            torch.log(torch.tensor([-1.0]))
        assert torch.isinf(torch.log(torch.tensor([0.0]))).all()
        assert torch.arange(3).sum().item() == 3


def test_profiler_trace_writes_tensorboard_trace(tmp_path):
    with tutils.trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    names = [e.key for e in prof.key_averages()]
    assert any("mm" in n for n in names), names
    files = [f for _, _, fs in os.walk(tmp_path) for f in fs]
    assert any(f.endswith(".pt.trace.json") for f in files), files
