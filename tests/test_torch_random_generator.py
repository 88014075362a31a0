"""The port's threefry ``Generator`` (``pydynet_tpu_torch/random.py``) and
the dropout that draws from it, against ``pydynet_tpu.random.Generator`` and
the JAX package's dropout on the CPU.

``split`` sequences, ``uniform`` (float32; float64, JAX's default type
under the JAX package's x64; bfloat16 and float16) and ``bernoulli`` are
equal bit for bit. ``normal`` goes through ``erfinv``, which PyTorch and
XLA round differently: the largest relative difference found over these
seeds is 5.1e-6 in float32 (1e-13 in float64), so it is held to 1e-5
relative. Dropout masks equal the JAX package's after the same seed, and
the first Adam step of the dropout example equals its.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import pydynet_tpu as pdn
import pydynet_tpu.nn.functional as JF
from pydynet_tpu import nn as jnn
from pydynet_tpu import optim as joptim
from pydynet_tpu.random import Generator as JGenerator
from examples.pydynet import dropout_bn as jdb

import pydynet_tpu_torch as pdt
from pydynet_tpu_torch import nn as tnn
from pydynet_tpu_torch import optim as toptim
from pydynet_tpu_torch import random as prandom
from pydynet_tpu_torch.examples import dropout_bn
from pydynet_tpu_torch.nn import functional as F
from pydynet_tpu_torch.utils.checkpoint import load_state_dict, state_dict

torch.set_num_threads(1)  # six test workers share the CPU: one thread each

REPO = Path(__file__).resolve().parents[1]
SEEDS = (0, 7, 2**40 + 3)
TYPES = {"float32": (jnp.float32, torch.float32),
         "float64": (jnp.float64, torch.float64),
         "bfloat16": (jnp.bfloat16, torch.bfloat16),
         "float16": (jnp.float16, torch.float16)}


def host(t):
    return t.float().numpy() if t.dtype in (torch.bfloat16,
                                            torch.float16) else t.numpy()


@pytest.mark.parametrize("seed", SEEDS)
def test_generator_split_sequence_matches_jax(seed):
    """``PRNGKey(seed)``, then ``next_key``'s keys and the state it keeps,
    split after split."""
    j, t = JGenerator(seed), prandom.Generator(seed)
    np.testing.assert_array_equal(t.state.numpy(),
                                  np.asarray(j._state._data))
    for _ in range(6):
        np.testing.assert_array_equal(t.next_key().numpy(),
                                      np.asarray(j.next_key()))
        np.testing.assert_array_equal(t.state.numpy(),
                                      np.asarray(j._state._data))


@pytest.mark.parametrize("dtype", list(TYPES))
@pytest.mark.parametrize("seed", SEEDS)
def test_generator_uniform_and_bernoulli_match_jax(seed, dtype):
    """``uniform`` in each type, over a range and over [0, 1), and
    ``bernoulli`` with a Python float (JAX's float64 draw), bit for bit."""
    jt, tt = TYPES[dtype]
    j, t = JGenerator(seed), prandom.Generator(seed)
    for kw in ({}, dict(minval=-2.5, maxval=3.0)):
        got = host(t.uniform((7, 33), dtype=tt, **kw))
        want = np.asarray(j.uniform((7, 33), dtype=jt, **kw))
        np.testing.assert_array_equal(got, want.astype(got.dtype))
    np.testing.assert_array_equal(t.bernoulli(0.3, (5, 41)).numpy(),
                                  np.asarray(j.bernoulli(0.3, (5, 41))))


@pytest.mark.parametrize("seed", SEEDS)
def test_generator_normal_matches_jax(seed):
    """``normal`` within 1e-5 relative in float32 and 1e-12 in float64
    (``erfinv``'s rounding; module doc)."""
    j, t = JGenerator(seed), prandom.Generator(seed)
    np.testing.assert_allclose(t.normal((4000,)).numpy(),
                               np.asarray(j.normal((4000,))), rtol=1e-5)
    np.testing.assert_allclose(
        t.normal((64,), dtype=torch.float64).numpy(),
        np.asarray(j.normal((64,), dtype=jnp.float64)), rtol=1e-12)


def test_manual_seed_resets_the_stream():
    """``manual_seed`` resets ``default_generator`` (and NumPy's stream) as
    the JAX package's does: the same draws again, equal to JAX's."""
    pdt.manual_seed(11)
    first = pdt.default_generator.uniform((100,))
    a = np.random.rand()
    assert pdt.manual_seed(11) is pdt.default_generator
    assert torch.equal(pdt.default_generator.uniform((100,)), first)
    assert np.random.rand() == a
    pdn.manual_seed(11)
    np.testing.assert_array_equal(
        first.numpy(), np.asarray(pdn.default_generator.uniform((100,))))
    # the init draws stay on the torch.Generators, which manual_seed seeds
    w1 = tnn.Linear(4, 3).weight.detach().clone()
    pdt.manual_seed(11)
    assert torch.equal(tnn.Linear(4, 3).weight, w1)


@pytest.mark.parametrize("p", [0.05, 0.5])
def test_dropout_masks_match_jax(p):
    """``F.dropout`` and ``nn.Dropout`` after the same seed: the JAX
    package's masks, draw after draw; eval mode and p = 0 are the
    identity and draw nothing."""
    x = np.random.default_rng(0).standard_normal((40, 96)).astype(
        np.float32)
    pdn.manual_seed(3)
    pdt.manual_seed(3)
    jd, td = jnn.Dropout(p), tnn.Dropout(p)
    for _ in range(2):
        np.testing.assert_array_equal(
            F.dropout(torch.from_numpy(x), p).numpy(),
            JF.dropout(pdn.Tensor(x), p).numpy())
        np.testing.assert_array_equal(td(torch.from_numpy(x)).numpy(),
                                      jd(pdn.Tensor(x)).numpy())
    jd.eval()
    td.eval()
    key = pdt.default_generator.state.clone()
    t = torch.from_numpy(x)
    assert td(t) is t and F.dropout(t, 0.0) is t and F.dropout(
        t, p, training=False) is t
    assert torch.equal(pdt.default_generator.state, key)
    np.testing.assert_array_equal(jd(pdn.Tensor(x)).numpy(), x)
    jd.train()
    td.train()
    np.testing.assert_array_equal(td(torch.from_numpy(x)).numpy(),
                                  jd(pdn.Tensor(x)).numpy())


def test_dropout_example_first_steps_match_jax():
    """``DNN_dropout`` (4096-512-128-40, p 0.05) against the JAX example's,
    the JAX step compiled with ``pdn.jit`` as the example compiles it:
    three Adam steps (lr 5e-5) from the same seed, losses within 1e-5
    relative, weights within 1e-5."""
    np.random.seed(0)
    jnet = jdb.DNN_dropout()
    tnet = dropout_bn.DNN_dropout()
    load_state_dict(tnet, jnet.state_dict())
    jopt = joptim.Adam(jnet.parameters(), lr=5e-5)
    topt = toptim.Adam(tnet.parameters(), lr=5e-5)
    jloss_fn, tloss_fn = jnn.CrossEntropyLoss(), tnn.CrossEntropyLoss()

    def jstep(bx, by):
        loss = jloss_fn(jnet(bx), by)
        jopt.zero_grad()
        loss.backward()
        jopt.step()
        return loss

    jtrain = pdn.jit(jstep, state=([jnet], [jopt]))
    X, y = dropout_bn.load_faces()
    pdn.manual_seed(42)
    pdt.manual_seed(42)
    for i in range(3):
        bx, by = X[40 * i:40 * (i + 1)], y[40 * i:40 * (i + 1)]
        jl = float(jtrain(pdn.Tensor(bx), pdn.Tensor(by)).numpy())
        tl = dropout_bn.train_step([tnet], [topt], tloss_fn,
                                   torch.from_numpy(bx),
                                   torch.from_numpy(by))[0]
        np.testing.assert_allclose(float(tl), jl, rtol=1e-5)
    want = jnet.state_dict()
    for name, got in state_dict(tnet).items():
        np.testing.assert_allclose(got, want[name], atol=1e-5, rtol=0,
                                   err_msg=name)
    np.testing.assert_array_equal(pdt.default_generator.state.numpy(),
                                  np.asarray(pdn.default_generator._state
                                             ._data))


def test_new_modules_import_no_jax():
    """The Generator, LoRA and the speculative server import neither JAX
    nor the JAX package."""
    code = ("import sys\n"
            "import pydynet_tpu_torch.random\n"
            "import pydynet_tpu_torch.nn.modules.lora\n"
            "import pydynet_tpu_torch.models.llama.serve_spec\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'pydynet_tpu'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120, env=dict(os.environ, OMP_NUM_THREADS="1"))
