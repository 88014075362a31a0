"""The port's nn-stack trainers (``pydynet_tpu_torch/examples``) against the
JAX examples, on the CPU.

The JAX nets are built from a numpy seed and carried into the port's twins
by ``utils/checkpoint.load_state_dict``; both are stepped eagerly on the
same batches with Adam. Losses are held to rtol 1e-5 and weights to 1e-5
(absolute): both packages compute in float32 and differ in summation order,
so gradients differ by about 1e-6 of their size, and Adam moves a weight by
about lr * g / (|g| + eps'), at most lr (5e-5 and 1e-4 here) a step, so a
step's difference stays far below 1e-5 unless a gradient sits near eps' =
1e-8 / sqrt(1 - 0.999^t) (3e-7 and less), where it can reach a share of lr.
The biases of the layers that feed a BatchNorm are such weights: the norm
takes away any constant shift of its input, so their gradients are zero up
to rounding, and Adam moves them by up to lr a step in directions that
rounding alone decides. They are held to what Adam can move them in five
steps, 2 * 5 * lr apart, and the outputs that they do not change to the
tolerances above.
"""
import sys
import types

import numpy as np
import pytest
import torch

import pydynet_tpu as pdn
from pydynet_tpu import nn as jnn
from pydynet_tpu import optim as joptim
import pydynet_tpu.nn.functional as JF
from examples.pydynet import dropout_bn as jdb
from examples.pydynet import mnist as jmnist

from pydynet_tpu_torch import optim as toptim
from pydynet_tpu_torch.data import data_loader
from pydynet_tpu_torch.examples import dropout_bn, mnist
from pydynet_tpu_torch.nn import CrossEntropyLoss
from pydynet_tpu_torch.utils.checkpoint import load_state_dict, state_dict


def twins(jclasses, tclasses, seed):
    np.random.seed(seed)
    jnets = [c() for c in jclasses]
    tnets = [c() for c in tclasses]
    for j, t in zip(jnets, tnets):
        load_state_dict(t, j.state_dict())
    return jnets, tnets


def assert_weights_close(jnets, tnets, inert=(), inert_atol=None):
    """Every weight within 1e-5, but those named in ``inert`` (the biases
    that feed a BatchNorm) within ``inert_atol``."""
    for j, t in zip(jnets, tnets):
        want = j.state_dict()
        for name, got in state_dict(t).items():
            atol = inert_atol if name in inert and isinstance(
                t, dropout_bn.DNN_BN) else 1e-5
            np.testing.assert_allclose(got, want[name], atol=atol, rtol=0,
                                       err_msg=name)


def test_synthetic_faces_equal_the_jax_examples(monkeypatch):
    """The JAX example's fallback set, bit for bit. Its sklearn fetch is
    replaced by one that fails at once, so nothing is fetched."""
    fake = types.ModuleType("sklearn.datasets")

    def no_fetch(**_):
        raise OSError("offline")

    fake.fetch_olivetti_faces = no_fetch
    monkeypatch.setitem(sys.modules, "sklearn.datasets", fake)
    (X, y), (jX, jy) = dropout_bn.load_faces(), jdb.load_faces()
    np.testing.assert_array_equal(X, jX)
    np.testing.assert_array_equal(y, jy)
    assert X.shape == (400, 4096) and X.dtype == np.float32


def test_synthetic_mnist_equals_the_jax_examples():
    for (a, b), (c, d) in zip(mnist.synthetic_mnist(),
                              jmnist.synthetic_mnist()):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_dropout_bn_summed_loss_steps_match_jax():
    """Five summed-loss Adam steps (lr 5e-5, one backward over both losses)
    of DNN and DNN_BN at 4096-512-128-40 on the example's batches."""
    jnets, tnets = twins((jdb.DNN, jdb.DNN_BN),
                         (dropout_bn.DNN, dropout_bn.DNN_BN), 0)
    jopts = [joptim.Adam(n.parameters(), lr=5e-5) for n in jnets]
    topts = [toptim.Adam(n.parameters(), lr=5e-5) for n in tnets]
    jloss, tloss = jnn.CrossEntropyLoss(), CrossEntropyLoss()
    X, y = dropout_bn.load_faces()
    np.random.seed(1)
    batches = list(data_loader(X[:320], y[:320], 40, shuffle=True))[:5]
    for bx, by in batches:
        jl = [jloss(n(pdn.Tensor(bx)), pdn.Tensor(by)) for n in jnets]
        for o in jopts:
            o.zero_grad()
        (jl[0] + jl[1]).backward()
        for o in jopts:
            o.step()
        tl = dropout_bn.train_step(tnets, topts, tloss, torch.from_numpy(bx),
                                   torch.from_numpy(by))
        np.testing.assert_allclose([float(x) for x in tl],
                                   [float(x.numpy()) for x in jl], rtol=1e-5)
    assert_weights_close(jnets, tnets, inert=("fc1.bias", "fc2.bias"),
                         inert_atol=2 * 5 * 5e-5)
    bn = tnets[1].bn1
    assert float(bn.running_mean.abs().max()) > 0  # the stats moved
    bx = X[320:360]
    with torch.no_grad():
        for j, t in zip(jnets, tnets):
            np.testing.assert_allclose(t(torch.from_numpy(bx)).numpy(),
                                       j(pdn.Tensor(bx)).numpy(), atol=1e-5,
                                       rtol=1e-5)


@pytest.mark.parametrize("network", ["conv", "mlp"])
def test_mnist_steps_match_jax(network):
    """Three Adam steps (lr 1e-4) at batch 16 on the synthetic set."""
    jcls = {"conv": jmnist.ConvNet, "mlp": jmnist.MLP}[network]
    tcls = {"conv": mnist.ConvNet, "mlp": mnist.MLP}[network]
    (jnet,), (tnet,) = twins((jcls,), (tcls,), 2)
    jopt = joptim.Adam(jnet.parameters(), lr=1e-4)
    topt = toptim.Adam(tnet.parameters(), lr=1e-4)
    (X, y), _ = mnist.synthetic_mnist()
    X = X.astype(np.float32)
    for i in range(3):
        bx, by = X[16 * i:16 * (i + 1)], y[16 * i:16 * (i + 1)]
        jl = JF.cross_entropy_loss(jnet(pdn.Tensor(bx)), pdn.Tensor(by))
        jopt.zero_grad()
        jl.backward()
        jopt.step()
        tl = mnist.train_step(tnet, topt, torch.from_numpy(bx),
                              torch.from_numpy(by))
        np.testing.assert_allclose(float(tl), float(jl.numpy()), rtol=1e-5)
    assert_weights_close([jnet], [tnet])


def test_dropout_bn_cli_on_cpu(capsys):
    accs = dropout_bn.cli(["--device", "cpu", "--epochs", "1"])
    out = capsys.readouterr().out
    assert "device cpu; TF32 matmul" in out and "epoch  0:" in out
    assert len(accs) == 3 and all(0.0 <= a <= 1.0 for a in accs)


def test_dropout_bn_trains_on_cpu():
    """Two epochs: every net's mean loss falls."""
    nets, history, accs = dropout_bn.train(epochs=2, device="cpu")
    assert len(history) == 2
    assert all(b < a for a, b in zip(*history))
    assert all(not n.training for n in nets)


@pytest.mark.parametrize("network", ["conv", "mlp"])
def test_mnist_cli_on_cpu(network, capsys):
    acc = mnist.main(["--network", network, "--device", "cpu", "--epochs",
                      "1", "--synthetic"])
    out = capsys.readouterr().out
    assert "synthetic MNIST-shaped data" in out and "steps/s" in out
    assert acc > 0.2  # chance is 0.1


def test_mnist_epoch_runs_full_batches_then_the_rest(monkeypatch):
    """512 samples at batch 256 are 2 steps; 1096 at 250 are 5, the last
    of the remaining 96."""
    steps = []
    net = mnist.MLP()
    opt = toptim.Adam(net.parameters(), lr=1e-4)
    (X, y), _ = mnist.synthetic_mnist()
    Xt, yt = torch.from_numpy(X.astype(np.float32)), torch.from_numpy(y)
    real = mnist.train_step
    monkeypatch.setattr(mnist, "train_step", lambda n, o, bx, by:
                        steps.append(len(bx)) or real(n, o, bx, by))
    assert mnist.train_epoch(net, opt, Xt[:512], yt[:512], 256)[1] == 2
    assert mnist.train_epoch(net, opt, Xt[:1096], yt[:1096], 250)[1] == 5
    assert steps == [256, 256, 250, 250, 250, 250, 96]


def test_entry_points_mean_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        dropout_bn.main(epochs=1)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        mnist.main(["--epochs", "1", "--synthetic"])
