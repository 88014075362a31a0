"""The training-state checkpoint (``pydynet_tpu_torch/utils/checkpoint.py``:
``state_blob``, ``save_checkpoint``, ``read_extra``, ``load_checkpoint``)
against the JAX package's, on the CPU.

One file resumes training in either package: a checkpoint written by one is
loaded by the other, which then takes the same next Adam or SGD step as the
writer (loss within rtol 1e-6, parameters within 1e-6 for the small net;
the Llama within the training tests' 1e-5). The port's Llama keeps torch's
(out, in) Linear layout and is written in the JAX package's (in, out), its
Adam moments with it.
"""
import numpy as np
import pytest
import torch

import pydynet_tpu as pdn
from pydynet_tpu import nn as jnn
from pydynet_tpu import optim as joptim
from pydynet_tpu import utils as jutils
from pydynet_tpu.models.llama.model import Llama as JLlama

from pydynet_tpu_torch import nn as tnn
from pydynet_tpu_torch import optim as toptim
from pydynet_tpu_torch.models.llama import Llama, params_from_tpu
from pydynet_tpu_torch.models.llama.convert import params_to_tpu
from pydynet_tpu_torch.nn import functional as F
from pydynet_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(1)  # six test workers share the CPU: one thread each

X = np.random.default_rng(0).standard_normal((8, 4)).astype(np.float32)
Y = np.random.default_rng(1).standard_normal((8, 2)).astype(np.float32)


def jax_net(seed):
    np.random.seed(seed)
    f32 = dict(dtype=np.float32)  # the JAX package's default is float64
    return jnn.Sequential(jnn.Linear(4, 8, **f32), jnn.Tanh(),
                          jnn.LayerNorm(8, **f32), jnn.Linear(8, 2, **f32))


def port_net(jnet=None):
    net = torch.nn.Sequential(tnn.Linear(4, 8), tnn.Tanh(), tnn.LayerNorm(8),
                              tnn.Linear(8, 2))
    if jnet is not None:
        tck.load_state_dict(net, jnet.state_dict())
    return net


def make_opt(mod, params, kind, lr):
    if kind == "Adam":
        return mod.Adam(params, lr=lr)
    return mod.SGD(params, lr=lr, momentum=0.9)


class JaxTrainer:
    def __init__(self, seed, kind, lr):
        self.net = jax_net(seed)
        self.opt = make_opt(joptim, self.net.parameters(), kind, lr)

        def step(x, y):
            self.opt.zero_grad()
            loss = pdn.nn.functional.mse_loss(self.net(x), y)
            loss.backward()
            self.opt.step()
            return loss

        self.step_fn = pdn.jit(step, state=(self.net, self.opt))

    def step(self):
        return float(self.step_fn(pdn.Tensor(X), pdn.Tensor(Y)).item())

    def state(self):
        return self.net.state_dict()


class PortTrainer:
    def __init__(self, seed, kind, lr):
        self.net = port_net(jax_net(seed))
        self.opt = make_opt(toptim, list(self.net.parameters()), kind, lr)

    def step(self):
        self.opt.zero_grad()
        loss = F.mse_loss(self.net(torch.from_numpy(X)), torch.from_numpy(Y))
        loss.backward()
        self.opt.step()
        return float(loss.detach())

    def state(self):
        return tck.state_dict(self.net)


PACKAGES = {"port": (PortTrainer, tck), "jax": (JaxTrainer, jutils)}


def buffers(opt, kind):
    names = ("m", "v") if kind == "Adam" else ("v",)
    return [np.asarray(b.numpy()) for n in names for b in getattr(opt, n)]


@pytest.mark.parametrize("kind", ["Adam", "SGD"])
@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_checkpoint_resumes_in_the_other_package(tmp_path, writer, reader,
                                                 kind):
    """Three steps in the writer, a checkpoint (step, extra), a fresh
    reader of other weights and rate loads it: its weights, running
    statistics, moments, rate and Adam's t equal the writer's; then both
    take the same next step."""
    w_cls, w_mod = PACKAGES[writer]
    r_cls, r_mod = PACKAGES[reader]
    src = w_cls(0, kind, 1e-2)
    for _ in range(3):
        src.step()
    path = str(tmp_path / "ck.npz")
    w_mod.save_checkpoint(path, src.net, src.opt, step=3,
                          extra={"epoch": 2, "ema": np.arange(3.0)})
    dst = r_cls(5, kind, 0.5)
    step, extra = r_mod.load_checkpoint(path, dst.net, dst.opt,
                                        with_extra=True)
    assert step == 3 and extra["epoch"] == 2
    np.testing.assert_array_equal(extra["ema"], np.arange(3.0))
    theirs = dst.state()
    for name, value in src.state().items():
        np.testing.assert_array_equal(theirs[name], value, err_msg=name)
    assert dst.opt.lr == src.opt.lr
    for a, b in zip(buffers(dst.opt, kind), buffers(src.opt, kind)):
        np.testing.assert_array_equal(a, b)
    if kind == "Adam":
        assert dst.opt.t == src.opt.t == 4
    np.testing.assert_allclose(dst.step(), src.step(), rtol=1e-6)
    theirs = dst.state()
    for name, value in src.state().items():
        np.testing.assert_allclose(theirs[name], value, atol=1e-6, rtol=0,
                                   err_msg=name)


# the Llama: torch's (out, in) Linears, written in the JAX layout
CFG = dict(vocab_size=256, embed_dim=32, n_heads=2, ffn_dim=64,
           max_seq_len=32, max_batch_size=1, n_layers=2)
TRAINABLE = ("tok_embedding", "layers.0.attention.Q", "layers.1.ffn",
             "lm_head")


def llama_pair(seed):
    np.random.seed(seed)
    jm = JLlama(dtype=np.float32, **CFG)
    tm = Llama(**CFG, device="cpu")
    tm.load_state_dict(params_from_tpu(
        {n: p.numpy() for n, p in jm._parameters.items()}))
    jm.set_trainable_parameters(TRAINABLE)
    tm.set_trainable_parameters(TRAINABLE)
    return jm, tm


def jax_params(jm):
    return {n: p.numpy() for n, p in jm._parameters.items()
            if getattr(p, "persistent", True)}


def test_llama_checkpoint_crosses_in_the_jax_layout(tmp_path):
    """The port's Llama checkpoint holds its Linear weights and their Adam
    moments transposed to the JAX package's layout: the JAX Llama resumes
    from it and takes the port's next step; a checkpoint the JAX Llama then
    writes resumes in the port, bit for bit, and takes its next step."""
    ids = np.random.default_rng(2).integers(0, 256, size=(1, 13))
    inp, tgt = ids[:, :-1], ids[:, 1:]
    jm, tm = llama_pair(0)
    jopt = joptim.Adam(jm.parameters(), lr=1e-4)
    topt = toptim.Adam([p for p in tm.parameters() if p.requires_grad],
                       lr=1e-4)
    tm.finetune_step(inp, tgt, topt)
    path = str(tmp_path / "llama.npz")
    tck.save_checkpoint(path, tm, topt, step=1)
    with np.load(path) as blob:
        q = blob["model.layers.0.attention.Q.weight"]
        np.testing.assert_array_equal(
            q, tm.layers[0].attention.Q.weight.detach().numpy().T)
        for i, m in enumerate(jopt.m):
            assert blob[f"opt.m.{i}"].shape == m.shape

    jm2, _ = llama_pair(7)
    jopt2 = joptim.Adam(jm2.parameters(), lr=1.0)
    assert jutils.load_checkpoint(path, jm2, jopt2) == 1
    want = params_to_tpu(dict(tm.named_parameters()))
    for name, value in jax_params(jm2).items():
        np.testing.assert_array_equal(value, want[name], err_msg=name)
    np.testing.assert_allclose(jm2.finetune_step(inp, tgt, jopt2),
                               tm.finetune_step(inp, tgt, topt), rtol=1e-5)
    got = dict(tm.named_parameters())
    for name, value in params_from_tpu(jax_params(jm2)).items():
        np.testing.assert_allclose(got[name].detach().numpy(), value.numpy(),
                                   atol=1e-5, rtol=0, err_msg=name)

    jutils.save_checkpoint(path, jm2, jopt2, step=2)
    _, tm2 = llama_pair(7)
    topt2 = toptim.Adam([p for p in tm2.parameters() if p.requires_grad],
                        lr=1.0)
    assert tck.load_checkpoint(path, tm2, topt2) == 2
    want = params_from_tpu(jax_params(jm2))
    for name, p in tm2.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[name].numpy())
    names = [n for n, p in tm2.named_parameters() if p.requires_grad]
    for name, a, b in zip(names, topt2.v, jopt2.v):
        b = b.numpy()
        np.testing.assert_array_equal(
            a.numpy(), b.T if a.dim() == 2 and "embedding" not in name
            else b)
    assert topt2.t == jopt2.t == 3 and topt2.lr == jopt2.lr
    np.testing.assert_allclose(tm2.finetune_step(inp, tgt, topt2),
                               jm2.finetune_step(inp, tgt, jopt2), rtol=1e-5)


# ------------------------------- the file ----------------------------------
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_extensionless_path_and_extra(tmp_path, writer):
    """A checkpoint lands at exactly the path given, suffix or not; both
    packages read its ``extra`` (0-d entries as Python scalars) and load
    it."""
    cls, mod = PACKAGES[writer]
    src = cls(0, "SGD", 0.1)
    path = tmp_path / "ckpt"
    mod.save_checkpoint(str(path), src.net, src.opt, step=4,
                        extra={"tag": 7, "w": np.ones(2)})
    assert path.exists() and not (tmp_path / "ckpt.npz").exists()
    for reader in (tck, jutils):
        extra = reader.read_extra(str(path))
        assert extra["tag"] == 7 and isinstance(extra["tag"], int)
        np.testing.assert_array_equal(extra["w"], np.ones(2))
    dst = PortTrainer(3, "SGD", 0.1)
    assert tck.load_checkpoint(str(path), dst.net, dst.opt) == 4
    with np.load(str(path)) as blob:
        assert blob["opt.lr"].dtype == np.float64
        assert {k.split(".")[0] for k in blob.files} == {"model", "opt",
                                                         "step", "extra"}


def test_load_is_strict_by_default(tmp_path):
    """A checkpoint of a smaller net raises ``KeyError`` in a larger one
    unless ``strict=False``, which loads the intersection; one of a larger
    net raises for its unexpected entries."""
    small = torch.nn.Sequential(tnn.Linear(4, 8))
    big = torch.nn.Sequential(tnn.Linear(4, 8), tnn.Linear(8, 2))
    path = str(tmp_path / "s.npz")
    tck.save_checkpoint(path, small)
    with pytest.raises(KeyError, match="missing"):
        tck.load_checkpoint(path, big)
    tck.load_checkpoint(path, big, strict=False)
    np.testing.assert_array_equal(big[0].weight.detach().numpy(),
                                  small[0].weight.detach().numpy())
    tck.save_checkpoint(path, big)
    with pytest.raises(KeyError, match="unexpected"):
        tck.load_checkpoint(path, small)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_moment_of_the_wrong_shape_raises(tmp_path, writer):
    """Moments are matched by index: an optimizer over another parameter
    set (the bias alone) meets a moment of another shape and raises
    ``ValueError``."""
    cls, mod = PACKAGES[writer]
    src = cls(0, "Adam", 1e-3)
    path = str(tmp_path / "m.npz")
    mod.save_checkpoint(path, src.net, src.opt)
    net = port_net(jax_net(0))
    opt = toptim.Adam([net[0].bias], lr=1e-3)
    with pytest.raises(ValueError, match="moment"):
        tck.load_checkpoint(path, net, opt)
