"""The port's ``Device``, ``cuda`` shim and device placement of tape
tensors against the JAX package's (``test_device.py``'s cases), and the
``Module`` names the JAX package has (``move``, ``set_module_state``,
``to(Device)``) with the two missing names of Queue 3 (``RMSNorm.
reset_parameters``, ``LoRALinear.merge_``/``delta_array``)."""
import numpy as np
import pytest
import torch

import pydynet_tpu as jpdn
import pydynet_tpu_torch as pdt
from pydynet_tpu import cuda as jcuda
from pydynet_tpu.device import Device as JDevice
from pydynet_tpu_torch import cuda
from pydynet_tpu_torch import device as tdevice
from pydynet_tpu_torch.device import Device

torch.set_num_threads(1)  # six test workers share the CPU: one thread each

BOTH = [(Device, cuda), (JDevice, jcuda)]


@pytest.mark.parametrize("D,shim", BOTH, ids=["port", "jax"])
def test_device_parsing_and_equality(D, shim):
    assert D(None) == D("cpu") and D(None).kind == "cpu"
    assert D(D("cpu")) == D("cpu")
    assert D("cpu") == "cpu"
    for bad in ("rocm:0", "cuda:x", "tpu:-1", 3.0):
        with pytest.raises(ValueError):
            D(bad)
    with D("cpu") as d:
        assert d == D("cpu")
    assert repr(D("cpu")) == "Device(type='cpu')"
    assert hash(D("cpu")) == hash(D(None))


@pytest.mark.parametrize("D,shim", BOTH, ids=["port", "jax"])
def test_cuda_module_shims_without_a_card(D, shim):
    if shim.is_available():
        pytest.skip("an accelerator is visible")
    assert shim.device_count() == 0 and shim.current_device() == 0
    for name in ("cuda", "gpu", "tpu:1", 0):
        with pytest.raises(RuntimeError):
            D(name)
    with pytest.raises(RuntimeError):
        shim.set_device(0)
    assert shim.Device is D


def fake_cards(monkeypatch, n):
    monkeypatch.setattr(tdevice, "is_available", lambda: True)
    monkeypatch.setattr(tdevice, "device_count", lambda: n)


def test_accel_names_index_and_torch_device(monkeypatch):
    """With cards (faked here), the JAX package's names all mean one card,
    equality ignores the index, and a bad index raises when used."""
    fake_cards(monkeypatch, 2)
    assert Device("cuda") == Device("tpu") == Device("gpu:1") == Device(1)
    assert Device("cuda") != Device("cpu")
    assert Device("gpu:1").torch_device == torch.device("cuda", 1)
    assert Device(torch.device("cuda", 1)).device_id == 1
    assert Device(torch.device("cpu")) == Device("cpu")
    assert repr(Device("tpu:1")) == "Device(type='cuda', index=1)"
    assert Device("cuda").xp is torch and Device("cpu").xp is np
    assert Device("cpu").device == "cpu"
    with pytest.raises(RuntimeError, match="Bad device index"):
        Device("cuda:3").torch_device
    with pytest.raises(ValueError, match="Bad device index"):
        cuda.set_device(2)
    cuda.set_device(1)
    try:
        assert cuda.current_device() == 1
    finally:
        tdevice._current_accel_index = 0
    assert tdevice.resolve(Device("cpu")) == torch.device("cpu")


def test_tensor_device_roundtrip_matches_jax():
    for pkg in (pdt, jpdn):
        t = pkg.Tensor(np.ones(3))
        assert t.device == pkg.Device("cpu") and t.xp is np
        assert t.cpu() is t and t.to("cpu") is t
    t = pdt.Tensor(np.ones(3), device=Device("cpu"))
    assert t.torch.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            t.cuda()
        with pytest.raises(RuntimeError):
            pdt.Tensor(np.ones(3), device="cuda")


@pytest.mark.parametrize("pkg", [pdt, jpdn], ids=["port", "jax"])
def test_mixed_device_binary_op_raises_naming_both(pkg, monkeypatch):
    """A card is faked by relabelling one CPU tensor's device; the check
    runs before any arithmetic, in both packages."""
    import pydynet_tpu.device as jdev
    mod = tdevice if pkg is pdt else jdev
    monkeypatch.setattr(mod, "is_available", lambda: True)
    a, b = pkg.Tensor(np.ones(2)), pkg.Tensor(np.ones(2))
    b.device = pkg.Device("cuda")
    for op in (pkg.add, pkg.mul, pkg.maximum, pkg.matmul):
        with pytest.raises(RuntimeError, match="different devices") as e:
            op(a, b)
        assert "cpu" in str(e.value) and "index=0" in str(e.value)


def test_package_surface_matches_jax():
    missing = set(jpdn.__all__) - set(pdt.__all__)
    assert not missing, missing
    for name in ("Tensor", "Device", "Graph", "cuda", "wrap_pure",
                 "remat_pure", "Generator", "set_grad_enabled",
                 "is_grad_enable", "full"):
        assert hasattr(pdt, name)
    assert set(jpdn.cuda.__all__) == set(pdt.cuda.__all__)
    assert pdt.nn.Parameter is not None and pdt.nn.Module is not None


# ------------------------------------------------------------- Module names
def test_module_move_set_module_state_and_to_device():
    from pydynet_tpu import nn as jnn
    from pydynet_tpu_torch import nn as tnn
    from pydynet_tpu_torch.models.clip import CLIP
    from pydynet_tpu_torch.models.llama import Llama

    net = tnn.Sequential(tnn.Linear(3, 4), tnn.ReLU(), tnn.Linear(4, 2))
    jnet = jnn.Sequential(jnn.Linear(3, 4), jnn.ReLU(), jnn.Linear(4, 2))
    assert [n for n, _ in net.named_parameters()] == [
        n for n, _ in jnet.named_parameters()]
    w = net[0].weight
    net.set_module_state(False)
    assert not any(m.training for m in net.modules())
    assert torch.is_grad_enabled() and pdt.is_grad_enable()
    net.set_module_state(True)
    assert all(m.training for m in net.modules())
    net.move("cpu")
    assert net.to(Device("cpu")) is net and net[0].weight is w
    net.move(Device(None))
    assert net[0].weight is w
    tiny = Llama(vocab_size=64, embed_dim=16, n_heads=2, ffn_dim=32,
                 max_seq_len=8, n_layers=1, device="cpu")
    for m in (tiny, CLIP.__mro__[0]):
        for name in ("move", "set_module_state"):
            assert callable(getattr(m, name))
    tiny.set_module_state(False)
    assert not tiny.layers[0].attention.training
    tiny.to(Device("cpu"))


def test_rmsnorm_reset_parameters_gives_ones_like_jax():
    from pydynet_tpu import nn as jnn
    from pydynet_tpu_torch import nn as tnn

    t, j = tnn.RMSNorm(6), jnn.RMSNorm(6)
    with torch.no_grad():
        t.weight.mul_(3.0)
    j.weight.data = j.weight.numpy() * 3.0
    t.reset_parameters()
    j.reset_parameters()
    np.testing.assert_array_equal(t.weight.detach().numpy(),
                                  j.weight.numpy())
    assert t.weight.detach().numpy().tolist() == [1.0] * 6


def test_lora_merge_and_delta_array_under_jax_names():
    from pydynet_tpu import nn as jnn
    from pydynet_tpu_torch import nn as tnn
    from pydynet_tpu_torch.nn.modules.lora import LoRALinear

    np.random.seed(0)
    jl = jnn.LoRALinear(jnn.Linear(5, 3), r=2, alpha=4.0)
    jl.lora_B.data = np.random.randn(2, 3)
    tl = LoRALinear(tnn.Linear(5, 3, dtype=torch.float64), r=2, alpha=4.0)
    with torch.no_grad():
        for name in ("weight", "bias", "lora_A", "lora_B"):
            getattr(tl, name).copy_(torch.from_numpy(
                getattr(jl, name).numpy()))
    np.testing.assert_array_equal(tl.delta_array().numpy(),
                                  np.asarray(jl.delta_array()))
    assert tl.delta is not None and tl.merge is not None
    jm, tm = jl.merge_(), tl.merge_()
    np.testing.assert_array_equal(tm.weight.detach().numpy(),
                                  jm.weight.numpy())
    assert isinstance(tm, tnn.Linear) and tm.weight is tl.weight


def test_parameter_of_a_tape_tensor_is_a_copy():
    t = pdt.Tensor(np.arange(3.0))
    p = pdt.nn.Parameter(t)
    assert isinstance(p, torch.nn.Parameter) and p.requires_grad
    assert isinstance(p, pdt.nn.Parameter)
    assert isinstance(torch.nn.Parameter(torch.ones(1)), pdt.nn.Parameter)
    with torch.no_grad():
        p -= 1
    assert t.numpy().tolist() == [0, 1, 2]
    assert p.detach().numpy().tolist() == [-1, 0, 1]
