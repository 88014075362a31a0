"""The port's sharded checkpoint (``pydynet_tpu_torch/utils/
sharded_checkpoint.py``, on ``torch.distributed.checkpoint``) on the CPU:
one case for each test of ``tests/test_sharded_checkpoint.py``.

A ``jit(mesh=)`` train state over dp2 x tp2 (tp ``shard_rules``), saved,
trained on, restored in place and replayed, on 4 spawned gloo ranks
(``parallel._cases``, group ``"ckpt"``): the state and the replayed losses
bit for bit, the placements kept. The nets start from the JAX package's
initial weights, and the first losses are held against its unsharded
``jit`` within 1e-5 relative.
"""
import pickle

import numpy as np
import pytest
import torch

import pydynet_tpu as pdn
from pydynet_tpu import nn as jnn
from pydynet_tpu import optim as joptim
from pydynet_tpu.utils import checkpoint as jck

torch.set_num_threads(1)  # six test workers share the CPU: one thread each


def _jbuild(seed):
    np.random.seed(seed)
    net = jnn.Sequential(jnn.Linear(6, 16), jnn.Tanh(), jnn.Linear(16, 3))
    return net, joptim.Adam(net.parameters(), lr=1e-2)


def _w(seed):
    return {k: np.asarray(v, np.float32)
            for k, v in jck.state_dict(_jbuild(seed)[0]).items()}


def _jlosses(seed, X, Y, n):
    net, opt = _jbuild(seed)

    def step(x, y):
        opt.zero_grad()
        loss = pdn.nn.functional.mse_loss(net(x), y)
        loss.backward()
        opt.step()
        return loss

    js = pdn.jit(step, state=(net, opt))
    return [float(js(pdn.Tensor(X), pdn.Tensor(Y)).item()) for _ in range(n)]


def _data(seed):
    np.random.seed(seed)
    return np.random.randn(16, 6), np.random.randn(16, 3)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from pydynet_tpu_torch.parallel import _cases
    from pydynet_tpu_torch.parallel._dryrun import spawn

    tmp = tmp_path_factory.mktemp("ckpt")
    d = str(tmp)
    X, Y = _data(11)
    X2, Y2 = _data(12)
    inputs = {"round_trip": dict(W=_w(3), X=X, Y=Y, dir=d),
              "fresh_model": dict(W=_w(5), W2=_w(99), X=X2, Y=Y2, dir=d),
              "async_save": dict(W=_w(6), W2=_w(7), dir=d),
              "tree_resume": dict(dir=d), "strict_missing": dict(dir=d)}
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(inputs, f)
    spawn(_cases.run_group, 4, "ckpt", str(tmp / "in.pkl"),
          str(tmp / "out.pkl"), timeout=600)
    with open(tmp / "out.pkl", "rb") as f:
        return pickle.load(f)


def result(ranks, name):
    r = ranks[name]
    assert not (isinstance(r, dict) and "error" in r), r.get("error")
    return r


def close(got, want, rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= rtol * np.abs(want).max(), (got, want)


def test_sharded_round_trip_exact_resume(ranks):
    r = result(ranks, "round_trip")
    X, Y = _data(11)
    close(r["first"], _jlosses(3, X, Y, 3))
    assert r["step"] == 3
    for name, want in r["ref"].items():
        np.testing.assert_array_equal(r["restored"][name], want,
                                      err_msg=name)
    assert r["after"] == r["placement"]
    assert r["placement"][0] == ["Replicate()", "Shard(dim=1)"]
    assert r["got_losses"] == r["ref_losses"]


def test_sharded_restore_into_fresh_model(ranks):
    r = result(ranks, "fresh_model")
    X, Y = _data(12)
    close(r["losses"], _jlosses(5, X, Y, 4))
    assert r["step"] == 4
    assert r["cont1"] == r["cont2"]
    assert r["losses"][-1] < r["losses"][0]


def test_sharded_async_save(ranks):
    r = result(ranks, "async_save")
    assert r["step"] == 1
    for n, a in r["a"].items():
        np.testing.assert_array_equal(r["b"][n], a, err_msg=n)


def test_sharded_tree_llama_spmd_resume(ranks):
    r = result(ranks, "tree_resume")
    assert r["same_placement"] and r["equal"]
    assert r["got"] == r["want"]


def test_sharded_strict_missing_param(ranks):
    r = result(ranks, "strict_missing")
    assert r["err"] and "missing parameter" in r["err"]
