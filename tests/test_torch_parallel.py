"""The port's parallel package (``pydynet_tpu_torch/parallel``) and
``jit(mesh=)`` against the JAX package's, on the CPU: one case for each test
of ``tests/test_parallel.py``.

The port runs on 4 spawned gloo ranks (``parallel._dryrun.spawn``, a
``FileStore`` under ``tmp_path``: no TCP port), all of this file's cases in
one spawn (``parallel._cases``, group ``"parallel"``), and rank 0's results
come back through a pickle; a mesh of 2 ranks leaves ranks 2 and 3 out.
This process runs the JAX side on its virtual CPU devices at the same mesh
shape, or on one device where the JAX test holds its mesh against one
device. Both packages start from the same weights: ``llama_spmd.init_params``
draws the same NumPy stream, and the JAX nets' initial weights travel in the
inputs. Losses, logits and trained weights agree within 1e-5 relative,
greedy tokens and MoE routing exactly, ring attention within 1e-5 of the
dense attention, its gradient included.
"""
import pickle

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import pydynet_tpu as pdn
from pydynet_tpu import nn as jnn
from pydynet_tpu import optim as joptim
from pydynet_tpu.parallel import llama_spmd as jspmd
from pydynet_tpu.parallel import make_mesh as jmesh
from pydynet_tpu.parallel import moe as jmoe
from pydynet_tpu.parallel import pipeline as jpipe
from pydynet_tpu.parallel import shard as jshard
from pydynet_tpu.utils import checkpoint as jck

torch.set_num_threads(1)  # six test workers share the CPU: one thread each

N_RANKS = 4


def close(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= rtol * max(np.abs(want).max(), 1e-6), (err, got, want)


def _jbuild(seed, hidden=16):
    np.random.seed(seed)
    net = jnn.Sequential(jnn.Linear(6, hidden), jnn.Tanh(),
                         jnn.Linear(hidden, 3))
    opt = joptim.SGD(net.parameters(), lr=0.1, momentum=0.0, nesterov=False)
    return net, opt


def _jstep(net, opt):
    def step(x, y):
        opt.zero_grad()
        loss = pdn.nn.functional.mse_loss(net(x), y)
        loss.backward()
        opt.step()
        return loss
    return step


def _f32(state):
    return {k: np.asarray(v, np.float32) for k, v in state.items()}


def _jllama(seed=0):
    from pydynet_tpu.models.llama.model import Llama

    np.random.seed(seed)
    net = Llama(vocab_size=64, embed_dim=16, n_heads=2, ffn_dim=32,
                max_seq_len=16, max_batch_size=4, n_layers=2,
                dtype=np.float32)
    net.train(True)
    opt = joptim.Adam(net.parameters(), lr=1e-2)
    crit = jnn.CrossEntropyLoss()

    def step(inp, tgt):
        opt.zero_grad()
        logits = net.forward_logits(inp, 0)
        B, L, V = logits.shape
        loss = crit(logits.reshape(B * L, V), tgt)
        loss.backward()
        opt.step()
        return loss

    return net, opt, step


def _inputs(tmp):
    """What the ranks cannot make without JAX: the JAX nets' initial
    weights and the data they train on."""
    inp = {}
    np.random.seed(1)
    X, Y = np.random.randn(32, 6), np.random.randn(32, 3)
    inp["dp_jit"] = dict(W=_f32(jck.state_dict(_jbuild(0)[0])), X=X, Y=Y)
    np.random.seed(4)
    X, Y = np.random.randn(16, 6), np.random.randn(16, 3)
    np.random.seed(7)
    lin = jnn.Linear(6, 3)
    inp["non_batch_arg"] = dict(W=_f32(jck.state_dict(lin)), X=X, Y=Y,
                                cw=np.array([0.5, 1.0, 2.0]))
    np.random.seed(4)
    Xb, Yb = np.random.randn(5, 16, 6), np.random.randn(5, 16, 3)
    inp["foreach"] = dict(W=_f32(jck.state_dict(_jbuild(7)[0])), Xb=Xb,
                          Yb=Yb)
    np.random.seed(9)
    Xb, Yb = np.random.randn(4, 8, 6), np.random.randn(4, 8, 3)
    inp["foreach_tp"] = dict(W=_f32(jck.state_dict(_jbuild(2)[0])), Xb=Xb,
                             Yb=Yb)
    path = str(tmp / "llama.npz")
    jck.save_checkpoint(path, _jllama()[0])
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, 64, (4, 8)).astype(np.int64)
    targets = rng.randint(0, 64, (4 * 8,)).astype(np.int64)
    inp["module_tp"] = inp["opt_first"] = dict(ckpt=path, inp=tokens,
                                               tgt=targets)
    return inp


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from pydynet_tpu_torch.parallel import _cases
    from pydynet_tpu_torch.parallel._dryrun import spawn

    tmp = tmp_path_factory.mktemp("parallel")
    inputs = _inputs(tmp)
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(inputs, f)
    spawn(_cases.run_group, N_RANKS, "parallel", str(tmp / "in.pkl"),
          str(tmp / "out.pkl"), timeout=600)
    with open(tmp / "out.pkl", "rb") as f:
        res = pickle.load(f)
    res["_inputs"] = inputs
    return res


def result(ranks, name):
    r = ranks[name]
    assert not (isinstance(r, dict) and "error" in r), r.get("error")
    return r


# ----------------------------- jit(mesh=) ------------------------------ #
def test_data_parallel_jit_matches_single_device(ranks):
    r = result(ranks, "dp_jit")
    inp = ranks["_inputs"]["dp_jit"]
    net, opt = _jbuild(0)
    js = pdn.jit(_jstep(net, opt), state=(net, opt))
    want = [float(js(pdn.Tensor(inp["X"]), pdn.Tensor(inp["Y"])).item())
            for _ in range(5)]
    close(r["losses"], want)
    for n, p in net._parameters.items():
        close(r["params"][n], p.numpy())


def test_data_parallel_state_actually_sharded(ranks):
    placements, size, local = result(ranks, "dp_jit")["placement"]
    assert size == 4 and placements == ["Replicate()"] and local == (6, 16)


def test_mesh_jit_non_batch_arg_replicated(ranks):
    r = result(ranks, "non_batch_arg")
    inp = ranks["_inputs"]["non_batch_arg"]
    np.random.seed(7)
    net = pdn.nn.Linear(6, 3)
    opt = pdn.optim.SGD(net.parameters(), lr=0.1)

    def step(x, y, w):
        opt.zero_grad()
        loss = pdn.mean(pdn.square(net(x) - y) * w)
        loss.backward()
        opt.step()
        return loss

    js = pdn.jit(step, state=(net, opt))
    want = [float(js(pdn.Tensor(inp["X"]), pdn.Tensor(inp["Y"]),
                     pdn.Tensor(inp["cw"])).item()) for _ in range(3)]
    close(r["losses"], want)


def _jforeach(inp, seed):
    net, opt = _jbuild(seed)
    js = pdn.jit(_jstep(net, opt), state=(net, opt))
    return js.foreach(pdn.Tensor(inp["Xb"]),
                      pdn.Tensor(inp["Yb"])).numpy().reshape(-1), net


def test_foreach_composes_with_mesh(ranks):
    r = result(ranks, "foreach")
    want, net = _jforeach(ranks["_inputs"]["foreach"], 7)
    close(r["each"], r["loop"], 1e-6)
    close(r["each"], want)
    for n, p in net._parameters.items():
        close(r["params_each"][n], r["params_loop"][n], 1e-6)
        close(r["params_each"][n], p.numpy())
    assert r["placement"][1] == 4


def test_foreach_mesh_with_tp_shard_rules(ranks):
    r = result(ranks, "foreach_tp")
    want, net = _jforeach(ranks["_inputs"]["foreach_tp"], 2)
    close(r["losses"], want)
    for n, p in net._parameters.items():
        close(r["params"][n], p.numpy())
    placements, size, local = r["placement"]
    assert placements == ["Replicate()", "Shard(dim=1)"] and size == 4
    assert local == (6, 8)


# ----------------------------- llama_spmd ------------------------------ #
def _jtrain(axes, cfg, params, tokens, targets, lr, steps, remat=False):
    mesh = jmesh(axes)
    params = jspmd.shard_params(params, mesh)
    step = jspmd.make_train_step(mesh, cfg, lr=lr, remat=remat)
    tokens = jshard(np.asarray(tokens, np.int32), mesh, "dp", None)
    targets = jshard(np.asarray(targets, np.int32), mesh, "dp", None)
    out = []
    for _ in range(steps):
        params, loss = step(params, tokens, targets)
        out.append(float(loss))
    return out, params


def test_llama_spmd_remat_matches_no_remat(ranks):
    r = result(ranks, "remat")
    cfg = jspmd.config(vocab_size=64, dim=16, n_heads=2, ffn_dim=32,
                       n_layers=4, max_seq_len=16)
    rng = np.random.RandomState(0)
    tokens, targets = rng.randint(0, 64, (8, 8)), rng.randint(0, 64, (8, 8))
    want, _ = _jtrain({"dp": 2, "tp": 2}, cfg,
                      jspmd.init_params(np.random.RandomState(1), cfg),
                      tokens, targets, 1e-1, 3, remat=True)
    close(r["remat"], r["plain"], 1e-6)
    close(r["remat"], want)
    assert r["remat"][-1] < r["remat"][0]


def test_mesh_helpers(ranks):
    r = result(ranks, "mesh_helpers")
    assert r["shape"] == {"dp": 2, "tp": 2}
    assert r["local"] == (4, 2)
    assert r["placements"] == ["Shard(dim=0)", "Replicate()"]
    np.testing.assert_array_equal(r["whole"], np.arange(16.0).reshape(8, 2))
    assert r["err"] and "needs 99 devices" in r["err"]


def test_hybrid_mesh_helpers(ranks):
    r = result(ranks, "hybrid_mesh")
    assert r["names"] == ("pp", "tp", "dp")
    assert r["shape"] == {"pp": 1, "tp": 2, "dp": 2}
    assert r["local"] == (4, 2)
    assert r["errs"]["dcn"][0] == "ValueError" \
        and "multi-process" in r["errs"]["dcn"][1]
    assert r["errs"]["dup"][0] == "ValueError" \
        and "duplicate" in r["errs"]["dup"][1]
    assert r["errs"]["claim"][0] == "RuntimeError" \
        and "before the process group" in r["errs"]["claim"][1]


def test_llama_spmd_train_step_loss_decreases(ranks):
    r = result(ranks, "train_loss")
    cfg = jspmd.config(vocab_size=64, dim=16, n_heads=2, ffn_dim=32,
                       n_layers=2, max_seq_len=16)
    rng = np.random.RandomState(0)
    params = jspmd.init_params(rng, cfg)
    tokens, targets = rng.randint(0, 64, (8, 8)), rng.randint(0, 64, (8, 8))
    want, wparams = _jtrain({"dp": 2, "tp": 2}, cfg, params, tokens,
                            targets, 1e-1, 8)
    close(r["losses"], want)
    close(r["wq"], np.asarray(wparams["wq"]))
    close(r["tok"], np.asarray(wparams["tok"]))
    assert r["losses"][-1] < r["losses"][0]
    placements, size, local = r["wq_placement"]
    assert placements == ["Replicate()", "Shard(dim=2)"] \
        and local == (2, 16, 8)


def test_module_tp_rules_match_single_device(ranks):
    r = result(ranks, "module_tp")
    inp = ranks["_inputs"]["module_tp"]
    net, opt, step = _jllama()
    js = pdn.jit(step, state=(net, opt))
    want = [float(js(pdn.Tensor(inp["inp"]), pdn.Tensor(inp["tgt"])).item())
            for _ in range(4)]
    close(r["losses"], want)
    assert r["losses"][-1] < r["losses"][0]
    # torch Linears are (out, in): column-parallel Q shards dim 0
    placements, size, local = r["q"]
    assert placements == ["Replicate()", "Shard(dim=0)"] and local == (8, 16)
    for pname, (moment, param) in r["moments"].items():
        assert moment == param, pname
    assert r["moments"]["layers.0.attention.O.weight"][1][0] == \
        ["Replicate()", "Shard(dim=1)"]


def test_shard_rules_survive_optimizer_first_state_order(ranks):
    placements, _, local = result(ranks, "opt_first")["q"]
    assert placements == ["Replicate()", "Shard(dim=0)"] and local == (8, 16)


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2), (1, 1)])
def test_llama_spmd_generate_matches_single_device(ranks, dp, tp):
    got = result(ranks, f"generate_dp{dp}_tp{tp}")["tokens"]
    cfg = jspmd.config(vocab_size=64, dim=16, n_heads=2, ffn_dim=32,
                       n_layers=2, max_seq_len=32)
    rng = np.random.RandomState(3)
    params = jspmd.init_params(rng, cfg)
    prompt = rng.randint(0, 64, (2 * dp, 5)).astype(np.int32)
    mesh = jmesh({"dp": dp, "tp": tp})
    want = jspmd.generate(jspmd.shard_params(params, mesh), prompt, 9, mesh,
                          cfg)
    assert got.shape == (2 * dp, 9)
    np.testing.assert_array_equal(got, want)


def test_llama_spmd_generate_consistent_with_train_forward(ranks):
    r = result(ranks, "generate_vs_forward")
    cfg = jspmd.config(vocab_size=32, dim=16, n_heads=2, ffn_dim=32,
                       n_layers=2, max_seq_len=16)
    rng = np.random.RandomState(7)
    params = jspmd.init_params(rng, cfg)
    mesh = jmesh({"dp": 1, "tp": 2})
    prompt = rng.randint(0, 32, (1, 4)).astype(np.int32)
    want = jspmd.generate(jspmd.shard_params(params, mesh), prompt, 6, mesh,
                          cfg)
    np.testing.assert_array_equal(r["tokens"], r["chain"])
    np.testing.assert_array_equal(r["tokens"], want)
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        jspmd.generate(jspmd.shard_params(params, mesh), prompt, 14, mesh,
                       cfg)
    assert "exceeds max_seq_len" in r["err"]


def _jref_losses(cfg, params, tokens, targets):
    return _jtrain({"dp": 1, "tp": 1}, cfg, params, tokens, targets, 1e-1,
                   3)[0]


@pytest.mark.parametrize("name", ["pp4_m4", "pp2_m8", "dp2_pp2_m2"])
def test_pipeline_train_matches_single_device(ranks, name):
    r = result(ranks, "pipeline_" + name)
    cfg = jspmd.config(vocab_size=64, dim=16, n_heads=2, ffn_dim=32,
                       n_layers=4, max_seq_len=16)
    rng = np.random.RandomState(0)
    tokens, targets = rng.randint(0, 64, (8, 8)), rng.randint(0, 64, (8, 8))
    want = _jref_losses(cfg, jspmd.init_params(np.random.RandomState(1),
                                               cfg), tokens, targets)
    close(r["losses"], want)
    assert r["losses"][-1] < r["losses"][0]


@pytest.mark.parametrize("name", ["pp2_tp2_m4", "pp2_tp2_m2"])
def test_pipeline_tp_train_matches_single_device(ranks, name):
    r = result(ranks, "pipeline_" + name)
    cfg = jspmd.config(vocab_size=64, dim=16, n_heads=2, ffn_dim=32,
                       n_layers=4, max_seq_len=16)
    rng = np.random.RandomState(3)
    tokens, targets = rng.randint(0, 64, (8, 8)), rng.randint(0, 64, (8, 8))
    want = _jref_losses(cfg, jspmd.init_params(np.random.RandomState(4),
                                               cfg), tokens, targets)
    close(r["losses"], want)
    assert r["losses"][-1] < r["losses"][0]
    assert "Shard(dim=3)" in r["wq"], r["wq"]


@pytest.mark.parametrize("name,n_heads,n_kv_heads,tp", [
    ("h4_kv2_tp2", 4, 2, 2),   # kv group-sharded
    ("h4_kv1_tp2", 4, 1, 2),   # kv whole on each tp rank
    ("h8_kv2_tp4", 8, 2, 4),
])
def test_pipeline_tp_gqa_train_matches_single_device(ranks, name, n_heads,
                                                     n_kv_heads, tp):
    r = result(ranks, "pipeline_gqa_" + name)
    cfg = jspmd.config(vocab_size=64, dim=16 * n_heads // 4,
                       n_heads=n_heads, ffn_dim=32, n_layers=4,
                       max_seq_len=16, n_kv_heads=n_kv_heads)
    rng = np.random.RandomState(3)
    tokens, targets = rng.randint(0, 64, (8, 8)), rng.randint(0, 64, (8, 8))
    want = _jref_losses(cfg, jspmd.init_params(np.random.RandomState(4),
                                               cfg), tokens, targets)
    close(r["losses"], want)
    assert r["losses"][-1] < r["losses"][0]
    tp_dim = r["axes"].index("tp")
    assert r["wq"][tp_dim] == "Shard(dim=3)"
    if n_kv_heads % tp == 0:
        assert r["wk"][tp_dim] == "Shard(dim=3)", r["wk"]
    else:
        assert r["wk"][tp_dim] == "Replicate()", r["wk"]
    assert r["no_cfg"] and "cfg" in r["no_cfg"]


def test_pipeline_apply_identity_routing(ranks):
    got = result(ranks, "pipeline_identity")["got"]
    x = np.arange(12.0).reshape(6, 2)
    np.testing.assert_array_equal(got, x + 1111.0)


# -------------------------------- moe ---------------------------------- #
def _jrouting(params, x, capacity_factor=2.0):
    T, E = x.shape[0], params["wg"].shape[1]
    gates = jax.nn.softmax(jnp.asarray(x) @ params["wg"], axis=-1)
    eidx = jnp.argmax(gates, axis=-1)
    onehot = jax.nn.one_hot(eidx, E, dtype=jnp.float32)
    pos = jnp.sum((jnp.cumsum(onehot, 0) - onehot) * onehot, -1)
    keep = pos < jmoe.capacity(T, E, capacity_factor)
    return np.asarray(eidx), np.asarray(pos).astype(np.int64), \
        np.asarray(keep)


def test_moe_matches_per_token_reference(ranks):
    r = result(ranks, "moe_reference")
    rng = np.random.RandomState(0)
    params = jmoe.init_moe_params(rng, 4, 8, 16)
    x = jnp.asarray(rng.standard_normal((32, 8)), jnp.float32)
    out, aux = jmoe.moe_ffn(params, x)
    np.testing.assert_allclose(r["out"], r["ref"], atol=1e-5)
    close(r["out"], np.asarray(out))
    close(r["aux"], float(aux))
    e, pos, keep = _jrouting(params, x)
    np.testing.assert_array_equal(r["expert"], e)
    np.testing.assert_array_equal(r["pos"], pos)
    np.testing.assert_array_equal(r["keep"], keep)


def test_moe_capacity_drops_tokens(ranks):
    r = result(ranks, "moe_capacity")
    rng = np.random.RandomState(1)
    params = dict(jmoe.init_moe_params(rng, 4, 8, 16))
    params["wg"] = jnp.zeros_like(params["wg"])
    x = jnp.asarray(rng.standard_normal((16, 8)), jnp.float32)
    out, _ = jmoe.moe_ffn(params, x, capacity_factor=1.0)
    nz = np.any(r["out"] != 0, axis=-1)
    assert nz.sum() == r["capacity"] == jmoe.capacity(16, 4, 1.0)
    np.testing.assert_allclose(r["out"], r["ref"], atol=1e-5)
    close(r["out"], np.asarray(out))
    _, pos, keep = _jrouting(params, x, 1.0)
    np.testing.assert_array_equal(r["pos"], pos)
    np.testing.assert_array_equal(r["keep"], keep)


def test_moe_expert_parallel_matches_unsharded(ranks):
    r = result(ranks, "moe_expert_parallel")
    rng = np.random.RandomState(2)
    params = jmoe.init_moe_params(rng, 8, 8, 16)
    x = jnp.asarray(rng.standard_normal((64, 8)), jnp.float32)
    want, _ = jmoe.moe_ffn(params, x)
    close(r["out"], np.asarray(want))
    assert r["w1_local"] == (2, 8, 16)

    def loss(p, x):
        out, aux = jmoe.moe_ffn(p, x)
        return jnp.sum(out ** 2) + 0.01 * aux

    lv, g = jax.value_and_grad(loss)(params, x)
    close(r["loss"], float(lv))
    for k in ("wg", "w1", "w2"):
        assert np.abs(r["grads"][k]).max() > 0, k
        close(r["grads"][k], np.asarray(g[k]))


def test_graft_entry_dryrun(ranks):
    """The port's dry run of every axis (``parallel._dryrun.run``) on the 4
    ranks."""
    assert result(ranks, "dryrun")["line"].endswith("OK")


# ---------------------------- ring attention --------------------------- #
@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_dense(ranks, causal):
    from pydynet_tpu.ops import flash_attention as fa
    from pydynet_tpu.parallel import ring_attention

    r = result(ranks, f"ring_causal_{causal}")
    rng = np.random.default_rng(0)
    q, k, v = (jnp.asarray(rng.standard_normal((2, 64, 2, 16)).astype(
        np.float32)) for _ in range(3))
    L = 64
    mask = jnp.where(jnp.arange(L)[:, None] >= jnp.arange(L)[None, :], 0.0,
                     -jnp.inf) if causal else None
    want = np.asarray(fa.mha_reference(q, k, v, mask))
    assert np.abs(r["out"] - want).max() <= 1e-5
    mesh = jmesh({"sp": 4})
    jring = ring_attention(*(jshard(a, mesh, None, "sp") for a in (q, k, v)),
                           mesh, causal=causal)
    assert np.abs(r["out"] - np.asarray(jring)).max() <= 1e-5
    assert r["placements"] == ["Shard(dim=1)"]


def test_ring_attention_under_jit_and_grad(ranks):
    from pydynet_tpu.ops import flash_attention as fa
    from pydynet_tpu.parallel import ring_attention

    r = result(ranks, "ring_grad")
    rng = np.random.default_rng(1)
    q = jnp.asarray(rng.standard_normal((1, 32, 2, 8)), jnp.float32)
    mesh = jmesh({"sp": 4})
    mask = jnp.where(jnp.arange(32)[:, None] >= jnp.arange(32)[None, :],
                     0.0, -jnp.inf)

    def loss(q):
        return jnp.sum(ring_attention(q, q, q, mesh, causal=True) ** 2)

    def dense(q):
        return jnp.sum(fa.mha_reference(q, q, q, mask) ** 2)

    g = np.asarray(jax.jit(jax.grad(loss))(q))
    gd = np.asarray(jax.grad(dense)(q))
    assert np.abs(r["grad"]).max() > 0
    close(r["grad"], g)
    close(r["grad"], gd)
    assert np.abs(r["out"] - np.asarray(
        fa.mha_reference(q, q, q, mask))).max() <= 1e-5


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2)])
def test_llama_spmd_gqa_generate_and_train(ranks, dp, tp):
    r = result(ranks, f"gqa_dp{dp}_tp{tp}")
    cfg = jspmd.config(vocab_size=64, dim=16, n_heads=4, n_kv_heads=2,
                       ffn_dim=32, n_layers=2, max_seq_len=32)
    rng = np.random.RandomState(5)
    params = jspmd.init_params(rng, cfg)
    prompt = rng.randint(0, 64, (2 * dp, 5)).astype(np.int32)
    mesh = jmesh({"dp": dp, "tp": tp})
    want = jspmd.generate(jspmd.shard_params(params, mesh), prompt, 9, mesh,
                          cfg)
    np.testing.assert_array_equal(r["tokens"], want)
    params2 = jspmd.init_params(rng, cfg)
    tokens = rng.randint(0, 64, (4 * dp, 8))
    losses, _ = _jtrain({"dp": dp, "tp": tp}, cfg, params2, tokens, tokens,
                        1e-2, 3)
    close(r["losses"], losses)
    assert r["losses"][-1] < r["losses"][0]


def test_params_to_torch_carries_the_jax_weights():
    """``params_to_torch`` of the JAX package's pytrees (the Llama
    parameters, their stage stacks, the MoE experts) is the port's own
    draw from the same seed, bit for bit: both packages compute from the
    same weights."""
    from pydynet_tpu_torch.parallel import llama_spmd, moe, pipeline

    cfg = jspmd.config(vocab_size=64, dim=16, n_heads=4, n_kv_heads=2,
                       ffn_dim=32, n_layers=4, max_seq_len=16)
    got = llama_spmd.params_to_torch(
        jspmd.init_params(np.random.RandomState(0), cfg))
    want = llama_spmd.init_params(np.random.RandomState(0), cfg)
    stages = llama_spmd.params_to_torch(jpipe.stack_stages(
        jspmd.init_params(np.random.RandomState(0), cfg), 2))
    mgot = llama_spmd.params_to_torch(
        jmoe.init_moe_params(np.random.RandomState(1), 4, 8, 16))
    mwant = moe.init_moe_params(np.random.RandomState(1), 4, 8, 16)
    for g, w in ((got, want), (stages, pipeline.stack_stages(want, 2)),
                 (mgot, mwant)):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k].numpy(), w[k].numpy(), k)


def test_jit_mesh_and_parallel_import_no_jax(tmp_path):
    """The parallel package and the rank bodies load no JAX (a spawned rank
    imports them without this file's conftest)."""
    import os
    import subprocess
    import sys

    code = ("import sys\n"
            "import pydynet_tpu_torch.parallel\n"
            "import pydynet_tpu_torch.parallel._cases\n"
            "import pydynet_tpu_torch.parallel._dryrun\n"
            "import pydynet_tpu_torch.utils\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'pydynet_tpu'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env=dict(os.environ, OMP_NUM_THREADS="1"))
