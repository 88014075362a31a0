"""The port's mesh server (``pydynet_tpu_torch/parallel/serve_spmd.py``)
against the JAX package's, on the CPU: one case for each test of
``tests/test_serve_spmd.py``.

Each JAX ``Llama`` is built here from its seed and written as the JAX
package's ``.npz`` checkpoint; the spawned gloo ranks (``parallel._cases``,
group ``"serve"``, one spawn for the file) load it into the port's Llama
(transposed to torch's layout) and serve it through ``params_from_model``.
Greedy streams equal the JAX package's standalone ``generate(fused=False)``
token for token, and seeded sampled streams equal the JAX mesh server's.
"""
import pickle

import numpy as np
import pytest
import torch

import pydynet_tpu as pdn
from pydynet_tpu.models.llama.model import Llama
from pydynet_tpu.parallel import make_mesh
from pydynet_tpu.parallel.serve_spmd import SpmdLlamaServer
from pydynet_tpu.utils import checkpoint as jck

torch.set_num_threads(1)  # six test workers share the CPU: one thread each

CFG = dict(vocab_size=256, embed_dim=32, n_heads=4, ffn_dim=64,
           max_seq_len=64, max_batch_size=2, n_layers=2, dtype=np.float32)
PA = [1, 5, 9, 4, 7, 2, 8, 3, 6, 1, 2, 4]
PB = PA[:10] + [7, 5]
PROMPTS = [[1, 5, 9], [2, 7, 3, 11], [30, 20], [4, 4, 4, 4, 4]]
SEEDS = {"serve_dp2_tp2": (31, {}), "serve_dp4": (31, {}),
         "serve_tp4": (31, {}), "gqa": (32, {"n_kv_heads": 2}),
         "params_pair": (33, {}), "eos_truncation": (34, {}),
         "seeded_sampling": (35, {}), "quant_int8": (41, {}),
         "quant_int4": (41, {}), "prefix_cache": (42, {"max_seq_len": 128}),
         "quant_prefix": (43, {"max_seq_len": 128}),
         "mixed_fleet": (36, {}), "kv_quant": (44, {}),
         "kv_quant_quant_prefix": (45, {"max_seq_len": 128})}


def jmodel(name):
    seed, over = SEEDS[name]
    np.random.seed(seed)
    model = Llama(**dict(CFG, **over))
    model.eval()
    return model


def standalone(model, prompt, n_new, **kw):
    with pdn.no_grad():
        return [int(t.numpy()[0, 0])
                for t in model.generate(np.asarray([prompt]),
                                        len(prompt) + n_new, fused=False,
                                        **kw)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from pydynet_tpu_torch.parallel import _cases
    from pydynet_tpu_torch.parallel._dryrun import spawn

    tmp = tmp_path_factory.mktemp("serve")
    inputs = {}
    for name in SEEDS:
        path = str(tmp / f"{name}.npz")
        jck.save_checkpoint(path, jmodel(name))
        inputs[name] = {"ckpt": path}
    inputs["eos_truncation"]["eos"] = standalone(jmodel("eos_truncation"),
                                                 [5, 6], 1)[0]
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(inputs, f)
    spawn(_cases.run_group, 4, "serve", str(tmp / "in.pkl"),
          str(tmp / "out.pkl"), timeout=600)
    with open(tmp / "out.pkl", "rb") as f:
        return pickle.load(f)


def result(ranks, name):
    r = ranks[name]
    assert not (isinstance(r, dict) and "error" in r), r.get("error")
    return r


@pytest.mark.parametrize("name", ["serve_dp2_tp2", "serve_dp4",
                                  "serve_tp4"])
def test_spmd_server_matches_module_generate(ranks, name):
    """Mid-stream admission and slot recycling (B=2 on dp2 x tp2 and tp4,
    B=4 on dp4) against the JAX package's standalone greedy stream."""
    r = result(ranks, name)
    model = jmodel(name)
    want = [standalone(model, p, 8) for p in PROMPTS]
    assert r["tokens"] == want


def test_spmd_server_gqa(ranks):
    """Two KV heads over tp=4: each rank reads the groups of its heads."""
    r = result(ranks, "gqa")
    model = jmodel("gqa")
    assert r["tokens"] == [standalone(model, p, 6)
                           for p in ([1, 5, 9], [2, 7, 3])]


def test_spmd_server_params_pair_and_validation(ranks):
    r = result(ranks, "params_pair")
    assert r["tokens"] == standalone(jmodel("params_pair"), [3, 1, 4], 5)
    assert r["err"] and "divisible" in r["err"]


def test_spmd_server_eos_and_truncation(ranks):
    r = result(ranks, "eos_truncation")
    assert r["long"]["truncated"] == [True]
    assert len(r["long"]["tokens"][0]) == CFG["max_seq_len"] - 3 + 1
    assert r["eos"]["tokens"] == [[]]


def test_spmd_server_seeded_sampling_reproduces(ranks):
    """A seeded request's stream depends only on its prompt, parameters and
    seed: the same in two fleets, and the JAX mesh server's."""
    r = result(ranks, "seeded_sampling")
    assert r["a"] == r["b"] and len(r["a"]) == 8
    model = jmodel("seeded_sampling")
    with pdn.no_grad():
        srv = SpmdLlamaServer(model, make_mesh({"dp": 2, "tp": 2}),
                              batch_size=2, chunk=4, eos_id=-1, seed=0)
        rid = srv.submit([1, 6, 2], max_new_tokens=8, temperature=0.9,
                         top_k=17, top_p=0.95, seed=1234)
        done = srv.run()
    assert r["a"] == done[rid].tokens


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_spmd_server_quant_exact_across_meshes(ranks, quant):
    """Weight-only int8/int4 over dp2 x tp2 equals one device, and the JAX
    package's quantized mesh server."""
    r = result(ranks, "quant_" + quant)
    assert r["mesh"]["tokens"] == r["one"]["tokens"]
    assert all(len(t) == 8 for t in r["mesh"]["tokens"])
    model = jmodel("quant_" + quant)
    with pdn.no_grad():
        srv = SpmdLlamaServer(model, make_mesh({"dp": 1}), batch_size=2,
                              chunk=4, eos_id=-1, quant=quant)
        rids = [srv.submit(p, max_new_tokens=8) for p in PROMPTS[:3]]
        done = srv.run()
    assert r["mesh"]["tokens"] == [done[i].tokens for i in rids]


def test_spmd_server_prefix_cache_reuses_and_matches(ranks):
    r = result(ranks, "prefix_cache")
    assert r["prefix_hits"] == 1 and r["prefix_rows_reused"] == 8
    model = jmodel("prefix_cache")
    assert r["tokens"] == [standalone(model, PA, 6), standalone(model, PB, 6)]


def test_spmd_server_quant_prefix_compose(ranks):
    r = result(ranks, "quant_prefix")
    assert r["warm"]["prefix_hits"] == 1
    assert r["warm"]["tokens"][1] == r["cold"]["tokens"][0]


def test_spmd_server_mixed_fleet_greedy_rows_exact(ranks):
    r = result(ranks, "mixed_fleet")
    assert r["tokens"][1] == standalone(jmodel("mixed_fleet"),
                                        [2, 7, 3, 11], 8)


def test_spmd_server_kv_quant_matches_module_generate(ranks):
    r = result(ranks, "kv_quant")
    model = jmodel("kv_quant")
    assert r["tokens"] == [standalone(model, p, 6, kv_quant="int8")
                           for p in ([1, 5, 9], [2, 7, 3], [30, 20])]


def test_spmd_server_kv_quant_quant_prefix_compose(ranks):
    """int4 weights, the int8 KV cache and the prefix cache together: the
    reuse stream equals the same server's without reuse, and the JAX
    package's reuse stream."""
    r = result(ranks, "kv_quant_quant_prefix")
    assert r["warm"]["prefix_hits"] == 1
    assert r["warm"]["tokens"][1] == r["cold"]["tokens"][0]
    assert r["err"] and "kv_quant" in r["err"]
    model = jmodel("kv_quant_quant_prefix")
    with pdn.no_grad():
        srv = SpmdLlamaServer(model, make_mesh({"dp": 2, "tp": 2}),
                              batch_size=2, chunk=4, eos_id=-1,
                              quant="int4", kv_quant="int8",
                              prefix_cache=True)
        srv.submit(PA, max_new_tokens=6)
        srv.step()
        rb = srv.submit(PB, max_new_tokens=8)
        srv.run()
    assert r["warm"]["tokens"][1] == srv._finished[rb].tokens
