"""LoRA in the port (``nn/modules/lora.py``, ``Llama.add_lora`` /
``merge_lora``, the decode snapshots' fold, adapter files, ``finetune
--lora``) against the JAX package on the CPU: ``tests/test_lora.py``'s
Llama and generic-module cases, each run on both packages with the same
weights (``params_from_tpu``; adapters cross with ``swap_linear``).

Float32 throughout. Losses agree to 1e-5 relative, dropout masks bit for
bit (both draw from the threefry ``Generator``), greedy streams token for
token; the port's merged and unmerged streams are bit-identical on every
decode lane.
"""
import functools

import numpy as np
import pytest
import torch

import pydynet_tpu as pdn
from pydynet_tpu import nn as jnn
from pydynet_tpu import optim as joptim
from pydynet_tpu.models.llama import io as jio
from pydynet_tpu.models.llama.model import Llama as JLlama
from pydynet_tpu.models.llama.serve import LlamaServer as JServer
from pydynet_tpu.nn.modules import lora as jlora
from pydynet_tpu.ops import decode_step as jdsk

import pydynet_tpu_torch as pdt
from pydynet_tpu_torch import nn as tnn
from pydynet_tpu_torch import optim as toptim
from pydynet_tpu_torch.models.llama import Llama, params_from_tpu
from pydynet_tpu_torch.models.llama import io as tio
from pydynet_tpu_torch.models.llama.convert import params_to_tpu
from pydynet_tpu_torch.models.llama.serve import LlamaServer
from pydynet_tpu_torch.nn.modules.lora import (LoRALinear, apply_lora,
                                               lora_state_names, merge_lora)

torch.set_num_threads(1)  # six test workers share the CPU: one thread each

# a size both packages' fused kernels take (tests/test_torch_serve.py's)
CFG = dict(vocab_size=256, embed_dim=32, n_heads=2, ffn_dim=64,
           max_seq_len=64, max_batch_size=2, n_layers=2)
INP = np.array([[1, 5, 9, 4, 7, 2]])
TGT = np.array([[5, 9, 4, 7, 2, 3]])
ALL = ("Q", "K", "V", "O", "gate", "up", "down", "lm_head")


def twins(seed=0, r=4, alpha=8.0, targets=("Q", "V"), dropout=0.0,
          b_scale=None):
    """A seeded JAX Llama with adapters and its port with the same base
    weights and adapters (``A`` carried; with ``b_scale`` a non-zero ``B``
    drawn from a seeded NumPy stream, the same in both)."""
    np.random.seed(seed)
    jm = JLlama(dtype=np.float32, **CFG)
    tm = Llama(**CFG, device="cpu")
    tm.load_state_dict(params_from_tpu(
        {n: p.numpy() for n, p in jm._parameters.items()}), strict=True)
    jm.add_lora(r=r, alpha=alpha, targets=targets, dropout=dropout)
    tm.add_lora(r=r, alpha=alpha, targets=targets, dropout=dropout)
    rng = np.random.default_rng(seed)
    for name in jlora.lora_state_names(jm):
        p = jm._parameters[name]
        if b_scale is not None and name.endswith("lora_B"):
            p.data = (rng.standard_normal(p.shape) * b_scale).astype(
                np.float32)
    carry(jm, tm)
    return jm, tm


def carry(jm, tm):
    """Copy the JAX model's adapters into the port's."""
    names = jlora.lora_state_names(jm)
    missing, _ = tm.load_state_dict(params_from_tpu(
        {n: jm._parameters[n].numpy() for n in names}), strict=False)
    assert set(lora_state_names(tm)) == set(names)
    assert not set(names) & set(missing)
    jm._weights_cache.clear()
    tm._weights_cache.clear()


def stream(gen):
    return [int(t.numpy()[0, 0]) for t in gen]


def train_both(jm, tm, steps, lr=1e-2, seed=5):
    """``steps`` Adam fine-tune steps on both packages from one seed;
    returns (JAX losses, port losses)."""
    pdn.manual_seed(seed)
    pdt.manual_seed(seed)
    jopt = joptim.Adam(jm.parameters(), lr=lr)
    topt = toptim.Adam([p for p in tm.parameters() if p.requires_grad],
                       lr=lr)
    jl = [jm.finetune_step(INP, TGT, jopt) for _ in range(steps)]
    tl = [tm.finetune_step(INP, TGT, topt) for _ in range(steps)]
    return jl, tl


# ------------------------------ module level ------------------------------
@pytest.mark.parametrize("layout", ["jax", "torch"])
def test_lora_linear_identity_at_init(layout):
    """A fresh adapter (B = 0) leaves the output bit-identical; the base
    parameters keep their names and are frozen; the adapters train, in
    the wrapped Linear's layout."""
    torch.manual_seed(1)
    base = (tnn.Linear(12, 7) if layout == "jax"
            else torch.nn.Linear(12, 7))
    x = torch.randn(5, 12)
    y0 = base(x)
    wrapped = LoRALinear(base, r=3, alpha=6.0).eval()
    assert torch.equal(wrapped(x), y0)
    assert dict(wrapped.named_parameters()).keys() == {
        "weight", "bias", "lora_A", "lora_B"}
    assert not wrapped.weight.requires_grad
    assert wrapped.lora_A.requires_grad and wrapped.lora_B.requires_grad
    shapes = ((12, 3), (3, 7)) if layout == "jax" else ((3, 12), (7, 3))
    assert (tuple(wrapped.lora_A.shape), tuple(wrapped.lora_B.shape)) \
        == shapes
    # A's kaiming bound, the JAX package's init (relu gain): sqrt(6 / in)
    # in both layouts
    assert float(wrapped.lora_A.abs().max()) <= np.sqrt(6 / 12)


@pytest.mark.parametrize("layout", ["jax", "torch"])
def test_lora_linear_forward_matches_jax_and_manual(layout):
    """With the JAX LoRALinear's weights, A and a non-zero B carried over,
    the port's forward equals the JAX package's and the manual formula."""
    np.random.seed(2)
    jbase = jnn.Linear(9, 5, bias=False)
    jl = jlora.LoRALinear(jbase, r=2, alpha=4.0)
    jl.lora_B.data = np.random.randn(2, 5).astype(np.float32)
    W, A, B = (p.numpy() for p in (jl.weight, jl.lora_A, jl.lora_B))
    if layout == "jax":
        base = tnn.Linear(9, 5, bias=False)
        tl = LoRALinear(base, r=2, alpha=4.0)
        vals = (W, A, B)
    else:
        base = torch.nn.Linear(9, 5, bias=False)
        tl = LoRALinear(base, r=2, alpha=4.0)
        vals = (W.T, A.T, B.T)
    with torch.no_grad():
        for p, v in zip((tl.weight, tl.lora_A, tl.lora_B), vals):
            p.copy_(torch.from_numpy(np.ascontiguousarray(v)))
    x = np.random.randn(3, 9).astype(np.float32)
    want = x @ W + (x @ A @ B) * 2.0
    got = tl(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, jl(pdn.Tensor(x)).numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("targets", [("Q", "V"), ALL])
def test_apply_lora_names_counts_and_freeze(targets):
    """Adapter names equal the JAX package's; the trainable count equals
    its, the frozen count is its minus its 2 * n_layers KV caches and two
    RoPE tables (Parameters there, buffers here:
    ``Llama.set_trainable_parameters``); only the adapters train."""
    np.random.seed(0)
    jm = JLlama(dtype=np.float32, **CFG)
    tm = Llama(**CFG, device="cpu")
    n_before = len(list(tm.parameters()))
    jt, jf = jm.add_lora(r=4, alpha=8.0, targets=targets)
    tt, tf = tm.add_lora(r=4, alpha=8.0, targets=targets)
    assert tt == jt == 2 * (len(targets) - ("lm_head" in targets)) * 2 \
        + 2 * ("lm_head" in targets)
    assert tf == jf - (2 * CFG["n_layers"] + 2) == n_before
    names = lora_state_names(tm)
    assert sorted(names) == sorted(jlora.lora_state_names(jm))
    assert "layers.0.attention.Q.lora_A" in names
    P = dict(tm.named_parameters())
    assert not P["layers.0.attention.Q.weight"].requires_grad
    assert all(p.requires_grad == (n in names) for n, p in P.items())
    with pytest.raises(ValueError, match="no Linear matched"):
        Llama(**CFG, device="cpu").add_lora(targets=("nothing",))


# ---------------------------- training, decode ----------------------------
@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_lora_finetune_trajectory_matches_jax(dropout):
    """12 Adam steps on carried base weights, A and a non-zero B: the loss
    trajectory equals the JAX package's within 1e-5 relative (at dropout
    0.1 the masks are JAX's, bit for bit), the base weights stay
    bit-unchanged and the adapters move."""
    jm, tm = twins(targets=("Q", "V", "O", "down"), dropout=dropout,
                   b_scale=0.1)
    base = {n: p.detach().clone() for n, p in tm.named_parameters()
            if n not in lora_state_names(tm)}
    b0 = tm.layers[0].attention.Q.lora_B.detach().clone()
    jl, tl = train_both(jm, tm, 12)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    for n, p in tm.named_parameters():
        if n in base:
            assert torch.equal(p, base[n]), n
    assert not torch.equal(tm.layers[0].attention.Q.lora_B, b0)
    np.testing.assert_allclose(
        tm.layers[0].attention.Q.lora_B.detach().numpy().T,
        jm._parameters["layers.0.attention.Q.lora_B"].numpy(), atol=1e-5)


@pytest.fixture
def interp_kernels(monkeypatch):
    """The JAX package's fused kernels in interpret mode."""
    for name in ("fused_decode_token", "fused_decode_token_batched"):
        monkeypatch.setattr(jdsk, name, functools.partial(
            getattr(jdsk, name), interpret=True))


def port_streams(tm, ids):
    """The port's greedy streams on every decode lane: generate on the
    fused lane (K1's plain version), the scan lane and the int8, int4 and
    int8-head snapshots, and two servers, fused and scan."""
    out = {"fused": stream(tm.generate(ids, 20, chunk=4, fused=True)),
           "scan": stream(tm.generate(ids, 20, chunk=4, fused=False))}
    for q in ("int8", "int4", "int8-head"):
        out[q] = stream(tm.generate(ids, 20, chunk=4, fused=False, quant=q))
    for lane in ("fused", "xla"):
        srv = LlamaServer(tm, batch_size=2, chunk=4, eos_id=-1, lane=lane)
        rids = [srv.submit(p, max_new_tokens=10) for p in ([1, 5, 9],
                                                           [2, 7])]
        done = srv.run()
        out["serve-" + lane] = [done[r].tokens for r in rids]
    return out


def test_lora_decode_folds_delta_matches_jax_and_merge_is_exact(
        interp_kernels):
    """After 6 steps on Q, V and O adapters, every decode lane of the port
    equals the JAX package's stream token for token, differs from the base
    model's, and is bit-identical after ``merge_lora``."""
    jm, tm = twins(targets=("Q", "V", "O"))
    train_both(jm, tm, 6, lr=5e-2)
    jm.eval()
    tm.eval()
    ids = np.array([[1, 5, 9]])
    got = port_streams(tm, ids)
    with pdn.no_grad():
        want = {"fused": stream(jm.generate(ids, 20, chunk=4, fused=True)),
                "scan": stream(jm.generate(ids, 20, chunk=4, fused=False))}
        for q in ("int8", "int4", "int8-head"):
            want[q] = stream(jm.generate(ids, 20, chunk=4, fused=False,
                                         quant=q))
        for lane in ("fused", "xla"):
            srv = JServer(jm, batch_size=2, chunk=4, eos_id=-1, lane=lane)
            rids = [srv.submit(p, max_new_tokens=10) for p in ([1, 5, 9],
                                                               [2, 7])]
            done = srv.run()
            want["serve-" + lane] = [done[r].tokens for r in rids]
    assert got == want
    np.random.seed(0)
    base = Llama(**CFG, device="cpu")
    base.load_state_dict(params_from_tpu(
        {n: p.numpy() for n, p in JLlama(dtype=np.float32,
                                         **CFG)._parameters.items()}))
    assert stream(base.eval().generate(ids, 20, fused=False)) != got["scan"]
    assert tm.merge_lora() == 6 and not lora_state_names(tm)
    assert type(tm.layers[0].attention.Q) is torch.nn.Linear
    assert port_streams(tm, ids) == got


def test_lora_eager_forward_matches_decode_fold():
    """The eager module path (base plus the low-rank term) and the scan
    lane's folded weights agree within 2e-4, and the eager logits equal the
    JAX package's."""
    jm, tm = twins(r=3, alpha=6.0, b_scale=0.1)
    jm.eval()
    tm.eval()
    ids = np.array([[1, 5, 9, 2]])
    with torch.no_grad():
        eager = tm.forward_logits(ids, 0).numpy()
        w = tm._weights()
        ck, cv = tm._empty_caches(1, w["tok"].dtype)
        folded = tm.forward_logits_one(
            w, ck, cv, torch.as_tensor(ids), 0, all_positions=True).numpy()
    np.testing.assert_allclose(folded, eager, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(
        eager, jm.forward_logits(pdn.Tensor(ids), 0).numpy(), rtol=1e-5,
        atol=1e-5)


def test_lora_adapter_files_cross_between_packages(tmp_path):
    """``save_finetuned_parameters`` of a LoRA model writes the adapters
    only, in the JAX package's layout; a file written by either package
    loads into the other, which then decodes the writer's stream."""
    jm, tm = twins()
    train_both(jm, tm, 4, lr=5e-2)
    tio.save_finetuned_parameters(tm, str(tmp_path / "port.npz"))
    jio.save_finetuned_parameters(jm, str(tmp_path / "jax.npz"))
    with np.load(tmp_path / "port.npz") as a, \
            np.load(tmp_path / "jax.npz") as b:
        assert set(a.files) == set(b.files) == set(lora_state_names(tm))
        for n in a.files:
            assert a[n].shape == b[n].shape
            np.testing.assert_allclose(a[n], b[n], atol=1e-5, err_msg=n)
    ids = np.array([[1, 5, 9]])
    jm.eval()
    tm.eval()
    with pdn.no_grad():
        jwant = stream(jm.generate(ids, 18, chunk=4, fused=False))
    twant = stream(tm.generate(ids, 18, chunk=4, fused=False))
    fresh_j, fresh_t = twins()  # the same base weights, fresh adapters
    jio.load_finetuned_parameters(fresh_j, str(tmp_path / "port.npz"))
    tio.load_finetuned_parameters(fresh_t, str(tmp_path / "jax.npz"))
    fresh_j.eval()
    with pdn.no_grad():
        assert stream(fresh_j.generate(ids, 18, chunk=4, fused=False)) \
            == twant
    assert stream(fresh_t.eval().generate(ids, 18, chunk=4, fused=False)) \
        == jwant


def test_apply_merge_on_generic_module():
    """``apply_lora`` and ``merge_lora`` on the nn stack's own Linears
    (JAX layout) inside ``torch.nn.ModuleList``s, against the JAX package
    with the same weights and adapters: names, outputs before and after the
    merge."""
    np.random.seed(3)

    def net_of(module, linear, module_list):
        class Block(module):
            def __init__(self):
                super().__init__()
                self.proj = linear(8, 8)
                self.out = linear(8, 4)

            def forward(self, x):
                return self.out(self.proj(x))

        class Net(module):
            def __init__(self):
                super().__init__()
                self.blocks = module_list([Block(), Block()])

        return Net()

    jnet = net_of(jnn.Module, jnn.Linear, jnn.ModuleList)
    tnet = net_of(torch.nn.Module, tnn.Linear, torch.nn.ModuleList)
    assert jlora.apply_lora(jnet, r=2, targets=("proj",)) == 2
    assert apply_lora(tnet, r=2, targets=("proj",)) == 2
    assert "blocks.0.proj.lora_A" in dict(tnet.named_parameters())
    with pdn.no_grad():
        for name, p in jnet._parameters.items():
            if name.endswith("lora_B"):
                p.data = np.random.randn(*p.shape).astype(np.float32)
    with torch.no_grad():
        for name, p in tnet.named_parameters():
            p.copy_(torch.from_numpy(jnet._parameters[name].numpy()))
    jnet.eval()
    tnet.eval()
    x = np.random.randn(2, 8).astype(np.float32)
    y1 = tnet.blocks[0](torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(y1, jnet.blocks[0](pdn.Tensor(x)).numpy(),
                               rtol=1e-5, atol=1e-5)
    assert merge_lora(tnet) == 2 and jlora.merge_lora(jnet) == 2
    assert "blocks.0.proj.lora_A" not in dict(tnet.named_parameters())
    assert type(tnet.blocks[0].proj) is tnn.Linear
    with torch.no_grad():
        y2 = tnet.blocks[0](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y2, y1, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y2, jnet.blocks[0](pdn.Tensor(x)).numpy(),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------- CLI -----------------------------------
def test_finetune_cli_lora_matches_jax(tmp_path, capsys, monkeypatch):
    """``finetune --lora 4 --lora-targets Q,V --lora-dropout 0.1`` on one
    stories15M-shaped weights file in both packages: the same trainable
    count (the frozen one smaller by the JAX package's 14 cache and RoPE
    Parameters), the same step-1 loss (B is zero at init), and the same
    saved names and shapes. The checkpoint has no ``lm_head.bias``: each
    package keeps its own random one, so the JAX model is given the port's
    to make the two models equal."""
    from llm.llama import finetune as jft
    from pydynet_tpu_torch.models.llama import finetune, infer

    src = Llama(infer.VOCAB_SIZE, infer.DIM, infer.N_HEADS, infer.FFN_DIM,
                infer.MAX_SEQ_LEN, infer.MAX_BATCH, infer.N_LAYERS,
                device="cpu",
                generator=torch.Generator().manual_seed(infer.WEIGHTS_SEED))
    P = params_to_tpu(dict(src.named_parameters()))
    hf = {"model.embed_tokens.weight": P["tok_embedding.weight"],
          "lm_head.weight": P["lm_head.weight"].T,
          "model.norm.weight": P["norm.weight"]}
    names = {"self_attn.q_proj": "attention.Q", "self_attn.k_proj":
             "attention.K", "self_attn.v_proj": "attention.V",
             "self_attn.o_proj": "attention.O", "mlp.up_proj": "ffn.up",
             "mlp.gate_proj": "ffn.gate", "mlp.down_proj": "ffn.down"}
    for i in range(infer.N_LAYERS):
        for theirs, ours in names.items():
            hf[f"model.layers.{i}.{theirs}.weight"] = \
                P[f"layers.{i}.{ours}.weight"].T
        hf[f"model.layers.{i}.input_layernorm.weight"] = \
            P[f"layers.{i}.input_norm.weight"]
        hf[f"model.layers.{i}.post_attention_layernorm.weight"] = \
            P[f"layers.{i}.post_attn_norm.weight"]
    path = tmp_path / "s15m.npz"
    np.savez(path, **hf)
    real_load = jft.load_model

    def load_with_port_bias(model, weights):
        model = real_load(model, weights)
        model._parameters["lm_head.bias"].data = P["lm_head.bias"]
        return model

    monkeypatch.setattr(jft, "load_model", load_with_port_bias)
    flags = ["--weights", str(path), "--steps", "1", "--lr", "1e-3",
             "--text", "Once upon a time", "--lora", "4", "--lora-targets",
             "Q,V", "--lora-dropout", "0.1"]
    capsys.readouterr()
    jft.main(flags + ["--no-cuda", "--save", str(tmp_path / "j.npz")])
    jout = capsys.readouterr().out
    finetune.main(flags + ["--device", "cpu", "--save",
                           str(tmp_path / "t.npz")])
    tout = capsys.readouterr().out

    def parse(out):
        counts = next(ln for ln in out.splitlines()
                      if ln.startswith("Trainable params"))
        t, f = (int(v.split(": ")[1]) for v in counts.split(", "))
        loss = next(float(ln.split("loss=")[1]) for ln in out.splitlines()
                    if ln.startswith("step=0001"))
        return t, f, loss

    (jt, jf, jloss), (tt, tf, tloss) = parse(jout), parse(tout)
    assert tt == jt == 24 and tf == jf - (2 * infer.N_LAYERS + 2) == 58
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "t.npz") as b:
        assert {n: a[n].shape for n in a.files} == \
            {n: b[n].shape for n in b.files}
        assert len(a.files) == 24
