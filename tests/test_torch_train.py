"""The port's training path (``finetune_step``/``finetune_steps``, Adam,
clipping, finetuned npz IO, the finetune CLI) against the JAX package's, on
the CPU.

A tiny Llama (2 layers, dim 32, 2 heads, vocab 256) is built by the JAX
package from a seed and copied into the port with ``params_from_tpu``.
Sequences stay below 128 tokens: from 128 on, the JAX train path calls its
Pallas flash kernel outside interpret mode, which needs a TPU; below, it
takes its dense composite, and the port runs the plain versions of its
flash kernels. Losses are held to rtol 1e-5 and parameters to 1e-5.
"""
import numpy as np
import pytest
import torch

from pydynet_tpu import optim as joptim
from pydynet_tpu.models.llama import io as jio
from pydynet_tpu.models.llama.model import Llama as JLlama

from pydynet_tpu_torch import optim as toptim
from pydynet_tpu_torch.models.llama import Llama, params_from_tpu
from pydynet_tpu_torch.models.llama import io as tio
from pydynet_tpu_torch.models.llama.convert import params_to_tpu
from pydynet_tpu_torch.nn.modules.loss import CrossEntropyLoss
from pydynet_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)  # six test workers share the CPU: one thread each

TINY = dict(vocab_size=256, embed_dim=32, n_heads=2, ffn_dim=64,
            max_seq_len=32, max_batch_size=1, n_layers=2)
ALL = ("tok_embedding", "layers", "norm", "lm_head")
STEPS = 5


def pair(seed, L=12, B=1):
    ids = np.random.default_rng(seed).integers(0, 256, size=(B, L + 1))
    return ids[:, :-1], ids[:, 1:]


def models(seed=0, **over):
    """A JAX model from ``seed`` and the port's copy of it."""
    cfg = dict(TINY, **over)
    np.random.seed(seed)
    jm = JLlama(dtype=np.float32, **cfg)
    tm = Llama(**cfg, device="cpu")
    tm.load_state_dict(params_from_tpu(
        {n: p.numpy() for n, p in jm._parameters.items()}))
    return jm, tm


def port_adam(tm, **kw):
    return toptim.Adam([p for p in tm.parameters() if p.requires_grad], **kw)


def assert_params_close(jm, tm, atol=1e-5):
    want = params_from_tpu({n: p.numpy() for n, p in jm._parameters.items()})
    got = dict(tm.named_parameters())
    assert set(want) == set(got)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), w.numpy(),
                                   atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("clip", [None, 0.5], ids=["noclip", "clip"])
@pytest.mark.parametrize("trainable,n_kv", [(("lm_head",), None),
                                            (ALL, None), (ALL, 1)],
                         ids=["lm_head", "all", "all-gqa"])
def test_adam_trajectory_matches_jax(trainable, n_kv, clip):
    """Five Adam steps: the losses and the final parameters (frozen ones
    too) match the JAX package's finetune_step. With n_kv_heads=1 each K/V
    head serves both query heads, so the repeat's gradient is summed.

    Adam moves a weight by about lr * g / (|g| + eps / sqrt(1 - beta2^t)),
    so where |g| is near 3e-7 the two packages' gradients, which differ in
    summation order, give steps that differ by a share of lr itself (5.5e-6
    at lr 1e-3 in this model); lr 1e-4 keeps that well inside 1e-5."""
    jm, tm = models(1, n_kv_heads=n_kv)
    jm.set_trainable_parameters(trainable)
    tm.set_trainable_parameters(trainable)
    jopt = joptim.Adam(jm.parameters(), lr=1e-4)
    topt = port_adam(tm, lr=1e-4)
    inp, tgt = pair(2)
    jl = [jm.finetune_step(inp, tgt, jopt, clip_norm=clip)
          for _ in range(STEPS)]
    tl = [tm.finetune_step(inp, tgt, topt, clip_norm=clip)
          for _ in range(STEPS)]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    assert_params_close(jm, tm)


def test_train_path_runs_the_flash_op(monkeypatch):
    """Train mode with a causal mask at start_pos 0 goes through
    flash_attention_causal once a layer; eval mode does not."""
    calls = []
    real = tfa.flash_attention_causal
    monkeypatch.setattr(tfa, "flash_attention_causal",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    _, tm = models()
    tm.set_trainable_parameters(ALL)
    inp, tgt = pair(3, L=9)
    tm.finetune_step(inp, tgt, port_adam(tm))
    assert calls == [(1, 9, 2, 16)] * TINY["n_layers"]
    tm.eval()
    with torch.no_grad():
        tm.forward_logits(inp)
    assert len(calls) == TINY["n_layers"]


def test_sum_reduction_is_mean_times_tokens():
    _, tm = models()
    tm.set_trainable_parameters(("lm_head",))
    opt = port_adam(tm, lr=0.0)  # the weights never change
    inp, tgt = pair(4, L=10, B=2)
    mean = tm.finetune_step(inp, tgt, opt)
    total = tm.finetune_step(inp, tgt, opt,
                             criterion=CrossEntropyLoss(reduction="sum"))
    assert total == pytest.approx(mean * tgt.size, rel=1e-5)


def test_train_mode_start_pos_raises():
    _, tm = models()
    opt = port_adam(tm)
    inp, tgt = pair(5, L=4)
    with pytest.raises(ValueError, match="start_pos=2"):
        tm.finetune_step(inp, tgt, opt, start_pos=2)


def test_finetune_steps_equals_single_steps():
    """3 + 4 steps in two finetune_steps calls give the losses and weights
    of 7 finetune_step calls, and read nothing back: the losses come as a
    device tensor."""
    _, a = models()
    _, b = models()
    inp, tgt = pair(6)
    oa, ob = port_adam(a, lr=1e-2), port_adam(b, lr=1e-2)
    single = [a.finetune_step(inp, tgt, oa, sync=False) for _ in range(7)]
    assert all(isinstance(x, torch.Tensor) and x.shape == () for x in single)
    l3, l4 = b.finetune_steps(inp, tgt, ob, 3), b.finetune_steps(inp, tgt,
                                                                ob, 4)
    assert l3.shape == (3,) and l4.shape == (4,)
    np.testing.assert_array_equal(torch.cat([l3, l4]).numpy(),
                                  torch.stack(single).numpy())
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        np.testing.assert_array_equal(p.detach().numpy(),
                                      q.detach().numpy(), err_msg=name)


@pytest.mark.parametrize("prefixes", [("lm_head",), ("layers",), ALL])
def test_trainable_counts_differ_from_jax_by_its_buffers(prefixes):
    """The JAX package counts its caches (2 a layer) and RoPE tables (2) as
    parameters; the port keeps them as buffers."""
    jm, tm = models()
    jt, jf = jm.set_trainable_parameters(prefixes)
    tt, tf = tm.set_trainable_parameters(prefixes)
    caches = 2 * TINY["n_layers"] if "layers" in prefixes else 0
    assert (jt, jf) == (tt + caches, tf + 2 + 2 * TINY["n_layers"] - caches)
    names = {n for n, p in tm.named_parameters() if p.requires_grad}
    assert names == {n for n, p in jm._parameters.items()
                     if p.requires_grad and "cache" not in n}


def test_finetuned_npz_round_trips_across_packages(tmp_path):
    """Port -> JAX and JAX -> port through one file in the JAX layout, a
    path without its .npz found with it."""
    jm, tm = models()
    jm2, tm2 = models(seed=9)
    for m in (jm, tm, jm2, tm2):
        m.set_trainable_parameters(("lm_head", "norm", "layers.1.ffn"))
    tio.save_finetuned_parameters(tm, str(tmp_path / "port.npz"))
    with np.load(tmp_path / "port.npz") as f:
        assert f["lm_head.weight"].shape == (32, 256)  # JAX (in, out)
        assert set(f.files) == {n for n, p in tm.named_parameters()
                                if p.requires_grad}
    jio.load_finetuned_parameters(jm2, str(tmp_path / "port.npz"))
    jio.save_finetuned_parameters(jm, str(tmp_path / "jax.npz"))
    tio.load_finetuned_parameters(tm2, str(tmp_path / "jax"))
    names = [n for n, p in tm.named_parameters() if p.requires_grad]
    for name in names:
        np.testing.assert_array_equal(
            jm2._parameters[name].numpy(),
            params_to_tpu({name: dict(tm.named_parameters())[name]})[name])
        np.testing.assert_array_equal(
            dict(tm2.named_parameters())[name].detach().numpy(),
            params_from_tpu({name: jm._parameters[name].numpy()})[name])


def test_generate_follows_the_trained_weights():
    """Decode-weight snapshots built before a step (f32 and bf16, fused and
    plain lanes) are dropped: generate after training equals generate of a
    fresh model holding the trained weights, and differs from before."""
    _, tm = models()
    tm.set_trainable_parameters(ALL)
    prompt = np.array([[1, 5, 9]])
    before = {}
    for dtype in (None, torch.bfloat16):
        for fused in (None, False):
            before[dtype, fused] = [int(x) for x in tm.generate(
                prompt, 16, dtype=dtype, fused=fused)]
    pattern = np.array([[1, 5, 9, 7, 3, 200] * 4])
    tm.finetune_steps(pattern[:, :-1], pattern[:, 1:], port_adam(tm, lr=3e-2),
                      20)
    fresh = Llama(**TINY, device="cpu")
    fresh.load_state_dict(tm.state_dict())
    for (dtype, fused), old in before.items():
        new = [int(x) for x in tm.generate(prompt, 16, dtype=dtype,
                                           fused=fused)]
        assert new == [int(x) for x in fresh.generate(prompt, 16,
                                                      dtype=dtype,
                                                      fused=fused)]
        assert new != old


def test_finetune_cli_runs_on_cpu(tmp_path, capsys):
    from pydynet_tpu_torch.models.llama import finetune

    save = tmp_path / "out" / "ft.npz"
    losses = finetune.main(["--random-init", "--device", "cpu", "--steps",
                            "6", "--lr", "1e-3", "--text", "Once upon a time",
                            "--save", str(save), "--clip-norm", "1.0",
                            "--weights", str(tmp_path / "none.npz")])
    out = capsys.readouterr().out
    assert "Trainable params: 2, Frozen params: 56" in out
    assert [line.split(",")[0] for line in out.splitlines()
            if line.startswith("step=")] == ["step=0001", "step=0005",
                                              "step=0006"]
    assert len(losses) == 3 and losses[-1] < losses[0]
    with np.load(save) as f:
        assert set(f.files) == {"lm_head.weight", "lm_head.bias"}
    # --lora trains and saves the adapters only (tests/test_torch_lora.py
    # holds the run to the JAX CLI's)
    lora = tmp_path / "lora.npz"
    finetune.main(["--random-init", "--device", "cpu", "--steps", "2",
                   "--text", "Once upon a time", "--lora", "4",
                   "--save", str(lora), "--weights", str(tmp_path / "none")])
    assert "Trainable params: 24, Frozen params: 58" in capsys.readouterr().out
    with np.load(lora) as f:
        assert set(f.files) == {f"layers.{i}.attention.{m}.lora_{ab}"
                                for i in range(6) for m in "QV"
                                for ab in "AB"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            finetune.main(["--random-init", "--text", "x"])
