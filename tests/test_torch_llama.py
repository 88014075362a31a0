"""The PyTorch port's Llama against the JAX package's, on the CPU.

Weights come from a seeded JAX model and reach the port through
``params_from_tpu``, so both compute from the same numbers. The JAX fused
lane runs its Pallas kernel in interpret mode, as ``tests/test_llama.py``
does; the port's fused lane runs the kernel's plain version on the CPU.
"""
import functools

import numpy as np
import pytest
import torch

import pydynet_tpu as pdn
from pydynet_tpu.models.llama import io as jio
from pydynet_tpu.models.llama.model import Llama as JLlama
from pydynet_tpu.ops import decode_step as jdsk
from pydynet_tpu.utils import fidelity as jfid

from pydynet_tpu_torch.models.llama import Llama, params_from_tpu
from pydynet_tpu_torch.models.llama import io as tio
from pydynet_tpu_torch.models.llama.tokenizer import Tokenizer
from pydynet_tpu_torch.ops import decode_step as tdsk
from pydynet_tpu_torch.utils import fidelity as tfid

# a fused-capable tiny size (test_llama.py's int8 plumbing config)
TINY = dict(vocab_size=256, embed_dim=32, n_heads=2, ffn_dim=64,
            max_seq_len=32, max_batch_size=1, n_layers=2)
STORIES15M = dict(vocab_size=32000, embed_dim=288, n_heads=6, ffn_dim=768,
                  max_seq_len=1024, max_batch_size=1, n_layers=6)


def jax_model(cfg, seed=0):
    np.random.seed(seed)
    model = JLlama(dtype=np.float32, **cfg)
    model.eval()
    return model


def port_of(jm, cfg):
    params = {n: p.numpy() for n, p in jm._parameters.items()}
    model = Llama(**cfg, device="cpu")
    model.load_state_dict(params_from_tpu(params), strict=True)
    return model.eval()


def stream(gen):
    return [int(t.numpy()[0, 0]) for t in gen]


@pytest.fixture
def step_calls(monkeypatch):
    """Count the port's fused_decode_token calls (on the CPU they run the
    plain version, which the kernel's launch counter does not count)."""
    calls = []
    real = tdsk.fused_decode_token

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(tdsk, "fused_decode_token", spy)
    return calls


@pytest.fixture
def batched_calls(monkeypatch):
    """Row counts of the port's fused_decode_token_batched calls."""
    calls = []
    real = tdsk.fused_decode_token_batched

    def spy(*args, **kwargs):
        calls.append(args[1].shape[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(tdsk, "fused_decode_token_batched", spy)
    return calls


@pytest.fixture
def jax_interpret_kernel(monkeypatch):
    """JAX's fused lane with its Pallas kernel in interpret mode."""
    monkeypatch.setattr(jdsk, "fused_decode_token",
                        functools.partial(jdsk.fused_decode_token,
                                          interpret=True))


def test_params_from_tpu_round_trips():
    jm = jax_model(TINY)
    params = {n: p.numpy() for n, p in jm._parameters.items()}
    state = params_from_tpu(params)
    skipped = {n for n in params if n.split(".")[-1] in
               ("cache_k", "cache_v", "freqs_cos", "freqs_sin")}
    assert skipped and set(state) == set(params) - skipped
    model = Llama(**TINY, device="cpu")
    assert set(model.state_dict()) == set(state)
    model.load_state_dict(state, strict=True)
    for name, value in model.state_dict().items():
        back = value.numpy()
        if back.ndim == 2 and name != "tok_embedding.weight":
            back = back.T  # torch (out, in) -> JAX (in, out)
        np.testing.assert_array_equal(back, params[name])
    assert model.layers[0].attention.Q.weight.shape == (32, 32)
    assert model.layers[0].ffn.gate.weight.shape == (64, 32)


def test_eager_logits_match_jax():
    jm = jax_model(TINY, seed=1)
    tm = port_of(jm, TINY)
    ids = np.array([[1, 5, 9, 77, 3]])
    with pdn.no_grad():
        want0 = jm(ids, 0).numpy()
        want1 = jm(np.array([[42]]), 5).numpy()
    with torch.no_grad():
        got0 = tm(ids, 0).numpy()
        got1 = tm(np.array([[42]]), 5).numpy()
        all_pos = tm.forward_logits(ids, 0).numpy()
    assert got0.shape == (1, 1, 256)
    np.testing.assert_allclose(got0, want0, atol=1e-5)
    np.testing.assert_allclose(got1, want1, atol=1e-5)
    np.testing.assert_allclose(all_pos[:, -1:], got0, atol=1e-6)


@pytest.mark.parametrize("quant", [None, "int8-head"])
@pytest.mark.parametrize("L", [3, 8, 9])
def test_generate_fused_matches_jax_fused(L, quant, jax_interpret_kernel,
                                          step_calls):
    """Greedy streams token for token, f32 and int8-head, across the
    prompt bucketing edges (3 -> 8, 8 stays, 9 -> 16)."""
    jm = jax_model(TINY, seed=L)
    tm = port_of(jm, TINY)
    ids = (np.arange(L)[None] * 37 + 1) % 256
    with pdn.no_grad():
        want = stream(jm.generate(ids, 24, chunk=8, fused=True, quant=quant))
    got = stream(tm.generate(ids, 24, chunk=8, quant=quant))
    assert got == want and len(got) == 24 - L
    assert len(step_calls) == 24 - L - 1
    # the default chunk holds the whole request: one read back at the end
    assert stream(tm.generate(ids, 24, quant=quant)) == want
    assert len(step_calls) == 2 * (24 - L - 1)


@pytest.fixture
def draw_gaps(monkeypatch):
    """Each port draw's gap between its two largest perturbed scores (row
    0), in draw order: the two frameworks' float32 ``log`` differ by ulps,
    so a sampled stream is compared up to its first draw below 1e-5."""
    from pydynet_tpu_torch import random as prandom

    rec = []
    real = prandom.categorical

    def spy(key, logits):
        shape = (tuple(logits.shape) if key.dim() == 1
                 else tuple(logits.shape[1:]))
        top2 = (prandom.gumbel(key, shape) + logits).topk(2, -1).values
        rec.append(float((top2[..., 0] - top2[..., 1]).reshape(-1)[0]))
        return real(key, logits)

    monkeypatch.setattr(prandom, "categorical", spy)
    return rec


def upto_near_tie(gaps):
    """Tokens of a stream that precede its first draw below 1e-5 of gap."""
    near = [i for i, g in enumerate(gaps) if g < 1e-5]
    return near[0] if near else len(gaps)


@pytest.mark.parametrize("sample", [None, dict(temperature=1.0, seed=7,
                                               top_p=0.9,
                                               repetition_penalty=1.3)],
                         ids=["greedy", "sampled"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "plain"])
def test_generate_unbucketed_prefill_matches_jax(fused, sample,
                                                 jax_interpret_kernel,
                                                 draw_gaps):
    """``bucket_prefill=False`` prefills the 5-token prompt unpadded, as
    the JAX package's ``generate`` does: the port's stream equals JAX's on
    each lane (JAX's fused kernel in interpret mode), greedy and sampled,
    and equals the port's bucketed stream (L=5 pads to 8)."""
    jm = jax_model(TINY, seed=41)
    tm = port_of(jm, TINY)
    ids = np.array([[1, 5, 9, 4, 7]])
    kw = dict(sample or {}, chunk=4, fused=fused)
    with pdn.no_grad():
        want = stream(jm.generate(ids, 22, bucket_prefill=False, **kw))
    got = stream(tm.generate(ids, 22, bucket_prefill=False, **kw))
    n = upto_near_tie(draw_gaps) if sample else len(got)
    del draw_gaps[:]
    bucketed = stream(tm.generate(ids, 22, **kw))
    n = min(n, upto_near_tie(draw_gaps)) if sample else n
    assert len(got) == len(want) == len(bucketed) == 22 - 5
    assert n > len(got) // 2
    assert got[:n] == want[:n] and bucketed[:n] == got[:n]


@pytest.mark.parametrize("L", [3, 9])
def test_generate_plain_matches_jax(L, step_calls):
    jm = jax_model(TINY, seed=10 + L)
    tm = port_of(jm, TINY)
    ids = (np.arange(L)[None] * 53 + 2) % 256
    with pdn.no_grad():
        want = stream(jm.generate(ids, 20, chunk=8, fused=False))
    got = stream(tm.generate(ids, 20, chunk=8, fused=False))
    assert not step_calls
    assert got == want and len(got) == 20 - L
    assert stream(tm.generate(ids, 20, chunk=5)) == want  # fused, B=1


def test_generate_plain_batched_matches_jax(batched_calls):
    jm = jax_model(TINY, seed=20)
    tm = port_of(jm, TINY)
    ids = np.array([[1, 5, 9], [2, 7, 3], [30, 20, 10]])
    with pdn.no_grad():
        want = np.concatenate([t.numpy() for t in
                               jm.generate(ids, 14, chunk=4, fused=False)], 1)
    rows = list(tm.generate(ids, 14, chunk=4, fused=False))
    assert not batched_calls
    assert all(r.shape == (3, 1) and r.dtype == torch.int32 for r in rows)
    np.testing.assert_array_equal(torch.cat(rows, 1).numpy(), want)


@pytest.mark.parametrize("max_new", [2, 3, 4, 40])
def test_generate_length_edges_match_jax(max_new):
    """max_new_tokens bounds the total length and is capped at max_seq_len;
    a total at or below the prompt length yields nothing."""
    jm = jax_model(TINY, seed=30)
    tm = port_of(jm, TINY)
    ids = np.array([[1, 5, 9]])
    with pdn.no_grad():
        want = stream(jm.generate(ids, max_new, fused=False))
    assert len(want) == max(0, min(max_new, 32) - 3)
    assert stream(tm.generate(ids, max_new)) == want
    assert stream(tm.generate(ids, max_new, fused=False)) == want


def test_generate_unported_options_raise(batched_calls, step_calls):
    tm = Llama(**TINY, device="cpu")
    ids = np.array([[1, 5, 9]])
    cases = [dict(fused="numpy"), dict(dtype=torch.float16)]
    for kw in cases:
        with pytest.raises(NotImplementedError):
            next(tm.generate(ids, 8, **kw))
    # flash prefill runs (K3's plain version on the CPU), on both lanes, and
    # decodes the dense prefill's stream
    for fused in (False, True):
        assert stream(tm.generate(ids, 12, flash_prefill=True,
                                  fused=fused)) == \
            stream(tm.generate(ids, 12, flash_prefill=False, fused=fused))
    del step_calls[:]
    # the int8 KV cache runs on the batched step, at B=1 too (as in the JAX
    # package), one call a decode token; the B=1 step is not called
    for fused in (None, True):
        del batched_calls[:]
        assert len(stream(tm.generate(ids, 8, kv_quant="int8",
                                      fused=fused))) == 5
        assert batched_calls == [1] * 4 and not step_calls
    # int8/int4 layers at a width the JAX package runs on its fused kernel:
    # K1's `qlayers`/`q4` at B=1, K2's at B>1; the scan lane when asked for
    for quant in ("int8", "int4"):
        for fused in (None, True):
            assert len(stream(tm.generate(ids, 8, quant=quant,
                                          fused=fused))) == 5
            del batched_calls[:]
            assert len(list(tm.generate(np.array([[1, 2], [3, 4]]), 8,
                                        quant=quant, fused=fused))) == 6
            assert batched_calls == [2] * 5
        assert len(list(tm.generate(np.array([[1, 2], [3, 4]]), 5,
                                    quant=quant, fused=False))) == 3
    for quant in ("int8", "int8-head", "int4"):
        assert len(stream(tm.generate(ids, 8, quant=quant, fused=False))) == 5
    with pytest.raises(ValueError, match="quant"):
        next(tm.generate(ids, 8, quant="int2", fused=False))
    for fused in (None, True):  # B>32: the batched kernel's row groups
        del batched_calls[:]
        assert len(list(tm.generate(np.ones((33, 2), np.int64), 4,
                                    fused=fused))) == 2
        assert batched_calls == [33]
    # a grouped-query model: the narrow mode of the fused lane at B=1 (one
    # B=1 step a decode token, (N, S, Hkv * hd) caches); the scan lane only
    # when asked for
    gqa = Llama(**dict(TINY, n_kv_heads=1), device="cpu")
    assert gqa._fused_decode_supported()
    for fused in (None, True):
        del step_calls[:], batched_calls[:]
        assert len(stream(gqa.generate(ids, 8, fused=fused))) == 5
        assert len(step_calls) == 4 and not batched_calls
    del step_calls[:]
    assert len(stream(gqa.generate(ids, 8, fused=False))) == 5
    assert not step_calls and not batched_calls
    odd = Llama(**dict(TINY, embed_dim=512, n_heads=1),  # head_dim > 256
                device="cpu")
    assert not odd._fused_decode_supported()
    for fused in (None, True):
        with pytest.raises(NotImplementedError, match="Big-dims"):
            next(odd.generate(ids, 8, fused=fused))
    assert len(stream(odd.generate(ids, 8, fused=False))) == 5
    # B>1 runs the plain lane only when asked for it
    assert len(list(tm.generate(np.array([[1, 2], [3, 4]]), 5,
                                fused=False))) == 3
    for fused in (None, True):  # the grouped-query model's narrow K2
        del batched_calls[:]
        assert len(list(gqa.generate(np.array([[1, 2], [3, 4]]), 8,
                                     fused=fused))) == 6
        assert batched_calls == [2] * 5


def test_generate_default_lane_is_batched_kernel_at_b_gt_1(batched_calls,
                                                           step_calls):
    """fused=None at B=3 runs the batched step once a decode token (its
    plain version here, the CUDA kernel on a GPU), never the plain lane."""
    tm = Llama(**TINY, device="cpu").eval()
    ids = np.array([[1, 5, 9], [2, 7, 3], [30, 20, 10]])
    rows = list(tm.generate(ids, 12, chunk=4))
    assert len(rows) == 12 - 3 and all(r.shape == (3, 1) for r in rows)
    assert batched_calls == [3] * (12 - 3 - 1) and not step_calls
    want = torch.cat(list(tm.generate(ids, 12, fused=False)), 1)
    assert torch.equal(torch.cat(rows, 1), want)  # f32: the same stream


def test_bf16_generate_runs_both_lanes(batched_calls):
    """bf16 rounds differently per lane (f32 residual on the fused lane), so
    only the confident-step gate holds them to the f32 stream; at B=3 the
    gate drives the batched step."""
    for B in (1, 3):
        tm = Llama(**dict(TINY, max_batch_size=B), device="cpu",
                   generator=torch.Generator().manual_seed(3)).eval()
        ids = np.array([[1, 5, 9], [2, 7, 3], [30, 20, 10]])[:B]
        truth, margins, tops = tfid.greedy_truth(tm, ids, 12)
        before = len(batched_calls)
        for quant in (None, "int8-head"):
            checked, ok, _ = tfid.gate_fused_argmax(
                tm, ids, truth, margins, tops, dtype=torch.bfloat16,
                quant=quant)
            assert checked > 0 and ok, (B, quant, checked)
        assert len(batched_calls) - before == (2 * 11 if B > 1 else 0)
        for fused in (True, False):
            toks = torch.cat(list(tm.generate(ids, 15, dtype=torch.bfloat16,
                                              fused=fused)), 1)
            assert toks.shape == (B, 12)
            assert 0 <= toks.min() and toks.max() < 256


def test_greedy_truth_and_gate_match_jax():
    jm = jax_model(TINY, seed=40)
    tm = port_of(jm, TINY)
    ids = np.array([[1, 5, 9, 4]])
    with pdn.no_grad():
        jt, jmg, jtop = jfid.greedy_truth(jm, ids, 10)
    tt, tmg, ttop = tfid.greedy_truth(tm, ids, 10)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tmg, jmg, atol=1e-5)
    np.testing.assert_allclose(ttop, jtop, atol=1e-5)
    assert np.array_equal(tfid._confident(tmg, ttop, 0.05, 0.02),
                          jfid._confident(jmg, jtop, 0.05, 0.02))
    checked, ok, frac = tfid.gate_fused_argmax(tm, ids, tt, tmg, ttop)
    assert checked > 0 and ok and frac == 1.0


def hf_checkpoint(P, path, **config):
    """The JAX parameters ``P`` as an HF-named npz at ``path``, with
    ``config.<name>`` entries."""
    hf = {"model.embed_tokens.weight": P["tok_embedding.weight"],
          "lm_head.weight": P["lm_head.weight"].T,
          "model.norm.weight": P["norm.weight"]}
    hf.update({f"config.{k}": v for k, v in config.items()})
    names = {"self_attn.q_proj": "attention.Q", "self_attn.k_proj":
             "attention.K", "self_attn.v_proj": "attention.V",
             "self_attn.o_proj": "attention.O", "mlp.up_proj": "ffn.up",
             "mlp.gate_proj": "ffn.gate", "mlp.down_proj": "ffn.down"}
    for i in range(2):
        for theirs, ours in names.items():
            hf[f"model.layers.{i}.{theirs}.weight"] = \
                P[f"layers.{i}.{ours}.weight"].T
        hf[f"model.layers.{i}.input_layernorm.weight"] = \
            P[f"layers.{i}.input_norm.weight"]
        hf[f"model.layers.{i}.post_attention_layernorm.weight"] = \
            P[f"layers.{i}.post_attn_norm.weight"]
    np.savez(path, **hf)


def test_load_model_and_infer_config_match_jax(tmp_path):
    """One HF-named npz loads into both packages with the same numbers."""
    cfg = dict(TINY, n_kv_heads=1)
    jm = jax_model(cfg, seed=50)
    P = {n: p.numpy() for n, p in jm._parameters.items()}
    path = tmp_path / "tiny.npz"
    hf_checkpoint(P, path, n_heads=2)
    jcfg = jio.infer_config(str(path), 32, 1)
    tcfg = tio.infer_config(str(path), 32, 1)
    assert tcfg == jcfg and tcfg["n_kv_heads"] == 1
    tm = tio.load_model(Llama(**tcfg, device="cpu"), str(path))
    expect = params_from_tpu(P)
    for name, value in tm.state_dict().items():
        if name != "lm_head.bias":  # not in the checkpoint: keeps its init
            torch.testing.assert_close(value, expect[name], rtol=0, atol=0)


def test_tokenizer_matches_jax(tmp_path):
    from pydynet_tpu.models.llama.tokenizer import Tokenizer as JTokenizer

    vocab = {"tokens": ["<unk>", "<s>", "</s>", "a", "b", "c", "ab", "abc",
                        " ", "bc"],
             "scores": [0, 0, 0, -1, -1, -1, 2.0, 3.0, -1, 1.0]}
    path = tmp_path / "tok.json"
    path.write_text(__import__("json").dumps(vocab))
    for p in (str(path), None):
        jt, tt = JTokenizer(p), Tokenizer(p)
        for text in ("abc abcb", "cab bca", ""):
            assert tt.encode(text) == jt.encode(text)
            assert tt.decode(tt.encode(text)) == jt.decode(jt.encode(text))


def test_stories15m_width_matches_jax_at_confident_steps():
    """Full stories15M width, 6 layers, random weights: the port's default
    (fused) lane on the CPU against JAX's plain lane, 8 tokens, equal at
    every confident step until a legitimate near-tie divergence."""
    jm = jax_model(STORIES15M, seed=0)
    tm = port_of(jm, STORIES15M)
    ids = np.array([[1, 243, 532, 991]])
    with pdn.no_grad():
        want = stream(jm.generate(ids, 12, fused=False))
    got = stream(tm.generate(ids, 12))
    truth, margins, tops = tfid.greedy_truth(tm, ids, 8)
    conf = tfid._confident(margins[:, 0], tops[:, 0], tfid.MARGIN,
                           tfid.REL_MARGIN)
    assert len(got) == len(want) == 8 and conf.any()
    for i in range(8):
        if got[i] != want[i]:
            assert not conf[i], (i, got, want)
            break


def test_infer_cli_runs_on_cpu_and_refuses_missing_gpu(tmp_path, capsys):
    from pydynet_tpu_torch.models.llama import infer

    rate = infer.main(["--random-init", "--device", "cpu",
                       "--max-new-tokens", "10", "--dtype", "bfloat16",
                       "--quant", "int8-head", "--weights",
                       str(tmp_path / "none.npz")])
    out = capsys.readouterr().out
    assert rate > 0 and "Token count:" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            infer.main(["--random-init", "--max-new-tokens", "6"])


def test_weight_snapshots_follow_load_state_dict():
    a = Llama(**TINY, device="cpu").eval()
    b = Llama(**TINY, device="cpu",
              generator=torch.Generator().manual_seed(7)).eval()
    ids = np.array([[1, 5, 9]])
    stream(a.generate(ids, 12))  # caches a's decode weights
    a.load_state_dict(b.state_dict())
    assert stream(a.generate(ids, 12)) == stream(b.generate(ids, 12))
    assert stream(a.generate(ids, 12, fused=False)) == \
        stream(b.generate(ids, 12, fused=False))


def test_checkpoint_load_state_dict_drops_decode_snapshots_like_jax():
    """utils.checkpoint.load_state_dict into a model that has decoded (its
    decode-weight snapshot built) must leave it decoding the new weights,
    as the JAX function does: seed 0 decodes on the scan lane, loads seed
    1's state, then streams what seed 1 streams (it once streamed seed 0's
    layers behind seed 1's prefill token)."""
    from pydynet_tpu.utils import checkpoint as jckpt

    from pydynet_tpu_torch.utils import checkpoint as tckpt

    j0, j1 = jax_model(TINY, seed=0), jax_model(TINY, seed=1)
    t0, t1 = port_of(j0, TINY), port_of(j1, TINY)
    ids = np.array([[1, 5, 9]])
    with pdn.no_grad():
        want = stream(j1.generate(ids, 16, fused=False))
        stream(j0.generate(ids, 16, fused=False))
        jckpt.load_state_dict(j0, jckpt.state_dict(j1))
        assert stream(j0.generate(ids, 16, fused=False)) == want
    assert stream(t1.generate(ids, 16, fused=False)) == want
    for fused in (False, True):
        assert stream(t0.generate(ids, 16, fused=fused)) != want
        tckpt.load_state_dict(t0, tckpt.state_dict(t1))
        assert stream(t0.generate(ids, 16, fused=fused)) == want
        t0 = port_of(jax_model(TINY, seed=0), TINY)  # seed 0 again


def cli_text(out):
    """What a decode CLI printed between the prompt and its token count."""
    return out.split("Token count")[0].strip().splitlines()[-1]


@pytest.mark.parametrize("heads", [None, 2, 4])
def test_clis_take_finetuned_and_n_heads_like_jax(tmp_path, capsys, heads):
    """The port's ``finetune --save`` npz, loaded by ``infer --finetuned``
    and ``serve_cli --finetuned`` over an HF checkpoint without a head
    count, decodes the tokens of the JAX package's CLIs on the same files;
    ``--n-heads`` overrides the count both packages infer from the
    shapes."""
    from llm.llama import infer as jinfer
    from llm.llama import serve as jserve
    from pydynet_tpu_torch.models.llama import finetune, infer, serve_cli

    jm = jax_model(TINY, seed=60)
    path, ft = tmp_path / "tiny.npz", tmp_path / "ft.npz"
    hf_checkpoint({n: p.numpy() for n, p in jm._parameters.items()}, path)
    finetune.main(["--device", "cpu", "--weights", str(path), "--steps",
                   "3", "--lr", "1e-2", "--text", "Once upon a time",
                   "--trainable", "layers.0,lm_head", "--save", str(ft)])
    with np.load(ft) as f:
        assert "lm_head.bias" in f.files and len(f.files) > 2
    flags = ["--weights", str(path), "--finetuned", str(ft),
             "--max-new-tokens", "14", "--prompt", "Once"]
    if heads:
        flags += ["--n-heads", str(heads)]
    capsys.readouterr()
    with pdn.no_grad():
        jinfer.main(flags + ["--no-cuda"])
    want = cli_text(capsys.readouterr().out)
    assert infer.main(flags + ["--device", "cpu"]) > 0
    assert cli_text(capsys.readouterr().out) == want
    without = infer.main(["--weights", str(path), "--device", "cpu",
                          "--max-new-tokens", "14", "--prompt", "Once"]
                         + flags[8:])
    assert without > 0 and cli_text(capsys.readouterr().out) != want
    serve_flags = flags[:4] + ["--max-new-tokens", "12", "--prompt", "Once",
                               "--prompt", "Upon", "--batch-size", "2",
                               "--chunk", "4", "--dtype", "float32",
                               "--lane", "xla"] + flags[8:]
    jserve.main(serve_flags + ["--no-cuda"])
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("--- [")]
    serve_cli.main(serve_flags + ["--device", "cpu"])
    got = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("--- [")]
    assert len(got) == 2 and got == want


def test_infer_takes_no_warmup_like_jax(tmp_path, capsys):
    """Both CLIs take ``--no-warmup --random-init --max-new-tokens 3`` and,
    with every parameter loaded over the random ones (``--finetuned``, the
    head's bias keeping the tokens in the byte range, where the tokenizer
    prints them), print the same text."""
    from llm.llama import infer as jinfer
    from pydynet_tpu_torch.models.llama import infer, params_to_tpu

    src = Llama(infer.VOCAB_SIZE, infer.DIM, infer.N_HEADS, infer.FFN_DIM,
                infer.MAX_SEQ_LEN, infer.MAX_BATCH, infer.N_LAYERS,
                device="cpu", generator=torch.Generator().manual_seed(16))
    params = params_to_tpu(dict(src.named_parameters()))
    params["lm_head.bias"][259:] = -100.0
    full = tmp_path / "full.npz"
    np.savez(full, **params)
    flags = ["--no-warmup", "--random-init", "--max-new-tokens", "3",
             "--prompt", "", "--finetuned", str(full)]
    capsys.readouterr()
    with pdn.no_grad():
        jinfer.main(flags + ["--no-cuda"])
    jout = capsys.readouterr().out
    assert infer.main(flags + ["--device", "cpu"]) > 0
    out = capsys.readouterr().out
    assert "Token count: 3" in out and "Token count: 3" in jout
    assert cli_text(out) == cli_text(jout) != ""
