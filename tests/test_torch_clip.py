"""CLIP in the port (``pydynet_tpu_torch/models/clip``) against the JAX
package's, on the CPU.

The JAX model is built at ``tests/test_clip.py``'s ``TINY`` sizes from a
NumPy seed and its ``_parameters`` are carried into the port's twin by
``utils/checkpoint.load_state_dict`` (both keep Linear weights (in, out), so
nothing is transposed). Inputs come from ``np.random.default_rng``, float32.
Tokenizer ids, the id matrix and the preprocessed images are held exact;
``patch_project``, attention, ``CLIPLayerNorm`` and the logits within 1e-5;
five fine-tune steps (projection-only, with clipping, LoRA r=4) to losses
within rtol 1e-5 and parameters within 1e-5. Only the two CLI tests build
the full ViT-B/32 width, and only in the port.
"""
import argparse
import gzip
import json
import zipfile

import numpy as np
import pytest
import torch

import pydynet_tpu as pdn
from pydynet_tpu import optim as joptim
from pydynet_tpu.models.clip import data as jdata
from pydynet_tpu.models.clip import io as jio
from pydynet_tpu.models.clip import model as jmodel
from pydynet_tpu.models.clip.tokenizer import SimpleTokenizer as JTokenizer

from pydynet_tpu_torch import optim as toptim
from pydynet_tpu_torch.models.clip import data as tdata
from pydynet_tpu_torch.models.clip import finetune as tfinetune
from pydynet_tpu_torch.models.clip import infer as tinfer
from pydynet_tpu_torch.models.clip import io as tio
from pydynet_tpu_torch.models.clip import model as tmodel
from pydynet_tpu_torch.models.clip.tokenizer import SimpleTokenizer
from pydynet_tpu_torch.utils.checkpoint import load_state_dict, state_dict

torch.set_num_threads(1)  # six test workers share the CPU: one thread each

F32 = np.float32
TOL = dict(atol=1e-5, rtol=1e-5)
TINY = dict(image_dim=16, image_heads=2, image_mlp_dim=32, image_patch=8,
            image_layers=2, text_dim=12, text_heads=2, text_mlp_dim=24,
            text_layers=2, final_dim=10, vocab_size=64, vision_tokens=17,
            text_tokens=9)
TEXTS = ["a dog", "A photo of a CAT!", "it's 3 o'clock", "  x  y ",
         "naïve café, 42 €", "a fish", ""]


def draw(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(F32)


def jax_state(jm):
    return {n: p.numpy() for n, p in jm._parameters.items()}


def twins(seed=0, **cfg):
    """A JAX CLIP from a NumPy seed and the port's twin with its numbers."""
    cfg = dict(TINY, **cfg)
    np.random.seed(seed)
    jm = jmodel.CLIP(**cfg)
    tm = tmodel.CLIP(**cfg, device="cpu")
    load_state_dict(tm, jax_state(jm))
    return jm, tm


def tiny_inputs(seed=0, n_img=2):
    img = draw((n_img, 3, 32, 32), seed)
    text = np.zeros((3, TINY["text_tokens"]), np.int64)
    text[:, 0] = 1
    text[0, 1:3], text[1, 1:5], text[2, 1] = (7, 9), (3, 11, 5, 2), 30
    text[0, 3], text[1, 5], text[2, 2] = 63, 63, 63  # the end token
    return img, text


def jax_logits(jm, img, text):
    """The JAX model's logits as one compiled program (its eager ops each
    compile anew at new shapes: several seconds a forward). Its text
    encoder caches the causal mask made in the trace, so the cache is
    emptied before each compile."""
    jm.text_encoder._mask_cache.clear()
    forward = pdn.jit(lambda a, b: jm(a, b), state=(jm,))
    with pdn.no_grad():
        return forward(pdn.Tensor(img), pdn.Tensor(text)).numpy()


def close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               **(kw or TOL))


# ------------------------------ inputs -------------------------------------
def write_merges(path):
    """A small merges file in the OpenAI layout: a header line, then one
    pair a line (here a few English pieces)."""
    merges = ["#version: 0.2", "a </w>", "d o", "do g</w>", "c a", "ca t</w>",
              "p h", "ph o", "pho t", "phot o</w>", "o f</w>", "f i",
              "fi s", "fis h</w>", "t h", "th e</w>"]
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(merges))


@pytest.mark.parametrize("merges", [False, True])
def test_tokenizer_and_tokenize_match_jax(tmp_path, merges):
    """Ids of each text and the (N, 77) id matrix equal the JAX package's,
    with the byte-level fallback vocab and with a merges file; a text too
    long for the context raises in both."""
    path = str(tmp_path / "bpe.txt.gz")
    if merges:
        write_merges(path)
    jt, tt = JTokenizer(path), SimpleTokenizer(path)
    assert tt.encoder == jt.encoder and tt.bpe_ranks == jt.bpe_ranks
    for text in TEXTS:
        assert tt.encode(text) == jt.encode(text), text
        assert tt.decode(tt.encode(text)) == jt.decode(jt.encode(text))
    got = tdata.tokenize(TEXTS, tokenizer=tt)
    want = jdata.tokenize(TEXTS, tokenizer=jt)
    assert got.dtype == want.dtype == np.int64 and got.shape == (7, 77)
    np.testing.assert_array_equal(got, want)
    if not merges:
        assert tt.encoder["<|endoftext|>"] == 49407
    for tok in (jdata.tokenize, tdata.tokenize):
        with pytest.raises(RuntimeError, match="too long"):
            tok(["a " * 80], tokenizer=tt)


def test_preprocess_matches_jax():
    """``preprocess_array`` (two crops) and ``preprocess`` of a PIL image
    give the JAX package's values bit for bit."""
    from PIL import Image

    rng = np.random.default_rng(3)
    for shape in ((256, 256, 3), (300, 240, 3)):
        x = rng.uniform(0, 1, shape)
        got, want = tdata.preprocess_array(x), jdata.preprocess_array(x)
        assert got.dtype == torch.float32 and got.shape == (3, 224, 224)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    image = Image.fromarray(rng.integers(0, 256, (260, 310, 3),
                                         dtype=np.uint8))
    np.testing.assert_array_equal(tdata.preprocess(image).numpy(),
                                  jdata.preprocess(image).numpy())


# ------------------------------ layers -------------------------------------
def test_patch_project_matches_jax():
    x, k = draw((2, 3, 32, 48), 1), draw((5, 3, 8, 8), 2)
    got = tmodel.patch_project(torch.from_numpy(x), torch.from_numpy(k))
    want = jmodel.patch_project(pdn.Tensor(x), pdn.Tensor(k))
    assert got.shape == (2, 24, 5)
    close(got.numpy(), want.numpy())


@pytest.mark.parametrize("masked", [False, True])
def test_attention_matches_jax(masked):
    """The fused-QKV attention block with weights carried from JAX, with
    the causal mask and without it; and the attention function alone."""
    np.random.seed(4)
    jm = jmodel.MultiHeadAttention(12, 3)
    tm = tmodel.MultiHeadAttention(12, 3)
    load_state_dict(tm, jm.state_dict())
    x = draw((2, 7, 12), 5)
    jmask = jmodel.build_attention_mask(7) if masked else None
    tmask = tmodel.build_attention_mask(7) if masked else None
    if masked:
        np.testing.assert_array_equal(tmask.numpy(), jmask.numpy())
    with pdn.no_grad():
        want = jm(pdn.Tensor(x), jmask).numpy()
    close(tm(torch.from_numpy(x), tmask).detach().numpy(), want)
    q, k, v = (draw((2, 7, 3, 4), s) for s in (6, 7, 8))
    want = jmodel._sdpa_node(pdn.Tensor(q), pdn.Tensor(k), pdn.Tensor(v),
                             jmask, 0.5).numpy()
    got = tmodel.attention(*map(torch.from_numpy, (q, k, v)), tmask, 0.5)
    close(got.numpy(), want)


@pytest.mark.parametrize("train", [True, False])
def test_clip_layernorm_matches_jax(train):
    """Last-axis statistics with eps 1e-5 and a drawn scale and shift, the
    same in train and eval mode; the running statistics unused."""
    jm = jmodel.CLIPLayerNorm((6,), eps=1e-5)
    jm.scale.data, jm.shift.data = draw((6,), 1) + 1, draw((6,), 2)
    tm = tmodel.CLIPLayerNorm((6,), eps=1e-5)
    load_state_dict(tm, jm.state_dict())
    assert tmodel.CLIPLayerNorm((6,)).eps == 1e-6  # the constructor's own
    jm.train(train)
    tm.train(train)
    x = draw((3, 4, 6), 3, scale=3.0)
    with pdn.no_grad():
        want = jm(pdn.Tensor(x)).numpy()
    close(tm(torch.from_numpy(x)).detach().numpy(), want)
    assert sorted(n for n, _ in tm.named_buffers()) == ["running_mean",
                                                        "running_var"]
    pdn.set_grad_enabled(True)  # JAX's train(False) turned it off


def test_clip_logits_match_jax():
    """The whole model: (2 images, 3 texts) logits within 1e-5 (a loaded
    scale: the synthetic checkpoint's test); the port's state carried back
    into a JAX model as it is."""
    jm, tm = twins()
    img, text = tiny_inputs()
    want = jax_logits(jm, img, text)
    with torch.no_grad():
        got = tm(img, text)
    assert got.shape == (2, 3) and got.dtype == torch.float32
    close(got.numpy(), want)
    back = jmodel.CLIP(**TINY)  # and back: the port's state into JAX's
    back.load_state_dict(state_dict(tm))
    for name, value in state_dict(tm).items():
        np.testing.assert_array_equal(back._parameters[name].numpy(), value)


def test_end_token_pooling_takes_the_first_maximum():
    """Two positions holding the largest id: both packages pool the
    first."""
    jm, tm = twins()
    img, text = tiny_inputs()
    text[0, 5] = 63
    want = jax_logits(jm, img, text)
    with torch.no_grad():
        close(tm(img, text).numpy(), want)


PREFIXES = [("text_encoder",), ("text_encoder.proj", "image_encoder.proj"),
            ("image_encoder.transformers.1", "class_embed"), ("nothing",)]


@pytest.mark.parametrize("prefixes", PREFIXES)
def test_names_and_counts_match_jax(prefixes):
    """Dotted names equal the JAX package's ``_parameters``; the trainable
    and frozen counts and the trainable names (running statistics under a
    prefix among them) equal its."""
    jm, tm = twins()
    assert set(tm.state_dict()) == set(jm._parameters)
    assert tm.set_trainable_parameters(prefixes) \
        == jm.set_trainable_parameters(prefixes)
    assert set(tm.trainable_names()) == {
        n for n, p in jm._parameters.items() if p.requires_grad}


@pytest.mark.parametrize("targets", [("QKV", "O"), ("fc1", "fc2", "proj")])
def test_lora_counts_and_merge_match_jax(targets):
    """``add_lora`` returns the JAX package's counts and names; with the
    adapters carried (and ``lora_B`` drawn non-zero) the logits agree
    before and after ``merge_lora``."""
    jm, tm = twins()
    assert tm.add_lora(r=4, alpha=8.0, targets=targets) \
        == jm.add_lora(r=4, alpha=8.0, targets=targets)
    assert set(tm.state_dict()) == set(jm._parameters)
    names = [n for n in jm._parameters if n.endswith(("lora_A", "lora_B"))]
    assert set(tm.trainable_names()) == set(names)
    for i, n in enumerate(names):
        if n.endswith("lora_B"):
            jm._parameters[n].data = draw(jm._parameters[n].shape, i, 0.1)
    load_state_dict(tm, {n: jm._parameters[n].numpy() for n in names},
                    strict=False)
    img, text = tiny_inputs()
    want = jax_logits(jm, img, text)
    assert tm.merge_lora() == jm.merge_lora() > 0
    merged = jax_logits(jm, img, text)
    with torch.no_grad():
        close(tm(img, text).numpy(), merged)
    close(merged, want)
    assert set(tm.state_dict()) == set(jm._parameters)


# ----------------------------- fine-tuning ---------------------------------
FINETUNES = {
    "proj": dict(prefixes=("text_encoder.proj", "image_encoder.proj")),
    # running statistics trainable in JAX (Adam steps them by zero)
    "clip_norm": dict(prefixes=("text_encoder",), clip_norm=0.05),
    "lora": dict(lora=4),
}


@pytest.mark.parametrize("kind", list(FINETUNES))
def test_finetune_steps_match_jax(kind):
    """Five ``finetune_step``s with Adam (lr 1e-3) on both packages:
    losses within rtol 1e-5, every parameter and buffer within 1e-5.

    The key third of each QKV bias gets a gradient of rounding noise only
    (a key bias adds one constant to a query's scores, which the softmax
    takes away), and Adam steps such an element by up to lr * noise / eps
    in a direction the rounding decides: at lr 1e-3 that stays below 5e-6
    here (3e-5 at lr 1e-2)."""
    spec = FINETUNES[kind]
    jm, tm = twins()
    if "lora" in spec:
        counts = [m.add_lora(r=spec["lora"], alpha=8.0) for m in (jm, tm)]
        load_state_dict(tm, {n: p.numpy() for n, p in jm._parameters.items()
                             if n.endswith("lora_A")}, strict=False)
    else:
        counts = [m.set_trainable_parameters(spec["prefixes"])
                  for m in (jm, tm)]
    assert counts[0] == counts[1]
    jopt = joptim.Adam(jm.parameters(), lr=1e-3)
    topt = toptim.Adam([p for p in tm.parameters() if p.requires_grad],
                       lr=1e-3)
    img, text = tiny_inputs(n_img=2)
    tgt = np.array([2, 0])
    clip_norm = spec.get("clip_norm")
    jl = [jm.finetune_step(img, text, tgt, jopt, clip_norm=clip_norm)
          for _ in range(5)]
    tl = [tm.finetune_step(img, text, tgt, topt, clip_norm=clip_norm)
          for _ in range(5)]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    theirs = jax_state(jm)
    for name, t in tm.state_dict().items():
        close(t.numpy(), theirs[name], atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", ["prefix", "lora"])
def test_finetuned_files_cross_both_ways(tmp_path, kind):
    """For the same flags both packages save the same key set (the running
    statistics under ``text_encoder`` included); each loads the other's
    file, extensionless paths through the ``.npz`` rule."""
    jm, tm = twins()
    if kind == "lora":
        jm.add_lora(r=2)
        tm.add_lora(r=2)
    else:
        jm.set_trainable_parameters(("text_encoder",))
        tm.set_trainable_parameters(("text_encoder",))
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t")
    jio.save_finetuned_parameters(jm, jpath)
    tio.save_finetuned_parameters(tm, tpath)
    with np.load(jpath) as a, np.load(tpath) as b:
        assert set(a.files) == set(b.files)
        keys = set(a.files)
    if kind == "prefix":
        assert "text_encoder.post_norm.running_var" in keys
    rng = np.random.default_rng(9)
    fresh = {k: (rng.standard_normal(jm._parameters[k].shape)).astype(F32)
             for k in keys}
    np.savez(str(tmp_path / "jfresh.npz"), **fresh)
    tio.load_finetuned_parameters(tm, str(tmp_path / "jfresh"))
    own = tm.state_dict()
    for k in keys:
        np.testing.assert_array_equal(own[k].numpy(), fresh[k])
    tio.save_finetuned_parameters(tm, tpath)
    jio.load_finetuned_parameters(jm, tpath)
    for k in keys:
        np.testing.assert_array_equal(jm._parameters[k].numpy(), fresh[k])


# ------------------------------ checkpoints --------------------------------
def openai_state(cfg, seed=0):
    """OpenAI's ViT-B/32 names at ``cfg``'s widths, 12 blocks each tower
    (``tests/test_clip.py``'s synthetic checkpoint), drawn from ``seed``."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return rng.standard_normal(shape).astype(F32)

    d_i, d_t, f = cfg["image_dim"], cfg["text_dim"], cfg["final_dim"]
    p = cfg["image_patch"]
    sd = {"logit_scale": t(), "visual.class_embedding": t(d_i),
          "visual.positional_embedding": t(cfg["vision_tokens"], d_i),
          "positional_embedding": t(cfg["text_tokens"], d_t),
          "visual.conv1.weight": t(d_i, 3, p, p),
          "visual.ln_pre.weight": t(d_i), "visual.ln_pre.bias": t(d_i),
          "visual.ln_post.weight": t(d_i), "visual.ln_post.bias": t(d_i),
          "visual.proj": t(d_i, f),
          "token_embedding.weight": t(cfg["vocab_size"], d_t),
          "ln_final.weight": t(d_t), "ln_final.bias": t(d_t),
          "text_projection": t(d_t, f)}
    for i in range(12):
        for pref, d, m in (("visual.transformer", d_i, cfg["image_mlp_dim"]),
                           ("transformer", d_t, cfg["text_mlp_dim"])):
            b = f"{pref}.resblocks.{i}."
            for name, shape in (("attn.in_proj_weight", (3 * d, d)),
                                ("attn.in_proj_bias", (3 * d,)),
                                ("attn.out_proj.weight", (d, d)),
                                ("attn.out_proj.bias", (d,)),
                                ("ln_1.weight", (d,)), ("ln_1.bias", (d,)),
                                ("ln_2.weight", (d,)), ("ln_2.bias", (d,)),
                                ("mlp.c_fc.weight", (m, d)),
                                ("mlp.c_fc.bias", (m,)),
                                ("mlp.c_proj.weight", (d, m)),
                                ("mlp.c_proj.bias", (d,))):
                sd[b + name] = t(*shape) * 0.2
    return sd


def write_openai_zip(tmp_path, sd):
    """``torch.save`` of ``sd`` as ViT-B-32.pt and its JSON byte index
    (each tensor's bytes found in the zip's members)."""
    pt = tmp_path / "ViT-B-32.pt"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, str(pt))
    with zipfile.ZipFile(str(pt)) as z:
        members = {i.filename: z.read(i.filename) for i in z.infolist()}
    index = {}
    for name, arr in sd.items():
        raw = arr.tobytes()
        for path, blob in members.items():
            off = blob.find(raw)
            if off >= 0:
                index[name] = {"path": path, "start": off,
                               "end": off + len(raw), "dtype": "float32",
                               "shape": list(arr.shape)}
                break
        assert name in index, name
    (tmp_path / "ViT-B-32.json").write_text(json.dumps(index))


def test_load_model_on_a_synthetic_openai_checkpoint(tmp_path):
    """``Params`` through the JSON index reads what the JAX package's does;
    ``load_model`` of it gives the same state and scale in both, and the
    logits agree within 1e-5."""
    cfg = dict(TINY, image_layers=12, text_layers=12, vision_tokens=5)
    sd = openai_state(cfg)
    write_openai_zip(tmp_path, sd)
    tp = tio.Params("ViT-B/32", download_root=str(tmp_path))
    jp = jio.Params("ViT-B/32", download_root=str(tmp_path))
    assert tp._tensors is None
    for name in sd:
        np.testing.assert_array_equal(tp[name], jp[name])
        np.testing.assert_array_equal(tp[name], sd[name])
    jm = jio.load_model(jmodel.CLIP(**cfg), jp)
    tm = tio.load_model(tmodel.CLIP(**cfg, device="cpu"), tp)
    assert tm.scale == jm.scale == float(np.exp(sd["logit_scale"]))
    theirs = jax_state(jm)
    for name, t in tm.state_dict().items():
        if "running" not in name:
            np.testing.assert_array_equal(t.numpy(), theirs[name])
    img = draw((1, 3, 16, 16), 0)
    text = np.array([[1, 5, 9, 2, 0, 0, 0, 0, 63],
                     [1, 7, 3, 2, 63, 0, 0, 0, 0]], np.int64)
    want = jax_logits(jm, img, text)
    with torch.no_grad():
        close(tm(img, text).numpy(), want)


def test_params_reads_torchscript_and_raises_when_missing(tmp_path):
    """Without the JSON index ``Params`` reads a TorchScript archive
    through torch, as the JAX package's does; with no checkpoint both
    raise ``FileNotFoundError`` (the port never fetches)."""
    for p in (tio.Params, jio.Params):
        with pytest.raises(FileNotFoundError):
            p("ViT-B/32", download_root=str(tmp_path))

    class M(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(
                torch.arange(6, dtype=torch.float32).reshape(2, 3))

    torch.jit.save(torch.jit.script(M()), str(tmp_path / "ViT-B-32.pt"))
    np.testing.assert_array_equal(
        tio.Params("ViT-B/32", download_root=str(tmp_path))["w"],
        jio.Params("ViT-B/32", download_root=str(tmp_path))["w"])


# --------------------------------- CLIs ------------------------------------
def flags(main):
    """{option: default} of the parser ``main`` builds."""
    seen = {}

    def capture(self, args=None, namespace=None):
        seen.update({a.option_strings[0]: a.default for a in self._actions
                     if a.option_strings and a.dest != "help"})
        raise SystemExit(0)

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = capture
    try:
        with pytest.raises(SystemExit):
            main([])
    finally:
        argparse.ArgumentParser.parse_args = orig
    return seen


@pytest.mark.parametrize("cli", ["infer", "finetune"])
def test_cli_flags_match_jax(cli):
    """The port's CLIs take the JAX CLIs' flags and defaults, with
    ``--device`` in place of ``--no-cuda``."""
    import importlib

    jax_cli = importlib.import_module(f"llm.clip.{cli}")
    port_cli = {"infer": tinfer, "finetune": tfinetune}[cli]
    theirs, ours = flags(jax_cli.main), flags(port_cli.main)
    assert theirs.pop("--no-cuda") is False
    assert ours.pop("--device") == "cuda"
    assert ours == theirs


def test_infer_cli_on_the_cpu(capsys, tmp_path):
    """``infer --random-init --device cpu`` on the synthetic image: the
    full ViT-B/32, three probabilities summing to 1."""
    out = tinfer.main(["--random-init", "--device", "cpu", "--image",
                       str(tmp_path / "missing.png")])
    text = capsys.readouterr().out
    assert "synthetic image" in text
    assert "Labels: ['a fish', 'a dog', 'a cat']" in text
    assert "Label probs:" in text
    assert out.shape == (3,) and np.isfinite(out).all()
    assert abs(float(out.sum()) - 1) < 1e-5


def test_finetune_cli_on_the_cpu(capsys, tmp_path):
    """``finetune --random-init --device cpu --steps 2``: the JAX package's
    counts at ViT-B/32's depth, two finite losses, the two projections
    saved."""
    save = tmp_path / "ft.npz"
    losses = tfinetune.main([
        "--random-init", "--device", "cpu", "--steps", "2", "--image",
        str(tmp_path / "missing.png"), "--labels", "a dog,a cat",
        "--target", "1", "--save", str(save)])
    text = capsys.readouterr().out
    jm = jmodel.CLIP(**dict(TINY, image_layers=12, text_layers=12))
    want = jm.set_trainable_parameters(("text_encoder.proj",
                                        "image_encoder.proj"))
    assert f"Trainable params: {want[0]}, Frozen params: {want[1]}" in text
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert "step=0002" in text
    with np.load(save) as f:
        assert set(f.files) == {"text_encoder.proj.weight",
                                "image_encoder.proj.weight"}
        assert f["image_encoder.proj.weight"].shape == (768, 512)
