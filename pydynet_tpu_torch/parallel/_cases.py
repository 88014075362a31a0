"""Rank bodies of the CPU tests that hold the parallel package against the
JAX package: a test spawns gloo ranks once (``_dryrun.spawn``) to run one
group of cases, each case on its own mesh, and reads rank 0's results. Every
rank of a case's mesh must return the same global result (``mesh``'s
execution model): after each case the ranks compare digests of their
results (leaving out None, the value of a mesh a rank is outside of), and a
rank that disagrees with rank 0 turns the case into an error.

A spawned rank imports only ``torch`` and this package, never JAX: the test
process prepares the inputs (the JAX package's initial weights among them),
writes them to a pickle, and computes the JAX side itself. A case returns
NumPy results (None on ranks outside its mesh); one that raises records its
traceback instead, so the other cases still run (a case that fails on some
ranks only leaves the others waiting in a collective, which times out).
"""
from __future__ import annotations

import hashlib
import pickle
import time
import traceback

import numpy as np
import torch

_GROUPS: dict = {}


def case(group: str):
    def register(fn):
        _GROUPS.setdefault(group, []).append((fn.__name__, fn))
        return fn
    return register


def run_group(rank, n, group, in_path, out_path):
    """Every case of ``group`` in order on this rank (those named in the
    inputs' ``"_only"`` when it is given), each case's seconds logged to
    ``<out_path>.log<rank>``; rank 0 pickles the results ({case: result or
    {"error": traceback}}) to ``out_path``."""
    import torch.distributed as dist

    with open(in_path, "rb") as f:
        inputs = pickle.load(f)
    results = {}
    only = inputs.get("_only")
    with open(f"{out_path}.log{rank}", "w") as log:
        for name, fn in _GROUPS[group]:
            if only and name not in only:
                continue
            t0 = time.time()
            log.write(f"{name} ...")
            log.flush()
            try:
                results[name] = fn(inputs.get(name, {}))
            except Exception:
                results[name] = {"error": traceback.format_exc()}
                log.write("\n" + results[name]["error"])
            log.write(f" {time.time() - t0:.1f} s\n")
            log.flush()
            _agree(results, name, n, out_path)
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(results, f)


def _digests(result, path=()):
    """``{path: digest}`` of the leaves of a result (nested dicts walked),
    leaving out None: the value of a mesh this rank is not a member of."""
    if isinstance(result, dict):
        out = {}
        for k, v in result.items():
            out.update(_digests(v, path + (k,)))
        return out
    if result is None:
        return {}
    return {path: hashlib.sha256(pickle.dumps(result)).hexdigest()}


def _agree(results, name, n, out_path):
    """Gather every rank's digests of ``results[name]``; where a rank's
    leaf differs from rank 0's, rank 0's result becomes an error naming
    those ranks."""
    import torch.distributed as dist

    digests = [None] * n
    dist.all_gather_object(digests, _digests(results[name]))
    r0 = results[name]
    if isinstance(r0, dict) and "error" in r0:
        return
    odd = {r: sorted(".".join(map(str, k)) for k, v in d.items()
                     if digests[0].get(k) != v)
           for r, d in enumerate(digests)}
    odd = {r: keys for r, keys in odd.items() if keys}
    if odd:
        results[name] = {"error": (
            f"ranks {sorted(odd)} returned another result than rank 0, in "
            f"{odd} (their logs: {out_path}.log<rank>)")}


def _np(x):
    from .mesh import full

    return full(x).detach().cpu().numpy()


def _mesh(axes):
    from .mesh import make_mesh

    return make_mesh(axes, device_type="cpu")


# ---------------------------- jit(mesh=) ------------------------------- #
def _mlp(state, hidden=16):
    from .. import nn, optim
    from ..utils.checkpoint import load_state_dict

    net = nn.Sequential(nn.Linear(6, hidden), nn.Tanh(),
                        nn.Linear(hidden, 3))
    load_state_dict(net, state)
    opt = optim.SGD(net.parameters(), lr=0.1, momentum=0.0, nesterov=False)
    return net, opt


def _mse_step(net, opt):
    from ..nn import functional as F

    def step(x, y):
        opt.zero_grad()
        loss = F.mse_loss(net(x), y)
        loss.backward()
        opt.step()
        return loss
    return step


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


def _params(net):
    return {n: _np(p) for n, p in net.named_parameters()}


def _placement(t):
    return [repr(p) for p in t.placements], int(t.device_mesh.size()), \
        tuple(t.to_local().shape)


@case("parallel")
def dp_jit(inp):
    from .. import jit

    mesh = _mesh({"dp": 4})
    net, opt = _mlp(inp["W"])
    js = jit(_mse_step(net, opt), state=(net, opt), mesh=mesh)
    losses = [float(js(_t(inp["X"]), _t(inp["Y"]))) for _ in range(5)]
    return {"losses": losses, "params": _params(net),
            "placement": _placement(net[0].weight)}


@case("parallel")
def non_batch_arg(inp):
    from .. import jit, nn, optim
    from ..utils.checkpoint import load_state_dict

    mesh = _mesh({"dp": 4})
    net = nn.Linear(6, 3)
    load_state_dict(net, inp["W"])
    opt = optim.SGD(net.parameters(), lr=0.1)

    def step(x, y, w):
        opt.zero_grad()
        loss = torch.mean(torch.square(net(x) - y) * w)
        loss.backward()
        opt.step()
        return loss

    js = jit(step, state=(net, opt), mesh=mesh)
    return {"losses": [float(js(_t(inp["X"]), _t(inp["Y"]), _t(inp["cw"])))
                       for _ in range(3)]}


def _foreach_run(inp, axes, rules=None, each=True):
    from .. import jit

    mesh = _mesh(axes)
    net, opt = _mlp(inp["W"])
    js = jit(_mse_step(net, opt), state=(net, opt), mesh=mesh,
             shard_rules=rules)
    if each:
        losses = js.foreach(_t(inp["Xb"]), _t(inp["Yb"])).reshape(-1)
    else:
        losses = torch.stack([js(_t(x), _t(y))
                              for x, y in zip(inp["Xb"], inp["Yb"])])
    return losses.numpy(), net


@case("parallel")
def foreach(inp):
    each, net_a = _foreach_run(inp, {"dp": 4})
    loop, net_b = _foreach_run(inp, {"dp": 4}, each=False)
    return {"each": each, "loop": loop, "params_each": _params(net_a),
            "params_loop": _params(net_b),
            "placement": _placement(net_a[0].weight)}


@case("parallel")
def foreach_tp(inp):
    from .mesh import P

    rules = [("0.weight", P(None, "tp")), ("0.bias", P("tp")),
             ("2.weight", P("tp", None))]
    losses, net = _foreach_run(inp, {"dp": 2, "tp": 2}, rules)
    return {"losses": losses, "params": _params(net),
            "placement": _placement(net[0].weight)}


# ---------------------------- llama_spmd ------------------------------- #
def _train(mesh, cfg, params, tokens, targets, lr, steps, remat=False):
    from . import llama_spmd

    params = llama_spmd.shard_params(params, mesh)
    step = llama_spmd.make_train_step(mesh, cfg, lr=lr, remat=remat)
    losses = []
    for _ in range(steps):
        params, loss = step(params, tokens, targets)
        losses.append(float(loss))
    return losses, params


@case("parallel")
def remat(inp):
    from . import llama_spmd

    mesh = _mesh({"dp": 2, "tp": 2})
    cfg = llama_spmd.config(vocab_size=64, dim=16, n_heads=2, ffn_dim=32,
                            n_layers=4, max_seq_len=16)
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, 64, (8, 8))
    targets = rng.randint(0, 64, (8, 8))
    out = {}
    for r in (False, True):
        p = llama_spmd.init_params(np.random.RandomState(1), cfg)
        out[r] = _train(mesh, cfg, p, tokens, targets, 1e-1, 3, r)[0]
    return {"plain": out[False], "remat": out[True]}


@case("parallel")
def mesh_helpers(inp):
    from .mesh import shard

    mesh = _mesh({"dp": 2, "tp": 2})
    x = shard(np.arange(16.0).reshape(8, 2), mesh, "dp", None)
    try:
        _mesh({"dp": 99})
        err = None
    except ValueError as e:
        err = str(e)
    return {"shape": mesh.shape, "local": tuple(x.to_local().shape),
            "placements": [repr(p) for p in x.placements],
            "whole": _np(x), "err": err}


@case("parallel")
def hybrid_mesh(inp):
    from .mesh import initialize_distributed, make_hybrid_mesh, shard

    mesh = make_hybrid_mesh({"tp": 2, "dp": 2}, {"pp": 1},
                            device_type="cpu")
    x = shard(np.arange(16.0).reshape(8, 2), mesh, "tp", None)
    errs = {}
    for key, fn in (("dcn", lambda: make_hybrid_mesh(
            {"tp": 2}, {"dp": 2}, device_type="cpu")),
            ("dup", lambda: make_hybrid_mesh({"tp": 2}, {"tp": 2},
                                             device_type="cpu")),
            ("claim", lambda: initialize_distributed("10.0.0.1:1234", 2,
                                                     0))):
        try:
            fn()
            errs[key] = None
        except (ValueError, RuntimeError) as e:
            # "claim" names this process's rank: the same text on every rank
            errs[key] = (type(e).__name__, str(e).replace(
                f"rank {torch.distributed.get_rank()} ", "rank <r> "))
    initialize_distributed()  # the group exists: a no-op
    return {"names": mesh.axis_names, "shape": mesh.shape,
            "local": tuple(x.to_local().shape), "errs": errs}


@case("parallel")
def train_loss(inp):
    from . import llama_spmd

    mesh = _mesh({"dp": 2, "tp": 2})
    cfg = llama_spmd.config(vocab_size=64, dim=16, n_heads=2, ffn_dim=32,
                            n_layers=2, max_seq_len=16)
    rng = np.random.RandomState(0)
    params = llama_spmd.init_params(rng, cfg)
    tokens = rng.randint(0, 64, (8, 8))
    targets = rng.randint(0, 64, (8, 8))
    losses, params = _train(mesh, cfg, params, tokens, targets, 1e-1, 8)
    return {"losses": losses, "wq": _np(params["wq"]),
            "tok": _np(params["tok"]),
            "wq_placement": _placement(params["wq"])}


def _llama_module(ckpt):
    from .. import nn, optim
    from ..models.llama.model import Llama
    from ..utils.checkpoint import load_checkpoint

    net = Llama(vocab_size=64, embed_dim=16, n_heads=2, ffn_dim=32,
                max_seq_len=16, max_batch_size=4, n_layers=2, device="cpu")
    load_checkpoint(ckpt, net)
    net.train(True)
    opt = optim.Adam(net.parameters(), lr=1e-2)
    crit = nn.CrossEntropyLoss()

    def step(inp, tgt):
        opt.zero_grad()
        logits = net.forward_logits(inp, 0)
        B, L, V = logits.shape
        loss = crit(logits.reshape(B * L, V), tgt)
        loss.backward()
        opt.step()
        return loss

    return net, opt, step


@case("parallel")
def module_tp(inp):
    from .. import jit
    from . import LLAMA_TP_RULES

    mesh = _mesh({"dp": 2, "tp": 2})
    net, opt, step = _llama_module(inp["ckpt"])
    js = jit(step, state=(net, opt), mesh=mesh, shard_rules=LLAMA_TP_RULES)
    x, y = torch.as_tensor(inp["inp"]), torch.as_tensor(inp["tgt"])
    losses = [float(js(x, y)) for _ in range(4)]
    named = dict(net.named_parameters())
    moments = {}
    for pname in ("layers.0.attention.Q.weight",
                  "layers.0.attention.O.weight"):
        p = named[pname]
        i = [id(q) for q in opt.params].index(id(p))
        moments[pname] = (_placement(opt.m[i]), _placement(p))
    return {"losses": losses, "moments": moments,
            "q": _placement(named["layers.0.attention.Q.weight"])}


@case("parallel")
def opt_first(inp):
    from .. import jit
    from . import LLAMA_TP_RULES

    mesh = _mesh({"dp": 2, "tp": 2})
    net, opt, step = _llama_module(inp["ckpt"])
    js = jit(step, state=(opt, net), mesh=mesh, shard_rules=LLAMA_TP_RULES)
    js(torch.as_tensor(inp["inp"]), torch.as_tensor(inp["tgt"]))
    return {"q": _placement(dict(net.named_parameters())[
        "layers.0.attention.Q.weight"])}


def _generate(axes, cfg, params, prompt, n_new):
    from . import llama_spmd

    mesh = _mesh(axes)
    if not mesh.is_member:
        return None
    return llama_spmd.generate(llama_spmd.shard_params(params, mesh),
                               prompt, n_new, mesh, cfg)


def _gen_case(dp, tp):
    def body(inp):
        from . import llama_spmd

        cfg = llama_spmd.config(vocab_size=64, dim=16, n_heads=2,
                                ffn_dim=32, n_layers=2, max_seq_len=32)
        rng = np.random.RandomState(3)
        params = llama_spmd.init_params(rng, cfg)
        prompt = rng.randint(0, 64, (2 * dp, 5))
        tokens = _generate({"dp": dp, "tp": tp}, cfg, params, prompt, 9)
        return None if tokens is None else {"tokens": tokens}
    body.__name__ = f"generate_dp{dp}_tp{tp}"
    return case("parallel")(body)


for _dp, _tp in ((1, 2), (2, 2), (1, 1)):
    _gen_case(_dp, _tp)


@case("parallel")
def generate_vs_forward(inp):
    from . import llama_spmd

    cfg = llama_spmd.config(vocab_size=32, dim=16, n_heads=2, ffn_dim=32,
                            n_layers=2, max_seq_len=16)
    rng = np.random.RandomState(7)
    params = llama_spmd.init_params(rng, cfg)
    mesh = _mesh({"dp": 1, "tp": 2})
    prompt = rng.randint(0, 32, (1, 4))
    if not mesh.is_member:
        return None
    sharded = llama_spmd.shard_params(params, mesh)
    got = llama_spmd.generate(sharded, prompt, 6, mesh, cfg)
    seq = prompt.copy()
    with torch.no_grad():
        for _ in range(6):
            logits = llama_spmd.forward_logits(sharded, seq, cfg)
            seq = np.concatenate([seq, [[int(logits[0, -1].argmax())]]], 1)
    try:  # past max_seq_len the cache writes would clamp: it raises
        llama_spmd.generate(sharded, prompt, 14, mesh, cfg)
        err = None
    except ValueError as e:
        err = str(e)
    return {"tokens": got, "chain": seq[:, 4:], "err": err}


def _pp_losses(axes, cfg, params, tokens, targets, micro, prepare):
    from . import pipeline

    mesh = _mesh(axes)
    if not mesh.is_member:
        return None
    pparams = prepare(params, mesh)
    step = pipeline.make_pp_train_step(mesh, cfg, lr=1e-1,
                                       microbatches=micro)
    losses = []
    for _ in range(3):
        pparams, loss = step(pparams, tokens, targets)
        losses.append(float(loss))
    return {"losses": losses,
            "wq": [repr(p) for p in pparams["wq"].placements],
            "wk": [repr(p) for p in pparams["wk"].placements],
            "axes": list(mesh.axis_names)}


_PP = {"pp4_m4": ({"pp": 4}, 4), "pp2_m8": ({"pp": 2}, 8),
       "dp2_pp2_m2": ({"dp": 2, "pp": 2}, 2)}
_PP_TP = {"pp2_tp2_m4": ({"pp": 2, "tp": 2}, 4),
          "pp2_tp2_m2": ({"pp": 2, "tp": 2}, 2)}
_PP_GQA = {"h4_kv2_tp2": (4, 2, 2), "h4_kv1_tp2": (4, 1, 2),
           "h8_kv2_tp4": (8, 2, 4)}


def _pp_case(name, axes, micro):
    def body(inp):
        from . import llama_spmd, pipeline

        cfg = llama_spmd.config(vocab_size=64, dim=16, n_heads=2,
                                ffn_dim=32, n_layers=4, max_seq_len=16)
        rng = np.random.RandomState(0)
        tokens = rng.randint(0, 64, (8, 8))
        targets = rng.randint(0, 64, (8, 8))
        return _pp_losses(
            axes, cfg, llama_spmd.init_params(np.random.RandomState(1), cfg),
            tokens, targets, micro, lambda p, m: pipeline.shard_stage_params(
                pipeline.stack_stages(p, axes["pp"]), m))
    body.__name__ = "pipeline_" + name
    return case("parallel")(body)


def _pp_tp_case(name, axes, micro):
    def body(inp):
        from . import llama_spmd, pipeline

        cfg = llama_spmd.config(vocab_size=64, dim=16, n_heads=2,
                                ffn_dim=32, n_layers=4, max_seq_len=16)
        rng = np.random.RandomState(3)
        tokens = rng.randint(0, 64, (8, 8))
        targets = rng.randint(0, 64, (8, 8))
        return _pp_losses(
            axes, cfg, llama_spmd.init_params(np.random.RandomState(4), cfg),
            tokens, targets, micro,
            lambda p, m: pipeline.prepare_pp_params(p, m, axes["pp"]))
    body.__name__ = "pipeline_" + name
    return case("parallel")(body)


def _pp_gqa_case(name, n_heads, n_kv, tp):
    def body(inp):
        from . import llama_spmd, pipeline

        cfg = llama_spmd.config(vocab_size=64, dim=16 * n_heads // 4,
                                n_heads=n_heads, ffn_dim=32, n_layers=4,
                                max_seq_len=16, n_kv_heads=n_kv)
        rng = np.random.RandomState(3)
        tokens = rng.randint(0, 64, (8, 8))
        targets = rng.randint(0, 64, (8, 8))
        pp = 2 if tp == 2 else 1
        axes = {"dp": 4 // (pp * tp), "pp": pp, "tp": tp}
        out = _pp_losses(
            axes, cfg, llama_spmd.init_params(np.random.RandomState(4), cfg),
            tokens, targets, 2,
            lambda p, m: pipeline.prepare_pp_params(p, m, pp, cfg=cfg))
        try:
            pipeline.prepare_pp_params(
                llama_spmd.init_params(np.random.RandomState(4), cfg),
                _mesh(axes), pp)
            out["no_cfg"] = None
        except ValueError as e:
            out["no_cfg"] = str(e)
        return out
    body.__name__ = "pipeline_gqa_" + name
    return case("parallel")(body)


for _k, (_a, _m) in _PP.items():
    _pp_case(_k, _a, _m)
for _k, (_a, _m) in _PP_TP.items():
    _pp_tp_case(_k, _a, _m)
for _k, _v in _PP_GQA.items():
    _pp_gqa_case(_k, *_v)


@case("parallel")
def pipeline_identity(inp):
    from .mesh import local, shard
    from .pipeline import pipeline_apply

    mesh = _mesh({"pp": 4})
    marks = shard(np.array([1.0, 10.0, 100.0, 1000.0])[:, None], mesh, "pp")
    x = torch.arange(12.0, dtype=torch.float64).reshape(6, 2)
    got = pipeline_apply(lambda m, h: h + m[0], local(marks), x, axis="pp",
                         n_stages=4, mesh=mesh)
    return {"got": got.numpy()}


# ------------------------------- moe ----------------------------------- #
@case("parallel")
def moe_reference(inp):
    from . import moe

    rng = np.random.RandomState(0)
    params = moe.init_moe_params(rng, 4, 8, 16)
    x = torch.as_tensor(rng.standard_normal((32, 8)), dtype=torch.float32)
    out, aux = moe.moe_ffn(params, x)
    e, pos, keep = moe._decisions(params, x)
    return {"out": out.numpy(), "aux": float(aux),
            "ref": moe.moe_ffn_reference(params, x.numpy()),
            "expert": e.numpy(), "pos": pos.numpy(), "keep": keep.numpy()}


@case("parallel")
def moe_capacity(inp):
    from . import moe

    rng = np.random.RandomState(1)
    params = moe.init_moe_params(rng, 4, 8, 16)
    params["wg"] = torch.zeros_like(params["wg"])
    x = torch.as_tensor(rng.standard_normal((16, 8)), dtype=torch.float32)
    out, _ = moe.moe_ffn(params, x, capacity_factor=1.0)
    e, pos, keep = moe._decisions(params, x, capacity_factor=1.0)
    return {"out": out.numpy(), "capacity": moe.capacity(16, 4, 1.0),
            "ref": moe.moe_ffn_reference(params, x.numpy(), 1.0),
            "pos": pos.numpy(), "keep": keep.numpy()}


@case("parallel")
def moe_expert_parallel(inp):
    from . import moe
    from ._dryrun import _as_placed

    rng = np.random.RandomState(2)
    params = moe.init_moe_params(rng, 8, 8, 16)
    x = torch.as_tensor(rng.standard_normal((64, 8)), dtype=torch.float32)
    mesh = _mesh({"ep": 4})
    sharded = moe.shard_moe_params(params, mesh)
    leaves = {k: v.to_local().detach().requires_grad_()
              for k, v in sharded.items()}
    out, aux = moe.moe_ffn(_as_placed(leaves, sharded), x)
    loss = (out ** 2).sum() + 0.01 * aux
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(
        leaves.values()))))
    whole = {k: _np(_as_placed({k: g}, {k: sharded[k]})[k])
             for k, g in grads.items()}
    return {"out": out.detach().numpy(), "loss": float(loss.detach()),
            "grads": whole, "w1_local": tuple(leaves["w1"].shape)}


@case("parallel")
def dryrun(inp):
    from ._dryrun import run

    return {"line": run(4)}


# --------------------------- ring attention ---------------------------- #
def _ring_case(causal):
    def body(inp):
        from .mesh import shard
        from .ring_attention import ring_attention

        mesh = _mesh({"sp": 4})
        rng = np.random.default_rng(0)
        q, k, v = (rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
                   for _ in range(3))
        got = ring_attention(*(shard(a, mesh, None, "sp")
                               for a in (q, k, v)), mesh, causal=causal)
        return {"out": _np(got), "placements": [repr(p) for p in
                                                got.placements]}
    body.__name__ = f"ring_causal_{causal}"
    return case("parallel")(body)


_ring_case(True)
_ring_case(False)


@case("parallel")
def ring_grad(inp):
    from .ring_attention import ring_attention

    mesh = _mesh({"sp": 4})
    rng = np.random.default_rng(1)
    q = torch.as_tensor(rng.standard_normal((1, 32, 2, 8)),
                        dtype=torch.float32).requires_grad_()
    out = ring_attention(q, q, q, mesh, causal=True)
    (g,) = torch.autograd.grad((out ** 2).sum(), [q])
    return {"grad": g.numpy(), "out": out.detach().numpy()}


def _gqa_case(dp, tp):
    def body(inp):
        from . import llama_spmd

        cfg = llama_spmd.config(vocab_size=64, dim=16, n_heads=4,
                                n_kv_heads=2, ffn_dim=32, n_layers=2,
                                max_seq_len=32)
        rng = np.random.RandomState(5)
        params = llama_spmd.init_params(rng, cfg)
        prompt = rng.randint(0, 64, (2 * dp, 5))
        mesh = _mesh({"dp": dp, "tp": tp})
        toks = None if not mesh.is_member else llama_spmd.generate(
            llama_spmd.shard_params(params, mesh), prompt, 9, mesh, cfg)
        params2 = llama_spmd.init_params(rng, cfg)
        tokens = rng.randint(0, 64, (4 * dp, 8))
        if not mesh.is_member:
            return None
        losses, _ = _train(mesh, cfg, params2, tokens, tokens, 1e-2, 3)
        return {"tokens": toks, "losses": losses}
    body.__name__ = f"gqa_dp{dp}_tp{tp}"
    return case("parallel")(body)


_gqa_case(1, 2)
_gqa_case(2, 2)


# ------------------------------ serving -------------------------------- #
SERVE_CFG = dict(vocab_size=256, embed_dim=32, n_heads=4, ffn_dim=64,
                 max_seq_len=64, max_batch_size=2, n_layers=2)
PA = [1, 5, 9, 4, 7, 2, 8, 3, 6, 1, 2, 4]
PB = PA[:10] + [7, 5]


def _model(ckpt, **over):
    """A port Llama on the CPU with the JAX package's weights (its
    ``.npz`` checkpoint, written transposed to the port's layout)."""
    from ..models.llama.model import Llama
    from ..utils.checkpoint import load_checkpoint

    m = Llama(**dict(SERVE_CFG, **over), device="cpu")
    load_checkpoint(ckpt, m)
    return m.eval()


def _serve(model, axes, requests, step_after_first=False, **kw):
    """Tokens of ``requests`` [(prompt, max_new, submit kwargs)] served on a
    fresh server over ``axes``; None outside the mesh."""
    from .serve_spmd import SpmdLlamaServer

    mesh = _mesh(axes)
    if not mesh.is_member:
        return None
    with torch.no_grad():
        srv = SpmdLlamaServer(model, mesh, **kw)
        rids = []
        for i, (p, n, skw) in enumerate(requests):
            rids.append(srv.submit(p, max_new_tokens=n, **skw))
            if i == 0 and step_after_first:
                srv.step()
        srv.run()
    return {"tokens": [srv._finished[r].tokens for r in rids],
            "truncated": [srv._finished[r].truncated for r in rids],
            "prefix_hits": srv.prefix_hits,
            "prefix_rows_reused": srv.prefix_rows_reused}


PROMPTS = [[1, 5, 9], [2, 7, 3, 11], [30, 20], [4, 4, 4, 4, 4]]
_SERVE_MESHES = {"dp2_tp2": ({"dp": 2, "tp": 2}, 2), "dp4": ({"dp": 4}, 4),
                 "tp4": ({"tp": 4}, 2)}


def _serve_case(name, axes, B):
    def body(inp):
        return _serve(_model(inp["ckpt"]), axes,
                      [(p, 8, {}) for p in PROMPTS], batch_size=B, chunk=4,
                      eos_id=-1)
    body.__name__ = "serve_" + name
    return case("serve")(body)


for _k, (_a, _b) in _SERVE_MESHES.items():
    _serve_case(_k, _a, _b)


@case("serve")
def gqa(inp):
    return _serve(_model(inp["ckpt"], n_kv_heads=2), {"tp": 4},
                  [([1, 5, 9], 6, {}), ([2, 7, 3], 6, {})], batch_size=2,
                  chunk=4, eos_id=-1)


@case("serve")
def params_pair(inp):
    from .serve_spmd import SpmdLlamaServer, params_from_model

    params, cfg = params_from_model(_model(inp["ckpt"]))
    mesh = _mesh({"dp": 2, "tp": 2})
    with torch.no_grad():
        srv = SpmdLlamaServer(params, mesh, cfg=cfg, batch_size=2, chunk=4,
                              eos_id=-1)
        rid = srv.submit([3, 1, 4], max_new_tokens=5)
        done = srv.run()
    try:
        SpmdLlamaServer(params, mesh, cfg=cfg, batch_size=3)
        err = None
    except ValueError as e:
        err = str(e)
    return {"tokens": done[rid].tokens, "err": err}


@case("serve")
def eos_truncation(inp):
    model = _model(inp["ckpt"])
    a = _serve(model, {"dp": 2, "tp": 2}, [([1, 2, 3], 1000, {})],
               batch_size=2, chunk=4, eos_id=-1)
    b = _serve(model, {"dp": 2, "tp": 2}, [([5, 6], 8, {})], batch_size=2,
               chunk=4, eos_id=inp["eos"])
    return {"long": a, "eos": b}


@case("serve")
def seeded_sampling(inp):
    model = _model(inp["ckpt"])
    req = ([1, 6, 2], 8, dict(temperature=0.9, top_k=17, top_p=0.95,
                              seed=1234))

    def fleet(extra, server_seed):
        reqs = [(p, 6, dict(temperature=0.7, top_k=9)) for p in extra]
        return _serve(model, {"dp": 2, "tp": 2}, reqs + [req],
                      batch_size=2, chunk=4, eos_id=-1,
                      seed=server_seed)["tokens"][-1]

    return {"a": fleet([], 0), "b": fleet([[7, 7], [3, 1, 4, 1, 5]], 42)}


def _quant_case(quant):
    def body(inp):
        model = _model(inp["ckpt"])
        reqs = [(p, 8, {}) for p in PROMPTS[:3]]
        kw = dict(batch_size=2, chunk=4, eos_id=-1, quant=quant)
        return {"mesh": _serve(model, {"dp": 2, "tp": 2}, reqs, **kw),
                "one": _serve(model, {"dp": 1}, reqs, **kw)}
    body.__name__ = "quant_" + quant
    return case("serve")(body)


_quant_case("int8")
_quant_case("int4")


@case("serve")
def prefix_cache(inp):
    return _serve(_model(inp["ckpt"], max_seq_len=128), {"dp": 2, "tp": 2},
                  [(PA, 6, {}), (PB, 6, {})], step_after_first=True,
                  batch_size=2, chunk=4, eos_id=-1, prefix_cache=True)


def _reuse_pair(inp, **kw):
    model = _model(inp["ckpt"], max_seq_len=128)
    mesh = {"dp": 2, "tp": 2}
    kw = dict(kw, batch_size=2, chunk=4, eos_id=-1)
    warm = _serve(model, mesh, [(PA, 6, {}), (PB, 8, {})],
                  step_after_first=True, prefix_cache=True, **kw)
    cold = _serve(model, mesh, [(PB, 8, {})], prefix_cache=False, **kw)
    return {"warm": warm, "cold": cold}


@case("serve")
def quant_prefix(inp):
    return _reuse_pair(inp, quant="int8")


@case("serve")
def mixed_fleet(inp):
    return _serve(_model(inp["ckpt"]), {"dp": 2, "tp": 2},
                  [([1, 5, 9], 8, dict(temperature=0.8, seed=3)),
                   ([2, 7, 3, 11], 8, {})], batch_size=2, chunk=4,
                  eos_id=-1)


@case("serve")
def kv_quant(inp):
    return _serve(_model(inp["ckpt"]), {"dp": 2, "tp": 2},
                  [(p, 6, {}) for p in ([1, 5, 9], [2, 7, 3], [30, 20])],
                  batch_size=2, chunk=4, eos_id=-1, kv_quant="int8")


@case("serve")
def kv_quant_quant_prefix(inp):
    out = _reuse_pair(inp, quant="int4", kv_quant="int8")
    try:
        _serve(_model(inp["ckpt"]), {"dp": 2, "tp": 2}, [], kv_quant="int4")
        out["err"] = None
    except ValueError as e:
        out["err"] = str(e)
    return out


# -------------------------- sharded checkpoint ------------------------- #
CKPT_RULES = (("0.weight", ("None", "tp")), ("0.bias", ("tp",)),
              ("2.weight", ("tp", "None")))


def _rules():
    from .mesh import P

    return [(pat, P(*(None if s == "None" else s for s in spec)))
            for pat, spec in CKPT_RULES]


def _adam_mlp(state):
    from .. import jit, nn, optim
    from ..utils.checkpoint import load_state_dict

    net = nn.Sequential(nn.Linear(6, 16), nn.Tanh(), nn.Linear(16, 3))
    load_state_dict(net, state)
    opt = optim.Adam(net.parameters(), lr=1e-2)
    return net, opt, jit(_mse_step(net, opt), state=(net, opt),
                         mesh=_mesh({"dp": 2, "tp": 2}),
                         shard_rules=_rules())


def _snap(net, opt):
    out = {n: _np(p).copy() for n, p in net.named_parameters()}
    for name in ("v", "m"):
        for i, b in enumerate(getattr(opt, name, None) or []):
            out[f"opt.{name}.{i}"] = _np(b).copy()
    return out


@case("ckpt")
def round_trip(inp):
    from ..utils import load_sharded, save_sharded

    net, opt, js = _adam_mlp(inp["W"])
    X, Y = _t(inp["X"]), _t(inp["Y"])
    first = [float(js(X, Y)) for _ in range(3)]
    placement = _placement(net[0].weight)
    save_sharded(inp["dir"] + "/ckpt", net, opt, step=3)
    ref = _snap(net, opt)
    ref_losses = [float(js(X, Y)) for _ in range(3)]
    step = load_sharded(inp["dir"] + "/ckpt", net, opt)
    restored = _snap(net, opt)
    got_losses = [float(js(X, Y)) for _ in range(3)]
    return {"first": first, "step": step, "ref": ref, "restored": restored,
            "placement": placement, "after": _placement(net[0].weight),
            "ref_losses": ref_losses, "got_losses": got_losses}


@case("ckpt")
def fresh_model(inp):
    from ..utils import load_sharded, save_sharded

    X, Y = _t(inp["X"]), _t(inp["Y"])
    net, opt, js = _adam_mlp(inp["W"])
    losses = [float(js(X, Y)) for _ in range(4)]
    save_sharded(inp["dir"] + "/fresh", net, opt, step=4)
    net2, opt2, js2 = _adam_mlp(inp["W2"])
    js2(X, Y)
    step = load_sharded(inp["dir"] + "/fresh", net2, opt2)
    return {"losses": losses, "step": step,
            "cont1": [float(js(X, Y)) for _ in range(2)],
            "cont2": [float(js2(X, Y)) for _ in range(2)]}


@case("ckpt")
def async_save(inp):
    from .. import nn, optim
    from ..utils import load_sharded, save_sharded
    from ..utils.checkpoint import load_state_dict

    def build(state):
        net = nn.Sequential(nn.Linear(6, 16), nn.Tanh(), nn.Linear(16, 3))
        load_state_dict(net, state)
        return net, optim.Adam(net.parameters(), lr=1e-2)

    net, opt = build(inp["W"])
    ck = save_sharded(inp["dir"] + "/async", net, opt, step=1,
                      async_save=True)
    ck.wait_until_finished()
    net2, _ = build(inp["W2"])
    step = load_sharded(inp["dir"] + "/async", net2, None)
    return {"step": step, "a": _params(net), "b": _params(net2)}


@case("ckpt")
def tree_resume(inp):
    from ..utils import load_sharded_tree, save_sharded_tree
    from . import llama_spmd

    mesh = _mesh({"dp": 2, "tp": 2})
    cfg = llama_spmd.config(vocab_size=64, dim=16, n_heads=2, ffn_dim=32,
                            n_layers=2, max_seq_len=16)
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, 64, (8, 8))
    targets = rng.randint(0, 64, (8, 8))
    losses, params = _train(
        mesh, cfg, llama_spmd.init_params(np.random.RandomState(1), cfg),
        tokens, targets, 1e-1, 2)
    step = llama_spmd.make_train_step(mesh, cfg, lr=1e-1)
    save_sharded_tree(inp["dir"] + "/spmd", params)
    want = float(step(params, tokens, targets)[1])
    restored = load_sharded_tree(inp["dir"] + "/spmd", params)
    got = float(step(restored, tokens, targets)[1])
    return {"losses": losses, "want": want, "got": got,
            "same_placement": all(
                restored[k].placements == params[k].placements
                for k in params),
            "equal": all(bool(torch.equal(restored[k].to_local(),
                                          params[k].to_local()))
                         for k in params)}


@case("ckpt")
def strict_missing(inp):
    from .. import nn
    from ..utils import load_sharded, save_sharded

    net = nn.Sequential(nn.Linear(6, 16), nn.Tanh(), nn.Linear(16, 3))
    save_sharded(inp["dir"] + "/strict", net, None)

    class Bigger(nn.Module):
        def __init__(self):
            super().__init__()
            self.base = nn.Sequential(nn.Linear(6, 16), nn.Tanh(),
                                      nn.Linear(16, 3))
            self.extra = nn.Linear(3, 3)

    try:
        load_sharded(inp["dir"] + "/strict", Bigger(), None)
        return {"err": None}
    except KeyError as e:
        return {"err": str(e)}
