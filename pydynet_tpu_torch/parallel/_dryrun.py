"""A small step of every parallel axis on ranks of one host (counterpart of
``pydynet_tpu/parallel/_dryrun.py``, which runs them on a virtual CPU
mesh).

    python -m pydynet_tpu_torch.parallel._dryrun 4      # 4 gloo CPU ranks
    torchrun --nproc-per-node 4 -m pydynet_tpu_torch.parallel._dryrun

``main(n)`` spawns ``n`` gloo CPU ranks (:func:`spawn`, a ``FileStore``
under a temporary directory, no TCP port to race for) and runs :func:`run`
on each. Under ``torchrun`` it joins the launcher's group instead and uses
the ranks it is given, on the cards (``--device cpu`` for gloo).
"""
from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time
import traceback
from datetime import timedelta


def _rank_main(fn, rank, n, store, args, timeout):
    import torch
    import torch.distributed as dist

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store, n),
                                rank=rank, world_size=n,
                                timeout=timedelta(seconds=min(timeout, 120)))
        fn(rank, n, *args)
        dist.destroy_process_group()
    except BaseException:
        with open(f"{store}.err{rank}", "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn(fn, n: int, *args, timeout: float = 300.0):
    """Run ``fn(rank, n, *args)`` on ``n`` gloo CPU ranks (spawned
    processes, one thread each) and wait. ``fn`` must be importable by
    name. Raises ``RuntimeError`` with the rank's traceback when a rank
    fails, and ``TimeoutError`` after ``timeout`` seconds; either way every
    rank is stopped. A collective that waits more than 120 s raises in its
    rank."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    d = tempfile.mkdtemp(prefix="pdt_ranks_")
    store = os.path.join(d, "store")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, n, store, args, timeout), daemon=True)
             for r in range(n)]
    try:
        for p in procs:
            p.start()
        deadline = time.time() + timeout
        while True:
            codes = [p.exitcode for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                r = bad[0]
                err = f"{store}.err{r}"
                tb = open(err).read() if os.path.exists(err) else ""
                raise RuntimeError(
                    f"rank {r} of {n} failed (exit {codes[r]}):\n{tb}")
            if all(c == 0 for c in codes):
                return
            if time.time() > deadline:
                raise TimeoutError(f"{n} ranks did not finish within "
                                   f"{timeout:.0f} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(5)
        shutil.rmtree(d, ignore_errors=True)


def run(n_devices: int, device_type: str = "cpu") -> str:
    """One small step of every axis on the first ``n_devices`` ranks: the
    dp x tp train step and tp decode, dp x tp serving (then with int8
    weights, the int8 KV cache and the prefix cache), the dp x pp x tp
    GPipe step, sp ring attention, ``jit(mesh=).foreach`` over dp, and an
    ep MoE forward and gradient. Returns the summary line (every rank)."""
    import numpy as np
    import torch

    from .. import jit, nn, optim
    from . import llama_spmd, moe, pipeline
    from .mesh import make_mesh, shard
    from .ring_attention import ring_attention
    from .serve_spmd import SpmdLlamaServer

    # ---- dp x tp: train step + tp-sharded decode ---- #
    tp = 2 if n_devices % 2 == 0 else 1
    dp = n_devices // tp
    mesh = make_mesh({"dp": dp, "tp": tp}, device_type=device_type)
    cfg = llama_spmd.config(vocab_size=128, dim=32, n_heads=2, ffn_dim=64,
                            n_layers=2, max_seq_len=16, n_kv_heads=1)
    rng = np.random.RandomState(0)
    params = llama_spmd.shard_params(llama_spmd.init_params(rng, cfg), mesh)
    B, L = 2 * dp, 8
    tokens = rng.randint(0, cfg["vocab_size"], (B, L))
    targets = rng.randint(0, cfg["vocab_size"], (B, L))
    step = llama_spmd.make_train_step(mesh, cfg, lr=1e-2)
    params, loss = step(params, tokens, targets)
    loss = float(loss)
    assert np.isfinite(loss), f"non-finite loss {loss}"
    toks = llama_spmd.generate(params, tokens[:, :4], 4, mesh, cfg)
    assert toks.shape == (B, 4), toks.shape

    # ---- dp x tp serving ---- #
    srv = SpmdLlamaServer(params, mesh, cfg=cfg, batch_size=dp, chunk=4,
                          eos_id=-1)
    srids = [srv.submit([1, 2, 3], max_new_tokens=4),
             srv.submit([4, 5], max_new_tokens=4)]
    sdone = srv.run()
    assert set(sdone) == set(srids) and \
        all(len(sdone[r].tokens) == 4 for r in srids)
    qsrv = SpmdLlamaServer(params, mesh, cfg=cfg, batch_size=dp, chunk=4,
                           eos_id=-1, quant="int8", kv_quant="int8",
                           prefix_cache=True)
    pa = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10]
    qa = qsrv.submit(pa, max_new_tokens=6)
    qsrv.step()
    qb = qsrv.submit(pa[:9] + [11], max_new_tokens=3)
    qdone = qsrv.run()
    assert set(qdone) == {qa, qb} and qsrv.prefix_hits == 1, \
        (sorted(qdone), qsrv.prefix_hits)

    # ---- dp x pp x tp: GPipe with tp inside the stages ---- #
    pp = 2 if n_devices % 2 == 0 else 1
    ptp = 2 if n_devices % 4 == 0 else 1
    pdp = n_devices // (pp * ptp)
    pp_mesh = make_mesh({"dp": pdp, "pp": pp, "tp": ptp},
                        device_type=device_type)
    pp_cfg = llama_spmd.config(vocab_size=128, dim=32, n_heads=2, ffn_dim=64,
                               n_layers=2 * pp, max_seq_len=16, n_kv_heads=1)
    pp_params = pipeline.prepare_pp_params(
        llama_spmd.init_params(rng, pp_cfg), pp_mesh, pp, cfg=pp_cfg)
    pp_step = pipeline.make_pp_train_step(pp_mesh, pp_cfg, lr=1e-2,
                                          microbatches=2)
    ptokens = rng.randint(0, 128, (2 * pdp, 8))
    ptargets = rng.randint(0, 128, (2 * pdp, 8))
    pp_params, pp_loss = pp_step(pp_params, ptokens, ptargets)
    pp_loss = float(pp_loss)
    assert np.isfinite(pp_loss), f"non-finite pp loss {pp_loss}"

    # ---- sp: ring attention ---- #
    sp_mesh = make_mesh({"sp": n_devices}, device_type=device_type)
    q = shard(rng.standard_normal((1, 8 * n_devices, 2, 8)).astype(
        np.float32), sp_mesh, None, "sp")
    att = ring_attention(q, q, q, sp_mesh, causal=True)
    assert bool(torch.isfinite(att.full_tensor()).all())

    # ---- foreach x mesh: dp-split whole-epoch steps ---- #
    np.random.seed(0)
    dev = sp_mesh.device
    net = nn.Sequential(nn.Linear(6, 8), nn.Tanh(), nn.Linear(8, 3)).to(dev)
    opt = optim.SGD(net.parameters(), lr=0.1, momentum=0.0, nesterov=False)

    def train_step(x, y):
        opt.zero_grad()
        l_ = nn.functional.mse_loss(net(x), y)
        l_.backward()
        opt.step()
        return l_

    dp_mesh = make_mesh({"dp": n_devices}, device_type=device_type)
    js = jit(train_step, state=(net, opt), mesh=dp_mesh)
    Xb = torch.as_tensor(rng.standard_normal((3, 2 * n_devices, 6)),
                         dtype=torch.float32)
    Yb = torch.as_tensor(rng.standard_normal((3, 2 * n_devices, 3)),
                         dtype=torch.float32)
    fe_losses = js.foreach(Xb, Yb).reshape(-1)
    assert bool(torch.isfinite(fe_losses).all()), fe_losses

    # ---- ep: expert-parallel switch MoE forward + gradient ---- #
    ep_mesh = make_mesh({"ep": n_devices}, device_type=device_type)
    mparams = moe.shard_moe_params(
        moe.init_moe_params(rng, n_devices, 16, 32), ep_mesh)
    leaves = {k: v.to_local().detach().requires_grad_()
              for k, v in mparams.items()}
    x = torch.as_tensor(rng.standard_normal((32, 16)), dtype=torch.float32)
    out, aux = moe.moe_ffn(_as_placed(leaves, mparams), x)
    mloss = (out ** 2).sum() + 0.01 * aux
    grads = torch.autograd.grad(mloss, list(leaves.values()))
    assert bool(torch.isfinite(mloss)) and all(
        bool(torch.isfinite(g).all()) for g in grads)

    return (f"dryrun_multichip({n_devices}): dp={dp} tp={tp} "
            f"loss={loss:.4f} decode {toks.shape} serve {len(sdone)} reqs; "
            f"dp={pdp}xpp={pp}xtp={ptp} loss={pp_loss:.4f}; "
            f"sp={n_devices} ring-attention; "
            f"foreach x dp={n_devices} epoch loss={float(fe_losses[-1]):.4f};"
            f" ep={n_devices} moe loss={float(mloss.detach()):.4f} OK")


def _as_placed(leaves, like):
    """Local leaves (requiring grad) wrapped as DTensors placed as ``like``,
    so a function of DTensor parameters differentiates to the leaves."""
    from torch.distributed.tensor import DTensor

    return {k: DTensor.from_local(v, like[k].device_mesh, like[k].placements,
                                  run_check=False, shape=like[k].shape,
                                  stride=like[k].stride())
            for k, v in leaves.items()}


def _spawned(rank, n):
    line = run(n)
    if rank == 0:
        print(line, flush=True)


def main(n_devices: int) -> None:
    """``run(n)`` on ``n`` spawned gloo CPU ranks."""
    spawn(_spawned, n_devices, timeout=600)


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        import torch.distributed as dist

        from .mesh import initialize_distributed

        device = "cpu" if "--device=cpu" in sys.argv or (
            "--device" in sys.argv
            and sys.argv[sys.argv.index("--device") + 1] == "cpu") \
            else "cuda"
        initialize_distributed(backend="gloo" if device == "cpu" else None)
        line = run(dist.get_world_size(), device_type=device)
        if dist.get_rank() == 0:
            print(line, flush=True)
        dist.destroy_process_group()
    else:
        main(int(args[0]) if args else 4)
