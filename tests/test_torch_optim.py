"""The port's SGD, Adagrad, Adadelta and learning-rate schedulers
(``pydynet_tpu_torch/optim``) against the JAX package's, on the CPU.

The optimizers take 10 steps over the same gradients (drawn from
``np.random.default_rng``) on the same float32 parameters, one of which
never gets a gradient (it steps as if its gradient were zero); parameters
and buffers are held within 1e-7. The schedulers' learning rates over 40
epochs, read back through the optimizers' float32 rate, are held exact,
with the cosine schedule's restarts and both kinds of resume.
"""
from collections import Counter

import numpy as np
import pytest
import torch

import pydynet_tpu as pdn
from pydynet_tpu import optim as joptim

from pydynet_tpu_torch import optim as toptim

torch.set_num_threads(1)  # six test workers share the CPU: one thread each

SHAPES = ((3, 4), (5,), (2, 3, 2))
OPTIMIZERS = {
    "sgd": ("SGD", dict(lr=0.1)),
    "sgd-plain-wd": ("SGD", dict(lr=0.05, momentum=0.9, nesterov=False,
                                 weight_decay=0.01)),
    "adagrad": ("Adagrad", {}),
    "adagrad-wd": ("Adagrad", dict(lr=0.3, weight_decay=0.1, eps=1e-6)),
    "adadelta": ("Adadelta", {}),
    "adadelta-wd": ("Adadelta", dict(lr=0.5, rho=0.5, weight_decay=0.02)),
}
BUFFERS = {"SGD": "v", "Adagrad": "G", "Adadelta": "G"}


def params(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in SHAPES]


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_steps_match_jax(name):
    """10 steps, defaults and weight decay included: parameters and the
    buffers (``v``, ``G``) within 1e-7; the last parameter never has a
    gradient."""
    cls, kw = OPTIMIZERS[name]
    init = params()
    jp = [pdn.Tensor(a, requires_grad=True) for a in init]
    tp = [torch.tensor(a, requires_grad=True) for a in init]
    jopt = getattr(joptim, cls)(jp, **kw)
    topt = getattr(toptim, cls)(tp, **kw)
    assert isinstance(topt.lr, float) and topt.lr == jopt.lr
    rng = np.random.default_rng(1)
    for _ in range(10):
        for j, t in zip(jp[:-1], tp[:-1]):
            g = rng.standard_normal(j.shape).astype(np.float32)
            j.grad = g
            t.grad = torch.from_numpy(g)
        jopt.step()
        topt.step()
    for j, t in zip(jp, tp):
        np.testing.assert_allclose(t.detach().numpy(), j.numpy(), atol=1e-7,
                                   rtol=0)
    moved = not np.array_equal(tp[-1].detach().numpy(), init[-1])
    assert moved == bool(kw.get("weight_decay"))  # g = 0 (+ decay)
    buf = BUFFERS[cls]
    for j, t in zip(getattr(jopt, buf), getattr(topt, buf)):
        np.testing.assert_allclose(t.numpy(), j.numpy(), atol=1e-7, rtol=0)


def test_sgd_defaults_are_the_reference_rule():
    """Momentum 0.5 and Nesterov by default: with lr 0.1 and g 2 the first
    step moves p by v + lr g = 0.2 + 0.2, the second by 0.3 + 0.2."""
    w = torch.tensor([1.0], requires_grad=True)
    opt = toptim.SGD([w], lr=0.1)
    assert (opt.momentum, opt.nesterov, opt.weight_decay) == (0.5, True, 0)
    for want in (0.6, 0.1):
        w.grad = torch.tensor([2.0])
        opt.step()
        assert abs(float(w) - want) < 1e-6


SCHEDULERS = {
    "exponential": ("ExponentialLR", dict(gamma=0.9)),
    "step": ("StepLR", dict(step_size=3, gamma=0.7)),
    "multistep": ("MultiStepLR", dict(milestones=[5, 5, 12, 30],
                                      gamma=0.5)),
    "cosine": ("CosineAnnealingLR", dict(T_max=10, eta_min=0.001)),
    "cosine-0": ("CosineAnnealingLR", dict(T_max=7)),
}


def run(opt_mod, sched_mod, cls, kw, epochs=40, lr=0.1):
    """The rate after construction and after each of ``epochs`` steps."""
    w = pdn.Tensor(np.ones(2), requires_grad=True) \
        if opt_mod is joptim else torch.ones(2, requires_grad=True)
    opt = opt_mod.SGD([w], lr=lr)
    sched = getattr(sched_mod, cls)(opt, **kw)
    lrs = [opt.lr]
    for _ in range(epochs):
        sched.step()
        lrs.append(opt.lr)
    return lrs, opt, sched


@pytest.mark.parametrize("name", list(SCHEDULERS))
def test_scheduler_rates_match_jax(name):
    """40 epochs of rates equal the JAX package's exactly (Exponential and
    Step compound, MultiStep counts repeated milestones, Cosine restarts at
    epochs 11 and 31 of T_max 10)."""
    cls, kw = SCHEDULERS[name]
    want, _, jsched = run(joptim, joptim.lr_scheduler, cls, kw)
    got, _, tsched = run(toptim, toptim.lr_scheduler, cls, kw)
    assert got == want
    assert tsched.last_epoch == jsched.last_epoch == 40
    if cls == "MultiStepLR":
        assert tsched.milestones == Counter({5: 2, 12: 1, 30: 1})


@pytest.mark.parametrize("name", list(SCHEDULERS))
def test_scheduler_resumes_match_jax(name):
    """Both kinds of resume at epoch 13: ``last_epoch=`` with the
    optimizer's ``initial_lr`` and its rate restored, and
    ``load_state_dict`` of the saved scheduler state; each continues to
    epoch 40 with the JAX package's rates exactly."""
    cls, kw = SCHEDULERS[name]
    out = {}
    for opt_mod in (joptim, toptim):
        lrs, opt, sched = run(opt_mod, opt_mod.lr_scheduler, cls, kw,
                              epochs=13)
        state = dict(sched.state_dict())
        w = torch.ones(1) if opt_mod is toptim else pdn.Tensor(np.ones(1))
        by_epoch = opt_mod.SGD([w], lr=lrs[-1])
        by_epoch.initial_lr = opt.initial_lr
        a = getattr(opt_mod.lr_scheduler, cls)(by_epoch, last_epoch=13,
                                               **kw)
        by_state = opt_mod.SGD([w], lr=lrs[-1])
        by_state.initial_lr = opt.initial_lr
        b = getattr(opt_mod.lr_scheduler, cls)(by_state, last_epoch=13,
                                               **kw)
        b.load_state_dict(state)
        by_state.lr = lrs[-1]
        seqs = ([by_epoch.lr], [])
        for _ in range(27):
            a.step()
            seqs[0].append(by_epoch.lr)
            b.step()
            seqs[1].append(by_state.lr)
        out[opt_mod] = (lrs, seqs)
    assert out[toptim] == out[joptim]
    full, _, _ = run(toptim, toptim.lr_scheduler, cls, kw)
    assert out[toptim][1][1] == full[14:]  # the state resume is exact
