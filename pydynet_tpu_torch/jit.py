"""``jit``: an imperative train or eval step run as one CUDA graph on a GPU
(counterpart of ``pydynet_tpu/jit.py``).

    jtrain = jit(train_step, state=(net, optimizer))
    loss = jtrain(bx, by)              # net and optimizer updated in place
    losses = jtrain.foreach(Xb, Yb)    # a call a slice of the leading axis

The JAX package traces the step once and runs it as one XLA program. The
port's counterpart on a GPU is one CUDA graph of the whole step: forward,
``loss.backward()`` and ``optimizer.step()``, PyTorch's whole-network
capture.

* A signature's first call runs ``fn`` eagerly. It is a real step, which
  builds the kernels, moves the generators' keys to the device and
  allocates what the step keeps.
* Its second call captures ``fn`` into a ``torch.cuda.CUDAGraph`` and
  replays it once, since a capture runs nothing.
* Every later call copies its tensor arguments into the graph's inputs,
  replays, and returns clones of the graph's outputs in their structure (a
  later replay overwrites the graph's own).

The signature is the shapes, types and devices of the tensor arguments,
the other arguments with the tree they sit in, and
``torch.is_grad_enabled()``; each gets its own graph (:attr:`graphs`, each
with its ``replays``). A wrapper's Python launch counter moves only while
``fn`` runs in Python, at the eager call and at the capture, so the
launches of a kernel inside a graph are its launches recorded in the
capture times the graph's replays (``ops/batchnorm.py`` counts those as
``captured``).

On the CPU every call runs ``fn`` eagerly: the same semantics with nothing
to capture, the route the tests take. Outputs are detached on both routes,
as the JAX jit's are.

The state (``state=``: modules, optimizers, threefry generators, torch
tensors, the tape's ``Tensor``s, and lists, tuples or dicts of them;
``random.default_generator`` always)
is what the step reads and updates in place: every parameter and buffer
(BatchNorm's running statistics), every optimizer buffer with its learning
rate and step count, every generator's key. A graph reads and writes the
memory it saw at its capture, so the state must stay in its tensors: if
``fn`` rebinds a state tensor during the capture, or a state tensor holds
other memory at a later replay, the call raises and names it. A
generator's key that a draw elsewhere moved is copied back into the
graph's buffer instead. Nothing falls back to the eager route.

Tape ``Tensor``s (``core/tensor.py``) may be arguments, state and outputs:
an argument reaches ``fn`` as a Tensor over the graph's input buffer, and
an output comes back as a Tensor over a clone, on both routes. A tape step
(``w.zero_grad()``, ``loss.backward()``, ``w.data -= lr * w.grad``) writes
its state in place, so it captures: the tape's Python bookkeeping runs at
the capture only, and the replays run its kernels.

As with the JAX jit, Python control flow is fixed at the capture, the
train or eval mode included: use one jit a mode. A step may not wait for
the host while it is captured (``.item()``, ``float(optimizer.lr)``,
printing a tensor). ``donate_state`` is taken and has no effect, since the
state is updated in place anyway.

``mesh=`` (a ``parallel.Mesh``) runs the step SPMD on every rank of the
mesh (``parallel/mesh.py``'s execution model): at the first call the state
is placed on the mesh as DTensors, once, in place of its tensors: a module's
parameter or buffer by the first ``shard_rules`` entry (``(fnmatch pattern,
P(...))`` on its dotted name) that matches, an optimizer's buffers as their
parameter (paired by index), everything else replicated. A tensor argument
whose leading dimension divides the ``batch_axis`` size is split over it,
any other replicated. DTensor propagates the collectives through the step:
plain tensors made inside it count as replicated, a module's output whose
reduction is pending (a row-parallel product's partial sums) is reduced at
the module's boundary, and each gradient is redistributed to its
parameter's placement as it is accumulated (the sum over ``dp`` among
them), so the optimizer's in-place update is its plain arithmetic. Every
rank gets the step's outputs whole. On a GPU the step is captured as on
one device, the collectives (NCCL) inside the graph.
"""
from __future__ import annotations

import fnmatch
import functools

import torch
from torch.utils import _pytree as pytree

from . import random as _random
from .core.tensor import Tensor
from .device import Device
from .optim.optimizer import Optimizer

__all__ = ["jit"]

_OPT_BUFFERS = ("v", "m", "G")
_OPT_SCALARS = ("_lr_tensor", "_t_tensor")


def _collect_state(state) -> list:
    """``(name, tensor, holder)`` for every state tensor, each once, in a
    fixed order; ``holder`` is the Generator whose key the tensor is, or the
    tape Tensor whose array it is, else None."""
    out, seen = [], set()

    def add(name, t, gen=None):
        if t is not None and id(t) not in seen:
            seen.add(id(t))
            out.append((name, t, gen))

    def visit(obj, name):
        if isinstance(obj, torch.Tensor):
            add(name, obj)
        elif isinstance(obj, Tensor):
            add(name, obj._data, obj)
        elif isinstance(obj, _random.Generator):
            add(f"{name}.key", obj._state, obj)
        elif isinstance(obj, torch.nn.Module):
            for n, t in obj.named_parameters():
                add(f"{name}.{n}", t)
            for n, t in obj.named_buffers():
                add(f"{name}.{n}", t)
        elif isinstance(obj, Optimizer):
            for i, p in enumerate(obj.params):
                add(f"{name}.params[{i}]", p)
            for b in _OPT_BUFFERS:
                for i, t in enumerate(getattr(obj, b, None) or ()):
                    add(f"{name}.{b}[{i}]", t)
            for s in _OPT_SCALARS:
                add(f"{name}.{s}", getattr(obj, s, None))
        elif isinstance(obj, (list, tuple)):
            for i, o in enumerate(obj):
                visit(o, f"{name}[{i}]")
        elif isinstance(obj, dict):
            for k, o in obj.items():
                visit(o, f"{name}[{k!r}]")
        elif obj is not None:
            raise TypeError(
                f"Cannot extract jit state from object of type {type(obj)}")

    visit(state, "state")
    visit(_random.default_generator, "default_generator")
    return out


def _ptr(t) -> int:
    """The address of a tensor's (a DTensor's local) memory."""
    local = getattr(t, "_local_tensor", None)
    return (t if local is None else local).data_ptr()


def _gather_tree(tree):
    """Every rank gets the step's outputs whole: DTensors (and tape Tensors
    over them) gathered to their global values."""
    def leaf(x):
        if isinstance(x, Tensor) and hasattr(x._data, "full_tensor"):
            return Tensor._wrap(x._data.full_tensor(), x.device,
                                x.requires_grad)
        return x.full_tensor() if hasattr(x, "full_tensor") else x
    return pytree.tree_map(leaf, tree)


def _detach(tree):
    """Outputs off every tape: torch tensors detached, tape Tensors as
    Tensors over a clone."""
    def leaf(x):
        if isinstance(x, torch.Tensor):
            return x.detach()
        if isinstance(x, Tensor):
            return Tensor._wrap(x._data.detach().clone(), x.device, False)
        return x
    return pytree.tree_map(leaf, tree)


def _unwrap(leaves):
    """Tape Tensor leaves -> their arrays, and which leaves they were (their
    ``requires_grad``, else None)."""
    kinds = [x.requires_grad if isinstance(x, Tensor) else None
             for x in leaves]
    return [x._data if isinstance(x, Tensor) else x for x in leaves], kinds


def _rewrap(leaves, kinds):
    return [Tensor._wrap(x, Device(x.device), k) if k is not None else x
            for x, k in zip(leaves, kinds)]


def _reduce_pending(module, inputs, out):
    """A module's DTensor output with a pending reduction (``Partial``, a
    row-parallel product's partial sums) reduced at the module's boundary,
    where GSPMD would: code after it reads whole values."""
    def leaf(x):
        pl = getattr(x, "placements", None)
        if pl is None or not any(p.is_partial() for p in pl):
            return x
        from torch.distributed.tensor import Replicate

        return x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                              else p for p in pl])
    return pytree.tree_map(leaf, out)


def _grad_to_placement(p):
    """A DTensor parameter's accumulated gradient in the parameter's own
    placement (a ``Partial`` gradient of a replicated weight is summed), so
    the optimizer's in-place update sees matching tensors."""
    g = p.grad
    if g is not None and tuple(g.placements) != tuple(p.placements):
        p.grad = g.redistribute(p.device_mesh, p.placements)


class _Graph:
    """One signature's captured step: the graph, its input and output
    tensors, the output tree, the state tensors it captured with their
    memory, and its replays."""

    def __init__(self, graph, inputs, outputs, out_kinds, out_spec,
                 state) -> None:
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.out_kinds = out_kinds
        self.out_spec = out_spec
        self.state = [(name, t, holder, _ptr(t))
                      for name, t, holder in state]
        self.replays = 0

    def check_state(self):
        """Raise if a captured state tensor holds other memory than at the
        capture; put a generator's key that a draw elsewhere moved back
        into the graph's buffer."""
        for name, t, holder, ptr in self.state:
            if isinstance(holder, _random.Generator) \
                    and holder._state is not t:
                with torch.no_grad():
                    t.copy_(holder._state)
                holder._state = t
            elif _ptr(t) != ptr or (isinstance(holder, Tensor)
                                    and holder._data is not t):
                raise RuntimeError(
                    f"jit: the state tensor {name} holds other memory than "
                    "when the step was captured; a CUDA graph keeps the "
                    "memory it saw")

    def replay(self, leaves=None):
        if leaves is not None:
            self.check_state()
            with torch.no_grad():
                for dst, src in zip(self.inputs, leaves):
                    dst.copy_(src)
        self.graph.replay()
        self.replays += 1
        return pytree.tree_unflatten(_rewrap(
            [x.clone() if isinstance(x, torch.Tensor) else x
             for x in self.outputs], self.out_kinds), self.out_spec)


class _JitFunction:

    def __init__(self, fn, state=(), donate_state: bool = True, mesh=None,
                 batch_axis: str = "dp", shard_rules=None) -> None:
        self._mesh = None
        if mesh is not None:
            from .parallel.mesh import as_mesh

            self._mesh = as_mesh(mesh)
        self._batch_axis = batch_axis
        self._shard_rules = list(shard_rules or ())
        self._placed = False
        self._fn = fn
        self._state = state
        self._device = None  # the state's device, found at the first call
        self._out_device = None  # without state or tensor arguments
        self._warm = set()  # signatures whose eager first call has run
        self.graphs: dict = {}  # signature -> _Graph
        functools.update_wrapper(self, fn, updated=())

    @property
    def replays(self) -> int:
        """Replays of all this jit's graphs."""
        return sum(g.replays for g in self.graphs.values())

    # -- arguments --------------------------------------------------------
    def _leaves(self, args, kwargs):
        """The arguments' leaves (every tensor on the step's device), their
        tree and the step's device: the first state tensor's that is not a
        generator's key, else the first tensor argument's (else, from the
        second call, the device of the first call's first tensor
        output)."""
        leaves, spec = pytree.tree_flatten((args, kwargs))
        leaves, kinds = _unwrap(leaves)
        if self._device is None:
            self._device = next(
                (t.device for _, t, holder in _collect_state(self._state)
                 if not isinstance(holder, _random.Generator)), False)
        target = self._device or next(
            (x.device for x in leaves if isinstance(x, torch.Tensor)), None)
        if target is not None:
            leaves = [x.to(target) if isinstance(x, torch.Tensor)
                      and x.device != target else x for x in leaves]
        if self._mesh is not None:
            leaves = [self._place_arg(x) if isinstance(x, torch.Tensor)
                      else x for x in leaves]
        return leaves, (spec, tuple(kinds)), target

    @staticmethod
    def _signature(leaves, spec):
        key = []
        for leaf in leaves:
            if isinstance(leaf, torch.Tensor):
                key.append((tuple(leaf.shape), leaf.dtype, leaf.device,
                            leaf.requires_grad,
                            getattr(leaf, "placements", None)))
            else:
                try:
                    hash(leaf)
                except TypeError:
                    raise TypeError(
                        f"jit: a non-tensor argument must be hashable, got "
                        f"{type(leaf).__name__}") from None
                key.append((type(leaf), leaf))
        return tuple(key), spec, torch.is_grad_enabled()

    # -- the two routes ---------------------------------------------------
    def _run(self, leaves, spec):
        spec, kinds = spec
        args, kwargs = pytree.tree_unflatten(_rewrap(leaves, kinds), spec)
        if self._mesh is None:
            return self._fn(*args, **kwargs)
        from torch.distributed.tensor.experimental import \
            implicit_replication

        with implicit_replication():
            return self._fn(*args, **kwargs)

    # -- mesh= -----------------------------------------------------------
    def _place_arg(self, x):
        """A tensor argument on the mesh: split over the batch axis when
        its leading dimension divides that axis's size, else replicated."""
        from torch.distributed.tensor import DTensor, distribute_tensor

        from .parallel.mesh import named_sharding

        if isinstance(x, DTensor):
            return x
        mesh, ax = self._mesh, self._batch_axis
        n = mesh.axis_size(ax)
        spec = (ax,) if ax in mesh.axis_names and x.ndim >= 1 \
            and x.shape[0] % n == 0 else ()
        return distribute_tensor(
            x.detach().to(mesh.device), mesh.device_mesh,
            named_sharding(mesh, *spec).placements,
            src_data_rank=None).requires_grad_(x.requires_grad)

    def _place_state(self):
        """Place the state on the mesh once (module docstring)."""
        from torch.distributed.tensor import DTensor, distribute_tensor

        from .parallel.mesh import named_sharding

        mesh = self._mesh

        def placements(name):
            for pat, spec in self._shard_rules:
                if name is not None and fnmatch.fnmatch(name, pat):
                    return named_sharding(mesh, *spec).placements
            return named_sharding(mesh).placements

        def place(t, pl):
            if isinstance(t, DTensor):
                return t
            return distribute_tensor(t.detach().to(mesh.device),
                                     mesh.device_mesh, pl,
                                     src_data_rank=None)

        modules, optimizers, tapes = [], [], []

        def visit(obj):
            if isinstance(obj, torch.nn.Module):
                modules.append(obj)
            elif isinstance(obj, Optimizer):
                optimizers.append(obj)
            elif isinstance(obj, Tensor):
                tapes.append(obj)
            elif isinstance(obj, (list, tuple)):
                for o in obj:
                    visit(o)
            elif isinstance(obj, dict):
                for o in obj.values():
                    visit(o)
            elif isinstance(obj, torch.Tensor):
                raise TypeError(
                    "jit(mesh=): a bare torch tensor in the state cannot be "
                    "placed on the mesh in place; hold it in a module")

        visit(self._state)
        placed = {}  # id(tensor before) -> the DTensor that replaced it
        for module in modules:
            for path, m in module.named_modules():
                pre = path + "." if path else ""
                for n, p in list(m._parameters.items()):
                    if p is None or isinstance(p, DTensor):
                        continue
                    new = torch.nn.Parameter(place(p, placements(pre + n)),
                                             requires_grad=p.requires_grad)
                    placed[id(p)] = m._parameters[n] = new
                for n, b in list(m._buffers.items()):
                    if b is not None and not isinstance(b, DTensor):
                        placed[id(b)] = m._buffers[n] = place(
                            b, placements(pre + n))
                m.register_forward_hook(_reduce_pending)
            cache = getattr(module, "_weights_cache", None)
            if isinstance(cache, dict):
                cache.clear()
        for opt in optimizers:
            for i, p in enumerate(opt.params):
                if id(p) not in placed:
                    placed[id(p)] = torch.nn.Parameter(
                        place(p, placements(None)),
                        requires_grad=p.requires_grad)
                opt.params[i] = placed[id(p)]
            for b in _OPT_BUFFERS:
                bufs = getattr(opt, b, None) or []
                for i, t in enumerate(bufs):
                    bufs[i] = place(t, opt.params[i].placements)
        for t in tapes:
            t._data = place(t._data, placements(None))
        for p in placed.values():
            if isinstance(p, torch.nn.Parameter) and p.requires_grad:
                p.register_post_accumulate_grad_hook(_grad_to_placement)
        self._placed = True

    def _capture(self, leaves, spec, sig, target) -> _Graph:
        entries = _collect_state(self._state)
        for name, t, holder in entries:
            if not isinstance(holder, _random.Generator) \
                    and t.device != target:
                raise RuntimeError(
                    f"jit: the state tensor {name} is on {t.device}, the "
                    f"step on {target}: a CUDA graph would keep its value "
                    "at the capture")
        ptrs = [_ptr(t) for _, t, _ in entries]
        inputs = [x.detach().clone().requires_grad_(x.requires_grad)
                  if isinstance(x, torch.Tensor) else x for x in leaves]
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                out = self._run(inputs, spec)
        except Exception as e:
            raise RuntimeError(
                f"jit: capturing {getattr(self._fn, '__name__', 'the step')}"
                f" into a CUDA graph failed ({type(e).__name__}: {e}); the "
                "step is not run eagerly instead") from e
        after = _collect_state(self._state)
        for i, (name, t, _) in enumerate(entries):
            if i >= len(after) or after[i][1] is not t \
                    or _ptr(t) != ptrs[i]:
                raise RuntimeError(
                    f"jit: the step rebound the state tensor {name} during "
                    "the capture; a CUDA graph keeps the memory it saw, so "
                    "the step must update its state in place")
        if len(after) != len(entries):
            raise RuntimeError(f"jit: the step added the state tensor "
                               f"{after[len(entries)][0]} during the capture")
        out_leaves, out_spec = pytree.tree_flatten(out)
        out_leaves, out_kinds = _unwrap(out_leaves)
        out_leaves = [x.detach() if isinstance(x, torch.Tensor) else x
                      for x in out_leaves]
        g = self.graphs[sig] = _Graph(
            graph, [x for x in inputs if isinstance(x, torch.Tensor)],
            out_leaves, [None if k is None else False for k in out_kinds],
            out_spec, entries)
        return g

    def _call(self, args, kwargs):
        if self._mesh is not None:
            if not self._placed:
                self._place_state()
            return _gather_tree(self._call_placed(args, kwargs))
        return self._call_placed(args, kwargs)

    def _call_placed(self, args, kwargs):
        leaves, spec, target = self._leaves(args, kwargs)
        sig = self._signature(leaves, spec)
        target = target or self._out_device
        if target is None or target.type != "cuda":
            out = _detach(self._run(leaves, spec))
            if target is None:  # the device of the step's first output
                self._out_device = next(
                    (x.device for x in _unwrap(pytree.tree_leaves(out))[0]
                     if isinstance(x, torch.Tensor)), None)
                self._warm.add(sig)
            return out
        g = self.graphs.get(sig)
        if g is not None:
            return g.replay([x for x in leaves
                             if isinstance(x, torch.Tensor)])
        if sig not in self._warm:
            out = _detach(self._run(leaves, spec))
            self._warm.add(sig)
            return out
        # the capture ran nothing: its first replay is this call's step
        return self._capture(leaves, spec, sig, target).replay()

    def __call__(self, *args, **kwargs):
        return self._call(args, kwargs)

    def foreach(self, *args, **kwargs):
        """The step over the leading-axis slices of every argument, in
        order: ``jstep.foreach(Xb, Yb)`` is ``[jstep(Xb[i], Yb[i]) for i in
        range(n)]`` with each output stacked on a new leading axis, and the
        same state updates. Every argument must be a tensor with the same
        leading length; static arguments belong in the step."""
        leaves, spec = pytree.tree_flatten((args, kwargs))
        lengths = set()
        for leaf in leaves:
            if not isinstance(leaf, (torch.Tensor, Tensor)):
                raise TypeError(
                    "foreach arguments must all be tensors with a leading "
                    f"steps axis; got {type(leaf).__name__}")
            if leaf.ndim == 0:
                raise ValueError("foreach arguments need a leading steps "
                                 "axis")
            lengths.add(leaf.shape[0])
        if len(lengths) != 1:
            raise ValueError(f"foreach arguments disagree on the leading "
                             f"steps axis: {sorted(lengths)}")
        n = lengths.pop()
        if n == 0:
            raise ValueError("foreach needs at least one step")
        outs = []
        for i in range(n):
            step_args, step_kwargs = pytree.tree_unflatten(
                [leaf[i] for leaf in leaves], spec)
            outs.append(self._call(step_args, step_kwargs))
        flat = [pytree.tree_flatten(o)[0] for o in outs]
        out_spec = pytree.tree_flatten(outs[0])[1]
        stacked = [torch.stack(col) if isinstance(col[0], torch.Tensor)
                   else Tensor._wrap(torch.stack([c.torch for c in col]),
                                     col[0].device, False)
                   if isinstance(col[0], Tensor) else list(col)
                   for col in zip(*flat)]
        return pytree.tree_unflatten(stacked, out_spec)


def jit(fn=None, *, state=(), donate_state: bool = True, mesh=None,
        batch_axis: str = "dp", shard_rules=None):
    """Run an imperative step as one CUDA graph on a GPU; see the module
    docstring. Usable as ``jit(fn, state=...)`` or as a decorator, bare or
    with arguments."""
    kwargs = dict(state=state, donate_state=donate_state, mesh=mesh,
                  batch_axis=batch_axis, shard_rules=shard_rules)
    if fn is None:
        return lambda f: _JitFunction(f, **kwargs)
    return _JitFunction(fn, **kwargs)
