"""CUDA graphs of the backbone's training pass, for `TrainStep`.

A training step runs the backbone twice with autograd recording: on the
scenes and on the class images (the label branch, the same ResNet-C4 where
the branches share their parameters). At the default recipe each pass is
about 3,000 small launches behind Python and autograd: the frozen
BatchNorms' elementwise kernels and their gradients, the convolutions, whose
backward is `models/resnet.py: conv2d_backward` in Python. On a card the
host, not the card, then sets the step's pace (PERF.md). `BackboneGraphs`
records such a pass once, its forward and its backward as a pair of CUDA
graphs, and replays the pair on later steps.

The rule, by what a call can observe:
- a pass runs eager where the step detaches its output (train_features
  off), where grad mode is off or nothing of the pass requires a gradient,
  and on the CPU;
- otherwise its signature (`pass_signature`) is the slot (which of the
  step's calls), the module, the input's shape, strides, dtype, device and
  requires-grad flag, and each parameter's requires-grad flag and storage
  address. A new signature runs eager the first time: that pass is the
  warm-up (cuDNN's and cuBLAS's lazy set-up for exactly these kernels) and
  records the layout of the gradient that reaches the output. The second
  time the pair is captured, and replayed from then on;
- at most `max_graphs` pairs are held, each in a memory pool of its own;
  past the bound a new signature runs eager. Parameters given new storage
  (a checkpoint that replaces them) make a new signature, and the slot's
  pairs on the old storage are dropped: no stale graph is replayed.

A replay runs the kernels that the eager pass launches, in its order, on
the parameters as they are at its addresses: the captured backward holds
`conv2d_backward`'s deterministic choices as they ran. So a graphed step
gives the eager step's numbers to the bit (tests/test_torch_train_graphs_card.py).

Contract: each slot is called once between backward passes (`TrainStep`
calls "backbone" and "label_branch" once a step). A replay's output and its
parameters' gradients are the pair's own buffers, written again by the
slot's next replay.

Counters since import, read and reset by whoever measures them: `captures`
(pairs recorded), `replays` (passes replayed) and `eager_passes` (passes run
eager, by reason: "detached", "no_grad", "cpu", "first_sight",
"cache_full").
"""

from __future__ import annotations

import collections

import torch

from ..utils.profiling import annotate

captures = 0
replays = 0
eager_passes = collections.Counter()


def pass_signature(slot: str, module, x, params=None) -> tuple:
    """What a graphed pass of `module` on `x` depends on (module docstring);
    `params` is tuple(module.parameters()), taken here if not given."""
    params = tuple(module.parameters()) if params is None else params
    return (slot, id(module), tuple(x.shape), x.stride(), x.dtype, x.device, x.requires_grad,
            tuple(p.requires_grad for p in params), tuple(p.data_ptr() for p in params))


def _dense_stride(grad):
    """The gradient's strides where a buffer can take them (one element per
    address), else None."""
    if grad.is_contiguous() or grad.is_contiguous(memory_format=torch.channels_last):
        return grad.stride()
    return None


class _GraphedPass:
    """One signature's forward and backward graphs in one memory pool, and
    their static tensors: the input, the output, the output's gradient and
    the gradients of the input and the parameters that require one."""

    def __init__(self, module, x, params, grad_stride):
        self.grad_params = tuple(p for p in params if p.requires_grad)
        self.x = x.detach().clone().requires_grad_(x.requires_grad)
        # the capture runs on leaves that share the parameters' storage: the
        # parameters' own gradient accumulators are on the step's stream and
        # may be held by a live graph (the other slot's replay); a capture
        # that reaches them fails (the step's stream would wait on it)
        leaves = {name: p.detach().requires_grad_(p.requires_grad)
                  for name, p in module.named_parameters()}
        # "thread_local": the train loop's prefetcher thread may upload the
        # next batch (pinned staging, a copy stream of its own) meanwhile
        self.forward = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.forward, capture_error_mode="thread_local"):
            out = torch.func.functional_call(module, leaves, (self.x,))
        self.out = out.detach()
        self.grad_out = torch.empty_strided(out.shape, grad_stride or out.stride(),
                                            dtype=out.dtype, device=out.device)
        inputs = ((self.x,) if x.requires_grad else ()) + tuple(
            leaf for leaf in leaves.values() if leaf.requires_grad)
        self.backward = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.backward, pool=self.forward.pool(),
                              capture_error_mode="thread_local"):
            grads = torch.autograd.grad(out, inputs, self.grad_out, allow_unused=True)
        self.grad_x = grads[0] if x.requires_grad else None
        self.grads = grads[len(grads) - len(self.grad_params):]


class _Replay(torch.autograd.Function):
    """The pass as one autograd node: forward and backward replay the pair."""

    @staticmethod
    def forward(ctx, graphed, x, *grad_params):
        ctx.graphed = graphed
        graphed.x.copy_(x)
        graphed.forward.replay()
        return graphed.out.detach()

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        graphed = ctx.graphed
        graphed.grad_out.copy_(grad)
        graphed.backward.replay()
        return (None,) + tuple(None if t is None else t.detach()
                               for t in (graphed.grad_x,) + graphed.grads)


class BackboneGraphs:
    """`self(slot, module, x, detached)` is `module(x)`, graphed by the rule
    of the module docstring; `TrainStep` owns one."""

    def __init__(self, max_graphs: int = 6):
        self.max_graphs = max_graphs
        self.graphs = {}  # signature -> _GraphedPass
        # signatures seen once -> the strides of their output's gradient
        self._seen = collections.OrderedDict()

    def __call__(self, slot: str, module, x, detached: bool = False):
        global replays
        reason, graphed, sig = None, None, None
        if detached:
            reason = "detached"
        elif not torch.is_grad_enabled():
            reason = "no_grad"
        elif x.device.type != "cuda":
            reason = "cpu"
        else:
            params = tuple(module.parameters())
            sig = pass_signature(slot, module, x, params)
            graphed = self.graphs.get(sig)
            if graphed is None:
                reason = self._miss(sig, module, x, params)
                graphed = self.graphs.get(sig)
        if graphed is not None:
            replays += 1
            with annotate("os2d.backbone"):
                return _Replay.apply(graphed, x, *graphed.grad_params)
        eager_passes[reason] += 1
        out = module(x)
        if reason == "first_sight" and out.requires_grad:
            def record(grad):
                if sig in self._seen:
                    self._seen[sig] = _dense_stride(grad)
            out.register_hook(record)
        return out

    def _miss(self, sig, module, x, params):
        """Captures `sig`'s pair where it was seen before and there is room;
        else the reason it runs eager."""
        global captures
        if not (x.requires_grad or any(p.requires_grad for p in params)):
            return "no_grad"
        slot, ident, ptrs = sig[0], sig[1], sig[-1]
        for old in [s for s in self.graphs if s[:2] == (slot, ident) and s[-1] != ptrs]:
            del self.graphs[old]  # the slot's parameters moved: free the old pair
        if len(self.graphs) >= self.max_graphs:
            return "cache_full"
        if sig not in self._seen:
            self._seen[sig] = None
            while len(self._seen) > 2 * self.max_graphs:
                self._seen.popitem(last=False)
            return "first_sight"
        self.graphs[sig] = _GraphedPass(module, x, params, self._seen.pop(sig))
        captures += 1
        return None
