"""The head's constant cache (`models/head.py: HeadConstantCache`) on the CPU
at a tiny size (B=2, C=3, F=32, feature maps 6x7 and 5x9):

- `head_forward` gives the same loc, cls, cls_detached and corners to the
  bit on a cold cache and on a warm one, on the interior-first and the grid
  path, and with grad on the same gradients of the feature maps and of the
  TransformNet;
- `lookups` counts one per head call, `builds` one per (device, h, w);
- past MAX_SHAPES (64) shapes the least recently used entry is evicted;
- only the first build on a device copies host values (`os2d.wait.constant`:
  the permutation and the two lattice rows), and a warm call none;
- lookups from many threads lose no count and build each entry once.

On the card, tests/test_torch_eval_card.py holds the benchmark's dispatch on
a warm cache against one on a cleared cache.
"""

import sys
import threading

import pytest
import torch

from os2d_torch.models import TransformNet
from os2d_torch.models.head import HeadConstantCache, build_class_head, head_constants, head_forward
from os2d_torch.utils import profiling

B, C, F = 2, 3, 32
SIZES = [(6, 7), (5, 9)]
CPU = torch.device("cpu")
KEYS = ("loc", "cls", "cls_detached", "corners")


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread (as tests/test_torch_spans.py): under the suite's
    workers sharing the cores, torch's OpenMP teams otherwise wait on each
    other's barriers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def parts():
    """(TransformNet with a non-zero final layer, class head, feature maps
    by size, loss weights by size)."""
    gen = torch.Generator().manual_seed(0)
    net = TransformNet(6, device="cpu")
    net.reset_parameters(gen)
    with torch.no_grad():
        # theta varies per anchor and class
        net.linear.weight.copy_(0.02 * torch.randn(net.linear.weight.shape, generator=gen))
    head = build_class_head(torch.randn(C, 15, 15, F, generator=gen))
    fms = {s: torch.randn(B, *s, F, generator=gen) for s in SIZES}
    weights = {s: (torch.randn(B, C, 4, s[0] * s[1], generator=gen),
                   torch.randn(B, C, s[0] * s[1], generator=gen)) for s in SIZES}
    return net, head, fms, weights


def run(parts, size, interior_first, grad):
    """(head_forward's outputs, [d fm] + the TransformNet's gradients with
    grad on, else [])."""
    net, head, fms, weights = parts
    fm = fms[size].clone().requires_grad_(grad)
    with torch.set_grad_enabled(grad):
        out = head_forward(net, fm, head, corr_interior_first=interior_first)
    if not grad:
        return out, []
    net.zero_grad(set_to_none=True)
    w_loc, w_cls = weights[size]
    ((out["loc"] * w_loc).sum() + (out["cls"] * w_cls).sum()).backward()
    return out, [fm.grad] + [p.grad for p in net.parameters()]


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("interior_first", [True, False])
def test_a_warm_cache_gives_the_cold_caches_outputs_and_gradients(parts, interior_first, grad):
    for size in SIZES:
        head_constants.clear()
        cold, cold_grads = run(parts, size, interior_first, grad)
        warm, warm_grads = run(parts, size, interior_first, grad)
        for k in KEYS:
            assert torch.equal(cold[k], warm[k]), (size, k)
        assert cold["fm_size"] == warm["fm_size"] == size
        if grad:
            assert len(cold_grads) == len(warm_grads) > 1
            assert all(g is not None for g in cold_grads)
            for i, (a, b) in enumerate(zip(cold_grads, warm_grads)):
                assert torch.equal(a, b), (size, i)


def test_a_lookup_per_call_and_a_build_per_shape(parts):
    head_constants.clear()
    lookups, builds = head_constants.lookups, head_constants.builds
    for size in SIZES + SIZES + SIZES[:1]:
        run(parts, size, True, False)
    assert head_constants.lookups - lookups == 5
    assert head_constants.builds - builds == 2


def test_past_max_shapes_the_least_recently_used_is_evicted():
    cache = HeadConstantCache()
    shapes = [(1, n) for n in range(1, cache.MAX_SHAPES + 3)]  # 66 distinct
    first = cache.lookup(CPU, *shapes[0])
    for s in shapes[1:cache.MAX_SHAPES]:
        cache.lookup(CPU, *s)
    assert cache.builds == cache.MAX_SHAPES
    # a hit makes shapes[0] the most recent: the 65th shape evicts shapes[1]
    assert cache.lookup(CPU, *shapes[0]) is first
    cache.lookup(CPU, *shapes[cache.MAX_SHAPES])
    assert cache.builds == cache.MAX_SHAPES + 1
    assert cache.lookup(CPU, *shapes[0]) is first
    cache.lookup(CPU, *shapes[1])
    assert cache.builds == cache.MAX_SHAPES + 2
    # with no hit between, the 65th new shape evicts the oldest
    cache.lookup(CPU, *shapes[cache.MAX_SHAPES + 1])  # evicts shapes[2]
    cache.lookup(CPU, *shapes[2])
    assert cache.builds == cache.MAX_SHAPES + 4
    assert cache.lookups == cache.MAX_SHAPES + 6


def test_only_the_first_build_on_a_device_copies_host_values(parts, monkeypatch):
    opened = []

    class counting(profiling.annotate):
        def __enter__(self):
            opened.append(self.name)
            return super().__enter__()

    # host_constant opens its span through the module's `annotate`
    monkeypatch.setattr(profiling, "annotate", counting)

    def constant_waits(size):
        opened.clear()
        run(parts, size, True, False)
        return opened.count("os2d.wait.constant")

    head_constants.clear()
    assert [constant_waits(SIZES[0]), constant_waits(SIZES[0]), constant_waits(SIZES[1])] \
        == [3, 0, 0]


def test_lookups_from_many_threads_lose_no_count():
    cache = HeadConstantCache()
    n_threads, per_thread, n_shapes = 16, 200, 4

    def work():
        for i in range(per_thread):
            cache.lookup(CPU, 1 + i % n_shapes, 2)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert cache.lookups == n_threads * per_thread
    assert cache.builds == n_shapes
