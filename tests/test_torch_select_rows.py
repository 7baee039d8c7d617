"""``render/select_kernel.select_rows`` on the CPU: the pipeline's gather of
per-object rows is ``table[idx]`` there, forward and backward, bit for bit,
and launches nothing; so is it without a gradient. (The kernels of its
backward on the card, over the objects, row widths and dtypes, are
``test_select_rows_*`` in tests/test_torch_gpu.py.)"""

import torch

from tpu_ray_tracer_torch.render import graphs
from tpu_ray_tracer_torch.render.select_kernel import select_rows


def test_select_rows_is_indexing_on_the_cpu_and_without_a_gradient():
    g = torch.Generator().manual_seed(18)
    table = torch.randn((21, 3), generator=g)
    idx = torch.randint(0, 21, (2, 37), generator=g)
    cotangent = torch.randn((2, 37, 3), generator=g)
    before = graphs.launch_counts()["select_rows"]

    leaf, want_leaf = table.clone().requires_grad_(), table.clone().requires_grad_()
    out = select_rows(leaf, idx)
    out.backward(cotangent)
    want = want_leaf[idx]
    want.backward(cotangent)
    assert torch.equal(out.detach(), want.detach())
    assert torch.equal(leaf.grad, want_leaf.grad)

    with torch.no_grad():
        out = select_rows(leaf, idx)
    assert out.grad_fn is None and torch.equal(out, table[idx])
    assert torch.equal(select_rows(table, idx), table[idx])
    assert graphs.launch_counts()["select_rows"] == before


def test_launch_counts_has_select_rows():
    counts = graphs.launch_counts()
    assert "select_rows" in counts
    table = torch.randn((3, 20)).requires_grad_()
    select_rows(table, torch.tensor([0, 2, 2, 1])).sum().backward()
    assert graphs.launch_counts() == counts
