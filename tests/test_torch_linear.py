"""The f32 linears' op (dostransformer_tpu_torch/ops/linear.py) on the
CPU: ``linear_plan`` sends f32 products of supported widths and enough
rows to the op and keeps bf16, f64, K = 41, N = 1 and few rows on
``F.linear``; the op's CPU path is ``F.linear`` bit for bit at every site
shape of the eDOS cell, weight slices and the parts form included; every
f32 product of ``nn/modules.py`` goes through the one helper, slices
uncopied; the linear counters add up; the eDOS and phDOS models' outputs
and gradients keep their bits. The kernel itself runs only on the card
(tests/test_torch_cuda.py)."""

import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from dostransformer_tpu_torch import tracing  # noqa: E402
from dostransformer_tpu_torch.nn import modules  # noqa: E402
from dostransformer_tpu_torch.ops import linear as linear_ops  # noqa: E402
from tests.test_torch_tracing import linear_rows  # noqa: E402

MIN_ROWS = linear_ops.MIN_ROWS
# (rows, K, N) of each f32 product of the eDOS cell (hidden 256, batch 64):
# a processor's edge projection at the smallest and largest buckets' edge
# slots, its node-level products (src_proj, dst_proj, node_mlp_2's parts
# and its second linear) at 64 x 256 atoms, the edge encoder's second
# layer, the heads' fc and fc_prompt, the node encoder's first layer
SITES = {
    "edge_proj_small": (8192, 256, 512),
    "edge_proj_large": (180224, 256, 512),
    "node_proj": (16384, 256, 512),
    "node_mlp_2_lin1": (16384, 512, 256),
    "edge_encoder_2": (180224, 256, 256),
    "heads_fc": (12864, 512, 256),
    "heads_fc_prompt": (12864, 640, 256),
    "node_encoder_1": (16384, 200, 256),
}


@pytest.mark.parametrize("rows,k,n,dtype,want", [
    *[(*shape, torch.float32, True) for shape in SITES.values()],
    (MIN_ROWS, 256, 512, torch.float32, True),
    (MIN_ROWS - 1, 256, 512, torch.float32, False),   # too few rows
    (512, 256, 512, torch.float32, False),            # bucket 8's nodes
    (64, 512, 256, torch.float32, False),             # the decoder
    (180224, 41, 256, torch.float32, False),          # edge encoder, K = 41
    (25728, 256, 1, torch.float32, False),            # out_layer, N = 1
    (16384, 118, 256, torch.float32, False),          # phDOS node encoder
    (16384, 4, 256, torch.float32, False),            # phDOS edge encoder
    (16384, 256, 50, torch.float32, False),           # N not a multiple of 4
    (180224, 256, 512, torch.bfloat16, False),        # bf16: F.linear + b
    (180224, 256, 512, torch.float64, False),         # f64: plain functions
], ids=[*SITES, "min_rows", "under_min_rows", "bucket8_nodes", "decoder",
        "k41", "n1", "phdos_k118", "phdos_k4", "n50", "bf16", "f64"])
def test_linear_plan(rows, k, n, dtype, want):
    assert linear_ops.linear_plan(rows, k, n, dtype) is want


def _grads(fn, leaves):
    leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
    out = fn(*leaves)
    out.backward(torch.ones_like(out).cumsum(-1) / out.shape[-1])
    return [out.detach()] + [t.grad for t in leaves]


@pytest.mark.parametrize("site", list(SITES))
@pytest.mark.parametrize("form", ["whole", "slice", "no_bias"])
def test_cpu_op_is_f_linear_bit_for_bit(site, form):
    """At each site's widths and the plan's fewest rows: the op, the helper
    and the custom op's CPU kernel give F.linear's outputs and gradients;
    ``slice`` takes the weight as the middle columns of one three times as
    wide (the processors' w0[:, h:2h])."""
    _, k, n = SITES[site]
    g = torch.Generator().manual_seed(1)
    x = torch.randn(MIN_ROWS, k, generator=g)
    wide = torch.randn(n, 3 * k if form == "slice" else k, generator=g)
    b = None if form == "no_bias" else torch.randn(n, generator=g)

    def cut(w):
        return w[:, k:2 * k] if form == "slice" else w

    leaves = [x, wide] + ([] if b is None else [b])

    def run(fn):
        return _grads(lambda x, w, *b: fn(x, cut(w), b[0] if b else None),
                      leaves)

    want = run(F.linear)
    for fn in (linear_ops.linear_op, modules.linear):
        got = run(fn)
        assert all(torch.equal(a, c) for a, c in zip(got, want))
    out = torch.ops.dostpu.linear_fwd(x, cut(wide), b)
    assert torch.equal(out, want[0])


def test_parts_form_is_f_linear_of_the_concatenation_bit_for_bit():
    """The parts form (node_mlp_2's [x, agg], the unfused EdgeModel's
    gathered [x_src, x_dst, e]) computes as before #9: each part through
    its weight slice, the gathers after, the bias last."""
    g = torch.Generator().manual_seed(2)
    layer = modules.TorchLinear(3 * 8, 16)
    layer.reset_parameters(g)
    x = torch.randn(2, 5, 8, generator=g)
    e = torch.randn(2, 7, 8, generator=g)
    idx = torch.randint(0, 5, (2, 7), generator=g)
    got = layer(((x, idx), (x, idx.flip(-1)), (e, None)))
    w = layer.weight
    want = (modules.gather_rows(F.linear(x, w[:, :8]), idx)
            + modules.gather_rows(F.linear(x, w[:, 8:16]), idx.flip(-1))
            + F.linear(e, w[:, 16:])) + layer.bias
    assert torch.equal(got, want)


def _spy(monkeypatch):
    """Record (rows, weight) of every call that reaches the op."""
    calls = []

    def spy(x, weight, bias):
        calls.append((x.numel() // x.shape[-1], weight))
        return F.linear(x, weight, bias)

    monkeypatch.setattr(modules, "linear_op", spy)
    monkeypatch.setattr(modules, "linear_plan",
                        lambda rows, k, n, dtype: dtype == torch.float32)
    return calls


def test_fused_edge_takes_the_helper_with_uncopied_slices(monkeypatch):
    """MLPBlock.fused_edge projects src, dst and the edge features through
    the helper, each on its slice of w0 (views, no copies)."""
    calls = _spy(monkeypatch)
    h = 8
    block = modules.MLPBlock(3 * h, 2 * h, h)
    block[0].reset_parameters(torch.Generator().manual_seed(3))
    x = torch.randn(2, 5, h)
    e = torch.randn(2, 7, h)
    idx = torch.zeros(2, 7, dtype=torch.long)
    block.fused_edge(x, idx, idx, e, torch.ones(2, 7))
    w0 = block[0].weight
    assert [r for r, _ in calls] == [10, 10, 14]
    for (_, w), lo in zip(calls, (0, h, 2 * h)):
        assert w.data_ptr() == w0[:, lo:].data_ptr()
        assert w.stride() == w0.stride() and w.shape == (2 * h, h)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64])
def test_helper_keeps_f_linear_for_bf16_and_f64(dtype, monkeypatch):
    """bf16 rounds the product before the bias (the JAX package's order)
    and f64 takes F.linear; neither reaches the op."""
    calls = _spy(monkeypatch)
    g = torch.Generator().manual_seed(4)
    x = torch.randn(3, 8, generator=g).to(dtype)
    w, b = torch.randn(4, 8, generator=g), torch.randn(4, generator=g)
    got = modules.linear(x, w, b)
    if dtype == torch.bfloat16:
        want = F.linear(x, w.to(dtype)) + b.to(dtype)
    else:
        want = F.linear(x, w.to(dtype), b.to(dtype))
    assert torch.equal(got, want) and calls == []


@pytest.mark.parametrize("case", ["k41", "n_odd", "bf16", "column_stride",
                                  "wide_k", "no_rows"])
def test_kernel_checks_refuse_what_it_does_not_take(case):
    """What the C entries assume, checked before any launch (the checks
    run on any device)."""
    x, w = torch.zeros(8, 32), torch.zeros(16, 32)
    err = ValueError
    if case == "k41":
        x, w = torch.zeros(8, 41), torch.zeros(16, 41)
    elif case == "n_odd":
        w = torch.zeros(18, 32)
    elif case == "bf16":
        w, err = w.to(torch.bfloat16), TypeError
    elif case == "column_stride":
        w = torch.zeros(32, 16).T
    elif case == "wide_k":
        w = torch.zeros(16, 64)
    elif case == "no_rows":
        x = torch.zeros(0, 32)
    with pytest.raises(err):
        linear_ops._require("linear", x, w)


def _batch(task, n):
    from dostransformer_tpu_torch.data.graph import collate
    from dostransformer_tpu_torch.data.synthetic import (
        synthetic_edos_samples,
        synthetic_phdos_samples,
    )

    make = synthetic_edos_samples if task == "edos" else synthetic_phdos_samples
    return collate(make(n, seed=5), num_graphs=n)


def _model(task, hidden=16):
    from dostransformer_tpu_torch.models.registry import build_model

    return build_model(task, layers=2, t_layers=1, hidden=hidden,
                       generator=torch.Generator().manual_seed(6))


@pytest.mark.parametrize("task", ["edos", "phdos"])
def test_cpu_models_keep_their_bits(task, monkeypatch):
    """Both flagships' outputs and gradients with every f32 linear sent
    to the op (the plan made to say yes to all) equal those with none sent,
    bit for bit."""
    batch = _batch(task, 4)
    runs = []
    for on in (True, False):
        with monkeypatch.context() as mp:
            mp.setattr(modules, "linear_plan",
                       lambda rows, k, n, dtype: on and dtype == torch.float32)
            model = _model(task)
            outs = model(batch)
            (outs[0].square().sum() + outs[2].sum()).backward()
            runs.append([o.detach() for o in outs]
                        + [p.grad for p in model.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("graphs,hidden", [(3, 16), (16, 32)])
def test_linear_counters_add_up(graphs, hidden):
    """linear.rows counts every linear call's rows over one eDOS forward
    (the FFN calls that take #8's op are not linears: at 16 graphs of
    hidden 32 all of them); linear.kernel_rows counts the rows that took
    #9, none on the CPU."""
    from dostransformer_tpu_torch.ops.ffn import ffn_plan

    batch = _batch("edos", graphs)
    model = _model("edos", hidden)
    counters = tracing.record().counters
    before = (counters.get("linear.rows", 0),
              counters.get("linear.kernel_rows", 0))
    with torch.no_grad():
        model(batch)
    b, atoms = batch.nodes.shape[:2]
    bins = model.n_bins
    want = linear_rows(b, atoms, batch.edges.shape[1], bins, layers=2)
    # fc1 and fc2 of the cross stack (b bins rows) and of the heads' two
    # stacks (2b bins rows), one layer each
    for rows, calls in ((b * bins, 2), (2 * b * bins, 4)):
        if ffn_plan(rows, hidden, torch.float32):
            want -= calls * rows
    assert want < linear_rows(b, atoms, batch.edges.shape[1], bins,
                              layers=2) or graphs == 3
    assert counters["linear.rows"] - before[0] == want
    assert counters.get("linear.kernel_rows", 0) - before[1] == 0
