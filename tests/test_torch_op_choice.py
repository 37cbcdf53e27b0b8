"""Each op entry picks its path from its operands (ops/kernels.py
``takes_kernels``): operands the kernels do not take (f64; bf16 for the
linear) give, bit for bit and with gradients, what the layers gave when
they made that choice themselves: the plain version, with no kernel path
entered and no launch counted."""

import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from dostransformer_tpu_torch.nn import layernorm  # noqa: E402
from dostransformer_tpu_torch.ops import attention  # noqa: E402
from dostransformer_tpu_torch.ops import ffn as ffn_ops  # noqa: E402
from dostransformer_tpu_torch.ops import linear as linear_ops  # noqa: E402
from dostransformer_tpu_torch.ops import segment  # noqa: E402

D = 32
ROWS = (2, ffn_ops.MIN_ROWS // 2 + 8)  # over both plans' row thresholds


def _refuse(*args, **kwargs):
    raise AssertionError("a kernel path was entered")


def _rand(g, *shape):
    return torch.randn(*shape, generator=g)


def _linear(dtype):
    """x in ``dtype``, the f32 parameters cast at use."""
    def make(g):
        x = _rand(g, *ROWS, 2 * D).to(dtype)
        leaves = [x, _rand(g, D, 2 * D), _rand(g, D)]

        def want(x, w, b):
            if dtype == torch.bfloat16:  # the product rounded, then + b
                return F.linear(x, w.to(dtype)) + b.to(dtype)
            return F.linear(x, w.to(dtype), b.to(dtype))

        return leaves, linear_ops.linear, want
    return make


def _ffn(dtype):
    def make(g):
        x = _rand(g, *ROWS, D).to(dtype)
        leaves = [x, _rand(g, 4 * D, D) * D ** -0.5, _rand(g, 4 * D),
                  _rand(g, D, 4 * D) * (4 * D) ** -0.5, _rand(g, D)]

        def lin(x, w, b):
            if dtype == torch.bfloat16:
                return F.linear(x, w.to(dtype)) + b.to(dtype)
            return F.linear(x, w.to(dtype), b.to(dtype))

        def want(x, w1, b1, w2, b2):
            return lin(F.relu(lin(x, w1, b1)), w2, b2)

        return leaves, ffn_ops.ffn, want
    return make


def _attention(g):
    q, k = _rand(g, 3, 7, D).double(), _rand(g, 3, 11, D).double()
    mask = torch.rand(3, 11, generator=g) > 0.3
    mask[-1] = False  # a dummy graph's keys: all masked

    def got(q, k, v):
        return attention.fused_attention(q, k, v, mask)

    def want(q, k, v):
        return attention.dot_product_attention(q, k, v, mask)

    return [q, k, _rand(g, 3, 11, D).double()], got, want


def _segment_sum(g):
    ids = torch.randint(-2, 9, (3, 40), generator=g, dtype=torch.int32)

    def got(data):
        return segment.batched_segment_sum(data, ids, 7)

    def want(data):
        return segment.segment_sum_reference(data, ids, 7)

    return [_rand(g, 3, 40, 5).double()], got, want


def _layer_norm_lp(g):
    leaves = [_rand(g, 4, 9, D).double() * 2,
              torch.rand(D, generator=g).double() + 0.5,
              _rand(g, D).double()]
    return leaves, layernorm.layer_norm_lp, layernorm.layer_norm


CASES = {
    "linear_f64": _linear(torch.float64),
    "linear_bf16": _linear(torch.bfloat16),
    "ffn_f64": _ffn(torch.float64),
    "ffn_bf16": _ffn(torch.bfloat16),
    "fused_attention_f64": _attention,
    "batched_segment_sum_f64": _segment_sum,
    "layer_norm_lp_f64": _layer_norm_lp,
}


def _run(fn, leaves):
    leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
    out = fn(*leaves)
    out.float().square().sum().backward()
    return [out.detach()] + [t.grad for t in leaves]


@pytest.mark.parametrize("case", list(CASES))
def test_op_takes_the_plain_version_for_operands_the_kernels_refuse(
        case, monkeypatch):
    counters = (linear_ops.linear_op, ffn_ops.ffn, attention.fused_attention,
                segment.batched_segment_sum, layernorm.layer_norm_bwd)
    before = [c.launches for c in counters]
    for target, name in ((linear_ops, "linear_op"),
                         (ffn_ops, "ffn_reference"),
                         (ffn_ops._FFN, "apply"),
                         (attention._FusedAttention, "apply"),
                         (segment._SegmentSum, "apply"),
                         (layernorm._LayerNormLP, "apply")):
        monkeypatch.setattr(target, name, _refuse)
    leaves, got, want = CASES[case](torch.Generator().manual_seed(0))
    runs = [_run(got, leaves), _run(want, leaves)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert runs[0][0].dtype == leaves[0].dtype
    assert [c.launches for c in counters] == before
