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
from dostransformer_tpu_torch import tracing  # noqa: E402
from dostransformer_tpu_torch.ops import ffn as ffn_ops  # noqa: E402
from dostransformer_tpu_torch.ops import layernorm as ln_ops  # noqa: E402
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
                segment.batched_segment_sum, ln_ops.layer_norm,
                ln_ops.layer_norm_bwd)
    before = [c.launches for c in counters]
    for target, name in ((linear_ops, "linear_op"),
                         (ffn_ops, "ffn_reference"),
                         (ffn_ops._FFN, "apply"),
                         (attention._FusedAttention, "apply"),
                         (segment._SegmentSum, "apply"),
                         (layernorm._LayerNormLP, "apply"),
                         (ln_ops._LayerNorm, "apply")):
        monkeypatch.setattr(target, name, _refuse)
    leaves, got, want = CASES[case](torch.Generator().manual_seed(0))
    runs = [_run(got, leaves), _run(want, leaves)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert runs[0][0].dtype == leaves[0].dtype
    assert [c.launches for c in counters] == before


def _widened_layer_norm(x, w, b):
    """The default LayerNorm as the layers composed it before the op: the
    widened ``F.layer_norm`` cast back."""
    f = torch.promote_types(x.dtype, torch.float32)
    return F.layer_norm(x.to(f), x.shape[-1:], w.to(f), b.to(f),
                        ln_ops.LN_EPS).to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_layer_norm_takes_f_layer_norm_on_the_cpu_and_for_f64(dtype,
                                                             monkeypatch):
    """On the CPU (every dtype) and for f64 the op is the widened
    ``F.layer_norm`` bit for bit, gradients too; the kernels' Function is
    never entered and nothing is launched."""
    monkeypatch.setattr(ln_ops._LayerNorm, "apply", _refuse)
    monkeypatch.setattr(ln_ops, "layer_norm_fwd_op", _refuse)
    before = (ln_ops.layer_norm.launches, ln_ops.layer_norm_bwd.launches)
    g = torch.Generator().manual_seed(3)
    leaves = [(_rand(g, 4, 9, D) * 3 + 1).to(dtype),
              torch.rand(D, generator=g) + 0.5, _rand(g, D)]
    runs = [_run(ln_ops.layer_norm, leaves),
            _run(_widened_layer_norm, leaves)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert runs[0][0].dtype == dtype
    assert (ln_ops.layer_norm.launches,
            ln_ops.layer_norm_bwd.launches) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("shape", [(7, 50), (3, 5, 256), (2, 1040)])
def test_layer_norm_reference_gives_f_layer_norm_and_var_mean(dtype, shape):
    """The plain forward with statistics: y is the widened F.layer_norm,
    mean and rstd are torch.var_mean's (biased) in f32 or wider."""
    g = torch.Generator().manual_seed(5)
    x = (_rand(g, *shape) * 2 + 0.5).to(dtype)
    w, b = torch.rand(shape[-1], generator=g) + 0.5, _rand(g, shape[-1])
    y, mean, rstd = ln_ops.layer_norm_reference(x, w, b)
    f = torch.promote_types(dtype, torch.float32)
    var, want_mean = torch.var_mean(x.to(f), -1, correction=0)
    assert torch.equal(y, _widened_layer_norm(x, w, b))
    assert mean.dtype == rstd.dtype == f and mean.shape == shape[:-1]
    assert torch.equal(mean, want_mean)
    assert torch.equal(rstd, torch.rsqrt(var + ln_ops.LN_EPS))


def test_layer_norm_counts_every_calls_rows():
    """``layer_norm.rows`` counts the rows of every call, whatever its
    dtype; on the CPU no call counts ``layer_norm.kernel_rows``."""
    names = ("layer_norm.rows", "layer_norm.kernel_rows")

    def read():
        return [tracing.record().counters.get(k, 0) for k in names]

    before = read()
    w, b = torch.ones(D), torch.zeros(D)
    for dtype, shape in ((torch.float32, (4, 9, D)),
                         (torch.bfloat16, (3, D)),
                         (torch.float64, (2, 5, 7, D))):
        ln_ops.layer_norm(torch.randn(shape).to(dtype), w, b)
    assert read() == [before[0] + 36 + 3 + 70, before[1]]
