"""The port's CUDA kernels against their plain PyTorch versions on the card
(marker ``cuda``; they skip where no CUDA device is visible). The kernels
have no CPU mode, so these are the only tests that run them; chip_smoke.py
runs the same comparison at the flagship shapes.

f32 on the card with TF32 off; the kernel and the plain version sum in
different orders, so atol 1e-5 on outputs of magnitude ~1 (rtol 1e-5).
Parameter gradients of the message-passing backward are sums over every
edge of the batch: rtol 1e-4 against their largest element. The segment sum
adds the same terms as its plain version in another order: 1e-5 of the
largest output; at F = 1 over 0/1 edge masks (the phDOS count) the sums are
small integers and must be exact. The phDOS shapes: queries Lq = 51 against
8-16 atom keys or 51 energy tokens, batches 1, 8 and 16, and the edge counts
of synthetic (128 slots) and featurised crystals (up to 2,048)."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from dostransformer_tpu_torch.ops.attention import (  # noqa: E402
    attention_bwd_reference,
    dot_product_attention,
    fused_attention,
    fused_attention_bwd,
    key_bias,
)
from dostransformer_tpu_torch.ops.fused_mp import (  # noqa: E402
    fused_mp_edge,
    fused_mp_edge_bwd,
    mp_edge_bwd_reference,
    mp_edge_reference,
)
from dostransformer_tpu_torch.ops.segment import (  # noqa: E402
    batched_segment_sum,
    segment_sum_reference,
)

pytestmark = pytest.mark.cuda
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _mp_args(dev, b, a, e, m, h, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)
    idx = lambda: torch.randint(0, a, (b, e), generator=g, dtype=torch.int32)
    mask = (torch.rand(b, e, generator=g) > 0.2).float()
    args = (r(b, a, m), r(b, a, m), r(b, e, m), idx(), idx(), mask,
            torch.rand(m, generator=g) + 0.5, r(m) * 0.1, torch.tensor([0.3]),
            r(h, m) * m ** -0.5, r(h) * 0.1)
    return [t.to(dev) for t in args]


@pytest.mark.parametrize("shape", [(8, 32, 384, 512, 256), (3, 13, 70, 48, 24),
                                   (2, 5, 17, 600, 300),
                                   (8, 16, 128, 512, 256),
                                   (1, 64, 2048, 512, 256)])
def test_fused_mp_edge_matches_plain(dev, shape):
    args = _mp_args(dev, *shape)
    before = fused_mp_edge.launches
    e_out, agg = fused_mp_edge(*args)
    assert fused_mp_edge.launches == before + 1
    want_e, want_agg = mp_edge_reference(*args)
    torch.testing.assert_close(e_out, want_e, **TOL)
    torch.testing.assert_close(agg, want_agg, rtol=1e-5, atol=1e-4)
    again = fused_mp_edge(*args)  # deterministic: no float atomics
    assert torch.equal(again[0], e_out) and torch.equal(again[1], agg)


def test_fused_mp_edge_out_of_range_index_reads_nothing(dev):
    args = _mp_args(dev, 2, 5, 9, 32, 16)
    args[3][0, 0] = 99  # sender out of range: contributes a zero row
    args[4][1, 2] = -1  # receiver out of range: reaches no node
    e_out, agg = fused_mp_edge(*args)
    assert torch.isfinite(e_out).all() and torch.isfinite(agg).all()


def test_fused_mp_edge_rejects_wrong_dtype(dev):
    args = _mp_args(dev, 2, 5, 9, 32, 16)
    args[3] = args[3].long()
    with pytest.raises(TypeError):
        fused_mp_edge(*args)


@pytest.mark.parametrize("shape", [(8, 201, 32, 256), (16, 201, 201, 256),
                                   (3, 5, 70, 96), (2, 40, 33, 512),
                                   (8, 51, 16, 256), (16, 51, 51, 256),
                                   (1, 51, 8, 256), (2, 51, 51, 256)])
def test_fused_attention_matches_plain(dev, shape):
    b, lq, lk, d = shape
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(b, n, d, generator=g).to(dev)
               for n in (lq, lk, lk))
    km = (torch.rand(b, lk, generator=g) > 0.3).to(dev)
    km[-1] = False  # fully masked row: uniform average, never NaN
    for mask in (km, None):
        before = fused_attention.launches
        got = fused_attention(q, k, v, mask)
        assert fused_attention.launches == before + 1
        torch.testing.assert_close(got, dot_product_attention(q, k, v, mask),
                                   **TOL)


def test_fused_attention_rejects_wrong_dtype_and_width(dev):
    q = torch.randn(2, 4, 64, device=dev)
    with pytest.raises(TypeError):
        fused_attention(q.double(), q.double(), q.double())
    q = torch.randn(2, 4, 40, device=dev)
    with pytest.raises(ValueError):
        fused_attention(q, q, q)


def _close_scaled(got, want, rtol):
    """max |got - want| <= rtol * max(1, max |want|)."""
    err = (got - want).abs().max().item()
    assert err <= rtol * max(1.0, want.abs().max().item()), err


@pytest.mark.parametrize("shape", [(8, 32, 384, 512, 256), (3, 13, 70, 48, 24),
                                   (2, 5, 17, 600, 300),
                                   (8, 16, 128, 512, 256),
                                   (1, 64, 2048, 512, 256)])
def test_fused_mp_edge_bwd_matches_plain(dev, shape):
    b, a, e, m, h = shape
    args = _mp_args(dev, *shape)
    args[5][-1] = 0.0  # a dummy graph: every edge is padding
    g = torch.Generator().manual_seed(5)
    cot = (torch.randn(b, e, h, generator=g).to(dev),
           torch.randn(b, a, h, generator=g).to(dev))
    fwd = args[:10]
    before = fused_mp_edge_bwd.launches
    got = fused_mp_edge_bwd(*fwd, *cot)
    assert fused_mp_edge_bwd.launches == before + 1
    want = mp_edge_bwd_reference(*fwd, *cot)
    for i, (x, w) in enumerate(zip(got, want)):
        assert x.shape == w.shape
        _close_scaled(x, w, 1e-5 if i < 3 else 1e-4)
    again = fused_mp_edge_bwd(*fwd, *cot)  # deterministic: no float atomics
    assert all(torch.equal(x, y) for x, y in zip(got, again))


def test_fused_mp_edge_is_differentiable_on_the_card(dev):
    args = _mp_args(dev, 3, 13, 70, 48, 24)
    leaves = [t.clone().requires_grad_(t.is_floating_point() and i != 5)
              for i, t in enumerate(args)]
    e_out, agg = fused_mp_edge(*leaves)
    (e_out.square().sum() + agg.sum()).backward()
    ref = [t.clone().requires_grad_(t.is_floating_point() and i != 5)
           for i, t in enumerate(args)]
    e_ref, agg_ref = mp_edge_reference(*ref)
    (e_ref.square().sum() + agg_ref.sum()).backward()
    for x, w in zip(leaves, ref):
        if w.grad is not None:
            _close_scaled(x.grad, w.grad, 1e-4)


@pytest.mark.parametrize("shape", [(8, 201, 32, 256), (16, 201, 201, 256),
                                   (3, 5, 70, 96), (2, 40, 33, 512),
                                   (8, 51, 16, 256), (16, 51, 51, 256),
                                   (1, 51, 8, 256), (2, 51, 51, 256)])
def test_fused_attention_bwd_matches_plain(dev, shape):
    b, lq, lk, d = shape
    g = torch.Generator().manual_seed(2)
    q, k, v, go = (torch.randn(b, n, d, generator=g).to(dev)
                   for n in (lq, lk, lk, lq))
    km = (torch.rand(b, lk, generator=g) > 0.3).to(dev)
    km[-1] = False  # fully masked row: p = 1/Lk on every key
    for mask in (km, None):
        bias = (key_bias(mask) if mask is not None
                else torch.zeros(b, lk, device=dev))
        o = fused_attention(q, k, v, mask)
        before = fused_attention_bwd.launches
        got = fused_attention_bwd(q, k, v, bias, o, go)
        assert fused_attention_bwd.launches == before + 1
        want = attention_bwd_reference(q, k, v, bias, go)
        for x, w in zip(got, want):
            _close_scaled(x, w, 1e-5)
        again = fused_attention_bwd(q, k, v, bias, o, go)
        assert all(torch.equal(x, y) for x, y in zip(got, again))


def test_fused_attention_is_differentiable_on_the_card(dev):
    g = torch.Generator().manual_seed(3)
    q = torch.randn(4, 9, 64, generator=g).to(dev).requires_grad_()
    kv = torch.randn(4, 6, 64, generator=g).to(dev).requires_grad_()
    km = torch.ones(4, 6, dtype=torch.bool, device=dev)
    km[-1] = False
    fused_attention(q, kv, kv, km).square().sum().backward()
    q2, kv2 = q.detach().clone().requires_grad_(), kv.detach().clone().requires_grad_()
    dot_product_attention(q2, kv2, kv2, km).square().sum().backward()
    _close_scaled(q.grad, q2.grad, 1e-5)
    _close_scaled(kv.grad, kv2.grad, 1e-5)  # k and v are one tensor


def _segment_args(dev, b, e, f, n, seed=0):
    """Edge rows masked as the model masks them (a dummy graph last), ids
    with out-of-range and negative entries."""
    g = torch.Generator().manual_seed(seed)
    mask = (torch.rand(b, e, generator=g) > 0.25).float()
    mask[-1] = 0.0
    data = (mask[..., None] if f == 1
            else torch.randn(b, e, f, generator=g) * mask[..., None])
    ids = torch.randint(-2, n + 2, (b, e), generator=g, dtype=torch.int32)
    return data.to(dev), ids.to(dev)


@pytest.mark.parametrize("shape", [(8, 128, 1, 16), (1, 2048, 1, 64),
                                   (8, 384, 256, 32), (3, 70, 5, 13),
                                   (2, 17, 300, 5), (2, 0, 4, 3)])
def test_batched_segment_sum_matches_plain(dev, shape):
    b, e, f, n = shape
    data, ids = _segment_args(dev, b, e, f, n)
    before = batched_segment_sum.launches
    got = batched_segment_sum(data, ids, n)
    assert batched_segment_sum.launches == before + 1
    want = segment_sum_reference(data, ids, n)
    assert got.shape == want.shape == (b, n, f)
    if f == 1:
        assert torch.equal(got, want)  # integer counts: exact
    else:
        _close_scaled(got, want, 1e-5)
    assert torch.equal(batched_segment_sum(data, ids, n), got)  # no atomics


def test_batched_segment_sum_is_differentiable_and_checked(dev):
    data, ids = _segment_args(dev, 3, 70, 5, 13)
    leaf = data.clone().requires_grad_()
    g = torch.randn(3, 13, 5, device=dev)
    batched_segment_sum(leaf, ids, 13).backward(g)
    ref = data.clone().requires_grad_()
    segment_sum_reference(ref, ids, 13).backward(g)
    assert torch.equal(leaf.grad, ref.grad)  # a gather: exact
    with pytest.raises(TypeError):
        batched_segment_sum(data, ids.long(), 13)
    with pytest.raises(TypeError):
        batched_segment_sum(data.double(), ids, 13)
