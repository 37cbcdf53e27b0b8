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
of synthetic (128 slots) and featurised crystals (up to 2,048).

The LN-fused attention forward and the LayerNorm backward take f32 and bf16
operands: f32 as above (the LayerNorm's parameter gradients, sums over every
row, 1e-4 of their largest element); bf16 outputs within 2 bf16 ulps (2^-6)
of the largest plain value for the attention (the kernel keeps the softmax
weights at TF32's 10 bits where the plain version rounds them to bf16), and
within 3%
of it for the LayerNorm backward (the kernel keeps g = dy * scale in f32
where the plain version rounds it: the JAX package's own bound)."""

import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from dostransformer_tpu_torch.nn.layernorm import (  # noqa: E402
    layer_norm,
    layer_norm_bwd,
    layer_norm_lp,
    ln_bwd_reference,
)
from dostransformer_tpu_torch.ops.attention import (  # noqa: E402
    attention_plan,
    fused_attention_fwd,
    attention_bwd_reference,
    attention_stats_reference,
    dot_product_attention,
    fused_attention,
    fused_attention_bwd,
    fused_attention_ln,
    key_bias,
    ln_attention_reference,
)
from dostransformer_tpu_torch.ops import kernels  # noqa: E402
from dostransformer_tpu_torch.ops.fused_mp import (  # noqa: E402
    FORM_GENERIC,
    FORM_TENSOR_CORE,
    _fused_mp_edge_fwd as fused_mp_forward_kernel,
    fused_mp_bwd_form,
    fused_mp_edge,
    fused_mp_edge_bwd,
    fused_mp_edge_bwd_tile,
    fused_mp_edge_tile,
    fused_mp_form,
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
    # bf16 products accumulate in f32, as the plain versions' on the CPU
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


# the two flagships, widths that keep the generic (FMA) form, phDOS at
# batch 1, a long edge list, edge counts no tile of the tensor-core form
# divides (at its widths), and the wide hidden widths: 576 and 768 (the
# backward's tensor-core form in a cluster), 624 and 1,000 (the generic
# backward with xhat in scratch) and 1,024 (a cluster of four)
MP_SHAPES = [(8, 32, 384, 512, 256), (3, 13, 70, 48, 24), (2, 5, 17, 600, 300),
             (8, 16, 128, 512, 256), (1, 64, 2048, 512, 256),
             (1, 16, 128, 512, 256), (3, 13, 70, 64, 32), (2, 7, 45, 96, 160),
             (2, 6, 40, 1152, 576), (2, 6, 40, 1248, 624),
             (2, 6, 40, 1536, 768), (2, 6, 40, 2000, 1000),
             (2, 6, 40, 2048, 1024)]


def _mp_args(dev, b, a, e, m, h, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)
    idx = lambda: torch.randint(0, a, (b, e), generator=g, dtype=torch.int32)
    mask = (torch.rand(b, e, generator=g) > 0.2).float()
    args = (r(b, a, m), r(b, a, m), r(b, e, m), idx(), idx(), mask,
            torch.rand(m, generator=g) + 0.5, r(m) * 0.1, torch.tensor([0.3]),
            r(h, m) * m ** -0.5, r(h) * 0.1)
    return [t.to(dev) for t in args]


@pytest.mark.parametrize("shape", MP_SHAPES)
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


@pytest.mark.parametrize("widths", [(32, 16), (64, 32)])
def test_fused_mp_edge_out_of_range_index_reads_nothing(dev, widths):
    args = _mp_args(dev, 2, 5, 9, *widths)
    args[3][0, 0] = 99  # sender out of range: contributes a zero row
    args[4][1, 2] = -1  # receiver out of range: reaches no node
    e_out, agg = fused_mp_edge(*args)
    assert torch.isfinite(e_out).all() and torch.isfinite(agg).all()
    want_e, want_agg = _mp_plain_with_bad_indices(args)
    torch.testing.assert_close(e_out, want_e, **TOL)
    torch.testing.assert_close(agg, want_agg, rtol=1e-5, atol=1e-4)


def _mp_plain_with_bad_indices(args):
    """The plain forward where an out-of-range sender or receiver reads a
    zero row and reaches no node: an extra zero node takes them."""
    a = args[0].shape[1]
    pad = lambda x: torch.cat([x, torch.zeros_like(x[:, :1])], 1)
    fix = lambda i: torch.where((i < 0) | (i >= a), a, i)
    e_out, agg = mp_edge_reference(pad(args[0]), pad(args[1]), args[2],
                                   fix(args[3]), fix(args[4]), *args[5:])
    return e_out, agg[:, :a]


@pytest.mark.parametrize("widths", [(512, 256), (64, 32), (48, 24), (600, 300),
                                    (2048, 1024), (96, 160), (32, 48),
                                    (520, 256), (1024, 512), (1088, 544),
                                    (1152, 576), (1216, 608), (3072, 32),
                                    (3104, 32), (1536, 64), (1248, 624),
                                    (1280, 640), (768, 384), (1536, 768),
                                    (2000, 1000)])
def test_fused_mp_form_matches_the_python_rule(dev, widths):
    lib = kernels.library()
    assert lib.dostpu_fused_mp_form(*widths) == fused_mp_form(*widths)
    assert lib.dostpu_fused_mp_bwd_form(*widths) == fused_mp_bwd_form(*widths)


def test_fused_mp_shapes_reach_every_tile(dev):
    """The shapes of MP_SHAPES between them run every tile of the
    tensor-core forward and every tile and cluster shape of the backward."""
    assert {fused_mp_edge_tile(b, e, m, h)
            for b, _, e, m, h in MP_SHAPES if fused_mp_form(m, h)} == {
        (32, 256), (16, 64)}
    assert {fused_mp_edge_bwd_tile(b, e, m, h)[:2]
            for b, _, e, m, h in MP_SHAPES if fused_mp_bwd_form(m, h)} == {
        (32, 1), (16, 1), (16, 2), (16, 4)}


@pytest.mark.parametrize("shape", [(8, 32, 384, 512, 256),
                                   (8, 16, 128, 512, 256),
                                   (3, 13, 70, 64, 32)])
def test_fused_mp_edge_both_forms_agree(dev, shape):
    """At tensor-core widths the generic form and the tensor-core form both
    give the plain version's outputs; each repeats its own bits."""
    args = _mp_args(dev, *shape)
    want_e, want_agg = mp_edge_reference(*args)
    for form in (FORM_GENERIC, FORM_TENSOR_CORE):
        e_out, agg = fused_mp_forward_kernel(*args, form=form)
        torch.testing.assert_close(e_out, want_e, **TOL)
        torch.testing.assert_close(agg, want_agg, rtol=1e-5, atol=1e-4)
        again = fused_mp_forward_kernel(*args, form=form)
        assert torch.equal(again[0], e_out) and torch.equal(again[1], agg)


def test_fused_mp_tensor_core_form_refuses_other_widths(dev):
    args = _mp_args(dev, 2, 5, 9, 48, 24)
    with pytest.raises(ValueError, match="multiples of 32"):
        fused_mp_forward_kernel(*args, form=FORM_TENSOR_CORE)
    with pytest.raises(ValueError, match="none of FORM_BY_SHAPE"):
        fused_mp_forward_kernel(*args, form=100)


def test_fused_mp_edge_hidden_1024(dev):
    """M = 2,048, H = 1,024 (--hidden 1024): the forward runs (its 16 x 64
    tile fits); the backward takes the tensor-core form in a cluster of four
    blocks (201,024 bytes a block) and matches its plain version, bit for
    bit on a rerun; the generic form (35,040 bytes at every width) agrees."""
    shape = (2, 6, 40, 2048, 1024)
    args = _mp_args(dev, *shape)
    e_out, agg = fused_mp_edge(*args)
    want_e, want_agg = mp_edge_reference(*args)
    torch.testing.assert_close(e_out, want_e, **TOL)
    torch.testing.assert_close(agg, want_agg, rtol=1e-5, atol=1e-4)
    g = torch.Generator().manual_seed(7)
    cot = (torch.randn(2, 40, 1024, generator=g).to(dev),
           torch.randn(2, 6, 1024, generator=g).to(dev))
    assert fused_mp_edge_bwd_tile(2, 40, 2048, 1024)[:2] == (16, 4)
    lib = kernels.library()
    assert lib.dostpu_fused_mp_edge_bwd_smem_bytes(2, 40, 2048, 1024,
                                                   -1) == 201024
    assert lib.dostpu_fused_mp_edge_bwd_smem_bytes(2, 40, 2048, 1024,
                                                   0) == 35040
    want = mp_edge_bwd_reference(*args[:10], *cot)
    for form in (FORM_TENSOR_CORE, FORM_GENERIC):
        got = fused_mp_edge_bwd(*args[:10], *cot, form=form)
        for i, (x, w) in enumerate(zip(got, want)):
            _close_scaled(x, w, 1e-5 if i < 3 else 1e-4)
        again = fused_mp_edge_bwd(*args[:10], *cot, form=form)
        assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("hidden", [1040, 1050, 2080])
def test_fused_mp_at_the_widths_the_generic_forms_repaired(dev, hidden):
    """M = 2H at hidden 1,040, 1,050 and 2,080, where no block of the first
    generic designs fit (and no tensor-core block does): both kernels take
    the generic forms (36,032 and 35,040 bytes a block at every width),
    match their plain versions (1e-5; 1e-4 parameter gradients) and repeat
    their bits on a second run."""
    b, a, e, m, h = 2, 6, 40, 2 * hidden, hidden
    assert fused_mp_form(m, h) == fused_mp_bwd_form(m, h) == FORM_GENERIC
    lib = kernels.library()
    assert lib.dostpu_fused_mp_edge_smem_bytes(b, e, m, h, -1) == 36032
    assert lib.dostpu_fused_mp_edge_bwd_smem_bytes(b, e, m, h, -1) == 35040
    args = _mp_args(dev, b, a, e, m, h)
    args[5][-1] = 0.0  # a dummy graph: every edge is padding
    got = fused_mp_edge(*args)
    for x, w in zip(got, mp_edge_reference(*args)):
        _close_scaled(x, w, 1e-5)
    again = fused_mp_edge(*args)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    g = torch.Generator().manual_seed(7)
    cot = (torch.randn(b, e, h, generator=g).to(dev),
           torch.randn(b, a, h, generator=g).to(dev))
    got = fused_mp_edge_bwd(*args[:10], *cot)
    want = mp_edge_bwd_reference(*args[:10], *cot)
    for i, (x, w) in enumerate(zip(got, want)):
        _close_scaled(x, w, 1e-5 if i < 3 else 1e-4)
    again = fused_mp_edge_bwd(*args[:10], *cot)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


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
    q = torch.randn(2, 4, 0, device=dev)  # no feature at all
    with pytest.raises(ValueError):
        fused_attention(q, q, q)


def _close_scaled(got, want, rtol):
    """max |got - want| <= rtol * max(1, max |want|)."""
    err = (got - want).abs().max().item()
    assert err <= rtol * max(1.0, want.abs().max().item()), err


@pytest.mark.parametrize("shape", MP_SHAPES)
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


@pytest.mark.parametrize("shape", [(8, 32, 384, 512, 256),
                                   (8, 16, 128, 512, 256),
                                   (3, 13, 70, 64, 32)])
def test_fused_mp_edge_bwd_both_forms_agree(dev, shape):
    """At tensor-core widths the generic form and the tensor-core form both
    give the plain backward; each repeats its own bits."""
    b, a, e, m, h = shape
    args = _mp_args(dev, *shape)
    g = torch.Generator().manual_seed(6)
    cot = (torch.randn(b, e, h, generator=g).to(dev),
           torch.randn(b, a, h, generator=g).to(dev))
    want = mp_edge_bwd_reference(*args[:10], *cot)
    for form in (FORM_GENERIC, FORM_TENSOR_CORE):
        got = fused_mp_edge_bwd(*args[:10], *cot, form=form)
        for i, (x, w) in enumerate(zip(got, want)):
            _close_scaled(x, w, 1e-5 if i < 3 else 1e-4)
        again = fused_mp_edge_bwd(*args[:10], *cot, form=form)
        assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("widths", [(48, 24), (64, 32)])
def test_fused_mp_edge_is_differentiable_on_the_card(dev, widths):
    args = _mp_args(dev, 3, 13, 70, *widths)
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


# the six attention calls of the two flagships, then ragged shapes, the
# widest row staged whole (D = 512), widths that are no multiple of 32
# (4-byte staging at odd D), and the sliced kernels (D > 512) at the h1024
# shapes
TC_SHAPES = [(8, 201, 32, 256), (16, 201, 201, 256), (16, 201, 32, 256),
             (8, 51, 16, 256), (16, 51, 51, 256), (16, 51, 16, 256),
             (3, 13, 5, 64), (2, 1, 1, 32), (2, 40, 33, 512),
             (3, 13, 5, 1), (2, 40, 33, 33), (4, 21, 19, 48), (3, 17, 40, 50),
             (2, 33, 21, 200), (2, 40, 33, 544), (3, 19, 70, 1000),
             (8, 201, 32, 1024), (16, 201, 201, 1024)]


@pytest.mark.parametrize("shape", TC_SHAPES)
def test_attention_tensor_core_kernels(dev, shape):
    """The forward and backward kernels (3xTF32 tensor-core products) at one
    shape, pad keys masked and the last graph fully masked: outputs, row
    statistics and gradients within 1e-5 x max(1, max|plain|); keys and
    values as one tensor give the bits of two copies; the backward gives the
    same bits with the forward's statistics and without, and on a second
    run."""
    b, lq, lk, d = shape
    g = torch.Generator().manual_seed(11)
    q, k, go = (torch.randn(b, n, d, generator=g).to(dev)
                for n in (lq, lk, lq))
    km = torch.arange(lk)[None] < torch.randint(1, lk + 1, (b, 1), generator=g)
    km[-1] = False
    km = km.to(dev)
    bias = key_bias(km)
    o, stats = fused_attention_fwd(q, k, k, bias, want_stats=True)
    assert torch.isfinite(o).all()
    _close_scaled(o, dot_product_attention(q, k, k, km), 1e-5)
    want = attention_stats_reference(q, k, bias)
    assert stats.shape == (2, b, lq)
    assert (stats[0][-1] == -1e30).all() and (stats[1][-1] == lk).all()
    _close_scaled(stats[0][:-1], want[0][:-1], 1e-5)
    _close_scaled(stats[0][:-1] + stats[1][:-1].log(),
                  want[0][:-1] + want[1][:-1].log(), 1e-5)
    copy = k.clone()
    o_copy, none = fused_attention_fwd(q, k, copy, bias)
    assert none is None and torch.equal(o_copy, o)

    got = fused_attention_bwd(q, k, k, bias, o, go, stats)
    for x, w in zip(got, attention_bwd_reference(q, k, k, bias, go)):
        assert torch.isfinite(x).all()
        _close_scaled(x, w, 1e-5)
    for other in (fused_attention_bwd(q, k, k, bias, o, go),         # no stats
                  fused_attention_bwd(q, k, copy, bias, o, go, stats),
                  fused_attention_bwd(q, k, k, bias, o, go, stats)):  # again
        assert all(torch.equal(x, y) for x, y in zip(got, other))


@pytest.mark.parametrize("d", [1, 33, 48, 50, 200, 544, 1024])
def test_attention_at_any_width_with_distinct_keys_and_values(dev, d):
    """Keys and values two distinct tensors at feature widths that are no
    multiple of 32 or above 512: the forward, the backward kernel and the
    gradients of fused_attention through autograd against the plain
    versions (1e-5 x max(1, max|plain|)), the backward bit-identical on a
    rerun and without the forward's statistics."""
    g = torch.Generator().manual_seed(12)
    b, lq, lk = 3, 37, 29
    q, k, v, go = (torch.randn(b, n, d, generator=g).to(dev)
                   for n in (lq, lk, lk, lq))
    km = torch.arange(lk)[None] < torch.tensor([[lk], [5], [0]])
    km = km.to(dev)
    bias = key_bias(km)
    o, stats = fused_attention_fwd(q, k, v, bias, want_stats=True)
    _close_scaled(o, dot_product_attention(q, k, v, km), 1e-5)
    got = fused_attention_bwd(q, k, v, bias, o, go, stats)
    for x, w in zip(got, attention_bwd_reference(q, k, v, bias, go)):
        _close_scaled(x, w, 1e-5)
    for other in (fused_attention_bwd(q, k, v, bias, o, go, stats),
                  fused_attention_bwd(q, k, v, bias, o, go)):
        assert all(torch.equal(x, y) for x, y in zip(got, other))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fused_attention(*leaves, km).backward(go)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    dot_product_attention(*ref, km).backward(go)
    for x, w in zip(leaves, ref):
        _close_scaled(x.grad, w.grad, 1e-5)


def test_attention_plan_matches_the_library(dev):
    lib = kernels.library()
    for d in (1, 31, 32, 33, 48, 50, 200, 512, 513, 544, 1000, 1024, 1536,
              2049):
        nc, slices = ctypes.c_int(), ctypes.c_int()
        lib.dostpu_attention_plan(d, nc, slices)
        assert (nc.value, slices.value) == attention_plan(d)


def test_attention_kernels_reject_what_they_do_not_take(dev):
    q = torch.randn(2, 4, 64, device=dev)
    bias = torch.zeros(2, 4, device=dev)
    with pytest.raises(TypeError):
        fused_attention_bwd(q.double(), q.double(), q.double(), bias, q, q)
    with pytest.raises(TypeError):
        fused_attention_bwd(q, q, q, bias, q, q, torch.zeros(2, 2, 4,
                            device=dev, dtype=torch.float64))
    empty = torch.randn(2, 4, 0, device=dev)  # no feature at all
    with pytest.raises(ValueError):
        fused_attention_bwd(empty, empty, empty, bias, empty, empty)
    strided = torch.randn(2, 4, 128, device=dev)[..., ::2]  # not contiguous
    for args in ((strided, q, q), (q, strided, strided), (q, q, strided)):
        with pytest.raises(ValueError):
            fused_attention(*args)
    expanded = torch.randn(4, 64, device=dev).expand(2, 4, 64)
    with pytest.raises(ValueError):
        fused_attention(expanded, q, q)
    with pytest.raises(ValueError):
        fused_attention_bwd(q, strided, strided, bias, q, q)
    with pytest.raises(ValueError):  # the statistics of another shape
        fused_attention_bwd(q, q, q, bias, q, q,
                            torch.zeros(2, 2, 5, device=dev))


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
                                   (2, 17, 300, 5), (2, 0, 4, 3),
                                   (8, 2048, 1, 64), (8, 2048, 256, 64),
                                   (3, 70, 3, 13), (2, 90, 300, 7),
                                   (4, 50, 8, 1), (2, 600, 4, 256),
                                   (2, 3000, 1, 256), (1, 384, 256, 32),
                                   (1, 9, 1, 1)])
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


def _ln_attn_inputs(dev, b, lq, lk, d, dtype=torch.float32, seed=6):
    g = torch.Generator().manual_seed(seed)
    x, xk, xv = ((torch.randn(b, n, d, generator=g) * 2 + 0.5).to(dev, dtype)
                 for n in (lq, lk, lk))
    scale = (torch.rand(d, generator=g) + 0.5).to(dev)
    bias = (torch.randn(d, generator=g) * 0.1).to(dev)
    km = (torch.rand(b, lk, generator=g) > 0.3).to(dev)
    km[-1] = False  # fully masked row: the mean of the normalised values
    return x, xk, xv, scale, bias, km


@pytest.mark.parametrize("shape", [(8, 201, 32, 256), (16, 201, 201, 256),
                                   (3, 5, 70, 96), (2, 40, 33, 512),
                                   (8, 51, 16, 256), (16, 51, 51, 256),
                                   (1, 51, 8, 256), (2, 17, 17, 32),
                                   (3, 13, 5, 1), (2, 40, 33, 33),
                                   (4, 21, 19, 48), (3, 17, 40, 50),
                                   (2, 33, 21, 200), (2, 40, 33, 544),
                                   (3, 19, 70, 1000), (8, 201, 32, 1024),
                                   (16, 201, 201, 1024)])
def test_fused_attention_ln_matches_plain(dev, shape):
    b, lq, lk, d = shape
    x, xk, xv, scale, bias, km = _ln_attn_inputs(dev, *shape)
    cases = [(x, xk, xv), (x, xk, xk)]  # distinct k and v; one tensor
    if lq == lk:
        cases.append((x, x, x))  # self-attention on one tensor
    for args in cases:
        for mask in (km, None):
            before = fused_attention_ln.launches, fused_attention.launches
            got = fused_attention_ln(*args, scale, bias, mask)
            assert fused_attention_ln.launches == before[0] + 1
            assert fused_attention.launches == before[1]
            want = ln_attention_reference(*args, scale, bias, mask)
            _close_scaled(got, want, 1e-5)
    # aliasing changes no bit: equal but distinct tensors give the same
    assert torch.equal(fused_attention_ln(x, xk, xk, scale, bias, km),
                       fused_attention_ln(x, xk, xk.clone(), scale, bias, km))


def test_fused_attention_ln_bf16_and_rejections(dev):
    x, xk, xv, scale, bias, km = _ln_attn_inputs(dev, 8, 51, 16, 256,
                                                 torch.bfloat16)
    got = fused_attention_ln(x, xk, xv, scale, bias, km)
    want = ln_attention_reference(x, xk, xv, scale, bias, km)
    assert got.dtype == torch.bfloat16
    _close_scaled(got.float(), want.float(), 2.0 ** -6)
    with pytest.raises(TypeError):
        fused_attention_ln(x.double(), xk.double(), xv.double(), scale, bias)
    with pytest.raises(TypeError):  # one operand dtype
        fused_attention_ln(x, xk.float(), xv.float(), scale, bias)
    with pytest.raises(TypeError):  # f32 LayerNorm parameters
        fused_attention_ln(x, xk, xv, scale.bfloat16(), bias.bfloat16())
    q = torch.randn(2, 4, 0, device=dev)  # no feature at all
    with pytest.raises(ValueError):
        fused_attention_ln(q, q, q, scale[:0], bias[:0])


def test_fused_attention_ln_is_differentiable_on_the_card(dev):
    """Backward through kernels #4 and #7: one LayerNorm backward launch per
    distinct input tensor, no forward attention launch."""
    x, xk, _, scale, bias, km = _ln_attn_inputs(dev, 4, 9, 6, 64)
    for shared_all in (False, True):
        grads = []
        for fn in (fused_attention_ln, ln_attention_reference):
            leaves = [t.clone().requires_grad_() for t in (x, xk, scale, bias)]
            tx, tk, ts, tb = leaves
            args = (tx, tx, tx) if shared_all else (tx, tk, tk)
            before = (layer_norm_bwd.launches, fused_attention_bwd.launches,
                      fused_attention.launches)
            fn(*args, ts, tb, None if shared_all else km).square().sum(
                ).backward()
            if fn is fused_attention_ln:
                assert layer_norm_bwd.launches == before[0] + (
                    1 if shared_all else 2)
                assert fused_attention_bwd.launches == before[1] + 1
                assert fused_attention.launches == before[2]
            grads.append([t.grad for t in leaves if t.grad is not None])
        for got, want in zip(*grads):
            _close_scaled(got, want, 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [(8, 201), (16, 201), (8, 32), (16, 51),
                                  (8, 16), (1,), (3000, 3)])
def test_layer_norm_bwd_matches_plain(dev, rows, dtype):
    d = 256 if rows != (3000, 3) else 96
    g = torch.Generator().manual_seed(8)
    x = (torch.randn(*rows, d, generator=g) * 3 + 1).to(dev, dtype)
    f = x.float()
    mu = f.mean(-1, keepdim=True)
    rstd = torch.rsqrt(f.var(-1, unbiased=False, keepdim=True) + 1e-5)
    xhat = ((f - mu) * rstd).to(dtype)
    dy = torch.randn(*rows, d, generator=g).to(dev, dtype)
    scale = (torch.rand(d, generator=g) + 0.5).to(dev)
    before = layer_norm_bwd.launches
    got = layer_norm_bwd(xhat, rstd, scale, dy)
    assert layer_norm_bwd.launches == before + 1
    want = ln_bwd_reference(xhat, rstd, scale, dy)
    assert got[0].dtype == dtype and got[0].shape == dy.shape
    assert got[1].dtype == got[2].dtype == torch.float32
    if dtype == torch.float32:
        _close_scaled(got[0], want[0], 1e-5)
        _close_scaled(got[1], want[1], 1e-4)
        _close_scaled(got[2], want[2], 1e-4)
    else:
        for a, w in zip(got, want):
            assert ((a.float() - w.float()).abs().max()
                    <= 0.03 * w.float().abs().max())
    again = layer_norm_bwd(xhat, rstd, scale, dy)  # no float atomics
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_layer_norm_lp_on_the_card_and_rejections(dev):
    g = torch.Generator().manual_seed(9)
    x = (torch.randn(4, 9, 64, generator=g) * 2).to(dev)
    w = (torch.rand(64, generator=g) + 0.5).to(dev)
    b = torch.randn(64, generator=g).to(dev)
    grads = []
    for fn in (layer_norm_lp, layer_norm):
        leaves = [t.clone().requires_grad_() for t in (x, w, b)]
        before = layer_norm_bwd.launches
        y = fn(*leaves)
        y.square().sum().backward()
        assert layer_norm_bwd.launches == before + (fn is layer_norm_lp)
        grads.append([y.detach()] + [t.grad for t in leaves])
    for got, want in zip(*grads):
        _close_scaled(got, want, 1e-4)
    xd = x.double().requires_grad_()
    with pytest.raises(TypeError):  # the kernel is f32/bf16
        layer_norm_lp(xd, w.double(), b.double()).sum().backward()
    q = torch.randn(5, 40, device=dev)  # any width runs through the kernel
    got = layer_norm_bwd(q, torch.ones(5, device=dev),
                         torch.ones(40, device=dev), q)
    want = ln_bwd_reference(q, torch.ones(5, 1, device=dev),
                            torch.ones(40, device=dev), q)
    for a, w in zip(got, want):
        _close_scaled(a, w, 1e-4)
    with pytest.raises(ValueError):  # one rstd a row
        layer_norm_bwd(q, torch.ones(4, device=dev),
                       torch.ones(40, device=dev), q)
    with pytest.raises(ValueError):  # one scale a column
        layer_norm_bwd(q, torch.ones(5, device=dev),
                       torch.ones(32, device=dev), q)


@pytest.mark.parametrize("form", ["xhat", "x_mean_rstd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 7, 128, 3216])
@pytest.mark.parametrize("d", [32, 48, 256, 600, 1024])
def test_layer_norm_bwd_any_width_both_forms(dev, d, rows, dtype, form):
    """Any width (the 16-byte vector form, and at bf16 D = 600 / 8 = 75
    vectors), any row count, both operand forms: against the plain version
    (f32 dx 1e-5, dscale and dbias 1e-4; bf16 3%), one launch counted, a
    second run bit-identical."""
    g = torch.Generator().manual_seed(d + rows)
    x = (torch.randn(rows, d, generator=g) * 3 + 1).to(dev, dtype)
    dy = torch.randn(rows, d, generator=g).to(dev, dtype)
    scale = (torch.rand(d, generator=g) + 0.5).to(dev)
    _, mean, rstd = torch.native_layer_norm(
        x.float(), (d,), scale, torch.zeros(d, device=dev), 1e-5)
    if form == "xhat":
        xin, m = ((x.float() - mean) * rstd).to(dtype), None
    else:
        xin, m = x, mean
    before = layer_norm_bwd.launches
    got = layer_norm_bwd(xin, rstd, scale, dy, m)
    assert layer_norm_bwd.launches == before + 1
    want = ln_bwd_reference(xin, rstd, scale, dy, m)
    tols = (1e-5, 1e-4, 1e-4) if dtype == torch.float32 else (0.03,) * 3
    floor = 1.0 if dtype == torch.float32 else 1e-3
    for a, w, tol in zip(got, want, tols):
        assert torch.isfinite(a).all()
        err = (a.float() - w.float()).abs().max().item()
        assert err <= tol * max(floor, w.float().abs().max().item())
    again = layer_norm_bwd(xin, rstd, scale, dy, m)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(300, 50), (9, 1), (40, 2500), (5, 36)])
def test_layer_norm_bwd_scalar_form(dev, rows, d, dtype):
    """Widths that are no whole number of 16-byte vectors, or too wide for a
    lane's registers (and 36 at bf16: 4.5 vectors), take the scalar form."""
    g = torch.Generator().manual_seed(rows)
    x = (torch.randn(rows, d, generator=g) + 0.3).to(dev, dtype)
    dy = torch.randn(rows, d, generator=g).to(dev, dtype)
    scale = (torch.rand(d, generator=g) + 0.5).to(dev)
    _, mean, rstd = torch.native_layer_norm(
        x.float(), (d,), scale, torch.zeros(d, device=dev), 1e-5)
    got = layer_norm_bwd(x, rstd, scale, dy, mean)
    want = ln_bwd_reference(x, rstd, scale, dy, mean)
    tols = (1e-5, 1e-4, 1e-4) if dtype == torch.float32 else (0.03,) * 3
    floor = 1.0 if dtype == torch.float32 else 1e-3
    for a, w, tol in zip(got, want, tols):
        err = (a.float() - w.float()).abs().max().item()
        assert err <= tol * max(floor, w.float().abs().max().item())
    assert all(torch.equal(a, b) for a, b in
               zip(got, layer_norm_bwd(x, rstd, scale, dy, mean)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 201, 32, 256), (16, 201, 201, 256),
                                   (2, 40, 33, 512), (2, 17, 17, 32),
                                   (2, 40, 33, 33), (4, 21, 19, 48),
                                   (3, 17, 40, 50), (2, 33, 21, 200),
                                   (2, 40, 33, 544), (8, 201, 32, 1024)])
def test_fused_attention_ln_large_mean_bf16_and_masked_rows(dev, shape,
                                                            dtype):
    """Inputs with a mean of 50 (25 standard deviations), a graph with all
    keys masked, D from 32 to 1,024 (bf16 rows staged as 16-byte copies at
    D % 8 == 0, 4-byte ones at even D, value by value at odd D), f32 (1e-5)
    and bf16 (2^-6); keys and values as one tensor against two copies, bit
    for bit."""
    b, lq, lk, d = shape
    x, xk, _, scale, bias, km = _ln_attn_inputs(dev, *shape, dtype=dtype)
    x, xk = x + 49.5, xk + 49.5
    got = fused_attention_ln(x, xk, xk, scale, bias, km)
    want = ln_attention_reference(x, xk, xk, scale, bias, km)
    assert torch.isfinite(got).all()
    _close_scaled(got.float(), want.float(),
                  1e-5 if dtype == torch.float32 else 2.0 ** -6)
    assert torch.equal(got, fused_attention_ln(x, xk, xk.clone(), scale,
                                               bias, km))
    # the fully masked graph averages its normalised values
    k = layer_norm(xk, scale, bias)
    _close_scaled(got[-1].float(),
                  k[-1].float().mean(0, keepdim=True).expand(lq, d),
                  1e-5 if dtype == torch.float32 else 2.0 ** -6)


def _attention_bits(dev):
    """sha256 of kernels #3 and #4's outputs on inputs made with numpy from
    a seed: the eDOS cross and self shapes and the phDOS self shape."""
    import hashlib

    import numpy as np

    rng = np.random.RandomState(0)
    h = hashlib.sha256()
    for b, lq, lk in ((8, 201, 32), (16, 201, 201), (16, 51, 51)):
        q, k, go = (torch.from_numpy(rng.randn(b, n, 256).astype(np.float32)
                                     ).to(dev) for n in (lq, lk, lq))
        mask = np.arange(lk)[None] < rng.randint(1, lk + 1, (b, 1))
        mask[-1] = False
        bias = key_bias(torch.from_numpy(mask).to(dev))
        o, stats = fused_attention_fwd(q, k, k, bias, want_stats=True)
        grads = fused_attention_bwd(q, k, k, bias, o, go, stats)
        for t in (o, stats, *grads):
            h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


# the attention forward and backward kernels' outputs before the building
# blocks of csrc/attention_core.cuh gained the single-pass products
ATTENTION_BITS = (
    "0df82e1b2ee5b3a49805f17d32a8622582682310762cf04473ff4f2d780aba6d")


def test_attention_kernels_keep_their_bits(dev):
    """Additions to the shared header changed nothing in kernels #3 and #4:
    the same bits as before them, and the same on a second run."""
    assert _attention_bits(dev) == ATTENTION_BITS


def _small_models(task, dev, **kw):
    from dostransformer_tpu_torch.models.registry import build_model

    return build_model(task, layers=2, t_layers=1, hidden=32, device=dev,
                       generator=torch.Generator().manual_seed(4), **kw)


def _small_batch(task, n=3):
    from dostransformer_tpu_torch.data.graph import collate
    from dostransformer_tpu_torch.data.synthetic import (
        synthetic_edos_learnable,
        synthetic_phdos_learnable,
    )

    make = (synthetic_edos_learnable if task == "edos"
            else synthetic_phdos_learnable)
    return collate(make(n, seed=2), num_graphs=n + 1)


@pytest.mark.parametrize("task", ["edos", "phdos"])
def test_remat_through_the_kernels_gives_the_same_gradients(dev, task):
    """--remat on the card: each processor and transformer layer runs again
    in the backward through the same kernels, which repeat their bits, so
    every gradient equals the one without remat; the recomputation adds one
    fused_mp_edge launch a processor and one fused_attention a layer (and
    one batched_segment_sum a processor for phDOS)."""
    batch = _small_batch(task).to(dev)
    grads, launches = [], []
    for remat in (False, True):
        model = _small_models(task, dev, remat=remat)
        counters = (fused_mp_edge, fused_attention, batched_segment_sum)
        before = [k.launches for k in counters]
        dg, _, ds = model(batch)
        (dg.square().sum() + ds.sum()).backward()
        launches.append([k.launches - b for k, b in zip(counters, before)])
        grads.append([p.grad for p in model.parameters()])
    assert all(torch.equal(x, y) for x, y in zip(*grads))
    extra = [r - n for n, r in zip(*launches)]
    assert extra == [2, 3 * 1, 2 if task == "phdos" else 0]


def test_device_dataset_epoch_on_the_card_matches_the_cpu(dev):
    """One epoch of Trainer.train_epoch_device on the card and on the CPU
    from one seeded model, in the same order: the step losses within rtol
    1e-3 (the card-against-CPU limit of the train steps)."""
    from dostransformer_tpu_torch.data.synthetic import (
        synthetic_phdos_learnable,
    )
    from dostransformer_tpu_torch.train.device_dataset import DeviceDataset
    from dostransformer_tpu_torch.train.trainer import Trainer

    samples = synthetic_phdos_learnable(10, seed=3)
    losses = []
    for device in ("cpu", dev):
        data = DeviceDataset.from_samples(samples, 4, device=device)
        trainer = Trainer(_small_models("phdos", device),
                          clamp_targets=False, eval_clamp=False)
        losses.append(trainer.train_epoch_device(data, seed=1, epoch=0)
                      .cpu())
    assert losses[0].shape == (3,)
    torch.testing.assert_close(losses[1], losses[0], rtol=1e-3, atol=0)


BASELINES = [(task, name) for task in ("edos", "phdos")
             for name in ("graphnetwork", "graphnetwork2", "mlp", "mlp2")]


@pytest.mark.parametrize("task,name", BASELINES,
                         ids=[f"{t}-{n}" for t, n in BASELINES])
def test_baseline_on_the_card_matches_the_cpu(dev, task, name):
    """Each baseline family at hidden 48, one seeded model on the card and
    on the CPU: the forward within atol 1e-3 + rtol 1e-3 and one train
    step's loss within rtol 1e-3 and gradients within atol 1e-3 + rtol 1e-3
    (the card-against-CPU limits of the flagships); graphnetwork* launch one
    fused_mp_edge and one fused_mp_edge_bwd a processor (phDOS also one
    batched_segment_sum), mlp* no kernel."""
    import copy

    from dostransformer_tpu_torch.models.registry import (
        build_model,
        model_outputs,
    )
    from dostransformer_tpu_torch.train.trainer import Trainer

    batch = _small_batch(task)
    cpu_model = build_model(task, name, layers=2, hidden=48,
                            node_in=batch.nodes.shape[-1],
                            generator=torch.Generator().manual_seed(4))
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    with torch.no_grad():
        want = model_outputs(cpu_model(batch))[0]
        got = model_outputs(gpu_model(batch.to(dev)))[0]
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)
    clamp = task == "edos"
    counters = (fused_mp_edge, fused_mp_edge_bwd, batched_segment_sum,
                fused_attention)
    before = [k.launches for k in counters]
    lg = Trainer(gpu_model, clamp_targets=clamp).train_step(batch)["loss"]
    launches = [k.launches - b for k, b in zip(counters, before)]
    lc = Trainer(cpu_model, clamp_targets=clamp).train_step(batch)["loss"]
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-3, atol=0)
    for (pname, pc), pg in zip(cpu_model.named_parameters(),
                               gpu_model.parameters()):
        assert (pc.grad is None) == (pg.grad is None), pname
        if pc.grad is not None:
            torch.testing.assert_close(pg.grad.cpu(), pc.grad, rtol=1e-3,
                                       atol=1e-3, msg=pname)
    gnn = name.startswith("graphnetwork")
    assert launches == [2 * gnn, 2 * gnn, 2 * (gnn and task == "phdos"), 0]


# --- the bf16 forms of the forward kernels (#1, #3, #6) ----------------------
# #1, #3 and #6 compute in f32 from the same bf16 inputs as their plain
# versions (which agree to ~1e-6 before rounding) and round where they round
# (#3: the normalised softmax weights, then the output): at most one bf16 ulp
# apart, 2^-8 of the value; held to 2 ulps of the largest value.
BF16_REL = 2.0 ** -7


def _bf16_mp_args(dev, shape):
    args = _mp_args(dev, *shape)
    return [t.bfloat16() for t in args[:3]] + args[3:]


@pytest.mark.parametrize("shape", MP_SHAPES)
def test_fused_mp_edge_bf16_matches_plain(dev, shape):
    """e_out and agg bf16, agg summed from the unrounded e_out; both forms
    where the widths take the tensor-core form; bit-identical reruns."""
    args = _bf16_mp_args(dev, shape)
    before = fused_mp_edge.launches
    got = fused_mp_edge(*args)
    assert fused_mp_edge.launches == before + 1
    want = mp_edge_reference(*args)
    forms = [got]
    if fused_mp_form(shape[3], shape[4]) == FORM_TENSOR_CORE:
        forms.append(fused_mp_forward_kernel(*args, form=FORM_GENERIC))
    for out in forms:
        for x, w in zip(out, want):
            assert x.dtype == w.dtype == torch.bfloat16
            _close_scaled(x.float(), w.float(), BF16_REL)
    again = fused_mp_edge(*args)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])


@pytest.mark.parametrize("shape", [(8, 201, 32, 256), (16, 201, 201, 256),
                                   (8, 51, 16, 256), (16, 51, 51, 256),
                                   (1, 51, 8, 256), (3, 5, 70, 96),
                                   (2, 40, 33, 50), (2, 9, 7, 33),
                                   (2, 40, 33, 512), (2, 40, 33, 544),
                                   (2, 33, 40, 1024), (2, 9, 7, 1025)])
def test_fused_attention_bf16_matches_plain(dev, shape):
    """q, k and v bf16 at every width (the sliced kernels above 512), keys
    and values one tensor and two, masked and not; the f32 row statistics
    within 1e-5 of the plain scores'; bit-identical reruns."""
    b, lq, lk, d = shape
    g = torch.Generator().manual_seed(11)
    q, k, v = (torch.randn(b, n, d, generator=g).to(dev, torch.bfloat16)
               for n in (lq, lk, lk))
    km = (torch.rand(b, lk, generator=g) > 0.3).to(dev)
    km[-1] = False
    for mask in (km, None):
        for vv in (k, v):
            before = fused_attention.launches
            got = fused_attention(q, k, vv, mask)
            assert fused_attention.launches == before + 1
            want = dot_product_attention(q, k, vv, mask)
            assert got.dtype == want.dtype == torch.bfloat16
            _close_scaled(got.float(), want.float(), BF16_REL)
            assert torch.equal(fused_attention(q, k, vv, mask), got)
    bias = key_bias(km)
    _, stats = fused_attention_fwd(q, k, k, bias, want_stats=True)
    want = attention_stats_reference(q, k, bias)
    real = km.any(-1)
    assert stats.dtype == torch.float32
    torch.testing.assert_close(stats[:, real], want[:, real], **TOL)


@pytest.mark.parametrize("shape", [(8, 128, 1, 16), (8, 2048, 1, 64),
                                   (8, 2048, 256, 64), (3, 70, 5, 13),
                                   (2, 90, 300, 7), (1, 9, 1, 1)])
def test_batched_segment_sum_bf16_matches_plain(dev, shape):
    """bf16 in and out, f32 sums rounded once: counts exact, other data
    within BF16_REL; bit-identical reruns."""
    b, e, f, n = shape
    data, ids = _segment_args(dev, b, e, f, n)
    data = data.bfloat16()
    got = batched_segment_sum(data, ids, n)
    want = segment_sum_reference(data, ids, n)
    assert got.dtype == want.dtype == torch.bfloat16
    if f == 1:
        assert torch.equal(got, want)
    else:
        _close_scaled(got.float(), want.float(), BF16_REL)
    assert torch.equal(batched_segment_sum(data, ids, n), got)


def test_bf16_rejections(dev):
    """f64 and f16 go nowhere, forward and backward kernels alike; the bf16
    backward kernels take one operand dtype (bf16 operands with f32
    cotangents raise rather than widen silently)."""
    args = _mp_args(dev, 2, 5, 9, 32, 16)
    q = torch.randn(2, 4, 64, device=dev)
    bias = torch.zeros(2, 4, device=dev)
    data, ids = _segment_args(dev, 3, 70, 5, 13)
    cot = (torch.randn(2, 9, 16, device=dev), torch.randn(2, 5, 16, device=dev))
    for dtype in (torch.float64, torch.float16):
        with pytest.raises(TypeError):
            fused_mp_edge(*[t.to(dtype) for t in args[:3]], *args[3:])
        with pytest.raises(TypeError):
            fused_mp_edge_bwd(*[t.to(dtype) for t in args[:3]], *args[3:10],
                              *(c.to(dtype) for c in cot))
        with pytest.raises(TypeError):
            fused_attention(q.to(dtype), q.to(dtype), q.to(dtype))
        with pytest.raises(TypeError):
            x = q.to(dtype)
            fused_attention_bwd(x, x, x, bias, x, x)
        with pytest.raises(TypeError):
            batched_segment_sum(data.to(dtype), ids, 13)
    bf = [t.bfloat16() for t in args[:3]]
    with pytest.raises(TypeError):
        fused_mp_edge_bwd(*bf, *args[3:10], *cot)
    qb = q.bfloat16()
    with pytest.raises(TypeError):
        fused_attention_bwd(qb, qb, qb, bias, None, q)


def _bf16_bwd_args(dev, shape):
    """The backward's operands with bf16 projections and cotangents (a
    dummy graph last)."""
    b, a, e, m, h = shape
    args = _mp_args(dev, *shape)
    args[5][-1] = 0.0
    g = torch.Generator().manual_seed(5)
    cot = (torch.randn(b, e, h, generator=g), torch.randn(b, a, h, generator=g))
    return ([t.bfloat16() for t in args[:3]] + args[3:10]
            + [c.to(dev).bfloat16() for c in cot])


@pytest.mark.parametrize("shape", MP_SHAPES)
def test_fused_mp_edge_bwd_bf16_matches_plain(dev, shape):
    """bf16 projections and cotangents: all eight gradients f32, within the
    f32 limits of the plain version (both widen the same bf16 values), in
    the form the widths take and the generic form; one launch a call;
    bit-identical reruns."""
    args = _bf16_bwd_args(dev, shape)
    before = fused_mp_edge_bwd.launches
    got = fused_mp_edge_bwd(*args)
    assert fused_mp_edge_bwd.launches == before + 1
    want = mp_edge_bwd_reference(*args)
    forms = [got]
    if fused_mp_bwd_form(shape[3], shape[4]) == FORM_TENSOR_CORE:
        forms.append(fused_mp_edge_bwd(*args, form=FORM_GENERIC))
    for out in forms:
        for i, (x, w) in enumerate(zip(out, want)):
            assert x.dtype == w.dtype == torch.float32
            _close_scaled(x, w, 1e-5 if i < 3 else 1e-4)
    again = fused_mp_edge_bwd(*args)
    assert all(torch.equal(x, y) for x, y in zip(again, got))


@pytest.mark.parametrize("shape", [(8, 201, 32, 256), (16, 201, 201, 256),
                                   (8, 51, 16, 256), (16, 51, 51, 256),
                                   (1, 51, 8, 256), (3, 5, 70, 96),
                                   (2, 40, 33, 50), (2, 9, 7, 33),
                                   (2, 40, 33, 512), (2, 40, 33, 544),
                                   (2, 33, 40, 1024), (2, 9, 7, 1025)])
def test_fused_attention_bwd_bf16_matches_plain(dev, shape):
    """q, k, v and g bf16 at every width (the sliced kernels above 512):
    dq, dk, dv bf16 within BF16_REL of the plain backward, keys and values
    one tensor and two, masked and not (a fully masked graph last); the
    same bits without the forward's statistics and with two copies of the
    keys; bit-identical reruns; one launch a call."""
    b, lq, lk, d = shape
    g = torch.Generator().manual_seed(12)
    q, k, v, go = (torch.randn(b, n, d, generator=g).to(dev, torch.bfloat16)
                   for n in (lq, lk, lk, lq))
    km = (torch.rand(b, lk, generator=g) > 0.3)
    km[-1] = False
    for bias in (key_bias(km.to(dev)), torch.zeros(b, lk, device=dev)):
        for vv in (k, v):
            o, stats = fused_attention_fwd(q, k, vv, bias, want_stats=True)
            before = fused_attention_bwd.launches
            got = fused_attention_bwd(q, k, vv, bias, o, go, stats)
            assert fused_attention_bwd.launches == before + 1
            want = attention_bwd_reference(q, k, vv, bias, go)
            for x, w in zip(got, want):
                assert x.dtype == w.dtype == torch.bfloat16
                _close_scaled(x.float(), w.float(), BF16_REL)
            for other in (fused_attention_bwd(q, k, vv, bias, o, go),
                          fused_attention_bwd(q, k, vv.clone(), bias, None,
                                              go, stats),
                          fused_attention_bwd(q, k, vv, bias, o, go, stats)):
                assert all(torch.equal(x, y) for x, y in zip(other, got))


@pytest.mark.parametrize("levers", [False, True])
@pytest.mark.parametrize("task", ["edos", "phdos"])
def test_bf16_train_step_on_the_card(dev, task, levers):
    """A small bf16 model's Trainer.train_step on the card: the bf16 forms
    forward and backward (exact launches: 2 #2 and 3 #4 at 2 processors and
    1 layer a stack; with the levers 3 #5 and 11 #7), every gradient f32,
    finite and within 3 times the CPU bf16 model's own distance from its
    f32 model (relative RMS over all parameters), the loss too."""
    from dostransformer_tpu_torch.data import synthetic
    from dostransformer_tpu_torch.data.graph import collate
    from dostransformer_tpu_torch.models.registry import build_model
    from dostransformer_tpu_torch.train.trainer import Trainer

    make = (synthetic.synthetic_edos_learnable if task == "edos"
            else synthetic.synthetic_phdos_learnable)
    batch = collate(make(5, seed=2), num_graphs=8)
    kw = dict(hidden=64, layers=2, t_layers=1, fuse_ln_attn=levers,
              ln_lp=levers)
    cpu = build_model(task, dtype="bfloat16",
                      generator=torch.Generator().manual_seed(3), **kw)
    cpu32 = build_model(task, **kw)
    cpu32.load_state_dict(cpu.state_dict())
    card = build_model(task, dtype="bfloat16", device=dev, **kw)
    card.load_state_dict(cpu.state_dict())
    counters = (fused_mp_edge, fused_mp_edge_bwd, fused_attention,
                fused_attention_bwd, fused_attention_ln, layer_norm_bwd)
    before = [c.launches for c in counters]
    clamp = task == "edos"
    loss = Trainer(card, clamp_targets=clamp).train_step(batch)["loss"]
    launches = [c.launches - n for c, n in zip(counters, before)]
    assert launches == ([2, 2, 0, 3, 3, 11] if levers else [2, 2, 3, 3, 0, 0])
    losses = [Trainer(m, clamp_targets=clamp).train_step(batch)["loss"].item()
              for m in (cpu, cpu32)]
    grads = [torch.cat([p.grad.float().cpu().flatten()
                        for p in m.parameters()]) for m in (card, cpu, cpu32)]
    assert all(p.grad.dtype == torch.float32 for p in card.parameters())
    assert bool(torch.isfinite(grads[0]).all())
    own = float((grads[1] - grads[2]).norm() / grads[2].norm())
    got = float((grads[0] - grads[1]).norm() / grads[1].norm())
    assert got <= 3 * own, (got, own)
    rel = abs(loss.item() - losses[0]) / abs(losses[0])
    assert rel <= 3 * max(own, abs(losses[0] - losses[1]) / abs(losses[1]))


@pytest.mark.parametrize("task", ["edos", "phdos"])
def test_bf16_remat_train_step_on_the_card(dev, task):
    """remat=True in bf16: torch.utils.checkpoint replays the bf16 forward
    kernels in the backward (the forward's launches twice a step), and the
    step's loss and gradients are those of the step without remat, bit for
    bit (the kernels repeat their bits)."""
    from dostransformer_tpu_torch.data import synthetic
    from dostransformer_tpu_torch.data.graph import collate
    from dostransformer_tpu_torch.models.registry import build_model
    from dostransformer_tpu_torch.train.trainer import Trainer

    make = (synthetic.synthetic_edos_learnable if task == "edos"
            else synthetic.synthetic_phdos_learnable)
    batch = collate(make(5, seed=2), num_graphs=8).to(dev)
    models = [build_model(task, hidden=64, layers=2, t_layers=1,
                          dtype="bfloat16", device=dev, remat=remat,
                          generator=torch.Generator().manual_seed(3))
              for remat in (False, True)]
    counters = (fused_mp_edge, batched_segment_sum, fused_attention,
                fused_mp_edge_bwd, fused_attention_bwd)
    losses, launches = [], []
    for model in models:
        before = [c.launches for c in counters]
        losses.append(Trainer(model, clamp_targets=task == "edos")
                      .train_step(batch)["loss"])
        launches.append([c.launches - n for c, n in zip(counters, before)])
    seg = 2 if task == "phdos" else 0
    assert launches == [[2, seg, 3, 2, 3], [4, 2 * seg, 6, 2, 3]]
    assert torch.equal(losses[0], losses[1])
    for (name, p), q in zip(models[0].named_parameters(),
                            models[1].parameters()):
        assert torch.equal(p.grad, q.grad) and torch.equal(p, q), name


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("task", ["edos", "phdos"])
def test_bf16_model_on_the_card_matches_the_cpu(dev, task, fuse):
    """A small bf16 model, card against the same weights on the CPU: f32
    outputs within 0.03 relative RMS (the card rounds the attention's
    weights elsewhere), through the bf16 forms of the kernels."""
    from dostransformer_tpu_torch.data.graph import collate
    from dostransformer_tpu_torch.data import synthetic
    from dostransformer_tpu_torch.models.registry import build_model

    make = (synthetic.synthetic_edos_samples if task == "edos"
            else synthetic.synthetic_phdos_samples)
    batch = collate(make(5, seed=2), num_graphs=8)
    cpu = build_model(task, hidden=64, layers=2, t_layers=1, dtype="bfloat16",
                      fuse_ln_attn=fuse,
                      generator=torch.Generator().manual_seed(3))
    card = build_model(task, hidden=64, layers=2, t_layers=1,
                       dtype="bfloat16", fuse_ln_attn=fuse, device=dev)
    card.load_state_dict(cpu.state_dict())
    before = (fused_mp_edge.launches, batched_segment_sum.launches)
    with torch.inference_mode():
        want = cpu(batch)
        got = card(batch.to(dev))
    assert fused_mp_edge.launches == before[0] + 2
    assert batched_segment_sum.launches == before[1] + (2 if task == "phdos"
                                                        else 0)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        g = g.cpu()
        assert (g - w).norm() <= 0.03 * w.norm(), float((g - w).norm()
                                                        / w.norm())


# --- serving through CUDA graphs (serve_dispatch.py) ------------------------


def _graph_predictors(task, dev, batch_size=4):
    """A graph-served and an eager Predictor of one small model."""
    from dostransformer_tpu_torch.serve import Predictor

    model = _small_models(task, dev)
    clamp = task == "edos"
    return (Predictor(model, batch_size=batch_size, clamp=clamp),
            Predictor(model, batch_size=batch_size, clamp=clamp, graphs=False))


def _requests(task):
    from dostransformer_tpu_torch.data import synthetic

    make = (synthetic.synthetic_edos_samples if task == "edos"
            else synthetic.synthetic_phdos_samples)
    small = make(6, seed=5, max_atoms=6)
    large = make(3, seed=6, min_atoms=17, max_atoms=20)
    return {"mixed": [s for pair in zip(small, large) for s in pair]
            + small[3:], "short": make(3, seed=7), "full": make(8, seed=8)}


@pytest.mark.parametrize("task", ["edos", "phdos"])
def test_graph_served_predictions_equal_eager_bit_for_bit(dev, task):
    """One CUDA graph per geometry gives the eager forward's bits (the same
    kernels and products on the same inputs); a second request of captured
    geometries captures no graph."""
    graph, eager = _graph_predictors(task, dev)
    for name, samples in _requests(task).items():
        got = graph.predict(samples)
        assert np.array_equal(got, eager.predict(samples)), name
    captured = graph.graph_count
    assert captured >= 3  # the mixed request's two buckets, and more
    for samples in _requests(task).values():
        graph.predict(samples)
    assert graph.graph_count == captured


def test_graph_ring_is_not_overwritten_by_back_to_back_requests(dev):
    """Requests of one geometry whose batches differ, sent back to back
    (more batches than ring slots, so slots are refilled while the card
    still runs): each gets its own rows, as the eager forward gives them."""
    from dostransformer_tpu_torch.data import synthetic

    graph, eager = _graph_predictors("edos", dev, batch_size=2)
    # 13-16 nodes (the prompt node too) and 144-180 edges: one geometry
    requests = [synthetic.synthetic_edos_samples(7, seed=s, min_atoms=12,
                                                 max_atoms=15)
                for s in range(10, 14)]
    got = [graph.predict(r) for r in requests]
    assert graph.graph_count == 1
    for r, g in zip(requests, got):
        assert np.array_equal(g, eager.predict(r))
    assert not np.array_equal(got[0], got[1])


def test_failing_capture_raises_without_falling_back(dev):
    """A forward that synchronises (legal eagerly) cannot be captured: the
    Predictor raises and never serves the eager result instead."""
    from dostransformer_tpu_torch.data import synthetic
    from dostransformer_tpu_torch.serve import Predictor

    class Syncing(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(3, device=dev))

        def forward(self, g):
            float(g.nodes.sum())  # a copy to the host: no capture allows it
            return g.nodes.sum((1, 2))[:, None] * self.w

    samples = synthetic.synthetic_edos_samples(3, seed=0)
    want = Predictor(Syncing(), graphs=False).predict(samples)
    assert want.shape == (3, 3)
    with pytest.raises(RuntimeError, match="CUDA graph capture"):
        Predictor(Syncing()).predict(samples)
    torch.cuda.synchronize()
