"""The port's multi-head transformer layer and the layer's other JAX options
(its dropouts) against the JAX package on the CPU: the cases of
tests/test_multihead.py against the JAX layer at h = 1, 2, 4, 8, from the
same weights (state_dict_from_jax, which carries them into every setting:
heads and dropout add no parameter).

Small sizes: hidden 32 (and 256 with 8 heads), 1-2 layers. The JAX stack
runs its plain path (use_pallas=False) unless a case says otherwise.
Tolerances: outputs rtol = atol = 1e-5 (the attention tolerance of
tests/test_torch_ops.py); gradients 1e-5 x max(1, max|gradient|) of each
tensor (a key gradient sums over every query and layer: at 8 heads of 4
columns its largest elements reach ~650, and both sides sit ~1e-4 from an
f64 run there); the port against itself bit-equal."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from dostransformer_tpu.nn import transformer as jtransformer  # noqa: E402
from dostransformer_tpu_torch.models.import_torch import (  # noqa: E402
    state_dict_from_jax,
)
from dostransformer_tpu_torch.nn import dropout as tdropout  # noqa: E402
from dostransformer_tpu_torch.nn import transformer  # noqa: E402
from dostransformer_tpu_torch.nn.transformer import (  # noqa: E402
    LayerMasks,
    TransformerEncoder,
    TransformerEncoderLayer,
    merge_heads,
    split_heads,
)
from dostransformer_tpu_torch.ops.attention import dot_product_attention  # noqa: E402

H = 32
TOL = dict(rtol=1e-5, atol=1e-5)
HEADS = [1, 2, 4, 8]


def _inputs(seed, b=3, lq=11, lk=6, d=H, masked=True):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, lq, d).astype(np.float32)
    kv = rng.randn(b, lk, d).astype(np.float32)
    km = rng.rand(b, lk) > 0.3
    km[:, 0] = True
    km[-1] = False  # a dummy graph: no key attended, zero key rows (as
    kv[-1] = 0.0    # the model makes them)
    return x, kv, km if masked else None


def _jax_stack(h, args, d=H, layers=2, use_pallas=False, **kw):
    jm = jtransformer.TransformerEncoder(embed_dim=d, num_heads=h,
                                         layers=layers, use_pallas=use_pallas,
                                         **kw)
    params = jm.init(jax.random.PRNGKey(1), *args)
    return jm, params


def _port_stack(h, params, d=H, layers=2, **kw):
    tm = TransformerEncoder(d, layers=layers, num_heads=h, **kw)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    return tm


def _j(t):
    return None if t is None else jnp.asarray(t)


def _grad_close(got, want, name=""):
    want = np.asarray(want)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= 1e-5 * max(1.0, float(np.abs(want).max())), (name, err)


def _t(t):
    return None if t is None else torch.from_numpy(t)


@pytest.mark.parametrize("h", HEADS)
@pytest.mark.parametrize("case", ["cross", "self_shared", "unmasked"])
def test_stack_matches_the_jax_layer(h, case):
    """The stack of 2 layers at h heads: cross-attention with masked keys
    (a graph with none), self-attention on one tensor, and cross-attention
    without a mask; outputs and the gradients of sum(out * g) in every
    input and parameter (see the module docstring)."""
    x, kv, km = _inputs(h, masked=case != "unmasked")
    args = ((x,) if case == "self_shared"
            else (x, kv, kv, km))
    jm, params = _jax_stack(h, tuple(_j(a) for a in args))
    g = np.random.RandomState(9).randn(*x.shape).astype(np.float32)

    def jloss(p, *a):
        out = jm.apply(p, *a)
        return (out * g).sum(), out

    (_, want), (jgp, *jga) = jax.value_and_grad(
        jloss, argnums=tuple(range(1 + (1 if case == "self_shared" else 3))),
        has_aux=True)(params, *(_j(a) for a in args[:3]),
                      *([] if case == "self_shared" else [_j(km)]))
    tm = _port_stack(h, params)
    targs = [torch.tensor(a, requires_grad=True) for a in args[:1]]
    if case != "self_shared":
        k = torch.tensor(kv, requires_grad=True)
        targs += [k, k, _t(km)]
    got = tm(*targs)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    (got * torch.from_numpy(g)).sum().backward()
    _grad_close(targs[0].grad, jga[0], "x")
    if case != "self_shared":  # one tensor as keys and values
        _grad_close(targs[1].grad, jga[1] + jga[2], "kv")
    want_grads = state_dict_from_jax(jgp)
    for name, p in tm.named_parameters():
        _grad_close(p.grad, want_grads[name], name)


def test_hidden_256_with_8_heads():
    """The flagship width with 8 heads of 32: outputs within 1e-5."""
    x, kv, km = _inputs(3, b=2, lq=21, lk=9, d=256)
    args = tuple(_j(a) for a in (x, kv, kv, km))
    jm, params = _jax_stack(8, args, d=256, layers=1)
    want = jm.apply(params, *args)
    tm = _port_stack(8, params, d=256, layers=1)
    got = tm(_t(x), _t(kv), _t(kv), _t(km))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_one_head_is_todays_layer_bit_for_bit():
    """num_heads=1 (and zero dropout rates) is the layer without them, bit
    for bit; the weights load unchanged into every setting."""
    x, kv, km = _inputs(0)
    args = tuple(_j(a) for a in (x, kv, kv, km))
    _, params = _jax_stack(1, args)
    base = _port_stack(1, params)
    plain = TransformerEncoder(H, layers=2)
    plain.load_state_dict(base.state_dict(), strict=True)
    targs = (_t(x), _t(kv), _t(kv), _t(km))
    assert torch.equal(base(*targs), plain(*targs))
    for h in HEADS:  # every setting takes the same state_dict
        TransformerEncoder(H, layers=2, num_heads=h, attn_dropout=0.1,
                           relu_dropout=0.1, res_dropout=0.1,
                           embed_dropout=0.1).load_state_dict(
            state_dict_from_jax(params), strict=True)


def test_heads_change_the_math():
    """4 heads give other outputs than 1 on the same weights (the JAX
    test's check), finite."""
    x, kv, km = _inputs(1)
    _, params = _jax_stack(1, tuple(_j(a) for a in (x, kv, kv, km)))
    targs = (_t(x), _t(kv), _t(kv), _t(km))
    one, four = (_port_stack(h, params)(*targs) for h in (1, 4))
    assert torch.isfinite(four).all()
    assert not torch.allclose(one, four)


@pytest.mark.parametrize("h", [2, 4, 8])
def test_head_split_equals_the_blockwise_computation(h):
    """h-head attention is the attention of each D/h column block run on
    its own, concatenated; merge_heads inverts split_heads."""
    rng = np.random.RandomState(2)
    b, n, d = 2, 5, 32
    q, k, v = (torch.from_numpy(rng.randn(b, n, d).astype(np.float32))
               for _ in range(3))
    w = d // h
    want = torch.cat([dot_product_attention(q[..., i * w:(i + 1) * w],
                                            k[..., i * w:(i + 1) * w],
                                            v[..., i * w:(i + 1) * w])
                      for i in range(h)], -1)
    got = merge_heads(dot_product_attention(split_heads(q, h),
                                            split_heads(k, h),
                                            split_heads(v, h)), h)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert torch.equal(merge_heads(split_heads(q, h), h), q)


@pytest.mark.parametrize("h", [1, 4])
def test_fused_ln_rule_follows_the_jax_layer(h, monkeypatch):
    """fuse_ln_attn takes the LN-fused attention only with one head and no
    attention dropout in the call, as the JAX layer does under
    DOSTPU_FUSE_LN_ATTN=1 (use_pallas=True: its kernels in interpret
    mode): the port's outputs equal JAX's choice within 1e-5, and the fused
    op runs exactly where JAX runs its fused kernel."""
    monkeypatch.setenv("DOSTPU_FUSE_LN_ATTN", "1")
    x, kv, km = _inputs(4)
    args = tuple(_j(a) for a in (x, kv, kv, km))
    jm, params = _jax_stack(h, args, use_pallas=True, attn_dropout=0.5)
    want = jm.apply(params, *args)
    calls = []
    original = transformer.fused_attention_ln
    monkeypatch.setattr(transformer, "fused_attention_ln",
                        lambda *a: calls.append(1) or original(*a))
    tm = _port_stack(h, params, fuse_ln_attn=True, attn_dropout=0.5)
    got = tm.eval()(_t(x), _t(kv), _t(kv), _t(km))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    assert len(calls) == (2 if h == 1 else 0)
    # training with attention dropout: never fused
    calls.clear()
    tm.train()(_t(x), _t(kv), _t(kv), _t(km),
               generator=torch.Generator().manual_seed(0))
    assert calls == []


@pytest.mark.parametrize("h", [1, 4])
def test_layer_dropouts_where_jax_puts_them(h):
    """Training with every dropout of the layer (attention, res_drop0,
    relu_drop, res_drop1; embed_drop on the stack's inputs): the masks come
    from the generator, so one seed repeats bit for bit and another seed
    differs; remat draws the same masks (same outputs and gradients, bit
    for bit); eval is the deterministic forward; in cross-attention the keys
    and values get two embed_drop draws. With the attention and ReLU
    rates 1 and no residual dropout a layer adds only fc2's bias to x."""
    x, kv, km = _inputs(5)
    _, params = _jax_stack(h, tuple(_j(a) for a in (x, kv, kv, km)))
    rates = dict(attn_dropout=0.2, relu_dropout=0.1, res_dropout=0.1,
                 embed_dropout=0.1)
    outs = []
    for remat, seed in ((False, 0), (False, 0), (True, 0), (False, 1)):
        tm = _port_stack(h, params, remat=remat, **rates).train()
        xi = torch.tensor(x, requires_grad=True)
        out = tm(xi, _t(kv), _t(kv), _t(km),
                 generator=torch.Generator().manual_seed(seed))
        out.square().sum().backward()
        outs.append((out.detach(), xi.grad,
                     [p.grad for p in tm.parameters()]))
    for a, b in zip(outs[0], outs[1]):
        assert all(torch.equal(u, v) for u, v in zip(
            a if isinstance(a, list) else [a], b if isinstance(b, list)
            else [b]))
    for a, b in zip(outs[0], outs[2]):
        assert all(torch.equal(u, v) for u, v in zip(
            a if isinstance(a, list) else [a], b if isinstance(b, list)
            else [b]))
    assert not torch.equal(outs[0][0], outs[3][0])
    tm = _port_stack(h, params, **rates).eval()
    det = _port_stack(h, params)
    targs = (_t(x), _t(kv), _t(kv), _t(km))
    assert torch.equal(tm(*targs, generator=torch.Generator()),
                       det(*targs))
    layer = TransformerEncoderLayer(H, num_heads=h, attn_dropout=1.0,
                                    relu_dropout=1.0).train()
    with torch.no_grad():
        layer.fc2.bias.copy_(torch.randn(
            H, generator=torch.Generator().manual_seed(5)))
    masks = layer.draw_masks(targs[0], targs[1],
                             torch.Generator().manual_seed(0))
    assert torch.equal(layer(*targs, masks=masks),
                       targs[0] + layer.fc2.bias)
    drawn = []
    original = transformer.dropout

    def recording(t, rate, generator):
        drawn.append((t, original(t, rate, generator)))
        return drawn[-1][1]

    transformer.dropout = recording
    k = _t(kv)
    try:
        _port_stack(h, params, embed_dropout=0.1).train()(
            _t(x), k, k, _t(km), generator=torch.Generator().manual_seed(0))
    finally:
        transformer.dropout = original
    # x, then k and v: one tensor in, two draws out
    assert len(drawn) == 3 and drawn[1][0] is drawn[2][0] is k
    assert not torch.equal(drawn[1][1], drawn[2][1])


def _perturbed(params, seed):
    """The JAX parameters moved off their init (nonzero biases, LayerNorm
    scales off 1), so that a mask applied before or after a bias shows."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: p + jnp.asarray(0.1 * rng.randn(*p.shape), p.dtype),
        params)


def _recorded_bernoulli(monkeypatch, fn):
    """fn() with every jax.random.bernoulli draw kept, in order: the masks
    of the JAX layer's flax Dropouts and of its attention dropout."""
    drawn, original = [], jax.random.bernoulli

    def recording(*a, **kw):
        out = original(*a, **kw)
        drawn.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax.random, "bernoulli", recording)
    try:
        return fn(), drawn
    finally:
        monkeypatch.setattr(jax.random, "bernoulli", original)


@pytest.mark.parametrize("unit", ["layer", "stack"])
@pytest.mark.parametrize("h", [1, 4])
def test_training_dropouts_match_jax_given_its_masks(unit, h, monkeypatch):
    """Training mode with every dropout rate > 0, against the JAX layer
    and stack (deterministic=False) on their own masks: the layer gets
    JAX's attention, res_drop0, relu_drop and res_drop1 masks through
    LayerMasks; the stack draws them (embed_drop, embed_drop_k,
    embed_drop_v, then each layer's) from a stand-in for draw_keep that
    hands out JAX's masks in JAX's order, each of the shape asked for.
    Outputs within 1e-5 and the gradients of sum(out * g) in x, the keys,
    the values and every parameter (see the module docstring); keys and
    values are two tensors, as under embed dropout."""
    x, kv, km = _inputs(6 + h)
    rates = dict(attn_dropout=0.25, relu_dropout=0.15, res_dropout=0.1)
    if unit == "stack":
        rates["embed_dropout"] = 0.2
    jargs = tuple(_j(a) for a in (x, kv, kv, km))
    jm, params = _jax_stack(h, jargs, **rates)
    params = _perturbed(params, 11)
    key = {"dropout": jax.random.PRNGKey(3)}
    if unit == "layer":
        jm = jtransformer.TransformerEncoderLayer(
            embed_dim=H, num_heads=h, use_pallas=False, **rates)
        jparams = {"params": params["params"]["layer0"]}
    else:
        jparams = params
    g = np.random.RandomState(9).randn(*x.shape).astype(np.float32)

    def japply(p, *a):
        return jm.apply(p, *a, jargs[3], deterministic=False, rngs=key)

    want, drawn = _recorded_bernoulli(
        monkeypatch, lambda: japply(jparams, *jargs[:3]))
    assert len(drawn) == (4 if unit == "layer" else 3 + 2 * 4)
    jgrads = jax.grad(lambda p, *a: (japply(p, *a) * g).sum(),
                      argnums=(0, 1, 2, 3))(jparams, *jargs[:3])

    tm = _port_stack(h, params, **rates).train()
    xt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (x, kv, kv))
    masks = [torch.from_numpy(m) for m in drawn]
    if unit == "layer":
        port = tm.layers[0]
        own = port.draw_masks(xt, kt, torch.Generator())
        assert [tuple(m.shape) for m in own] == [m.shape for m in drawn]
        got = port(xt, kt, vt, _t(km), LayerMasks(*masks))
    else:
        port = tm

        def replay(shape, rate, generator, device):
            mask = masks.pop(0)
            assert tuple(mask.shape) == tuple(shape)
            return mask

        monkeypatch.setattr(transformer, "draw_keep", replay)
        monkeypatch.setattr(tdropout, "draw_keep", replay)
        got = port(xt, kt, vt, _t(km), generator=torch.Generator())
        assert masks == []
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    (got * torch.from_numpy(g)).sum().backward()
    for name, t, want_grad in zip("xkv", (xt, kt, vt), jgrads[1:]):
        _grad_close(t.grad, want_grad, name)
    jgp = jgrads[0] if unit == "stack" else {
        "params": {**params["params"], "layer0": jgrads[0]["params"]}}
    want_grads = state_dict_from_jax(jgp)
    prefix = "layers.0." if unit == "layer" else ""
    for name, p in port.named_parameters():
        _grad_close(p.grad, want_grads[prefix + name], name)


def test_layer_api_rejects_a_width_the_heads_do_not_split():
    with pytest.raises(ValueError, match="num_heads"):
        TransformerEncoderLayer(30, num_heads=4)
