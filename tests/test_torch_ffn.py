"""The transformer FFN's op (dostransformer_tpu_torch/ops/ffn.py) on the
CPU: its plain version is the layer's composition before kernel #8 bit for
bit, ``ffn_plan`` sends only f32 calls of supported widths and enough rows
to #8's path, every other path of the layer computes as before, the CPU
model's outputs and gradients keep their bits, and the FFN counters add up.
The kernel itself runs only on the card (tests/test_torch_cuda.py)."""

import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from dostransformer_tpu_torch import tracing  # noqa: E402
from dostransformer_tpu_torch.nn import transformer  # noqa: E402
from dostransformer_tpu_torch.nn.dropout import apply_keep  # noqa: E402
from dostransformer_tpu_torch.ops import attention as attention_ops  # noqa: E402
from dostransformer_tpu_torch.ops import ffn as ffn_ops  # noqa: E402


def _params(d, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    layer = transformer.TransformerEncoderLayer(d)
    for p in layer.parameters():  # nonzero biases, so that both are used
        with torch.no_grad():
            p.copy_(torch.randn(p.shape, generator=g) * p.shape[-1] ** -0.5)
    return layer.to(dtype)


def _old_ffn(layer, y, keep=None):
    """The layer's FFN as it was before #8."""
    h = F.relu(layer.fc1(y))
    return layer.fc2(apply_keep(h, keep, layer.relu_dropout))


def _grads(fn, leaves):
    leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
    out = fn(*leaves)
    out.backward(torch.ones_like(out).cumsum(-1) / out.shape[-1])
    return [out.detach()] + [t.grad for t in leaves]


# the cell's width, hidden 1,024, phDOS's hidden 50, and the cell's rows a
# crystal at a small width
@pytest.mark.parametrize("shape", [(2, 7, 256), (1, 3, 1024), (3, 5, 50),
                                   (4, 201, 32)])
def test_plain_version_is_todays_composition_bit_for_bit(shape):
    d = shape[-1]
    layer = _params(d)
    y = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    leaves = [y, layer.fc1.weight, layer.fc1.bias, layer.fc2.weight,
              layer.fc2.bias]

    def old(y, w1, b1, w2, b2):
        return transformer.linear(F.relu(transformer.linear(y, w1, b1)), w2,
                                  b2)

    want = _grads(old, leaves)
    for fn in (ffn_ops.ffn_reference, ffn_ops.ffn):
        got = _grads(fn, leaves)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    # the op's CPU kernel (an artifact exported on the card, run on the CPU)
    out, h = torch.ops.dostpu.ffn_fwd(y.reshape(-1, d), *leaves[1:])
    assert torch.equal(out.reshape(shape), want[0])
    assert torch.equal(h, F.relu(transformer.linear(y.reshape(-1, d),
                                                    *leaves[1:3])))


@pytest.mark.parametrize("rows,d,dtype,want", [
    (12864, 256, torch.float32, True),    # the cell's cross stack
    (25728, 256, torch.float32, True),    # the heads' 2B pass
    (12864, 1024, torch.float32, True),   # hidden 1,024
    (ffn_ops.MIN_ROWS, 256, torch.float32, True),
    (ffn_ops.MIN_ROWS - 1, 256, torch.float32, False),
    (408, 256, torch.float32, False),     # phDOS at batch 8
    (12864, 256, torch.bfloat16, False),  # bf16: ROADMAP item 4
    (12864, 256, torch.float64, False),   # f64: the plain functions
    (12864, 50, torch.float32, False),    # phDOS's hidden 50
    (12864, 48, torch.float32, False),    # no multiple of 32
])
def test_ffn_plan(rows, d, dtype, want):
    assert ffn_ops.ffn_plan(rows, d, dtype) is want


def _refuse(*args):
    raise AssertionError("the FFN took #8's path")


@pytest.mark.parametrize("case", ["bf16", "f64", "relu_dropout", "tp",
                                  "width_48", "few_rows"])
def test_layer_keeps_todays_path_where_the_plan_or_the_layer_says(
        case, monkeypatch):
    """bf16, f64, a ReLU dropout mask, the tensor-parallel branch, a width
    the kernel does not take and few rows never take #8's path (its plain
    version on the CPU), and give the composition's bits."""
    monkeypatch.setattr(ffn_ops, "ffn_reference", _refuse)
    monkeypatch.setattr(ffn_ops, "ffn_fwd_kernel", _refuse)
    d = 48 if case == "width_48" else 32
    dtype = {"bf16": torch.bfloat16, "f64": torch.float64}.get(
        case, torch.float32)
    layer = _params(d, dtype=dtype)
    if case == "relu_dropout":
        layer.relu_dropout = 0.5
    rows = 4 if case == "few_rows" else -(-ffn_ops.MIN_ROWS // 64)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(rows, 64, d, generator=g).to(dtype)
    masks = transformer.LayerMasks()
    if case == "relu_dropout":
        masks = transformer.LayerMasks(
            relu=torch.rand(rows, 64, 4 * d, generator=g) > 0.5)
    if case == "tp":  # the branch of a sharded layer, on one process
        monkeypatch.setattr(transformer, "tp_enter", lambda t, grp: t)
        monkeypatch.setattr(transformer, "tp_exit", lambda t, grp: t)
        layer.tp_group = "one rank"
    got = layer(x, x, x, None, masks)
    ln0, ln1 = layer.layer_norms
    k = ln0(x)
    attend = (attention_ops.dot_product_attention if case == "f64"
              else attention_ops.fused_attention)
    x1 = x + attend(ln0(x), k, k, None)
    want = x1 + _old_ffn(layer, ln1(x1), masks.relu)
    if case == "tp":  # the bias after the product, as the branch adds it
        h = F.relu(layer.fc1(ln1(x1)))
        want = x1 + (transformer.linear(h, layer.fc2.weight, None)
                     + layer.fc2.bias)
    assert torch.equal(got, want)


def test_layer_takes_the_op_where_the_plan_says(monkeypatch):
    calls = []

    def spy(*args):
        calls.append(args[0].shape)
        return ffn_ops.ffn(*args)

    monkeypatch.setattr(transformer, "ffn", spy)
    layer = _params(32)
    x = torch.randn(-(-ffn_ops.MIN_ROWS // 64), 64, 32)
    layer(x, x, x)
    assert calls == [x.shape]


def _edos_model(ffn_on: bool, monkeypatch):
    from dostransformer_tpu_torch.models.registry import build_model

    if not ffn_on:
        monkeypatch.setattr(ffn_ops, "ffn_plan", lambda *a: False)
    return build_model("edos", layers=1, t_layers=1, hidden=32,
                       generator=torch.Generator().manual_seed(3))


def _edos_batch(n):
    from dostransformer_tpu_torch.data.graph import collate
    from dostransformer_tpu_torch.data.synthetic import synthetic_edos_samples

    return collate(synthetic_edos_samples(n, seed=4), num_graphs=n)


def test_cpu_model_outputs_and_gradients_keep_their_bits(monkeypatch):
    """The eDOS model at 16 crystals (3,216 and 6,432 FFN rows, over the
    plan's threshold) through the op's path and through the old path: the
    same outputs and gradients, bit for bit."""
    batch = _edos_batch(16)
    runs = []
    for on in (True, False):
        with monkeypatch.context() as mp:
            model = _edos_model(on, mp)
            outs = model(batch)
            (outs[0].square().sum() + outs[2].sum()).backward()
            runs.append([o.detach() for o in outs]
                        + [p.grad for p in model.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_ffn_counters_add_up(monkeypatch):
    """ffn.rows counts the rows of every call of the op: a forward of the
    eDOS model runs the cross stack over B x bins rows and the self and
    source stacks over 2B x bins, t_layers each, so 5 t_layers bins B in
    all; ffn.kernel_rows counts the rows that took #8, none on the CPU."""
    batch = _edos_batch(3)
    model = _edos_model(True, monkeypatch)
    counters = tracing.record().counters
    before = (counters.get("ffn.rows", 0), counters.get("ffn.kernel_rows", 0))
    with torch.no_grad():
        model(batch)
    bins = 201
    assert counters["ffn.rows"] - before[0] == 5 * 1 * bins * 3
    assert counters.get("ffn.kernel_rows", 0) - before[1] == 0
