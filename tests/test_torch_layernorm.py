"""The PyTorch port's LayerNorm levers against the JAX package, on the CPU:
``layer_norm_lp`` (the low-precision-residual LayerNorm and its single-pass
backward), ``fused_attention_ln`` (the shared LayerNorm fused into the
attention), the transformer stack and the two flagships with both switches
on. Inputs come from numpy with a seed. The JAX side runs its Pallas kernels
in interpret mode under its three lever names; the port runs the kernels'
plain versions (CPU tensors).

Tolerances, each stated where it is used: 1e-6 for the f32 LayerNorm forward
(the same operations in the same order), one bf16 ulp for the bf16 forward,
2e-5 for f32 LayerNorm gradients and 3% of the largest element for bf16 (the
JAX package's own bounds, tests/test_layernorm_lp.py), 2e-5 forward and 3e-4
gradients for the LN-fused attention (tests/test_multihead.py), and the
whole-model bounds of tests/test_torch_train.py and tests/test_torch_phdos.py.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from dostransformer_tpu.data import collate as jcollate  # noqa: E402
from dostransformer_tpu.data import synthetic as jsyn  # noqa: E402
from dostransformer_tpu.models import DOSTransformerEDOS as JEDOS  # noqa: E402
from dostransformer_tpu.models import DOSTransformerPhDOS as JPhDOS  # noqa: E402
from dostransformer_tpu.nn.layernorm import _ln_bwd_jnp  # noqa: E402
from dostransformer_tpu.nn.layernorm import layer_norm_lp as j_layer_norm_lp  # noqa: E402
from dostransformer_tpu.nn.transformer import TransformerEncoder as JEncoder  # noqa: E402
from dostransformer_tpu.ops.attention import fused_attention_ln as j_fused_attention_ln  # noqa: E402
from dostransformer_tpu.train import loss as jloss  # noqa: E402
from dostransformer_tpu.train.trainer import Trainer as JTrainer  # noqa: E402
from dostransformer_tpu.train.trainer import TrainState  # noqa: E402
from dostransformer_tpu_torch.cli import common, main_edos, main_phdos, main_predict  # noqa: E402
from dostransformer_tpu_torch.data import graph, synthetic  # noqa: E402
from dostransformer_tpu_torch.data.io import save_samples  # noqa: E402
from dostransformer_tpu_torch.models.import_torch import state_dict_from_jax  # noqa: E402
from dostransformer_tpu_torch.models.registry import build_model  # noqa: E402
from dostransformer_tpu_torch.nn.layernorm import (  # noqa: E402
    LayerNorm,
    LayerNormLP,
    layer_norm,
    layer_norm_lp,
)
from dostransformer_tpu_torch.nn.transformer import TransformerEncoder  # noqa: E402
from dostransformer_tpu_torch.ops import attention as port_attention  # noqa: E402
from dostransformer_tpu_torch.ops.attention import (  # noqa: E402
    attention_plan,
    fused_attention_ln,
    ln_attention_reference,
)
from dostransformer_tpu_torch.ops.layernorm import (  # noqa: E402
    layer_norm_bwd,
    ln_bwd_plan,
    ln_bwd_reference,
)
from dostransformer_tpu_torch.serve import Predictor  # noqa: E402
from dostransformer_tpu_torch.train import loss as tloss  # noqa: E402
from dostransformer_tpu_torch.train.trainer import Trainer  # noqa: E402

H = 32
LEVERS = ("DOSTPU_FUSE_LN_ATTN", "DOSTPU_LN_LP", "DOSTPU_LN_PALLAS")
SHAPES = [(8, 201, 256), (6, 7, 32), (16, 64)]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture
def levers(monkeypatch):
    """The JAX package's three lever names set as its users set them (its
    kernels in interpret mode, as tests/conftest.py arranges)."""
    monkeypatch.setenv("DOSTPU_PALLAS_INTERPRET", "1")
    for name in LEVERS:
        monkeypatch.setenv(name, "1")


def _ln_data(shape, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 3 + 1).astype(np.float32)
    scale = (rng.randn(shape[-1]) * 0.2 + 1.0).astype(np.float32)
    bias = (rng.randn(shape[-1]) * 0.1).astype(np.float32)
    return x, scale, bias


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a.astype(jnp.float32))


# --- layer_norm_lp (kernel #7's op and plain version) -------------------


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES)
def test_layer_norm_lp_forward_matches_jax(dtype, shape):
    """f32: within 1e-6 (the same operations in the same order); bf16:
    within one bf16 ulp (2^-7 of the value) of the JAX output."""
    jd, td = DTYPES[dtype]
    x, scale, bias = _ln_data(shape)
    want = j_layer_norm_lp(jnp.asarray(x).astype(jd), jnp.asarray(scale),
                           jnp.asarray(bias))
    got = layer_norm_lp(torch.from_numpy(x).to(td), torch.from_numpy(scale),
                        torch.from_numpy(bias))
    assert got.dtype == td and tuple(got.shape) == shape
    got, want = _f32(got), _f32(want)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        assert (np.abs(got - want) <= np.abs(want) * 2.0 ** -7).all()


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES)
def test_layer_norm_lp_gradients_match_jax_pallas_backward(dtype, shape,
                                                           monkeypatch):
    """dx, dscale and dbias against jax.grad with DOSTPU_LN_PALLAS=1 (the
    Pallas backward in interpret mode on 3-D inputs, its jnp form on 2-D):
    f32 rtol/atol 2e-5, bf16 within 3% of the largest element."""
    monkeypatch.setenv("DOSTPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("DOSTPU_LN_PALLAS", "1")
    jd, td = DTYPES[dtype]
    x, scale, bias = _ln_data(shape, seed=1)

    def jloss(x, s, b):
        return (j_layer_norm_lp(x, s, b).astype(jnp.float32) ** 2).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x).astype(jd), jnp.asarray(scale), jnp.asarray(bias))
    leaves = [torch.from_numpy(x).to(td).requires_grad_(),
              torch.from_numpy(scale).requires_grad_(),
              torch.from_numpy(bias).requires_grad_()]
    layer_norm_lp(*leaves).float().square().sum().backward()
    assert leaves[0].grad.dtype == td
    for t, w, name in zip(leaves, want, ("dx", "dscale", "dbias")):
        g, w = _f32(t.grad), _f32(w)
        if dtype == "f32":
            np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-5,
                                       err_msg=name)
        else:
            denom = max(1e-3, float(np.abs(w).max()))
            assert np.abs(g - w).max() / denom < 0.03, name


def test_layer_norm_lp_gradcheck_f64_and_default_path():
    """f64 operands stay f64 on the plain path (gradcheck); at f32 the
    variant agrees with the default layer_norm, forward (1e-6) and backward
    (2e-5)."""
    x, scale, bias = _ln_data((3, 5, 32), seed=2)
    leaves = [torch.from_numpy(a).double().requires_grad_()
              for a in (x, scale, bias)]
    assert layer_norm_lp(*leaves).dtype == torch.float64
    assert torch.autograd.gradcheck(layer_norm_lp, leaves)
    grads = []
    for fn in (layer_norm_lp, layer_norm):
        leaves = [torch.from_numpy(a).requires_grad_()
                  for a in (x, scale, bias)]
        y = fn(*leaves)
        y.square().sum().backward()
        grads.append([y.detach()] + [t.grad for t in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)


def test_layer_norm_bwd_kernel_refuses_cpu_tensors():
    """The kernel wrapper never gives way to the plain version."""
    x, scale, _ = _ln_data((4, 32))
    xhat, dy = torch.from_numpy(x), torch.from_numpy(x)
    rstd = torch.ones(4, 1)
    before = layer_norm_bwd.launches
    with pytest.raises(ValueError, match="CUDA"):
        layer_norm_bwd(xhat, rstd, torch.from_numpy(scale), dy)
    assert layer_norm_bwd.launches == before
    dx, dscale, dbias = ln_bwd_reference(xhat, rstd, torch.from_numpy(scale),
                                         dy)
    assert dx.shape == (4, 32) and dscale.shape == dbias.shape == (32,)


def _ln_bwd_operands(rows, d, td, seed=0, shift=1.0):
    """x, dy in ``td``; scale, and the rows' mean and rstd in f32."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.randn(rows, d) * 3 + shift).astype(
        np.float32)).to(td)
    dy = torch.from_numpy(rng.randn(rows, d).astype(np.float32)).to(td)
    scale = torch.from_numpy((rng.rand(d) + 0.5).astype(np.float32))
    _, mean, rstd = torch.native_layer_norm(x.float(), (d,), scale,
                                            torch.zeros(d), 1e-5)
    return x, dy, scale, mean, rstd


@pytest.mark.parametrize("shape", [(40, 32), (7, 48), (3, 5, 256), (9, 600)],
                         ids=str)
@pytest.mark.parametrize("dtype", DTYPES)
def test_ln_bwd_reference_raw_form_equals_xhat_form_and_jax(dtype, shape):
    """``ln_bwd_reference(x, rstd, scale, dy, mean)`` forms xhat itself:
    the same bits as the xhat form on the xhat it would be handed, and
    against the JAX package's ``_ln_bwd_jnp`` f32 atol 1e-6 x the largest
    element, bf16 within 3% of it."""
    jd, td = DTYPES[dtype]
    rows, d = int(np.prod(shape[:-1])), shape[-1]
    x, dy, scale, mean, rstd = _ln_bwd_operands(rows, d, td, seed=3)
    x, dy = x.reshape(shape), dy.reshape(shape)
    mean, rstd = (t.reshape(*shape[:-1], 1) for t in (mean, rstd))
    xhat = ((x.float() - mean) * rstd).to(td)
    raw = ln_bwd_reference(x, rstd, scale, dy, mean)
    by_xhat = ln_bwd_reference(xhat, rstd, scale, dy)
    for a, b in zip(raw, by_xhat):
        assert torch.equal(a, b)
    want = _ln_bwd_jnp((jnp.asarray(_f32(xhat)).astype(jd),
                        jnp.asarray(rstd.numpy()), jnp.asarray(scale.numpy())),
                       jnp.asarray(_f32(dy)).astype(jd))
    for got, w, name in zip(raw, want, ("dx", "dscale", "dbias")):
        g, w = _f32(got), _f32(w)
        tol = 1e-6 if dtype == "f32" else 0.03
        assert np.abs(g - w).max() <= tol * max(1.0, np.abs(w).max()), name


def emulated_ln_bwd(x, rstd, scale, dy, mean=None):
    """The kernel's arithmetic and summation orders in plain torch
    (csrc/layernorm_bwd.cu): everything in f32; dx a row at a time; dscale
    and dbias per slab of columns, a thread adding its rows (every
    rows_a_pass-th of its block's run) in order, then the lanes that hold
    the same columns by a butterfly, the 8 warps in order, the cluster's
    blocks in rank order."""
    td = dy.dtype
    rows, d = dy.shape
    plan = ln_bwd_plan(rows, d, td == torch.bfloat16)
    xf, dyf = x.float(), dy.float()
    if mean is not None:
        xf = ((xf - mean) * rstd).to(td).float()
    g = dyf * scale
    s1 = g.sum(-1, keepdim=True) / d
    s2 = (g * xf).sum(-1, keepdim=True) / d
    dx = (rstd * (g - s1 - xf * s2)).to(td)

    tpr, rpp = plan["threads_a_row"], plan["rows_a_pass"]
    per_warp = 32 // tpr          # row lanes of a warp
    sums = []
    for prod in (dyf * xf, dyf):
        total = torch.zeros(d)
        for rank in range(plan["cluster"]):
            lo = min(rows, rank * plan["rows_per_rank"])
            hi = min(rows, lo + plan["rows_per_rank"])
            thread = torch.zeros(rpp, d)      # [row lane of the block, col]
            for r0 in range(lo, hi, rpp):     # a thread's rows, in order
                chunk = prod[r0:min(hi, r0 + rpp)]
                thread[:chunk.shape[0]] += chunk
            warps = thread.reshape(8, per_warp, d)
            while warps.shape[1] > 1:         # the xor butterfly, low bit first
                warps = warps[:, 0::2] + warps[:, 1::2]
            block = torch.zeros(d)
            for w in range(8):                # warp order
                block = block + warps[w, 0]
            total = total + block             # rank order
        sums.append(total)
    return dx, sums[0], sums[1]


@pytest.mark.parametrize("raw", [False, True], ids=["xhat", "x_mean_rstd"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,d", [(1, 32), (7, 48), (128, 256), (300, 50),
                                    (1100, 256), (260, 600), (40, 1024)])
def test_emulated_ln_bwd_partition_matches_the_plain_version(rows, d, dtype,
                                                             raw):
    """The kernel's partition and summation orders against
    ``ln_bwd_reference``: f32 dx within 1e-5 and dscale, dbias within 1e-4
    of max(1, max|plain|); bf16 within 3% (the kernel keeps g in f32)."""
    td = DTYPES[dtype][1]
    x, dy, scale, mean, rstd = _ln_bwd_operands(rows, d, td, seed=rows + d)
    xin = x if raw else ((x.float() - mean) * rstd).to(td)
    m = mean if raw else None
    got = emulated_ln_bwd(xin, rstd, scale, dy, m)
    want = ln_bwd_reference(xin, rstd, scale, dy, m)
    tols = (1e-5, 1e-4, 1e-4) if dtype == "f32" else (0.03,) * 3
    for a, b, tol, name in zip(got, want, tols, ("dx", "dscale", "dbias")):
        a, b = a.float(), b.float()
        assert (a - b).abs().max() <= tol * max(1.0, b.abs().max().item()), name


def test_emulated_ln_bwd_large_mean_input():
    """The raw form at a mean of 50 (25 standard deviations): xhat is formed
    from the row's own mean, so nothing cancels; 1e-5 / 1e-4 as above."""
    x, dy, scale, mean, rstd = _ln_bwd_operands(816, 256, torch.float32,
                                                seed=9, shift=50.0)
    x = (x - 50.0) * (2.0 / 3.0) + 50.0
    _, mean, rstd = torch.native_layer_norm(x, (256,), scale,
                                            torch.zeros(256), 1e-5)
    got = emulated_ln_bwd(x, rstd, scale, dy, mean)
    want = ln_bwd_reference(x, rstd, scale, dy, mean)
    for a, b, tol in zip(got, want, (1e-5, 1e-4, 1e-4)):
        assert (a - b).abs().max() <= tol * max(1.0, b.abs().max().item())


@pytest.mark.parametrize("d", [1, 31, 48, 50, 256, 600, 1024, 2048, 5000])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_ln_bwd_plan_covers_any_width(d, bf16):
    """Every width has a plan: the 16-byte vector form where the row is a
    whole number of vectors that a lane's registers hold, else the scalar
    form; the slabs cover the columns, the clusters the rows, and the grid
    is whole clusters with a row block for every 8 rows."""
    vec = 8 if bf16 else 4
    for rows in (1, 8, 128, 129, 3216, 100_000):
        p = ln_bwd_plan(rows, d, bf16)
        assert p["vector_form"] == (d % vec == 0 and d <= 256 * vec)
        assert p["slabs"] * p["slab"] >= d > (p["slabs"] - 1) * p["slab"]
        assert p["cluster"] in (1, 2, 4, 8)
        assert p["cluster"] * p["rows_per_rank"] >= rows
        assert p["slabs"] * p["cluster"] <= max(132, p["slabs"])
        assert p["grid"] % p["cluster"] == 0
        assert p["grid"] >= p["slabs"] * p["cluster"] + -(-rows // 8)
        # a block of a cluster keeps at least four passes of rows
        assert p["cluster"] == 1 or rows > 4 * p["rows_a_pass"] * p["cluster"]


@pytest.mark.parametrize("d", [48, 1024])
def test_layer_norm_lp_gradients_match_jax_at_other_widths(d, monkeypatch):
    """Widths the card's LayerNorm backward now takes (any width): dx,
    dscale, dbias against jax.grad of the JAX layer_norm_lp (its plain
    backward), rtol/atol 2e-5."""
    for name in LEVERS:
        monkeypatch.delenv(name, raising=False)
    x, scale, bias = _ln_data((3, 5, d), seed=d)

    def jloss(x, s, b):
        return (j_layer_norm_lp(x, s, b) ** 2).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias)]
    layer_norm_lp(*leaves).square().sum().backward()
    for t, w, name in zip(leaves, want, ("dx", "dscale", "dbias")):
        np.testing.assert_allclose(_f32(t.grad), _f32(w), rtol=2e-5,
                                   atol=2e-5, err_msg=name)


# --- fused_attention_ln (kernel #5's op and plain version) --------------


def _attn_case(b, lq, lk, d, self_attn=False, masked=False, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, lq, d).astype(np.float32)
    xk = xv = None
    if not self_attn:
        xk = rng.randn(b, lk, d).astype(np.float32)
        xv = rng.randn(b, lk, d).astype(np.float32)
    scale = (rng.rand(d) + 0.5).astype(np.float32)
    bias = (rng.randn(d) * 0.1).astype(np.float32)
    mask = None
    if masked:
        mask = rng.rand(b, lk) > 0.3
        mask[:, 0] = True  # at least one key
    return x, xk, xv, scale, bias, mask


ATTN_CASES = {"cross": dict(b=2, lq=9, lk=6, d=32),
              "self_shared_tensor": dict(b=2, lq=7, lk=7, d=32,
                                         self_attn=True),
              "masked_keys": dict(b=2, lq=5, lk=11, d=64, masked=True,
                                  seed=3),
              "flagship_width": dict(b=1, lq=13, lk=5, d=256, seed=5)}


@pytest.mark.parametrize("case", ATTN_CASES)
def test_fused_attention_ln_matches_jax(case, levers):
    """Forward (2e-5) and the five gradients (3e-4) against the JAX
    fused_attention_ln (its Pallas kernel in interpret mode); the self case
    passes ONE tensor three times on both sides, so its single input
    gradient is the sum of the three uses."""
    x, xk, xv, scale, bias, mask = _attn_case(**ATTN_CASES[case])
    self_attn = xk is None
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)

    def jf(x_, xk_, xv_, s_, b_):
        if self_attn:
            xk_ = xv_ = x_
        return j_fused_attention_ln(x_, xk_, xv_, s_, b_, jmask)

    jin = [jnp.asarray(a if a is not None else x)
           for a in (x, xk, xv, scale, bias)]
    want = jf(*jin)
    want_g = jax.grad(lambda *a: (jf(*a) ** 2).sum(),
                      argnums=(0, 1, 2, 3, 4))(*jin)

    tx, ts, tb = (torch.from_numpy(a).requires_grad_()
                  for a in (x, scale, bias))
    if self_attn:
        txk = txv = tx
    else:
        txk, txv = (torch.from_numpy(a).requires_grad_() for a in (xk, xv))
    got = fused_attention_ln(tx, txk, txv, ts, tb, tmask)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(
        got, ln_attention_reference(tx, txk, txv, ts, tb, tmask),
        rtol=2e-5, atol=2e-5)
    got.square().sum().backward()
    names = ("x", "ln_scale", "ln_bias") if self_attn else (
        "x", "x_k", "x_v", "ln_scale", "ln_bias")
    leaves = dict(x=tx, x_k=txk, x_v=txv, ln_scale=ts, ln_bias=tb)
    idx = dict(x=0, x_k=1, x_v=2, ln_scale=3, ln_bias=4)
    for name in names:
        np.testing.assert_allclose(leaves[name].grad.numpy(),
                                   np.asarray(want_g[idx[name]]),
                                   rtol=3e-4, atol=3e-4, err_msg=name)
    if self_attn:  # JAX's x_k / x_v slots got no separate cotangent
        assert float(jnp.abs(want_g[1]).max()) == 0.0


@pytest.mark.parametrize("alias", ["k_is_v", "all_one"])
def test_fused_attention_ln_does_not_depend_on_aliasing(alias):
    """Inputs that are one tensor take the shared-LayerNorm shortcut in the
    backward; the outputs and (summed) gradients are those of equal but
    distinct tensors, to f32 rounding (1e-5)."""
    x, xk, _, scale, bias, mask = _attn_case(2, 7, 7, 32, masked=True,
                                             seed=7)
    tmask = torch.from_numpy(mask)
    outs = []
    for shared in (True, False):
        tx, tk, ts, tb = (torch.from_numpy(a).requires_grad_()
                          for a in (x, x if alias == "all_one" else xk,
                                    scale, bias))
        if shared:
            args = (tx, tx, tx) if alias == "all_one" else (tx, tk, tk)
        else:
            args = ((tx, tx.clone(), tx.clone()) if alias == "all_one"
                    else (tx, tk, tk.clone()))
        o = fused_attention_ln(*args, ts, tb, tmask)
        o.square().sum().backward()
        outs.append([o.detach(), tx.grad, ts.grad, tb.grad]
                    + ([] if alias == "all_one" else [tk.grad]))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", [48, 1024])
def test_fused_attention_ln_gradients_match_jax_at_other_widths(d):
    """D = 48 and 1,024 (off the card's attention widths; the plain path
    takes any): forward 2e-5 and the five gradients 3e-4 against the JAX
    fused_attention_ln through its plain path."""
    x, xk, xv, scale, bias, mask = _attn_case(2, 6, 5, d, masked=True, seed=d)
    jmask, tmask = jnp.asarray(mask), torch.from_numpy(mask)
    jin = [jnp.asarray(a) for a in (x, xk, xv, scale, bias)]
    jf = lambda *a: j_fused_attention_ln(*a, jmask)
    want = jf(*jin)
    want_g = jax.grad(lambda *a: (jf(*a) ** 2).sum(),
                      argnums=(0, 1, 2, 3, 4))(*jin)
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (x, xk, xv, scale, bias)]
    got = fused_attention_ln(*leaves, tmask)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    got.square().sum().backward()
    for t, w, name in zip(leaves, want_g,
                          ("x", "x_k", "x_v", "ln_scale", "ln_bias")):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=3e-4,
                                   atol=3e-4, err_msg=name)


def _xhat_form_backward(x, x_k, x_v, ln_scale, ln_bias, key_mask, g):
    """The five gradients of fused_attention_ln as its backward formed them
    while it built xhat with eager ops and handed the LayerNorm backward the
    xhat form: one LayerNorm backward per distinct tensor."""
    def ln(t):
        y, mu, rstd = torch.native_layer_norm(t, t.shape[-1:], ln_scale,
                                              ln_bias, 1e-5)
        return y, (t - mu) * rstd, rstd

    k_is_q, v_is_k, v_is_q = x_k is x, x_v is x_k, x_v is x
    lnq = ln(x)
    lnk = lnq if k_is_q else ln(x_k)
    lnv = lnk if v_is_k else lnq if v_is_q else ln(x_v)
    bias = port_attention._bias(x, x_k.shape[1], key_mask)
    dq, dk, dv = port_attention.attention_bwd_reference(
        lnq[0], lnk[0], lnv[0], bias, g)
    if v_is_k:
        dk, dv = dk + dv, None
    elif v_is_q:
        dq, dv = dq + dv, None
    if k_is_q:
        dq, dk = dq + dk, None
    grads, dscale, dbias = [], 0.0, 0.0
    for dy, (_, xhat, rstd) in ((dq, lnq), (dk, lnk), (dv, lnv)):
        if dy is None:
            grads.append(None)
            continue
        dx, ds, db = ln_bwd_reference(xhat, rstd, ln_scale, dy)
        grads.append(dx)
        dscale, dbias = dscale + ds, dbias + db
    return (*grads, dscale, dbias)


@pytest.mark.parametrize("alias", ["distinct", "k_is_v", "all_one"])
def test_fused_attention_ln_backward_keeps_its_gradients(alias):
    """The backward now hands the LayerNorm backward the raw inputs with
    (mean, rstd); at the three aliasing patterns it returns the same five
    gradients, bit for bit, as the xhat form it replaced."""
    x, xk, xv, scale, bias, mask = _attn_case(2, 7, 7, 32, masked=True,
                                              seed=11)
    tx, tk, tv, ts, tb = (torch.from_numpy(a) for a in
                          (x, xk, xv, scale, bias))
    tmask = torch.from_numpy(mask)
    args = {"distinct": (tx, tk, tv), "k_is_v": (tx, tk, tk),
            "all_one": (tx, tx, tx)}[alias]
    g = torch.from_numpy(np.random.RandomState(12).randn(2, 7, 32).astype(
        np.float32))
    leaves = {id(t): t.clone().requires_grad_() for t in args}
    ls, lb = ts.clone().requires_grad_(), tb.clone().requires_grad_()
    o = fused_attention_ln(*(leaves[id(t)] for t in args), ls, lb, tmask)
    o.backward(g)
    want = _xhat_form_backward(*args, ts, tb, tmask, g)
    seen = set()
    for t, w in zip(args, want[:3]):
        if id(t) in seen:
            assert w is None
            continue
        seen.add(id(t))
        assert torch.equal(leaves[id(t)].grad, w)
    assert torch.equal(ls.grad, want[3]) and torch.equal(lb.grad, want[4])


@pytest.mark.parametrize("d", [1, 31, 33, 48, 50, 200, 544, 1000, 1024])
def test_the_attention_kernels_take_every_width(d):
    """The attention kernels' plan (the mirror of dostpu_attention_plan,
    held equal to the library on the card) has a form for every width: rows
    staged whole at ceil(D / 32) x 32 columns up to 512, slices of 512
    output columns above it; the staged columns cover the row with less
    than one group (or slice) to spare."""
    nc, slices, _ = attention_plan(d)
    assert 1 <= nc <= 16 and slices >= 1
    if d <= 512:
        assert slices == 1 and 32 * (nc - 1) < d <= 32 * nc
    else:
        assert nc == 16 and 512 * (slices - 1) < d <= 512 * slices
    with pytest.raises(ValueError):
        attention_plan(0)


def _width_batches(task, seed=13):
    """One batch of 2 learnable samples + 1 dummy graph, JAX and port."""
    samples = TASKS[task][1](2, seed=seed)
    a = graph.bucket_size(max(s.n_nodes for s in samples))
    e = graph.bucket_size(max(s.n_edges for s in samples))
    kw = dict(atoms_per_graph=a, edges_per_graph=e, num_graphs=3)
    return jcollate(samples, **kw), graph.collate(_port(samples), **kw)


@pytest.mark.parametrize("hidden", [33, 48, 1024])
@pytest.mark.parametrize("task", ["edos", "phdos"])
def test_flagship_at_a_width_no_multiple_of_32_or_wide_matches_jax(
        task, hidden):
    """The widths the card now takes (no multiple of 32; 1,024, the h1024
    row) on the CPU, port against the JAX package on its plain path
    (use_pallas and use_fused_mp off: its kernels' lane padding is not what
    is compared), 1 processor and 1 layer per stack, weights carried by
    state_dict_from_jax, 2 graphs and a dummy: the forward's three outputs on
    the real graphs (atol 1e-4 + rtol 1e-4, as the flagship test above) and
    every parameter's first-step gradient of the training loss against
    jax.grad (1e-4 x max(1, max|grad|) per tensor, as
    tests/test_torch_train.py; 1e-3 at hidden 1,024, where the JAX
    package's own f32 gradients stand up to 2.1e-4 x max|grad| from the
    same model evaluated in f64, and the port's up to 1.0e-4)."""
    jmodel_cls, _, clamp = TASKS[task]
    jb, tb = _width_batches(task)
    jm = jmodel_cls(layers=1, t_layers=1, hidden=hidden, use_pallas=False,
                    use_fused_mp=False)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jb)["params"]
    tm = build_model(task, layers=1, t_layers=1, hidden=hidden, device="cpu")
    tm.load_state_dict(state_dict_from_jax(params, task=task), strict=True)

    def loss_fn(p):
        dg, _, ds = jm.apply({"params": p}, jb, deterministic=True)
        return jloss.dos_loss(dg, ds, jb.y, jb.graph_mask, 1.0, clamp)[0]

    want_out = jm.apply({"params": params}, jb, deterministic=True)
    want_loss, want = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = state_dict_from_jax(want, task=task)
    got_out = tm(tb)
    for w, g in zip(want_out, got_out):
        np.testing.assert_allclose(g.detach().numpy()[:2], np.asarray(w)[:2],
                                   rtol=1e-4, atol=1e-4)
    dg, _, ds = got_out
    got_loss, _ = tloss.dos_loss(dg, ds, tb.y, tb.graph_mask,
                                 clamp_targets=clamp)
    got_loss.backward()
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
    named = dict(tm.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        assert p.grad is not None, name
        _scaled_close(p.grad, want[name].numpy(),
                      1e-4 if hidden < 1024 else 1e-3, name)


# --- the transformer stack ----------------------------------------------


@pytest.mark.parametrize("mode", ["cross", "self"])
def test_transformer_encoder_with_both_switches_matches_jax(mode, levers):
    """TransformerEncoder(fuse_ln_attn=True, ln_lp=True) against the JAX
    TransformerEncoder(use_pallas=True) under the three levers, weights
    through state_dict_from_jax: output 2e-5, input and parameter gradients
    3e-4; and against the port's own unfused stack on the same weights."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, 7, H).astype(np.float32)
    xk = rng.randn(2, 4, H).astype(np.float32) if mode == "cross" else None
    mask = None
    if mode == "cross":
        mask = np.array([[1, 1, 1, 0], [1, 1, 0, 0]], bool)
    enc = JEncoder(embed_dim=H, layers=2, use_pallas=True)
    jargs = ((jnp.asarray(x), jnp.asarray(xk), jnp.asarray(xk),
              jnp.asarray(mask)) if mode == "cross" else (jnp.asarray(x),))
    params = enc.init(jax.random.PRNGKey(0), *jargs)["params"]
    # LayerNorm parameters off their 1/0 init, so their gradients matter
    params = jax.tree.map(
        lambda a: a + 0.1 * jnp.asarray(
            np.random.RandomState(a.size).randn(*a.shape), a.dtype), params)

    def jloss(p, *a):
        return (enc.apply({"params": p}, *a) ** 2).sum()

    want = enc.apply({"params": params}, *jargs)
    want_gp, want_gx = jax.grad(jloss, argnums=(0, 1))(params, *jargs)

    sd = state_dict_from_jax(params)
    port = TransformerEncoder(H, 2, fuse_ln_attn=True, ln_lp=True)
    plain = TransformerEncoder(H, 2)
    assert list(port.state_dict()) == list(plain.state_dict())
    port.load_state_dict(sd, strict=True)
    plain.load_state_dict(sd, strict=True)
    assert all(isinstance(m, LayerNormLP) for m in
               [port.layer_norm, *port.layers[0].layer_norms])
    tx = torch.from_numpy(x).requires_grad_()
    targs = ((tx, torch.from_numpy(xk), torch.from_numpy(xk),
              torch.from_numpy(mask)) if mode == "cross" else (tx,))
    got = port(*targs)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(got, plain(*targs), rtol=2e-5, atol=2e-5)
    got.square().sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_gx),
                               rtol=3e-4, atol=3e-4)
    want_gp = state_dict_from_jax(want_gp)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_gp[name].numpy(),
                                   rtol=3e-4, atol=3e-4, err_msg=name)


# --- end to end: both flagships with both switches ----------------------

TASKS = {"edos": (JEDOS, jsyn.synthetic_edos_learnable, True),
         "phdos": (JPhDOS, jsyn.synthetic_phdos_learnable, False)}


def _port(samples):
    return [graph.GraphSample(**dataclasses.asdict(s)) for s in samples]


def _train_batches(task, n_batches=2, seed=11):
    """n same-shape batches of 3 learnable samples + 1 dummy graph."""
    samples = TASKS[task][1](3 * n_batches, seed=seed)
    a = graph.bucket_size(max(s.n_nodes for s in samples))
    e = graph.bucket_size(max(s.n_edges for s in samples))
    groups = [samples[3 * i: 3 * i + 3] for i in range(n_batches)]
    kw = dict(atoms_per_graph=a, edges_per_graph=e, num_graphs=4)
    return ([jcollate(g, **kw) for g in groups],
            [graph.collate(_port(g), **kw) for g in groups])


def _scaled_close(got: torch.Tensor, want: np.ndarray, rel: float, name):
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= rel * max(1.0, float(np.abs(want).max())), (name, err)


@pytest.mark.parametrize("task", TASKS)
def test_flagship_with_both_switches_matches_jax(task, levers):
    """A small flagship (hidden 32, 2 processors, 1 layer per stack) with
    fuse_ln_attn and ln_lp on, against the JAX model under the three levers
    (Pallas kernels in interpret mode): the forward's three outputs (atol
    1e-4, as tests/test_torch_phdos.py), then two Trainer.train_steps:
    per-step losses rtol 1e-5, params after them atol 1e-6 (1% of one AdamW
    step at lr 1e-4), as tests/test_torch_train.py."""
    jmodel_cls, _, clamp = TASKS[task]
    jb, tb = _train_batches(task)
    jm = jmodel_cls(layers=2, t_layers=1, hidden=H, use_pallas=True,
                    use_fused_mp=True)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jb[0])["params"]
    tm = build_model(task, layers=2, t_layers=1, hidden=H, fuse_ln_attn=True,
                     ln_lp=True)
    tm.load_state_dict(state_dict_from_jax(params, task=task), strict=True)

    want = jm.apply({"params": params}, jb[0])
    with torch.inference_mode():
        got = tm(tb[0])
    # real graphs only: a dummy graph's fully masked rows average over the
    # JAX kernel's lane-padded keys (ROADMAP queue 3), and the training loss
    # masks them
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy()[:3], np.asarray(w)[:3],
                                   rtol=1e-4, atol=1e-4)

    jt = JTrainer(jm, donate=False, clamp_targets=clamp, eval_clamp=clamp)
    state = TrainState.create(params, jt.tx, jax.random.PRNGKey(1))
    trainer = Trainer(tm, clamp_targets=clamp, eval_clamp=clamp)
    for j, t in zip(jb, tb):
        state, jout = jt.train_step(state, j)
        out = trainer.train_step(t)
        for k in ("loss", "rmse_global", "rmse_system"):
            np.testing.assert_allclose(out[k].item(), float(jout[k]),
                                       rtol=1e-5, err_msg=k)
    want = state_dict_from_jax(state.params, task=task)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)
    m = trainer.eval_step(tb[0])
    jm_out = jt.eval_step(state.params, jb[0])
    for k in ("rmse", "mae", "preds", "preds_global"):
        _scaled_close(m[k][:3], np.asarray(jm_out[k])[:3], 1e-4, k)


@pytest.mark.parametrize("task", TASKS)
def test_state_dict_is_the_same_with_the_switches_on_and_off(task):
    """Same keys, shapes and (from one seed) values, so state_dict_from_jax
    and load_reference_state_dict need no new mapping; the switches change
    the LayerNorm classes only."""
    kw = dict(layers=2, t_layers=1, hidden=H)
    off = build_model(task, generator=torch.Generator().manual_seed(3), **kw)
    on = build_model(task, generator=torch.Generator().manual_seed(3),
                     fuse_ln_attn=True, ln_lp=True, **kw)
    assert list(off.state_dict()) == list(on.state_dict())
    for (k, a), b in zip(off.state_dict().items(), on.state_dict().values()):
        assert torch.equal(a, b), k
    on.load_state_dict(off.state_dict(), strict=True)
    n_lp = lambda m: sum(type(x) is LayerNormLP for x in m.modules())
    stacks = (on.transformer, on.transformer_self, on.transformer_source)
    assert all(type(s.layer_norm) is LayerNormLP
               and all(type(n) is LayerNormLP for n in s.layers[0].layer_norms)
               and s.layers[0].fuse_ln_attn for s in stacks)
    assert type(off.transformer.layer_norm) is LayerNorm
    assert not off.transformer.layers[0].fuse_ln_attn
    # 3 stacks x (1 layer x 2 LayerNorms + the final one); the message-
    # passing LayerNorms stay as they are
    assert n_lp(on) == 9 and n_lp(off) == 0


# --- selecting the levers ----------------------------------------------


@pytest.mark.parametrize("env,want", [
    ({}, dict(fuse_ln_attn=False, ln_lp=False)),
    ({"DOSTPU_FUSE_LN_ATTN": "1"}, dict(fuse_ln_attn=True, ln_lp=False)),
    ({"DOSTPU_LN_LP": "1"}, dict(fuse_ln_attn=False, ln_lp=True)),
    ({"DOSTPU_LN_PALLAS": "1"}, dict(fuse_ln_attn=False, ln_lp=True)),
    ({"DOSTPU_FUSE_LN_ATTN": "1", "DOSTPU_LN_LP": "1",
      "DOSTPU_LN_PALLAS": "1"}, dict(fuse_ln_attn=True, ln_lp=True)),
    ({"DOSTPU_FUSE_LN_ATTN": "0", "DOSTPU_LN_LP": "true"},
     dict(fuse_ln_attn=False, ln_lp=False)),
], ids=["none", "fuse", "lp", "pallas", "all", "only_1_counts"])
def test_ln_levers_from_env(env, want, monkeypatch):
    assert common.ln_levers_from_env(env) == want
    for name in LEVERS:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert common.ln_levers_from_env() == want


@pytest.mark.parametrize("entry", ["main_edos", "main_phdos", "main_predict"])
def test_entry_points_pass_the_levers_to_the_model(entry, tmp_path,
                                                   monkeypatch):
    """With the JAX package's lever names in the environment each entry
    point builds its model with both switches on, and with none, off."""
    built = []
    real = build_model

    def recording(*args, **kwargs):
        built.append(real(*args, **kwargs))
        return built[-1]

    monkeypatch.setattr(common, "build_model", recording)
    monkeypatch.setattr("dostransformer_tpu_torch.serve.build_model",
                        recording)
    size = ["--hidden", str(H), "--layers", "2", "--transformer", "1",
            "--device", "cpu"]
    if entry == "main_predict":
        samples = synthetic.synthetic_edos_samples(3, seed=0)
        model = build_model("edos", layers=2, t_layers=1, hidden=H)
        torch.save(model.state_dict(), tmp_path / "w.pt")
        save_samples(str(tmp_path / "in.npz"), samples)
        run = lambda: main_predict.main([
            "--task", "edos", "--torch_state_dict", str(tmp_path / "w.pt"),
            "--input", str(tmp_path / "in.npz"), "--output",
            str(tmp_path / "out.npz"), *size])
    else:
        cli = main_edos if entry == "main_edos" else main_phdos
        run = lambda: cli.main([
            "--synthetic", "10", "--epochs", "1", "--eval", "1",
            "--batch_size", "4", "--results_dir", str(tmp_path), *size])
    for name in LEVERS:
        monkeypatch.delenv(name, raising=False)
    first = run()
    monkeypatch.setenv("DOSTPU_FUSE_LN_ATTN", "1")
    monkeypatch.setenv("DOSTPU_LN_PALLAS", "1")
    second = run()
    off, on = built
    assert not off.transformer.layers[0].fuse_ln_attn
    assert type(off.transformer.layer_norm) is LayerNorm
    assert on.transformer_self.layers[0].fuse_ln_attn
    assert type(on.transformer_source.layer_norm) is LayerNormLP
    if entry == "main_predict":  # same weights: the same spectra
        np.testing.assert_allclose(second, first, rtol=1e-4, atol=1e-5)


def test_predictor_from_torch_takes_the_switches(tmp_path):
    samples = synthetic.synthetic_phdos_samples(3, seed=0)
    model = build_model("phdos", layers=2, t_layers=1, hidden=H)
    torch.save(model.state_dict(), tmp_path / "w.pt")
    kw = dict(task="phdos", example=samples[0], layers=2, t_layers=1,
              hidden=H, batch_size=2, device="cpu")
    plain = Predictor.from_torch(tmp_path / "w.pt", **kw)
    fused = Predictor.from_torch(tmp_path / "w.pt", fuse_ln_attn=True,
                                 ln_lp=True, **kw)
    assert fused.model.transformer.layers[0].fuse_ln_attn
    np.testing.assert_allclose(fused.predict(samples), plain.predict(samples),
                               rtol=1e-4, atol=1e-5)
