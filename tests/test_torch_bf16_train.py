"""bf16 training in the PyTorch port against the JAX package on the CPU: the
plain versions of the two backward kernels that have a bf16 form now (the
fused message-passing backward, the attention backward), both flagships'
first-step gradients with and without the LayerNorm levers, and three
Trainer steps against f32. Small size: hidden 32, 2 processors, 1
transformer layer per stack, 3 samples plus a dummy graph; inputs from numpy
with a seed, rounded to bf16 the same way on both sides. The JAX Pallas
kernels run in interpret mode (tests/conftest.py); its attention backward is
the Pallas kernel where ``DOSTPU_ATTN_PALLAS_BWD=1`` is set (the JAX
package's own switch) and its XLA backward ``_softmax_attn_bwd`` where it is
0.

Tolerances, derived once here and used below:

* ``F32_REL = 1e-5`` and ``F32_PARAM_REL = 1e-4`` of ``max(1, max|want|)``
  for the message-passing backward: both sides widen the same bf16 values
  to f32 and compute in f32, so they differ by f32 summation order only, as
  the f32 kernels do; the parameter gradients sum over every edge.
* ``KERNEL_REL = 2^-7`` of ``max|want|`` for the attention backward against
  the JAX Pallas kernel: both form s, p32, dp and ds in f32 from the same
  bf16 values (to ~1e-6) and round p, ds and each output once at the same
  points, so they are at most one bf16 ulp (2^-8 of the value) apart, more
  only where an f32 difference moves p or ds across a rounding boundary,
  which the sums then average; 2 ulps of the largest value.
* ``XLA_REL = 2^-6`` against the JAX XLA backward, which rounds dq and dk
  before the scale as well: one more rounding at a scale that is no power of
  2 (D = 32, 50), half an ulp more of each value.
* The model's gradients: the port and the JAX model round at the same
  points but for one, the cotangent of the three node and edge projections
  (the JAX custom VJP hands the Linear's transpose an f32 cotangent, which
  its mixed-dtype product takes as it is; torch's autograd casts a
  Function's gradient to its input's dtype, bf16, first). Every other
  difference is f32 summation order moving a value across a bf16 rounding
  boundary. Such a one-ulp step decorrelates that value's later rounding
  noise, so the scale of the difference is bf16's own noise at this depth:
  ``own``, the relative RMS distance of the port's bf16 gradients from its
  f32 gradients on the same weights. Limits: the relative RMS of all
  gradients together within ``own``; of each parameter within
  ``GRAD_FACTOR = 3`` times the largest of ``own`` and that parameter's own
  distance in either model (the port's bf16 from its f32, the JAX package's
  bf16 from its f32): a one-element PReLU slope, whose gradient is a sum
  with cancellation, moves 2-4% between any two of the four. Measured
  (all four cases): the total 0.22-0.58 of ``own``, each parameter at most
  1.24 times the largest of the three (the slopes of the encoders' PReLU).
* ``RUN_RTOL = 0.03``: three bf16 Trainer steps against the same steps in
  f32, the JAX package's own bound (tests/test_train.py, rtol 0.03).
"""

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
from dostransformer_tpu.ops import attention as jattention  # noqa: E402
from dostransformer_tpu.ops import fused_mp as jfused  # noqa: E402
from dostransformer_tpu.train import loss as jloss  # noqa: E402
from dostransformer_tpu_torch.data import graph  # noqa: E402
from dostransformer_tpu_torch.models.import_torch import (  # noqa: E402
    state_dict_from_jax,
)
from dostransformer_tpu_torch.models.registry import build_model  # noqa: E402
from dostransformer_tpu_torch.ops.attention import (  # noqa: E402
    attention_bwd_reference,
    key_bias,
)
from dostransformer_tpu_torch.ops.fused_mp import (  # noqa: E402
    mp_edge_bwd_reference,
)
from dostransformer_tpu_torch.train import loss as tloss  # noqa: E402
from dostransformer_tpu_torch.train.trainer import Trainer  # noqa: E402

H = 32
F32_REL, F32_PARAM_REL = 1e-5, 1e-4
KERNEL_REL = 2.0 ** -7
XLA_REL = 2.0 ** -6
GRAD_FACTOR = 3.0
RUN_RTOL = 0.03
LEVERS = ("DOSTPU_FUSE_LN_ATTN", "DOSTPU_LN_LP", "DOSTPU_LN_PALLAS")
TASKS = {"edos": (JEDOS, jsyn.synthetic_edos_learnable, True),
         "phdos": (JPhDOS, jsyn.synthetic_phdos_learnable, False)}


def _bf16(x: np.ndarray):
    """The same bf16 values on both sides: (JAX array, torch tensor)."""
    return (jnp.asarray(x).astype(jnp.bfloat16),
            torch.from_numpy(np.ascontiguousarray(x)).bfloat16())


def _f32(want) -> np.ndarray:
    return np.asarray(jnp.asarray(want).astype(jnp.float32))


def _close(got: torch.Tensor, want, rel: float, what: str = "",
           floor: float = 0.0) -> float:
    """max |got - want| <= rel * max(floor, max |want|), both as f32."""
    want = _f32(want)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rel * max(floor, float(np.abs(want).max())), (what, err)
    return err


# --- the plain backward versions ---------------------------------------------


@pytest.mark.parametrize("m,h", [(2 * H, H), (100, 50)])
def test_mp_edge_bwd_reference_bf16_matches_the_jax_kernel(m, h):
    """bf16 projections and cotangents, f32 LayerNorm parameters, slope and
    W1: all eight gradients f32 on both sides (the JAX custom VJP hands the
    kernel's f32 gradients on for bf16 projections), within the f32 limits
    of the JAX ``_bwd_kernel`` (interpret mode). A last graph with no real
    edge; hidden 50 (M = 100) is a width whose bf16 rows are no multiple of
    8."""
    rng = np.random.RandomState(3)
    b, a, e = 4, 7, 20
    sp, dp = (rng.randn(b, a, m).astype(np.float32) for _ in range(2))
    ep = rng.randn(b, e, m).astype(np.float32)
    g_eout = rng.randn(b, e, h).astype(np.float32)
    g_agg = rng.randn(b, a, h).astype(np.float32)
    snd, rcv = (rng.randint(0, a, (b, e)).astype(np.int32) for _ in range(2))
    mask = (rng.rand(b, e) > 0.25).astype(np.float32)
    mask[-1] = 0.0
    scale = (rng.rand(m) + 0.5).astype(np.float32)
    shift = (rng.randn(m) * 0.1).astype(np.float32)
    alpha = np.asarray([0.25], np.float32)
    w1 = (rng.randn(m, h) * m ** -0.5).astype(np.float32)  # flax [M, H]
    b1 = (rng.randn(h) * 0.1).astype(np.float32)
    bf = [_bf16(t) for t in (sp, dp, ep, g_eout, g_agg)]
    (jsp, tsp), (jdp, tdp), (jep, tep), (jge, tge), (jga, tga) = bf

    def jfn(sp_, dp_, ep_, sc, sh, al, w, bb):
        return jfused.fused_mp_edge(sp_, dp_, ep_, jnp.asarray(snd),
                                    jnp.asarray(rcv), jnp.asarray(mask), sc,
                                    sh, al, w, bb)

    _, vjp = jax.vjp(jfn, jsp, jdp, jep, *(jnp.asarray(t) for t in (
        scale, shift, alpha, w1, b1)))
    want = list(vjp((jge, jga)))
    want[6] = want[6].T  # g_W1 in torch's [H, M]
    t = lambda x: torch.from_numpy(x)
    got = mp_edge_bwd_reference(tsp, tdp, tep, t(snd), t(rcv), t(mask),
                                t(scale), t(shift), t(alpha),
                                t(w1.T.copy()), tge, tga)
    names = ("g_src", "g_dst", "g_edge", "g_ln_scale", "g_ln_bias",
             "g_alpha", "g_w1", "g_b1")
    for i, (g, w, name) in enumerate(zip(got, want, names)):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32, name
        _close(g, w, F32_REL if i < 3 else F32_PARAM_REL, name, floor=1.0)


def _attention_inputs(d, masked, seed=4):
    rng = np.random.RandomState(seed)
    b, lq, lk = 3, 11, 9
    q, g = (rng.randn(b, lq, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(b, lk, d).astype(np.float32) for _ in range(2))
    km = rng.rand(b, lk) > 0.4
    km[:, 0] = True  # every row attends somewhere (the JAX kernel's padded
    # form averages a fully masked row over its lane-padding keys)
    return q, k, v, g, (km if masked else None)


def _jax_attention_grads(q, k, v, g, km, pallas: bool, monkeypatch):
    """(dq, dk, dv) of the JAX fused_attention through the backward that
    DOSTPU_ATTN_PALLAS_BWD selects."""
    monkeypatch.setenv("DOSTPU_ATTN_PALLAS_BWD", "1" if pallas else "0")
    jm = None if km is None else jnp.asarray(km)
    _, vjp = jax.vjp(lambda a, b_, c: jattention.fused_attention(a, b_, c, jm),
                     *(_bf16(t)[0] for t in (q, k, v)))
    return vjp(_bf16(g)[0])


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("d", [32, 50, 64])
def test_attention_bwd_reference_bf16_matches_the_jax_kernels(d, masked,
                                                             monkeypatch):
    """dq, dk, dv bf16 within KERNEL_REL of the JAX Pallas backward
    (``_attn_bwd_kernel`` in interpret mode: p and ds rounded before their
    products, each output once after its scale) and within XLA_REL of the
    JAX XLA backward (``_softmax_attn_bwd``, which rounds dq and dk once
    more, before the scale)."""
    q, k, v, g, km = _attention_inputs(d, masked)
    tq, tk, tv, tg = (_bf16(t)[1] for t in (q, k, v, g))
    bias = (torch.zeros(3, k.shape[1]) if km is None
            else key_bias(torch.from_numpy(km)))
    got = attention_bwd_reference(tq, tk, tv, bias, tg)
    pallas = _jax_attention_grads(q, k, v, g, km, True, monkeypatch)
    xla = _jax_attention_grads(q, k, v, g, km, False, monkeypatch)
    for x, wp, wx, name in zip(got, pallas, xla, ("dq", "dk", "dv")):
        assert x.dtype == torch.bfloat16 and wp.dtype == jnp.bfloat16, name
        _close(x, wp, KERNEL_REL, f"{name} vs the Pallas backward")
        _close(x, wx, XLA_REL, f"{name} vs the XLA backward")


@pytest.mark.parametrize("d", [32, 50])
def test_attention_bwd_reference_f32_is_unchanged(d):
    """At f32 the rounding points of the bf16 form change nothing: the same
    bits as the composition before it (dq and dk scaled after an f32
    product, dv an f32 product), with and without the row statistics."""
    q, k, v, g, km = _attention_inputs(d, True)
    tq, tk, tv, tg = (torch.from_numpy(t) for t in (q, k, v, g))
    bias = key_bias(torch.from_numpy(km))
    scale = d ** -0.5
    s = torch.matmul(tq, tk.transpose(-1, -2)) * scale + bias[:, None, :]
    m = s.amax(-1)
    stats = torch.stack([m, torch.exp(s - m[..., None]).sum(-1)])
    for st in (None, stats):
        p = (torch.softmax(s, -1) if st is None
             else torch.exp(s - st[0][..., None]) / st[1][..., None])
        dp = torch.matmul(tg, tv.transpose(-1, -2))
        ds = p * (dp - (dp * p).sum(-1, keepdim=True))
        want = (torch.matmul(ds, tk) * scale,
                torch.matmul(ds.transpose(-1, -2), tq) * scale,
                torch.matmul(p.transpose(-1, -2), tg))
        got = attention_bwd_reference(tq, tk, tv, bias, tg, st)
        for x, w in zip(got, want):
            assert x.dtype == torch.float32 and torch.equal(x, w)


# --- the whole model -------------------------------------------------------------


def _batches(task, seed=11):
    """3 learnable samples + 1 dummy graph, JAX and port."""
    samples = TASKS[task][1](3, seed=seed)
    a = graph.bucket_size(max(s.n_nodes for s in samples))
    e = graph.bucket_size(max(s.n_edges for s in samples))
    kw = dict(atoms_per_graph=a, edges_per_graph=e, num_graphs=4)
    port = [graph.GraphSample(**vars(s)) for s in samples]
    return jcollate(samples, **kw), graph.collate(port, **kw)


def _port_grads(task, params, batch, dtype, levers):
    """The port's first-step loss and gradients of every parameter."""
    model = build_model(task, layers=2, t_layers=1, hidden=H, dtype=dtype,
                        fuse_ln_attn=levers, ln_lp=levers)
    model.load_state_dict(state_dict_from_jax(params, task=task), strict=True)
    dg, _, ds = model(batch)
    loss, _ = tloss.dos_loss(dg, ds, batch.y, batch.graph_mask,
                             clamp_targets=TASKS[task][2])
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert all(g is not None and g.dtype == torch.float32
               for g in grads.values())
    return loss.item(), grads


def _rel_rms(got, want) -> float:
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


@pytest.mark.parametrize("levers", [False, True])
@pytest.mark.parametrize("task", ["edos", "phdos"])
def test_bf16_first_step_gradients_match_jax(task, levers, monkeypatch):
    """Every parameter's first-step gradient of the bf16 flagship (with
    both LayerNorm levers or none) against jax.grad of the JAX bf16 model
    through its kernels (interpret mode; the attention backward the Pallas
    kernel; the levers under the JAX package's three names), within the
    limits derived above; the loss within 2^-7."""
    monkeypatch.setenv("DOSTPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("DOSTPU_ATTN_PALLAS_BWD", "1")
    for name in LEVERS:
        monkeypatch.setenv(name, "1" if levers else "0")
    jmodel_cls, _, clamp = TASKS[task]
    jb, tb = _batches(task)
    params = jax.jit(jmodel_cls(layers=2, t_layers=1, hidden=H).init)(
        jax.random.PRNGKey(0), jb)["params"]
    jm = jmodel_cls(layers=2, t_layers=1, hidden=H, dtype="bfloat16",
                    use_pallas=True, use_fused_mp=True)

    def loss_fn(p):
        dg, _, ds = jm.apply({"params": p}, jb, deterministic=True)
        return jloss.dos_loss(dg, ds, jb.y, jb.graph_mask, 1.0, clamp)[0]

    want_loss, want = jax.value_and_grad(loss_fn)(params)
    want = state_dict_from_jax(want, task=task)
    # the JAX package's f32 gradients, on its plain path (its kernels are
    # held to it in f32 elsewhere): the scale of its own bf16 noise
    jm32 = jmodel_cls(layers=2, t_layers=1, hidden=H, use_pallas=False,
                      use_fused_mp=False)

    def loss32(p):
        dg, _, ds = jm32.apply({"params": p}, jb, deterministic=True)
        return jloss.dos_loss(dg, ds, jb.y, jb.graph_mask, 1.0, clamp)[0]

    want32 = state_dict_from_jax(jax.jit(jax.grad(loss32))(params), task=task)
    loss16, got = _port_grads(task, params, tb, "bfloat16", levers)
    _, got32 = _port_grads(task, params, tb, "float32", levers)
    np.testing.assert_allclose(loss16, float(want_loss), rtol=KERNEL_REL)
    assert set(got) == set(want)
    names = sorted(got)
    cat = lambda d: torch.cat([d[n].flatten().float() for n in names])
    own = _rel_rms(cat(got), cat(got32))
    assert own > 1e-3, "the bf16 model computed in f32"  # a silent-f32 guard
    total = _rel_rms(cat(got), cat(want))
    assert total <= own, (total, own)
    for n in names:
        scale = max(own, _rel_rms(got[n], got32[n]),
                    _rel_rms(want[n], want32[n]))
        assert _rel_rms(got[n], want[n]) <= GRAD_FACTOR * scale, (n, scale)



@pytest.mark.parametrize("task", ["edos", "phdos"])
def test_bf16_trainer_steps_track_f32(task):
    """Three bf16 Trainer.train_steps (plain versions forward and backward,
    AdamW on f32 parameters) from the weights of an f32 model, on the same
    batches: every loss within RUN_RTOL of the f32 run's, as the JAX
    package's tests/test_train.py holds its bf16 model; every gradient f32
    and finite, every parameter f32."""
    samples = TASKS[task][1](9, seed=2)
    port = [graph.GraphSample(**vars(s)) for s in samples]
    a = graph.bucket_size(max(s.n_nodes for s in samples))
    e = graph.bucket_size(max(s.n_edges for s in samples))
    batches = [graph.collate(port[i:i + 3], atoms_per_graph=a,
                             edges_per_graph=e, num_graphs=4)
               for i in range(0, 9, 3)]
    clamp = TASKS[task][2]
    losses = {}
    for dtype in ("float32", "bfloat16"):
        model = build_model(task, layers=2, t_layers=1, hidden=H, dtype=dtype,
                            generator=torch.Generator().manual_seed(7))
        trainer = Trainer(model, clamp_targets=clamp, eval_clamp=clamp)
        losses[dtype] = [trainer.train_step(b)["loss"].item()
                         for b in batches]
        for name, p in model.named_parameters():
            assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
            assert bool(torch.isfinite(p.grad).all()), name
    assert np.isfinite(losses["bfloat16"]).all()
    np.testing.assert_allclose(losses["bfloat16"], losses["float32"],
                               rtol=RUN_RTOL)
    assert losses["bfloat16"] != losses["float32"]  # a silent-f32 guard
