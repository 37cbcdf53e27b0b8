"""bf16 serving in the PyTorch port against the JAX package on the CPU: the
plain versions of the three kernels that have a bf16 form (the fused
message-passing forward, the attention forward, the segment sum), both
flagships' forward, the Predictor, the parameters, and one train step's
plumbing. Small size: hidden 32, 2 processors, 1 transformer layer per
stack, a batch of 3 samples plus one dummy graph; inputs from numpy with a
seed, rounded to bf16 the same way on both sides (round to nearest even).
The JAX Pallas kernels run in interpret mode (tests/conftest.py), so the JAX
side rounds where its TPU kernels round.

Tolerances, derived once here and used below:

* ``KERNEL_REL = 2^-7`` of ``max|want|`` for one kernel's plain version:
  both sides compute in f32 from the same bf16 inputs, so before their last
  rounding they agree to ~1e-6 (summation order only); each then rounds once
  to bf16 (at most half an ulp, 2^-9 of the value, each), so they are at most
  one bf16 ulp apart, 2^-8 of the value: 2 ulps of the largest value leave a
  factor of 2. Edge counts are small integers: exact.
* ``MODEL_REL = 2^-6`` of ``max|want|`` for a whole model against the JAX
  model run through its kernels (``use_pallas=use_fused_mp=True``, which
  round where the port's plain versions round): every op of both rounds at
  the same points, so the two differ only where an f32 summation order moves
  a value across a bf16 rounding boundary; that one-ulp step (2^-8) is
  carried through the later layers with a gain of order one. Measured: at
  most 2^-8.
* ``PLAIN_REL = 0.03`` of ``max|want|`` against the JAX model's plain
  composition (``use_pallas=use_fused_mp=False``), which rounds elsewhere:
  it casts W1 to bf16, sums the aggregation in bf16 and rounds the product
  of the edge MLP before its bias. Those are independent bf16 roundings
  through every layer, the size of bf16's own distance from f32; 0.03 is
  the limit of the JAX package's own bf16-against-f32 test
  (tests/test_train.py, ``rtol=0.03``). Measured: at most 0.014.
* Under ``jax.jit`` (the JAX Predictor and Trainer) XLA keeps excess
  precision inside its fusions (``xla_allow_excess_precision``, on by
  default), so the jitted JAX model rounds at fewer points than the eager
  one: it is held to ``PLAIN_REL`` as well. Measured: at most 0.021.
* The silent-f32 guard: the bf16 output must differ from the same weights'
  f32 output by more than ``F32_FLOOR = 1e-3`` of its largest value (an f32
  run differs by ~1e-6; a bf16 run by ~1e-2) and by at most 0.03 of it.
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
from dostransformer_tpu.ops import segment as jsegment  # noqa: E402
from dostransformer_tpu.serve import Predictor as JPredictor  # noqa: E402
from dostransformer_tpu.train.trainer import Trainer as JTrainer  # noqa: E402
from dostransformer_tpu.train.trainer import TrainState  # noqa: E402
from dostransformer_tpu_torch.data.graph import GraphSample, collate  # noqa: E402
from dostransformer_tpu_torch.models.dostransformer import (  # noqa: E402
    DOSTransformerEDOS,
    DOSTransformerPhDOS,
)
from dostransformer_tpu_torch.models.import_torch import (  # noqa: E402
    state_dict_from_jax,
)
from dostransformer_tpu_torch.models.registry import build_model  # noqa: E402
from dostransformer_tpu_torch.ops.attention import fused_attention  # noqa: E402
from dostransformer_tpu_torch.ops.fused_mp import fused_mp_edge  # noqa: E402
from dostransformer_tpu_torch.ops.segment import batched_segment_sum  # noqa: E402
from dostransformer_tpu_torch.serve import Predictor  # noqa: E402
from dostransformer_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402
from dostransformer_tpu_torch.train.trainer import Trainer  # noqa: E402

H = 32
KERNEL_REL = 2.0 ** -7
MODEL_REL = 2.0 ** -6
PLAIN_REL = 0.03
F32_FLOOR = 1e-3
TASKS = {"edos": (JEDOS, DOSTransformerEDOS, jsyn.synthetic_edos_samples),
         "phdos": (JPhDOS, DOSTransformerPhDOS,
                   jsyn.synthetic_phdos_samples)}


def _bf16(x: np.ndarray):
    """The same bf16 values on both sides: (JAX array, torch tensor)."""
    return (jnp.asarray(x).astype(jnp.bfloat16),
            torch.from_numpy(np.ascontiguousarray(x)).bfloat16())


def _close(got: torch.Tensor, want, rel: float, what: str = ""):
    """max |got - want| <= rel * max |want|, both as f32."""
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (what, err)
    return err


# --- the kernels' plain versions ---------------------------------------------


def test_fused_mp_edge_plain_version_rounds_where_the_tpu_kernel_does():
    """bf16 projections, f32 LayerNorm parameters, slope, W1 and b1 (as the
    JAX model passes them): e_out and agg bf16, within KERNEL_REL of the
    JAX kernel's (interpret mode). A last graph with no real edge."""
    rng = np.random.RandomState(0)
    b, a, e, m, h = 4, 7, 20, 2 * H, H
    sp, dp = (rng.randn(b, a, m).astype(np.float32) for _ in range(2))
    ep = rng.randn(b, e, m).astype(np.float32)
    snd, rcv = (rng.randint(0, a, (b, e)).astype(np.int32) for _ in range(2))
    mask = (rng.rand(b, e) > 0.25).astype(np.float32)
    mask[-1] = 0.0
    scale = (rng.rand(m) + 0.5).astype(np.float32)
    shift = (rng.randn(m) * 0.1).astype(np.float32)
    alpha = np.asarray([0.25], np.float32)
    w1 = (rng.randn(m, h) * m ** -0.5).astype(np.float32)  # flax [M, H]
    b1 = (rng.randn(h) * 0.1).astype(np.float32)
    (jsp, tsp), (jdp, tdp), (jep, tep) = (_bf16(t) for t in (sp, dp, ep))
    f32 = lambda t: torch.from_numpy(t)
    want = jfused.fused_mp_edge(jsp, jdp, jep, jnp.asarray(snd),
                                jnp.asarray(rcv), jnp.asarray(mask),
                                jnp.asarray(scale), jnp.asarray(shift),
                                jnp.asarray(alpha), jnp.asarray(w1),
                                jnp.asarray(b1))
    got = fused_mp_edge(tsp, tdp, tep, f32(snd), f32(rcv), f32(mask),
                        f32(scale), f32(shift), f32(alpha),
                        f32(w1.T.copy()), f32(b1))
    for g, w, what in zip(got, want, ("e_out", "agg")):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16, what
        _close(g, w, KERNEL_REL, what)
    # agg sums the UNROUNDED e_out: the sum of the rounded rows differs
    summed = np.zeros((b, a, h), np.float32)
    e_round = got[0].float().numpy() * mask[..., None]
    for gi in range(b):
        np.add.at(summed[gi], rcv[gi], e_round[gi])
    assert not np.array_equal(
        torch.from_numpy(summed).bfloat16().float().numpy(),
        got[1].float().numpy())


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("lq,lk", [(11, 6), (9, 9)])
def test_fused_attention_plain_version_matches_the_jax_kernel(masked, lq, lk):
    """softmax(q k^T / sqrt(D) + bias) v in bf16: the softmax in f32, its
    weights normalised and rounded to bf16, then p v; within KERNEL_REL of
    the JAX kernel (interpret mode). The last batch element's keys are all
    masked (a dummy graph): that row is the uniform average of v, held to
    the JAX plain path (the JAX kernel's padded form also averages in its
    zero lane-padding keys there, as tests/test_torch_ops.py notes)."""
    rng = np.random.RandomState(1)
    q = rng.randn(3, lq, H).astype(np.float32)
    kv = rng.randn(3, lk, H).astype(np.float32)
    km = rng.rand(3, lk) > 0.3
    km[:, 0] = True
    km[-1] = False
    (jq, tq), (jk, tk) = _bf16(q), _bf16(kv)
    jm = jnp.asarray(km) if masked else None
    tm = torch.from_numpy(km) if masked else None
    want = jattention.fused_attention(jq, jk, jk, jm)
    got = fused_attention(tq, tk, tk, tm)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    real = slice(None, -1) if masked else slice(None)
    _close(got[real], want[real], KERNEL_REL)
    if masked:
        plain = jattention.dot_product_attention(jq, jk, jk, jm)
        _close(got[-1], plain[-1], KERNEL_REL, "fully masked row")


@pytest.mark.parametrize("f", [1, 8])
def test_batched_segment_sum_bf16(f):
    """bf16 data summed in f32 and rounded once. The edge count (F = 1,
    0/1 masks) is exact against both JAX sums; F = 8 within KERNEL_REL of
    segment_sum_pallas (f32 sums within its one edge tile, rounded once).
    Ids out of range and negative are dropped."""
    rng = np.random.RandomState(2)
    b, e, n = 4, 300, 13
    mask = (rng.rand(b, e) > 0.25).astype(np.float32)
    mask[-1] = 0.0
    data = (mask[..., None] if f == 1
            else rng.randn(b, e, f).astype(np.float32) * mask[..., None])
    ids = rng.randint(-2, n + 2, (b, e)).astype(np.int32)
    jd, td = _bf16(data)
    got = batched_segment_sum(td, torch.from_numpy(ids), n)
    assert got.dtype == torch.bfloat16
    pallas = jnp.stack([jsegment.segment_sum_pallas(jd[i], jnp.asarray(ids[i]),
                                                    n) for i in range(b)])
    if f == 1:
        plain = jsegment.batched_segment_sum(jd, jnp.asarray(ids), n)
        for want in (pallas, plain):
            np.testing.assert_array_equal(
                got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    else:
        _close(got, pallas, KERNEL_REL)


# --- the whole model -----------------------------------------------------------


def _batches(task, seed=5):
    samples = TASKS[task][2](3, seed=seed)
    port = [GraphSample(**vars(s)) for s in samples]
    return jcollate(samples, num_graphs=4), collate(port, num_graphs=4)


def _models(task, padding="mask"):
    """JAX params, the port's bf16 and f32 models on them."""
    jmodel, tmodel, _ = TASKS[task]
    jb, _ = _batches(task)
    params = jmodel(layers=2, t_layers=1, hidden=H, padding=padding).init(
        jax.random.PRNGKey(0), jb)
    ports = {}
    for dtype in ("bfloat16", "float32"):
        ports[dtype] = tmodel(layers=2, t_layers=1, hidden=H, padding=padding,
                              dtype=dtype)
        ports[dtype].load_state_dict(state_dict_from_jax(params, task=task),
                                     strict=True)
    return params, ports


@pytest.mark.parametrize("padding", ["mask", "ref"])
@pytest.mark.parametrize("task", ["edos", "phdos"])
def test_bf16_model_matches_jax(task, padding):
    """All three outputs, f32, against the JAX bf16 model through its
    kernels (MODEL_REL) and through its plain composition (PLAIN_REL); and
    the silent-f32 guard against the port's f32 model."""
    jb, tb = _batches(task)
    params, ports = _models(task, padding)
    with torch.inference_mode():
        got = ports["bfloat16"](tb)
        f32 = ports["float32"](tb)
    bins = 201 if task == "edos" else 51
    assert [tuple(g.shape) for g in got] == [
        (4, bins), (4, tb.atoms_per_graph, H), (4, bins)]
    assert all(g.dtype == torch.float32 for g in got)
    for kernels, rel in ((True, MODEL_REL), (False, PLAIN_REL)):
        jm = TASKS[task][0](layers=2, t_layers=1, hidden=H, padding=padding,
                            dtype="bfloat16", use_pallas=kernels,
                            use_fused_mp=kernels)
        want = jm.apply(params, jb)
        for g, w, what in zip(got, want, ("global", "nodes", "system")):
            assert w.dtype == jnp.float32
            _close(g, w, rel, f"{what}, JAX kernels {kernels}")
    for g, w in zip(got, f32):
        err = float((g - w).abs().max())
        top = float(w.abs().max())
        assert F32_FLOOR * top < err <= PLAIN_REL * top, (err, top)


def test_bf16_model_keeps_f32_parameters():
    """dtype="bfloat16" changes no parameter: every one is f32, and the
    state_dict equals the f32 model's built from the same JAX params."""
    for task in TASKS:
        _, ports = _models(task)
        sd16, sd32 = (ports[d].state_dict() for d in ("bfloat16", "float32"))
        assert set(sd16) == set(sd32)
        for k, v in sd16.items():
            assert v.dtype == torch.float32, k
            assert torch.equal(v, sd32[k]), k
        assert all(p.dtype == torch.float32
                   for p in ports["bfloat16"].parameters())


@pytest.mark.parametrize("dtype,error", [("float64", None),
                                         ("bf16", ValueError),
                                         ("float16", ValueError)])
def test_dtypes_the_model_refuses(dtype, error):
    """float64 (ported) builds, with f32 parameters, and computes in f64;
    an unknown name raises as the JAX model does."""
    for task in TASKS:
        if error is None:
            model = build_model(task, hidden=H, layers=1, t_layers=1,
                                dtype=dtype)
            assert model.cdtype == torch.float64
            assert all(p.dtype == torch.float32 for p in model.parameters())
            continue
        with pytest.raises(error, match="unknown dtype"):
            build_model(task, hidden=H, layers=1, t_layers=1, dtype=dtype)


# --- serving -------------------------------------------------------------------


@pytest.mark.parametrize("task", ["edos", "phdos"])
def test_bf16_predictor_matches_jax_predictor(task, tmp_path):
    """Predictor.from_torch(..., dtype="bfloat16") against the JAX Predictor
    of a bf16 model (through its kernels; jitted, so PLAIN_REL): f32
    outputs, eDOS clamped at 0, phDOS not; from_checkpoint(...,
    dtype="bfloat16") serves the same weights to the same bits."""
    jmodel, _, make = TASKS[task]
    request = make(7, seed=9)
    port = [GraphSample(**vars(s)) for s in request]
    params, ports = _models(task)
    jm = jmodel(layers=2, t_layers=1, hidden=H, dtype="bfloat16",
                use_pallas=True, use_fused_mp=True)
    want = JPredictor(jm, params["params"], batch_size=4,
                      clamp=task == "edos").predict(request)
    path = tmp_path / "w.pt"
    torch.save(ports["float32"].state_dict(), path)
    kw = dict(task=task, example=port[0], layers=2, t_layers=1, hidden=H,
              batch_size=4, device="cpu", dtype="bfloat16")
    pred = Predictor.from_torch(path, **kw)
    assert all(p.dtype == torch.float32 for p in pred.model.parameters())
    got = pred.predict(port)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.isfinite(got).all()
    if task == "edos":
        assert (got >= 0).all()
    else:
        assert (got < 0).any()  # phDOS is not clamped
    _close(torch.from_numpy(got), want, PLAIN_REL)
    ck = str(tmp_path / "ck")
    CheckpointManager(ck).save(1, ports["float32"], wait=True)
    again = Predictor.from_checkpoint(ck, **kw).predict(port)
    np.testing.assert_array_equal(again, got)


# --- training plumbing ---------------------------------------------------------


def test_bf16_train_step_on_the_cpu_matches_jax_trainer():
    """One Trainer.train_step of a bf16 eDOS model on the CPU (the plain
    versions, forward and backward) against the JAX Trainer's on a bf16
    model through its kernels: the loss within MODEL_REL (it is a mean of
    squares of the outputs, each within MODEL_REL of its largest value);
    every gradient f32 and finite, as AdamW's f32-only state needs. Then
    an eval step, whose metrics are f32."""
    jb, tb = _batches("edos")
    params, ports = _models("edos")
    jm = JEDOS(layers=2, t_layers=1, hidden=H, dtype="bfloat16",
               use_pallas=True, use_fused_mp=True)
    jt = JTrainer(jm, donate=False)
    state = TrainState.create(params["params"], jt.tx, jax.random.PRNGKey(1))
    _, jout = jt.train_step(state, jb)
    out = Trainer(ports["bfloat16"]).train_step(tb)
    np.testing.assert_allclose(out["loss"].item(), float(jout["loss"]),
                               rtol=MODEL_REL)
    for name, p in ports["bfloat16"].named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        assert bool(torch.isfinite(p.grad).all()), name
    # the eval step scores the f32 outputs of the bf16 forward
    m = Trainer(ports["bfloat16"]).eval_step(tb)
    for k in ("rmse", "preds", "embeddings", "preds_global"):
        assert m[k].dtype == torch.float32 and bool(torch.isfinite(m[k]).all())
