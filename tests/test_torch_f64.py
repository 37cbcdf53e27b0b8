"""The port's float64 model and ``--x64`` against the JAX package on the
CPU: both flagships' forward in f64 against the JAX model's
``dtype="float64"`` under ``jax_enable_x64`` (set up as
tests/test_model_parity.py sets up its x64 pins), three f64 train steps
against the JAX f64 Trainer, AdamW's x64 scalars against optax under x64,
``main_phdos --x64`` against the JAX ``main_phdos --x64``, and the f64 rule
(the f64 model calls no kernel op, on any device).

Small sizes: hidden 32, 2 processors, 1 transformer layer a stack, batches
of 3 samples and a dummy graph; f32 parameters (cast to f64 at use, as the
JAX package casts them). Tolerances, each stated where it is used: with
``DOSTPU_SOFTMAX_WIDE=1`` on both sides (every operation in f64) rtol 1e-9,
atol 1e-10; with the softmax at exactly f32 rtol = atol = 1e-6, the gap
between the two libraries' f32 exp; f32 parameters after AdamW steps 1e-6;
the CLI runs' losses and metrics rtol 1e-6 (f32 models whose sums run in
another order)."""

import contextlib
import dataclasses
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from dostransformer_tpu.cli import main_phdos as jax_main_phdos  # noqa: E402
from dostransformer_tpu.data import collate as jcollate  # noqa: E402
from dostransformer_tpu.data import synthetic as jsyn  # noqa: E402
from dostransformer_tpu.models import DOSTransformerEDOS as JEDOS  # noqa: E402
from dostransformer_tpu.models import DOSTransformerPhDOS as JPhDOS  # noqa: E402
from dostransformer_tpu.train.trainer import Trainer as JTrainer  # noqa: E402
from dostransformer_tpu.train.trainer import TrainState  # noqa: E402
from dostransformer_tpu.train.trainer import make_adamw as jmake_adamw  # noqa: E402
from dostransformer_tpu_torch.cli import main_phdos  # noqa: E402
from dostransformer_tpu_torch.data import graph  # noqa: E402
from dostransformer_tpu_torch.models.import_torch import (  # noqa: E402
    state_dict_from_jax,
)
from dostransformer_tpu_torch.models.registry import build_model  # noqa: E402
from dostransformer_tpu_torch.nn import layernorm  # noqa: E402
from dostransformer_tpu_torch.ops import attention, fused_mp, segment  # noqa: E402
from dostransformer_tpu_torch.serve import Predictor  # noqa: E402
from dostransformer_tpu_torch.train import optim  # noqa: E402
from dostransformer_tpu_torch.train.trainer import Trainer  # noqa: E402

H = 32
WIDE_TOL = dict(rtol=1e-9, atol=1e-10)
F32_SOFTMAX_TOL = dict(rtol=1e-6, atol=1e-6)
TASKS = {"edos": (JEDOS, jsyn.synthetic_edos_samples),
         "phdos": (JPhDOS, jsyn.synthetic_phdos_samples)}


@contextlib.contextmanager
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _f64(tree):
    return jax.tree.map(
        lambda a: np.asarray(a).astype(np.float64)
        if np.issubdtype(np.asarray(a).dtype, np.floating) else a, tree)


def _port_f64(batch):
    """The port's batch with every float field in f64 (as the JAX batch is
    cast)."""
    return dataclasses.replace(batch, **{
        f.name: getattr(batch, f.name).double()
        for f in dataclasses.fields(batch)
        if isinstance(getattr(batch, f.name), torch.Tensor)
        and getattr(batch, f.name).is_floating_point()})


def _forward_pair(task, wide, monkeypatch):
    """JAX dtype="float64" under x64 (use_pallas=False, parameters and
    batch cast to f64) and the port's f64 model on the same weights and
    batch (3 samples and a dummy graph)."""
    jcls, make = TASKS[task]
    samples = make(3, seed=7)
    if wide:
        monkeypatch.setenv("DOSTPU_SOFTMAX_WIDE", "1")
    with x64():
        jb = _f64(jcollate(samples, num_graphs=4))
        jm = jcls(layers=2, t_layers=1, hidden=H, dtype="float64",
                  use_pallas=False)
        params = jm.init(jax.random.PRNGKey(0), jb)
        want = [np.asarray(t) for t in jm.apply(_f64(params), jb)]
    tm = build_model(task, layers=2, t_layers=1, hidden=H, dtype="float64",
                     **({"node_in": samples[0].x.shape[1],
                         "edge_in": samples[0].edge_attr.shape[1],
                         "glob_in": samples[0].glob.shape[-1]}
                        if task == "edos" else {}))
    tm.load_state_dict(state_dict_from_jax(params, task=task), strict=True)
    port = [graph.GraphSample(**vars(s)) for s in samples]
    tb = _port_f64(graph.collate(port, num_graphs=4))
    with torch.no_grad():
        got = tm(tb)
    return got, want


@pytest.mark.parametrize("wide", [True, False], ids=["wide", "f32_softmax"])
@pytest.mark.parametrize("task", sorted(TASKS))
def test_f64_flagship_matches_jax_x64(task, wide, monkeypatch):
    """All three outputs, f64 on both sides: 1e-9 with the wide softmax,
    1e-6 with the f32 softmax."""
    got, want = _forward_pair(task, wide, monkeypatch)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and w.dtype == np.float64
        np.testing.assert_allclose(g.numpy(), w,
                                   **(WIDE_TOL if wide else F32_SOFTMAX_TOL))


def test_f64_train_steps_match_the_jax_f64_trainer(monkeypatch):
    """Three Trainer steps of the f64 phDOS model (f32 parameters and AdamW
    state, the x64 optimizer scalars) against the JAX Trainer of its
    dtype="float64" model under x64, wide softmax: the first loss (the f64
    forward and loss on the same parameters) rtol 1e-9; the f32
    parameters after each step within 1e-6, and so the later losses rtol
    1e-8: the port's AdamW and the XLA-compiled optax update round a few
    elements in 1e4 one f32 ulp apart (34 of 1e5 on identical f32
    gradients), and those parameters move the next f64 loss by ~1e-9."""
    monkeypatch.setenv("DOSTPU_SOFTMAX_WIDE", "1")
    samples = jsyn.synthetic_phdos_learnable(9, seed=11)
    a = graph.bucket_size(max(s.n_nodes for s in samples))
    e = graph.bucket_size(max(s.n_edges for s in samples))
    kw = dict(atoms_per_graph=a, edges_per_graph=e, num_graphs=4)
    groups = [samples[3 * i: 3 * i + 3] for i in range(3)]
    port = [[graph.GraphSample(**vars(s)) for s in g] for g in groups]
    with x64():
        jm = JPhDOS(layers=2, t_layers=1, hidden=H, dtype="float64",
                    use_pallas=False)
        jbatches = [jcollate(g, **kw) for g in groups]
        params = jm.init(jax.random.PRNGKey(0), jbatches[0])["params"]
        assert all(p.dtype == jnp.float32
                   for p in jax.tree.leaves(params))
        jt = JTrainer(jm, donate=False, clamp_targets=False,
                      eval_clamp=False)
        state = TrainState.create(params, jt.tx, jax.random.PRNGKey(1))
        jlosses = []
        for b in jbatches:
            state, out = jt.train_step(state, b)
            jlosses.append(float(out["loss"]))
        want = state_dict_from_jax(jax.device_get(state.params),
                                   task="phdos")
    tm = build_model("phdos", layers=2, t_layers=1, hidden=H,
                     dtype="float64")
    tm.load_state_dict(state_dict_from_jax(params, task="phdos"),
                       strict=True)
    trainer = Trainer(tm, optim.make_adamw(tm.parameters(), x64=True),
                      clamp_targets=False, eval_clamp=False)
    losses = []
    for group in port:
        out = trainer.train_step(graph.collate(group, **kw))
        assert out["loss"].dtype == torch.float64
        losses.append(out["loss"].item())
    np.testing.assert_allclose(losses[0], jlosses[0], rtol=1e-9)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-8)
    for name, p in tm.named_parameters():
        assert p.dtype == torch.float32, name
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("kwargs", [
    {}, {"warmup_steps": 3}, {"cosine_decay_steps": 5},
    {"warmup_steps": 2, "cosine_decay_steps": 4}],
    ids=["constant", "warmup", "cosine", "warmup+cosine"])
def test_adamw_x64_matches_optax_under_x64(kwargs):
    """AdamW(x64=True) against the JAX package's make_adamw under
    jax_enable_x64, 6 steps on the same f32 parameters and gradients: the
    parameters within 1 f32 ulp-scale (rtol 1e-7); the learning rate and
    bias corrections are optax's x64 ones exactly."""
    rng = np.random.RandomState(0)
    p0 = rng.randn(64).astype(np.float32)
    grads = [rng.randn(64).astype(np.float32) for _ in range(6)]
    with x64():
        tx = jmake_adamw(1e-3, 1e-2, **kwargs)
        params = {"w": jnp.asarray(p0)}
        state = tx.init(params)

        @jax.jit  # the JAX package's train step is jitted
        def step(params, state, g):
            up, state = tx.update({"w": g}, state, params)
            return optax.apply_updates(params, up), state

        for g in grads:
            params, state = step(params, state, jnp.asarray(g))
        want = np.asarray(params["w"])
        assert want.dtype == np.float32
        if kwargs.get("cosine_decay_steps"):
            sched = optax.warmup_cosine_decay_schedule(
                0.0 if kwargs.get("warmup_steps") else 1e-3, 1e-3,
                kwargs.get("warmup_steps", 0),
                kwargs.get("warmup_steps", 0) + kwargs["cosine_decay_steps"])
        elif kwargs.get("warmup_steps"):
            sched = optax.join_schedules(
                [optax.linear_schedule(0.0, 1e-3, kwargs["warmup_steps"]),
                 optax.constant_schedule(1e-3)], [kwargs["warmup_steps"]])
        else:
            sched = None
        for t in range(7):
            if sched is not None:  # as f32 multiplies the update
                got = optim.learning_rate(t, 1e-3, x64=True, **kwargs)
                assert np.float32(got) == np.float32(sched(jnp.int32(t)))
            bc = 1 - 0.9 ** jnp.int32(t + 1)
            assert optim.bias_correction(0.9, t + 1, x64=True) == float(
                np.float32(bc))
    w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = optim.make_adamw([w], 1e-3, 1e-2, x64=True, **kwargs)
    for g in grads:
        w.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(w.detach().numpy(), want, rtol=1e-7, atol=0)


def test_x64_widens_the_bias_correction():
    """Without x64 the bias correction is optax's f32 one, with it the f64
    one rounded: they differ (1 - 0.9 at step 1 is 0.100000024 in f32,
    0.1 rounded from f64)."""
    assert optim.bias_correction(0.9, 1) == float(
        np.float32(1) - np.float32(0.9))
    assert optim.bias_correction(0.9, 1, x64=True) == float(np.float32(0.1))
    assert optim.bias_correction(0.9, 1) != optim.bias_correction(
        0.9, 1, x64=True)


def _cli_flags(tmp_path, name):
    return ["--synthetic", "24", "--synthetic_learnable", "--epochs", "1",
            "--hidden", "32", "--layers", "1", "--transformer", "1",
            "--batch_size", "4", "--eval", "1", "--host_loader", "--x64",
            "--init_torch", str(tmp_path / "w.pt"),
            "--results_dir", str(tmp_path / name),
            "--log_jsonl", str(tmp_path / name / "log.jsonl")]


def _log(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_main_phdos_x64_matches_the_jax_cli(tmp_path):
    """main_phdos --x64 against the JAX main_phdos --x64 (24 samples, 1
    epoch, hidden 32, batch 4), both from one state_dict (--init_torch) and
    the host loader (one batch order on both sides): the epoch loss and the
    valid and test metrics within rtol 1e-6; the model stays f32 (the JAX
    CLI's --x64 does not change --dtype). The targets are learnable
    (--synthetic_learnable): on the unlearnable set many gradients are near
    0, where Adam turns rounding-level differences into steps of its
    learning rate, and after 5 steps the test mse of the JAX run alone moves
    by 1e-5 between --x64 and no --x64."""
    model = build_model("phdos", layers=1, t_layers=1, hidden=32,
                        generator=torch.Generator().manual_seed(3))
    torch.save(model.state_dict(), tmp_path / "w.pt")
    try:
        jax_main_phdos.main(_cli_flags(tmp_path, "jax"))
    finally:
        jax.config.update("jax_enable_x64", False)
    main_phdos.main([*_cli_flags(tmp_path, "port"), "--device", "cpu"])
    jrows, rows = (_log(tmp_path / n / "log.jsonl") for n in ("jax", "port"))
    assert len(jrows) == len(rows)
    for jr, r in zip(jrows, rows):
        for key in ("loss", "valid", "test"):
            if key == "loss" and key in jr:
                np.testing.assert_allclose(r[key], jr[key], rtol=1e-6)
            elif key in jr:
                for m, v in jr[key].items():
                    np.testing.assert_allclose(r[key][m], v, rtol=1e-6,
                                               err_msg=f"{key} {m}")


# --- the f64 rule ---------------------------------------------------------


def _no_op(*args, **kwargs):
    raise AssertionError("an f64 model called a kernel op")


@pytest.mark.parametrize("task", sorted(TASKS))
def test_f64_model_takes_the_plain_functions(task, monkeypatch):
    """An f64 model (even asked for both LayerNorm levers and the fused
    message passing) calls none of the kernel ops, forward or backward: its
    layers see f64 operands and take the plain functions (the f64 rule), so
    on the card it launches no kernel; it returns f64. The same model in
    f32 does take the ops."""
    kw = dict(layers=2, t_layers=1, hidden=H, fuse_ln_attn=True,
              ln_lp=True, use_fused_mp=True)
    m64 = build_model(task, dtype="float64", **kw)
    make = (jsyn.synthetic_edos_learnable if task == "edos"
            else jsyn.synthetic_phdos_learnable)
    batch = graph.collate([graph.GraphSample(**vars(s))
                           for s in make(3, seed=2)], num_graphs=4)
    for target, name in ((attention._FusedAttention, "apply"),
                         (attention._FusedAttentionLN, "apply"),
                         (segment._SegmentSum, "apply"),
                         (layernorm._LayerNormLP, "apply"),
                         (fused_mp, "fused_mp_edge")):
        monkeypatch.setattr(target, name, _no_op)
    import dostransformer_tpu_torch.nn.modules as modules
    monkeypatch.setattr(modules, "fused_mp_edge", _no_op)
    dg, x, ds = m64(batch)
    assert dg.dtype == x.dtype == ds.dtype == torch.float64
    (dg.sum() + ds.square().sum()).backward()
    assert all(p.grad.dtype == torch.float32 for p in m64.parameters())
    with pytest.raises(AssertionError, match="kernel op"):
        build_model(task, **kw)(batch)


def test_f64_predictor_serves_f64(tmp_path, monkeypatch):
    """Predictor.from_torch(..., dtype="float64") on the CPU serves the f64
    model's system head (f64 spectra), equal to the model's own forward on
    batches padded otherwise (wide softmax: 1e-10)."""
    monkeypatch.setenv("DOSTPU_SOFTMAX_WIDE", "1")
    samples = jsyn.synthetic_phdos_samples(5, seed=4)
    port = [graph.GraphSample(**vars(s)) for s in samples]
    model = build_model("phdos", layers=1, t_layers=1, hidden=H,
                        dtype="float64",
                        generator=torch.Generator().manual_seed(1))
    torch.save(model.state_dict(), tmp_path / "w.pt")
    pred = Predictor.from_torch(tmp_path / "w.pt", task="phdos",
                                example=port[0], layers=1, t_layers=1,
                                hidden=H, batch_size=4, device="cpu",
                                dtype="float64")
    got = pred.predict(port)
    assert got.dtype == np.float64 and got.shape == (5, 51)
    with torch.no_grad():
        want = np.concatenate([
            model.eval()(b)[2][b.graph_mask > 0.5].numpy()
            for b in pred_batches(pred, port)])
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


def pred_batches(pred, samples):
    from dostransformer_tpu_torch.data.datasets import GraphLoader
    return list(GraphLoader(samples, batch_size=pred.batch_size))
