"""The PyTorch port's eight baseline families (graphnetwork, graphnetwork2,
mlp, mlp2 of eDOS and phDOS) against the JAX package on the CPU, on identical
weights (state_dict_from_jax) and inputs (numpy from a seed): hidden 32 for
eDOS and 48 for phDOS, 2 processors where the family has them, a batch of 3
samples plus one dummy graph, f32 on both sides.

Tolerances, each stated where it is used: forward outputs atol 1e-4 + rtol
1e-4 (f32 through a few layers of products summed in another order),
first-step gradients 1e-4 of each tensor's largest element, the loss rtol
1e-5 and the parameters after one AdamW step atol 1e-6 (1% of a step at lr
1e-4) where the gradient is at least 100x AdamW's eps, two steps elsewhere;
weight names exact. Then the registry, the reference-weight import,
and the three CLIs with every family."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from dostransformer_tpu.data import collate as jcollate  # noqa: E402
from dostransformer_tpu.data import synthetic as jsyn  # noqa: E402
from dostransformer_tpu.models import registry as jregistry  # noqa: E402
from dostransformer_tpu.models.import_torch import (  # noqa: E402
    export_reference_state_dict,
)
from dostransformer_tpu.train import loss as jloss  # noqa: E402
from dostransformer_tpu.train.trainer import Trainer as JTrainer  # noqa: E402
from dostransformer_tpu.train.trainer import TrainState  # noqa: E402
from dostransformer_tpu_torch.cli import (  # noqa: E402
    main_edos,
    main_phdos,
    main_predict,
)
from dostransformer_tpu_torch.data import graph  # noqa: E402
from dostransformer_tpu_torch.data.io import save_samples  # noqa: E402
from dostransformer_tpu_torch.models.import_torch import (  # noqa: E402
    load_reference_state_dict,
    state_dict_from_jax,
)
from dostransformer_tpu_torch.models.registry import (  # noqa: E402
    MODEL_REGISTRY,
    build_model,
    model_outputs,
)
from dostransformer_tpu_torch.serve import Predictor  # noqa: E402
from dostransformer_tpu_torch.train import loss  # noqa: E402
from dostransformer_tpu_torch.train.trainer import Trainer  # noqa: E402

HIDDEN = {"edos": 32, "phdos": 48}
LAYERS = 2
FAMILIES = [(task, name) for task in ("edos", "phdos")
            for name in ("graphnetwork", "graphnetwork2", "mlp", "mlp2")]
IDS = [f"{t}-{n}" for t, n in FAMILIES]
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
LR = 1e-4  # both Trainers' default AdamW rate


def _port(samples):
    return [graph.GraphSample(**dataclasses.asdict(s)) for s in samples]


def _samples(task, n=3, seed=7):
    make = (jsyn.synthetic_edos_learnable if task == "edos"
            else jsyn.synthetic_phdos_learnable)
    return make(n, seed=seed)


def _batch(task, seed=7):
    """3 samples and one dummy graph, collated by both packages."""
    samples = _samples(task, seed=seed)
    return jcollate(samples, num_graphs=4), graph.collate(_port(samples),
                                                          num_graphs=4)


def _jax_model(task, name):
    return jregistry.build_model(task, name, layers=LAYERS,
                                 hidden=HIDDEN[task])


def _port_model(task, name, params, batch):
    widths = {"node_in": batch.nodes.shape[-1]}
    if batch.edges is not None:
        widths.update(edge_in=batch.edges.shape[-1],
                      glob_in=batch.glob.shape[-1])
    model = build_model(task, name, layers=LAYERS, hidden=HIDDEN[task],
                        device="cpu", **widths)
    model.load_state_dict(state_dict_from_jax(params, task), strict=True)
    return model


@pytest.fixture(scope="module", params=FAMILIES, ids=IDS)
def family(request):
    """(task, name, JAX model, its params, JAX batch, port batch)."""
    task, name = request.param
    jb, tb = _batch(task)
    jm = _jax_model(task, name)
    params = jax.jit(jm.init)(jax.random.PRNGKey(3), jb)["params"]
    return task, name, jm, params, jb, tb


def _jax_outputs(out):
    if not isinstance(out, tuple):
        return out, None, None
    return out if len(out) == 3 else (out[0], out[1], None)


def test_forward_matches_jax(family):
    task, name, jm, params, jb, tb = family
    want = _jax_outputs(jm.apply({"params": params}, jb))
    tm = _port_model(task, name, params, tb)
    with torch.inference_mode():
        out = tm(tb)
    # eDOS graphnetwork* return (dos, node embeddings); the rest a bare dos
    assert isinstance(out, tuple) == (task == "edos"
                                      and name.startswith("graphnetwork"))
    got = model_outputs(out)
    bins = 201 if task == "edos" else 51
    assert tuple(got[0].shape) == (4, bins)
    for w, g in zip(want, got):
        assert (w is None) == (g is None)
        if w is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **MODEL_TOL)


def _scaled_close(got, want: np.ndarray, rel: float, name):
    got = np.zeros_like(want) if got is None else got.detach().numpy()
    err = float(np.abs(got - want).max())
    assert err <= rel * max(1.0, float(np.abs(want).max())), (name, err)


def test_first_step_gradients_and_adamw_step_match_jax(family):
    """Every parameter's gradient of the training loss against jax.grad
    (a parameter whose output nothing reads has no gradient here and a zero
    one there), then one train step against the JAX Trainer's: the loss and
    the parameters after AdamW."""
    task, name, jm, params, jb, tb = family
    clamp = task == "edos"

    def loss_fn(p):
        dg, _, ds = _jax_outputs(jm.apply({"params": p}, jb))
        return jloss.dos_loss(dg, ds, jb.y, jb.graph_mask, 1.0, clamp)[0]

    want_loss, want = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = state_dict_from_jax(want, task)
    tm = _port_model(task, name, params, tb)
    dg, _, ds = model_outputs(tm(tb))
    got_loss, _ = loss.dos_loss(dg, ds, tb.y, tb.graph_mask, 1.0, clamp)
    got_loss.backward()
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
    named = dict(tm.named_parameters())
    assert set(named) == set(want)
    for pname, p in named.items():
        _scaled_close(p.grad, want[pname].numpy(), 1e-4, pname)

    jt = JTrainer(jm, donate=False, clamp_targets=clamp, eval_clamp=clamp)
    state = TrainState.create(params, jt.tx, jax.random.PRNGKey(1))
    state, jout = jt.train_step(state, jb)
    tm = _port_model(task, name, params, tb)
    out = Trainer(tm, clamp_targets=clamp, eval_clamp=clamp).train_step(tb)
    np.testing.assert_allclose(out["loss"].item(), float(jout["loss"]),
                               rtol=1e-5)
    after = state_dict_from_jax(state.params, task)
    for pname, p in tm.named_parameters():
        got, ref = p.detach().numpy(), after[pname].numpy()
        # AdamW's first step is lr * g / (|g| + 1e-8): where |g| is near the
        # eps its direction is f32 noise of the two gradients, so those
        # elements are held within two steps, the rest within 1% of one
        stable = np.abs(want[pname].numpy()) >= 100 * 1e-8
        np.testing.assert_allclose(got[stable], ref[stable], rtol=0,
                                   atol=1e-6, err_msg=pname)
        assert np.abs(got - ref).max() <= 2 * LR, pname


def test_eval_step_matches_jax(family):
    """Metrics of the one DOS; embeddings only where the model returns node
    embeddings (as the JAX Trainer exports them)."""
    task, name, jm, params, jb, tb = family
    clamp = task == "edos"
    jt = JTrainer(jm, donate=False, clamp_targets=clamp, eval_clamp=clamp)
    want = jt.eval_step(params, jb)
    got = Trainer(_port_model(task, name, params, tb), clamp_targets=clamp,
                  eval_clamp=clamp).eval_step(tb)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **MODEL_TOL)


def test_state_dict_from_jax_equals_reference_export(family):
    task, name, _, params, _, tb = family
    ours = state_dict_from_jax(params, task)
    ref = export_reference_state_dict(params, task=task)
    assert set(ours) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    tm = _port_model(task, name, params, tb)
    assert set(tm.state_dict()) == set(ours)


@pytest.mark.parametrize("task,name", FAMILIES, ids=IDS)
def test_reference_weights_load_without_their_dead_parameters(task, name):
    """A reference state_dict (the JAX package's export, plus the free
    alpha and, for graphnetwork2, the Decoder its forward never calls)
    loads strictly; the outputs are the JAX model's."""
    jb, tb = _batch(task, seed=9)
    jm = _jax_model(task, name)
    params = jm.init(jax.random.PRNGKey(5), jb)["params"]
    sd = {k: torch.from_numpy(np.array(v)) for k, v in
          export_reference_state_dict(params, task=task).items()}
    sd["alpha"] = torch.zeros(1)
    if name == "graphnetwork2":
        h = HIDDEN[task]
        sd["GN_decoder.mlp.0.weight"] = torch.zeros(h, 2 * h)
        sd["GN_decoder.mlp.0.bias"] = torch.zeros(h)
    tm = build_model(task, name, layers=LAYERS, hidden=HIDDEN[task],
                     device="cpu", node_in=tb.nodes.shape[-1])
    load_reference_state_dict(tm, sd, strict=True)
    want = _jax_outputs(jm.apply({"params": params}, jb))[0]
    with torch.inference_mode():
        got = model_outputs(tm(tb))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


@pytest.mark.parametrize("task,name", [(t, n) for t in MODEL_REGISTRY
                                       for n in MODEL_REGISTRY[t]])
def test_registry_passes_each_family_only_its_arguments(task, name):
    """Flagship-only options are dropped for a baseline, as the JAX
    registry drops them; the baselines' parameters match the JAX
    package's."""
    model = build_model(task, name, layers=LAYERS, t_layers=1, hidden=32,
                        padding="mask", remat=False, fuse_ln_attn=False,
                        ln_lp=False, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    assert next(model.parameters()).device.type == "cpu"
    if name.startswith("dostransformer"):
        return
    jb, _ = _batch(task)
    jm = jregistry.build_model(task, name, layers=LAYERS, hidden=32)
    jparams = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jb)["params"]
    shapes = {k: tuple(v.shape) for k, v in state_dict_from_jax(
        jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jparams),
        task).items()}
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == shapes


def _cli_argv(tmp_path, name, *extra):
    return ["--embedder", name, "--synthetic", "16", "--synthetic_learnable",
            "--epochs", "2", "--eval", "1", "--hidden", "16", "--layers", "1",
            "--batch_size", "4", "--device", "cpu", "--results_dir",
            str(tmp_path), *extra]


@pytest.mark.parametrize("task,name", FAMILIES, ids=IDS)
def test_training_cli_trains_every_family(tmp_path, task, name):
    """main_edos / main_phdos with --embedder: finite test metrics, the
    experiments_{embedder}.txt block and --export_preds (embeddings where
    the family returns node embeddings)."""
    cli = main_edos if task == "edos" else main_phdos
    preds = tmp_path / "preds.npz"
    result = cli.main(_cli_argv(tmp_path, name, "--export_preds", str(preds)))
    assert all(np.isfinite(v) for v in result["test"].values())
    block = (tmp_path / f"experiments_{name}.txt").read_text()
    assert "best RMSE : " in block
    with np.load(preds) as z:
        n = z["sample_id"].shape[0]
        assert z["preds"].shape == (n, 201 if task == "edos" else 51)
        has_x = task == "edos" and name.startswith("graphnetwork")
        assert ("embeddings" in z) == has_x


@pytest.mark.parametrize("task", ["edos", "phdos"])
def test_main_predict_serves_a_baseline_as_the_jax_predictor(tmp_path, task):
    """main_predict --embedder mlp2 on the weights of a JAX-initialised
    model: the JAX package's predictions (atol 1e-4 + rtol 1e-4)."""
    from dostransformer_tpu.serve import Predictor as JPredictor

    samples = _samples(task, n=5, seed=3)
    jb = jcollate(samples)
    jm = _jax_model(task, "mlp2")
    params = jm.init(jax.random.PRNGKey(2), jb)["params"]
    weights = tmp_path / "mlp2.pt"
    torch.save(state_dict_from_jax(params, task), weights)
    request, out = tmp_path / "req.npz", tmp_path / "out.npz"
    save_samples(request, _port(samples))
    main_predict.main(["--task", task, "--embedder", "mlp2",
                       "--torch_state_dict", str(weights), "--input",
                       str(request), "--output", str(out), "--layers",
                       str(LAYERS), "--hidden", str(HIDDEN[task]),
                       "--device", "cpu"])
    want = JPredictor(jm, params, clamp=(task == "edos")).predict(samples)
    with np.load(out) as z:
        np.testing.assert_allclose(z["dos"], np.asarray(want), **MODEL_TOL)
    ours = Predictor.from_torch(weights, task=task, example=_port(samples)[0],
                                embedder="MLP2", layers=LAYERS,
                                hidden=HIDDEN[task], device="cpu")
    np.testing.assert_allclose(ours.predict(_port(samples)), np.asarray(want),
                               **MODEL_TOL)
