"""The PyTorch port's serving path against the JAX package on the CPU:
Predictor.predict on a request that spans two atom buckets and a short
batch, the main_predict CLI, and loading reference-format weights.
f32 on both sides; atol 1e-4 (rtol 1e-4), as for the whole model."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from dostransformer_tpu.data import collate as jcollate  # noqa: E402
from dostransformer_tpu.data import synthetic_edos_samples  # noqa: E402
from dostransformer_tpu.models import DOSTransformerEDOS as JModel  # noqa: E402
from dostransformer_tpu.serve import Predictor as JPredictor  # noqa: E402
from dostransformer_tpu_torch.cli import main_predict  # noqa: E402
from dostransformer_tpu_torch.data.graph import GraphSample, RequestError  # noqa: E402
from dostransformer_tpu_torch.data.io import save_samples  # noqa: E402
from dostransformer_tpu_torch.models.import_torch import (  # noqa: E402
    load_reference_state_dict,
    load_torch_state_dict,
    state_dict_from_jax,
)
from dostransformer_tpu_torch.models.registry import build_model  # noqa: E402
from dostransformer_tpu_torch.serve import Predictor  # noqa: E402

H, LAYERS, T_LAYERS = 32, 2, 1
TOL = dict(rtol=1e-4, atol=1e-4)


def _mixed_request():
    """Small (bucket 8) and large (bucket 32) crystals interleaved, so the
    bucket groups are not contiguous in input order."""
    small = synthetic_edos_samples(4, seed=20, min_atoms=3, max_atoms=6)
    large = synthetic_edos_samples(2, seed=21, min_atoms=20, max_atoms=24)
    return [small[0], large[0], small[1], small[2], large[1], small[3]]


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """JAX params, and the same weights saved as a port state_dict."""
    jm = JModel(layers=LAYERS, t_layers=T_LAYERS, hidden=H)
    params = jm.init(jax.random.PRNGKey(0), jcollate(_mixed_request()[:2]))
    path = tmp_path_factory.mktemp("w") / "edos.pt"
    torch.save(state_dict_from_jax(params), path)
    return jm, params["params"], path


def test_predict_matches_jax_predictor(weights):
    jm, params, path = weights
    request = _mixed_request()
    want = JPredictor(jm, params, batch_size=3, clamp=True).predict(request)
    port = [GraphSample(**vars(s)) for s in request]
    pred = Predictor.from_torch(path, task="edos", example=port[0],
                                layers=LAYERS, t_layers=T_LAYERS, hidden=H,
                                batch_size=3, device="cpu")
    got = pred.predict(port)
    assert got.shape == (6, 201) and (got >= 0).all()
    np.testing.assert_allclose(got, want, **TOL)
    # one group at the request-wide shape gives the same answers
    np.testing.assert_allclose(pred.predict(port, bucketed=False), got, **TOL)
    with pytest.raises(RequestError):
        pred.predict([])


def test_cli_writes_the_jax_output_keys(weights, tmp_path):
    jm, params, path = weights
    request = [GraphSample(**vars(s)) for s in _mixed_request()]
    save_samples(tmp_path / "in.npz", request)
    out = tmp_path / "out.npz"
    dos = main_predict.main([
        "--task", "edos", "--torch_state_dict", str(path),
        "--input", str(tmp_path / "in.npz"), "--output", str(out),
        "--layers", str(LAYERS), "--transformer", str(T_LAYERS),
        "--hidden", str(H), "--batch_size", "4", "--device", "cpu"])
    with np.load(out) as z:
        assert sorted(z.files) == ["dos", "mp_id", "sample_id"]
        np.testing.assert_array_equal(z["dos"], dos)
        assert list(z["sample_id"]) == [s.sample_id for s in request]
        assert list(z["mp_id"]) == [s.mp_id for s in request]
    want = JPredictor(jm, params, batch_size=4, clamp=True).predict(
        _mixed_request())
    np.testing.assert_allclose(dos, want, **TOL)


@pytest.mark.parametrize("flag", [["--data_parallel"]])
def test_cli_rejects_unported_flags(flag, capsys):
    with pytest.raises(SystemExit):
        main_predict.main(["--task", "edos", "--torch_state_dict", "w.pt",
                           "--input", "x.npz", "--output", "y.npz", *flag])
    assert "ROADMAP.md" in capsys.readouterr().err


METRIC_KEYS = ("rmse", "mse", "mae", "r2", "n")


def test_cli_metrics_match_the_jax_cli(weights, tmp_path, capsys):
    """--metrics: the port's CLI and the JAX package's, on the same seeded
    samples and the same weights (one state_dict file), give the same JSON
    line and npz entries. Tolerance rtol 1e-4 + atol 1e-4: the predictions
    agree to that (TOL above) and every metric is a mean over them in f64."""
    import json

    from dostransformer_tpu.cli import main_predict as jax_main_predict

    _, _, path = weights
    request = [GraphSample(**vars(s)) for s in _mixed_request()]
    save_samples(tmp_path / "in.npz", request)
    common = ["--task", "edos", "--torch_state_dict", str(path),
              "--input", str(tmp_path / "in.npz"), "--layers", str(LAYERS),
              "--transformer", str(T_LAYERS), "--hidden", str(H),
              "--batch_size", "4", "--metrics"]
    found = {}
    for name, cli, more in (("jax", jax_main_predict, []),
                            ("port", main_predict, ["--device", "cpu"])):
        out = tmp_path / f"{name}.npz"
        cli.main([*common, "--output", str(out), *more])
        lines = [ln for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith('{"metrics"')]
        assert len(lines) == 1
        printed = json.loads(lines[0])["metrics"]
        assert tuple(printed) == METRIC_KEYS
        with np.load(out) as z:
            assert sorted(z.files) == sorted(
                ["dos", "mp_id", "sample_id", *METRIC_KEYS])
            for k in METRIC_KEYS:
                assert z[k].dtype == np.float64 and z[k] == printed[k]
        found[name] = printed
    assert found["port"]["n"] == found["jax"]["n"] == len(request)
    for k in METRIC_KEYS:
        np.testing.assert_allclose(found["port"][k], found["jax"][k], **TOL)


@pytest.mark.parametrize("task", ["edos", "phdos"])
def test_prediction_metrics_clamp_edos_targets_only(task):
    """A negative target counts as 0 for eDOS and as itself for phDOS; r2 of
    a perfect prediction is 1."""
    class S:
        def __init__(self, y):
            self.y = y

    y = np.array([[-1.0, 2.0, 3.0], [0.5, 0.0, 1.0]])
    pred = np.clip(y, 0.0, None)
    got = main_predict.prediction_metrics(task, [S(r) for r in y], pred)
    if task == "edos":
        assert got["mse"] == 0.0 and got["mae"] == 0.0 and got["r2"] == 1.0
    else:
        assert got["mse"] == pytest.approx(1.0 / 6.0)
        assert got["mae"] == pytest.approx(1.0 / 6.0)
        assert got["r2"] < 1.0
    assert got["n"] == 2


def _default_device_cases():
    """Each entry point called as a user without a card would call it: no
    ``--device`` and no ``device=``. The CLIs get arguments that would run
    (synthetic data, a tiny model), so only the device can stop them."""
    from dostransformer_tpu_torch.cli import main_edos, main_phdos
    from dostransformer_tpu_torch.cli.common import run_training
    from dostransformer_tpu_torch.config import TrainConfig

    tiny = ["--synthetic", "8", "--epochs", "1", "--hidden", str(H),
            "--layers", "1", "--transformer", "1"]
    port = [GraphSample(**vars(s)) for s in _mixed_request()]
    return {
        "main_predict": lambda: main_predict.main(
            ["--task", "edos", "--torch_state_dict", "w.pt", "--input",
             "x.npz", "--output", "y.npz"]),
        "main_edos": lambda: main_edos.main(tiny),
        "main_phdos": lambda: main_phdos.main(tiny),
        "Predictor.from_torch": lambda: Predictor.from_torch(
            "w.pt", task="edos", example=port[0], hidden=H),
        "run_training": lambda: run_training(
            "edos", TrainConfig(epochs=1, hidden=H), port[:4], port[4:5],
            port[5:]),
    }


@pytest.mark.parametrize("entry", ["main_predict", "main_edos", "main_phdos",
                                   "Predictor.from_torch", "run_training"])
def test_entry_points_default_to_the_card_and_refuse_without_one(
        entry, capsys, monkeypatch, tmp_path):
    """The entry points run on the card by default. Where no card is
    visible they stop with a message that names how to ask for the CPU
    (``--device cpu`` for the CLIs, ``device="cpu"`` for the functions) and
    do no work: no model is built, nothing is written."""
    from dostransformer_tpu_torch.cli import common
    from dostransformer_tpu_torch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)

    def never(*a, **k):
        raise AssertionError(f"{entry} built a model without a card")

    monkeypatch.setattr(common, "build_model", never)
    monkeypatch.setattr(serve, "build_model", never)
    call = _default_device_cases()[entry]
    if entry.startswith("main_"):
        with pytest.raises(SystemExit) as exc:
            call()
        assert exc.value.code == 2
        message = capsys.readouterr().err
        assert "--device cpu" in message
    else:
        with pytest.raises(RuntimeError) as exc:
            call()
        message = str(exc.value)
        assert 'device="cpu"' in message
    assert "no CUDA device is visible" in message
    assert not list(tmp_path.iterdir())


def test_reference_format_state_dict_loads(tmp_path):
    """A state_dict with the reference's module structure (dead attention
    projections, node_mlp_1 and all) loads into the port strictly."""
    from test_import_torch import _FlagshipEDOS  # the reference's names

    ref = _FlagshipEDOS(h=H)
    torch.save({"state_dict": ref.state_dict(), "epoch": 3}, tmp_path / "r.pt")
    sd = load_torch_state_dict(tmp_path / "r.pt")
    model = build_model("edos", layers=2, t_layers=2, hidden=H)
    load_reference_state_dict(model, sd, strict=True)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
    with pytest.raises(RuntimeError):  # a mismatched shape is loud
        load_reference_state_dict(
            build_model("edos", layers=2, t_layers=2, hidden=2 * H), sd)
