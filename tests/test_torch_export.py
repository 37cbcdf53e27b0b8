"""The port's torch.export artifacts on the CPU: Predictor.export and
ExportedPredictor against the live port Predictor (exactly equal at the
artifact's geometry) and against the JAX package's ExportedPredictor on the
same weights (atol = rtol = 1e-4, as for the whole model in
tests/test_torch_serve.py); the exported graph's ``dostpu`` ops; serving an
artifact in a process that imports no model code; main_predict --export /
--from_exported and their flag conflicts; and each ``dostpu`` op's fake
implementation against its CPU implementation's shapes and dtypes. Small
models: hidden 32, 2 processors, 1 layer a stack."""

import collections
import json
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from dostransformer_tpu.data import collate as jcollate  # noqa: E402
from dostransformer_tpu.data import synthetic as jsyn  # noqa: E402
from dostransformer_tpu.models import DOSTransformerEDOS as JEDOS  # noqa: E402
from dostransformer_tpu.models import DOSTransformerPhDOS as JPhDOS  # noqa: E402
from dostransformer_tpu.serve import ExportedPredictor as JExported  # noqa: E402
from dostransformer_tpu.serve import Predictor as JPredictor  # noqa: E402
from dostransformer_tpu_torch.cli import main_predict  # noqa: E402
from dostransformer_tpu_torch.data.graph import GraphSample, RequestError  # noqa: E402
from dostransformer_tpu_torch.data.io import save_samples  # noqa: E402
from dostransformer_tpu_torch.models.import_torch import state_dict_from_jax  # noqa: E402
from dostransformer_tpu_torch.ops import attention, fused_mp, segment  # noqa: E402
from dostransformer_tpu_torch.serve import ExportedPredictor, Predictor  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, LAYERS, T_LAYERS = 32, 2, 1
TOL = dict(rtol=1e-4, atol=1e-4)
JAX_MODELS = {"edos": JEDOS, "phdos": JPhDOS}
MAKE = {"edos": jsyn.synthetic_edos_samples,
        "phdos": jsyn.synthetic_phdos_samples}


def _request(task):
    """Two atom buckets interleaved and a short final batch at batch 4."""
    make = MAKE[task]
    small = make(7, seed=30, max_atoms=6)
    large = make(3, seed=31, min_atoms=10, max_atoms=13)
    return [s for pair in zip(small, large) for s in pair] + small[3:]


def _port(samples):
    return [GraphSample(**vars(s)) for s in samples]


@pytest.fixture(scope="module", params=["edos", "phdos"])
def served(request, tmp_path_factory):
    """(task, JAX model and params, the port Predictor on the same weights,
    the request, the port artifact's directory)."""
    task = request.param
    samples = _request(task)
    jm = JAX_MODELS[task](layers=LAYERS, t_layers=T_LAYERS, hidden=H)
    params = jm.init(jax.random.PRNGKey(3), jcollate(samples[:2]))
    root = tmp_path_factory.mktemp(task)
    torch.save(state_dict_from_jax(params, task=task), root / "w.pt")
    port = _port(samples)
    pred = Predictor.from_torch(root / "w.pt", task=task, example=port[0],
                                layers=LAYERS, t_layers=T_LAYERS, hidden=H,
                                batch_size=4, device="cpu")
    pred.export(str(root / "art"), port)
    return task, (jm, params["params"]), pred, samples, root


def test_export_round_trip_equals_the_live_predictor(served):
    """The artifact served without the model code gives the live
    Predictor's bits at the artifact's geometry (one group at the
    request-wide buckets), and agrees with its bucketed groups."""
    task, _, pred, samples, root = served
    port = _port(samples)
    ep = ExportedPredictor(str(root / "art"), device="cpu")
    assert ep.batch_size == 4 and ep.clamp == (task == "edos")
    got = ep.predict(port)
    assert got.shape == (len(port), 201 if task == "edos" else 51)
    assert np.array_equal(got, pred.predict(port, bucketed=False))
    np.testing.assert_allclose(got, pred.predict(port), **TOL)
    # a request that is one short batch, and a single sample
    assert np.array_equal(ep.predict(port[:3]),
                          pred.predict(port, bucketed=False)[:3])
    assert np.array_equal(ep.predict(port[5:6]),
                          pred.predict(port, bucketed=False)[5:6])


def test_exported_matches_the_jax_exported_predictor(served, tmp_path):
    """The same request through the JAX package's export of the same
    weights."""
    task, (jm, params), _, samples, root = served
    jpred = JPredictor(jm, params, batch_size=4, clamp=(task == "edos"))
    jpred.export(str(tmp_path / "jart"), samples)
    want = JExported(str(tmp_path / "jart")).predict(samples)
    got = ExportedPredictor(str(root / "art"), device="cpu").predict(
        _port(samples))
    np.testing.assert_allclose(got, want, **TOL)


def test_serving_meta_has_the_jax_keys(served, tmp_path):
    task, (jm, params), _, samples, root = served
    with open(root / "art" / "serving_meta.json") as f:
        meta = json.load(f)
    JPredictor(jm, params, batch_size=4, clamp=(task == "edos")).export(
        str(tmp_path / "j"), samples)
    with open(tmp_path / "j" / "serving_meta.json") as f:
        jmeta = json.load(f)
    for key in ("batch_size", "atoms_per_graph", "edges_per_graph", "bins",
                "n_leaves", "clamp"):
        assert meta[key] == jmeta[key], key
    assert meta["device"] == "cpu" and meta["dtype"] == "float32"
    assert len(meta["leaves"]) == meta["n_leaves"]


def _dostpu_ops(path):
    program = torch.export.load(os.path.join(path, "forward.pt2"))
    return collections.Counter(
        str(n.target).split(".")[1] for n in program.graph.nodes
        if n.op == "call_function" and str(n.target).startswith("dostpu."))


def test_exported_graph_holds_one_op_a_kernel_launch(served):
    """3 fused message-passing and 6 attention ops (phDOS also 3 segment
    sums): one opaque node per kernel launch of a forward."""
    task, _, _, _, root = served
    want = {"fused_mp_edge_fwd": LAYERS, "attention_fwd": 3 * T_LAYERS}
    if task == "phdos":
        want["segment_sum"] = LAYERS
    assert _dostpu_ops(str(root / "art")) == want


@pytest.mark.parametrize("task", ["edos", "phdos"])
def test_fused_ln_export_holds_the_ln_fused_attention_op(task, tmp_path):
    from dostransformer_tpu_torch.models.registry import build_model

    port = _port(_request(task)[:4])
    model = build_model(task, layers=LAYERS, t_layers=T_LAYERS, hidden=H,
                        fuse_ln_attn=True, node_in=port[0].x.shape[1],
                        generator=torch.Generator().manual_seed(0))
    pred = Predictor(model, batch_size=4, clamp=(task == "edos"))
    pred.export(str(tmp_path / "art"), port)
    want = {"fused_mp_edge_fwd": LAYERS, "attention_ln_fwd": 3 * T_LAYERS}
    if task == "phdos":
        want["segment_sum"] = LAYERS
    assert _dostpu_ops(str(tmp_path / "art")) == want
    got = ExportedPredictor(str(tmp_path / "art"), device="cpu").predict(port)
    assert np.array_equal(got, pred.predict(port, bucketed=False))


def test_request_beyond_the_geometry_is_refused(served):
    task, _, _, _, root = served
    ep = ExportedPredictor(str(root / "art"), device="cpu")
    with pytest.raises(RequestError, match="shape envelope"):
        ep.predict(_port(MAKE[task](1, seed=1, min_atoms=30,
                                    max_atoms=31)))
    with pytest.raises(RequestError, match="empty request"):
        ep.predict([])


def test_exported_predictor_runs_on_the_card_by_default(served, monkeypatch):
    """An entry point: with no card visible it stops and names
    device="cpu"."""
    _, _, _, _, root = served
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ExportedPredictor(str(root / "art"))


PROBE = """
import json, sys
import torch
torch.set_num_threads(1)  # the test process's BLAS threads: the same sums
from dostransformer_tpu_torch.cli import main_predict
dos = main_predict.main(sys.argv[1:])
print(json.dumps({"shape": list(dos.shape), "modules": sorted(
    m for m in sys.modules
    if m.startswith(("dostransformer_tpu_torch.models",
                     "dostransformer_tpu_torch.train", "jax", "flax"))
    or m.split(".")[0] == "dostransformer_tpu")}))
"""


def test_served_in_a_process_without_the_model_code(served, tmp_path):
    """main_predict --from_exported in a fresh process imports no module of
    models/ or train/ (nor jax or the JAX package) and writes the live
    Predictor's predictions."""
    task, _, pred, samples, root = served
    port = _port(samples)
    save_samples(tmp_path / "in.npz", port)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-c", PROBE, "--from_exported", str(root / "art"),
         "--input", str(tmp_path / "in.npz"), "--output",
         str(tmp_path / "out.npz"), "--device", "cpu"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    found = json.loads(out.stdout.strip().splitlines()[-1])
    assert found["modules"] == []
    with np.load(tmp_path / "out.npz") as z:
        assert np.array_equal(z["dos"], pred.predict(port, bucketed=False))
        assert list(z["sample_id"]) == [s.sample_id for s in port]


@pytest.mark.parametrize("extra", [
    ["--export", "dir"],                      # the JAX package's conflicts
    ["--data_parallel"],
    ["--checkpoint_state", "best"],
    ["--torch_state_dict", "w.pt"],
    ["--metrics"],                            # --metrics needs --task
])
def test_cli_flag_conflicts_error(extra, capsys):
    """--from_exported with a flag it cannot honour errors loudly instead of
    silently ignoring the flag (the JAX package's
    test_cli_flag_conflicts_error, and the port's own)."""
    with pytest.raises(SystemExit) as exc:
        main_predict.main(["--from_exported", "whatever", "--input",
                           "in.npz", "--output", "out.npz", "--device",
                           "cpu", *extra])
    assert exc.value.code == 2
    assert "error" in capsys.readouterr().err


def test_cli_export_and_serve_a_checkpoint(tmp_path):
    """main_phdos writes a checkpoint; main_predict --export writes an
    artifact from it; --from_exported serves it with the checkpoint's
    predictions (the JAX package's test_cli_export_and_serve)."""
    from dostransformer_tpu_torch.cli import main_phdos

    ck = tmp_path / "ckpt"
    main_phdos.main([
        "--synthetic", "16", "--epochs", "1", "--eval", "1",
        "--hidden", str(H), "--layers", str(LAYERS), "--transformer",
        str(T_LAYERS), "--batch_size", "4", "--results_dir", str(tmp_path),
        "--checkpoint_dir", str(ck), "--checkpoint_every", "1",
        "--device", "cpu"])
    samples = _port(jsyn.synthetic_phdos_samples(10, seed=14, max_atoms=8))
    inp, out = tmp_path / "in.npz", tmp_path / "out.npz"
    save_samples(inp, samples)
    art = tmp_path / "artifact"
    common = ["--input", str(inp), "--output", str(out), "--batch_size", "4",
              "--device", "cpu"]
    model = ["--layers", str(LAYERS), "--transformer", str(T_LAYERS),
             "--hidden", str(H)]
    assert main_predict.main(["--task", "phdos", "--checkpoint_dir", str(ck),
                              "--export", str(art), *model, *common]) is None
    assert sorted(os.listdir(art)) == ["forward.pt2", "serving_meta.json"]
    dos_ck = main_predict.main(["--task", "phdos", "--checkpoint_dir",
                                str(ck), *model, *common])
    dos_art = main_predict.main(["--from_exported", str(art), *common])
    # one atom bucket (up to 8 atoms): one geometry on both paths
    assert np.array_equal(dos_art, dos_ck)
    with np.load(out) as z:
        assert list(z["sample_id"]) == [s.sample_id for s in samples]


def _op_cases():
    """(name, op, arguments) of every dostpu op at a small shape."""
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)
    b, a, e, m, h, lq, lk, d = 2, 5, 7, 8, 4, 6, 5, 8
    idx = lambda: torch.randint(0, a, (b, e), generator=g, dtype=torch.int32)
    mask = torch.rand(b, lk, generator=g) > 0.3
    bias = attention.key_bias(mask)

    def cases(dtype):
        f = lambda t: t.to(dtype)
        return [
            ("fused_mp_edge_fwd", fused_mp.fused_mp_edge_op,
             (f(r(b, a, m)), f(r(b, a, m)), f(r(b, e, m)), idx(), idx(),
              torch.ones(b, e), r(m), r(m), torch.tensor([0.2]), r(h, m),
              r(h))),
            ("attention_fwd", attention.attention_fwd_op,
             (f(r(b, lq, d)), f(r(b, lk, d)), f(r(b, lk, d)), bias, False)),
            ("attention_fwd+stats", attention.attention_fwd_op,
             (f(r(b, lq, d)), f(r(b, lk, d)), f(r(b, lk, d)), bias, True)),
            ("attention_ln_fwd", attention.attention_ln_fwd_op,
             (f(r(b, lq, d)), f(r(b, lk, d)), f(r(b, lk, d)), r(d), r(d),
              mask)),
            ("attention_ln_fwd, no mask", attention.attention_ln_fwd_op,
             (f(r(b, lq, d)), f(r(b, lq, d)), f(r(b, lq, d)), r(d), r(d),
              None)),
            ("segment_sum", segment.segment_sum_op,
             (f(r(b, e, 3)), idx(), a)),
        ]
    return {(name, str(dtype).split(".")[1]): (op, args)
            for dtype in (torch.float32, torch.bfloat16)
            for name, op, args in cases(dtype)}


OP_CASES = _op_cases()


@pytest.mark.parametrize("case", sorted(OP_CASES), ids=lambda c: " ".join(c))
def test_op_fake_matches_its_cpu_implementation(case):
    """Each op's fake implementation (what torch.export traces) gives the
    shapes and dtypes its CPU implementation returns."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    op, args = OP_CASES[case]
    real = op(*args)
    with FakeTensorMode() as mode:
        fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                    for a in args))
    real = real if isinstance(real, tuple) else (real,)
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert [(tuple(t.shape), t.dtype) for t in fake] == [
        (tuple(t.shape), t.dtype) for t in real]
    torch.library.opcheck(op, args, test_utils=("test_schema",
                                                 "test_faketensor"))


@pytest.mark.parametrize("source", ["weights", "checkpoint", "artifact"])
@pytest.mark.parametrize("cli", ["main_predict", "main_serve"])
def test_cli_source_builds_its_predictor(cli, source, monkeypatch, tmp_path):
    """main_predict and main_serve build their predictor through one loader:
    each weight source reaches its constructor with the task, the
    model-shape flags and the device, and serves through graphs (the
    default; graphs=False is the Python API's eager oracle only)."""
    from dostransformer_tpu_torch import serve, serve_dispatch
    from dostransformer_tpu_torch.cli import main_serve

    seen = {}

    class Stop(Exception):
        pass

    def record(what):
        def build(*args, **kw):
            seen.update(what=what, args=args, **kw)
            raise Stop
        return build

    monkeypatch.setattr(serve.Predictor, "from_torch", record("from_torch"))
    monkeypatch.setattr(serve.Predictor, "from_checkpoint",
                        record("from_checkpoint"))
    monkeypatch.setattr(serve_dispatch, "ExportedPredictor",
                        record("exported"))
    save_samples(tmp_path / "in.npz",
                 _port(jsyn.synthetic_phdos_samples(2, seed=1)))
    argv = {"weights": ["--task", "phdos", "--torch_state_dict", "w.pt"],
            "checkpoint": ["--task", "phdos", "--checkpoint_dir", "ck",
                           "--checkpoint_state", "latest"],
            "artifact": ["--from_exported", "art"]}[source]
    argv += ["--hidden", "48", "--batch_size", "4", "--device", "cpu"]
    if cli == "main_predict":
        run = main_predict.main
        argv += ["--input", str(tmp_path / "in.npz"), "--output",
                 str(tmp_path / "out.npz")]
    else:
        run = main_serve.build_server
        if source != "artifact":
            argv += ["--example", str(tmp_path / "in.npz")]
    with pytest.raises(Stop):
        run(argv)
    assert seen["device"] == torch.device("cpu")
    assert "graphs" not in seen
    if source == "artifact":
        assert (seen["what"], seen["args"]) == ("exported", ("art",))
        return
    assert seen["what"] == {"weights": "from_torch",
                            "checkpoint": "from_checkpoint"}[source]
    assert seen["args"] == ({"weights": "w.pt", "checkpoint": "ck"}[source],)
    assert (seen["task"], seen["hidden"], seen["batch_size"]) == (
        "phdos", 48, 4)
    assert seen["example"].n_nodes == _port(
        jsyn.synthetic_phdos_samples(2, seed=1))[0].n_nodes
    if source == "checkpoint":
        assert seen["prefer"] == "latest"
