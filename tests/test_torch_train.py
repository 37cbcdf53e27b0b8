"""The PyTorch port's training slice against the JAX package, on the CPU:
loss, eval metrics, AdamW, whole-model gradients, train steps, splits, the
shuffled loader and the main_edos entry point. Small size: hidden 32, 2
processors, 1 transformer layer per stack, batches of 3 samples plus one
dummy graph; inputs from numpy with a seed; f32 on both sides. The JAX model
runs its Pallas kernels in interpret mode (tests/conftest.py), the fused
message-passing backward kernel included.

Tolerances, each stated where it is used: 1e-6 for the loss and metrics
(one reduction), bit-equal for AdamW's stored bf16 first moment, 1e-4 of
each gradient tensor's largest element for whole-model gradients (f32
through ~10 layers of products summed in another order)."""

import dataclasses
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from dostransformer_tpu.cli.common import _write_results_line  # noqa: E402
from dostransformer_tpu.config import TrainConfig as JConfig  # noqa: E402
from dostransformer_tpu.config import exp_get_name as jexp_get_name  # noqa: E402
from dostransformer_tpu.data import collate as jcollate  # noqa: E402
from dostransformer_tpu.data import datasets as jdatasets  # noqa: E402
from dostransformer_tpu.data import synthetic as jsyn  # noqa: E402
from dostransformer_tpu.models import DOSTransformerEDOS as JModel  # noqa: E402
from dostransformer_tpu.train import loss as jloss  # noqa: E402
from dostransformer_tpu.train import metrics as jmetrics  # noqa: E402
from dostransformer_tpu.train.trainer import Trainer as JTrainer  # noqa: E402
from dostransformer_tpu.train.trainer import TrainState  # noqa: E402
from dostransformer_tpu.train.trainer import make_adamw as jmake_adamw  # noqa: E402
from dostransformer_tpu_torch import config  # noqa: E402
from dostransformer_tpu_torch.cli import main_edos, main_phdos  # noqa: E402
from dostransformer_tpu_torch.data import datasets, graph, synthetic  # noqa: E402
from dostransformer_tpu_torch.models.dostransformer import (  # noqa: E402
    DOSTransformerEDOS,
)
from dostransformer_tpu_torch.models.import_torch import (  # noqa: E402
    state_dict_from_jax,
)
from dostransformer_tpu_torch.train import loss, metrics, optim  # noqa: E402
from dostransformer_tpu_torch.train.trainer import Trainer  # noqa: E402

H = 32
SMALL_TOL = dict(rtol=1e-6, atol=1e-6)


def _port(samples):
    return [graph.GraphSample(**dataclasses.asdict(s)) for s in samples]


def _loss_inputs(seed=0):
    rng = np.random.RandomState(seed)
    pg, ps = (rng.randn(4, 11).astype(np.float32) for _ in range(2))
    y = rng.randn(4, 11).astype(np.float32)  # negatives: clamped in training
    mask = np.array([1, 1, 1, 0], np.float32)
    pg[-1] = ps[-1] = y[-1] = 0.0  # a dummy graph whose MSE is exactly 0
    return pg, ps, y, mask


@pytest.mark.parametrize("two_heads", [True, False])
@pytest.mark.parametrize("clamp", [True, False])
def test_dos_loss_value_and_grad_match_jax(two_heads, clamp):
    pg, ps, y, mask = _loss_inputs()
    ps_j = jnp.asarray(ps) if two_heads else None

    def jf(pg, ps):
        return jloss.dos_loss(pg, ps if two_heads else None, jnp.asarray(y),
                              jnp.asarray(mask), 0.7, clamp)[0]

    want = jf(jnp.asarray(pg), ps_j)
    want_g = jax.grad(jf, argnums=(0, 1) if two_heads else 0)(
        jnp.asarray(pg), ps_j)
    want_g = want_g if two_heads else (want_g,)
    tpg, tps = (torch.from_numpy(t).requires_grad_() for t in (pg, ps))
    got, parts = loss.dos_loss(tpg, tps if two_heads else None,
                               torch.from_numpy(y), torch.from_numpy(mask),
                               0.7, clamp)
    _, jparts = jloss.dos_loss(jnp.asarray(pg), ps_j, jnp.asarray(y),
                               jnp.asarray(mask), 0.7, clamp)
    np.testing.assert_allclose(got.item(), float(want), **SMALL_TOL)
    for k in ("rmse_global", "rmse_system"):
        np.testing.assert_allclose(parts[k].item(), float(jparts[k]),
                                   **SMALL_TOL)
    got.backward()
    leaves = (tpg, tps) if two_heads else (tpg,)
    for t, w in zip(leaves, want_g):
        assert torch.isfinite(t.grad).all()  # the safe sqrt: no 0 * inf
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   **SMALL_TOL)
    assert torch.equal(tpg.grad[-1], torch.zeros(11))


def test_eval_metrics_and_accumulator_match_jax():
    acc, jacc = metrics.MetricAccumulator(), jmetrics.MetricAccumulator()
    for seed in (1, 2):
        _, ps, y, mask = _loss_inputs(seed)
        got = metrics.eval_metrics(torch.from_numpy(ps), torch.from_numpy(y),
                                   graph_mask=torch.from_numpy(mask))
        want = jmetrics.eval_metrics(jnp.asarray(ps), jnp.asarray(y),
                                     graph_mask=jnp.asarray(mask))
        assert set(got) == set(want)
        for k in got:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       err_msg=k, **SMALL_TOL)
        acc.update(got)
        jacc.update({k: np.asarray(v) for k, v in want.items()})
    res, jres = acc.result(), jacc.result()
    assert set(res) == set(jres)
    for k in res:
        np.testing.assert_allclose(res[k], jres[k], err_msg=k, **SMALL_TOL)
    with pytest.raises(ValueError):
        metrics.MetricAccumulator().result()


def test_adamw_three_steps_match_make_adamw():
    """Params after 3 steps and the stored bf16 first moment, against the
    JAX package's make_adamw() under jit (as its Trainer runs it): the
    moment bit-equal, params to 1e-8."""
    rng = np.random.RandomState(3)
    shapes = {"w": (6, 5), "b": (5,), "s": (1,)}
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * 10 ** rng.uniform(-4, 0)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    tx = jmake_adamw()
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    update = jax.jit(tx.update)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    opt = optim.make_adamw(tp.values())
    for g in grads:
        u, state = update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = jax.tree.map(lambda p, d: p + d, jp, u)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    assert opt.step_count == 3
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-8, err_msg=k)
        mu, nu = opt.moments(tp[k])
        assert mu.dtype == torch.bfloat16 and nu.dtype == torch.float32
        np.testing.assert_array_equal(
            mu.float().numpy(),
            np.asarray(state[0].mu[k].astype(jnp.float32)), err_msg=k)
        np.testing.assert_allclose(nu.numpy(), np.asarray(state[0].nu[k]),
                                   rtol=1e-6, atol=0, err_msg=k)


@pytest.mark.parametrize("kwargs", [{"grad_clip": -1.0}, {"warmup_steps": -5},
                                    {"cosine_decay_steps": -9}])
def test_make_adamw_extensions_raise(kwargs):
    """The extensions are ported (tests/test_torch_runtime.py holds them to
    the JAX make_adamw); a negative horizon or norm raises, naming it."""
    with pytest.raises(ValueError, match=next(iter(kwargs))):
        optim.make_adamw([torch.nn.Parameter(torch.zeros(2))], **kwargs)


def _train_batches(n_batches=3, seed=11):
    """n same-shape batches of 3 samples + 1 dummy graph, JAX and port."""
    samples = jsyn.synthetic_edos_learnable(3 * n_batches, seed=seed)
    a = graph.bucket_size(max(s.n_nodes for s in samples))
    e = graph.bucket_size(max(s.n_edges for s in samples))
    groups = [samples[3 * i: 3 * i + 3] for i in range(n_batches)]
    kw = dict(atoms_per_graph=a, edges_per_graph=e, num_graphs=4)
    return ([jcollate(g, **kw) for g in groups],
            [graph.collate(_port(g), **kw) for g in groups])


def _scaled_close(got: torch.Tensor, want: np.ndarray, rel: float, name):
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= rel * max(1.0, float(np.abs(want).max())), (name, err)


@pytest.fixture(scope="module")
def jax_model():
    jb, _ = _train_batches()
    jm = JModel(layers=2, t_layers=1, hidden=H, use_pallas=True,
                use_fused_mp=True)
    return jm, jax.jit(jm.init)(jax.random.PRNGKey(0), jb[0])["params"]


def _port_model(params):
    tm = DOSTransformerEDOS(layers=2, t_layers=1, hidden=H)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    return tm


def test_model_gradients_match_jax_grad(jax_model):
    """Every parameter's gradient of the training loss, against jax.grad of
    the JAX Trainer's loss: tolerance 1e-4 x max(1, max|grad|) per tensor."""
    jm, params = jax_model
    jb, tb = _train_batches(1)

    def loss_fn(p):
        dg, _, ds = jm.apply({"params": p}, jb[0], deterministic=True)
        return jloss.dos_loss(dg, ds, jb[0].y, jb[0].graph_mask, 1.0, True)[0]

    want_loss, want = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = state_dict_from_jax(want)
    tm = _port_model(params)
    dg, _, ds = tm(tb[0])
    got_loss, _ = loss.dos_loss(dg, ds, tb[0].y, tb[0].graph_mask)
    got_loss.backward()
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
    named = dict(tm.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        assert p.grad is not None, name
        _scaled_close(p.grad, want[name].numpy(), 1e-4, name)


def test_three_train_steps_match_jax_trainer(jax_model):
    """Per-step losses (rtol 1e-5) and the params after 3 steps (atol 1e-6,
    1% of one AdamW step at lr 1e-4) against the JAX Trainer.train_step."""
    jm, params = jax_model
    jb, tb = _train_batches()
    jt = JTrainer(jm, donate=False)
    state = TrainState.create(params, jt.tx, jax.random.PRNGKey(1))
    tm = _port_model(params)
    trainer = Trainer(tm)
    for j, t in zip(jb, tb):
        state, jout = jt.train_step(state, j)
        out = trainer.train_step(t)
        assert all(v.dim() == 0 for v in out.values())
        for k in ("loss", "rmse_global", "rmse_system"):
            np.testing.assert_allclose(out[k].item(), float(jout[k]),
                                       rtol=1e-5, err_msg=k)
    want = state_dict_from_jax(state.params)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)
    # eval on the real graphs: a dummy graph's outputs differ once the LN
    # biases have moved, because the JAX padded attention form averages its
    # fully masked rows over 128 lane-padded keys (ROADMAP queue 3)
    m = trainer.eval_step(tb[0])
    jm_out = jt.eval_step(state.params, jb[0])
    for k in ("rmse", "mae", "preds", "embeddings", "preds_global"):
        _scaled_close(m[k][:3], np.asarray(jm_out[k])[:3], 1e-4, k)


def test_splits_match_jax():
    samples = synthetic.synthetic_edos_samples(23, seed=4, max_atoms=6)
    ids = lambda ss: [s.sample_id for s in ss]
    for rs in (0, 5):
        got = datasets.edos_random_split(samples, rs)
        want = jdatasets.edos_random_split(samples, rs)
        assert [ids(g) for g in got] == [ids(w) for w in want]
        got = datasets.edos_ood_split(samples[:10], samples[10:], rs)
        want = jdatasets.edos_ood_split(samples[:10], samples[10:], rs)
        assert [ids(g) for g in got] == [ids(w) for w in want]
    with pytest.raises(ValueError):
        datasets.train_test_split([1], 0.5, 0)


@pytest.mark.parametrize("drop_last", [False, True])
def test_shuffled_loader_gives_the_jax_batches(drop_last):
    """Same seed, same batches, epoch after epoch (exact: numpy on both)."""
    samples = jsyn.synthetic_edos_samples(11, seed=6, max_atoms=8)
    kw = dict(batch_size=4, shuffle=True, seed=3, drop_last=drop_last)
    ours = datasets.GraphLoader(_port(samples), **kw)
    ref = jdatasets.GraphLoader(samples, numpy=True, **kw)
    assert len(ours) == len(ref) == (2 if drop_last else 3)
    fields = [f.name for f in dataclasses.fields(graph.GraphBatch)]
    for _ in range(2):
        batches = list(ours)
        assert len(batches) == len(ours)
        for tb, jb in zip(batches, ref):
            for name in fields:
                want = getattr(jb, name)
                if want is None:
                    assert getattr(tb, name) is None
                else:
                    np.testing.assert_array_equal(
                        getattr(tb, name).numpy(), want, err_msg=name)


def test_synthetic_learnable_matches_jax():
    for a, b in zip(synthetic.synthetic_edos_learnable(3, seed=2),
                    jsyn.synthetic_edos_learnable(3, seed=2)):
        np.testing.assert_array_equal(a.y, b.y)
        np.testing.assert_array_equal(a.x, b.x)


def test_main_edos_trains_on_the_cpu(tmp_path):
    log = tmp_path / "run.jsonl"
    result = main_edos.main([
        "--synthetic", "20", "--synthetic_learnable", "--epochs", "2",
        "--eval", "1", "--hidden", str(H), "--layers", "2",
        "--transformer", "1", "--device", "cpu", "--host_loader",
        "--debug_nans",
        "--results_dir", str(tmp_path), "--log_jsonl", str(log)])
    assert set(result["test"]) == {"rmse", "mse", "mae", "r2"}
    assert all(np.isfinite(v) for v in result["test"].values())
    assert result["best_epoch"] in (1, 2) and result["samples_per_sec"] > 0
    assert len(log.read_text().splitlines()) >= 4
    # the experiments block is byte-identical to the JAX package's
    cfg = config.TrainConfig(epochs=2, eval_every=1, hidden=H, layers=2,
                             transformer=1)
    jcfg = JConfig(epochs=2, eval_every=1, hidden=H, layers=2, transformer=1)
    assert config.exp_get_name(cfg) == jexp_get_name(jcfg)
    _write_results_line("edos", jcfg, result, str(tmp_path / "jax"))
    name = "experiments_DOSTransformer.txt"
    assert ((tmp_path / name).read_bytes()
            == (tmp_path / "jax" / name).read_bytes())


def _bf16_cli_run(tmp_path, cli, task, extra):
    """A bf16 run of a training CLI on the CPU at a tiny size, 2 epochs:
    finite epoch losses and test metrics, and the experiments block
    byte-identical to the JAX package's for the same flags (the compute
    dtype is not part of the run's name)."""
    log = tmp_path / "run.jsonl"
    result = cli.main([
        "--synthetic", "16", "--synthetic_learnable", "--epochs", "2",
        "--eval", "1", "--hidden", str(H), "--layers", "2",
        "--transformer", "1", "--batch_size", "4", "--device", "cpu",
        "--dtype", "bfloat16", *extra, "--results_dir", str(tmp_path),
        "--log_jsonl", str(log)])
    losses = [json.loads(line)["loss"] for line in log.read_text().splitlines()
              if '"loss"' in line]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert all(np.isfinite(v) for v in result["test"].values())
    kw = dict(epochs=2, eval_every=1, hidden=H, layers=2, transformer=1,
              batch_size=4, dtype="bfloat16")
    cfg, jcfg = config.TrainConfig(**kw), JConfig(**kw)
    assert config.exp_get_name(cfg) == jexp_get_name(jcfg)
    _write_results_line(task, jcfg, result, str(tmp_path / "jax"))
    name = "experiments_DOSTransformer.txt"
    assert ((tmp_path / name).read_bytes()
            == (tmp_path / "jax" / name).read_bytes())


def test_main_edos_trains_in_bf16_on_the_cpu(tmp_path):
    """main_edos --dtype bfloat16 --device cpu (the device-resident
    dataset, the plain versions forward and backward)."""
    _bf16_cli_run(tmp_path, main_edos, "edos", [])


def test_main_phdos_trains_in_bf16_with_bf16_data_on_the_cpu(tmp_path):
    """main_phdos --dtype bfloat16 --bf16_data --device cpu: features
    stored in bf16, cast to the compute dtype by the model."""
    _bf16_cli_run(tmp_path, main_phdos, "phdos", ["--bf16_data"])


def test_main_edos_trains_in_bf16_with_the_host_loader(tmp_path):
    """main_edos --dtype bfloat16 --host_loader --remat: batches collated
    on the host, each processor and transformer layer recomputed in the
    backward in bf16."""
    _bf16_cli_run(tmp_path, main_edos, "edos", ["--host_loader", "--remat"])


_PORTED_NOW = (["--x64"], ["--attn_drop", "0.1"])


def _tiny_edos_run(tmp_path, *flags):
    return main_edos.main(["--synthetic", "12", "--epochs", "1", "--eval",
                           "1", "--hidden", "16", "--layers", "1",
                           "--transformer", "1", "--batch_size", "4",
                           "--device", "cpu", "--results_dir",
                           str(tmp_path), *flags])


@pytest.mark.parametrize("flags", [
    ["--x64"], ["--compile_cache", "cc"], ["--pad_bins", "256"],
    ["--attn_drop", "0.1"], ["--use_pallas"], ["--no_pallas"]])
def test_main_edos_rejects_unported_flags(flags, capsys, tmp_path):
    """The do-not-port flags refuse, naming the list in ROADMAP.md; --x64
    and --attn_drop (ported) train."""
    if flags in _PORTED_NOW:
        result = _tiny_edos_run(tmp_path, *flags)
        assert all(np.isfinite(v) for v in result["test"].values())
        return
    with pytest.raises(SystemExit):
        main_edos.main(["--synthetic", "8", *flags])
    assert "ROADMAP" in capsys.readouterr().err


def test_main_edos_rejects_x64_and_attn_drop_naming_their_items(tmp_path):
    """--x64 and --attn_drop > 0 (ROADMAP items 5 and 2, ported) run
    together: finite losses and metrics."""
    result = _tiny_edos_run(tmp_path, *_PORTED_NOW[0], *_PORTED_NOW[1])
    assert all(np.isfinite(v) for v in result["test"].values())


def test_main_edos_data_parallel_in_one_process_trains_as_without(tmp_path):
    """--data_parallel in a plain single process (no launcher): nothing to
    split over, so the run is the run without the flag, loss for loss (the
    two-process runs are in tests/test_torch_parallel_train.py)."""
    argv = ["--synthetic", "16", "--synthetic_learnable", "--epochs", "2",
            "--eval", "1", "--hidden", "16", "--layers", "1",
            "--transformer", "1", "--batch_size", "4", "--device", "cpu"]
    runs = {}
    for name, extra in (("plain", []), ("dp", ["--data_parallel"])):
        log = tmp_path / f"{name}.jsonl"
        runs[name] = main_edos.main([*argv, "--results_dir",
                                     str(tmp_path / name), "--log_jsonl",
                                     str(log), *extra])
        runs[name]["losses"] = [json.loads(line).get("loss") for line in
                                log.read_text().splitlines()]
    assert runs["dp"]["losses"] == runs["plain"]["losses"]
    assert runs["dp"]["test"] == runs["plain"]["test"]


def test_main_edos_tensor_parallel_needs_its_processes(capsys):
    """--tensor_parallel 2 in a plain single process: there is no second
    rank to shard over; it says how to launch two."""
    with pytest.raises(SystemExit, match="torchrun --nproc_per_node 2"):
        main_edos.main(["--synthetic", "8", "--device", "cpu",
                        "--tensor_parallel", "2"])
