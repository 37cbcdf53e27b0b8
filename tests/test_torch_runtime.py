"""The PyTorch port's training runtime against the JAX package, on the CPU:
the optimizer's clipping and schedules, the device-resident datasets and
their epochs, eval epochs, eval artifacts, TensorBoard files, remat,
checkpoints (round trip, resume, preemption, the best model's ordinal) and
serving from a checkpoint. Small sizes: hidden 16-32, 1-2 layers, f32. The
JAX model runs its plain path (use_pallas=False), as its own tests run it on
the CPU where the kernels are not the point.

Tolerances, each stated where it is used: parameters of the optimizer rtol
1e-6 (as tests/test_finetune_knobs.py); an epoch's losses and parameters
rtol 1e-5 (f32 through a few layers of products summed in another order);
artifacts, TensorBoard scalars and a resumed run's losses exact."""

import dataclasses
import json
import os
import signal

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from dostransformer_tpu.cli import main_predict as jax_main_predict  # noqa: E402
from dostransformer_tpu.data import collate as jcollate  # noqa: E402
from dostransformer_tpu.data import synthetic as jsyn  # noqa: E402
from dostransformer_tpu.models import DOSTransformerPhDOS as JPhDOS  # noqa: E402
from dostransformer_tpu.train import tensorboard as jtb  # noqa: E402
from dostransformer_tpu.train.artifacts import EvalArtifacts as JArtifacts  # noqa: E402
from dostransformer_tpu.train.device_dataset import (  # noqa: E402
    BucketedDeviceDataset as JBucketed,
)
from dostransformer_tpu.train.device_dataset import (  # noqa: E402
    DeviceDataset as JDeviceDataset,
)
from dostransformer_tpu.train.trainer import Trainer as JTrainer  # noqa: E402
from dostransformer_tpu.train.trainer import TrainState  # noqa: E402
from dostransformer_tpu.train.trainer import make_adamw as jmake_adamw  # noqa: E402
from dostransformer_tpu_torch.cli import common, main_edos, main_phdos  # noqa: E402
from dostransformer_tpu_torch.cli import main_predict  # noqa: E402
from dostransformer_tpu_torch.data import graph  # noqa: E402
from dostransformer_tpu_torch.data.io import save_samples  # noqa: E402
from dostransformer_tpu_torch.models.import_torch import (  # noqa: E402
    state_dict_from_jax,
)
from dostransformer_tpu_torch.models.registry import build_model  # noqa: E402
from dostransformer_tpu_torch.serve import Predictor  # noqa: E402
from dostransformer_tpu_torch.train import optim, tensorboard  # noqa: E402
from dostransformer_tpu_torch.train.artifacts import EvalArtifacts  # noqa: E402
from dostransformer_tpu_torch.train.checkpoint import (  # noqa: E402
    CheckpointManager,
    best_dir,
)
from dostransformer_tpu_torch.train.device_dataset import (  # noqa: E402
    BucketedDeviceDataset,
    DeviceDataset,
    epoch_perm,
    shuffle_seed,
)
from dostransformer_tpu_torch.train.early_stop import BestTracker  # noqa: E402
from dostransformer_tpu_torch.train.trainer import Trainer  # noqa: E402

H = 16


def _port(samples):
    return [graph.GraphSample(**dataclasses.asdict(s)) for s in samples]


# --- the optimizer's extensions ---------------------------------------------

OPT_CASES = [{"grad_clip": 0.5}, {"warmup_steps": 3},
             {"cosine_decay_steps": 5},
             {"warmup_steps": 2, "cosine_decay_steps": 4},
             {"grad_clip": 2.0, "warmup_steps": 2, "cosine_decay_steps": 3}]
OPT_IDS = ["clip", "warmup", "cosine", "warmup+cosine", "all"]


@pytest.mark.parametrize("kwargs", OPT_CASES, ids=OPT_IDS)
def test_make_adamw_extensions_match_jax(kwargs):
    """Six steps of the port's make_adamw against the JAX make_adamw under
    jit, from the same parameters and gradients (some above the clip norm,
    some below): every parameter after every step within rtol 1e-6 (atol
    1e-7, 1e-6 of the parameters' scale: the clip's global norm sums the
    squares in another order), the step count 6."""
    rng = np.random.RandomState(3)
    shapes = {"w": (6, 5), "b": (5,), "s": (1,)}
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * 10 ** rng.uniform(-2, 0.5))
              .astype(np.float32) for k, s in shapes.items()}
             for _ in range(6)]
    tx = jmake_adamw(1e-2, **kwargs)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    update = jax.jit(tx.update)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    opt = optim.make_adamw(tp.values(), 1e-2, **kwargs)
    for g in grads:
        u, state = update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = jax.tree.map(lambda p, d: p + d, jp, u)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=k)
    assert opt.step_count == 6


@pytest.mark.parametrize("warmup, cosine", [(4, 0), (0, 7), (3, 6)])
def test_learning_rate_is_the_optax_schedule(warmup, cosine):
    """The rate at each count (before the step) against the optax schedule
    the JAX make_adamw builds, in f32 (rtol 1e-6)."""
    lr = 3e-3
    if cosine:
        sched = optax.warmup_cosine_decay_schedule(
            0.0 if warmup else lr, lr, warmup, warmup + cosine, 0.0)
    else:
        sched = optax.join_schedules([optax.linear_schedule(0.0, lr, warmup),
                                      optax.constant_schedule(lr)], [warmup])
    for count in range(warmup + cosine + 3):
        want = float(sched(jnp.asarray(count, jnp.int32)))
        got = optim.learning_rate(count, lr, warmup, cosine)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12,
                                   err_msg=str(count))


# --- the device-resident datasets --------------------------------------------


@pytest.fixture(scope="module")
def phdos_setup():
    """A small phDOS corpus spanning two atom buckets, the JAX model
    (plain path) and its initial parameters."""
    samples = jsyn.synthetic_phdos_learnable(14, seed=4)
    jm = JPhDOS(layers=1, t_layers=1, hidden=H, use_pallas=False,
                use_fused_mp=False)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jcollate(samples[:2]))["params"]
    return samples, jm, params


def _jax_perm(key, steps, batch):
    """The JAX Trainer's ``_epoch_perm`` of ``key`` (train/trainer.py)."""
    sub = jax.random.split(key)[1]
    return np.array(jax.random.permutation(sub, steps * batch)
                      .reshape(steps, batch))


def _port_trainer(params):
    model = build_model("phdos", layers=1, t_layers=1, hidden=H)
    model.load_state_dict(state_dict_from_jax(params, task="phdos"),
                          strict=True)
    return Trainer(model, clamp_targets=False, eval_clamp=False)


@pytest.mark.parametrize("bucketed", [False, True], ids=["flat", "bucketed"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_device_epoch_matches_jax(phdos_setup, bucketed, bf16):
    """One epoch over the device-resident dataset (flat, or by atom bucket),
    features stored f32 or bf16, fed the JAX epoch's own permutations: the
    per-step losses within rtol 1e-5 and every parameter after the epoch
    within rtol 1e-5 (atol 1e-6, 1% of one AdamW step at lr 1e-4)."""
    samples, jm, params = phdos_setup
    jt = JTrainer(jm, clamp_targets=False, eval_clamp=False, donate=False)
    state = TrainState.create(params, jt.tx, jax.random.PRNGKey(1))
    rng = jax.random.PRNGKey(5)
    jdtype, tdtype = ((jnp.bfloat16, torch.bfloat16) if bf16
                      else (None, None))
    trainer = _port_trainer(params)
    if bucketed:
        jdata = JBucketed.from_samples(samples, 4, storage_dtype=jdtype)
        assert len(jdata.buckets) >= 2
        state, want, _ = jt.train_epoch_buckets(state, jdata, rng)
        perms = [_jax_perm(jax.random.fold_in(rng, i), d.steps_per_epoch, 4)
                 for i, (_, d) in enumerate(jdata.buckets)]
        data = BucketedDeviceDataset.from_samples(
            _port(samples), 4, storage_dtype=tdtype, device="cpu")
        assert [a for a, _ in data.buckets] == [a for a, _ in jdata.buckets]
        got = trainer.train_epoch_buckets(data, perms=perms)
    else:
        jdata = JDeviceDataset.from_samples(samples, 4, storage_dtype=jdtype)
        state, want, _ = jt.train_epoch_device(state, jdata, rng)
        data = DeviceDataset.from_samples(_port(samples), 4,
                                          storage_dtype=tdtype, device="cpu")
        assert data.nbytes() > 0 and data.steps_per_epoch == 4
        got = trainer.train_epoch_device(
            data, perm=_jax_perm(rng, data.steps_per_epoch, 4))
    if bf16:
        assert data.num_samples == 16
        stored = (data.buckets[0][1] if bucketed else data).data
        assert stored.nodes.dtype == torch.bfloat16
        assert stored.y.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    ref = state_dict_from_jax(state.params, task="phdos")
    for name, p in trainer.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_epoch_order_is_a_pure_function_of_seed_and_epoch():
    """The shuffle of an epoch depends on (seed, epoch[, bucket]) alone:
    two calls agree, other epochs, seeds and buckets differ, every sample
    appears once; train_epochs_device replays train_epoch_device."""
    a = epoch_perm(16, 4, seed=3, epoch=2)
    assert torch.equal(a, epoch_perm(16, 4, seed=3, epoch=2))
    assert sorted(a.flatten().tolist()) == list(range(16))
    others = [epoch_perm(16, 4, 3, 1), epoch_perm(16, 4, 4, 2),
              epoch_perm(16, 4, 3, 2, bucket=0)]
    assert all(not torch.equal(a, o) for o in others)
    assert len({shuffle_seed(s, e, b) for s in range(3) for e in range(3)
                for b in (None, 0, 1)}) == 27
    samples = _port(jsyn.synthetic_phdos_learnable(8, seed=1))
    losses = []
    for fn in ("one", "many"):
        model = build_model("phdos", layers=1, t_layers=1, hidden=H,
                            generator=torch.Generator().manual_seed(2))
        trainer = Trainer(model, clamp_targets=False)
        data = DeviceDataset.from_samples(samples, 4, device="cpu")
        if fn == "one":
            losses.append(torch.stack([trainer.train_epoch_device(data, 7, e)
                                       for e in range(3)]))
        else:
            losses.append(trainer.train_epochs_device(data, 7, range(3)))
    assert losses[0].shape == (3, 2)
    assert torch.equal(losses[0], losses[1])


def test_eval_epoch_matches_jax(phdos_setup):
    """Trainer.eval_epoch over same-shape batches against the JAX
    Trainer.eval_epoch: every output on the real graphs within rtol 1e-5
    (atol 1e-6)."""
    samples, jm, params = phdos_setup
    groups = [samples[0:3], samples[3:6]]
    kw = dict(atoms_per_graph=graph.bucket_size(max(s.n_nodes
                                                    for s in samples[:6])),
              edges_per_graph=graph.bucket_size(max(s.n_edges
                                                    for s in samples[:6])),
              num_graphs=4)
    jt = JTrainer(jm, clamp_targets=False, eval_clamp=False, donate=False)
    want = jt.eval_epoch(params, [jcollate(g, **kw) for g in groups])
    got = _port_trainer(params).eval_epoch(
        [graph.collate(_port(g), **kw) for g in groups])
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.shape[0] == 2, k
        np.testing.assert_allclose(v[:, :3].numpy(), np.asarray(want[k])[:, :3],
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_eval_artifacts_match_jax(tmp_path):
    """The same eval outputs (with a dummy graph) through both
    EvalArtifacts: the same arrays, and npz files with the same entries."""
    rng = np.random.RandomState(0)
    outs = []
    for start in (0, 4):
        mask = np.array([1, 1, 1, 0], np.float32)
        outs.append(({"preds": rng.randn(4, 5).astype(np.float32),
                      "preds_global": rng.randn(4, 5).astype(np.float32),
                      "y": rng.randn(4, 5).astype(np.float32),
                      "embeddings": rng.randn(4, 3).astype(np.float32)},
                     mask, np.arange(start, start + 4, dtype=np.int32)))
    ours, ref = EvalArtifacts(), JArtifacts()
    for m, mask, ids in outs:
        jb = type("B", (), {"graph_mask": mask, "sample_id": ids})
        tb = type("B", (), {"graph_mask": torch.from_numpy(mask),
                            "sample_id": torch.from_numpy(ids)})
        ref.update(m, jb)
        ours.update({k: torch.from_numpy(v) for k, v in m.items()}, tb)
    got, want = ours.result(), ref.result()
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    mp_ids = [f"mp-{i}" for i in range(8)]
    ours.save(str(tmp_path / "ours.npz"), mp_ids=mp_ids)
    ref.save(str(tmp_path / "ref.npz"), mp_ids=mp_ids)
    with np.load(tmp_path / "ours.npz") as a, np.load(tmp_path / "ref.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("writer_side", ["port", "jax"])
def test_tensorboard_files_read_across_frameworks(tmp_path, writer_side):
    """A file either framework's SummaryWriter writes is read back by the
    other's read_events: the same steps, tags and f32 values."""
    writer, reader = ((tensorboard, jtb) if writer_side == "port"
                      else (jtb, tensorboard))
    w = writer.SummaryWriter(str(tmp_path))
    scalars = [(1, {"train/loss": 0.5}), (2, {"valid/rmse": 0.25,
                                              "valid/mae": 1e-7})]
    for step, s in scalars:
        w.add_scalars(step, s)
    w.close()
    events = reader.read_events(w.path)
    assert events[0] == (None, {})  # the file_version record
    assert [e[0] for e in events[1:]] == [1, 2]
    for (_, want), (_, got) in zip(scalars, events[1:]):
        assert set(got) == set(want)
        for k in want:
            assert got[k] == np.float32(want[k])
    assert reader.read_events(w.path) == writer.read_events(w.path)


# --- remat --------------------------------------------------------------------


@pytest.mark.parametrize("task", ["edos", "phdos"])
def test_remat_gives_the_same_gradients(task):
    """remat=True recomputes each processor and transformer layer in the
    backward: on the CPU every gradient equals the one without (exact), and
    serving under no_grad runs no recomputation at all."""
    make = (jsyn.synthetic_edos_learnable if task == "edos"
            else jsyn.synthetic_phdos_learnable)
    batch = graph.collate(_port(make(3, seed=1)), num_graphs=4)
    grads = []
    for remat in (False, True):
        model = build_model(task, layers=2, t_layers=1, hidden=H,
                            generator=torch.Generator().manual_seed(0),
                            remat=remat)
        dg, _, ds = model(batch)
        (dg.square().sum() + ds.sum()).backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
        with torch.no_grad():
            assert torch.isfinite(model(batch)[2]).all()
    assert set(grads[0]) == set(grads[1])
    for name, g in grads[0].items():
        assert torch.equal(g, grads[1][name]), name


# --- checkpoints ----------------------------------------------------------------


def _trained(seed=0, steps=2):
    """A small phDOS model and its AdamW after ``steps`` steps."""
    model = build_model("phdos", layers=1, t_layers=1, hidden=H,
                        generator=torch.Generator().manual_seed(seed))
    trainer = Trainer(model, clamp_targets=False)
    batch = graph.collate(_port(jsyn.synthetic_phdos_learnable(3, seed=3)))
    for _ in range(steps):
        trainer.train_step(batch)
    return model, trainer.optimizer


def test_checkpoint_round_trip(tmp_path):
    """save -> restore gives back the model's state_dict, AdamW's moments
    (mu bf16, nu f32) and step count, the epoch and every tracker field,
    exactly; the newest max_to_keep files stay; a save at a step that does
    not increase is refused."""
    model, opt = _trained()
    tracker = BestTracker(es=10, eval_every=2)
    tracker.update(2, 0.5, 0.4)
    tracker.record_test({"rmse": 0.3, "mse": 0.09, "mae": 0.2, "r2": 0.1})
    tracker.step_and_should_stop()
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    assert mgr.latest_epoch() is None and mgr.restore(model) is None
    for epoch in (1, 2, 4):
        assert mgr.save(epoch, model, opt, tracker)
    mgr.wait_until_finished()
    assert mgr.latest_epoch() == 4
    assert sorted(os.listdir(tmp_path / "ck")) == ["checkpoint_2.pt",
                                                   "checkpoint_4.pt"]
    assert not mgr.save(3, model, opt, tracker)  # not above the latest
    fresh, fresh_opt = _trained(seed=9, steps=1)
    epoch, got = mgr.restore(fresh, fresh_opt)
    assert epoch == 4 and got == tracker
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    assert fresh_opt.step_count == opt.step_count == 2
    assert fresh_opt.mu.dtype == torch.bfloat16
    assert torch.equal(fresh_opt.mu, opt.mu) and torch.equal(fresh_opt.nu,
                                                               opt.nu)
    assert mgr.restore(fresh, epoch=2)[0] == 2


def test_resumed_best_save_at_older_epoch_is_kept(tmp_path):
    """best/ saves go by a monotonic ordinal with the true epoch beside it:
    after a resume restored a state older than the recorded best, a new
    best found at a lower epoch still replaces best/ (as the JAX
    package's tests/test_serve.py pins for orbax)."""
    model, opt = _trained()
    mgr = CheckpointManager(str(tmp_path / "best"), max_to_keep=1)
    assert mgr.save(0, model, opt, epoch_meta=7, wait=True)
    later, later_opt = _trained(seed=5)
    ordinal = mgr.latest_epoch() + 1
    assert mgr.save(ordinal, later, later_opt, epoch_meta=5, wait=True)
    fresh, _ = _trained(seed=9, steps=0)
    epoch, tracker = mgr.restore(fresh)
    assert epoch == 5 and tracker is None
    for k, v in later.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    assert os.listdir(tmp_path / "best") == ["checkpoint_1.pt"]


def _phdos_flags(tmp_path, name, epochs, *extra):
    return ["--synthetic", "24", "--synthetic_learnable", "--epochs",
            str(epochs), "--eval", "2", "--hidden", str(H), "--layers", "1",
            "--transformer", "1", "--batch_size", "4", "--device", "cpu",
            "--results_dir", str(tmp_path / name),
            "--log_jsonl", str(tmp_path / name / "log.jsonl"), *extra]


def _epoch_losses(path):
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    return {r["epoch"]: r["loss"] for r in rows if "loss" in r}


def test_crash_resume_matches_uninterrupted(tmp_path):
    """A run stopped after epoch 2 and resumed to epoch 4 from its
    checkpoint gives the uninterrupted 4-epoch run's epoch losses, best
    epoch and best metrics exactly (model, AdamW and tracker restored; the
    data order a function of (seed, epoch))."""
    ck = ["--checkpoint_every", "2", "--checkpoint_dir"]
    full = main_phdos.main(_phdos_flags(tmp_path, "a", 4, *ck,
                                        str(tmp_path / "cka")))
    main_phdos.main(_phdos_flags(tmp_path, "b", 2, *ck,
                                 str(tmp_path / "ckb")))
    resumed = main_phdos.main(_phdos_flags(tmp_path, "b", 4, *ck,
                                           str(tmp_path / "ckb")))
    assert _epoch_losses(tmp_path / "a" / "log.jsonl") == _epoch_losses(
        tmp_path / "b" / "log.jsonl")
    for k in ("best_epoch", "best_valid_rmse", "best_valid_mae", "test"):
        assert resumed[k] == full[k], k
    assert CheckpointManager(str(tmp_path / "ckb")).latest_epoch() == 4


def test_sigterm_checkpoints_and_resumes(tmp_path, monkeypatch):
    """SIGTERM during training: the run finishes the epochs in flight,
    saves a checkpoint at that boundary, skips the eval and returns
    preempted; the handler is restored; a follow-up run resumes from the
    checkpoint."""
    sent = []
    original = Trainer.train_epochs_device

    def signalled(self, *args, **kwargs):
        out = original(self, *args, **kwargs)
        if not sent:  # once, from inside the run, as a scheduler would
            sent.append(True)
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    monkeypatch.setattr(Trainer, "train_epochs_device", signalled)
    before = signal.getsignal(signal.SIGTERM)
    flags = lambda epochs: _phdos_flags(
        tmp_path, "run", epochs, "--checkpoint_dir", str(tmp_path / "ck"),
        "--checkpoint_every", "2")
    result = main_phdos.main(flags(100000))
    assert result["preempted"] is True and result["test"] is None
    assert signal.getsignal(signal.SIGTERM) == before
    saved = CheckpointManager(str(tmp_path / "ck")).latest_epoch()
    assert saved == 2  # the first chunk: epochs up to the first eval
    again = main_phdos.main(flags(saved + 2))
    assert again["preempted"] is False
    assert np.isfinite(again["test"]["rmse"])
    assert CheckpointManager(str(tmp_path / "ck")).latest_epoch() == 4


def test_runtime_flags_run_and_write_their_outputs(tmp_path):
    """main_edos on the CPU with the runtime's flags: bucketed bf16 device
    data, remat, clipping, warmup and cosine, TensorBoard, eval artifacts
    and a profiler trace: every output is there and finite."""
    out = tmp_path / "run"
    result = main_edos.main([
        "--synthetic", "20", "--synthetic_learnable", "--epochs", "2",
        "--eval", "1", "--hidden", str(H), "--layers", "1",
        "--transformer", "1", "--batch_size", "4", "--device", "cpu",
        "--results_dir", str(out), "--bucketed", "--bf16_data", "--remat",
        "--grad_clip", "1", "--warmup_epochs", "1", "--cosine_lr",
        "--tensorboard", str(out / "tb"), "--export_preds",
        str(out / "preds.npz"), "--profile_dir", str(out / "prof")])
    assert result["preempted"] is False
    assert all(np.isfinite(v) for v in result["test"].values())
    (event_file,) = os.listdir(out / "tb")
    tags = set()
    for _, scalars in tensorboard.read_events(str(out / "tb" / event_file)):
        tags |= set(scalars)
    assert {"train/loss", "valid/rmse", "test/rmse"} <= tags
    with np.load(out / "preds.npz") as z:
        n = z["sample_id"].shape[0]
        assert n > 0 and z["preds"].shape == (n, 201)
        assert z["embeddings"].shape == (n, H) and z["mp_id"].shape == (n,)
        assert (z["preds"] >= 0).all()  # the eDOS eval clamp
    with open(out / "prof" / "trace.json") as f:
        assert "traceEvents" in json.load(f)


def test_bucketed_needs_the_device_dataset():
    with pytest.raises(ValueError, match="host_loader"):
        main_edos.main(["--synthetic", "8", "--device", "cpu", "--bucketed",
                        "--host_loader"])


PORTED_FLAGS = [["--checkpoint_dir", "ck", "--checkpoint_every", "2"],
                ["--export_preds", "p.npz"], ["--profile_dir", "prof"],
                ["--remat"], ["--tensorboard", "tb"], ["--bf16_data"],
                ["--bucketed"], ["--grad_clip", "1.0"],
                ["--warmup_epochs", "2"], ["--cosine_lr"]]


@pytest.mark.parametrize("flags", PORTED_FLAGS,
                         ids=[f[0].lstrip("-") for f in PORTED_FLAGS])
def test_runtime_flags_are_accepted(flags):
    """The training runtime's flags parse (no longer refused) and reach
    run_training's keywords or the config."""
    parser = common.build_arg_parser("edos")
    args = common.parse_args(parser, ["--device", "cpu", *flags])
    cfg, kw = common.config_from_args(args), common.runtime_kwargs(args)
    name = flags[0].lstrip("-")
    value = getattr(cfg, name, None) if name == "checkpoint_dir" else kw[name]
    assert value not in (None, False, 0, 0.0), name


# --- serving from a checkpoint --------------------------------------------------


def _edos_request():
    return _port(jsyn.synthetic_edos_samples(5, seed=3, max_atoms=10))


def test_from_checkpoint_serves_best_or_latest(tmp_path):
    """Predictor.from_checkpoint serves best/ by default and the newest
    cadence checkpoint with prefer="latest", falls back to it without a
    best/, and raises where there is none."""
    request = _edos_request()
    kw = dict(task="edos", example=request[0], layers=1, t_layers=1,
              hidden=H, batch_size=4, device="cpu")
    models = [build_model("edos", layers=1, t_layers=1, hidden=H,
                          generator=torch.Generator().manual_seed(s))
              for s in (1, 2)]
    ck = str(tmp_path / "ck")
    CheckpointManager(ck).save(3, models[1], wait=True)
    latest = Predictor.from_checkpoint(ck, **kw).predict(request)
    CheckpointManager(best_dir(ck)).save(0, models[0], epoch_meta=2,
                                         wait=True)
    best = Predictor.from_checkpoint(ck, **kw).predict(request)
    again = Predictor.from_checkpoint(ck, prefer="latest", **kw).predict(
        request)
    for model, got in ((models[1], latest), (models[0], best),
                       (models[1], again)):
        want = Predictor(model, batch_size=4, clamp=True).predict(request)
        np.testing.assert_array_equal(got, want)
    assert not np.array_equal(best, latest)
    with pytest.raises(FileNotFoundError):
        Predictor.from_checkpoint(str(tmp_path / "none"), **kw)
    with pytest.raises(ValueError, match="prefer"):
        Predictor.from_checkpoint(ck, prefer="oldest", **kw)


def test_cli_checkpoint_dir_matches_the_jax_cli(tmp_path):
    """main_predict --checkpoint_dir (best/ of a checkpoint directory)
    against the JAX package's main_predict on the same weights (its
    --torch_state_dict, since the JAX CLI reads orbax checkpoints): the same
    spectra within rtol 1e-4 + atol 1e-4, as for the whole model."""
    request = _edos_request()
    save_samples(tmp_path / "in.npz", request)
    model = build_model("edos", layers=1, t_layers=1, hidden=H,
                        generator=torch.Generator().manual_seed(4))
    ck = str(tmp_path / "ck")
    CheckpointManager(best_dir(ck)).save(0, model, epoch_meta=1, wait=True)
    torch.save(model.state_dict(), tmp_path / "w.pt")
    common_flags = ["--task", "edos", "--input", str(tmp_path / "in.npz"),
                    "--layers", "1", "--transformer", "1", "--hidden", str(H),
                    "--batch_size", "4"]
    main_predict.main([*common_flags, "--checkpoint_dir", ck,
                       "--checkpoint_state", "best", "--device", "cpu",
                       "--output", str(tmp_path / "port.npz")])
    jax_main_predict.main([*common_flags, "--torch_state_dict",
                           str(tmp_path / "w.pt"),
                           "--output", str(tmp_path / "jax.npz")])
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert a["dos"].shape == (5, 201)
        np.testing.assert_allclose(a["dos"], b["dos"], rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(a["sample_id"], b["sample_id"])


@pytest.mark.parametrize("flags", [
    ["--torch_state_dict", "w.pt", "--checkpoint_dir", "ck"],
    ["--torch_state_dict", "w.pt", "--checkpoint_state", "latest"],
    []], ids=["both-sources", "state-with-state-dict", "no-source"])
def test_cli_checkpoint_flags_are_exclusive(flags, capsys):
    """The JAX CLI's rules: exactly one weight source, and
    --checkpoint_state only with a checkpoint."""
    with pytest.raises(SystemExit):
        main_predict.main(["--task", "edos", "--input", "x.npz",
                           "--output", "y.npz", *flags])
    assert "--checkpoint_dir" in capsys.readouterr().err
