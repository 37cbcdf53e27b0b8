"""AdamW on flat buffers and the rule that picks the replayed train step
(train/optim.py, train/trainer.py), on the CPU.

The flat-buffer AdamW against the step it replaced, kept here as the
oracle (:class:`GatheringAdamW`: the gradients and parameters gathered with
``torch.cat`` and copied back with ``_foreach_copy_``), bit for bit over 5
steps with clipping, warmup, cosine decay and ``x64``, on random leaves and
on a bf16 model's f32 leaves; the per-step scalars a captured update reads
against ``learning_rate`` and ``bias_correction``, bit for bit; the state
dict, the moments and a checkpoint's files and resume; a parameter
rebound after the optimizer was built stopping the step; and which runs
replay (a card without a mesh; never the CPU, a mesh, an f64 model, another
optimizer or ``graphs=False``; never the host loader). The replay itself
runs on the card only: tests/test_torch_cuda.py holds it to the eager step
there.

Small sizes: leaves of a few dozen floats, an eDOS model at hidden 16."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from dostransformer_tpu_torch import tracing  # noqa: E402
from dostransformer_tpu_torch.data.datasets import GraphLoader  # noqa: E402
from dostransformer_tpu_torch.data.graph import collate  # noqa: E402
from dostransformer_tpu_torch.data.synthetic import (  # noqa: E402
    synthetic_edos_learnable,
)
from dostransformer_tpu_torch.models.registry import (  # noqa: E402
    build_model,
    model_outputs,
)
from dostransformer_tpu_torch.train import optim  # noqa: E402
from dostransformer_tpu_torch.train.checkpoint import (  # noqa: E402
    CheckpointManager,
)
from dostransformer_tpu_torch.train.device_dataset import (  # noqa: E402
    BucketedDeviceDataset,
    DeviceDataset,
)
from dostransformer_tpu_torch.train.trainer import Trainer  # noqa: E402

SHAPES = {"w": (6, 5), "b": (5,), "s": (1,), "e": (3, 2, 4)}
CASES = {
    "plain": {},
    "grad_clip": {"grad_clip": 0.05},
    "warmup": {"warmup_steps": 3},
    "cosine": {"cosine_decay_steps": 4},
    "warmup_cosine_x64": {"warmup_steps": 2, "cosine_decay_steps": 3,
                          "x64": True},
    "clip_x64": {"grad_clip": 0.05, "x64": True},
}


class GatheringAdamW(optim.AdamW):
    """The step the flat buffers replaced: the moments flat, the gradients
    and parameters gathered with ``torch.cat`` each step, the parameters
    copied back with ``_foreach_copy_``."""

    def __init__(self, params, **kwargs):
        params = list(params)
        saved = [p.detach().clone() for p in params]
        super().__init__(params, **kwargs)
        for p, x in zip(self.params, saved):  # leaves of their own again
            p.data = x
            p.grad = None
        n = sum(self._sizes)  # the moments packed, with no gaps
        self._slots = self._offsets
        self.mu = torch.zeros(n, dtype=torch.bfloat16)
        self.nu = torch.zeros(n)

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, grad_group=None):
        g = torch.cat([(p.grad if p.grad is not None
                        else torch.zeros_like(p)).reshape(-1)
                       for p in self.params])
        p = torch.cat([p.reshape(-1) for p in self.params])
        if self.grad_clip > 0:
            norm = self._global_norm(g)
            g = torch.where(norm < self.grad_clip, g,
                            g / norm * self.grad_clip)
        lr = optim.learning_rate(self.step_count, self.lr, self.warmup_steps,
                                 self.cosine_decay_steps, self.x64)
        self.step_count += 1
        t = self.step_count
        bc1 = optim.bias_correction(optim.B1, t, self.x64)
        bc2 = optim.bias_correction(optim.B2, t, self.x64)
        mu = (1 - optim.B1) * g + self._b1_mu * self.mu.float()
        nu = (1 - optim.B2) * (g * g) + optim.B2 * self.nu
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + optim.EPS)
        p = p + (u + self.weight_decay * p) * (-lr)
        self.mu.copy_(mu)
        self.nu.copy_(nu)
        torch._foreach_copy_(self.params,
                             [x.view_as(q) for x, q in
                              zip(p.split(self._sizes), self.params)])


def _leaves(seed=3):
    rng = np.random.RandomState(seed)
    return [torch.nn.Parameter(torch.from_numpy(
        rng.randn(*s).astype(np.float32))) for s in SHAPES.values()]


def _model(**kw):
    return build_model("edos", "DOSTransformer", layers=1, t_layers=1,
                       hidden=16, n_bins=17, node_in=200, edge_in=41,
                       glob_in=2, generator=torch.Generator().manual_seed(0),
                       **kw)


def _batch():
    return collate(synthetic_edos_learnable(6, seed=2, max_atoms=9,
                                            n_bins=17), num_graphs=8)


def _same(a, b):
    """Bit-equal parameters, moments and counts of two optimizers."""
    for p, q in zip(a.params, b.params):
        assert torch.equal(p, q)
    sa, sb = a.state_dict(), b.state_dict()
    assert torch.equal(sa["mu"], sb["mu"]) and torch.equal(sa["nu"], sb["nu"])
    assert a.step_count == b.step_count


@pytest.mark.parametrize("leaves", ["random", "bf16_model"])
@pytest.mark.parametrize("case", list(CASES))
def test_flat_adamw_steps_bit_equal_to_the_gathering_step(case, leaves):
    """5 steps of the flat-buffer AdamW and of the step it replaced, on the
    same gradients: every parameter, both moments and the count bit-equal.
    Random leaves take gradients set on ``.grad`` (copied into the flat
    buffer at the step), spread over four decades; a bf16 model's f32
    leaves take its backward's, accumulated into the flat buffer."""
    kwargs = dict(lr=1e-2, **CASES[case])
    if leaves == "random":
        flat = optim.make_adamw(_leaves(), **kwargs)
        old = GatheringAdamW(_leaves(), **kwargs)
        rng = np.random.RandomState(7)
        for _ in range(5):
            for p, q in zip(flat.params, old.params):
                g = (rng.randn(*p.shape) * 10 ** rng.uniform(-4, 0))
                p.grad = torch.from_numpy(g.astype(np.float32))
                q.grad = p.grad.clone()
            flat.step()
            old.step()
            _same(flat, old)
        return
    models = [_model(dtype="bfloat16") for _ in range(2)]
    flat = optim.make_adamw(models[0].parameters(), **kwargs)
    old = GatheringAdamW(models[1].parameters(), **kwargs)
    batch = _batch()
    for _ in range(5):
        for model, opt in zip(models, (flat, old)):
            opt.zero_grad()
            dos_global, _, dos_system = model_outputs(model(batch))
            (dos_global.square().mean() + dos_system.square().mean()
             ).backward()
            opt.step()
        _same(flat, old)
    assert all(p.dtype == torch.float32 for p in flat.params)


@pytest.mark.parametrize("case", list(CASES))
def test_scalar_table_holds_the_eager_steps_scalars(case):
    """Each row of the table a captured update reads: the rate
    ``learning_rate`` gives at the step's count and the reciprocals of
    ``bias_correction`` at the count after it (formed in f64), each rounded
    to f32 as the card takes a host float, bit for bit; from the count where
    the table starts, which the table leaves as it is."""
    opt = optim.make_adamw(_leaves(), lr=3e-3, **CASES[case])
    opt.step_count = 2
    table = opt.scalar_table(9)
    assert table.dtype == torch.float32 and table.shape == (9, 3)
    assert opt.step_count == 2
    f32 = np.float32
    x64 = CASES[case].get("x64", False)
    for i, row in enumerate(table.numpy()):
        c = 2 + i
        lr = optim.learning_rate(c, 3e-3, CASES[case].get("warmup_steps", 0),
                                 CASES[case].get("cosine_decay_steps", 0),
                                 x64)
        want = [f32(lr)] + [f32(1.0 / optim.bias_correction(b, c + 1, x64))
                            for b in (optim.B1, optim.B2)]
        assert row.tobytes() == np.array(want, np.float32).tobytes()
    # the eager step's own scalars, from the same count
    eager = opt._scalars()
    assert f32(eager[0]) == table[0, 0].item()
    assert f32(1.0 / eager[1]) == table[0, 1].item()
    assert f32(1.0 / eager[2]) == table[0, 2].item()


@pytest.mark.parametrize("case", list(CASES))
def test_captured_step_follows_the_table_row_by_row(case):
    """The update a graph captures, fed the table's rows and counted with
    ``advance``, against 5 eager steps: the same count, and on the CPU the
    same parameters and moments within 1e-6 (the CPU divides where the
    card, and so the table, multiplies by the reciprocal: a rounding
    apart; on the card the two are bit-equal)."""
    kwargs = dict(lr=1e-2, **CASES[case])
    eager, captured = (optim.make_adamw(_leaves(), **kwargs)
                       for _ in range(2))
    table = captured.scalar_table(5)
    rng = np.random.RandomState(5)
    for i in range(5):
        for p, q in zip(eager.params, captured.params):
            g = torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
            p.grad = g
            q.grad.copy_(g)
        eager.step()
        captured.captured_step(table[i])
        captured.advance()
    assert captured.step_count == eager.step_count == 5
    for p, q in zip(eager.params, captured.params):
        torch.testing.assert_close(q, p, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(captured.nu, eager.nu, rtol=1e-6, atol=0)
    torch.testing.assert_close(captured.mu.float(), eager.mu.float(),
                               rtol=2 ** -7, atol=0)


def test_parameters_and_gradients_are_views_of_the_flat_buffers():
    """Each parameter is its slot of ``flat``, each ``.grad`` its slot of
    ``grad`` and ``moments(p)`` its slots of ``mu`` and ``nu``, shaped like
    it, every slot starting ``ALIGN`` floats apart (256 bytes: the kernels
    take aligned pointers); the state dict is the moments packed in
    parameter order and the count, as before, and loads back; a cleared
    ``.grad`` reads as zeros at the next step, and ``zero_grad`` brings the
    views back."""
    params = _leaves()
    before = [p.detach().clone() for p in params]
    opt = optim.make_adamw(params)
    base = opt.flat.data_ptr()
    for p, x in zip(params, before):
        assert torch.equal(p, x)
        off = p.data_ptr() - base
        assert off % (4 * optim.ALIGN) == 0
        assert p.grad.data_ptr() - opt.grad.data_ptr() == off
        mu, nu = opt.moments(p)
        assert mu.shape == nu.shape == p.shape
        assert 2 * (mu.data_ptr() - opt.mu.data_ptr()) == off
        assert nu.data_ptr() - opt.nu.data_ptr() == off
    for p in params:
        p.grad = torch.ones_like(p)
    opt.step()
    state = opt.state_dict()
    assert set(state) == {"mu", "nu", "step_count"}
    n = sum(p.numel() for p in params)
    assert state["mu"].shape == state["nu"].shape == (n,)
    assert state["mu"].dtype == torch.bfloat16
    assert torch.equal(state["nu"], torch.cat(
        [opt.moments(p)[1].reshape(-1) for p in params]))
    # the gaps between slots stay zero
    assert float(opt.flat.abs().sum()) == pytest.approx(
        sum(float(p.detach().abs().sum()) for p in params))
    fresh = optim.make_adamw(_leaves())
    fresh.load_state_dict(state)
    assert torch.equal(fresh.mu, opt.mu) and torch.equal(fresh.nu, opt.nu)
    assert fresh.step_count == 1
    opt.grad.fill_(1.0)
    params[0].grad = None
    opt.step()
    assert params[0].grad.data_ptr() == opt.grad.data_ptr()
    assert not params[0].grad.any() and params[1].grad.eq(1).all()
    views = [p.grad for p in params]
    params[1].grad = torch.zeros_like(params[1])
    opt.zero_grad()
    assert params[1].grad is views[1]
    assert not opt.grad.any()


REBIND = {
    "data": lambda model, params: setattr(params[0], "data",
                                          params[0].data.clone()),
    "to": lambda model, params: model.to(torch.float64),
    "second_optimizer": lambda model, params: optim.make_adamw(params),
}


@pytest.mark.parametrize("how", list(REBIND))
def test_a_parameter_rebound_after_the_optimizer_stops_the_step(how):
    """A parameter that no longer is its view of the flat buffer (its
    ``.data`` set, the model moved with ``to``, a second optimizer built
    on the same model) would silently stop training: the
    step and ``zero_grad`` raise, and the flat buffer is left as it was."""
    model = _model()
    params = [p for p in model.parameters() if p.requires_grad]
    opt = optim.make_adamw(params)
    opt.check_views()
    REBIND[how](model, params)
    flat = opt.flat.clone()
    for call in (opt.step, opt.zero_grad, opt.check_views):
        with pytest.raises(RuntimeError, match="rebound after the optimizer"):
            call()
    assert torch.equal(opt.flat, flat) and opt.step_count == 0


def test_checkpoint_files_and_resume_are_unchanged(tmp_path):
    """A checkpoint of a trained model: every saved leaf a tensor of its own
    size (not the flat buffer), the moments flat at the model's size; a
    fresh model and optimizer restored from it, then stepped beside the
    uninterrupted pair, stay bit-equal to it."""
    batch = _batch()
    trainers = [Trainer(_model(), seed=1) for _ in range(2)]
    trainers[0].train_step(batch)
    manager = CheckpointManager(str(tmp_path))
    manager.save(1, trainers[0].model, trainers[0].optimizer, wait=True,
                 rng=trainers[0].dropout_rng)
    state = torch.load(tmp_path / manager._path(1), weights_only=True)
    for name, t in state["model"].items():
        assert t.untyped_storage().nbytes() == t.numel() * t.element_size(), \
            name
    n = sum(t.numel() for t in state["model"].values())
    assert n == sum(trainers[0].optimizer._sizes)
    assert state["optimizer"]["mu"].shape == (n,)
    assert state["optimizer"]["nu"].shape == (n,)
    manager.restore(trainers[1].model, trainers[1].optimizer,
                    rng=trainers[1].dropout_rng)
    _same(trainers[0].optimizer, trainers[1].optimizer)
    for _ in range(2):
        losses = [t.train_step(batch)["loss"] for t in trainers]
        assert torch.equal(*losses)
    _same(trainers[0].optimizer, trainers[1].optimizer)


class _Mesh:
    """Stands in for a mesh in the rule alone (never stepped)."""


RULE = {
    "card": ({}, True),
    "cpu": ({"device": "cpu"}, False),
    "graphs_off": ({"graphs": False}, False),
    "mesh": ({"mesh": _Mesh()}, False),
    "f64_model": ({"dtype": "float64"}, False),
    "bf16_model": ({"dtype": "bfloat16"}, True),
    "remat_model": ({"remat": True}, True),
    "other_optimizer": ({"optimizer": "gathering"}, False),
}


@pytest.mark.parametrize("case", list(RULE))
def test_replay_rule_is_decided_by_what_the_trainer_holds(case):
    """On a card without a mesh the device dataset's steps replay; the
    CPU, a mesh, an f64 model, another optimizer and ``graphs=False`` keep
    the eager step. (The Trainer is built on the CPU and its device then
    read as a card's: the rule is all this checks.)"""
    kw, want = RULE[case]
    model = _model(**{k: v for k, v in kw.items()
                      if k in ("dtype", "remat")})
    trainer = Trainer(model, graphs=kw.get("graphs", True),
                      optimizer=(GatheringAdamW(model.parameters())
                                 if "optimizer" in kw else None))
    assert not trainer.replays  # built on the CPU
    trainer.device = torch.device(kw.get("device", "cuda"))
    trainer.mesh = kw.get("mesh")
    assert trainer.replays is want


@pytest.mark.parametrize("kind", ["host", "device", "buckets"])
def test_only_the_device_datasets_steps_replay(kind, monkeypatch):
    """With the rule holding, the device dataset's epochs (flat and
    bucketed) hand every step to the replay, with the order on the data's
    device; the host loader's epoch runs the eager step."""
    calls = []

    def replayed(self, dataset, perm, epoch, first):
        calls.append((perm.device, tuple(perm.shape), first))
        return torch.zeros(perm.shape[0])

    monkeypatch.setattr(Trainer, "replays", property(lambda self: True))
    monkeypatch.setattr(Trainer, "_replayed_epoch", replayed)
    trainer = Trainer(_model(), seed=0)
    counters = tracing.record().counters
    before = counters.get("train.steps_replayed", 0)
    samples = synthetic_edos_learnable(12, seed=4, max_atoms=12, n_bins=17)
    if kind == "host":
        losses = trainer.train_epoch(GraphLoader(samples, 4), 0)
        assert calls == [] and trainer.optimizer.step_count == 3
    elif kind == "device":
        losses = trainer.train_epoch_device(
            DeviceDataset.from_samples(samples, 4, device="cpu"), 0, 0)
        assert calls == [(torch.device("cpu"), (3, 4), 0)]
        assert trainer.optimizer.step_count == 0
    else:
        data = BucketedDeviceDataset.from_samples(samples, 4, device="cpu")
        losses = trainer.train_epoch_buckets(data, 0, 0)
        steps = [d.steps_per_epoch for _, d in data.buckets]
        assert len(steps) == 2
        assert [c[2] for c in calls] == [0, steps[0]]
    assert losses.shape == (3 if kind != "buckets" else sum(steps),)
    # the host loader's eager steps count 0 replayed, the others all
    replayed = counters["train.steps_replayed"] - before
    assert replayed == (0 if kind == "host" else losses.shape[0])


def test_static_inputs_are_the_batch_geometry():
    """A geometry's static inputs: every field the dataset has, at the
    local batch, in the data's dtypes (a bf16 storage's features bf16), as
    its key names them; the captured step reads them."""
    from dostransformer_tpu_torch.train import trainer as trainer_module

    samples = synthetic_edos_learnable(10, seed=4, max_atoms=12, n_bins=17)
    data = DeviceDataset.from_samples(samples, 4, device="cpu",
                                      storage_dtype=torch.bfloat16)
    key = trainer_module._geometry(data)
    inputs = trainer_module._static_inputs(data.data, data.local_batch)
    names = [f.name for f in dataclasses.fields(inputs)
             if getattr(inputs, f.name) is not None]
    assert key[0] == 4 and [n for n, _, _ in key[1:]] == names
    for name, shape, dtype in key[1:]:
        t = getattr(inputs, name)
        assert tuple(t.shape) == (4,) + shape and t.dtype == dtype
    assert dict((n, d) for n, _, d in key[1:])["nodes"] == torch.bfloat16


@pytest.mark.cuda
def test_replayed_epoch_at_the_cell_sizes_runs_the_linear_kernel_bit_equal():
    """On the card, the cell's model (eDOS at hidden 256, 3 processors, 2
    layers a stack, 201 bins) at batch 64 over the atom buckets 16 and 128,
    2 steps each: the eager epoch sends the processors', encoders' and
    heads' f32 linears to kernel #9 (``linear.kernel_rows``, launches);
    the replayed epoch (captured in its first, replayed in its second)
    runs #9's kernels by torch.profiler name as often as the eager epoch
    and gives its losses, parameters and AdamW state bit for bit. The
    LayerNorms take #10 and #7 likewise: 24 of each a step, eager and
    replayed, every row on the kernels (``layer_norm.kernel_rows``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel #9 has no CPU mode")
    from torch.profiler import ProfilerActivity, profile

    from dostransformer_tpu_torch.ops.layernorm import (
        layer_norm,
        layer_norm_bwd,
    )
    from dostransformer_tpu_torch.ops.linear import linear_op

    torch.backends.cuda.matmul.allow_tf32 = False
    samples = [s for lo, hi, seed in ((8, 15, 31), (64, 127, 32))
               for s in synthetic_edos_learnable(128, seed=seed, min_atoms=lo,
                                                 max_atoms=hi)]
    data = BucketedDeviceDataset.from_samples(samples, 64, device="cuda")
    assert [a for a, _ in data.buckets] == [16, 128]
    trainers = []
    for graphs in (False, True):
        model = build_model("edos", layers=3, t_layers=2, hidden=256,
                            device="cuda",
                            generator=torch.Generator().manual_seed(5))
        trainers.append(Trainer(model, seed=3, graphs=graphs,
                                clamp_targets=True))
    eager, replayed = trainers
    counters = tracing.record().counters
    kernel_rows = counters.get("linear.kernel_rows", 0)
    ln_rows = [counters.get(k, 0)
               for k in ("layer_norm.rows", "layer_norm.kernel_rows")]
    launches = linear_op.launches
    ln_launches = layer_norm.launches, layer_norm_bwd.launches
    want = eager.train_epochs_buckets(data, 0, [0])
    assert linear_op.launches - launches >= 4 * 6
    assert counters["linear.kernel_rows"] > kernel_rows
    assert (layer_norm.launches - ln_launches[0],
            layer_norm_bwd.launches - ln_launches[1]) == (4 * 24, 4 * 24)
    assert (counters["layer_norm.rows"] - ln_rows[0]
            == counters["layer_norm.kernel_rows"] - ln_rows[1] > 0)
    assert torch.equal(replayed.train_epochs_buckets(data, 0, [0]), want)
    names = []
    for trainer in trainers:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            losses = trainer.train_epochs_buckets(data, 0, [1])
            torch.cuda.synchronize()
        names.append(sorted(
            e.name for e in prof.events()
            if any(k in e.name for k in ("linear_gemm_kernel",
                                         "linear_split_kernel",
                                         "linear_reduce_kernel",
                                         "ln_fwd_kernel",
                                         "ln_bwd_kernel"))))
        if trainer is eager:
            want = losses
    assert names[0] and names[0] == names[1]
    for kernel in ("ln_fwd_kernel", "ln_bwd_kernel"):
        got = [sum(kernel in n for n in side) for side in names]
        assert got == [4 * 24] * 2, (kernel, got, sorted(set(names[0])))
    assert torch.equal(losses, want)
    for p, q in zip(eager.model.parameters(), replayed.model.parameters()):
        assert torch.equal(p, q)
    assert torch.equal(eager.optimizer.mu, replayed.optimizer.mu)
    assert torch.equal(eager.optimizer.nu, replayed.optimizer.nu)
